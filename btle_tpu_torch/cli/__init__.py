"""Command-line interface of the port (``python -m btle_tpu_torch.cli``)."""
