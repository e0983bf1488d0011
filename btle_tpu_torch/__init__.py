"""btle_tpu_torch — the PyTorch/CUDA port of btle_tpu for NVIDIA Hopper.

The JAX package ``btle_tpu`` stays the reference; this package imports
nothing of it and no JAX. Plain tensor code is PyTorch; every Pallas
kernel on the ported path is a hand-written CUDA kernel under ``csrc/``,
built with nvcc on first use (``_build``) and held against a plain
PyTorch twin in the same module. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy convenience exports (importing the package loads no torch)."""
    lazy = {
        "WidebandSniffer": ("btle_tpu_torch.wideband", "WidebandSniffer"),
        "WidebandConfig": ("btle_tpu_torch.wideband", "WidebandConfig"),
        "fused_selftest": ("btle_tpu_torch.wideband", "fused_selftest"),
        "Sniffer": ("btle_tpu_torch.stream", "Sniffer"),
        "SnifferConfig": ("btle_tpu_torch.stream", "SnifferConfig"),
    }
    if name in lazy:
        import importlib

        mod, attr = lazy[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(name)
