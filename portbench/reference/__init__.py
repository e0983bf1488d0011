"""Plain NumPy / PyTorch reference of the sniffers' semantics.

Imports nothing of btle_tpu_torch or btle_tpu: frozen copies of the
packet framing, the channelizer's tables and the receivers' rules,
recomputed from the same generated IQ the program received.
"""
