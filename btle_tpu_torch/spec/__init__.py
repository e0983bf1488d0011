"""Numpy copies of btle_tpu.spec: bit order, constants, channel plan,
CRC24 and whitening."""

from . import bits, channels, constants, crc24, whitening  # noqa: F401
