"""Numpy copies of btle_tpu.spec: bit order, constants, channel plan,
CRC24, whitening and the LE Coded framing."""

from . import bits, channels, coded, constants, crc24, whitening  # noqa: F401
