"""Numpy golden-model pieces the port needs to synthesize scenes."""

from .model import assemble_phy_bits, gauss_fir, gfsk_modulate_float  # noqa: F401
