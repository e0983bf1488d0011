"""Lookup tables for the fixed-point GFSK chain.

Copy of btle_tpu/phy/tables.py: the tables are generated by the golden
layer (numpy) once and uploaded to the modulator's device by
``phy.modulator``. tests/test_torch_tables.py holds them equal to the
originals.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..golden.model import c_flavor_taps, gauss_fir, sin_cos_tables
from ..spec.constants import C_PHASE_TABLE_SIZE, GOLDEN_TAP_SCALE


@lru_cache(maxsize=None)
def golden_mod_tables(sps: int = 8):
    """(taps_i32, cos_i8, sin_i8, table_mask) for the python flavor.

    taps = round(128 * gauss_fir) (btlelib.py:151-152); VCO gain 64 after
    the >>1 post-shift; table size 64*sps/0.25.
    """
    taps = np.round(GOLDEN_TAP_SCALE * gauss_fir(sps)).astype(np.int32)
    cos_t, sin_t = sin_cos_tables(GOLDEN_TAP_SCALE >> 1, sps)
    if len(cos_t) & (len(cos_t) - 1):
        # The phase accumulator wraps with bitwise_and — valid only for
        # power-of-two tables (see golden.gfsk_modulate_python's fence).
        raise ValueError(
            f"fixed-point python-flavor modulator requires a power-of-two "
            f"phase table; sps={sps} gives {len(cos_t)} entries — use the "
            f"float flavor for arbitrary sps")
    return taps, cos_t, sin_t, len(cos_t) - 1


@lru_cache(maxsize=None)
def c_mod_tables(sps: int = 4):
    """(taps_i32, cos_i8, sin_i8, table_mask) for the C flavor.

    Only the 9 centre taps participate (btle_tx.c:1049-1053 restricts the
    inner loop to j=3..11, i.e. gauss_coef_int8[4..12]); phase accumulator
    masked to 1024 entries (gauss_cos_sin_table.h).
    """
    taps16 = c_flavor_taps(sps).astype(np.int32)
    phase = 2 * np.pi * np.arange(C_PHASE_TABLE_SIZE) / C_PHASE_TABLE_SIZE
    cos_t = np.round(127 * np.cos(phase)).astype(np.int8)
    sin_t = np.round(127 * np.sin(phase)).astype(np.int8)
    return taps16, cos_t, sin_t, C_PHASE_TABLE_SIZE - 1
