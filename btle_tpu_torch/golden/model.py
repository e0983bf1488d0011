"""Partial numpy copy of btle_tpu.golden.model: the pulse shapes, phase
tables and the three GFSK modulators (the two fixed-point flavors and
the float one) and frame assembly — the oracle of the port's TX path
(``phy/modulator.py``, ``tx/``) and the synthesis of test scenes,
without the JAX package.

Copied from btle_tpu/golden/model.py (gauss_fir, sin_cos_tables,
c_flavor_pulse, c_flavor_taps, gfsk_modulate_python,
gfsk_modulate_float, gfsk_modulate_c, _c_tables, assemble_phy_bits);
tests/test_torch_tables.py holds the copies equal to the originals.
"""

from __future__ import annotations

import numpy as np

from ..spec import bits as B
from ..spec import crc24 as C
from ..spec import whitening as W
from ..spec.constants import (
    ADV_ACCESS_ADDRESS_HEX,
    ADV_CRC_INIT_HEX,
    BT,
    GAUSS_FILTER_SPAN_SYMBOLS,
    MODULATION_INDEX,
)


def gauss_fir(sps: int, bt: float = BT, span: int = GAUSS_FILTER_SPAN_SYMBOLS) -> np.ndarray:
    """Closed-form Gaussian taps, normalized so NRZ input peaks at +-1.

    CCSDS 413.0-G-3 formula as in btlelib.gauss_fir_gen (btlelib.py:38-48).
    Length span*sps+1 (17 taps at sps=8).
    """
    sigma = np.sqrt(np.log(2)) / (2 * np.pi * bt)
    t = np.arange(-(span / 2), (span / 2) + 1 / sps, 1 / sps)
    h = np.exp(-t * t / (2 * sigma * sigma)) / (sigma * np.sqrt(2 * np.pi))
    return h / sps


def sin_cos_tables(scale_up: int, sps: int, h_mod: float = MODULATION_INDEX):
    """int8 cos/sin tables of size scale_up*sps/(h_mod/2) (btlelib.py:50-66)."""
    table_size = int(scale_up * sps / (h_mod / 2))
    phase = 2 * np.pi * np.arange(0, 1, 1 / table_size)
    cos_t = np.round(127 * np.cos(phase)).astype(np.int8)
    sin_t = np.round(127 * np.sin(phase)).astype(np.int8)
    return cos_t, sin_t


def c_flavor_pulse(sps: int) -> np.ndarray:
    """The C tools' float GFSK frequency pulse (gauss_coef, btle_tx.c:95-107).

    Because the C modulator drives the filter with a zero-stuffed IMPULSE
    train (one +-1 per symbol, btle_tx.c:1036-1041) rather than repeated NRZ,
    its taps are the Gaussian-filtered one-symbol rectangular pulse
    g(t) = 0.5*[erf((t+1/2)/(sigma*sqrt2)) - erf((t-1/2)/(sigma*sqrt2))],
    evaluated on t in [-2, 2) at 1/sps steps (peak 0.9408018).
    """
    from math import erf

    sigma = np.sqrt(np.log(2)) / (2 * np.pi * BT)
    t = np.arange(-2, 2, 1 / sps)
    s2 = sigma * np.sqrt(2)
    return np.array([0.5 * (erf((x + 0.5) / s2) - erf((x - 0.5) / s2)) for x in t])


def c_flavor_taps(sps: int = 4) -> np.ndarray:
    """int8 taps round(64*gauss_coef), matching gauss_coef_int8 in
    gauss_cos_sin_table.h (16 taps at sps=4)."""
    return np.round(64 * c_flavor_pulse(sps)).astype(np.int8)


def gfsk_modulate_python(bits: np.ndarray, sps: int = 8):
    """Fixed-point modulator, ``python`` flavor (btlelib.py:146-189).

    Returns (cos_i8, sin_i8, phase_accum_input) where cos/sin are int8.
    """
    taps = np.round(128 * gauss_fir(sps)).astype(np.int8)  # btlelib.py:152
    vco_gain = 128 >> 1                                    # btlelib.py:154
    cos_t, sin_t = sin_cos_tables(vco_gain, sps)
    if len(cos_t) & (len(cos_t) - 1):
        # btlelib.py:93 wraps the VCO phase with bitwise_and(table_size-1),
        # which is a modulo ONLY for power-of-two tables (2048 at sps=8,
        # 1024 at sps=4). At e.g. sps=80 the table is 20480 entries and the
        # mask maps index 20480 to 16384 — silently corrupted phase. Use
        # gfsk_modulate_float for arbitrary-sps synthesis.
        raise ValueError(
            f"fixed-point python-flavor modulator requires a power-of-two "
            f"phase table; sps={sps} gives {len(cos_t)} entries — use "
            f"gfsk_modulate_float for arbitrary sps")
    table_mask = np.int64(len(cos_t) - 1)

    bits = np.asarray(bits, dtype=np.int8)
    nrz = (bits * 2 - 1).astype(np.int8)
    up = np.repeat(nrz, sps)  # sample-repeat upsampling (btlelib.py:161-163)

    # Reference prepends len(taps) of -1 so the filter starts settled
    # (btlelib.py:169-173) then drops that warm-up region again.
    warm = np.full(len(taps), -1, dtype=np.int8)
    x = np.concatenate([warm, up]).astype(np.int16)
    y = np.convolve(x, taps.astype(np.int16)).astype(np.int16)
    y = y[len(taps):]
    y = y[: len(up) + len(taps) - 1]
    y = np.right_shift(y, 1)  # btlelib.py:178

    acc = np.bitwise_and(np.cumsum(y), table_mask)  # btlelib.py:93
    return cos_t[acc], sin_t[acc], y


def gfsk_modulate_float(bits: np.ndarray, sps: int, amplitude: float = 127.0):
    """Floating-point modulator (btlelib.gfsk_modulation, py:131-144),
    SPS-parametric — used for synthesizing wideband test signals at
    arbitrary oversampling where the fixed-point table sizes don't apply.
    """
    h = gauss_fir(sps)
    bits = np.asarray(bits, dtype=np.float64)
    nrz = bits * 2 - 1
    up = np.repeat(nrz, sps)
    y = np.convolve(up, h)
    phase = np.cumsum(y) * 2 * np.pi * (MODULATION_INDEX / 2) / sps
    return amplitude * np.cos(phase), amplitude * np.sin(phase)


def gfsk_modulate_c(bits: np.ndarray, sps: int = 4):
    """Fixed-point modulator, ``c`` flavor (btle_tx.c:1022-1085).

    Returns interleaved-equivalent (cos_i8, sin_i8) of length
    num_bits*sps + 4*sps, bit-exact vs gen_sample_from_phy_bit.
    """
    if sps != 4:
        raise ValueError("the C flavor is defined at SAMPLE_PER_SYMBOL=4")
    taps = c_flavor_taps(sps)          # 16 entries, only 4..12 nonzero
    lg = 4 * sps                       # LEN_GAUSS_FILTER*SPS = 16
    num_bits = len(bits)
    num_sample = num_bits * sps + lg

    # Zero-stuffed impulse train with (lg-1) leading zeros
    # (btle_tx.c:1030-1041).
    x = np.zeros(lg - 1 + num_bits * sps + lg - 1, dtype=np.int16)
    idx = np.arange(num_bits) * sps + (lg - 1)
    x[idx] = np.asarray(bits, dtype=np.int16) * 2 - 1

    cos_t, sin_t = _c_tables()
    cos_out = np.empty(num_sample, dtype=np.int8)
    sin_out = np.empty(num_sample, dtype=np.int8)
    acc = np.int16(0)
    cos_out[0] = cos_t[0]
    sin_out[0] = sin_t[0]
    # Inner loop j=3..11 uses taps[16-j-1] = taps[12]..taps[4]
    # (btle_tx.c:1049-1053).
    jj = np.arange(3, lg - 4)
    w = taps[lg - jj - 1].astype(np.int32)
    for i in range(num_sample - 1):
        a = int(np.dot(w, x[i + 3 : i + 12].astype(np.int32)))
        acc = np.int16((int(acc) + a) & 1023)
        cos_out[i + 1] = cos_t[acc]
        sin_out[i + 1] = sin_t[acc]
    return cos_out, sin_out


_C_TABLES = None


def _c_tables():
    global _C_TABLES
    if _C_TABLES is None:
        phase = 2 * np.pi * np.arange(1024) / 1024
        _C_TABLES = (
            np.round(127 * np.cos(phase)).astype(np.int8),
            np.round(127 * np.sin(phase)).astype(np.int8),
        )
    return _C_TABLES


def assemble_phy_bits(
    pdu_bits: np.ndarray,
    channel: int = 37,
    crc_init_hex: str = ADV_CRC_INIT_HEX,
    access_address_hex: str = ADV_ACCESS_ADDRESS_HEX,
    phy: str = "1m",
) -> np.ndarray:
    """PDU bits -> whitened on-air bit stream (btlelib.btle_tx, py:344-393).

    phy "1m" is the reference's LE 1M framing (8-bit preamble). "2m" is
    the BLE 5 LE 2M PHY: identical AA/CRC/whitening, but a 16-symbol
    preamble (Core 5.3 Vol 6 Part B 2.1.1 — the alternation extends to
    16 bits, still chosen so the first preamble bit equals AA bit 0).
    The reference never implements 2M; everything downstream of the
    preamble is rate-agnostic, so this is the only TX-side difference.
    """
    aa_bits = B.hex_to_bits(access_address_hex)
    if channel in (37, 38, 39) and phy == "1m":
        preamble = "aa"
    else:
        preamble = "55" if aa_bits[0] == 1 else "aa"  # btlelib.py:369-374
    if phy == "2m":
        preamble = preamble * 2
    elif phy != "1m":
        raise ValueError(f"unknown phy {phy!r}")
    head = B.hex_to_bits(preamble + access_address_hex)
    pdu_at = len(head)  # 40 (1M) or 48 (2M): preamble never whitened/CRC'd
    info = np.concatenate([head, np.asarray(pdu_bits, dtype=np.int8)])
    crc = C.crc24_bits(info[pdu_at:], B.hex_to_bits(crc_init_hex))
    info_crc = np.concatenate([info, crc])
    phy_out = info_crc.copy()
    phy_out[pdu_at:] = W.whiten_bits(info_crc[pdu_at:], channel)
    return phy_out
