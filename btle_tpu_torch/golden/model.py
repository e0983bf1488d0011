"""Partial numpy copy of btle_tpu.golden.model: the float GFSK modulator
and frame assembly, enough to synthesize wideband test scenes (the
self-test and chip_smoke.py) without the JAX package.

Copied from btle_tpu/golden/model.py (gauss_fir, gfsk_modulate_float,
assemble_phy_bits); tests/test_torch_tables.py holds the copies equal
to the originals.
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
