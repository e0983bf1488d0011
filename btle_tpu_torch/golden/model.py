"""Numpy copy of btle_tpu.golden.model, the bit-true golden chain: the
pulse shapes, phase tables and the three GFSK modulators (the two
fixed-point flavors and the float one), frame assembly, the golden
transmitter and receiver (first-CRC-OK-phase-wins) and the channel
impairments — the oracle of the port's TX path (``phy/modulator.py``,
``tx/``) and the synthesis of test scenes, without the JAX package.

Copied from btle_tpu/golden/model.py (gauss_fir, sin_cos_tables,
c_flavor_pulse, c_flavor_taps, gfsk_modulate_python,
gfsk_modulate_float, gfsk_modulate_c, _c_tables, assemble_phy_bits,
btle_tx, demod_symbol_lag, search_bit_sequence, GoldenRxResult, btle_rx,
add_freq_sampling_error, add_noise); tests/test_torch_tables.py holds
the copies equal to the originals.
"""

from __future__ import annotations

from dataclasses import dataclass

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


def btle_tx(
    pdu_bits: np.ndarray,
    channel: int = 37,
    crc_init_hex: str = ADV_CRC_INIT_HEX,
    access_address_hex: str = ADV_ACCESS_ADDRESS_HEX,
    sps: int = 8,
    flavor: str = "python",
    phy: str = "1m",
):
    """Full golden transmitter. Returns (i, q, phy_bits).

    phy "2m" emits LE 2M framing (16-bit preamble); the modulator is
    symbol-indexed so sps samples/symbol then means 2*sps Msps on air.
    """
    phy = assemble_phy_bits(pdu_bits, channel, crc_init_hex,
                            access_address_hex, phy=phy)
    if flavor == "python":
        cos_o, sin_o, _ = gfsk_modulate_python(phy, sps)
    elif flavor == "c":
        cos_o, sin_o = gfsk_modulate_c(phy, sps)
    else:
        raise ValueError(flavor)
    return cos_o, sin_o, phy


# --------------------------------------------------------------------------
# Receiver
# --------------------------------------------------------------------------


def demod_symbol_lag(i: np.ndarray, q: np.ndarray):
    """Symbol-rate phase-difference decision (btlelib.py:395-400).

    Inputs are already decimated to symbol rate; lag is one symbol.
    """
    i = np.asarray(i, dtype=np.int32)
    q = np.asarray(q, dtype=np.int32)
    d = i[:-1] * q[1:] - i[1:] * q[:-1]
    return (d > 0).astype(np.int8), d


def search_bit_sequence(bits: np.ndarray, pattern: np.ndarray) -> int:
    """First exact-match index or -1 (btlelib.py:402-412)."""
    bits = np.asarray(bits)
    pattern = np.asarray(pattern)
    n, m = len(bits), len(pattern)
    for s in range(n - m + 1):
        if np.array_equal(bits[s : s + m], pattern):
            return s
    return -1


@dataclass
class GoldenRxResult:
    pdu_bits: np.ndarray
    crc_ok: bool
    payload_len: int
    phy_bits: np.ndarray
    bits_all_phases: np.ndarray
    decision_all_phases: np.ndarray
    best_phase: int


def btle_rx(
    i: np.ndarray,
    q: np.ndarray,
    channel: int = 37,
    crc_init_hex: str = ADV_CRC_INIT_HEX,
    access_address_hex: str = ADV_ACCESS_ADDRESS_HEX,
    sps: int = 8,
) -> GoldenRxResult:
    """Golden receiver with first-CRC-OK-phase-wins semantics.

    Exact port of btlelib.btle_rx (btlelib.py:414-541), SPS-parametric.
    """
    aa_bits = B.hex_to_bits(access_address_hex)
    crc_init_bits = B.hex_to_bits(crc_init_hex)
    i = np.asarray(i, dtype=np.int16)
    q = np.asarray(q, dtype=np.int16)

    num_sample = len(i)
    num_bit = int(round(num_sample / sps)) - 1
    bits_all = np.zeros((sps, num_bit), dtype=np.int8)
    dec_all = np.zeros((sps, num_bit), dtype=np.int32)

    pdu_bits = np.array([], dtype=np.int8)
    phy_bits = np.array([], dtype=np.int8)
    payload_len = 0
    crc_ok = False
    phase = 0
    for phase in range(sps):
        b, d = demod_symbol_lag(i[phase::sps], q[phase::sps])
        n = min(len(b), num_bit)
        bits_all[phase, :n] = b[:n]
        dec_all[phase, :n] = d[:n]
        if n < num_bit and len(b):
            # Reference pads the tail with the last demodulated value
            # (btlelib.py:465-467).
            bits_all[phase, -1] = b[-1]
            dec_all[phase, -1] = d[-1]

        start = search_bit_sequence(bits_all[phase], aa_bits)
        if start == -1:
            continue
        phy_bits = np.concatenate(
            [np.zeros(8, dtype=np.int8), bits_all[phase, start:]]
        )  # fake preamble, btlelib.py:474
        dewhitened = phy_bits.copy()
        dewhitened[40:] = W.whiten_bits(phy_bits[40:], channel)

        len_bits = 6 if channel in (37, 38, 39) else 5
        payload_len = B.bits_to_uint(dewhitened[48 : 48 + len_bits])
        crc_start = 40 + 16 + payload_len * 8
        if crc_start + 24 > len(dewhitened):
            crc_start = len(dewhitened) - 24  # btlelib.py:488-490
        pdu_bits = dewhitened[40:crc_start]
        crc_calc = C.crc24_bits(pdu_bits, crc_init_bits)
        crc_rx = dewhitened[crc_start : crc_start + 24]
        crc_ok = bool(np.array_equal(crc_calc, crc_rx))
        if crc_ok:
            break

    return GoldenRxResult(pdu_bits, crc_ok, payload_len, phy_bits, bits_all, dec_all, phase)


# --------------------------------------------------------------------------
# Channel impairments (btlelib.py:823-873)
# --------------------------------------------------------------------------


def add_freq_sampling_error(i, q, ppm_value: float, sps: int = 8, fc_hz: float = 2450e6):
    """Joint sampling-clock and carrier frequency offset model."""
    i = np.asarray(i, dtype=np.double)
    q = np.asarray(q, dtype=np.double)
    err = ppm_value / 1e6
    xp = np.linspace(0, len(i) - 1, len(i))
    x = xp * (1.0 + err)
    i2 = np.interp(x, xp, i)
    q2 = np.interp(x, xp, q)
    fo = err * fc_hz
    new_ts = (1.0 / sps) * 1e-6 * (1 + err)
    rot = np.exp(1j * 2.0 * np.pi * fo * new_ts * xp)
    iq = (i2 + 1j * q2) * rot
    return np.real(iq), np.imag(iq), fo


def add_noise(i, q, snr_db: float, rng: np.random.Generator | None = None):
    """AWGN with SNR referenced to int8 peak power 127^2 (btlelib.py:859-873)."""
    rng = rng or np.random.default_rng()
    sigma = 127 / np.power(10, snr_db / 20) / np.sqrt(2)
    i = np.asarray(i, dtype=np.double) + rng.normal(0, sigma, len(i))
    q = np.asarray(q, dtype=np.double) + rng.normal(0, sigma, len(q))
    return i, q
