"""LE Coded PHY (BLE 5 long range): FEC, pattern mapper, packet framing.

Beyond-reference: JiaoXianjun/BTLE is LE-1M only (its chip doc lists
"LE 1M, with uncoded data" as the supported PHY). This module adds the
BLE 5 Coded PHY per Core Spec Vol 6 Part B:

* §2.2 packet format — Preamble (80 symbols = 10 repetitions of
  '00111100'), FEC block 1 [Access Address (32) | CI (2) | TERM1 (3)]
  always coded S=8, FEC block 2 [PDU | CRC24 | TERM2 (3)] coded S=8
  (CI=0b00, 125 kb/s) or S=2 (CI=0b01, 500 kb/s).
* §3.3.1 FEC encoder — non-systematic non-recursive rate-1/2
  convolutional code, constraint length K=4 (FEC_G0/FEC_G1 below;
  TERM bits flush the shift register to zero so Viterbi termination is
  exact).
* §3.3.2 pattern mapper — P=1 at S=2 (each FEC bit is one symbol),
  P=4 at S=8 (FEC bit 0 -> symbols 0011, bit 1 -> 1100).

Whitening (same LFSR as 1M, §3.2) applies to PDU+CRC BEFORE FEC
encoding; AA/CI/TERM1 are never whitened. CRC24 is the 1M CRC over the
PDU. The symbol rate is 1 Msym/s GFSK — the existing modulators and the
wideband channelizer work unchanged at sps = samples per symbol.

All coding constants live HERE and nowhere else. This environment has
no off-the-air Coded captures (the reference has none either — it
predates LE Coded support) so conformance is evidenced by structural
self-consistency: exact Viterbi termination, pattern-mapper inverses,
end-to-end loopbacks through AWGN showing the expected ~coding gain
over uncoded 1M (tests/test_coded.py).
"""

from __future__ import annotations

import numpy as np

from . import bits as B
from . import crc24 as C
from . import whitening as W

# --- §3.3.1 FEC encoder -----------------------------------------------------
# Generator taps over [x^0, x^1, x^2, x^3] (current input is x^0; x^k is
# the bit k steps in the past). Rate 1/2: each input bit emits a0 (G0)
# then b0 (G1), a0 first on air.
#   G0(x) = x^3 + x^2 + 1,  G1(x) = x^3 + x^2 + x + 1   (§3.3.1)
FEC_G0 = (1, 0, 1, 1)
FEC_G1 = (1, 1, 1, 1)
FEC_K = 4
N_TERM = 3                     # TERM1/TERM2: zeros flushing the register

# --- §3.3.2 pattern mapper --------------------------------------------------
P4_MAP = {0: (0, 0, 1, 1), 1: (1, 1, 0, 0)}   # S=8: one FEC bit -> 4 symbols

# --- §2.2 packet format -----------------------------------------------------
PREAMBLE_UNIT = (0, 0, 1, 1, 1, 1, 0, 0)       # repeated 10 times
N_PREAMBLE_SYMBOLS = 80
CI_S8 = 0                       # FEC2 coded S=8 (125 kb/s)
CI_S2 = 1                       # FEC2 coded S=2 (500 kb/s)


def preamble_symbols() -> np.ndarray:
    return np.tile(np.asarray(PREAMBLE_UNIT, np.int8),
                   N_PREAMBLE_SYMBOLS // len(PREAMBLE_UNIT))


def fec_encode(bits: np.ndarray, state: int = 0) -> np.ndarray:
    """Rate-1/2 convolutional encode (no termination appended here).

    bits: (N,) 0/1. Returns (2N,) FEC bits [a0 b0 a1 b1 ...].
    """
    bits = np.asarray(bits, np.int8)
    out = np.empty(2 * len(bits), np.int8)
    # state holds the last K-1 inputs, bit k-1 = input k steps ago
    s = state
    for i, x in enumerate(bits):
        reg = (int(x), s & 1, (s >> 1) & 1, (s >> 2) & 1)  # x^0..x^3
        out[2 * i] = sum(g & r for g, r in zip(FEC_G0, reg)) & 1
        out[2 * i + 1] = sum(g & r for g, r in zip(FEC_G1, reg)) & 1
        s = ((s << 1) | int(x)) & ((1 << (FEC_K - 1)) - 1)
    return out


def pattern_map(fec_bits: np.ndarray, s: int) -> np.ndarray:
    """FEC bits -> on-air symbols (S=2: identity; S=8: P=4 map)."""
    fec_bits = np.asarray(fec_bits, np.int8)
    if s == 2:
        return fec_bits.copy()
    if s == 8:
        lut = np.asarray([P4_MAP[0], P4_MAP[1]], np.int8)
        return lut[fec_bits].reshape(-1)
    raise ValueError(f"S must be 2 or 8, got {s}")


def pattern_demap_soft(symbols: np.ndarray, s: int) -> np.ndarray:
    """Soft symbols (+1 = bit 1, -1 = bit 0, fractional ok) -> per-FEC-bit
    soft metrics (positive = bit 1). S=8 correlates each 4-symbol group
    against the two patterns."""
    x = np.asarray(symbols, np.float64)
    if s == 2:
        return x.copy()
    if s == 8:
        g = x[: 4 * (len(x) // 4)].reshape(-1, 4)
        p1 = np.asarray(P4_MAP[1], np.float64) * 2 - 1
        return g @ p1                      # corr(1-pattern) - corr(0) ∝ this
    raise ValueError(f"S must be 2 or 8, got {s}")


def assemble_coded_phy(pdu_bits: np.ndarray, channel: int, s: int = 8,
                       access_address_hex: str = "d6be898e",
                       crc_init_hex: str = "555555") -> np.ndarray:
    """PDU bits -> full on-air Coded-PHY symbol stream (LSB-first bits).

    Preamble | FEC1{AA, CI, TERM1} @S=8 | FEC2{whitened(PDU+CRC), TERM2} @s.
    """
    pdu_bits = np.asarray(pdu_bits, np.int8)
    aa_bits = B.hex_to_bits(access_address_hex)
    ci = CI_S2 if s == 2 else CI_S8
    ci_bits = np.asarray([(ci >> k) & 1 for k in range(2)], np.int8)
    fec1_in = np.concatenate(
        [aa_bits, ci_bits, np.zeros(N_TERM, np.int8)])
    fec1 = pattern_map(fec_encode(fec1_in), 8)

    crc_bits = C.crc24_bits(pdu_bits, B.hex_to_bits(crc_init_hex))
    body = np.concatenate([pdu_bits, crc_bits]).astype(np.int8)
    body ^= W.whitening_bits(channel, len(body))
    fec2_in = np.concatenate([body, np.zeros(N_TERM, np.int8)])
    fec2 = pattern_map(fec_encode(fec2_in), s)

    return np.concatenate([preamble_symbols(), fec1, fec2]).astype(np.int8)


def coded_aa_symbols(access_address_hex: str = "d6be898e",
                     s2: int | None = None) -> np.ndarray:
    """The fixed FEC1 symbol pattern for an access address: coded
    AA+CI+TERM1 (CI per s2, default S=8's CI). 296 symbols — the sync
    correlator's unique word (8x the energy of the uncoded 32-bit AA)."""
    aa_bits = B.hex_to_bits(access_address_hex)
    ci = CI_S2 if s2 == 2 else CI_S8
    ci_bits = np.asarray([(ci >> k) & 1 for k in range(2)], np.int8)
    fec1_in = np.concatenate([aa_bits, ci_bits, np.zeros(N_TERM, np.int8)])
    return pattern_map(fec_encode(fec1_in), 8)


def fec1_symbol_count() -> int:
    return (32 + 2 + N_TERM) * 2 * 4


def fec2_symbol_count(n_pdu_bits: int, s: int) -> int:
    p = 1 if s == 2 else 4
    return (n_pdu_bits + 24 + N_TERM) * 2 * p
