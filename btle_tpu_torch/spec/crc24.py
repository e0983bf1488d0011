"""BLE CRC-24 in three equivalent forms.

The reference carries the same CRC in two styles that we must stay
bit-compatible with:
  * a bit-serial LFSR over the PDU bit stream (btlelib.py:191-219
    ``crc24_core``; btle_tx.c:1463-1494 ``crc24``), whose 24-bit result is
    emitted reversed and transmitted LSB-first, and
  * a reflected byte-table update (btle_rx.c crc_table/crc_update
    btle_rx.c:971-1004,1211-1222; btle_tx.c:1441-1461) operating on packed
    octets with the bit-reversed init value (0x555555 <-> 0xAAAAAA).

We derive the 256-entry table from the BLE polynomial x^24 + x^10 + x^9 +
x^6 + x^4 + x^3 + x + 1 (reflected form 0xDA6000) instead of transcribing
the reference table; tests assert equality of behaviour against the LFSR.

The table form is the one the TPU pipeline uses (a 47-step ``lax.scan`` of
gather + xor, vmapped over packet candidates).
"""

from __future__ import annotations

import numpy as np

from .bits import bits_to_uint, hex_to_bits, reverse_bits24, swap_bytes24

BLE_CRC24_POLY = 0x00065B           # normal (MSB-first) representation
BLE_CRC24_POLY_REFLECTED = 0xDA6000  # bit-reversed, for LSB-first updates


def _make_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for b in range(256):
        crc = b
        for _ in range(8):
            if crc & 1:
                crc = (crc >> 1) ^ BLE_CRC24_POLY_REFLECTED
            else:
                crc >>= 1
        table[b] = crc
    return table


CRC24_TABLE = _make_table()


def crc24_bits(bits: np.ndarray, init_bits: np.ndarray) -> np.ndarray:
    """Bit-serial LFSR. Returns the 24 on-air CRC bits.

    Exact port of the update network in btlelib.crc24_core
    (btlelib.py:191-219); ``init_bits`` is the LSB-first expansion of the
    init hex string (e.g. hex_to_bits('555555')).
    """
    s = np.asarray(init_bits, dtype=np.int8).copy()
    taps = (1, 3, 4, 6, 9, 10)  # positions whose next value xors in the feedback bit
    for b in np.asarray(bits).ravel():
        new = (int(s[23]) + int(b)) & 1
        nxt = np.empty(24, dtype=np.int8)
        nxt[0] = new
        nxt[2] = s[1]
        nxt[5] = s[4]
        nxt[7] = s[6]
        nxt[8] = s[7]
        nxt[11:24] = s[10:23]
        for t in taps:
            nxt[t] = (int(s[t - 1]) + new) & 1
        s = nxt
    return s[::-1].copy()


def crc24_bytes(data: np.ndarray, init: int) -> int:
    """Reflected table update over packed octets (btle_rx.c:1211-1228).

    ``init`` is in table convention: the bit-reversal of the LFSR init
    (advertising channels use 0xAAAAAA).
    """
    crc = init & 0xFFFFFF
    for byte in np.asarray(data, dtype=np.uint8).ravel():
        idx = (crc ^ int(byte)) & 0xFF
        crc = (int(CRC24_TABLE[idx]) ^ (crc >> 8)) & 0xFFFFFF
    return crc


def lfsr_init_to_table_init(init_hex: str) -> int:
    """'555555' -> 0xAAAAAA: bit-reverse of the LSB-first init bit vector."""
    return reverse_bits24(bits_to_uint(hex_to_bits(init_hex)))


def crc_init_reorder(crc_init: int) -> int:
    """Sniffed CONNECT_REQ CRCInit -> internal table init.

    Exact port of crc_init_reorder (btle_rx.c:1969-1993): byte-swap the
    24-bit value, then reverse its bits.
    """
    return reverse_bits24(swap_bytes24(crc_init & 0xFFFFFF))


def crc_received_from_bytes(crc_bytes: np.ndarray) -> int:
    """3 on-air CRC octets -> table-convention integer (btle_rx.c:2010-2014)."""
    b = np.asarray(crc_bytes, dtype=np.uint8).ravel()
    return (int(b[2]) << 16) | (int(b[1]) << 8) | int(b[0])


def crc_to_bytes(crc: int) -> np.ndarray:
    """Table-convention CRC -> the 3 octets as transmitted
    (btle_tx.c:1897-1900)."""
    return np.array([crc & 0xFF, (crc >> 8) & 0xFF, (crc >> 16) & 0xFF], dtype=np.uint8)


def _byte_step(state: int, byte: int) -> int:
    """One reflected table update (btle_rx.c:1211-1222)."""
    return int(CRC24_TABLE[(state ^ byte) & 0xFF]) ^ (state >> 8)


def linear_crc_matrices(max_bytes: int = 42):
    """GF(2)-linear form of the prefix-state table CRC.

    The table update is affine over GF(2) in (state, data bits), so the
    state after every prefix length is one bit-matrix product — on TPU
    this replaces a 42-step scan of table gathers with a single MXU
    matmul over the candidate batch.

    Returns (V, Minit), float32 0/1 matrices:
      V[j, (L-1)*24 + t]     — data bit j's contribution to state bit t
                               after L bytes (bit j = LSB-first bit k of
                               byte j//8; zero for j >= 8L)
      Minit[b, (L-1)*24 + t] — init-state bit b's contribution
    so state_bits(L) = (data_bits @ V + init_bits @ Minit) mod 2 at
    column block L-1, for L = 1..max_bytes.
    """
    nbits = 8 * max_bytes
    V = np.zeros((nbits, max_bytes * 24), dtype=np.float32)
    for j in range(nbits):
        kb, k = divmod(j, 8)
        state = 0
        for L in range(1, max_bytes + 1):
            state = _byte_step(state, (1 << k) if (L - 1) == kb else 0)
            for t in range(24):
                V[j, (L - 1) * 24 + t] = (state >> t) & 1
    Minit = np.zeros((24, max_bytes * 24), dtype=np.float32)
    for b in range(24):
        state = 1 << b
        for L in range(1, max_bytes + 1):
            state = _byte_step(state, 0)
            for t in range(24):
                Minit[b, (L - 1) * 24 + t] = (state >> t) & 1
    return V, Minit
