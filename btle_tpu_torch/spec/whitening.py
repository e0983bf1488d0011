"""BLE data whitening (scrambling) sequences.

The whitener is a 7-bit LFSR (x^7 + x^4 + 1) seeded with
``1 | channel[5:0]`` and applied to every bit after the access address
(btlelib.py:226-268 ``scramble_core``; btle_tx.c:1502-1530 ``scramble``).

Because the sequence depends only on the channel, the whole whitening
operation is a precomputed XOR table — the reference ships it as
``scramble_table[40][42]`` (host/btle-tools/src/scramble_table.h, generated
by matlab/test_scramble_gen_all_channel.m). We generate the same table from
the LFSR definition; tests spot-check byte values against the reference
table.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .constants import MAX_PDU_CRC_BITS, NUM_CHANNELS


@lru_cache(maxsize=512)
def whitening_bits(channel: int, num_bits: int) -> np.ndarray:
    """The raw whitening bit sequence for ``channel`` (int8 of 0/1).

    Cached (the sequence is channel-constant and regenerating the LFSR per
    streaming block costs ~0.5 ms); treat the returned array as read-only.
    """
    s = np.empty(7, dtype=np.int8)
    s[0] = 1
    for k in range(6):
        s[1 + k] = (channel >> (5 - k)) & 1
    out = np.empty(num_bits, dtype=np.int8)
    for i in range(num_bits):
        out[i] = s[6]
        nxt = np.empty(7, dtype=np.int8)
        nxt[0] = s[6]
        nxt[1] = s[0]
        nxt[2] = s[1]
        nxt[3] = s[2]
        nxt[4] = (s[3] + s[6]) & 1
        nxt[5] = s[4]
        nxt[6] = s[5]
        s = nxt
    out.setflags(write=False)
    return out


def whiten_bits(bits: np.ndarray, channel: int) -> np.ndarray:
    """XOR a PDU(+CRC) bit stream with the channel's whitening sequence.

    Equivalent to btlelib.scramble_core applied from the first PDU bit.
    Whitening is an involution, so this both whitens and de-whitens.
    """
    bits = np.asarray(bits, dtype=np.int8)
    return bits ^ whitening_bits(channel, len(bits))


def whitening_bytes(channel: int, num_bytes: int) -> np.ndarray:
    """Whitening sequence packed LSB-first into octets.

    Row ``channel`` of the reference's scramble_table.h for num_bytes=42.
    """
    seq = whitening_bits(channel, num_bytes * 8)
    return np.packbits(seq.astype(np.uint8), bitorder="little")


def make_whitening_table(num_bytes: int = 42) -> np.ndarray:
    """(40, num_bytes) uint8 table == scramble_table.h for num_bytes=42."""
    return np.stack([whitening_bytes(ch, num_bytes) for ch in range(NUM_CHANNELS)])


def make_whitening_bit_table(num_bits: int = MAX_PDU_CRC_BITS) -> np.ndarray:
    """(40, num_bits) int8 bit table used by the TPU de-whitening XOR."""
    return np.stack([whitening_bits(ch, num_bits) for ch in range(NUM_CHANNELS)])
