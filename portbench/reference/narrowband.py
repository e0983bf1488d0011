"""Plain reference of the narrowband sniffer (one channel, integer IQ).

The semantics, and where the program has them: the 1-sample-lag
phase-difference decisions in exact integers and the 32-tap
access-address test (phy/demodulator.py), ``decode_block`` (the earliest
hits at or after a cursor, the clamped candidate window, dewhitening,
the table CRC, the RSSI mean of |I| + |Q| over the AA window; rx/
pipeline.py), ``stream_decode``'s in-order walk with its rescans
(rx/decoder.py) and the block cadence of stream/blocks.py (territory
plus a halo, the cursor carried as ``skip``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import ble

AA_BITS = 32
HDR_BITS = 16


def halo(sps: int, lag: int) -> int:
    """Samples past a block's territory that a max-length packet needs."""
    return (AA_BITS + ble.MAX_PDU_CRC_BITS) * sps + lag


def lattice(i: np.ndarray, q: np.ndarray, aa: int, sps: int, lag: int = 1):
    """(bits (N-lag,) bool, hit (N-lag-31*sps,) bool) of one block."""
    i = np.asarray(i, np.int64)
    q = np.asarray(q, np.int64)
    bits = (i[:-lag] * q[lag:] - i[lag:] * q[:-lag]) > 0
    n_hit = len(bits) - (AA_BITS - 1) * sps
    t = ble.aa_bits(aa).astype(np.int64) * 2 - 1
    s = bits.astype(np.int64) * 2 - 1
    acc = np.zeros(n_hit, np.int64)
    for j in range(AA_BITS):
        acc += s[j * sps: j * sps + n_hit] * t[j]
    return bits, acc == AA_BITS


@dataclass
class Candidates:
    """decode_block's outputs for one channel: ``slots`` earliest hits."""
    pos: np.ndarray
    valid: np.ndarray
    payload_len: np.ndarray
    len_ok: np.ndarray
    crc_ok: np.ndarray
    pdu_bytes: np.ndarray     # (slots, 42)
    mag_mean: np.ndarray      # float32
    num_hits: int


def decode_block(i, q, bits, hit, channel: int, crc_init: int, sps: int,
                 slots: int, min_pos: int, with_mag: bool) -> Candidates:
    hits = np.flatnonzero(hit)
    live = hits[hits >= min_pos]
    n = min(slots, len(live))
    pos = np.zeros(slots, np.int64)
    pos[:n] = live[:n]
    valid = np.arange(slots) < n
    kb = len(bits)
    idx = np.clip(pos[:, None] + AA_BITS * sps
                  + sps * np.arange(ble.MAX_PDU_CRC_BITS)[None, :], 0, kb - 1)
    dew = bits[idx].astype(np.int8) ^ ble.whitening_bits(channel)[None, :]
    octets = np.packbits(dew.astype(np.uint8), axis=1, bitorder="little")
    adv = ble.is_adv(channel)
    nlen = 6 if adv else 5
    plen = (dew[:, 8: 8 + nlen].astype(np.int64) << np.arange(nlen)).sum(1)
    len_ok = (plen >= 6) & (plen <= 37) if adv else plen <= 31
    match = np.zeros(slots, bool)
    for k in range(n):              # a slot past the hits is never valid
        pc = min(int(plen[k]), 37)
        crc = ble.crc24(octets[k, : pc + 2].tobytes(), crc_init)
        rcv = (int(octets[k, pc + 2]) | int(octets[k, pc + 3]) << 8
               | int(octets[k, pc + 4]) << 16)
        match[k] = crc == rcv
    if with_mag:
        win = AA_BITS * sps
        mag = np.abs(np.asarray(i, np.int64)) + np.abs(np.asarray(q, np.int64))
        c = np.concatenate([[0], np.cumsum(mag)])
        upper = np.minimum(pos + win, len(mag))
        mag_mean = ((c[upper] - c[pos]).astype(np.float32) / np.float32(win))
    else:
        mag_mean = np.zeros(slots, np.float32)
    return Candidates(pos, valid, plen, len_ok & valid, match & len_ok & valid,
                      octets.astype(np.int64), mag_mean.astype(np.float32),
                      len(live))


@dataclass
class RefEvent:
    sample_pos: int          # absolute
    ts_us: int
    crc_ok: bool
    pdu: bytes               # header + payload
    rssi_dbm: int | None


class NarrowbandWalker:
    """Blocks of territory ``scan_len`` in stream order: stream_decode's
    walk and the skip that the next block inherits."""

    def __init__(self, channel: int, aa: int, crc_init: int, sps: int,
                 scan_len: int, slots: int, rssi: bool, samples_per_us: int):
        self.channel, self.aa, self.crc_init = channel, aa, crc_init
        self.sps, self.scan_len, self.slots, self.rssi = sps, scan_len, slots, rssi
        self.samples_per_us = samples_per_us
        self.skip = 0

    def block(self, i, q, offset: int):
        """(events, [Candidates of each decode_block call], bits, hit) of
        the block at ``offset``; carries the consumed cursor on."""
        sps = self.sps
        bits, hit = lattice(i, q, self.aa, sps)
        n_lattice = len(i) - 1
        adv = ble.is_adv(self.channel)
        cursor, done = self.skip, False
        events, calls = [], []
        while not done:
            c = decode_block(i, q, bits, hit, self.channel, self.crc_init, sps,
                             self.slots, cursor, self.rssi)
            calls.append(c)
            done = True
            for k in range(self.slots):
                if not c.valid[k]:
                    break
                pos = int(c.pos[k])
                if pos < cursor:
                    continue
                if pos >= self.scan_len:
                    break
                plen = int(c.payload_len[k])
                if adv and not 6 <= plen <= 37:
                    cursor = pos + (AA_BITS + HDR_BITS) * sps
                    continue
                pc = min(plen, 37)
                if pos + (AA_BITS + (pc + 5) * 8 - 1) * sps >= n_lattice:
                    break
                rssi = (ble.rssi_dbm_from_mag(float(c.mag_mean[k]))
                        if self.rssi else None)
                events.append(RefEvent(
                    offset + pos, (offset + pos) // self.samples_per_us,
                    bool(c.crc_ok[k]), c.pdu_bytes[k, : 2 + pc].astype(np.uint8).tobytes(),
                    rssi))
                cursor = pos + (AA_BITS + HDR_BITS) * sps + (pc + 3) * 8 * sps
            else:
                if c.valid.all() and cursor < self.scan_len:
                    cursor = max(cursor, int(c.pos[-1]) + 1)
                    done = False
        self.skip = max(0, cursor - self.scan_len)
        return events, calls, bits, hit
