"""Plain reference of the sharded wideband stream (BASELINE config 5).

The deployment: ``n_time`` processes, one a card, each fed its own slice
of every step: step k of the process at time shard t holds the stream's
block b = k * n_time + t, wideband samples [b * B, (b + 1) * B) with
B = scan_len * 20. Its semantics, which this file states and the
program is held to:

- the sharded stream decodes as ONE unsharded stream at scan_len-sample
  blocks: block b is scanned over its window, the stream's samples
  [b * B - (num_taps - 1), (b + 1) * B + halo_wb) (its filter history,
  its territory and its head; zeros before the stream's start), with
  halo_wb = ((32 + 336) * sps + lag) * 20 + num_taps, whatever shard or
  step holds it;
- the walk (``wideband.Walker``: span-eating cursors, advertising length
  checks, a rescan when a channel's hits outnumber its slots) runs over
  the blocks in stream order, its cursors carried across every block
  and step, and positions are stream-absolute per-channel indices;
- a rescan reads the block window's own lattice: the plain channelizer
  on exact frames, the RSSI over channel samples truncated toward zero;
- every process hands on the same packets.

Lattices and packets come from ``wideband.py``; nothing here imports
the program. It runs on any torch device.
"""

from __future__ import annotations

import numpy as np

from . import wideband as ref

AA_BITS, MAX_PDU_CRC_BITS = 32, 336


def halo_wb(num_taps: int, sps: int = 4, lag: int = 4) -> int:
    """The head of a block's window, in wideband samples: the channel
    samples a maximum-length packet at the block's last position needs,
    and one filter span more."""
    return ((AA_BITS + MAX_PDU_CRC_BITS) * sps + lag) * ref.D + num_taps


def block_of(step: int, shard: int, n_time: int) -> int:
    """The stream block that time shard ``shard`` holds in ``step``."""
    return step * n_time + shard


def window(take, b: int, scan_len: int, num_taps: int, sps: int = 4, lag: int = 4):
    """Block b's window (int or float host arrays i, q): ``take(start, n)``
    gives the stream's samples [start, start + n) for start >= 0."""
    block_wb = scan_len * ref.D
    ctx = num_taps - 1
    start = b * block_wb - ctx
    n = ctx + block_wb + halo_wb(num_taps, sps, lag)
    if start >= 0:
        return take(start, n)
    i, q = take(0, n + start)
    pad = np.zeros(-start, i.dtype)
    return np.concatenate([pad, i]), np.concatenate([pad, q])


class Stream:
    """The reference decode of the stream, block after block from
    ``first`` (the walk's cursors start there, at the block's first
    per-channel sample)."""

    def __init__(self, take, scan_len: int, num_taps: int, cutoff_mhz: float,
                 operand: str, aa: int, crc_init: int, slots: int, device,
                 sps: int = 4, lag: int = 4, first: int = 0):
        self.take, self.scan_len, self.num_taps = take, scan_len, num_taps
        self.cutoff_mhz, self.operand, self.aa = cutoff_mhz, operand, aa
        self.sps, self.lag, self.device = sps, lag, device
        self.next = first
        self.walker = ref.Walker(scan_len, sps, slots, aa, crc_init,
                                 offset=first * scan_len)

    def lattice(self, b: int, operand: str | None = None, int_mag: bool = False):
        """Block b's (bits, hit, mag) lattices (tensors on the device) at
        the configuration's operand type, or at ``operand``."""
        xi, xq = window(self.take, b, self.scan_len, self.num_taps, self.sps, self.lag)
        return ref.block_lattice(xi, xq, self.num_taps, self.cutoff_mhz,
                                 operand or self.operand, self.aa, self.sps, self.lag,
                                 self.device, int_mag=int_mag)

    def block(self):
        """(block index, its packets [wideband.RefPacket], its lattices)
        of the next block; advances the walk."""
        b = self.next
        self.next += 1
        bits, hit, mag = self.lattice(b)

        def rescan_lattice():
            return [t.cpu().numpy() for t in self.lattice(b, "exact", int_mag=True)]

        pkts = self.walker.block(bits.cpu().numpy(), hit.cpu().numpy(),
                                 mag.cpu().numpy(), rescan_lattice)
        return b, pkts, (bits, hit, mag)

    def steps(self, n_steps: int, n_time: int) -> list:
        """The packets of the next ``n_steps`` whole steps, one list a
        step in block order (``first`` must start a step)."""
        out = []
        for _ in range(n_steps):
            out.append([p for _ in range(n_time) for p in self.block()[1]])
        return out
