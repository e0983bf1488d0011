"""Overlap-save block iteration over an unbounded IQ stream.

The reference scans half-buffers of 8192 samples with a copied tail overlap
equal to two max-packet spans (btle_rx.c:221-248, 2619-2637) so packets
crossing a block boundary are seen whole. Here each yielded block carries
``scan_len`` samples of territory plus a halo long enough to decode a
max-length packet whose access address starts on the last territory sample;
the iterator also threads the span-eating cursor across blocks so the
sequential consumption semantics hold stream-wide.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..rx.pipeline import required_halo

DEFAULT_SCAN_LEN = 8192  # samples, ~2 ms at 4 Msps (btle_rx.c:223)


@dataclass
class Block:
    i: np.ndarray           # (scan_len + halo,) int16 — may be zero-padded at EOF
    q: np.ndarray
    offset: int             # absolute sample index of block start
    scan_len: int           # territory length
    skip: int               # lattice positions < skip are already consumed


class OverlapBlockIterator:
    """Iterate fixed-shape blocks over a sample source.

    ``source`` yields (i_chunk, q_chunk) int16 arrays of arbitrary length.
    Every block has identical shape so the jitted scan compiles once.
    """

    def __init__(self, source, sps: int, lag: int = 1, scan_len: int = DEFAULT_SCAN_LEN):
        self.source = iter(source)
        self.scan_len = scan_len
        self.halo = required_halo(sps, lag)
        self._buf_i = np.zeros(0, dtype=np.int16)
        self._buf_q = np.zeros(0, dtype=np.int16)
        self._offset = 0
        self._skip = 0
        self._eof = False

    def _fill(self, need: int):
        while len(self._buf_i) < need and not self._eof:
            try:
                ci, cq = next(self.source)
            except StopIteration:
                self._eof = True
                break
            self._buf_i = np.concatenate([self._buf_i, np.asarray(ci, dtype=np.int16)])
            self._buf_q = np.concatenate([self._buf_q, np.asarray(cq, dtype=np.int16)])

    def __iter__(self) -> Iterator[Block]:
        total = self.scan_len + self.halo
        while True:
            self._fill(total)
            n_avail = len(self._buf_i)
            if n_avail == 0:
                return
            if n_avail < total:
                # final partial block: zero-pad the halo region
                i = np.zeros(total, dtype=np.int16)
                q = np.zeros(total, dtype=np.int16)
                i[:n_avail] = self._buf_i
                q[:n_avail] = self._buf_q
                scan = min(self.scan_len, n_avail)
                yield Block(i, q, self._offset, scan, self._skip)
                return
            yield Block(
                self._buf_i[:total].copy(), self._buf_q[:total].copy(),
                self._offset, self.scan_len, self._skip,
            )
            self._buf_i = self._buf_i[self.scan_len:]
            self._buf_q = self._buf_q[self.scan_len:]
            self._offset += self.scan_len

    def consume_to(self, absolute_pos: int):
        """Record that samples before ``absolute_pos`` were eaten by a
        decoded packet; the next block will not re-report hits inside."""
        self._skip = max(0, absolute_pos - self._offset - self.scan_len)
