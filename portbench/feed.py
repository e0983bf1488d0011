"""The wideband cells' sample feed (feed.cpp), bound with ctypes.

Built on first use with g++ into build/portbench/ inside the checkout,
keyed by a hash of the source and the flags, as the program builds its
own runtime; later runs of the checkout load it. The thread writes
through the ring's own C entry point (``iq_ring_write_i16`` of the
program's runtime library) and records every write: the first
generated pair, the pairs the ring took, when it was due and when it
returned, on the clock of ``time.perf_counter``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "feed.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "portbench"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")


def _library() -> ctypes.CDLL:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update("\0".join(FLAGS).encode())
    path = BUILD_DIR / f"feed-{h.hexdigest()[:12]}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *FLAGS, "-o", tmp, str(SOURCE)], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(path))
    p, u64, f64 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_double
    lib.feed_start.restype = p
    lib.feed_start.argtypes = [p, p, p, p, u64, u64, f64, u64, f64, u64, p, p, p, p]
    lib.feed_stop.restype = u64
    lib.feed_stop.argtypes = [p]
    lib.feed_now.restype = f64
    lib.feed_now.argtypes = []
    return lib


class NativeFeed:
    """Writes the scene ``iq`` (interleaved int16), looped, into ``ring``
    in ``write_pairs`` writes: paced at ``rate_msps`` from ``t0``, or
    closed loop when ``rate_msps`` is None. ``writes`` after ``stop``:
    (first generated pair, pairs, pairs taken, due, written) a write."""

    def __init__(self, ring, iq: np.ndarray, write_pairs: int,
                 rate_msps: float | None, capacity: int, max_writes: int):
        from btle_tpu_torch import runtime

        self.lib = _library()
        rt = ctypes.CDLL(str(runtime.library_path()))
        self._write = ctypes.cast(rt.iq_ring_write_i16, ctypes.c_void_p).value
        self._avail = ctypes.cast(rt.iq_ring_available, ctypes.c_void_p).value
        self.ring, self.iq = ring, np.ascontiguousarray(iq, np.int16)
        self.write_pairs, self.rate = write_pairs, rate_msps
        self.capacity = capacity
        self.gen = np.zeros(max_writes, np.int64)
        self.took = np.zeros(max_writes, np.int64)
        self.due = np.zeros(max_writes, np.float64)
        self.done = np.zeros(max_writes, np.float64)
        self.writes: list = []
        self._h = None

    def now(self) -> float:
        return self.lib.feed_now()

    def start(self, t0: float):
        ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
        self._h = self.lib.feed_start(
            self.ring._ptr, self._write, self._avail, ptr(self.iq),
            len(self.iq) // 2, self.write_pairs, (self.rate or 0.0) * 1e6,
            self.capacity, t0, len(self.gen), ptr(self.gen), ptr(self.took),
            ptr(self.due), ptr(self.done))

    def stop(self):
        if self._h is None:
            return
        n = int(self.lib.feed_stop(self._h))
        self._h = None
        self.writes = [(int(self.gen[k]), self.write_pairs, int(self.took[k]),
                        float(self.due[k]), float(self.done[k])) for k in range(n)]

    def delivered(self):
        """Per write: (first generated pair, first delivered pair, pairs
        delivered, due) as arrays; the ring keeps a write's head."""
        n = len(self.writes)
        took = self.took[:n].copy()
        start = np.concatenate([[0], np.cumsum(took)[:-1]]).astype(np.int64)
        return self.gen[:n].copy(), start, took, self.due[:n].copy()
