"""ctypes bindings for the native sample-transport runtime.

Port of btle_tpu/runtime: ``runtime.cpp`` here is a byte-equal copy of
the JAX package's source (an SPSC int16 IQ ring with overlap-save block
extraction, and a UDP listener thread that fills it). ``read_ahead.cpp``
is the port's own: a native thread that reads the ring's next block
while the live loop works (``ReadAhead``). On first use each source is
compiled with g++ (``-O3 -march=native -shared -fPIC -std=c++17
-lpthread``) into ``build/btle_tpu_torch/`` at the repository root,
keyed by a hash of the source and the flags, as ``_build`` keys the
CUDA kernels, and loaded with ctypes. ``available()`` says whether that
worked; the live path has no pure-Python stand-in.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator

import numpy as np

from .._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "runtime.cpp"
READ_AHEAD_SOURCE = SOURCE.with_name("read_ahead.cpp")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_FMT_CODES = {"i8": 0, "i16": 1, "f32": 2}
_lib: ctypes.CDLL | None = None
_tried = False
_ra_lib: ctypes.CDLL | None = None


def library_path(source: Path = SOURCE) -> Path:
    h = hashlib.sha1(source.read_bytes())
    h.update("\0".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:12]}.so"


def _build(source: Path = SOURCE) -> bool:
    """Compile ``source`` into library_path(source) (atomically: a
    temporary file renamed into place, so a concurrent process never
    loads half a library). False when g++ is missing or fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(source), "-lpthread"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, library_path(source))
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def _open(source: Path) -> ctypes.CDLL | None:
    if not library_path(source).exists() and not _build(source):
        return None
    try:
        return ctypes.CDLL(str(library_path(source)))
    except OSError:
        return None


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib = _open(SOURCE)
    if lib is None:
        return None

    u64 = ctypes.c_uint64
    p = ctypes.c_void_p
    sz = ctypes.c_size_t
    lib.iq_ring_create.restype = p
    lib.iq_ring_create.argtypes = [sz]
    lib.iq_ring_destroy.argtypes = [p]
    lib.iq_ring_available.restype = u64
    lib.iq_ring_available.argtypes = [p]
    lib.iq_ring_dropped.restype = u64
    lib.iq_ring_dropped.argtypes = [p]
    lib.iq_ring_total_written.restype = u64
    lib.iq_ring_total_written.argtypes = [p]
    for name, ctype in (("i8", ctypes.c_int8), ("i16", ctypes.c_int16)):
        fn = getattr(lib, f"iq_ring_write_{name}")
        fn.restype = u64
        fn.argtypes = [p, ctypes.POINTER(ctype), sz]
    lib.iq_ring_write_f32.restype = u64
    lib.iq_ring_write_f32.argtypes = [p, ctypes.POINTER(ctypes.c_float), sz,
                                      ctypes.c_float]
    i16p = ctypes.POINTER(ctypes.c_int16)
    lib.iq_ring_read_block.restype = u64
    lib.iq_ring_read_block.argtypes = [p, i16p, i16p, sz, sz]
    lib.iq_ring_drain.restype = u64
    lib.iq_ring_drain.argtypes = [p, i16p, i16p, sz]
    lib.udp_source_start.restype = p
    lib.udp_source_start.argtypes = [p, ctypes.c_uint16, ctypes.c_int]
    lib.udp_source_stop.argtypes = [p]
    lib.udp_source_datagrams.restype = u64
    lib.udp_source_datagrams.argtypes = [p]
    lib.deinterleave_i8.argtypes = [ctypes.POINTER(ctypes.c_int8), sz, i16p, i16p]
    lib.deinterleave_i16.argtypes = [ctypes.POINTER(ctypes.c_int16), sz, i16p, i16p]
    lib.deinterleave_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), sz, ctypes.c_float, i16p, i16p]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the native runtime built and loaded."""
    return _load() is not None


def _load_read_ahead() -> ctypes.CDLL:
    global _ra_lib
    if _ra_lib is None:
        lib = _open(READ_AHEAD_SOURCE)
        if lib is None:
            raise RuntimeError("native read-ahead unavailable (g++ build failed)")
        p, sz = ctypes.c_void_p, ctypes.c_size_t
        lib.read_ahead_open.restype = p
        lib.read_ahead_open.argtypes = [p, p, sz, sz]
        lib.read_ahead_submit.restype = None
        lib.read_ahead_submit.argtypes = [p, p, p]
        lib.read_ahead_done.restype = ctypes.c_int
        lib.read_ahead_done.argtypes = [p]
        lib.read_ahead_wait.restype = ctypes.c_uint64
        lib.read_ahead_wait.argtypes = [p]
        lib.read_ahead_close.restype = None
        lib.read_ahead_close.argtypes = [p]
        lib.read_ahead_open_count.restype = ctypes.c_int
        lib.read_ahead_open_count.argtypes = []
        _ra_lib = lib
    return _ra_lib


def read_ahead_open_count() -> int:
    """ReadAhead threads started and not yet joined, in this process."""
    return int(_load_read_ahead().read_ahead_open_count())


def _check_out(out, total: int):
    """``out`` as (i, q), two writable C-contiguous int16 arrays of
    ``total`` samples."""
    i, q = out
    for a in (i, q):
        if not (isinstance(a, np.ndarray) and a.dtype == np.int16
                and a.shape == (total,) and a.flags.c_contiguous
                and a.flags.writeable):
            raise ValueError(f"out must be two writable C-contiguous "
                             f"int16 arrays of {total} samples")
    return i, q


class IqRingBuffer:
    """Native SPSC IQ ring with overlap-save block extraction."""

    def __init__(self, capacity_pairs: int = 1 << 22):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable (g++ build failed)")
        self._lib = lib
        self._ptr = lib.iq_ring_create(capacity_pairs)
        self._refused_uncounted = 0   # refusals the native counter missed

    def close(self):
        if self._ptr:
            self._lib.iq_ring_destroy(self._ptr)
            self._ptr = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -------------------------- producer --------------------------
    def write(self, interleaved: np.ndarray, fmt: str = "i16",
              scale: float = 256.0) -> int:
        """Append interleaved I/Q pairs (i8, i16, or f32 scaled by
        ``scale`` and rounded to int16); returns the pairs written.

        Every refused pair counts in ``dropped``. The native writers
        convert in 4096-pair chunks and stop at the first chunk the ring
        cannot take whole, counting only that chunk's shortfall; the
        rest of a refused write is counted here. The native UDP thread
        (runtime.cpp's listener) writes through the same chunked writers
        and still undercounts a datagram of more than 4096 pairs that
        meets a full ring."""
        arr = np.ascontiguousarray(interleaved)
        n_pairs = len(arr) // 2
        lib, ptr = self._lib, self._ptr
        counted = lib.iq_ring_dropped(ptr)
        if fmt == "i8":
            cp = arr.astype(np.int8, copy=False).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int8))
            written = int(lib.iq_ring_write_i8(ptr, cp, n_pairs))
        elif fmt == "i16":
            cp = arr.astype(np.int16, copy=False).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int16))
            written = int(lib.iq_ring_write_i16(ptr, cp, n_pairs))
        elif fmt == "f32":
            cp = arr.astype(np.float32, copy=False).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float))
            written = int(lib.iq_ring_write_f32(ptr, cp, n_pairs, scale))
        else:
            raise ValueError(fmt)
        counted = lib.iq_ring_dropped(ptr) - counted
        self._refused_uncounted += n_pairs - written - counted
        return written

    # -------------------------- consumer --------------------------
    def read_block(self, scan_len: int, halo: int, out=None):
        """(i, q) int16 of scan_len+halo samples, or None if not enough
        buffered. Consumes scan_len samples (overlap-save). ``out``, a
        pair of writable C-contiguous int16 arrays of scan_len+halo
        samples, receives the block in place of two new arrays."""
        total = scan_len + halo
        if out is None:
            i = np.empty(total, dtype=np.int16)
            q = np.empty(total, dtype=np.int16)
        else:
            i, q = _check_out(out, total)
        got = self._lib.iq_ring_read_block(
            self._ptr, i.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), scan_len, halo)
        if got == 0:
            return None
        return i, q

    def drain(self, max_pairs: int = 1 << 22):
        i = np.empty(max_pairs, dtype=np.int16)
        q = np.empty(max_pairs, dtype=np.int16)
        n = self._lib.iq_ring_drain(
            self._ptr, i.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), max_pairs)
        return i[:n], q[:n]

    @property
    def available_pairs(self) -> int:
        return int(self._lib.iq_ring_available(self._ptr))

    @property
    def dropped(self) -> int:
        """Pairs the ring refused: the native counter, and what the
        port's ``write`` counted beyond it."""
        return int(self._lib.iq_ring_dropped(self._ptr)) + self._refused_uncounted

    @property
    def total_written(self) -> int:
        return int(self._lib.iq_ring_total_written(self._ptr))

    def read_ahead(self, scan_len: int, halo: int) -> "ReadAhead":
        """A native thread that makes this ring's ``read_block(scan_len,
        halo, out)`` calls while the caller works; close it before the
        ring."""
        return ReadAhead(self, scan_len, halo)


class ReadAhead:
    """One native thread that reads ``ring``'s next block into views the
    caller lends it, one request at a time: ``submit(out)`` starts the
    read, ``done()`` says whether it has ended, ``take()`` waits for it
    and gives ``out`` as (i, q), or None when the ring held less than a
    block (the ring is then left as it was). ``close()`` waits for a read
    in flight and joins the thread. The thread never takes the
    interpreter lock."""

    def __init__(self, ring: IqRingBuffer, scan_len: int, halo: int):
        self._lib = _load_read_ahead()
        read = ctypes.cast(ring._lib.iq_ring_read_block, ctypes.c_void_p)
        self._ring = ring        # not collected while the thread reads it
        self._total = scan_len + halo
        self._out = None
        self._ptr = self._lib.read_ahead_open(read, ring._ptr, scan_len, halo)
        if not self._ptr:
            raise RuntimeError("could not start the read-ahead thread")

    @property
    def busy(self) -> bool:
        """A read was submitted and not yet taken."""
        return self._out is not None

    def submit(self, out):
        if self.busy:
            raise RuntimeError("take the read in flight first")
        i, q = self._out = _check_out(out, self._total)
        self._lib.read_ahead_submit(self._ptr, i.ctypes.data, q.ctypes.data)

    def done(self) -> bool:
        return bool(self._lib.read_ahead_done(self._ptr))

    def take(self):
        if not self.busy:
            raise RuntimeError("no read in flight")
        out, self._out = self._out, None
        return out if self._lib.read_ahead_wait(self._ptr) else None

    def close(self):
        if self._ptr:
            self._lib.read_ahead_close(self._ptr)
            self._ptr = None
            self._out = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class UdpIngest:
    """Native UDP listener thread filling an IqRingBuffer — the
    board->host sample transport."""

    def __init__(self, ring: IqRingBuffer, port: int, fmt: str = "i16"):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable (g++ build failed)")
        self._lib = lib
        self._ptr = lib.udp_source_start(ring._ptr, port, _FMT_CODES[fmt])
        if not self._ptr:
            raise OSError(f"could not bind UDP port {port}")
        self.port = port

    @property
    def datagrams(self) -> int:
        return int(self._lib.udp_source_datagrams(self._ptr))

    def stop(self):
        if self._ptr:
            self._lib.udp_source_stop(self._ptr)
            self._ptr = None


def deinterleave(interleaved: np.ndarray, fmt: str = "i16", scale: float = 256.0):
    """Native (or NumPy-fallback) wire-format deinterleave -> (i16, q16)."""
    lib = _load()
    arr = np.ascontiguousarray(interleaved)
    n_pairs = len(arr) // 2
    if lib is None:
        a = arr
        if fmt == "f32":
            a = np.round(arr.astype(np.float32) * scale)
        return a[0::2].astype(np.int16), a[1::2].astype(np.int16)
    i = np.empty(n_pairs, dtype=np.int16)
    q = np.empty(n_pairs, dtype=np.int16)
    ip = i.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
    qp = q.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
    if fmt == "i8":
        lib.deinterleave_i8(arr.astype(np.int8, copy=False).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int8)), n_pairs, ip, qp)
    elif fmt == "i16":
        lib.deinterleave_i16(arr.astype(np.int16, copy=False).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int16)), n_pairs, ip, qp)
    elif fmt == "f32":
        lib.deinterleave_f32(arr.astype(np.float32, copy=False).ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)), n_pairs, ctypes.c_float(scale), ip, qp)
    else:
        raise ValueError(fmt)
    return i, q


def ring_source(ring: IqRingBuffer, scan_len: int, halo: int,
                poll_s: float = 0.005, stop=None) -> Iterator:
    """Adapter: consume a ring as a block source for the stream layer.
    Yields (i, q) blocks of scan_len+halo; ends when ``stop()`` is truthy
    and the ring is drained."""
    import time as _time

    while True:
        blk = ring.read_block(scan_len, halo)
        if blk is not None:
            yield blk
            continue
        if stop is not None and stop():
            tail = ring.drain()
            if len(tail[0]):
                yield tail
            return
        _time.sleep(poll_s)
