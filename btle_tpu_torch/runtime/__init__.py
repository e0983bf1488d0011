"""ctypes bindings for the native sample-transport runtime.

Port of btle_tpu/runtime: ``runtime.cpp`` here is a byte-equal copy of
the JAX package's source (an SPSC int16 IQ ring with overlap-save block
extraction, and a UDP listener thread that fills it). On first use it is
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
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_FMT_CODES = {"i8": 0, "i16": 1, "f32": 2}
_lib: ctypes.CDLL | None = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update("\0".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"runtime-{h.hexdigest()[:12]}.so"


def _build() -> bool:
    """Compile runtime.cpp into library_path() (atomically: a temporary
    file renamed into place, so a concurrent process never loads half a
    library). False when g++ is missing or fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE), "-lpthread"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, library_path())
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not library_path().exists() and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(library_path()))
    except OSError:
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


class IqRingBuffer:
    """Native SPSC IQ ring with overlap-save block extraction."""

    def __init__(self, capacity_pairs: int = 1 << 22):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable (g++ build failed)")
        self._lib = lib
        self._ptr = lib.iq_ring_create(capacity_pairs)

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
        ``scale`` and rounded to int16); returns the pairs written."""
        arr = np.ascontiguousarray(interleaved)
        n_pairs = len(arr) // 2
        if fmt == "i8":
            cp = arr.astype(np.int8, copy=False).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int8))
            return int(self._lib.iq_ring_write_i8(self._ptr, cp, n_pairs))
        if fmt == "i16":
            cp = arr.astype(np.int16, copy=False).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int16))
            return int(self._lib.iq_ring_write_i16(self._ptr, cp, n_pairs))
        if fmt == "f32":
            cp = arr.astype(np.float32, copy=False).ctypes.data_as(
                ctypes.POINTER(ctypes.c_float))
            return int(self._lib.iq_ring_write_f32(self._ptr, cp, n_pairs, scale))
        raise ValueError(fmt)

    # -------------------------- consumer --------------------------
    def read_block(self, scan_len: int, halo: int):
        """(i, q) int16 of scan_len+halo samples, or None if not enough
        buffered. Consumes scan_len samples (overlap-save)."""
        total = scan_len + halo
        i = np.empty(total, dtype=np.int16)
        q = np.empty(total, dtype=np.int16)
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
        return int(self._lib.iq_ring_dropped(self._ptr))

    @property
    def total_written(self) -> int:
        return int(self._lib.iq_ring_total_written(self._ptr))


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
