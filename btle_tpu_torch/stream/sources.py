"""IQ sample sources: files, stdin, synthetic streams.

Formats mirror the reference's capture conventions:
  * int8 interleaved  — HackRF native stream (btle_rx.c rx_buf)
  * int16 interleaved — firmware ``btle_ll -q`` captures
    (test_btle_rx_by_captured_iq.py:76-81)
  * float32 interleaved — usrp_replay .bin (int8 scaled by 1/256)

Each source yields (i_chunk, q_chunk) int16 arrays; the optional native
C++ reader (btle_tpu.runtime) is used transparently for high-rate file
ingest when built.
"""

from __future__ import annotations

import sys
from typing import Iterator

import numpy as np

DEFAULT_CHUNK = 1 << 18  # IQ pairs per read


def _deinterleave(arr: np.ndarray):
    return arr[0::2].astype(np.int16), arr[1::2].astype(np.int16)


def _raw_to_pairs(raw: bytes, fmt: str, dtype) -> tuple[np.ndarray, np.ndarray]:
    arr = np.frombuffer(raw, dtype=dtype)
    if len(arr) % 2:
        arr = arr[:-1]
    if fmt == "f32":
        arr = np.round(arr * 256).astype(np.int16)
    return _deinterleave(np.asarray(arr))


def iq_file_source(path: str, fmt: str = "i16", chunk_pairs: int = DEFAULT_CHUNK) -> Iterator:
    """Stream a capture file as (i, q) int16 chunks.

    fmt: 'i8' | 'i16' | 'f32' (float32 scaled: value*256 -> int16,
    matching load semantics of the usrp_replay artifact).
    """
    dtype = {"i8": np.int8, "i16": np.int16, "f32": np.float32}[fmt]
    itemsize = np.dtype(dtype).itemsize
    with open(path, "rb") as fh:
        while True:
            raw = fh.read(chunk_pairs * 2 * itemsize)
            if not raw:
                return
            yield _raw_to_pairs(raw, fmt, dtype)


def stdin_source(fmt: str = "i8", chunk_pairs: int = DEFAULT_CHUNK) -> Iterator:
    dtype = {"i8": np.int8, "i16": np.int16, "f32": np.float32}[fmt]
    itemsize = np.dtype(dtype).itemsize
    fh = sys.stdin.buffer
    while True:
        raw = fh.read(chunk_pairs * 2 * itemsize)
        if not raw:
            return
        yield _raw_to_pairs(raw, fmt, dtype)


def array_source(i: np.ndarray, q: np.ndarray, chunk_pairs: int = DEFAULT_CHUNK) -> Iterator:
    """Wrap in-memory arrays as a chunked source (tests, replay)."""
    n = len(i)
    for s in range(0, n, chunk_pairs):
        yield (
            np.asarray(i[s : s + chunk_pairs], dtype=np.int16),
            np.asarray(q[s : s + chunk_pairs], dtype=np.int16),
        )


def ila_csv_source(path: str, col_i: int = 9, col_q: int = 11,
                   skip_rows: int = 2, decimate: int = 2,
                   chunk_pairs: int = DEFAULT_CHUNK) -> Iterator:
    """Vivado ILA .csv capture source (the reference's FPGA debug path,
    test_btle_rx_by_captured_iq.py:63-75): integer I/Q columns, two header
    rows skipped, decimated 16 MHz -> 8 Msps by default."""
    import csv as _csv

    buf_i: list[int] = []
    buf_q: list[int] = []
    with open(path, newline="") as fh:
        reader = _csv.reader(fh)
        for row_idx, row in enumerate(reader):
            if row_idx < skip_rows:
                continue
            k = row_idx - skip_rows
            if k % decimate:
                continue
            try:
                buf_i.append(int(row[col_i]))
                buf_q.append(int(row[col_q]))
            except (ValueError, IndexError):
                continue
            if len(buf_i) >= chunk_pairs:
                yield (np.asarray(buf_i, np.int16), np.asarray(buf_q, np.int16))
                buf_i, buf_q = [], []
    if buf_i:
        yield (np.asarray(buf_i, np.int16), np.asarray(buf_q, np.int16))


def load_iq_capped(path: str, fmt: str = "i16",
                   max_samples: int = 4_000_000
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Read up to ``max_samples`` IQ pairs of a capture into memory —
    the shared loader behind the inspection surfaces (CLI iq-show, MCP
    ble_iq_occupancy, the TUI spectrum screen). fmt 'csv' reads Vivado
    ILA exports; others match iq_file_source. Raises ValueError on an
    empty capture so callers surface a clear message."""
    src = (ila_csv_source(path) if fmt == "csv"
           else iq_file_source(path, fmt))
    chunks_i, chunks_q, total = [], [], 0
    for ci, cq in src:
        chunks_i.append(ci)
        chunks_q.append(cq)
        total += len(ci)
        if total >= max_samples:
            break
    if not chunks_i:
        raise ValueError(f"no IQ samples in {path}")
    return (np.concatenate(chunks_i)[:max_samples],
            np.concatenate(chunks_q)[:max_samples])
