"""Profiling hooks: the program's tracer, torch.profiler traces and
simple block timing.

The reference's only tracing was stage dump files and Vivado ILA captures
(SURVEY.md §5). The JAX package wraps jax.profiler traces; here the
native tool is torch.profiler, whose Chrome trace (chrome://tracing,
Perfetto) names every CUDA kernel a region launched. ``BlockStats`` is a
copy of btle_tpu.utils.profiling's wall-clock block statistics.

The tracer times the per-block phases of the live loops from inside the
program: ``span(name)`` around a phase, ``count(name, n)`` for a
counter. Both do nothing until ``tracing(tracer)`` turns a ``Tracer``
on: each site then costs one test of a module global, with no clock
read, no allocation and no profiler call. While a tracer is on and a
torch.profiler session runs, every span is also a
``record_function("btle." + name)`` range, so the program's phases sit
on the device trace's own timeline.
"""

from __future__ import annotations

import contextlib
import os
import struct
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import NamedTuple

# the tracer turned on by ``tracing``; None leaves every site idle
_tracer: Tracer | None = None

_SPAN, _COUNT = 0, 1


class SpanRecord(NamedTuple):
    """One finished span: its block (the dispatch sequence number; -1
    outside any block), start and end on ``time.perf_counter_ns``, its
    index in ``Tracer.spans()`` and its parent's (-1 at the top)."""
    name: str
    block: int
    start_ns: int
    end_ns: int
    ident: int
    parent: int


class CountRecord(NamedTuple):
    """One ``count`` call: the block of the innermost span open at the
    time, when, and how much."""
    name: str
    block: int
    at_ns: int
    n: int


# a record: kind, name id, block (or n; -2 = inherit), start, end
_RECORD = struct.Struct("<qqqqq")
_INHERIT = -2


class Tracer:
    """Spans and counters of one thread's loop, in a buffer of
    ``capacity`` records fixed when the tracer is made. A full buffer
    records nothing more and counts what it lost in ``lost``; the
    running ``counters`` keep counting.

    A span records only its name, its block (or none) and its two clock
    readings, packed into one preallocated bytearray (no object a record,
    and nothing the garbage collector walks); which span encloses which,
    and so the parents, the blocks inherited and the self times, is
    worked out afterwards from the readings, since spans of one thread
    nest."""

    def __init__(self, capacity: int = 1 << 16):
        import torch

        self.capacity = int(capacity)
        self._buf = bytearray(self.capacity * _RECORD.size)
        self._n = 0
        self.lost = 0
        self.counters: dict = defaultdict(int)
        self._ids: dict = {}          # name -> id in the records
        self._profiling = torch.autograd._profiler_enabled
        self._record_function = torch.autograd.profiler.record_function

    def __len__(self) -> int:
        return self._n

    def _new_id(self, name: str) -> int:
        i = self._ids[name] = len(self._ids)
        return i

    def count(self, name: str, n: int = 1):
        self.counters[name] += n
        if self._n < self.capacity:
            t = time.perf_counter_ns()
            i = self._ids.get(name)
            if i is None:
                i = self._new_id(name)
            _RECORD.pack_into(self._buf, self._n * _RECORD.size, _COUNT, i, n, t, t)
            self._n += 1
        else:
            self.lost += 1

    def _resolve(self) -> tuple[list[SpanRecord], list[CountRecord]]:
        """The records in start order, each span with its parent and
        block, each count with the block of the innermost open span."""
        names = list(self._ids)
        used = memoryview(self._buf)[:self._n * _RECORD.size]
        events = sorted((start, -end, kind, names[i], x)
                        for kind, i, x, start, end in _RECORD.iter_unpack(used))
        spans: list = []
        counts: list = []
        stack: list = []
        for start, neg_end, kind, name, x in events:
            while stack and spans[stack[-1]].end_ns < -neg_end:
                stack.pop()
            parent = stack[-1] if stack else -1
            block = spans[parent].block if stack else -1
            if kind == _SPAN:
                spans.append(SpanRecord(name, block if x == _INHERIT else x, start,
                                        -neg_end, len(spans), parent))
                stack.append(len(spans) - 1)
            else:
                counts.append(CountRecord(name, block, start, x))
        return spans, counts

    def spans(self) -> list[SpanRecord]:
        return self._resolve()[0]

    def counts(self) -> list[CountRecord]:
        return self._resolve()[1]

    def totals(self, until_ns: int | None = None) -> dict:
        """Per span name, over the spans that ended at or before
        ``until_ns`` (all of them when None): ``total_ns``, ``self_ns``
        (the total less what its child spans cover) and ``count``;
        ``counters`` (the count calls made by then), ``blocks`` (the
        distinct blocks those spans belong to) and ``lost``."""
        spans, counts = self._resolve()
        spans = [r for r in spans if until_ns is None or r.end_ns <= until_ns]
        child_ns: dict = defaultdict(int)
        for r in spans:
            child_ns[r.parent] += r.end_ns - r.start_ns
        out: dict = {}
        for r in spans:
            t = out.setdefault(r.name, {"total_ns": 0, "self_ns": 0, "count": 0})
            t["total_ns"] += r.end_ns - r.start_ns
            t["self_ns"] += r.end_ns - r.start_ns - child_ns.get(r.ident, 0)
            t["count"] += 1
        if until_ns is None:
            counters = dict(self.counters)
        else:
            counters = defaultdict(int)
            for c in counts:
                if c.at_ns <= until_ns:
                    counters[c.name] += c.n
            counters = dict(counters)
        return {"spans": out, "counters": counters,
                "blocks": len({r.block for r in spans if r.block >= 0}),
                "lost": self.lost}


class _Idle:
    """What ``span`` hands out with no tracer on: one shared object."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, et, ev, tb):
        return False


_IDLE = _Idle()


class span:
    """A context manager timing one phase: ``with span(name, block):``.
    ``block`` is the block it belongs to; None takes the enclosing
    span's (-1 at the top). With no tracer on it is one shared object
    that does nothing."""
    __slots__ = ("tr", "name", "block", "t0", "rf")

    def __new__(cls, name: str, block: int | None = None):
        tr = _tracer
        if tr is None:
            return _IDLE
        self = object.__new__(cls)
        self.tr, self.name = tr, name
        self.block = _INHERIT if block is None else block
        return self

    def __enter__(self):
        self.rf = None
        if self.tr._profiling():
            self.rf = self.tr._record_function("btle." + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, et, ev, tb):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        tr = self.tr
        n = tr._n
        if n < tr.capacity:
            i = tr._ids.get(self.name)
            if i is None:
                i = tr._new_id(self.name)
            _RECORD.pack_into(tr._buf, n * _RECORD.size, _SPAN, i, self.block, self.t0, t1)
            tr._n = n + 1
        else:
            tr.lost += 1
        return False


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` (when a tracer is on)."""
    tr = _tracer
    if tr is not None:
        tr.count(name, n)


def active_tracer() -> Tracer | None:
    """The tracer on now, or None."""
    return _tracer


@contextlib.contextmanager
def tracing(tracer: Tracer):
    """Turn ``tracer`` on for a region (the one on before comes back on
    exit)."""
    global _tracer
    prev, _tracer = _tracer, tracer
    try:
        yield tracer
    finally:
        _tracer = prev


@contextlib.contextmanager
def device_trace(out_dir: str):
    """Capture a torch.profiler trace around a code region: CPU activity,
    and CUDA activity when a card is present. On exit the Chrome trace is
    written into ``out_dir`` as ``trace-<ns>.json``; the profiler is
    yielded (its ``trace_path`` is set once the file is written). A tracer
    is on for the region (a new one unless one is on already), so the
    program's spans appear in the trace as ``btle.*`` ranges; it is
    ``prof.tracer``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.trace_path = None
    prof.tracer = _tracer if _tracer is not None else Tracer()
    prof.start()
    try:
        with tracing(prof.tracer):
            yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(out_dir, f"trace-{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        prof.trace_path = path


@dataclass
class BlockStats:
    """Streaming-throughput accounting for a block-processing loop."""

    samples_per_block: int
    sample_rate_hz: float
    blocks: int = 0
    busy_s: float = 0.0
    t_start: float = field(default_factory=time.perf_counter)
    _t0: float = 0.0

    def begin(self):
        self._t0 = time.perf_counter()

    def end(self):
        self.busy_s += time.perf_counter() - self._t0
        self.blocks += 1

    @property
    def throughput_sps(self) -> float:
        return self.blocks * self.samples_per_block / self.busy_s if self.busy_s else 0.0

    @property
    def realtime_factor(self) -> float:
        return self.throughput_sps / self.sample_rate_hz if self.sample_rate_hz else 0.0

    def summary(self) -> str:
        return (f"{self.blocks} blocks, {self.throughput_sps/1e6:.1f} Msps "
                f"({self.realtime_factor:.1f}x real time)")
