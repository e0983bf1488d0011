"""The traced part of a ``--trace 1`` window: torch.profiler over a
fixed span of it, reduced to device busy time, the device operations
that took the most time, and the longest idle gaps by what the host was
doing.

The idle arithmetic (device spans merged, busy over the window) is
copied from btle_tpu_torch/tools/_measure.py ``device_profile``. The
harness marks its own calls into the program with ``span(name)``; a gap
is named by the innermost such mark and the deepest host operation that
cover its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

N_TOP = 10


def _is_device_side(e) -> bool:
    return "CUDA" in str(getattr(e, "device_type", ""))


def _is_device(e) -> bool:
    """A device operation: on the card, and not the card-side copy of a
    harness mark (a record_function range also appears there)."""
    return (_is_device_side(e) and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("portbench."))


def merge(spans):
    """Sorted, merged (start, end) intervals of possibly overlapping
    ones."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_and_gaps(spans, t0: float, t1: float):
    """Busy time of merged device spans clipped to [t0, t1], and the idle
    gaps between them (start, end), in the spans' unit."""
    busy, gaps, cur = 0.0, [], t0
    for s, e in merge(spans):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        busy += e - s
        cur = max(cur, e)
    if t1 > cur:
        gaps.append((cur, t1))
    return busy, gaps


SETTLE_S = 1.0     # after the profiler starts, before the span opens


class TraceWindow:
    """Profiles a span of ``length_s`` seconds of a window, switched by
    ``tick`` from the harness's own calls: the profiler starts at
    ``start_s`` after the window opened; its first start stalls the
    host (CUPTI's set-up), so the span opens ``SETTLE_S`` after that
    start returns, once a backlog the stall left has been worked off,
    and closes ``length_s`` later. Marks in the trace bound the span.
    Once started, the profiler's tracing slows the host's launches for
    the rest of the process, so host-clock spans count only before
    ``started``. ``enabled`` False makes every call a no-op."""

    def __init__(self, enabled: bool, start_s: float = 0.0, length_s: float = 0.0):
        self.enabled = enabled
        self.start_s, self.length_s = start_s, length_s
        self.prof = None
        self.active = False          # inside the span
        self.done = False
        self.t_begin = 0.0           # when the profiler was asked to start
        self.stall_s = 0.0           # how long its start held the host
        self.t_open = self.t_start = self.t_stop = 0.0
        self.blocks = 0

    @property
    def started(self) -> bool:
        return self.prof is not None

    def tick(self, now: float, t_window0: float):
        """Start the profiler, open or close the span; ``now`` on
        perf_counter."""
        if not self.enabled or self.done:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        if self.prof is None:
            if now - t_window0 >= self.start_s:
                self.t_begin = now
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.start()
                self.stall_s = time.perf_counter() - now
                self.t_open = now + self.stall_s + SETTLE_S
        elif not self.active and now >= self.t_open:
            with record_function("portbench.span_open"):
                self.t_start = time.perf_counter()
            self.active = True
        elif self.active and now - self.t_start >= self.length_s:
            self.stop()

    def stop(self):
        """Close the span (the window may close it first) and stop."""
        if self.prof is None or self.done:
            return
        import torch
        from torch.profiler import record_function

        torch.cuda.synchronize()
        with record_function("portbench.span_close"):
            self.t_stop = time.perf_counter()
        self.prof.stop()
        self.done = True
        if not self.active:
            self.t_start = self.t_stop
        self.active = False

    def span(self, name: str):
        """A mark of the harness's call ``name`` while tracing."""
        if self.prof is not None and not self.done:
            from torch.profiler import record_function

            return record_function("portbench." + name)
        return contextlib.nullcontext()

    def count_block(self):
        if self.active:
            self.blocks += 1

    def reduce(self) -> dict | None:
        """busy_s, window_s, blocks, device_ops and idle_gaps of the span
        between its marks; None when it saw no device operation."""
        if self.prof is None or not self.done or not self.blocks:
            return None
        events = list(self.prof.events())
        marks = {e.name: e.time_range.start for e in events
                 if e.name in ("portbench.span_open", "portbench.span_close")
                 and not _is_device_side(e)}
        if len(marks) < 2:
            return None
        t0, t1 = marks["portbench.span_open"], marks["portbench.span_close"]
        dev = [e for e in events if _is_device(e)
               and e.time_range.end > t0 and e.time_range.start < t1]
        if not dev:
            return None
        host = [e for e in events if not _is_device_side(e)]
        busy_us, gaps = busy_and_gaps(
            [(e.time_range.start, e.time_range.end) for e in dev], t0, t1)
        ops = defaultdict(float)
        for e in dev:
            s, f = max(e.time_range.start, t0), min(e.time_range.end, t1)
            ops[e.name[:90]] += (f - s) / 1e6
        marks_iv = _Intervals(e for e in host if e.name.startswith("portbench.")
                              and not e.name.startswith("portbench.span_"))
        tops = _Intervals(e for e in host if not e.name.startswith("portbench."))
        by_host = defaultdict(float)
        for s, e in gaps:
            mid = (s + e) / 2
            mark = marks_iv.innermost(mid)
            op = tops.innermost(mid)
            name = (mark.name[len("portbench."):] if mark else "loop") + ":" + (
                op.name[:60] if op else "python")
            by_host[name] += (e - s) / 1e6
        return {
            "busy_s": busy_us / 1e6,
            "window_s": (t1 - t0) / 1e6,
            "blocks": self.blocks,
            "device_ops": _top(ops),
            "idle_gaps": _top(by_host),
        }


class _Intervals:
    """Host events by start, for the innermost one that covers a time."""

    def __init__(self, events, reach: int = 4096):
        self.events = sorted(events, key=lambda e: e.time_range.start)
        self.starts = [e.time_range.start for e in self.events]
        self.reach = reach

    def innermost(self, t):
        """The latest-starting event that covers t (nested events start
        after their parents), looking back at most ``reach`` events."""
        k = bisect.bisect_right(self.starts, t)
        for j in range(k - 1, max(-1, k - 1 - self.reach), -1):
            if self.events[j].time_range.end >= t:
                return self.events[j]
        return None


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:N_TOP]]
