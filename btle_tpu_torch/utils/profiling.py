"""Profiling hooks: torch.profiler traces + simple block timing.

The reference's only tracing was stage dump files and Vivado ILA captures
(SURVEY.md §5). The JAX package wraps jax.profiler traces; here the
native tool is torch.profiler, whose Chrome trace (chrome://tracing,
Perfetto) names every CUDA kernel a region launched. ``BlockStats`` is a
copy of btle_tpu.utils.profiling's wall-clock block statistics.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field


@contextlib.contextmanager
def device_trace(out_dir: str):
    """Capture a torch.profiler trace around a code region: CPU activity,
    and CUDA activity when a card is present. On exit the Chrome trace is
    written into ``out_dir`` as ``trace-<ns>.json``; the profiler is
    yielded (its ``trace_path`` is set once the file is written)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.trace_path = None
    prof.start()
    try:
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
