"""Timing and bounds shared by the probes (card only: a CPU run reports
no time)."""

from __future__ import annotations

import statistics

from .._build import CudaKernel

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_FLOPS = 67e12              # CUDA-core FP32
BF16_FLOPS = 989e12             # dense tensor-core bf16


# an empty kernel (csrc/decode_candidates.cu): the device time of a launch
# that does nothing, the floor below which no kernel's time can go
LAUNCH_FLOOR = CudaKernel("launch_floor", replaces="none: the launch floor")


def launch_floor() -> None:
    """Launch the empty kernel on the current CUDA stream."""
    LAUNCH_FLOOR.launch()


def bound_ms(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over ``rate``, whichever is larger, and which it was."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_blocks(fn, blocks, iters: int, trials: int) -> tuple[float, list]:
    """ms per call of fn(block), rotating over distinct device-resident
    blocks, from CUDA events around ``iters`` calls: the median of
    ``trials`` runs and every run's value."""
    import torch

    for b in blocks[:2]:
        fn(b)
    torch.cuda.synchronize()
    runs = []
    for _ in range(trials):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for k in range(iters):
            fn(blocks[k % len(blocks)])
        t1.record()
        t1.synchronize()
        runs.append(t0.elapsed_time(t1) / iters)
    return statistics.median(runs), runs


def checksums_match(base: float, new: float) -> bool:
    """The TPU tools' checksum rule: equal to 1e-3 of the base's size."""
    return abs(base - new) < 1e-3 * max(1.0, abs(base))


def device_profile(run, n: int) -> dict:
    """torch.profiler over run() (n blocks): device time per block by
    kernel name, the device's idle share of the window between the first
    and the last device activity, and the host's side of the window: its
    wall time, and the count and summed time of its top-level events
    (torch ops and CUDA runtime calls made outside any op), per block."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    host = [e for e in prof.events()
            if e.cpu_parent is None and "CPU" in str(getattr(e, "device_type", ""))]
    host_us = sum(e.time_range.end - e.time_range.start for e in host)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if "CUDA" in str(getattr(e, "device_type", "")))
    if not spans:
        return {"device_time": "not measured"}
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    top = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0.0)
        if t > 0:
            top.append({"name": ev.key[:90], "ms_per_block": t / 1e3 / n,
                        "calls_per_block": ev.count / n})
    top.sort(key=lambda r: -r["ms_per_block"])
    return {"blocks": n, "device_busy_ms_per_block": busy / 1e3 / n,
            "window_ms_per_block": window / 1e3 / n,
            "idle_share": 1.0 - busy / window, "top": top[:12],
            "host_wall_ms_per_block": wall_s * 1e3 / n, "host_events_per_block": len(host) / n,
            "host_event_ms_per_block": host_us / 1e3 / n}
