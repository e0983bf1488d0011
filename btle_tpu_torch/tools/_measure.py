"""Timing and bounds shared by the probes (card only: a CPU run reports
no time)."""

from __future__ import annotations

import statistics

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_FLOPS = 67e12              # CUDA-core FP32
BF16_FLOPS = 989e12             # dense tensor-core bf16


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
