"""Verdict latency of the wideband scan by block size, on the card.

Port of tools/bench_latency.py. The latency of a streaming block pipeline
is the block's air time (the wait to fill it) plus its processing time,
which hides behind the next block's fill once the scan runs faster than
the air. For each block size (channel samples per block) it measures, in
the shipped "bf16x2w" mode on ``btle_tpu_torch.bench``'s program (6
distinct noise blocks made on the card, every output checksummed):

  scan_len_ch                      the block size
  air_ms                           the block's air time (scan_len_ch * 20
                                   wideband samples at 80 Msps)
  pipelined_ms_per_block           the median of 5 trials of 192
                                   dispatches, each timed by CUDA events
                                   and forced by one host fetch
  x_real_time                      air_ms / pipelined_ms_per_block
  single_dispatch_rtt_ms           one dispatch to its fetched checksum
                                   (``.item()``), host clock, median of 7
  steady_state_verdict_latency_ms  air_ms + pipelined_ms_per_block

Usage: python -m btle_tpu_torch.tools.bench_latency
       [--sizes 8192,32768,131072] [--iters 192] [--trials 5]
       [--device cuda|cpu]
One JSON line per size (the JAX tool's keys, unrounded).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

SIZES = (8192, 32768, 131072)
MODE = "bf16x2w"


def measure(dev, scan_len_ch: int, iters: int = 192, trials: int = 5,
            seed: int = 0) -> dict:
    """The latency line of one block size (the module docstring's keys)."""
    from .. import bench

    air_ms = scan_len_ch * 20 / 80e3
    blocks = bench.make_blocks(dev, scan_len_ch, count=6, seed=seed)
    step = bench.scan_step(dev, MODE)
    cuda = dev.type == "cuda"
    float(torch.stack([step(*b) for b in blocks[:2]]).sum())     # warm
    per_block = [bench.trial_seconds(step, blocks, iters, cuda)[0] * 1e3 / iters
                 for _ in range(trials)]
    piped_ms = statistics.median(per_block)
    rtts = []
    for k in range(7):
        t0 = time.perf_counter()
        step(*blocks[k % len(blocks)]).item()
        rtts.append((time.perf_counter() - t0) * 1e3)
    return {"scan_len_ch": scan_len_ch, "air_ms": air_ms,
            "pipelined_ms_per_block": piped_ms,
            "x_real_time": air_ms / piped_ms,
            "single_dispatch_rtt_ms": statistics.median(rtts),
            "steady_state_verdict_latency_ms": air_ms + piped_ms}


def run(device=None, sizes=SIZES, iters: int = 192, trials: int = 5) -> list:
    """measure() for each block size, on ``device`` (cuda unless the caller
    asks for another; the CPU's numbers are its host clock's)."""
    from .._device import resolve_device

    dev = resolve_device(device)
    return [measure(dev, int(n), iters, trials) for n in sizes]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)),
                    help="CSV of scan_len_ch block sizes (channel samples)")
    ap.add_argument("--iters", type=int, default=192)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for line in run(args.device, [int(s) for s in args.sizes.split(",")],
                    args.iters, args.trials):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
