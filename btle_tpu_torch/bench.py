"""Benchmark: sustained wideband 40-channel sniffing throughput per card.

Port of the repository's ``bench.py``. Run on a machine with a CUDA card:

    python -m btle_tpu_torch.bench

It prints one JSON line with ``bench.py``'s keys — ``metric``
("wideband_iq_msps_per_chip"), ``value`` (Msps, the median of 5 trials),
``unit``, ``vs_baseline`` (value / 800), ``path`` ("fused-bf16x2w"),
``parity_msps``, ``parity_vs_baseline`` and ``parity_path``
("fused-f32-polyx", the exact mode on K3) — plus each mode's trials, their
min and max, the folded checksum, the device, and the card's name and
power limit as ``nvidia-smi`` reads them.

The measured program is one block of ``bench.py``'s geometry (131072
channel samples plus ``required_halo(4, 4)``, times 20 wideband samples;
16 candidate slots; the 1280-tap prototype; ``default_scan_tables()``)
through ``wideband_scan_fused`` with the arguments ``bench.py`` passes,
every output summed into one float32 scalar a block. The inputs are 8
distinct blocks of N(0, 1) noise times 30, made on the card from a
``torch.Generator`` seeded 0. Each mode runs 2 warm blocks, then 5 trials
of 192 dispatches over the rotating blocks; a trial is timed with CUDA
events and forced by one host fetch of the folded checksum. Msps is
131072 * 20 * dispatches / seconds / 1e6.

There is no fallback: a kernel that fails to build or launch fails the
run, and ``path`` always names the fused kernels. ``--device cpu`` (or
``run("cpu", scan_len_ch, iters, trials)`` at a smaller size) runs the
plain PyTorch twins, timed by the host clock, and labels its line with
that device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from ._device import resolve_device
from .rx.pipeline import required_halo
from .wideband.channelizer import DEFAULT_TAPS
from .wideband.fused import wideband_scan_fused
from .wideband.sniffer import CH_LAG, default_scan_tables

SCAN_LEN_CH = 131072
MAX_CANDIDATES = 16
N_BLOCKS = 8
BASELINE_MSPS = 800.0
MODES = (("bf16x2w", "fused-bf16x2w"), ("f32", "fused-f32-polyx"))


def block_len(scan_len_ch: int = SCAN_LEN_CH) -> int:
    """Wideband samples of one block: territory plus the channel halo."""
    return (scan_len_ch + required_halo(4, CH_LAG)) * 20


def make_blocks(device, scan_len_ch: int = SCAN_LEN_CH, count: int = N_BLOCKS,
                seed: int = 0) -> list:
    """``count`` distinct (i, q) blocks of 30 * N(0, 1) float32 noise,
    drawn on ``device`` from a generator seeded ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = block_len(scan_len_ch)
    return [tuple(30.0 * torch.randn(n, generator=gen, device=device)
                  for _ in range(2)) for _ in range(count)]


def block_checksum(out: dict) -> torch.Tensor:
    """Every output leaf cast to float32 and summed, in key order (the
    order of ``jax.tree_util.tree_leaves`` over the JAX dict), into one
    scalar on the outputs' device."""
    return sum(out[k].to(torch.float32).sum() for k in sorted(out))


def scan_step(device, compute_dtype: str):
    """step(i, q) -> the block's checksum scalar: ``wideband_scan_fused``
    with bench.py's arguments in ``compute_dtype``."""
    tables = default_scan_tables(device)

    def step(i, q):
        return block_checksum(wideband_scan_fused(
            i, q, *tables, sps=4, lag=CH_LAG, max_candidates=MAX_CANDIDATES,
            num_taps=DEFAULT_TAPS, compute_dtype=compute_dtype, device=device))
    return step


def trial_seconds(step, blocks, iters: int, cuda: bool) -> tuple[float, float]:
    """One trial: ``iters`` dispatches over the rotating blocks, folded and
    fetched once. Returns (seconds, folded checksum)."""
    if cuda:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
    else:
        start = time.perf_counter()
    scalars = [step(*blocks[k % len(blocks)]) for k in range(iters)]
    folded = torch.stack(scalars).sum()
    if cuda:
        t1.record()
    total = float(folded)            # the one host fetch forces every block
    if cuda:
        return t0.elapsed_time(t1) / 1e3, total
    return time.perf_counter() - start, total


def time_mode(step, blocks, scan_len_ch: int, iters: int, trials: int,
              cuda: bool) -> dict:
    """2 warm blocks, then ``trials`` trials: Msps per trial, their median,
    min and max, and the last trial's folded checksum."""
    float(torch.stack([step(*b) for b in blocks[:2]]).sum())
    msps, checksum = [], 0.0
    for _ in range(trials):
        seconds, checksum = trial_seconds(step, blocks, iters, cuda)
        msps.append(scan_len_ch * 20 * iters / seconds / 1e6)
    return {"msps": statistics.median(msps), "msps_trials": msps,
            "msps_min": min(msps), "msps_max": max(msps), "checksum": checksum}


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def run(device=None, scan_len_ch: int = SCAN_LEN_CH, iters: int = 192,
        trials: int = 5) -> dict:
    """The bench line as a dict (see the module docstring)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    blocks = make_blocks(dev, scan_len_ch)
    res = {mode: time_mode(scan_step(dev, mode), blocks, scan_len_ch, iters,
                           trials, cuda) for mode, _ in MODES}
    head, parity = res["bf16x2w"], res["f32"]
    return {
        "metric": "wideband_iq_msps_per_chip",
        "value": round(head["msps"], 1),
        "unit": "Msps",
        "vs_baseline": round(head["msps"] / BASELINE_MSPS, 3),
        "path": MODES[0][1],
        "parity_msps": round(parity["msps"], 1),
        "parity_vs_baseline": round(parity["msps"] / BASELINE_MSPS, 3),
        "parity_path": MODES[1][1],
        "msps_trials": head["msps_trials"], "msps_min": head["msps_min"],
        "msps_max": head["msps_max"],
        "parity_msps_trials": parity["msps_trials"],
        "parity_msps_min": parity["msps_min"], "parity_msps_max": parity["msps_max"],
        "checksum": head["checksum"], "parity_checksum": parity["checksum"],
        "scan_len_ch": scan_len_ch, "dispatches": iters, "trials": trials,
        "device": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "nvidia_smi": nvidia_smi() if cuda else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain twins, host clock)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
