"""Single-channel scan throughput (BASELINE config 1), on the card.

Port of tools/bench_narrowband.py. The measured program is the narrowband
block decode, ``rx.pipeline.decode_block`` (the scan kernel K7, the
earliest 64 AA hits, the candidate decode K4, the RSSI window means), on
one 1,048,576-sample int16 block at sps 4 and lag 1 with the advertising
access address, channel 37's whitening and CRC init 0x555555. Every
output is cast to float32 and summed into one scalar a block. The inputs
are 6 distinct blocks of uniform integers in [-90, 90), made with numpy
from ``seed`` and placed on the device once. After 2 warm blocks, each
of 3 trials dispatches 48 blocks over the rotating inputs and is forced
by one host read of their folded checksum; the result is the median
trial:

  ms_per_block   milliseconds a block
  msps           million samples a second
  x_real_time    times real time at the 4 Msps channel rate
  checksum       the six blocks' checksums summed (float64 of float32s)

On the card it also reports, from a torch.profiler window of 48 blocks,
the device's busy ms a block and its idle share, and the host's: the
window's wall ms a block, and the count and summed ms of its top-level
events (torch ops and CUDA runtime calls) a block. ``scan_step(device,
plain=True)`` steps through the kernels' plain PyTorch twins instead (the
card's checksum must equal theirs); ``--device cpu`` runs the twins by
the host clock.

Usage: python -m btle_tpu_torch.tools.bench_narrowband [--n 1048576]
       [--iters 48] [--trials 3] [--device cuda|cpu]
Prints the JAX tool's line, then the result as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

N = 1 << 20
N_BLOCKS = 6
SPS, LAG, MAX_CANDIDATES = 4, 1, 64
CHANNEL = 37


def make_blocks(device, n: int = N, count: int = N_BLOCKS, seed: int = 0) -> list:
    """``count`` distinct (i, q) int16 blocks of n samples, uniform in
    [-90, 90), drawn with numpy from ``seed`` and placed on ``device``."""
    rng = np.random.default_rng(seed)
    return [tuple(torch.as_tensor(rng.integers(-90, 90, n).astype(np.int16),
                                  device=device) for _ in range(2))
            for _ in range(count)]


def scan_tables(device) -> tuple:
    """(aa_bits (32,), aa_mask (32,), whiten (1, 336), crc_init (1,),
    adv_flag (1,)) of the advertising scan on channel 37."""
    from ..spec import bits as B
    from ..spec import crc24 as C
    from ..spec import whitening as W

    return (torch.as_tensor(B.hex_to_bits("d6be898e"), device=device),
            torch.ones(32, dtype=torch.int8, device=device),
            torch.as_tensor(np.array(W.whitening_bits(CHANNEL, 336)[None]), device=device),
            torch.tensor([C.lfsr_init_to_table_init("555555")], dtype=torch.int32,
                         device=device),
            torch.tensor([True], device=device))


def decode_block_plain(i, q, aa_bits, aa_mask, whiten, crc_init, adv_flag,
                       sps: int, lag: int, max_candidates: int) -> dict:
    """``decode_block`` with the plain twins of K7 and K4 in place of the
    kernels, on any device."""
    from ..phy.scan_kernel import scan_block_reference
    from ..rx.decode_kernel import decode_candidates_reference
    from ..rx.pipeline import block_candidates, earliest_hits

    hit, bits = scan_block_reference(i, q, aa_bits, aa_mask, sps, lag)
    pos, valid, num_hits = earliest_hits(hit, max_candidates)
    decoded = decode_candidates_reference(
        bits, pos, whiten, crc_init, adv_flag, sps=sps, clamp_tail=True)
    return block_candidates(i, q, pos, valid, num_hits, decoded, sps)


def scan_step(device, plain: bool = False):
    """step(i, q) -> the block's checksum scalar on the device."""
    from ..bench import block_checksum
    from ..rx.pipeline import decode_block

    tables = scan_tables(device)
    decode = decode_block_plain if plain else decode_block

    def step(i, q):
        return block_checksum(decode(i[None], q[None], *tables, sps=SPS, lag=LAG,
                                     max_candidates=MAX_CANDIDATES))
    return step


def checksum(step, blocks) -> float:
    """The checksums of ``blocks`` (one each) summed, read once."""
    return float(torch.stack([step(*b) for b in blocks]).to(torch.float64).sum())


def run(device=None, n: int = N, iters: int = 48, trials: int = 3, seed: int = 0) -> dict:
    """The bench line as a dict (see the module docstring), on ``device``
    (cuda unless the caller asks for another)."""
    from .._device import resolve_device
    from ..bench import trial_seconds
    from ._measure import device_profile

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    blocks = make_blocks(dev, n, N_BLOCKS, seed)
    step = scan_step(dev)
    float(torch.stack([step(*b) for b in blocks[:2]]).sum())
    seconds = [trial_seconds(step, blocks, iters, cuda)[0] / iters
               for _ in range(trials)]
    med = statistics.median(seconds)
    out = {"n": n, "blocks": N_BLOCKS, "iters": iters, "trials_ms": [s * 1e3 for s in seconds],
           "ms_per_block": med * 1e3, "msps": n / med / 1e6, "x_real_time": n / med / 4e6,
           "checksum": checksum(step, blocks), "device": str(dev)}
    if cuda:
        prof = device_profile(lambda: [step(*blocks[k % N_BLOCKS]) for k in range(iters)],
                              iters)
        out["device_busy_ms_per_block"] = prof.get("device_busy_ms_per_block")
        out["idle_share"] = prof.get("idle_share")
        out["profile_top"] = prof.get("top", [])[:4]
        for key in ("host_wall_ms_per_block", "host_events_per_block",
                    "host_event_ms_per_block"):
            out[key] = prof.get(key)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N, help="samples a block")
    ap.add_argument("--iters", type=int, default=48)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = run(args.device, args.n, args.iters, args.trials)
    print(f"narrowband scan: {res['ms_per_block']:.3f} ms per {res['n']} samples "
          f"-> {res['msps']:.0f} Msps ({res['x_real_time']:.0f}x real time at 4 Msps)",
          flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
