"""Time the kernels of two source trees on one card, in turns.

Usage: python btle_tpu_torch/tools/kernel_ab.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (for example a
``git archive`` of a parent commit unpacked under ``build/``). The trees
are measured in the order given, each in a fresh child process that puts
its TREE first on ``sys.path``, builds that tree's kernels and times them
(the order parent, this, this, parent compares two trees on one card):

  - K1 ("bf16x2w", ``filterbank_bf16x2w``), K5 at "f32" im2col
    (``filterbank_im2col``, kind "f32_im2col") and at "bf16", and K2
    (``demod_tail`` on K1's y) on one bench-geometry block (131072 + 1476
    channel samples, 1280 taps, noise of std 30), operands from that
    tree's ``frontend_operands``;
  - K3 (``filterbank_polyx_f32`` on that block's "f32" operands) and K4
    (``decode_candidates`` on K2's lattice at the 16 earliest hits of
    each channel, 40 x 16, and of one channel, 1 x 16);
  - K11 f32 and bf16 (``dev_roll_experiment.run``, im2col-copy at 64
    tiles) and the K11 AA stage (``run(which="aa")``, aa-fma exact against
    the tool's truth, then ``aa_corr`` timed at 40 x 131072, f32 +-1
    lattice, sps 4, grp 1);
  - K10 at R = 40, 80 and 160 (``dev_rollscale.run``, 64 tiles);
  - K8's AA stage (``aa_corr`` on 40 x 2172 int8 decisions, T = 2048,
    sps 4, grp 8);
  - K9's roll (``shift_stack`` of 40 x 2176 float32 rows, grp 8, sps 4,
    k0 0: the probe's stack);
  - K7 (``scan_block_kernel``, sps 4) at the narrowband block (1 x 131072
    + 1473 int16, lag 1), the live block (1 x 8192 + 1473 int16, lag 1)
    and 40 float rows of a bench block (40 x 131072 + 1476 float32, lag 4).

Times are CUDA events, the median of 5 trials of 20 launches (K1-K3, K5)
or of the probes' own trials. K4, K7, the AA stages of K8 and K11 and
K9's roll are timed by the profiler's device time over 50 launches: their
wrappers' host work takes about as long as the kernel or longer, so events around
back-to-back calls would time the host. Each child prints one JSON line:
the tree, the card's name and power limit, and {kernel: ms}; the parent
process prints them again as one JSON list on its last line. It needs a
CUDA card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

NUM_TAPS = 1280
SCAN_LEN = 131072


def _cuda_ms(fn, iters: int = 20, trials: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(trials):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        t1.synchronize()
        runs.append(t0.elapsed_time(t1) / iters)
    return statistics.median(runs)


def _device_ms(fn, kernel_name: str, reps: int = 50) -> float:
    """Device time per launch of the kernel named ``kernel_name`` over
    ``reps`` calls of ``fn``, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages() if kernel_name in e.key]
    launches = sum(e.count for e in found)
    if not launches:
        raise AssertionError(f"kernel_ab: the profiler recorded no {kernel_name}")
    return sum(e.self_device_time_total for e in found) / 1e3 / launches


def child(tree: str) -> dict:
    """Measure the kernels of the btle_tpu_torch package under ``tree``."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from btle_tpu_torch.phy.scan_kernel import scan_block_kernel
    from btle_tpu_torch.rx.decode_kernel import decode_candidates
    from btle_tpu_torch.rx.pipeline import earliest_hits, required_halo
    from btle_tpu_torch.tools import dev_roll_experiment, dev_rollscale
    from btle_tpu_torch.tools._kernels import aa_corr, shift_stack
    from btle_tpu_torch.wideband import fused
    from btle_tpu_torch.wideband.sniffer import default_scan_tables

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    n = (SCAN_LEN + required_halo(4, 4)) * 20 + NUM_TAPS - 1
    gen = torch.Generator(device=dev).manual_seed(0)
    xi, xq = (30.0 * torch.randn(n, generator=gen, device=dev) for _ in range(2))
    aa, mask, whiten, crc, adv = default_scan_tables(dev)
    ms = {}
    fb, tail = fused.frontend_operands(xi, xq, aa, mask, NUM_TAPS, True, 4, 4,
                                       "bf16x2w", 1.0, dev)
    ms["K1 bf16x2w"] = _cuda_ms(lambda: fused.filterbank_bf16x2w(*fb))
    y = fused.filterbank_bf16x2w(*fb)
    ms["K2 demod_tail"] = _cuda_ms(lambda: fused.demod_tail(y, *tail))
    bits, hit, _ = fused.demod_tail(y, *tail)
    pos = earliest_hits(hit, 16)[0]
    ms["K4 40x16"] = _device_ms(lambda: decode_candidates(bits, pos, whiten, crc, adv, 4),
                                "decode_candidates_kernel")
    one = (bits[:1].contiguous(), pos[:1].contiguous(), whiten[:1], crc[:1], adv[:1])
    ms["K4 1x16"] = _device_ms(lambda: decode_candidates(*one, 4), "decode_candidates_kernel")
    fb, _ = fused.frontend_operands(xi, xq, aa, mask, NUM_TAPS, True, 4, 4, "f32", 1.0, dev)
    ms["K3 f32"] = _cuda_ms(lambda: fused.filterbank_polyx_f32(*fb))
    for label, dtype, inner in (("K5 f32 im2col", "f32", "im2col"),
                                ("K5 bf16", "bf16", None)):
        fb, _ = fused.frontend_operands(xi, xq, aa, mask, NUM_TAPS, True, 4, 4,
                                        dtype, 1.0, dev, inner)
        ms[label] = _cuda_ms(lambda fb=fb: fused.filterbank_im2col(*fb))
    for dtype in ("f32", "bf16"):
        res = dev_roll_experiment.run(dev, which="im2col", dtype=dtype, iters=20,
                                      trials=5)
        if res["failures"]:
            raise AssertionError(f"K11 {dtype}: {res['failures']} failures")
        ms[f"K11 {dtype}"] = res["variants"]["im2col-copy"]["ms"]
    res = dev_roll_experiment.run(dev, which="aa", iters=20, trials=5)
    if res["failures"] or not res["variants"]["aa-fma"]["exact"]:
        raise AssertionError(f"K11 aa: {res['failures']} failures")
    n11 = dev_roll_experiment.N_TILES * dev_roll_experiment.T
    lat = 2.0 * torch.randint(0, 2, (40, n11 + 128), generator=gen, device=dev) - 1.0
    w11 = 2.0 * torch.randint(0, 2, (40, 32), generator=gen, device=dev) - 1.0
    ms["K11 aa-fma"] = _device_ms(lambda: aa_corr(lat, w11, 4, n11, grp=1), "aa_corr_kernel")
    res = dev_rollscale.run(dev, configs=dev_rollscale.CONFIGS[:3], iters=20, trials=5)
    if res["failures"]:
        raise AssertionError(f"K10: {res['failures']} failures")
    for r in res["configs"].values():
        ms[f"K10 R{r['rows']}"] = r["ms"]
    dec = torch.randint(0, 2, (40, 2048 + 31 * 4), generator=gen, device=dev).to(torch.int8)
    signs = (2.0 * torch.randint(0, 2, (40, 32), generator=gen, device=dev) - 1.0)
    ms["K8 aa_only"] = _device_ms(lambda: aa_corr(dec, signs, 4, 2048, grp=8),
                                  "aa_corr_kernel")
    s9 = torch.randn((40, 2176), generator=gen, device=dev)
    ms["K9 roll"] = _device_ms(lambda: shift_stack(s9, 8, 4), "shift_stack_kernel")
    for label, rows, n, lag, dtype in (("narrowband", 1, SCAN_LEN + required_halo(4, 1), 1,
                                        torch.int16),
                                       ("live", 1, 8192 + required_halo(4, 1), 1, torch.int16),
                                       ("float rows 40", 40, SCAN_LEN + required_halo(4, 4), 4,
                                        torch.float32)):
        i, q = (torch.randint(-2000, 2001, (rows, n), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        ms[f"K7 {label}"] = _device_ms(
            lambda i=i, q=q, lag=lag: scan_block_kernel(i, q, aa, mask, 4, lag),
            "scan_block_kernel")
    return {"tree": tree, "nvidia_smi": smi, "ms": ms}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args[:1] == ["--child"]:
        print(json.dumps(child(args[1])), flush=True)
        return 0
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    out = []
    for tree in args:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--child", tree], capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode:
            print(f"kernel_ab: {tree} failed ({proc.returncode})", file=sys.stderr)
            return 1
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        out.append(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
