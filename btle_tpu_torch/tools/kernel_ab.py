"""Time the CUDA-core FP32 kernels of two source trees on one card, in turns.

Usage: python btle_tpu_torch/tools/kernel_ab.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (for example a
``git archive`` of a parent commit unpacked under ``build/``). The trees
are measured in the order given, each in a fresh child process that puts
its TREE first on ``sys.path``, builds that tree's kernels and times them
(the order parent, this, this, parent compares two trees on one card):

  - K5 at "f32" im2col (``filterbank_im2col``, kind "f32_im2col") and at
    "bf16" on one bench-geometry block (131072 + 1476 channel samples,
    1280 taps, noise of std 30), operands from that tree's
    ``frontend_operands``;
  - K11 f32 and bf16 (``dev_roll_experiment.run``, im2col-copy at 64
    tiles);
  - K10 at R = 40, 80 and 160 (``dev_rollscale.run``, 64 tiles).

Times are CUDA events, the median of 5 trials of 20 launches (K5) or of
the probes' own trials. Each child prints one JSON line: the tree, the
card's name and power limit, and {kernel: ms}; the parent process prints
them again as one JSON list on its last line. It needs a CUDA card.
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


def child(tree: str) -> dict:
    """Measure the kernels of the btle_tpu_torch package under ``tree``."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from btle_tpu_torch.rx.pipeline import required_halo
    from btle_tpu_torch.tools import dev_roll_experiment, dev_rollscale
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
    aa, mask = default_scan_tables(dev)[:2]
    ms = {}
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
    res = dev_rollscale.run(dev, configs=dev_rollscale.CONFIGS[:3], iters=20, trials=5)
    if res["failures"]:
        raise AssertionError(f"K10: {res['failures']} failures")
    for r in res["configs"].values():
        ms[f"K10 R{r['rows']}"] = r["ms"]
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
