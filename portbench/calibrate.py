"""Readings for the limits of ``correct``: a cell's compared numbers on
many seeds of the program and on a few of its control, in one process.

    python3 portbench/calibrate.py --workload NAME --seeds 12 \
        --control-seeds 3 --seconds 3 [--first-seed N]

Each run is a short window at the cell's own size, checking as many
blocks as a full run does. Prints one JSON line a run, then a summary:
each number's largest reading over the program's seeds (the lower
reading) and its smallest over the control's (the upper one).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)

from portbench import controls, core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = ap.parse_args(argv)
    core.cache_dirs(ROOT)
    core.few_threads()
    import torch

    torch.set_num_threads(1)
    bench = core.benchmark(ROOT)
    entry, config, traffic, settings = core.cell(bench, args.workload)
    sysm = core.system(config["system"])
    readings = {"program": {}, "control": {}}
    runs = [("program", s) for s in range(args.seeds)] + \
        [("control", s) for s in range(args.control_seeds)]
    for side, k in runs:
        seed = args.first_seed + 7919 * k + (0 if side == "program" else 1)
        with controls.applied(settings["control"]) if side == "control" \
                else contextlib.nullcontext({}) as overrides:
            ctx = core.Context(args.workload, config, traffic, settings, seed=seed,
                               seconds=args.seconds, trace=False, device="cuda",
                               t_process0=time.perf_counter(),
                               config_overrides={**overrides,
                                                 "selftest": side == "program" and k == 0})
            rec = sysm.run(ctx)
        vals = {n: c.value for n, c in rec.checks.items()}
        for n, v in vals.items():
            readings[side].setdefault(n, []).append(v)
        print(json.dumps({"workload": args.workload, "side": side, "seed": seed,
                          "correct": rec.correct, "checks": vals,
                          "attempted": rec.attempted, "failed": rec.failed,
                          "notes": rec.notes}), flush=True)
    summary = {n: {"lower": max(v), "upper": min(readings["control"].get(n, [None]) or [None])
                   if readings["control"].get(n) else None, "program": v,
                   "control": readings["control"].get(n)}
               for n, v in readings["program"].items()}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
