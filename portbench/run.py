"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

(or ``python3 -m portbench.run ...``) from the root of a checkout. The
cell's parts are found by name (portbench/core.py). Set-up builds the
system under test on the card, runs its self-test, makes the scene from
the seed and warms the cell's block shape; the window then runs for
``--seconds``; after it, the program's outputs of blocks drawn from the
seed are compared with the plain reference. The last lines on stderr are
the numbers compared, each beside its limit; the last line on stdout is
one JSON object. Exits non-zero, printing no result, without enough
CUDA cards, or when the process loaded jax, jaxlib, flax or btle_tpu.
"""

from __future__ import annotations

import time

T_MAIN = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# run as a script, Python puts portbench/ first on the path: put the
# checkout's root there instead, so no harness file shadows a module
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import core  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(rec: core.RunRecord, metrics: list, chips: int, trace: bool) -> dict:
    import torch

    values = {}
    for m in metrics:
        v = core.reader(m["name"])(rec)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(rec.memory_peak_bytes)}
    out = {"correct": rec.correct, "attempted": rec.attempted,
           "failed": rec.failed, "metrics": values, "device": device}
    if trace and rec.trace is not None:
        device["busy_s"] = rec.trace["busy_s"]
        device["window_s"] = rec.trace["window_s"]
        out["breakdown"] = {"device_ops": rec.trace["device_ops"],
                            "idle_gaps": rec.trace["idle_gaps"]}
    out["checks"] = {k: {"value": c.value, "limit": c.limit}
                     for k, c in rec.checks.items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    t_process0 = T_MAIN - core.process_age_s()
    bench = core.benchmark(ROOT)
    entry, config, traffic, settings = core.cell(bench, args.workload)
    core.cache_dirs(ROOT)
    core.few_threads()
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import btle_tpu_torch

    if ROOT not in Path(btle_tpu_torch.__file__).resolve().parents:
        print(f"portbench: the program under test is not this checkout's "
              f"({btle_tpu_torch.__file__})", file=sys.stderr)
        return 4
    ctx = core.Context(args.workload, config, traffic, settings,
                       seed=args.seed % (1 << 63), seconds=args.seconds,
                       trace=bool(args.trace), device="cuda", t_process0=t_process0)
    rec = core.system(config["system"]).run(ctx)
    line = result_line(rec, core.metrics_for(bench, args.workload, bool(args.trace)),
                       entry["chips"], bool(args.trace))
    bad = core.forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: the process loaded {bad}; no result", file=sys.stderr)
        return 3
    for note in rec.notes:
        print(note, file=sys.stderr)
    for name, c in rec.checks.items():
        print(f"check {name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
