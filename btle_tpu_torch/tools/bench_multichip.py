"""Multi-device scaling benchmark for the sharded wideband scan.

Port of tools/bench_multichip.py. Measures sustained wideband throughput
of ``dist.ShardedWidebandScan`` at several mesh sizes over the ranks of
the current ``torch.distributed`` group (NCCL ranks, one card each; or
gloo ranks on the CPU, which validate the mechanics and the scaling
trend) and reports efficiency against the 1-device run plus the analytic
per-block communication volumes (the halo exchange over the time axis,
the all_reduce of the partial DFT over the channel axis). Inputs are
placed on each rank once — the steady state of a front end writing
blocks to their owning device — so the timing isolates compute and
collectives. Each mesh: 2 warm steps, then 3 trials of ``iters`` steps
(CUDA events on cards, the host clock on the CPU), the median trial.

  python -m btle_tpu_torch.tools.bench_multichip            # world size 1, cuda
  python -m btle_tpu_torch.tools.bench_multichip --cpu-devices 8 [--block-wb 655360]
  # one process per card:
  python -m btle_tpu_torch.tools.bench_multichip --coordinator host0:1234 \\
      --num-processes 4 --process-id $RANK

One JSON line per mesh (the JAX tool's keys, plus each trial's ms).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np


def pick_meshes(n_dev):
    """(n_ch, n_time) grids to sweep: one balanced factorization per
    power-of-two device count, plus the pure-channel and pure-time
    extremes at the largest size."""
    sweeps = []
    total = 1
    while total <= n_dev:
        for c in (8, 5, 4, 2, 1):
            if total % c == 0 and 40 % c == 0 and c * c <= total * 4:
                sweeps.append((c, total // c))
                break
        total *= 2
    largest = sweeps[-1][0] * sweeps[-1][1]
    for extreme in ((largest, 1), (1, largest)):
        if extreme[0] <= 8 and 40 % extreme[0] == 0 and extreme not in sweeps:
            sweeps.append(extreme)
    return sweeps


def comm_volumes(scan):
    """Bytes moved by collectives per block per device (I+Q float32)."""
    k = scan.block_wb // 20 + scan.halo_wb // 20  # per-channel samples
    return {
        "halo_ppermute_bytes": 2 * 4 * (scan.halo_wb + scan.num_taps - 1),
        "dft_psum_bytes": 2 * 4 * 40 * k,
    }


def bench_mesh(n_ch, n_time, block_wb, iters, rng, device_type="cuda"):
    """One mesh's row, on rank 0 (None on ranks the mesh leaves out, and
    on the other ranks of the mesh)."""
    import torch
    import torch.distributed as dist

    from ..dist import ShardedWidebandScan, make_mesh

    mesh = make_mesh(n_ch, n_time, device_type)
    n = n_time * block_wb
    # every rank draws the same global blocks and keeps its own shard
    blocks = [tuple(rng.normal(0, 30, n).astype(np.float32) for _ in range(2))
              for _ in range(4)]
    if mesh.get_coordinate() is None:
        return None
    scan = ShardedWidebandScan(mesh, block_wb=block_wb)
    own = slice(scan.t_idx * block_wb, (scan.t_idx + 1) * block_wb)
    placed = [tuple(torch.as_tensor(x[own], device=scan.device) for x in b)
              for b in blocks]
    cuda = scan.device.type == "cuda"

    def run(b):
        return scan.run_placed(*b)

    for b in placed[:2]:
        run(b)
    trials = []
    for _ in range(3):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(iters):
            out = run(placed[k % 4])
        out["num_hits"].cpu()
        trials.append((time.perf_counter() - t0) / iters)
    dt = statistics.median(trials)
    if dist.get_rank():
        return None
    return {
        "devices": n_ch * n_time, "mesh": f"{n_ch}x{n_time}",
        "msps": n / dt / 1e6,
        "ms_per_block": dt * 1e3,
        **comm_volumes(scan),
        "ms_trials": [t * 1e3 for t in trials],
    }


def sweep(block_wb: int = 655360, iters: int = 10, meshes=None,
          device_type: str = "cuda") -> list:
    """bench_mesh over ``meshes`` (pick_meshes of the world size by
    default) on the current group; rank 0 returns the rows with their
    scaling efficiency against the 1-device row."""
    import torch.distributed as dist

    rng = np.random.default_rng(0)
    results, base = [], None
    for n_ch, n_time in meshes or pick_meshes(dist.get_world_size()):
        row = bench_mesh(n_ch, n_time, block_wb, iters, rng, device_type)
        if row is None:
            continue
        if base is None and row["devices"] == 1:
            base = row["msps"]
        if base:
            row["scaling_efficiency"] = row["msps"] / (base * row["devices"])
        results.append(row)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--block-wb", type=int, default=655360)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--backend", default="nccl", help="nccl (cards) or gloo")
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="spawn N gloo ranks on the CPU (mechanics test)")
    ap.add_argument("--mesh", default=None,
                    help="only this CHxTIME factorization (e.g. 4x2)")
    ap.add_argument("--out", default=None, help="write results JSON here")
    args = ap.parse_args(argv)
    meshes = [tuple(int(v) for v in args.mesh.split("x"))] if args.mesh else None
    if args.cpu_devices:
        from ..dist.dryrun import spawn

        results = spawn(args.cpu_devices, sweep, args.block_wb, args.iters, meshes,
                        "cpu", backend="gloo", device_type="cpu", timeout=3600)[0]
        platform, n_dev = "cpu", args.cpu_devices
    else:
        import torch.distributed as dist

        from ..dist.dryrun import free_port
        from ..dist.multihost import init_distributed

        if args.num_processes == 1 and not dist.is_initialized():
            dist.init_process_group(args.backend, init_method=f"tcp://localhost:{free_port()}",
                                    world_size=1, rank=0)
        init_distributed(args.coordinator, args.num_processes, args.process_id,
                         args.backend)
        device_type = "cuda" if args.backend == "nccl" else "cpu"
        results = sweep(args.block_wb, args.iters, meshes, device_type)
        platform, n_dev = device_type, dist.get_world_size()
    for row in results or []:
        print(json.dumps(row), flush=True)
    if args.out and results is not None:
        with open(args.out, "w") as f:
            json.dump({"platform": platform, "host_devices": n_dev,
                       "block_wb": args.block_wb, "results": results}, f, indent=1)
    return results


if __name__ == "__main__":
    main()
