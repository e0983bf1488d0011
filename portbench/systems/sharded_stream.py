"""The per-process sharded wideband stream (BASELINE config 5): one
process a card, each feeding its own slice of every step to
``btle_tpu_torch.dist.MultiHostWidebandScan`` in a closed loop, as
``dist/multihost.py``'s usage runs it.

run.py's process is rank 0; it starts the other ranks, each a fresh
process on its own card (``torch.cuda.set_device``), with the harness's
one-thread pools and frozen heap. Every process builds the looped scene
from the seed; step k of the rank at time shard t feeds the stream's
block k * n_time + t (and, on the last time shard, the lookahead after
it), the next step starting when every rank has finished the last. Rank
0 keeps the window's clock and says when the ranks stop (two steps
ahead, through shared memory, so every rank runs the same steps). A
rank that dies ends the run at once, with no result.

The check, after the window: each rank's lattices of its shard window
(context, territory, head) for steps drawn from the seed against the
plain reference (portbench/reference/sharded.py), rank 0's packets of
those steps against the reference's walk of the stream (a rescan on its
own lattice), and every rank's packets equal to rank 0's.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import socket
import sys
import threading
import time

import numpy as np

from portbench import core, roofline
from portbench.devtrace import TraceWindow
from portbench.reference import ble
from portbench.reference import sharded as RS
from portbench.reference import wideband as ref
from portbench.systems.wideband_live import _compact, _scene_accounting, _sniffer_aa

# the program's spans of a step (the last inside the walk): rank 0's, a
# step before the profiler, are the per-layer metrics' RunRecord.spans
STEP_SPANS = ("shard.ingest", "shard.exchange", "shard.scan", "shard.gather", "shard.walk")
SPANS = STEP_SPANS + ("shard.rescan",)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Stream:
    """The looped scene as the stream: ``take(start, n)`` gives int16
    (i, q) of pairs [start, start + n). The scene is held with its first
    ``reach`` pairs again after its end, so a read of up to that many
    pairs is a view, wherever the loop point falls."""

    def __init__(self, scene, reach: int):
        self.n = scene.n_pairs
        self.i = np.concatenate([scene.iq[0::2], scene.iq[0: 2 * reach: 2]])
        self.q = np.concatenate([scene.iq[1::2], scene.iq[1: 2 * reach: 2]])
        self.reach = reach

    def take(self, start: int, n: int):
        if n > self.reach:
            raise ValueError(f"a read of {n} pairs is longer than {self.reach}")
        s = start % self.n
        return self.i[s: s + n], self.q[s: s + n]


def _settings(ctx):
    s = {**ctx.config["sniffer"], **ctx.config_overrides}
    traffic = {**ctx.traffic, **ctx.traffic_overrides}
    return s, traffic


def run(ctx: core.Context) -> core.RunRecord:
    """Rank 0: start the others, run its own rank, gather the reports."""
    from btle_tpu_torch.dist.multihost import MultiHostWidebandScan

    if not hasattr(MultiHostWidebandScan, "lookahead_wb"):
        raise RuntimeError("the program has no per-process stream "
                           "(MultiHostWidebandScan.lookahead_wb): it cannot run this cell")
    import multiprocessing as mp

    n_ch, n_time = ctx.config["mesh"]
    world = n_ch * n_time
    rec = core.RunRecord()
    mpc = mp.get_context("spawn")
    # the step the ranks stop at (-1: not yet), and how many steps rank 0
    # counts before its profiler (the span totals' cut)
    shared = (mpc.Value("q", -1), mpc.Value("q", 0))
    reports = mpc.Queue()
    port = _free_port()
    procs = [mpc.Process(target=_child, args=(r, world, port, ctx, shared, reports),
                         daemon=True) for r in range(1, world)]
    for p in procs:
        p.start()
    watch = _Watch(procs)
    watch.start()
    try:
        own = _rank(0, world, port, ctx, shared, rec)
        others = [reports.get(timeout=600) for _ in procs]
    finally:
        watch.stop()
    for p in procs:
        p.join(timeout=60)
        if p.is_alive():
            p.terminate()
    _finish(ctx, rec, own, sorted(others, key=lambda r: r["rank"]))
    return rec


class _Watch(threading.Thread):
    """Ends the run as soon as another rank exits without success (its
    peers would wait in a collective until the group's time limit)."""

    def __init__(self, procs):
        super().__init__(daemon=True)
        self.procs = procs
        self.done = threading.Event()

    def run(self):
        while not self.done.wait(0.2):
            bad = [(r + 1, p.exitcode) for r, p in enumerate(self.procs)
                   if p.exitcode not in (None, 0)]
            if bad:
                print(f"portbench: ranks {[r for r, _ in bad]} exited "
                      f"{[c for _, c in bad]}; no result", file=sys.stderr, flush=True)
                for p in self.procs:
                    if p.is_alive():
                        p.terminate()
                os._exit(5)

    def stop(self):
        self.done.set()


def _child(rank, world, port, ctx, shared, reports):
    """Ranks 1..world-1: their own rank, then the report to rank 0. A
    rank whose parent is gone exits."""
    parent = os.getppid()

    def orphan():
        while True:
            time.sleep(0.5)
            if os.getppid() != parent:
                os._exit(6)

    threading.Thread(target=orphan, daemon=True).start()
    reports.put(_rank(rank, world, port, ctx, shared, None))


def _rank(rank, world, port, ctx, shared, rec):
    """One rank from start to its report. Rank 0 (``rec`` given) keeps the
    window and fills the record's clock; the others only follow."""
    stop, cut = shared
    core.few_threads()
    import torch

    torch.set_num_threads(1)
    dev = torch.device(ctx.device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        torch.cuda.reset_peak_memory_stats(dev)
    from btle_tpu_torch.dist.multihost import MultiHostWidebandScan, init_distributed
    from btle_tpu_torch.utils import profiling as P
    from btle_tpu_torch.wideband import fused as fused_mod

    lead = rec is not None
    if lead:
        rec.mark("imports")
    s, traffic = _settings(ctx)
    if s["selftest"] and dev.type == "cuda":
        from btle_tpu_torch.wideband.selftest import fused_selftest

        fused_selftest(compute_dtype=s["fused_dtype"], phy=s["phy"], device=dev)
    if lead:
        rec.mark("self-test")
    scene_params = {**traffic["scene"], **ctx.scene_overrides}
    scene = core.scene_generator(scene_params["generator"]).generate(
        scene_params, ctx.seed, ctx.settings["scene_salt"])
    scan_len = traffic["block"]
    block_wb = scan_len * ref.D
    # a reference window: history, the block and its head
    stream = _Stream(scene, s["num_taps"] + block_wb + RS.halo_wb(s["num_taps"]))
    if lead:
        rec.mark("scene")
    init_distributed(coordinator=f"localhost:{port}", num_processes=world,
                     process_id=rank, backend="nccl" if dev.type == "cuda" else "gloo")
    import torch.distributed as dist

    kw = dict(block_wb=block_wb, device_type=dev.type, fused=True,
              fused_dtype=s["fused_dtype"], max_candidates=s["max_candidates"],
              num_taps=s["num_taps"], access_address_hex=s["access_address_hex"],
              crc_init_hex=s["crc_init_hex"], phy=s["phy"])
    n_ch = ctx.config["mesh"][0]

    def feed(scan, k):
        start = (k * scan.n_time + scan.t_idx) * block_wb
        return stream.take(start, block_wb + scan.lookahead_wb)

    # warm every shape of the step (the rescans' too) on a scan of its
    # own, so the timed one starts a fresh stream
    warm = MultiHostWidebandScan(n_ch, **kw)
    for k in range(3):
        warm.gather_packets(warm(*feed(warm, k)))
    del warm
    scan = MultiHostWidebandScan(n_ch, **kw)
    if lead:
        rec.mark("warm-up")

    check = ctx.settings["check"]
    rng = np.random.default_rng([ctx.settings["scene_salt"], ctx.seed, 1])
    span = max(2 * check["steps"] + 2, int(check["steps_per_s"] * ctx.seconds))
    want = [int(k) for k in rng.choice(np.arange(1, span), 2 * check["steps"],
                                       replace=False)]
    account_s = ctx.settings["account_air_s"]
    span_pairs = int(account_s * scene_params["sample_rate_msps"] * 1e6)
    n_keep = -(-span_pairs // (world * block_wb)) + 1
    lattices, kept = {}, {}
    state = {"step": -1}
    orig_frontend = fused_mod.fused_frontend

    def frontend(*a, **k):
        out = orig_frontend(*a, **k)
        if state["step"] in want and state["step"] not in lattices:
            lattices[state["step"]] = tuple(t.clone() for t in out)
        return out

    tracer = P.Tracer(1 << 20) if ctx.trace else None
    tw = TraceWindow(ctx.trace and lead, *traffic["trace_span_s"])
    done_t = []
    fused_mod.fused_frontend = frontend
    core.settle_heap()
    dist.barrier()
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    try:
        with P.tracing(tracer) if tracer is not None else contextlib.nullcontext():
            k = 0
            while stop.value < 0 or k < stop.value:
                state["step"] = k
                if lead:
                    tw.tick(time.perf_counter(), t0)
                    tw.count_block()
                with tw.span("step"):
                    pkts = scan.gather_packets(scan(*feed(scan, k)))
                if k < n_keep or k in want:
                    kept[k] = pkts
                if lead:
                    now = time.perf_counter()
                    done_t.append(now)
                    if now >= deadline and stop.value < 0:
                        # the others may be one step ahead: every rank
                        # runs this step's successor and then stops
                        stop.value = k + 2
                k += 1
        tw.stop()
    finally:
        fused_mod.fused_frontend = orig_frontend
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    kept = {j: [_compact(p) for p in v] for j, v in kept.items()}
    digests = {j: hashlib.sha1(repr(v).encode()).hexdigest() for j, v in kept.items()}
    report = {"rank": rank, "steps": k, "digests": digests,
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))
              if dev.type == "cuda" else 0,
              "truncated": scan.truncated_cells}
    if lead:
        rec.setup_s = t0 - ctx.t_process0
        report.update(t0=t0, deadline=deadline, done_t=done_t, kept=kept, tw=tw,
                      scene=scene, stream=stream, want=want, settings=s,
                      scan_len=scan_len, block_wb=block_wb,
                      halo_wb=scan.halo_wb)
        # the steps done before the profiler started, and in the window
        t_cut = min(tw.t_begin if tw.started else deadline, deadline)
        cut.value = sum(1 for t in done_t if t <= t_cut)
        if cut.value:
            report["clean_s"] = done_t[cut.value - 1] - t0
    dist.barrier()
    if tracer is not None and cut.value:
        report["totals"] = _step_totals(tracer, cut.value)
        report["clean_steps"] = cut.value
    # the comparison, after the window, on each rank's own card
    host_lat = {j: tuple(t.cpu() for t in v) for j, v in lattices.items()}
    del lattices, scan
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    picked = [j for j in want if j in host_lat and j < k][: check["steps"]]
    report["picked"] = picked
    report["lattice"] = _lattice_checks(ctx, s, stream, picked, host_lat, scan_len,
                                        world, rank, dev)
    if lead:
        report["packets"] = _packet_checks(ctx, s, stream, picked, kept, scan_len,
                                           world, dev)
    dist.barrier()
    dist.destroy_process_group()
    return report


def _step_totals(tracer, n: int) -> dict:
    """The tracer's spans and counters of steps 0..n-1: per span name its
    total and self ns, and each counter's sum."""
    spans = tracer.spans()
    child: dict = {}
    for r in spans:
        if 0 <= r.block < n and r.parent >= 0:
            child[r.parent] = child.get(r.parent, 0) + r.end_ns - r.start_ns
    out: dict = {}
    for r in spans:
        if 0 <= r.block < n:
            t = out.setdefault(r.name, [0, 0])
            t[0] += r.end_ns - r.start_ns
            t[1] += r.end_ns - r.start_ns - child.get(r.ident, 0)
    counters: dict = {}
    for c in tracer.counts():
        if 0 <= c.block < n:
            counters[c.name] = counters.get(c.name, 0) + c.n
    return {"spans": out, "counters": counters, "lost": tracer.lost}


def _reference(ctx, s, stream, scan_len, dev, first: int) -> RS.Stream:
    from btle_tpu_torch.wideband.sniffer import cutoff_for_phy

    return RS.Stream(stream.take, scan_len, s["num_taps"], cutoff_for_phy(s["phy"]),
                     s["operand"], _sniffer_aa(s), ble.ADV_CRC_INIT_TABLE,
                     s["max_candidates"], dev, first=first)


def _lattice_checks(ctx, s, stream, picked, lattices, scan_len, world, rank, dev) -> dict:
    """This rank's shard lattices of the picked steps against the
    reference's lattices of the same windows."""
    import torch

    ref_stream = _reference(ctx, s, stream, scan_len, dev, 0)
    flips = decisions = hit_diff = 0
    rssi_gap = 0.0
    for k in picked:
        bits, hit, mag = ref_stream.lattice(RS.block_of(k, rank, world))
        pb, ph, pm = (t.to(dev) for t in lattices[k])
        if pb.shape != bits.shape or ph.shape != hit.shape:
            flips += bits.numel()
            decisions += bits.numel()
            hit_diff += hit.numel()
            continue
        flips += int((pb.to(torch.bool) != bits).sum())
        decisions += bits.numel()
        hit_diff += int((ph != hit).sum())
        floor = 1e-6 * float(mag.abs().max())
        rssi_gap = max(rssi_gap, float(((pm.to(torch.float64) - mag).abs()
                                        / mag.abs().clamp_min(floor)).max()))
    return {"flips": flips, "decisions": decisions, "hit_diff": hit_diff,
            "rssi_gap": rssi_gap}


def _packet_checks(ctx, s, stream, picked, kept, scan_len, world, dev) -> dict:
    """Rank 0's packets of the picked steps against the reference's walk
    of the same blocks (from the block before each step, for the cursors
    the step inherits)."""
    pkt_diff, rssi_gap, rescans, n = 0, 0.0, 0, 0
    for k in picked:
        ref_stream = _reference(ctx, s, stream, scan_len, dev, k * world - 1)
        ref_stream.block()
        want = {}
        for _ in range(world):
            for p in ref_stream.block()[1]:
                want[(p.channel, p.sample_pos, p.access_addr, p.crc_ok, p.pdu)] = p.rssi_mag
        got = {p[:5]: p[5] for p in kept[k]}
        pkt_diff += len(set(got) ^ set(want))
        for key in set(got) & set(want):
            rssi_gap = max(rssi_gap, abs(got[key] - want[key]) / max(abs(want[key]), 1e-12))
        rescans += ref_stream.walker.rescans
        n += len(got)
    return {"pkt_diff": pkt_diff, "rssi_gap": rssi_gap, "rescans": rescans, "packets": n}


def _finish(ctx, rec, own, others):
    """The record from every rank's report."""
    s = own["settings"]
    world = 1 + len(others)
    limits = ctx.settings["limits"]
    done = np.array(own["done_t"])
    rec.window_s = ctx.seconds
    rec.blocks = int((done <= own["deadline"]).sum())
    rec.territory_samples = rec.blocks * world * own["block_wb"]
    rec.memory_peak_bytes = max([own["memory_peak_bytes"]]
                                + [r["memory_peak_bytes"] for r in others])
    rec.notes.append(core.slice_note(
        "Msps", own["done_t"], [world * own["block_wb"]] * len(own["done_t"]), own["t0"],
        ctx.seconds, lambda v: sum(v) / 5.0 / 1e6))
    tw = own["tw"]
    rec.trace = tw.reduce()
    if tw.started:
        rec.notes.append(f"traced span: the profiler's start held rank 0 "
                         f"{tw.stall_s:.3f} s; span {tw.t_stop - tw.t_start:.3f} s, "
                         f"{tw.blocks} steps")
    if "totals" in own:
        tot, n = own["totals"], own["clean_steps"]
        for name in SPANS:
            if name in tot["spans"]:
                rec.spans[name] = [tot["spans"][name][0] / 1e9, n]
        if "shard.walk" in tot["spans"]:
            rec.spans["shard.walk.self"] = [tot["spans"]["shard.walk"][1] / 1e9, n]
        for name in ("rescan_cells", "h2d_copies", "halo_bytes", "gather_bytes"):
            if name in tot["counters"]:
                rec.spans[name] = [tot["counters"][name], n]
        top = sum(tot["spans"][x][0] for x in STEP_SPANS if x in tot["spans"]) / 1e9
        rec.notes.append(f"rank 0 before the profiler: {n} steps in {own['clean_s']:.3f} s; "
                         f"the shard spans cover {100 * top / own['clean_s']:.2f}% of it; "
                         f"lost {tot['lost']}")
        for r in [own] + others:
            t = r.get("totals")
            if t is not None:
                rec.notes.append(
                    f"rank {r['rank']}, ms a step over the same steps: " + ", ".join(
                        f"{k} {v[0] / n / 1e6:.4f}" + (f" (self {v[1] / n / 1e6:.4f})"
                                                       if k == "shard.walk" else "")
                        for k, v in sorted(t["spans"].items()))
                    + "; a step: " + ", ".join(f"{k} {v / n:.4f}"
                                                for k, v in sorted(t["counters"].items())))
    rec.geometry = roofline.geometry(own["scan_len"], s["num_taps"], slots=s["max_candidates"])
    rec.geometry["numerics"] = s["fused_dtype"]

    # accounting: the packets of the first account_air_s of air
    scene = own["scene"]
    total_pairs = len(own["done_t"]) * world * own["block_wb"] + own["halo_wb"]
    one = np.array([0])
    rec.attempted, rec.failed = _scene_accounting(
        scene, scene.packets_on(_sniffer_aa(s)),
        [own["kept"][k] for k in sorted(own["kept"])], len(own["done_t"]) * world,
        own["scan_len"], one, one, np.array([total_pairs]),
        span_pairs=int(ctx.settings["account_air_s"]
                       * ctx.traffic["scene"]["sample_rate_msps"] * 1e6))

    lat = [own["lattice"]] + [r["lattice"] for r in others]
    pk = own["packets"]
    flips = sum(x["flips"] for x in lat)
    decisions = sum(x["decisions"] for x in lat)
    rank_diff = sum(1 for r in others for k, d in r["digests"].items()
                    if own["digests"].get(k) != d)
    rank_diff += sum(abs(r["steps"] - len(own["done_t"])) for r in others)
    rec.checks = {
        "pkt_diff": core.Check(pk["pkt_diff"], limits["pkt_diff"]),
        "hit_diff": core.Check(sum(x["hit_diff"] for x in lat), limits["hit_diff"]),
        "flip_ppm": core.Check(1e6 * flips / max(1, decisions), limits["flip_ppm"]),
        "rssi_gap": core.Check(max([pk["rssi_gap"]] + [x["rssi_gap"] for x in lat]),
                               limits["rssi_gap"]),
        "rank_diff": core.Check(rank_diff, limits["rank_diff"]),
    }
    picked = own["picked"]
    short = (ctx.settings["check"]["steps"] - len(picked)
             + sum(r["picked"] != picked for r in others))
    if short:
        rec.checks["steps_short"] = core.Check(short, 0)
    rec.notes.append(
        f"steps {len(own['done_t'])} run, {rec.blocks} done in the window; checked steps "
        f"{sorted(picked)} ({decisions} decisions on {world} ranks, {pk['packets']} "
        f"packets, reference rescans {pk['rescans']}); rescans by rank 0 "
        f"{own['truncated']}; digests compared {len(own['digests'])} steps x "
        f"{len(others)} ranks")
    rec.notes.insert(0, rec.phase_note(ctx.t_process0))
