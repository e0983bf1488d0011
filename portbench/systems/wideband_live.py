"""The deployed live wideband loop: a feed thread writes the scene's
int16 IQ into the program's native ring (runtime.IqRingBuffer) while
``WidebandStreamRunner.run_live`` reads blocks, dispatches the scan
(``WidebandSniffer.scan_async``), walks it (``consume_scan``) and emits
NDJSON, as ``wideband --live --fused --json`` does.

The feed is the traffic's: closed loop (as fast as the ring has room,
never overrunning it, like a capture replayed or a flow-controlled
radio) or paced (each write handed over when its last sample is due,
on a schedule that does not slow when the sniffer does). The harness
wraps the runner's and the sniffer's calls with its host clock; the
program gets only the IQ.
"""

from __future__ import annotations

import bisect
import time

import numpy as np

from portbench import core, roofline
from portbench.feed import NativeFeed
from portbench.reference import ble
from portbench.reference import wideband as ref
from portbench.devtrace import TraceWindow

# a scene packet's AA, in channel samples past (AA start at 80 Msps)/20:
# the Gaussian pulse's symbol of delay and the channelizer's group delay
# ((1280 - 1) / 2 wideband samples), measured with the reference
AA_DELAY_CH = 35
MATCH_TOL_CH = 8


def _sniffer_config(ctx):
    from btle_tpu_torch.wideband import WidebandConfig

    s = {**ctx.config["sniffer"], **ctx.config_overrides}
    return WidebandConfig(
        access_address_hex=s["access_address_hex"], crc_init_hex=s["crc_init_hex"],
        follow_connections=False, max_candidates=s["max_candidates"],
        scan_len_ch=ctx.traffic["block"], num_taps=s["num_taps"], fused=True,
        fused_dtype=s["fused_dtype"], phy=s["phy"]), s


def ring_capacity(wb_block_len: int) -> int:
    """The CLI's ring: at least 8 blocks of territory and halo, a power
    of two of at least 2^22 pairs (cli/app.py ``_wideband_live``)."""
    need = 8 * wb_block_len
    return 1 << max(22, (need - 1).bit_length())


def _stream(scene, start: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Pairs [start, start+n) of the looped scene as int16 (i, q); zeros
    before 0."""
    idx = np.arange(start, start + n)
    i = np.where(idx >= 0, scene.iq[2 * (idx % scene.n_pairs)], 0)
    q = np.where(idx >= 0, scene.iq[2 * (idx % scene.n_pairs) + 1], 0)
    return i.astype(np.int16), q.astype(np.int16)


def run(ctx: core.Context) -> core.RunRecord:
    import torch

    from btle_tpu_torch import runtime
    from btle_tpu_torch.stream.ndjson import NdjsonEmitter
    from btle_tpu_torch.wideband import WidebandSniffer
    from btle_tpu_torch.wideband import fused as fused_mod
    from btle_tpu_torch.wideband.stream import WidebandStreamRunner

    rec = core.RunRecord()
    rec.mark("imports")
    traffic = {**ctx.traffic, **ctx.traffic_overrides}
    wcfg, s = _sniffer_config(ctx)
    dev = torch.device(ctx.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    if not runtime.available():
        raise RuntimeError("the native ring (g++) did not build")
    sn = WidebandSniffer(wcfg, device=dev)
    rec.mark("sniffer")
    if s["selftest"] and dev.type == "cuda":
        sn.selftest()            # as the CLI runs it on a card
    rec.mark("self-test")
    scene_params = {**traffic["scene"], **ctx.scene_overrides}
    scene = core.scene_generator(scene_params["generator"]).generate(
        scene_params, ctx.seed, ctx.settings["scene_salt"])
    rec.mark("scene")
    step = wcfg.scan_len_ch * ref.D
    halo_wb = sn.halo_ch * ref.D
    # warm the block shape the ring path dispatches (int16) on a sniffer
    # of its own, so the timed one starts from a fresh stream
    warm = WidebandSniffer(wcfg, device=dev)
    for k in range(3):
        warm.process(*_stream(scene, k * step, sn.wb_block_len))
    del warm
    rec.mark("warm-up")
    tw = TraceWindow(ctx.trace, *traffic["trace_span_s"])
    capacity = ring_capacity(sn.wb_block_len)
    ring = runtime.IqRingBuffer(capacity)
    runner = WidebandStreamRunner(sn, ndjson=NdjsonEmitter(core.NullSink()))
    runner.start()
    rec.mark("ring and runner")

    # -- harness wrappers: host clock around the program's calls --------
    check = ctx.settings["check"]
    rng = np.random.default_rng([ctx.settings["scene_salt"], ctx.seed, 1])
    span = max(2 * check["blocks"] + 2, int(check["blocks_per_s"] * ctx.seconds))
    want = [int(k) for k in rng.choice(np.arange(1, span), 2 * check["blocks"],
                                       replace=False)]
    lattices: dict = {}
    state = {"block": -1, "consumed": 0}
    dispatch_t, done_t, packets = [], [], []
    acc = {"scan_async": [0.0, 0], "consume_scan": [0.0, 0]}
    t_window = [0.0]
    orig_scan, orig_consume_scan = sn.scan_async, sn.consume_scan
    orig_consume, orig_frontend = runner.consume, fused_mod.fused_frontend

    def scan_async(i16, q16):
        t = time.perf_counter()
        tw.tick(t, t_window[0])
        tw.count_block()
        state["block"] = len(dispatch_t)
        dispatch_t.append(t)
        with tw.span("scan_async"):
            h = orig_scan(i16, q16)
        if not tw.started:
            acc["scan_async"][0] += time.perf_counter() - t
            acc["scan_async"][1] += 1
        return h

    def consume_scan(handle):
        # a scan path that hands its lattice over in the handle (as
        # "lattice": (bits, hit, mag)) is read there; otherwise the
        # front end's wrapper below reads it
        k = state["consumed"]
        state["consumed"] += 1
        lat = handle.get("lattice") if isinstance(handle, dict) else None
        if lat is not None and k in want and k not in lattices:
            lattices[k] = tuple(t.clone() for t in lat)
        t = time.perf_counter()
        with tw.span("consume_scan"):
            out = orig_consume_scan(handle)
        if not tw.started:
            acc["consume_scan"][0] += time.perf_counter() - t
            acc["consume_scan"][1] += 1
        return out

    def consume(handle):
        with tw.span("consume"):
            pkts = orig_consume(handle)
        done_t.append(time.perf_counter())
        packets.append([_compact(p) for p in pkts])
        return pkts

    def frontend(*a, **k):
        out = orig_frontend(*a, **k)
        if state["block"] in want and state["block"] not in lattices:
            lattices[state["block"]] = out
        return out

    sn.scan_async, sn.consume_scan, runner.consume = scan_async, consume_scan, consume
    fused_mod.fused_frontend = frontend
    feed_cfg = traffic["feed"]
    rate = feed_cfg.get("rate_msps")
    feed = NativeFeed(ring, scene.iq, feed_cfg["write_pairs"], rate, capacity,
                      max_writes=int((ctx.seconds + 5) * (rate or 4000) * 1e6
                                     / feed_cfg["write_pairs"]) + 1000)
    core.settle_heap()
    try:
        t0 = time.perf_counter()
        rec.setup_s = t0 - ctx.t_process0
        t_window[0] = t0
        deadline = t0 + ctx.seconds
        feed.start(t0)
        with core.GcWatch() as gcw:
            runner.run_live(ring, should_stop=lambda: time.perf_counter() >= deadline,
                            pipeline=s["pipeline"])
        tw.stop()
    finally:
        feed.stop()
        fused_mod.fused_frontend = orig_frontend
    runner.stop()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)

    # -- what the window did ------------------------------------------------
    rec.window_s = ctx.seconds
    done = np.array(done_t)
    rec.blocks = int((done <= deadline).sum())
    rec.territory_samples = rec.blocks * step
    g_start, d_start, took, due = feed.delivered()
    rec.notes.append(gcw.note())
    if not feed_cfg.get("rate_msps"):
        rec.notes.append(core.slice_note(
            "Msps", done_t, [step] * len(done_t), t0, ctx.seconds,
            lambda v: sum(v) / 5.0 / 1e6))
    if feed_cfg.get("rate_msps"):
        cum = d_start + took
        waits, works = [], []
        for k, t_done in enumerate(done_t):
            if dispatch_t[k] > deadline:
                break
            last = k * step + step + halo_wb - 1
            j = int(np.searchsorted(cum, last, side="right"))
            rec.latencies_s.append(t_done - due[j])
            waits.append(dispatch_t[k] - due[j])
            works.append(t_done - dispatch_t[k])
        rec.notes.append(core.slice_note(
            "p95 ms", done_t, rec.latencies_s, t0, ctx.seconds, lambda v: core.p95(v) * 1e3))
        rec.notes.append(core.spread_note("due to dispatch", waits))
        rec.notes.append(core.spread_note("dispatch to consumed", works))
        late = np.array([w - d for _, _, _, d, w in feed.writes if w <= deadline])
        rec.notes.append(f"feed lateness: {len(late)} writes, mean "
                         f"{late.mean() * 1e3:.4f} ms, p99 "
                         f"{np.percentile(late, 99) * 1e3:.4f} ms, max "
                         f"{late.max() * 1e3:.4f} ms")
    rec.trace = tw.reduce()
    if tw.started:
        rec.notes.append(f"traced span: the profiler's start held the host "
                         f"{tw.stall_s:.3f} s; span {tw.t_stop - tw.t_start:.3f} s, "
                         f"{tw.blocks} blocks")
    clean_s = (tw.t_begin - t0) if tw.started else ctx.seconds
    rec.spans = {
        "scan_async": acc["scan_async"], "consume_scan": acc["consume_scan"],
        "loop": [clean_s - acc["scan_async"][0] - acc["consume_scan"][0],
                 acc["scan_async"][1]]}
    rec.geometry = roofline.geometry(wcfg.scan_len_ch, wcfg.num_taps, slots=wcfg.max_candidates)
    rec.geometry["numerics"] = wcfg.fused_dtype
    lost = sum(1 for _, n, t, _, _ in feed.writes if t < n)
    refused = sum(n - t for _, n, t, _, w in feed.writes if w <= deadline)
    st = runner.stats
    rec.notes.append(
        f"blocks {len(dispatch_t)} dispatched, {rec.blocks} done in the window; "
        f"packets {st.packets} (CRC OK {st.crc_ok}); rescans {st.truncate_rescans}; "
        f"writes {len(feed.writes)}, short writes {lost}, pairs refused in the window "
        f"{refused}, ring.dropped {ring.dropped}")
    ring.close()

    # -- the comparison, after the window ---------------------------------
    aa = _sniffer_aa(s)
    account_s = ctx.settings.get("account_air_s")
    rec.attempted, rec.failed = _scene_accounting(
        scene, scene.packets_on(aa), packets, len(dispatch_t), wcfg.scan_len_ch,
        g_start, d_start, took,
        span_pairs=None if account_s is None
        else int(account_s * scene_params["sample_rate_msps"] * 1e6))
    host_lat = {k: tuple(t.cpu() for t in v) for k, v in lattices.items()}
    del lattices, sn, runner
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    picked = [k for k in want if k in host_lat and k < len(packets)][: check["blocks"]]
    rec.checks, lines = _compare(ctx, s, scene, picked, host_lat, packets, wcfg,
                                 halo_wb, g_start, d_start, took, dev)
    if "ring_refused" in ctx.settings["limits"]:
        # every sample the radio sent in the window reached the sniffer;
        # a traced run's profiler holds the loop for seconds and the
        # ring refuses what comes meanwhile, so only untraced runs hold it
        if ctx.trace:
            lines.append(f"ring_refused {refused}: not held in a traced run")
        else:
            rec.checks["ring_refused"] = core.Check(refused, ctx.settings["limits"]["ring_refused"])
    rec.notes += lines
    rec.notes.insert(0, rec.phase_note(ctx.t_process0))
    return rec


def _sniffer_aa(s: dict) -> int:
    """The sniffer's access address as an integer (the configuration
    writes its octets in air order)."""
    return int.from_bytes(int(s["access_address_hex"], 16).to_bytes(4, "big"), "little")


def _compact(p):
    """What the comparison reads of a packet handed on, as atoms the
    collector need not scan: (channel, position, AA, CRC OK, PDU, RSSI
    statistic)."""
    return (int(p.channel), int(p.sample_pos), int(p.access_addr), bool(p.crc_ok),
            bytes(p.pdu_bytes.astype(np.uint8)), float(p.rssi_mag))


def _delivered_to_generated(d, g_start, d_start, took):
    """Generated pair index of delivered pair d (arrays), or -1."""
    j = np.searchsorted(d_start, d, side="right") - 1
    off = d - d_start[j]
    return np.where(off < took[j], g_start[j] + off, -1)


def _block_input(scene, k, step, halo_wb, ctx_len, g_start, d_start, took):
    """Block k's delivered samples with the filter's history before them,
    as the sniffer concatenates them (zeros before the stream)."""
    d = np.arange(k * step - ctx_len, k * step + step + halo_wb)
    g = np.full(len(d), -1, np.int64)
    ok = d >= 0
    g[ok] = _delivered_to_generated(d[ok], g_start, d_start, took)
    i = np.where(g >= 0, scene.iq[2 * (np.maximum(g, 0) % scene.n_pairs)], 0)
    q = np.where(g >= 0, scene.iq[2 * (np.maximum(g, 0) % scene.n_pairs) + 1], 0)
    return i.astype(np.int16), q.astype(np.int16)


def _compare(ctx, s, scene, picked, lattices, packets, wcfg, halo_wb,
             g_start, d_start, took, dev):
    """The program's lattices and packets of the picked blocks against
    the reference recomputed from the same IQ (block k-1 first, for the
    cursors block k inherits)."""
    import torch

    limits = ctx.settings["limits"]
    step = wcfg.scan_len_ch * ref.D
    ctx_len = wcfg.num_taps - 1
    aa = _sniffer_aa(s)
    crc_init = ble.ADV_CRC_INIT_TABLE
    flips = decisions = hit_diff = pkt_diff = 0
    rssi_gap = 0.0
    rescans = 0
    operand = s["operand"]
    for k in picked:
        walker = ref.Walker(wcfg.scan_len_ch, 4, wcfg.max_candidates, aa, crc_init,
                            offset=(k - 1) * wcfg.scan_len_ch)
        for b in (k - 1, k):
            xi, xq = _block_input(scene, b, step, halo_wb, ctx_len, g_start, d_start, took)
            bits, hit, mag = ref.block_lattice(xi, xq, wcfg.num_taps,
                                               wcfg.resolved_cutoff_mhz, operand,
                                               aa, 4, 4, dev)

            def rescan_lattice(xi=xi, xq=xq):
                return [t.cpu().numpy() for t in ref.block_lattice(
                    xi, xq, wcfg.num_taps, wcfg.resolved_cutoff_mhz, "exact",
                    aa, 4, 4, dev, int_mag=True)]
            ref_pkts = walker.block(bits.cpu().numpy(), hit.cpu().numpy(),
                                    mag.cpu().numpy(), rescan_lattice)
        pb, ph, pm = (t.to(dev) for t in lattices[k])
        flips += int((pb.to(torch.bool) != bits).sum())
        decisions += bits.numel()
        hit_diff += int((ph != hit).sum())
        floor = 1e-6 * float(mag.abs().max())
        rssi_gap = max(rssi_gap, float(((pm.to(torch.float64) - mag).abs()
                                        / mag.abs().clamp_min(floor)).max()))
        got = {p[:5]: p[5] for p in packets[k]}
        want = {(p.channel, p.sample_pos, p.access_addr, p.crc_ok, p.pdu): p.rssi_mag
                for p in ref_pkts}
        pkt_diff += len(set(got) ^ set(want))
        for key in set(got) & set(want):
            rssi_gap = max(rssi_gap, abs(got[key] - want[key]) / max(abs(want[key]), 1e-12))
        rescans += walker.rescans
    checks = {
        "pkt_diff": core.Check(pkt_diff, limits["pkt_diff"]),
        "hit_diff": core.Check(hit_diff, limits["hit_diff"]),
        "flip_ppm": core.Check(1e6 * flips / max(1, decisions), limits["flip_ppm"]),
        "rssi_gap": core.Check(rssi_gap, limits["rssi_gap"]),
    }
    lines = [f"checked blocks {sorted(picked)} ({decisions} decisions, "
             f"{sum(len(packets[k]) for k in picked)} packets, reference rescans {rescans})"]
    if len(picked) < ctx.settings["check"]["blocks"]:
        checks["blocks_short"] = core.Check(
            ctx.settings["check"]["blocks"] - len(picked), 0)
    return checks, lines


def _scene_accounting(scene, on_air, packets, n_blocks, scan_len, g_start, d_start, took,
                      span_pairs=None):
    """(attempted, failed): the scene's packets on the sniffer's AA
    (``on_air``) whose AA lies in the territory of the dispatched blocks
    (on generated positions, so a packet the ring dropped counts too),
    those not handed on exactly, and packets handed on where no scene
    packet was (a wrong packet where one was is its scene packet's
    failure, counted once).

    With ``span_pairs`` (a closed-loop cell, whose window reaches further
    into the looped air the faster the program runs) the operations are
    instead the packets of the first ``span_pairs`` generated pairs, the
    same in every run of a seed: one the window never reached is failed."""
    if not len(g_start):
        return 0, 0
    gen_end = int(g_start[-1] + took[-1])
    d_total = int(d_start[-1] + took[-1])
    end_ch = min(n_blocks * scan_len, d_total // ref.D) - MATCH_TOL_CH
    ghost_end = end_ch
    if span_pairs is not None:
        d_span = _generated_to_delivered(min(span_pairs, gen_end - 1), g_start, d_start, took)
        ghost_end = min(end_ch, (d_span if d_span is not None else d_total) // ref.D)
    handed = {}
    for blk in packets:
        for ch, pos, _, crc_ok, pdu, _ in blk:
            handed.setdefault(ch, []).append((pos, crc_ok, pdu))
    for v in handed.values():
        v.sort(key=lambda h: h[0])
    starts = {ch: [h[0] for h in v] for ch, v in handed.items()}
    attempted = failed = 0
    near = set()
    stop_g = gen_end if span_pairs is None else span_pairs
    for r in range(stop_g // scene.n_pairs + 1):
        for p in on_air:
            g = r * scene.n_pairs + p.aa_start
            if g >= stop_g:
                break
            d = _generated_to_delivered(g, g_start, d_start, took) if g < gen_end else None
            pos = d // ref.D + AA_DELAY_CH if d is not None else None
            if span_pairs is None and pos is not None and pos >= end_ch:
                break
            attempted += 1
            exact = False
            if pos is not None and pos < end_ch + MATCH_TOL_CH and p.channel in handed:
                v = handed[p.channel]
                k = bisect.bisect_left(starts[p.channel], pos - MATCH_TOL_CH)
                while k < len(v) and v[k][0] <= pos + MATCH_TOL_CH:
                    near.add((p.channel, v[k][0]))
                    exact = exact or (v[k][1] and v[k][2] == p.pdu)
                    k += 1
            failed += not exact
    ghosts = sum(1 for ch, v in handed.items() for h in v
                 if h[0] < ghost_end and (ch, h[0]) not in near)
    return attempted, failed + ghosts


def _generated_to_delivered(g, g_start, d_start, took):
    """Delivered pair index of generated pair g, or None if the ring
    refused it."""
    j = int(np.searchsorted(g_start, g, side="right")) - 1
    off = g - int(g_start[j])
    return int(d_start[j]) + off if off < took[j] else None
