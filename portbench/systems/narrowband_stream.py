"""The narrowband sniffer on a live stream: ``hackrf_transfer -r - |
decode --bin - --json --rssi``. The harness's source hands the scene's
int8 IQ over in reads of ``read_pairs`` (stdin_source's), each when its
last sample is due at ``rate_msps``, on a schedule that does not slow
when the sniffer does; ``stream.sniffer.Sniffer.run`` decodes it in
blocks of territory and halo.

Block stamps come from the harness's ``control`` object, whose
``apply`` Sniffer.run calls before each block; a block's work ends at
the next such call, or at the source's next read if that comes first
(the sniffer asks for input only after its blocks are done), or when
run returns.
"""

from __future__ import annotations

import bisect
import sys
import time

import numpy as np

from portbench import core
from portbench.devtrace import TraceWindow
from portbench.reference import ble
from portbench.reference import narrowband as ref

MATCH_TOL_US = 4
HOLD_S = 0.05      # a profiler switch that held the host longer shifts the feed


class PacedPipe:
    """The radio's pipe: the looped scene's bytes, handed over in
    transfers of ``read_pairs`` pairs, transfer c when its last sample
    is due at t0 + (c+1) * read_pairs / rate. ``read(n)`` blocks until
    the transfer holding its last byte is due, as a pipe from
    hackrf_transfer does. Records each read: (asked, due, handed over,
    waited)."""

    def __init__(self, iq: np.ndarray, read_pairs: int, rate_msps: float,
                 n_reads: int, t0: float | None = None, tw: TraceWindow | None = None):
        self.tw = tw or TraceWindow(False)
        self.raw = iq.tobytes()
        self.pair_bytes = 2 * iq.itemsize
        self.read_pairs, self.rate = read_pairs, rate_msps * 1e6
        self.total = n_reads * read_pairs * self.pair_bytes
        self.t0 = t0
        self.pos = 0
        self.pulls: list = []
        self.shifts: list = []       # (first read delayed, seconds)

    def shift(self, dt: float):
        """Delay the transfers not yet handed over by ``dt``: the harness
        held the reader (the profiler's start or stop in a traced run),
        and the backlog it left would fill the rest with catch-up."""
        self.shifts.append((self.pos // (self.read_pairs * self.pair_bytes), dt))

    def due(self, c: int) -> float:
        late = sum(dt for first, dt in self.shifts if c >= first)
        return self.t0 + (c + 1) * self.read_pairs / self.rate + late

    def _bytes(self, start: int, n: int) -> bytes:
        size, parts, at = len(self.raw), [], start % len(self.raw)
        while n:
            k = min(n, size - at)
            parts.append(self.raw[at: at + k])
            n, at = n - k, 0
        return b"".join(parts)

    def read(self, n: int) -> bytes:
        asked = time.perf_counter()
        end = min(self.pos + n, self.total)
        if end <= self.pos:
            return b""
        out = self._bytes(self.pos, end - self.pos)
        due = asked
        if self.t0 is not None:
            due = self.due((end // self.pair_bytes - 1) // self.read_pairs)
            with self.tw.span("source_wait"):
                while time.perf_counter() < due:
                    time.sleep(max(0.0, due - time.perf_counter()))
        self.pulls.append((asked, due, time.perf_counter(), due > asked))
        self.pos = end
        return out


class _Stdin:
    """sys.stdin while a pipe stands in for it: stdin_source reads
    ``sys.stdin.buffer``."""

    def __init__(self, pipe):
        self.buffer = pipe


class BlockStamps:
    """The ``control`` the Sniffer calls before each block: stamps the
    block's start, the packets handed on so far, and switches the traced
    span."""

    def __init__(self, tw: TraceWindow, taps: dict, pipe: PacedPipe):
        self.tw, self.taps, self.pipe = tw, taps, pipe
        self.calls: list = []
        self.n_events: list = []
        self.t_window0 = 0.0

    def apply(self, sniffer):
        now = time.perf_counter()
        self.tw.tick(now, self.t_window0)
        held = time.perf_counter() - now
        if held > HOLD_S:
            self.pipe.shift(held)
        self.tw.count_block()
        self.taps["block"] = len(self.calls)
        self.calls.append((now, self.tw.started))
        self.n_events.append(len(sniffer.packets))


def _sniffer_config(ctx):
    from btle_tpu_torch.stream import SnifferConfig

    s = {**ctx.config["sniffer"], **ctx.config_overrides}
    return SnifferConfig(channel=s["channel"], access_addr=int(s["access_addr_hex"], 16),
                         crc_init=int(s["crc_init_hex"], 16), sps=s["sps"],
                         rssi=s["rssi"], scan_len=ctx.traffic["block"]), s


def run(ctx: core.Context) -> core.RunRecord:
    import torch

    from btle_tpu_torch.rx import decoder as decoder_mod
    from btle_tpu_torch.rx import pipeline as pipeline_mod
    from btle_tpu_torch.stream import NdjsonEmitter, Sniffer, stdin_source

    rec = core.RunRecord()
    rec.mark("imports")
    traffic = {**ctx.traffic, **ctx.traffic_overrides}
    scfg, s = _sniffer_config(ctx)
    dev = torch.device(ctx.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    scene_params = {**traffic["scene"], **ctx.scene_overrides}
    scene = core.scene_generator(scene_params["generator"]).generate(
        scene_params, ctx.seed, ctx.settings["scene_salt"])
    rec.mark("scene")
    feed = traffic["feed"]
    read_pairs = feed["read_pairs"]

    def sniffer(control=None):
        return Sniffer(scfg, ndjson=NdjsonEmitter(core.NullSink()), quiet_text=True,
                       control=control, device=dev)

    def run_on(sn, pipe):
        """Sniffer.run over stdin_source, the pipe standing in for stdin."""
        saved = sys.stdin
        sys.stdin = _Stdin(pipe)
        try:
            return sn.run(stdin_source(s["format"]))
        finally:
            sys.stdin = saved

    # warm the block shape (and the last, zero-padded one) on a sniffer
    # of its own
    run_on(sniffer(), PacedPipe(scene.iq, read_pairs, feed["rate_msps"], 2))
    rec.mark("warm-up")
    tw = TraceWindow(ctx.trace, *traffic["trace_span_s"])
    taps = {"block": -1}
    n_reads = max(2, int(ctx.seconds * feed["rate_msps"] * 1e6 // read_pairs))
    src = PacedPipe(scene.iq, read_pairs, feed["rate_msps"], n_reads, tw=tw)
    stamps = BlockStamps(tw, taps, src)
    sn = sniffer(stamps)

    check = ctx.settings["check"]
    rng = np.random.default_rng([ctx.settings["scene_salt"], ctx.seed, 1])
    span = max(2 * check["blocks"] + 2, int(check["blocks_per_s"] * ctx.seconds))
    on_air = scene.packets_on(int(s["access_addr_hex"], 16))
    want = _pick_blocks(rng, on_air, scene.n_pairs, scfg.scan_len, span,
                        2 * check["blocks"])
    cands: dict = {}
    lattices: dict = {}
    orig_decode, orig_scan = decoder_mod.decode_block, pipeline_mod.scan_block

    def decode_block(*a, **k):
        out = orig_decode(*a, **k)
        if taps["block"] in want:
            cands.setdefault(taps["block"], []).append(out)
        return out

    def scan_block(*a, **k):
        out = orig_scan(*a, **k)
        if taps["block"] in want and taps["block"] not in lattices:
            lattices[taps["block"]] = out
        return out

    decoder_mod.decode_block, pipeline_mod.scan_block = decode_block, scan_block
    core.settle_heap()
    try:
        t0 = time.perf_counter()
        rec.setup_s = t0 - ctx.t_process0
        src.t0 = stamps.t_window0 = t0
        with core.GcWatch() as gcw:
            run_on(sn, src)
        t_end = time.perf_counter()
        tw.stop()
    finally:
        decoder_mod.decode_block, pipeline_mod.scan_block = orig_decode, orig_scan
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)

    # -- what the window did ------------------------------------------------
    halo = ref.halo(scfg.sps, 1)
    total = n_reads * read_pairs
    starts = [t for t, _ in stamps.calls]
    pulls = [p[0] for p in src.pulls]
    n_full = sum(1 for k in range(len(starts))
                 if k * scfg.scan_len + scfg.scan_len + halo <= total)
    busy_s, busy_n = 0.0, 0
    waits, works, done_at = [], [], []
    for k in range(n_full):
        nxt = starts[k + 1] if k + 1 < len(starts) else t_end
        j = int(np.searchsorted(pulls, starts[k], side="right"))
        done = min(nxt, pulls[j]) if j < len(pulls) else nxt
        last = k * scfg.scan_len + scfg.scan_len + halo - 1
        rec.latencies_s.append(done - src.due(last // read_pairs))
        done_at.append(done)
        waits.append(starts[k] - src.due(last // read_pairs))
        works.append(done - starts[k])
        # the interval to the next block, where no read waited in it
        waited = j < len(pulls) and pulls[j] < nxt and src.pulls[j][3]
        if k + 1 < len(starts) and not waited and not stamps.calls[k][1] \
                and not stamps.calls[k + 1][1]:
            busy_s += nxt - starts[k]
            busy_n += 1
    rec.spans = {"process": [busy_s, busy_n]}
    rec.notes += [gcw.note(),
                  core.slice_note("p95 ms", done_at, rec.latencies_s, src.t0,
                                  ctx.seconds, lambda v: core.p95(v) * 1e3),
                  core.spread_note("due to block start", waits),
                  core.spread_note("block start to done", works)]
    rec.window_s = n_reads * read_pairs / (feed["rate_msps"] * 1e6)
    rec.blocks = n_full
    rec.territory_samples = n_full * scfg.scan_len
    rec.trace = tw.reduce()
    if tw.started:
        rec.notes.append(f"traced span: the profiler's start held the host "
                         f"{tw.stall_s:.3f} s; span {tw.t_stop - tw.t_start:.3f} s, "
                         f"{tw.blocks} blocks")
    # the source's own lateness: hand-over past the later of due and asked
    late = np.array([p[2] - max(p[0], p[1]) for p in src.pulls])
    behind = sum(1 for p in src.pulls if p[0] > p[1])
    rec.notes.append(
        f"blocks {len(starts)} ({n_full} full); packets {len(sn.packets)} (CRC OK "
        f"{sum(e.crc_ok for e in sn.packets)}); reads {len(src.pulls)} ({behind} asked "
        f"after due), hand-over lateness mean {late.mean() * 1e3:.4f} ms max "
        f"{late.max() * 1e3:.4f} ms")

    # -- the comparison, after the window ---------------------------------
    events = sn.packets
    per_block = [events[stamps.n_events[k]: stamps.n_events[k + 1]
                        if k + 1 < len(stamps.n_events) else len(events)]
                 for k in range(len(starts))]
    rec.attempted, rec.failed = _scene_accounting(scene, on_air, events,
                                                  n_full * scfg.scan_len)
    host_c = {k: [{n: t.cpu().numpy() for n, t in c.items()} for c in v]
              for k, v in cands.items()}
    host_l = {k: tuple(t.cpu().numpy() for t in v) for k, v in lattices.items()}
    del cands, lattices, sn
    picked = [k for k in want if k in host_l and k < n_full][: check["blocks"]]
    rec.checks, lines = _compare(ctx, s, scfg, scene, picked, host_c, host_l,
                                 per_block, halo, n_full)
    rec.notes += lines
    rec.notes.insert(0, rec.phase_note(ctx.t_process0))
    return rec


def _pick_blocks(rng, packets, n_pairs: int, scan_len: int, span: int, n: int) -> list:
    """``n`` blocks in [1, span) drawn from the seed, those that hold a
    scene packet's access address first, so the comparison reads
    packets and not only noise."""
    full = set()
    for r in range(span * scan_len // n_pairs + 1):
        for p in packets:
            k = (r * n_pairs + p.aa_start) // scan_len
            if 1 <= k < span:
                full.add(k)
    rest = sorted(set(range(1, span)) - full)
    order = list(rng.permutation(sorted(full))) + list(rng.permutation(rest))
    return [int(k) for k in order[:n]]


def _block_iq(scene, k: int, scan_len: int, halo: int):
    idx = (k * scan_len + np.arange(scan_len + halo)) % scene.n_pairs
    return (scene.iq[2 * idx].astype(np.int16), scene.iq[2 * idx + 1].astype(np.int16))


def _event_key(e):
    h = e.header
    head = (int(h.pdu_type), int(h.tx_add), int(h.rx_add), int(h.payload_len)) \
        if e.is_adv else (int(h.llid), int(h.nesn), int(h.sn), int(h.md), int(h.payload_len))
    return (int(e.ts_us), int(e.channel), int(e.access_addr), bool(e.crc_ok),
            head, bytes(e.payload_bytes), e.rssi_dbm)


def _ref_key(r, channel, aa):
    b0, b1 = r.pdu[0], r.pdu[1]
    head = ((b0 & 0x0F, (b0 >> 6) & 1, (b0 >> 7) & 1, b1 & 0x3F) if ble.is_adv(channel)
            else (b0 & 3, (b0 >> 2) & 1, (b0 >> 3) & 1, (b0 >> 4) & 1, b1 & 0x1F))
    return (r.ts_us, channel, aa, r.crc_ok, head, r.pdu[2:], r.rssi_dbm)


def _compare(ctx, s, scfg, scene, picked, cands, lattices, per_block, halo, n_full):
    """The packets handed on in every full block of the window, and the
    lattices and decode_block outputs of the picked blocks, against the
    reference walking the same IQ from the stream's start."""
    limits = ctx.settings["limits"]
    aa = int(s["access_addr_hex"], 16)
    crc_init = ble.ADV_CRC_INIT_TABLE if s["crc_init_hex"].lower() == "555555" else None
    if crc_init is None:
        raise ValueError("the reference keys the advertising CRC init only")
    lat = cand = pkt = n_ref = 0
    fields = ("pos", "valid", "payload_len", "len_ok", "crc_ok", "mag_mean")
    picked_set = set(picked)
    walker = ref.NarrowbandWalker(s["channel"], aa, crc_init, scfg.sps, scfg.scan_len,
                                  16, scfg.rssi, scfg.samples_per_us)
    for k in range(n_full):
        ev, calls, bits, hit = walker.block(*_block_iq(scene, k, scfg.scan_len, halo),
                                            k * scfg.scan_len)
        a = {_event_key(e) for e in per_block[k]}
        r = {_ref_key(e, s["channel"], aa) for e in ev}
        pkt += len(a ^ r)
        n_ref += len(ev)
        if k not in picked_set:
            continue
        p_hit, p_bits = lattices[k]
        lat += int((p_bits[0].astype(bool) != bits).sum() + (p_hit[0] != hit).sum())
        got = cands.get(k, [])
        if len(got) != len(calls):
            cand += abs(len(got) - len(calls)) * 16
        for g, c in zip(got, calls):
            valid = c.valid
            if not np.array_equal(g["valid"][0], valid) or int(g["num_hits"][0]) != c.num_hits:
                cand += 16
                continue
            for f in fields:
                cand += int((np.asarray(g[f][0])[valid] != np.asarray(getattr(c, f))[valid]).sum())
            cand += int((g["pdu_bytes"][0][valid] != c.pdu_bytes[valid]).any(axis=1).sum())
    checks = {"pkt_diff": core.Check(pkt, limits["pkt_diff"]),
              "cand_diff": core.Check(cand, limits["cand_diff"]),
              "lattice_diff": core.Check(lat, limits["lattice_diff"])}
    if len(picked) < ctx.settings["check"]["blocks"]:
        checks["blocks_short"] = core.Check(ctx.settings["check"]["blocks"] - len(picked), 0)
    lines = [f"packets compared in {n_full} blocks: {n_ref} of the reference's, "
             f"{sum(len(per_block[k]) for k in range(n_full))} handed on; lattices and "
             f"candidates of {len(picked)} blocks "
             f"({sum(len(per_block[k]) for k in picked)} packets), the first "
             f"{sorted(picked)[:8]}"]
    return checks, lines


def _scene_accounting(scene, packets, events, end_pos: int):
    """(attempted, failed): the scene's ``packets`` on the sniffer's AA
    whose AA lies in the full blocks' territory, those not handed on
    exactly, and packets handed on where no scene packet was (a wrong
    packet where one was is its scene packet's failure, counted once)."""
    sps = scene.sps
    by_ts = sorted((e.ts_us, k) for k, e in enumerate(events))
    ts = [t for t, _ in by_ts]
    attempted = failed = 0
    near = set()
    for r in range(end_pos // scene.n_pairs + 1):
        for p in packets:
            pos = r * scene.n_pairs + p.aa_start
            if pos >= end_pos - MATCH_TOL_US * sps:
                break
            attempted += 1
            t = pos // sps
            exact = False
            j = bisect.bisect_left(ts, t - MATCH_TOL_US)
            while j < len(ts) and ts[j] <= t + MATCH_TOL_US:
                e = events[by_ts[j][1]]
                near.add(j)
                exact = exact or (e.crc_ok and e.channel == p.channel
                                  and bytes(e.payload_bytes) == p.pdu[2:])
                j += 1
            failed += not exact
    end_us = end_pos // sps - MATCH_TOL_US
    ghosts = sum(1 for j, t in enumerate(ts) if t < end_us and j not in near)
    return attempted, failed + ghosts
