"""The port's tracer (btle_tpu_torch.utils.profiling): spans, counters and
their totals; the sites in the wideband and narrowband block loops and
in the sharded stream's steps (two gloo ranks); the off path, which
reads no clock; the btle.* ranges under torch.profiler;
and the ring's count of refused pairs."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from btle_tpu_torch import runtime
from btle_tpu_torch.golden import model as G
from btle_tpu_torch.spec import bits as B
from btle_tpu_torch.utils import profiling as P
from btle_tpu_torch.wideband import WidebandConfig, WidebandSniffer, synthesize_wideband
from btle_tpu_torch.wideband.stream import WidebandStreamRunner


class _Clock:
    """perf_counter_ns as a counter: each read advances 10 ns."""

    def __init__(self):
        self.t = 0

    def __call__(self):
        self.t += 10
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(time, "perf_counter_ns", c)
    return c


def _no_clock():
    raise AssertionError("a clock was read with no tracer on")


# --------------------------------------------------------------------------
# the tracer
# --------------------------------------------------------------------------


def test_nesting_self_time_and_blocks(clock):
    tr = P.Tracer(64)
    with P.tracing(tr):
        with P.span("outer", block=3):
            with P.span("inner"):
                P.count("copies", 2)
            with P.span("inner"):
                pass
        with P.span("top"):
            pass
    outer = next(r for r in tr.spans() if r.name == "outer")
    inners = [r for r in tr.spans() if r.name == "inner"]
    top = next(r for r in tr.spans() if r.name == "top")
    assert outer.parent == -1 and outer.block == 3
    assert all(r.parent == outer.ident and r.block == 3 for r in inners)
    assert top.parent == -1 and top.block == -1
    tot = tr.totals()
    inner_ns = sum(r.end_ns - r.start_ns for r in inners)
    assert tot["spans"]["inner"] == {"total_ns": inner_ns, "self_ns": inner_ns, "count": 2}
    o = tot["spans"]["outer"]
    assert o["total_ns"] == outer.end_ns - outer.start_ns
    assert o["self_ns"] == o["total_ns"] - inner_ns and o["count"] == 1
    assert tot["counters"] == {"copies": 2}
    assert tot["blocks"] == 1 and tot["lost"] == 0
    (c,) = tr.counts()
    assert c.block == 3 and c.n == 2


def test_totals_until(clock):
    tr = P.Tracer(64)
    with P.tracing(tr):
        for k in range(4):
            with P.span("blk", block=k):
                P.count("n")
    ends = [r.end_ns for r in tr.spans()]
    cut = tr.totals(until_ns=ends[1])
    assert cut["spans"]["blk"]["count"] == 2 and cut["blocks"] == 2
    assert cut["counters"] == {"n": 2}
    # a parent still open at the cut leaves its finished children in
    with P.tracing(tr):
        with P.span("parent", block=9):
            with P.span("child"):
                pass
            mid = time.perf_counter_ns()
    cut = tr.totals(until_ns=mid)
    assert "parent" not in cut["spans"] and cut["spans"]["child"]["count"] == 1
    assert tr.totals()["spans"]["parent"]["self_ns"] < tr.totals()["spans"]["parent"]["total_ns"]


def test_full_buffer_counts_lost(clock):
    tr = P.Tracer(3)
    with P.tracing(tr):
        for _ in range(5):
            with P.span("s"):
                pass
        P.count("c", 4)
    assert len(tr) == 3 and tr.lost == 3
    tot = tr.totals()
    assert tot["spans"]["s"]["count"] == 3 and tot["lost"] == 3
    assert tot["counters"] == {"c": 4}          # running counters keep counting


def test_tracing_restores_and_idle_span_is_shared(monkeypatch):
    monkeypatch.setattr(time, "perf_counter_ns", _no_clock)
    assert P.active_tracer() is None
    assert P.span("a") is P.span("b", block=1)      # one object, nothing made
    with P.span("a"):
        P.count("x", 3)
    monkeypatch.undo()
    outer, inner = P.Tracer(8), P.Tracer(8)
    with P.tracing(outer):
        with P.tracing(inner):
            assert P.active_tracer() is inner
        assert P.active_tracer() is outer
    assert P.active_tracer() is None


def test_exception_closes_the_span(clock):
    tr = P.Tracer(8)
    with P.tracing(tr), pytest.raises(ValueError):
        with P.span("fails", block=2):
            raise ValueError
    with P.tracing(tr):
        with P.span("after"):
            pass
    after = next(r for r in tr.spans() if r.name == "after")
    assert after.parent == -1 and after.block == -1


# --------------------------------------------------------------------------
# the sites
# --------------------------------------------------------------------------

SCAN_LEN = 2048


def _burst(rng, ch, n_payload=6):
    hdr = 0x40 if ch in (37, 38, 39) else 0x01
    payload = rng.integers(0, 256, n_payload, dtype=np.uint8)
    pdu = B.bytes_to_bits(np.concatenate([[hdr, n_payload], payload]).astype(np.uint8))
    return G.gfsk_modulate_float(G.assemble_phy_bits(pdu, ch), 80)


@pytest.fixture(scope="module")
def dense_scene():
    """Eight advertising bursts on each of channels 37, 38 and 39 in 3
    blocks: more AA hits a block than two candidate slots on all three, so
    the walk rescans them together."""
    rng = np.random.default_rng(5)
    gap = np.zeros(2500, np.float32)
    signals = {}
    for ch in (37, 38, 39):
        parts_i, parts_q = [], []
        for _ in range(8):
            bi, bq = _burst(rng, ch)
            parts_i += [bi, gap]
            parts_q += [bq, gap]
        signals[ch] = (np.concatenate(parts_i), np.concatenate(parts_q))
    return synthesize_wideband(signals, 3 * SCAN_LEN * 20, {37: 2000, 38: 2400, 39: 2800})


def _wideband_runner():
    sn = WidebandSniffer(WidebandConfig(max_candidates=2, scan_len_ch=SCAN_LEN,
                                        fused=True, fused_dtype="f32"), device="cpu")
    return WidebandStreamRunner(sn)


def test_wideband_spans_and_rescans(dense_scene):
    wi, wq = dense_scene
    runner = _wideband_runner()
    tr = P.Tracer(4096)
    with P.tracing(tr):
        pkts = runner.run_capture(wi, wq)
    sn = runner.sn
    n = sn.blocks_dispatched
    assert n >= 3 and sum(p.crc_ok for p in pkts) >= 6
    tot = tr.totals()
    assert tot["lost"] == 0 and tot["blocks"] == n
    spans = tot["spans"]
    for name in ("scan_async", "scan_async.stage", "scan_async.launch", "consume_scan",
                 "consume_scan.wait", "consume.emit"):
        assert spans[name]["count"] == n, name
    assert sn.truncated_channels > 0
    assert tot["counters"]["rescan_channels"] == sn.truncated_channels
    assert runner.stats.truncate_rescans == sn.truncated_channels
    # each block's spans carry its dispatch number; children nest in parents
    recs = tr.spans()
    by_id = {r.ident: r for r in recs}
    for r in recs:
        if r.name.startswith("scan_async."):
            assert by_id[r.parent].name == "scan_async"
        if r.name.startswith("consume_scan."):
            assert by_id[r.parent].name == "consume_scan"
    assert sorted(r.block for r in recs if r.name == "consume_scan") == list(range(n))
    assert sorted(r.block for r in recs if r.name == "consume.emit") == list(range(n))
    # a rescan span is one device round trip: a block's first round serves
    # every channel that overflowed, a fallback round those whose slots
    # filled again; each round counts the channels it serves
    rounds = [c for c in tr.counts() if c.name == "rescan_channels"]
    rescanned = {c.block for c in rounds}
    fallbacks = len(rounds) - len(rescanned)
    assert [c.n for c in rounds if c.block == min(rescanned)][0] == 3
    assert spans["consume_scan.rescan"]["count"] == len(rescanned) + fallbacks
    assert spans["consume_scan.rescan"]["count"] < sn.truncated_channels
    assert {r.block for r in recs if r.name == "consume_scan.rescan"} == rescanned
    # uploads: the two IQ arrays a block; a block's rescans add the plain
    # channelizer's four tables once
    assert tot["counters"]["h2d_copies"] == 2 * n + 4 * len(rescanned)
    assert spans["consume_scan"]["self_ns"] < spans["consume_scan"]["total_ns"]


def _nb_capture(tmp_path):
    """Three advertising packets at 4 Msps with noise between them, as an
    i16 file of several 2048-sample blocks."""
    rng = np.random.default_rng(1)
    segs = []
    for n in (8, 20, 12):
        payload = rng.integers(0, 256, n, dtype=np.uint8)
        pdu = B.bytes_to_bits(np.concatenate([[0, n], payload]).astype(np.uint8))
        ci, cq, _ = G.btle_tx(pdu, 37, sps=4, flavor="c")
        segs.append(np.stack([ci, cq]).astype(np.int16))
        segs.append(rng.integers(-2, 3, (2, 3000)).astype(np.int16))
    s = np.concatenate(segs, axis=1)
    inter = np.empty(2 * s.shape[1], np.int16)
    inter[0::2], inter[1::2] = s[0], s[1]
    path = tmp_path / "nb.i16"
    inter.tofile(path)
    return path


def _sniffer(path):
    from btle_tpu_torch.stream import Sniffer, SnifferConfig
    from btle_tpu_torch.stream.sources import iq_file_source

    sn = Sniffer(SnifferConfig(channel=37, sps=4, scan_len=2048, rssi=True),
                 quiet_text=True, device="cpu")
    return sn, iq_file_source(str(path), "i16")


def test_narrowband_spans_and_uploads(tmp_path):
    from btle_tpu_torch.rx import decoder

    path = _nb_capture(tmp_path)
    decoder._scan_tables.cache_clear()
    sn, src = _sniffer(path)
    tr = P.Tracer(4096)
    with P.tracing(tr):
        events = sn.run(src)
    assert sum(e.crc_ok for e in events) == 3
    n = sn.blocks
    tot = tr.totals()
    assert n >= 4 and tot["blocks"] == n and tot["lost"] == 0
    spans = tot["spans"]
    for name in ("sniffer.block", "stream_decode.stage", "sniffer.handle"):
        assert spans[name]["count"] == n, name
    assert spans["stream_decode.launch"]["count"] == spans["stream_decode.wait"]["count"] >= n
    # two IQ uploads a block; the five tables once, on the first block
    per_block = {}
    for c in tr.counts():
        assert c.name == "h2d_copies"
        per_block[c.block] = per_block.get(c.block, 0) + c.n
    assert per_block == {0: 7, **{k: 2 for k in range(1, n)}}
    by_id = {r.ident: r for r in tr.spans()}
    for r in tr.spans():
        if r.name != "sniffer.block":
            assert by_id[r.parent].name == "sniffer.block" and r.block == by_id[r.parent].block


def test_off_path_reads_no_clock(monkeypatch, tmp_path, dense_scene):
    """With no tracer on, a wideband block and a narrowband file decode
    read no perf_counter_ns."""
    path = _nb_capture(tmp_path)
    wi, wq = dense_scene
    sn = _wideband_runner().sn
    nb, src = _sniffer(path)
    blk = sn.wb_block_len
    monkeypatch.setattr(time, "perf_counter_ns", _no_clock)
    assert P.active_tracer() is None
    sn.process(wi[:blk], wq[:blk])
    assert sn.truncated_channels > 0
    assert sum(e.crc_ok for e in nb.run(src)) == 3


SHARD_SPANS = ("shard.ingest", "shard.exchange", "shard.scan", "shard.gather", "shard.walk")


@pytest.fixture(scope="module")
def shard_ranks(dense_scene, tmp_path_factory):
    """Two gloo ranks of the per-process sharded stream (mesh (1, 2), a
    block a rank) over the dense scene for two steps, each under a
    tracer: their spans and counters."""
    import pickle

    from btle_tpu_torch.dist import dryrun

    import test_torch_dist_ranks as ranks_mod

    wi, wq = (np.pad(v, (0, 2 * SCAN_LEN * 20)) for v in dense_scene)
    path = tmp_path_factory.mktemp("shard") / "stream.pkl"
    with open(path, "wb") as fh:
        pickle.dump((wi, wq), fh)
    kw = {"block_wb": SCAN_LEN * 20, "fused": True, "fused_dtype": "f32",
          "max_candidates": 2}
    return dryrun.spawn(2, ranks_mod.stream_steps, str(path), 2, kw, True,
                        backend="gloo", device_type="cpu", timeout=300)


def test_shard_spans_nest_and_carry_their_step(shard_ranks):
    """Each step's five top-level shard spans carry the step; a rescan
    round nests in the walk of its step; the counters count the rescans
    (``rescan_cells`` equals ``truncated_cells``), the exchange's bytes
    sent, the gathers' bytes received and the uploads."""
    block_wb, ctx = SCAN_LEN * 20, 1279
    halo = min(block_wb, (32 + 336) * 4 * 20 + 4 * 20 + 1280)
    for rank, res in enumerate(shard_ranks):
        spans, c = res["spans"], res["counters"]
        for name in SHARD_SPANS:
            assert sorted(b for n, b, parent in spans if n == name and parent is None) \
                == [0, 1], (rank, name)
        rescans = [(b, parent) for n, b, parent in spans if n == "shard.rescan"]
        assert rescans and all(parent == "shard.walk" for _, parent in rescans)
        assert {b for b, _ in rescans} <= {0, 1}
        assert c["rescan_cells"] == res["truncated"] > 0
        # rank 0 sends its tail to its right neighbour; rank 1, the last
        # shard, its head to the left and its tail round to rank 0
        sent = 2 * 4 * (ctx if rank == 0 else halo + ctx)
        assert c["halo_bytes"] == 2 * sent
        assert c["gather_bytes"] > 0
        # the two IQ uploads a step; a step whose rescans this rank
        # serves adds the plain channelizer's four tables
        extra = c["h2d_copies"] - 2 * 2
        assert extra >= 0 and extra % 4 == 0
    assert shard_ranks[0]["packets"] == shard_ranks[1]["packets"]


def test_shard_off_path_records_nothing(monkeypatch, dense_scene):
    """With no tracer on, steps of the stream at world size 1 (mesh (1,
    1), gloo in this process) that rescan read no perf_counter_ns."""
    import torch.distributed as dist

    from btle_tpu_torch.dist import ShardedWidebandScan, make_mesh
    from btle_tpu_torch.dist.dryrun import free_port

    wi, wq = (torch.as_tensor(v, dtype=torch.float32) for v in dense_scene)
    block_wb = SCAN_LEN * 20
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        scan = ShardedWidebandScan(make_mesh(1, 1, "cpu"), block_wb=block_wb, fused=True,
                                   fused_dtype="f32", max_candidates=2)
        monkeypatch.setattr(time, "perf_counter_ns", _no_clock)
        assert P.active_tracer() is None
        for k in range(2):
            s = slice(k * block_wb, (k + 1) * block_wb)
            scan.gather_packets(scan.run_placed(wi[s], wq[s]))
        monkeypatch.undo()
        assert scan.truncated_cells > 0
    finally:
        dist.destroy_process_group()


def test_profiler_ranges_enclose_the_ops(tmp_path):
    """Under a CPU torch.profiler with a tracer on, each span is a
    btle.<name> range, and the aten ops a phase launched lie inside its
    range."""
    from torch.profiler import ProfilerActivity, profile

    path = _nb_capture(tmp_path)
    sn, src = _sniffer(path)
    tr = P.Tracer(4096)
    with profile(activities=[ProfilerActivity.CPU]) as prof, P.tracing(tr):
        sn.run(src)
    events = list(prof.events())
    ranges = {}
    for e in events:
        if e.name.startswith("btle."):
            ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    for name in ("sniffer.block", "stream_decode.stage", "stream_decode.launch",
                 "stream_decode.wait", "sniffer.handle"):
        assert len(ranges["btle." + name]) == tr.totals()["spans"][name]["count"], name
    topk = [e for e in events if e.name == "aten::topk"]
    assert topk
    launch = ranges["btle.stream_decode.launch"]
    for e in topk:
        assert any(s <= e.time_range.start and e.time_range.end <= f for s, f in launch)


def test_device_trace_turns_a_tracer_on(tmp_path, dense_scene):
    wi, wq = dense_scene
    sn = _wideband_runner().sn
    blk = sn.wb_block_len
    with P.device_trace(str(tmp_path)) as prof:
        assert P.active_tracer() is prof.tracer
        sn.process(wi[:blk], wq[:blk])
    assert P.active_tracer() is None
    # a tracer already on (even one with no record yet) is the one used
    outer = P.Tracer(16)
    with P.tracing(outer), P.device_trace(str(tmp_path / "again")) as again:
        assert again.tracer is outer
    assert prof.tracer.totals()["spans"]["scan_async"]["count"] == 1
    names = {e.get("name") for e in json.loads(open(prof.trace_path).read())["traceEvents"]}
    assert {"btle.scan_async", "btle.scan_async.stage", "btle.consume_scan.wait",
            "btle.consume_scan.rescan"} <= names


# --------------------------------------------------------------------------
# the ring's refused pairs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fmt,dtype", [("i8", np.int8), ("i16", np.int16),
                                       ("f32", np.float32)])
def test_ring_counts_every_refused_pair(fmt, dtype):
    """A write of more than 4096 pairs into a nearly full ring counts every
    pair it refused, not only the first short chunk's."""
    if not runtime.available():
        pytest.skip("the native runtime did not build (no g++)")
    ring = runtime.IqRingBuffer(1 << 14)
    try:
        assert ring.write(np.zeros(2 * ((1 << 14) - 1000), dtype), fmt) == (1 << 14) - 1000
        n = 10_000
        written = ring.write(np.ones(2 * n, dtype), fmt)
        assert written == 1000
        assert ring.dropped == n - written
        ring.read_block(4096, 0)
        assert ring.write(np.ones(2 * 5000, dtype), fmt) == 4096
        assert ring.dropped == (n - written) + (5000 - 4096)
    finally:
        ring.close()
