"""The port's WidebandSniffer as a whole (plain PyTorch twins of the
CUDA kernels, on the CPU) against the JAX package's sniffer: packet
lists across streamed blocks, the known-answer self-test, a mid-stream
handover of state from a JAX sniffer to the port, and the rule that an
entry point without an explicit device never falls back to the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from btle_tpu.golden import model as G
from btle_tpu.spec import bits as B
from btle_tpu.wideband import WidebandConfig as JConfig
from btle_tpu.wideband import WidebandSniffer as JSniffer
from btle_tpu.wideband import synthesize_wideband

from btle_tpu_torch.wideband import WidebandConfig, WidebandSniffer, fused_selftest

torch.set_num_threads(2)


def _burst(rng, ch, n_payload=12):
    hdr = 0x40 if ch in (37, 38, 39) else 0x01
    payload = rng.integers(0, 256, n_payload, dtype=np.uint8)
    pdu = B.bytes_to_bits(
        np.concatenate([[hdr, n_payload], payload]).astype(np.uint8))
    return G.gfsk_modulate_float(G.assemble_phy_bits(pdu, ch), 80)


def _capture(rng, placements, n):
    """placements: [(channel, wideband offset)]; bursts on one channel may
    repeat (composed one at a time)."""
    wi = np.zeros(n, np.float32)
    wq = np.zeros(n, np.float32)
    for k, (ch, off) in enumerate(placements):
        bi, bq = synthesize_wideband({ch: _burst(rng, ch, 10 + k % 8)}, n,
                                     {ch: off})
        wi += bi
        wq += bq
    wi += rng.normal(0, 0.01, n).astype(np.float32)
    wq += rng.normal(0, 0.01, n).astype(np.float32)
    return wi, wq


def _streaming_scene():
    """The scene of test_wideband_fused.py::test_sniffer_fused_streaming_parity."""
    rng = np.random.default_rng(0)
    signals, offsets = {}, {}
    for k, ch in enumerate((37, 5, 21, 38)):
        signals[ch] = _burst(rng, ch, n_payload=10 + k)
        offsets[ch] = 50000 + 140000 * k
    wi, wq = synthesize_wideband(signals, 700000, offsets)
    wi += rng.normal(0, 0.01, wi.shape).astype(np.float32)
    wq += rng.normal(0, 0.01, wq.shape).astype(np.float32)
    return wi, wq


def _tuples(pkts):
    return [(p.channel, p.sample_pos, p.payload_len, p.crc_ok,
             p.pdu_bytes.tobytes()) for p in pkts]


@pytest.fixture(scope="module")
def streaming_reference():
    wi, wq = _streaming_scene()
    ref = _tuples(JSniffer(JConfig(scan_len_ch=8192)).run(wi, wq))
    assert len([p for p in ref if p[3]]) >= 4
    return wi, wq, ref


@pytest.mark.parametrize("fused,dtype", [(True, "f32"), (False, "f32"),
                                         (True, "bf16x2w")])
def test_sniffer_packet_list_matches_jax(streaming_reference, fused, dtype):
    wi, wq, ref = streaming_reference
    sn = WidebandSniffer(WidebandConfig(scan_len_ch=8192, fused=fused,
                                        fused_dtype=dtype), device="cpu")
    got = _tuples(sn.run(wi, wq))
    if dtype == "f32":
        assert got == ref
    else:
        assert [p for p in got if p[3]] == [p for p in ref if p[3]]


def test_parsed_packets():
    wi, wq = _streaming_scene()
    pkts = WidebandSniffer(WidebandConfig(scan_len_ch=8192, fused=True),
                           device="cpu").run(wi, wq)
    adv = [p for p in pkts if p.crc_ok and p.channel in (37, 38)]
    assert adv and all(p.header is not None and p.payload is not None
                       for p in adv)
    assert all(p.access_addr == 0x8E89BED6 for p in pkts)


STEP = 8192 * 20
HANDOVER_PLAN = ([(37, 30_000), (4, 90_000), (38, STEP + 40_000),
                  (12, 2 * STEP - 6_000)]        # across the block-1/2 boundary
                 + [(9, 2 * STEP + 10_000 + 30_000 * k) for k in range(4)]
                 + [(39, 3 * STEP + 20_000), (30, 3 * STEP + 70_000)])


def _blocks(wi, wq, n_blocks, total):
    for b in range(n_blocks):
        seg = slice(b * STEP, b * STEP + total)
        bi = np.zeros(total, np.float32)
        bq = np.zeros(total, np.float32)
        bi[: len(wi[seg])] = wi[seg]
        bq[: len(wq[seg])] = wq[seg]
        yield bi, bq


def test_midstream_handover_from_jax():
    """JAX scans blocks 0-1, its state moves into the port, the port scans
    blocks 2-3: the packet list equals JAX scanning all four. Two
    candidate slots per channel make block 2's four packets on channel 9
    overflow into the rescan path on both sides."""
    cfg = dict(scan_len_ch=8192, max_candidates=2)
    jsn = JSniffer(JConfig(**cfg))
    total = jsn.wb_block_len
    wi, wq = _capture(np.random.default_rng(11), HANDOVER_PLAN, 3 * STEP + total)
    ref = _tuples(JSniffer(JConfig(**cfg)).run(wi, wq))
    assert len([p for p in ref if p[3]]) == len(HANDOVER_PLAN)

    blocks = list(_blocks(wi, wq, 4, total))
    got = []
    for bi, bq in blocks[:2]:
        got += _tuples(jsn.process(bi, bq))
    port = WidebandSniffer(WidebandConfig(fused=True, fused_dtype="f32", **cfg),
                           device="cpu")
    port.load_state(np.asarray(jsn._cursors), jsn._offset_ch, jsn._ctx_i,
                    jsn._ctx_q, np.asarray(jsn.aa_rows),
                    np.asarray(jsn.crc_inits), jsn.truncated_channels)
    for bi, bq in blocks[2:]:
        got += _tuples(port.process(bi, bq))
    assert got == ref
    assert port.truncated_channels >= 1


# short advertising bursts on 37, 38 and 39 (wideband offsets): at two
# slots a channel all three overflow in block 0, 37 and 38 past one rescan;
# 39's last three bursts lie in block 0's halo, so its last rescan finds
# only hits that block 1 owns and stops there
OVERFLOW_TRAINS = {37: range(30_000, 100_000, 14_000),
                   38: range(60_000, 115_000, 14_000),
                   39: [*range(20_000, 110_000, 15_000), 164_240, 175_040, 185_840]}


@pytest.fixture(scope="module")
def overflow_scene():
    """test_wideband_stream's follow scene (ADV on 37 and 38, a CONNECT_REQ
    on 37, a data packet on the connection's channel 9 in block 1) with
    OVERFLOW_TRAINS added: 37's CONNECT_REQ is found by a later rescan."""
    from test_wideband_stream import _scene

    rng = np.random.default_rng(7)
    n = 2 * STEP
    wi, wq = _scene(rng, n)
    for ch, offsets in OVERFLOW_TRAINS.items():
        for off in offsets:
            bi, bq = synthesize_wideband({ch: _burst(rng, ch, 6)}, n, {ch: off})
            wi += bi
            wq += bq
    return wi, wq


@pytest.mark.parametrize("follow,fused", [
    (dict(), False),
    (dict(follow_connections=True), False),
    (dict(follow_connections=True, max_follow=2), False),
    (dict(follow_connections=True), True)],
    ids=["plain", "plain-follow", "plain-multifollow", "f32-follow"])
def test_overflow_rescans_match_jax(overflow_scene, follow, fused):
    """Channels 37, 38 and 39 overflowing in one block: the rescans of a
    block batched into rounds give the JAX sniffer's packets, in its order
    (with the access address and, on the plain path, the RSSI statistic),
    its rescan count and its cursors, with and without following."""
    from btle_tpu_torch.utils import profiling as P

    wi, wq = overflow_scene
    cfg = dict(scan_len_ch=8192, max_candidates=2, **follow)
    jsn = JSniffer(JConfig(**cfg))
    ref = jsn.run(wi, wq)
    port = WidebandSniffer(WidebandConfig(fused=fused, fused_dtype="f32", **cfg),
                           device="cpu")
    tr = P.Tracer(4096)
    with P.tracing(tr):
        got = port.run(wi, wq)
    assert _tuples(got) == _tuples(ref)
    assert [p.access_addr for p in got] == [p.access_addr for p in ref]
    if not fused:
        assert [p.rssi_mag for p in got] == [p.rssi_mag for p in ref]
    assert port.truncated_channels == jsn.truncated_channels
    assert np.array_equal(port._cursors, np.asarray(jsn._cursors))
    assert port._offset_ch == jsn._offset_ch
    # block 0's first round serves all three channels; later rounds follow
    rounds = [c.n for c in tr.counts() if c.name == "rescan_channels" and c.block == 0]
    assert rounds[0] == 3 and len(rounds) >= 3 and rounds == sorted(rounds, reverse=True)
    assert tr.counters["rescan_channels"] == port.truncated_channels
    assert (tr.totals()["spans"]["consume_scan.rescan"]["count"]
            == len([c for c in tr.counts() if c.name == "rescan_channels"]))
    data = [p for p in got if p.channel == 9 and p.crc_ok]
    assert len(data) == (1 if follow else 0)
    assert sum(p.crc_ok for p in got if p.channel in (37, 38, 39)) >= 10


def test_decode_block_rows_with_min_pos_vector(overflow_scene):
    """One decode_block over several channel rows with a (C,) min_pos
    equals one call a row with its scalar min_pos, key by key."""
    from btle_tpu_torch.rx.pipeline import decode_block
    from btle_tpu_torch.wideband import channelize
    from btle_tpu_torch.wideband.sniffer import default_scan_tables

    wi, wq = overflow_scene
    sn = WidebandSniffer(WidebandConfig(scan_len_ch=8192), device="cpu")
    n = sn.wb_block_len + sn._ctx_len
    y_i, y_q = channelize(np.concatenate([np.zeros(sn._ctx_len, np.float32), wi])[:n],
                          np.concatenate([np.zeros(sn._ctx_len, np.float32), wq])[:n],
                          has_context=True, device="cpu")
    aa, mask, whiten, crc, adv = default_scan_tables("cpu")
    rows, starts = [19, 20, 32, 9], [0, 1700, 1000, 0]
    kw = dict(sps=4, lag=4, max_candidates=2)
    idx = torch.tensor(rows)
    many = decode_block(y_i[idx], y_q[idx], aa.expand(len(rows), 32), mask,
                        whiten[idx], crc[idx], adv[idx],
                        min_pos=torch.tensor(starts, dtype=torch.int32), **kw)
    assert int(many["num_hits"][0]) > 2 and int(many["num_hits"][1]) > 2
    for j, (m, p) in enumerate(zip(rows, starts)):
        one = decode_block(y_i[m: m + 1], y_q[m: m + 1], aa[None], mask,
                           whiten[m: m + 1], crc[m: m + 1], adv[m: m + 1],
                           min_pos=p, **kw)
        assert set(one) == set(many)
        for k in one:
            assert torch.equal(many[k][j], one[k][0]), (m, k)


def test_integer_wire_format_blocks():
    """int16 wire samples go to the device as integers (the cast to float
    runs there) and decode as the JAX sniffer decodes the same blocks."""
    wi, wq = _streaming_scene()
    wi, wq = np.round(wi).astype(np.int16), np.round(wq).astype(np.int16)
    jsn = JSniffer(JConfig(scan_len_ch=8192))
    port = WidebandSniffer(WidebandConfig(scan_len_ch=8192, fused=True,
                                          fused_dtype="f32"), device="cpu")
    total = jsn.wb_block_len
    ref, got = [], []
    for b in range(4):
        bi = np.zeros(total, np.int16)
        bq = np.zeros(total, np.int16)
        seg = slice(b * STEP, b * STEP + total)
        bi[: len(wi[seg])], bq[: len(wq[seg])] = wi[seg], wq[seg]
        ref += _tuples(jsn.process(bi, bq))
        got += _tuples(port.process(bi, bq))
    assert port._ctx_i.dtype == np.int16
    assert got == ref and len([p for p in got if p[3]]) >= 4


@pytest.mark.parametrize("kw", [dict(compute_dtype="bf16x2w"),
                                dict(compute_dtype="f32"),
                                dict(compute_dtype="f32", phy="2m"),
                                dict(compute_dtype="f32", decode="xla"),
                                dict(pipeline="xla")])
def test_selftest_passes_on_cpu(kw):
    from btle_tpu.wideband.selftest import fused_selftest as jselftest

    got = fused_selftest(device="cpu", **kw)
    want = jselftest(pipeline="xla", phy=kw.get("phy", "1m"))
    assert got == want


def test_sniffer_selftest_and_control_registers():
    sn = WidebandSniffer(WidebandConfig(fused=True), device="cpu")
    assert set(sn.selftest()) == {37, 17, 39}
    jsn = JSniffer(JConfig())
    writes = [(10, 0x50655535), (12, 0x123456)]
    sn.apply_control_registers(writes)
    jsn.apply_control_registers(writes)
    aa_rows, _, _, crc_inits, _ = sn.keys.tables
    assert np.array_equal(aa_rows.numpy(), np.asarray(jsn.aa_rows))
    assert np.array_equal(crc_inits.numpy(), np.asarray(jsn.crc_inits))
    # connection following is ported: one hop tracker, or a multi-follower
    assert WidebandSniffer(WidebandConfig(follow_connections=True),
                           device="cpu").hop_tracker is not None
    assert WidebandSniffer(WidebandConfig(follow_connections=True, max_follow=3),
                           device="cpu").multi_follower.max_connections == 3


def test_entry_points_without_device_refuse_cpu(monkeypatch):
    from btle_tpu_torch.wideband import channelize, wideband_scan_fused
    from btle_tpu_torch.wideband.sniffer import default_scan_tables

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros(30000, np.float32)
    tables = default_scan_tables(device="cpu")
    for call in (lambda: WidebandSniffer(WidebandConfig()),
                 lambda: fused_selftest(),
                 lambda: default_scan_tables(),
                 lambda: channelize(x, x),
                 lambda: wideband_scan_fused(x, x, *tables)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
