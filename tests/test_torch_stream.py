"""The port's streaming runtime on the CPU against the JAX package: block
iteration, sample sources, NDJSON, pcap, the control transports, the hop
tracker, the narrowband Sniffer end to end (packet events, NDJSON lines,
pcap bytes and text lines, with the clock patched in both), a mid-stream
handover of a JAX Sniffer's state to the port, and the ``decode`` CLI.
Every comparison is exact."""

import dataclasses
import io
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import btle_tpu.stream as J
from btle_tpu.cli.app import main as jax_cli_main
from btle_tpu.golden import model as G
from btle_tpu.ll import hop as jhop
from btle_tpu.spec import bits as B
from btle_tpu.stream import control as jcontrol
from btle_tpu.stream import hci as jhci
from btle_tpu.stream import sources as jsources

import btle_tpu_torch.stream as T
from btle_tpu_torch import convert
from btle_tpu_torch.ll import hop as thop
from btle_tpu_torch.stream import control as tcontrol
from btle_tpu_torch.stream import hci as thci
from btle_tpu_torch.stream import sources as tsources

from test_hop import CONN_AA, CONN_AA_HEX, CRC_INIT_HEX, connect_req_pdu, data_pdu, place

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent


# --------------------------------------------------------------------------
# pure modules
# --------------------------------------------------------------------------


def test_blocks_match():
    rng = np.random.default_rng(1)
    i = rng.integers(-100, 100, 23000).astype(np.int16)
    q = rng.integers(-100, 100, 23000).astype(np.int16)
    its = [pkg.OverlapBlockIterator(pkg.array_source(i, q, 3000), sps=4, lag=1,
                                    scan_len=4096) for pkg in (J, T)]
    blocks = [[], []]
    for k, it in enumerate(its):
        for b in it:
            blocks[k].append((b.i.tobytes(), b.q.tobytes(), b.offset,
                              b.scan_len, b.skip))
            it.consume_to(b.offset + b.scan_len + 50 * (b.offset // 4096))
    assert blocks[0] == blocks[1] and len(blocks[0]) == 6


@pytest.mark.parametrize("fmt", ["i8", "i16", "f32", "csv"])
def test_sources_match(tmp_path, fmt):
    rng = np.random.default_rng(2)
    n = 5001
    path = tmp_path / f"cap.{fmt}"
    if fmt == "csv":
        rows = ["h1", "h2"] + [
            ",".join(str(v) for v in rng.integers(-300, 300, 12))
            for _ in range(n)]
        path.write_text("\n".join(rows) + "\n")
        ref = list(jsources.ila_csv_source(str(path), chunk_pairs=700))
        got = list(tsources.ila_csv_source(str(path), chunk_pairs=700))
    else:
        dt = {"i8": np.int8, "i16": np.int16, "f32": np.float32}[fmt]
        raw = (rng.normal(0, 0.3, 2 * n) if fmt == "f32"
               else rng.integers(-100, 100, 2 * n)).astype(dt)
        raw.tofile(path)
        ref = list(jsources.iq_file_source(str(path), fmt, chunk_pairs=900))
        got = list(tsources.iq_file_source(str(path), fmt, chunk_pairs=900))
        a = jsources.load_iq_capped(str(path), fmt, max_samples=3000)
        b = tsources.load_iq_capped(str(path), fmt, max_samples=3000)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert len(ref) == len(got) > 1
    for (ri, rq), (gi, gq) in zip(ref, got):
        assert ri.dtype == gi.dtype == np.int16
        assert np.array_equal(ri, gi) and np.array_equal(rq, gq)
    i, q = rng.integers(-9, 9, (2, 1000)).astype(np.int16)
    for (ri, rq), (gi, gq) in zip(jsources.array_source(i, q, 300),
                                  tsources.array_source(i, q, 300)):
        assert np.array_equal(ri, gi) and np.array_equal(rq, gq)


def test_ndjson_and_pcap_bytes_match():
    outs = []
    for pkg in (J, T):
        buf, pc = io.StringIO(), io.BytesIO()
        em = pkg.NdjsonEmitter(buf)
        em.pkt_adv(1715680000.1, 42, 37, 0x8E89BED6, True, 0, "ADV_IND", 1, 0,
                   31, bytes.fromhex("aabbccddeeff"), b"\x02\x01\x1a", -58)
        em.pkt_data(2.5, 43, 9, CONN_AA, False, 2, "LL_DATA", 1, 0, 1, 3,
                    b"\x01\x02\x03", None, plain_hex="0102")
        em.hop(3.0, "track_start", 0, 1, 9, 2422, CONN_AA, 0xA77B22, 20000, 9,
               bytes.fromhex("1fffffffff"))
        em.status(4.0, "start", "file", 37, 2_402_000_000, msg="x")
        w = pkg.PcapWriter(pc)
        w.write_packet(b"\x42\x06" + bytes(6), 37, 0x8E89BED6, rssi_dbm=-60,
                       ts=123.5)
        w.write_packet(b"\x01\x00", 9, CONN_AA, ts=124.25)
        outs.append((buf.getvalue(), pc.getvalue()))
    assert outs[0] == outs[1]


def test_read_pcap_matches(tmp_path):
    path = tmp_path / "x.pcap"
    with T.PcapWriter(path) as w:
        w.write_packet(b"\x42\x06" + bytes(6), 37, 0x8E89BED6, rssi_dbm=-60, ts=9.5)
        w.write_packet(b"\x01\x00", 9, CONN_AA, ts=10.0)
    ref, got = J.read_pcap(path), T.read_pcap(path)
    assert [dataclasses.astuple(r) for r in ref] == \
        [dataclasses.astuple(g) for g in got]
    assert got[0].rssi_dbm == -60 and got[1].rssi_dbm == -127


def test_control_codecs_and_server_match(tmp_path):
    writes = [(10, CONN_AA), (11, 9), (12, 0xA77B22), (77, 5)]
    payload = jcontrol.encode_reg_writes(writes)
    assert payload == tcontrol.encode_reg_writes(writes)
    assert jcontrol.decode_reg_writes(payload + b"xx") == \
        tcontrol.decode_reg_writes(payload + b"xx") == writes
    regs = tmp_path / "regs.txt"
    regs.write_text("# comment\n10 0x60850A1B\n11 9  # channel\n\n12 0xa77b22\n")
    assert jcontrol.parse_register_file(regs) == tcontrol.parse_register_file(regs)
    server = tcontrol.ControlServer(0)
    try:
        assert tcontrol.send_command(server.port, channel=9, regs=[(77, 5)]) == 2
        deadline = time.time() + 5
        got = []
        while not got and time.time() < deadline:
            got = server.poll()
        assert got == [(77, 5), (11, 9)] and server.registers[77] == 5
    finally:
        server.close()


def test_hci_codecs_match():
    rng = np.random.default_rng(3)
    data = bytes(rng.integers(0, 256, 40, dtype=np.uint8))
    for parity in ("none", "even", "odd"):
        a, b = jhci.UartFramer(parity), thci.UartFramer(parity)
        assert np.array_equal(a.encode(data), b.encode(data))
        levels = a.encode(data)
        levels[25] ^= 1
        assert a.decode(levels) == b.decode(levels)
    frame = jhci.HciFrameCodec.encode(jcontrol.encode_reg_writes([(11, 9)]))
    assert frame == thci.HciFrameCodec.encode(tcontrol.encode_reg_writes([(11, 9)]))
    stream = b"\x00\xb7" + frame + frame[:-1] + b"\x00" + frame
    ja, tb = jhci.HciFrameCodec(), thci.HciFrameCodec()
    assert ja.feed(stream) == tb.feed(stream)
    assert ja.frame_errors == tb.frame_errors > 0
    assert jhci.crc8(data) == thci.crc8(data)


def _drive_tracker(mod):
    t = mod.HopTracker()
    conn = mod.ConnectionInfo(CONN_AA, 0xA77B22, 9, 16, bytes.fromhex("1fffffffff"))
    t.on_connect_req(conn, 1000)
    for now in (2000, 9000):
        t.on_tick(now)
    t.on_crc_ok_packet(9000)
    t.on_ll_ctrl(0x01, {"chm": bytes.fromhex("fffffbff1f")[::-1], "instant": 2},
                 9100)
    t.on_ll_ctrl(0x00, {"interval": 24, "instant": 3}, 9200)
    for now in range(10_000, 120_000, 2048):
        t.on_tick(now)
        if now % 3 == 0:
            t.on_crc_ok_packet(now)
    bad = mod.HopTracker(require_full_map=True)
    bad.on_connect_req(mod.ConnectionInfo(1, 2, 5, 6, bytes.fromhex("1ffffffffe")), 0)
    return ([dataclasses.astuple(e) for e in t.events + bad.events],
            t.channel, t.hop_chan, t.used, t.interval_us, t.retunes)


def test_hop_tracker_matches():
    ref, got = _drive_tracker(jhop), _drive_tracker(thop)
    assert ref == got
    assert {"track_start", "chan_change", "chm_update", "conn_update",
            "track_drop"} <= {e[0] for e in got[0]}


# --------------------------------------------------------------------------
# the Sniffer end to end
# --------------------------------------------------------------------------


def _ev_key(e):
    return (e.ts_us, e.pkt_count, e.channel, e.access_addr, e.crc_ok, e.is_adv,
            repr(e.header), repr(e.payload), e.payload_bytes, e.rssi_dbm,
            e.raw_bytes)


class _ScriptedControl:
    """Register writes applied before the listed block indices (the
    ControlServer's apply() contract, without a socket)."""

    def __init__(self, script):
        self.script, self.k = script, 0

    def apply(self, target):
        writes = self.script.get(self.k, [])
        self.k += 1
        if writes:
            target.apply_control_registers(writes)
        return len(writes)


def _run(pkg, i, q, cfg, control=None, **kw):
    buf, pc, text = io.StringIO(), io.BytesIO(), io.StringIO()
    sn = pkg.Sniffer(pkg.SnifferConfig(**cfg), ndjson=pkg.NdjsonEmitter(buf),
                     pcap=pkg.PcapWriter(pc), text_fh=text,
                     control=None if control is None else _ScriptedControl(control),
                     **kw)
    events = sn.run(pkg.array_source(i, q, 7000))
    hop = [] if sn.hop_tracker is None else \
        [dataclasses.astuple(e) for e in sn.hop_tracker.events]
    return ([_ev_key(e) for e in events], buf.getvalue(), pc.getvalue(),
            text.getvalue(), hop, (sn.channel, sn.access_addr,
                                   sn.crc_init_internal)), events


def _both(monkeypatch, i, q, cfg, control=None):
    monkeypatch.setattr(time, "time", lambda: 1715680000.25)
    ref, _ = _run(J, i, q, cfg, control)
    got, events = _run(T, i, q, cfg, control, device="cpu")
    for r, g, what in zip(ref, got, ("events", "ndjson", "pcap", "text", "hop",
                                     "receiver")):
        assert r == g, what
    return events, got


def _adv_pdu(rng, n, pdu_type=0):
    payload = rng.integers(0, 256, n, dtype=np.uint8)
    return B.bytes_to_bits(np.concatenate([[pdu_type, n], payload]).astype(np.uint8))


def _tx(bits, ch, sps=4, phy="1m", conn=False):
    kw = dict(crc_init_hex=CRC_INIT_HEX, access_address_hex=CONN_AA_HEX) if conn else {}
    ci, cq, _ = G.btle_tx(bits, ch, sps=sps, flavor="c" if phy == "1m" else "python",
                          phy=phy, **kw)
    return ci, cq


def _multi_adv():
    """tests/test_stream.py's multi-packet scene (5 ADV PDUs, 3000-sample
    gaps of +-2 noise)."""
    rng = np.random.default_rng(0)
    segs = []
    for n in (6, 15, 37, 8, 22):
        ci, cq = _tx(_adv_pdu(rng, n), 37)
        segs.append(np.stack([ci, cq]).astype(np.int16))
        segs.append(rng.integers(-2, 3, (2, 3000)).astype(np.int16))
    s = np.concatenate(segs, axis=1)
    return s[0], s[1]


def _hop_scene(kind):
    """The four scenes of tests/test_hop.py::TestSingleChannelHopFollow."""
    rng = np.random.default_rng(0)
    n = {"two_hops": 120_000, "partial_map": 60_000, "chm_update": 120_000,
         "full_map_gate": 30_000}[kind]
    i, q = np.zeros(n, np.int16), np.zeros(n, np.int16)
    cr = connect_req_pdu()
    if kind in ("partial_map", "full_map_gate"):
        pdu = B.bits_to_bytes(cr)
        if kind == "partial_map":
            pdu[2 + 29] = 0xFD
        else:
            pdu[2 + 28] = 0xFE
        cr = B.bytes_to_bits(pdu)
    place(i, q, 10_000 if n == 120_000 else 5_000, *_tx(cr, 37))
    if kind == "two_hops":
        place(i, q, 36_000, *_tx(data_pdu(rng), 9, conn=True))
        place(i, q, 96_000, *_tx(data_pdu(rng), 18, conn=True))
    elif kind == "partial_map":
        place(i, q, 36_000, *_tx(data_pdu(rng), 10, conn=True))
    elif kind == "chm_update":
        ctrl = np.array([0x03, 8, 0x01, 0xFF, 0xFF, 0xFB, 0xFF, 0x1F, 0x01,
                         0x00], np.uint8)
        place(i, q, 36_000, *_tx(B.bytes_to_bits(ctrl), 9, conn=True))
        place(i, q, 96_000, *_tx(data_pdu(rng), 19, conn=True))
    return i, q


def test_sniffer_multi_adv_with_outputs(monkeypatch):
    i, q = _multi_adv()
    events, _ = _both(monkeypatch, i, q, dict(channel=37, sps=4, rssi=True,
                                              scan_len=8192))
    assert sum(e.crc_ok for e in events) == 5


@pytest.mark.parametrize("kind", ["two_hops", "partial_map", "chm_update"])
def test_sniffer_hop_follow(monkeypatch, kind):
    i, q = _hop_scene(kind)
    events, got = _both(monkeypatch, i, q, dict(channel=37, sps=4, hop=True,
                                                scan_len=8192))
    ok = [e for e in events if e.crc_ok]
    assert len(ok) == (2 if kind == "partial_map" else 3)
    assert got[4][0][0] == "track_start"


def test_sniffer_full_map_gate(monkeypatch):
    """require_full_map=True (set on both trackers) refuses the partial map."""
    i, q = _hop_scene("full_map_gate")
    monkeypatch.setattr(time, "time", lambda: 7.0)
    out = []
    for pkg, kw in ((J, {}), (T, {"device": "cpu"})):
        sn = pkg.Sniffer(pkg.SnifferConfig(channel=37, sps=4, hop=True),
                         quiet_text=True, **kw)
        sn.hop_tracker.require_full_map = True
        events = sn.run(pkg.array_source(i, q))
        out.append(([_ev_key(e) for e in events], sn.channel,
                    [dataclasses.astuple(e) for e in sn.hop_tracker.events]))
    assert out[0] == out[1]
    assert out[1][1] == 37 and out[1][2][-1][0] == "track_drop"


def test_sniffer_dwell_rotation(monkeypatch):
    rng = np.random.default_rng(4)
    n = 26_000
    i = rng.integers(-2, 3, n).astype(np.int16)
    q = rng.integers(-2, 3, n).astype(np.int16)
    for pos, ch in ((1000, 37), (9000, 38), (17500, 39), (21000, 37)):
        place(i, q, pos, *_tx(_adv_pdu(rng, 10), ch))
    events, got = _both(monkeypatch, i, q, dict(
        channel=37, sps=4, scan_len=4096, rotate_channels=(37, 38, 39),
        dwell_ms=2))
    assert [e.channel for e in events if e.crc_ok] == [37, 38, 39]
    assert got[1].count('"retune"') >= 2


def test_sniffer_le_2m(monkeypatch):
    rng = np.random.default_rng(5)
    i = rng.integers(-2, 3, 16_000).astype(np.int16)
    q = rng.integers(-2, 3, 16_000).astype(np.int16)
    for pos in (2000, 9000):
        place(i, q, pos, *_tx(_adv_pdu(rng, 14), 38, phy="2m"))
    events, _ = _both(monkeypatch, i, q, dict(channel=38, sps=4, phy="2m",
                                              scan_len=4096))
    assert sum(e.crc_ok for e in events) == 2


def test_sniffer_control_retune_between_blocks(monkeypatch):
    """Register writes (channel, AA, CRC init) land between blocks and key
    the following blocks, as from a ControlServer."""
    rng = np.random.default_rng(6)
    n = 30_000
    i = rng.integers(-2, 3, n).astype(np.int16)
    q = rng.integers(-2, 3, n).astype(np.int16)
    place(i, q, 1500, *_tx(_adv_pdu(rng, 9), 37))
    place(i, q, 12_000, *_tx(data_pdu(rng, 11), 9, conn=True))
    place(i, q, 20_000, *_tx(data_pdu(rng, 5), 9, conn=True))
    events, _ = _both(monkeypatch, i, q, dict(channel=37, sps=4, scan_len=8192),
                      control={1: [(11, 9), (10, CONN_AA), (12, 0xA77B22),
                                   (99, 1)]})
    assert [(e.channel, e.crc_ok) for e in events] == [(37, True), (9, True),
                                                      (9, True)]


def test_sniffer_handover_mid_stream(monkeypatch):
    """A JAX Sniffer scans the first block of the hop scene (it sees the
    CONNECT_REQ, whose samples reach into the next block); the port
    continues from its state and the next block's offset. The joined event
    list and hop events equal one JAX run over the whole stream."""
    monkeypatch.setattr(time, "time", lambda: 5.0)
    i, q = _hop_scene("two_hops")
    cfg = dict(channel=37, sps=4, hop=True, scan_len=10_240)
    whole = J.Sniffer(J.SnifferConfig(**cfg), quiet_text=True)
    whole.run(J.array_source(i, q))

    first = J.Sniffer(J.SnifferConfig(**cfg), quiet_text=True)
    it = J.OverlapBlockIterator(J.array_source(i, q), 4, lag=1, scan_len=10_240)
    for block in it:
        first._process_block(block, it)
        break
    state = convert.sniffer_state(first, block.offset + block.scan_len, it._skip)
    state = json.loads(json.dumps(state, default=lambda b: {"__bytes__": b.hex()}),
                       object_hook=lambda d: bytes.fromhex(d["__bytes__"])
                       if set(d) == {"__bytes__"} else d)
    assert state["skip"] > 0 and state["hop"]["state"] == 1
    rest = convert.sniffer_from_state(state, device="cpu", quiet_text=True)
    off = state["next_offset"]
    rest.run(T.array_source(i[off:], q[off:]), offset=off, skip=state["skip"])
    joined = [_ev_key(e) for e in first.packets + rest.packets]
    assert joined == [_ev_key(e) for e in whole.packets]
    assert sum(e.crc_ok for e in whole.packets) == 3
    assert [dataclasses.astuple(e) for e in rest.hop_tracker.events] == \
        [dataclasses.astuple(e) for e in whole.hop_tracker.events]
    assert (rest.channel, rest.access_addr, rest.pkt_count) == \
        (whole.channel, whole.access_addr, whole.pkt_count)


def test_sniffer_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda")
    with pytest.raises(RuntimeError):
        T.Sniffer(T.SnifferConfig())


# --------------------------------------------------------------------------
# the decode CLI
# --------------------------------------------------------------------------


def _write_scene(tmp_path):
    i, q = _hop_scene("two_hops")
    path = tmp_path / "scene.i16"
    np.stack([i, q], axis=1).reshape(-1).astype(np.int16).tofile(path)
    return path


def _port_cli(args, stdin=None):
    proc = subprocess.run([sys.executable, "-m", "btle_tpu_torch.cli", *args,
                           "--device", "cpu"], cwd=ROOT, capture_output=True,
                          stdin=stdin, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.decode(), proc.stderr.decode()


@pytest.mark.parametrize("source", ["file", "stdin"])
def test_cli_decode_json_matches_jax(tmp_path, capsys, source):
    """--json on a file at the live block size, and on stdin (whose
    default block size is the live one), against the JAX CLI on the file."""
    path = _write_scene(tmp_path)
    common = ["--format", "i16", "--channel", "37", "--sps", "4", "--hop", "--json"]
    assert jax_cli_main(["decode", "--bin", str(path), *common,
                         "--scan-len", "8192"]) == 0
    ref = capsys.readouterr()
    if source == "file":
        out, err = _port_cli(["decode", "--bin", str(path), *common,
                              "--scan-len", "8192"])
    else:
        with open(path, "rb") as fh:
            out, err = _port_cli(["decode", "--bin", "-", *common], stdin=fh)

    def lines(text):
        out = []
        for line in text.splitlines():
            obj = json.loads(line)
            obj.pop("ts")
            out.append(obj)
        return out

    ref_lines, got_lines = lines(ref.out), lines(out)
    assert ref_lines == got_lines
    assert sum(1 for o in got_lines if o["t"] == "pkt" and o["crc_ok"]) == 3
    assert [o["event"] for o in got_lines if o["t"] == "hop"][:2] == \
        ["track_start", "chan_change"]
    assert ref.err.strip().splitlines()[-1] == err.strip().splitlines()[-1]


def test_cli_decode_text_and_pcap_match_jax(tmp_path, capsys):
    """Text lines with RSSI on stdout and a pcap file (timestamps aside)."""
    path = _write_scene(tmp_path)
    args = ["decode", "--bin", str(path), "--format", "i16", "--channel", "37",
            "--sps", "4", "--hop", "--rssi", "--scan-len", "16384"]
    assert jax_cli_main([*args, "--pcap", str(tmp_path / "ref.pcap")]) == 0
    ref = capsys.readouterr()
    out, _ = _port_cli([*args, "--pcap", str(tmp_path / "got.pcap")])
    assert ref.out == out and "RSSI" in out
    recs = [[dataclasses.astuple(r)[1:] for r in J.read_pcap(tmp_path / name)]
            for name in ("ref.pcap", "got.pcap")]
    assert recs[0] == recs[1] and len(recs[1]) >= 2


def test_sniff_file_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 3.0)
    path = _write_scene(tmp_path)
    kw = dict(channel=37, sps=4, hop=True, scan_len=8192)
    ref = J.sniff_file(str(path), "i16", **kw)
    got = T.sniff_file(str(path), "i16", device="cpu", **kw)
    assert [_ev_key(e) for e in ref] == [_ev_key(e) for e in got]
    assert sum(e.crc_ok for e in got) == 3


def test_cli_refuses_coded_phy(tmp_path):
    """The coded decode reads a whole capture: it refuses stdin and the
    ILA CSV format, and decodes a file (here one with no packet)."""
    from btle_tpu_torch.cli.app import main

    path = tmp_path / "x.i16"
    np.zeros(64, np.int16).tofile(path)
    with pytest.raises(SystemExit, match="seekable --bin file"):
        main(["decode", "--bin", "-", "--phy", "coded8", "--device", "cpu"])
    with pytest.raises(SystemExit, match="not supported for a coded PHY"):
        main(["decode", "--bin", str(path), "--format", "csv", "--phy", "coded2",
              "--device", "cpu"])
    assert main(["decode", "--bin", str(path), "--phy", "coded8",
                 "--device", "cpu"]) == 0


def test_cli_runs_on_the_card_by_default(tmp_path):
    """--device defaults to cuda: without a card the CLI raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from btle_tpu_torch.cli.app import main

    path = tmp_path / "x.i16"
    np.zeros(64, np.int16).tofile(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["decode", "--bin", str(path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.Sniffer(T.SnifferConfig(), device="cuda")
