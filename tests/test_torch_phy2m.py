"""LE 2M in the port against the JAX package: every row of
tests/test_phy2m.py that the port's other tests lack (the narrowband LE 2M
sniffer is tests/test_torch_stream.py::test_sniffer_le_2m, 2M wideband
following tests/test_torch_wideband_follow.py::test_2m_follow_matches_jax).

Framing (the 16-bit preamble, the data-channel preamble, PHY checks,
``to_2m``, mixed-PHY plans), the golden / device / Sniffer loopbacks, the
config checks, 2M hop following on the narrowband Sniffer, the 2M
wideband self-test on the plain path and the CLI round trips
``tx --phy 2m`` -> ``decode`` and -> ``wideband``. Where a row has an
output it is compared, exactly, with ``btle_tpu``'s on the same input.
"""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from btle_tpu.cli.app import main as jax_cli_main
from btle_tpu.golden import model as JG
from btle_tpu.rx import stream_decode as j_stream_decode
from btle_tpu.spec import bits as JB
from btle_tpu.stream import Sniffer as JSniffer
from btle_tpu.stream import SnifferConfig as JSnifferConfig
from btle_tpu.stream.sources import array_source as j_array_source
from btle_tpu.tx import parse_descriptor as j_parse_descriptor
from btle_tpu.tx import synthesize as j_synthesize
from btle_tpu.tx.synth import plan_to_stream as j_plan_to_stream

from btle_tpu_torch.golden import model as G
from btle_tpu_torch.rx import stream_decode
from btle_tpu_torch.spec import bits as B
from btle_tpu_torch.stream import Sniffer, SnifferConfig
from btle_tpu_torch.stream.sources import array_source
from btle_tpu_torch.tx import parse_descriptor, synthesize
from btle_tpu_torch.tx.synth import plan_to_stream

from test_hop import CONN_AA_HEX, CRC_INIT_HEX, connect_req_pdu, data_pdu, place

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# ADV_NONCONN_IND, TxAdd=1: AdvA 06:05:04:03:02:01 + 3 payload bytes
PDU_HEX = "4209010203040506aabbcc"
ADV_IND = "37-ADV_IND-TxAdd-1-RxAdd-0-AdvA-010203040506-AdvData-0011"


def _pdu_bits():
    return B.hex_to_bits(PDU_HEX)


def _event_key(e):
    return (e.ts_us, e.channel, e.crc_ok, e.access_addr, bytes(e.payload_bytes))


# --------------------------------------------------------------------------
# framing
# --------------------------------------------------------------------------


def test_preamble_is_16_alternating_bits():
    phy1 = G.assemble_phy_bits(_pdu_bits(), channel=37)
    phy2 = G.assemble_phy_bits(_pdu_bits(), channel=37, phy="2m")
    np.testing.assert_array_equal(
        phy2, JG.assemble_phy_bits(JB.hex_to_bits(PDU_HEX), channel=37, phy="2m"))
    assert len(phy2) == len(phy1) + 8
    np.testing.assert_array_equal(phy2[:8], phy1[:8])
    np.testing.assert_array_equal(phy2[8:16], phy1[:8])
    np.testing.assert_array_equal(phy2[16:], phy1[8:])


def test_data_channel_preamble_follows_aa_lsb():
    aa = "01850A1B"      # LSB 1: "55" on 1M, "5555" on 2M
    kw = dict(channel=9, phy="2m", crc_init_hex="A77B22", access_address_hex=aa)
    phy2 = G.assemble_phy_bits(_pdu_bits(), **kw)
    np.testing.assert_array_equal(phy2, JG.assemble_phy_bits(JB.hex_to_bits(PDU_HEX), **kw))
    assert B.hex_to_bits(aa)[0] == 1
    np.testing.assert_array_equal(phy2[:16], B.hex_to_bits("5555"))


@pytest.mark.parametrize("phy", ["coded", "2M", "1M"])
def test_unknown_phy_rejected(phy):
    for pkg in (JG, G):
        with pytest.raises(ValueError):
            pkg.assemble_phy_bits(_pdu_bits(), phy=phy)


def test_descriptor_to_2m():
    spec, jspec = parse_descriptor(ADV_IND), j_parse_descriptor(ADV_IND)
    s2, j2 = spec.to_2m(), jspec.to_2m()
    assert (spec.phy, s2.phy) == ("1m", "2m")
    assert (spec.pdu_start, s2.pdu_start) == (40, 48) == (jspec.pdu_start, j2.pdu_start)
    assert s2.num_info_bits == spec.num_info_bits + 8 == j2.num_info_bits
    np.testing.assert_array_equal(s2.phy_bits(), j2.phy_bits())
    np.testing.assert_array_equal(s2.phy_bits()[8:], spec.phy_bits())
    assert s2.to_2m().num_info_bits == s2.num_info_bits


def test_to_2m_rejects_raw():
    for parse in (j_parse_descriptor, parse_descriptor):
        with pytest.raises(ValueError, match="raw_phy_bits"):
            parse("37-RAW-aaaaaaaa").to_2m()


def test_plan_to_stream_rejects_mixed_phy():
    spec = parse_descriptor(ADV_IND)
    pkts = synthesize([spec], flavor="c", sps=4, device="cpu") \
        + synthesize([spec.to_2m()], flavor="c", sps=4, device="cpu")
    with pytest.raises(ValueError, match="mixes PHYs"):
        plan_to_stream(pkts, sps=4)
    with pytest.raises(ValueError, match="sym_rate"):
        plan_to_stream(pkts[1:], sps=4, sym_rate_msym=1)
    # the right rate plays the 2M packet as the JAX package does
    jspec = j_parse_descriptor(ADV_IND).to_2m()
    want = j_plan_to_stream(j_synthesize([jspec], flavor="c", sps=4), sps=4,
                            sym_rate_msym=2)
    got = plan_to_stream(pkts[1:], sps=4, sym_rate_msym=2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# --------------------------------------------------------------------------
# loopback
# --------------------------------------------------------------------------


def test_golden_2m_loopback():
    """2M TX at 4 samples a symbol decodes byte-exact through the golden
    receiver, with the JAX package's samples and result."""
    pdu = _pdu_bits()
    i, q, _ = G.btle_tx(pdu, channel=37, sps=4, phy="2m")
    ji, jq, _ = JG.btle_tx(JB.hex_to_bits(PDU_HEX), channel=37, sps=4, phy="2m")
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(q, jq)
    pad = np.zeros(40, np.int16)
    args = (np.concatenate([pad, i, pad]), np.concatenate([pad, q, pad]), 37)
    res, jres = G.btle_rx(*args, sps=4), JG.btle_rx(*args, sps=4)
    assert res.crc_ok and jres.crc_ok
    np.testing.assert_array_equal(res.pdu_bits, pdu)
    np.testing.assert_array_equal(res.pdu_bits, jres.pdu_bits)


def test_device_pipeline_2m_loopback():
    """The block decoder needs no 2M knob: the port finds the packet the
    JAX package finds, at the same position."""
    pdu = _pdu_bits()
    i, q, _ = G.btle_tx(pdu, channel=37, sps=4, phy="2m")
    pad = np.zeros(256, np.int16)
    i, q = np.concatenate([pad, i, pad]), np.concatenate([pad, q, pad])
    got = [p for p in stream_decode(i, q, 37, sps=4, device="cpu").packets if p.crc_ok]
    want = [p for p in j_stream_decode(i, q, 37, sps=4).packets if p.crc_ok]
    assert len(got) == 1 == len(want)
    np.testing.assert_array_equal(got[0].pdu_bytes, want[0].pdu_bytes)
    assert got[0].sample_pos == want[0].sample_pos
    np.testing.assert_array_equal(B.bits_to_bytes(pdu),
                                  np.frombuffer(got[0].pdu_bytes, np.uint8))


def test_sniffer_2m_timestamps_are_halved(monkeypatch):
    """phy='2m' runs the microsecond clock at 8 samples a us; the events
    equal the JAX Sniffer's at both PHYs."""
    monkeypatch.setattr(time, "time", lambda: 1.0)
    spec = parse_descriptor(f"{ADV_IND}-Space-2").to_2m()
    pkt = synthesize([spec], flavor="c", sps=4, device="cpu")
    i, q = plan_to_stream(pkt, sps=4, num_repeat=2, sym_rate_msym=2)
    evs = {}
    for phy in ("1m", "2m"):
        evs[phy] = Sniffer(SnifferConfig(channel=37, sps=4, phy=phy), quiet_text=True,
                           device="cpu").run(array_source(i, q))
        ref = JSniffer(JSnifferConfig(channel=37, sps=4, phy=phy),
                       quiet_text=True).run(j_array_source(i, q))
        assert [_event_key(e) for e in evs[phy]] == [_event_key(e) for e in ref]
    assert len(evs["2m"]) == 2
    t1 = [e.ts_us for e in evs["1m"]]
    t2 = [e.ts_us for e in evs["2m"]]
    assert all(abs(a - 2 * b) <= 2 for a, b in zip(t1, t2))
    assert 1900 <= t2[1] - t2[0] <= 2400


def test_unknown_phy_rejected_at_config():
    for cfg in (JSnifferConfig, SnifferConfig):
        with pytest.raises(ValueError):
            cfg(phy="2M")       # case-sensitive: '1m'|'2m'
        with pytest.raises(ValueError):
            cfg(phy="coded")
        assert cfg(phy="2m").samples_per_us == 8


# --------------------------------------------------------------------------
# narrowband hop following
# --------------------------------------------------------------------------


def test_2m_connection_follow_two_hops(monkeypatch):
    """A CONNECT_REQ then data on the first two dwell channels (9 -> 18,
    hop 9), all at 2M: the interval clock paces at 8 samples a us. The
    events and hop events equal the JAX Sniffer's."""
    monkeypatch.setattr(time, "time", lambda: 1.0)
    rng = np.random.default_rng(7)
    sps, n = 4, 240_000
    i = np.zeros(n, np.int16)
    q = np.zeros(n, np.int16)
    ci, cq, _ = JG.btle_tx(connect_req_pdu(), 37, sps=sps, phy="2m")
    place(i, q, 20_000, ci, cq)            # t = 2500 us
    d1, d2 = data_pdu(rng), data_pdu(rng)
    for pdu, ch, at in ((d1, 9, 72_000), (d2, 18, 192_000)):
        ci, cq, _ = JG.btle_tx(pdu, ch, crc_init_hex=CRC_INIT_HEX,
                               access_address_hex=CONN_AA_HEX, sps=sps, phy="2m")
        place(i, q, at, ci, cq)
    cfg = dict(channel=37, sps=sps, hop=True, phy="2m")
    sn = Sniffer(SnifferConfig(**cfg), quiet_text=True, device="cpu")
    events = sn.run(array_source(i, q))
    ref_sn = JSniffer(JSnifferConfig(**cfg), quiet_text=True)
    ref = ref_sn.run(j_array_source(i, q))
    assert [_event_key(e) for e in events] == [_event_key(e) for e in ref]
    assert [(e.event, e.channel) for e in sn.hop_tracker.events] == \
        [(e.event, e.channel) for e in ref_sn.hop_tracker.events]
    ok = [e for e in events if e.crc_ok]
    assert [e.channel for e in ok] == [37, 9, 18]
    np.testing.assert_array_equal(np.frombuffer(ok[2].payload_bytes, np.uint8),
                                  B.bits_to_bytes(d2)[2:])
    assert sn.hop_tracker.hop == 9 and sn.hop_tracker.interval_us == 16 * 1250


# --------------------------------------------------------------------------
# wideband
# --------------------------------------------------------------------------


def test_selftest_xla_2m():
    """The known-answer scene framed for 2M decodes on all three channels
    through the plain wideband path at sps 2, at the JAX package's
    positions."""
    from btle_tpu.wideband.selftest import fused_selftest as j_selftest

    from btle_tpu_torch.wideband.selftest import fused_selftest

    pos = fused_selftest(pipeline="xla", phy="2m", device="cpu")
    assert set(pos) == {37, 17, 39}
    assert pos == j_selftest(pipeline="xla", phy="2m")


def test_wideband_config_rejects_unknown_phy():
    from btle_tpu.wideband import WidebandConfig as JConfig

    from btle_tpu_torch.wideband import WidebandConfig

    for cfg in (JConfig, WidebandConfig):
        with pytest.raises(ValueError):
            cfg(phy="coded")


# --------------------------------------------------------------------------
# CLI round trips
# --------------------------------------------------------------------------


def _port_cli(*args):
    proc = subprocess.run([sys.executable, "-m", "btle_tpu_torch.cli", *args,
                           "--device", "cpu"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _json_lines(text):
    out = []
    for line in text.splitlines():
        if line.strip().startswith("{"):
            obj = json.loads(line)
            obj.pop("ts", None)
            out.append(obj)
    return out


def test_tx_decode_2m_roundtrip(tmp_path, capsys):
    """``tx --phy 2m`` -> ``decode --phy 2m --json``: the port's tx file
    equals the JAX CLI's, and its decode NDJSON equals the JAX CLI's on
    that file."""
    desc = "37-DISCOVERY-TxAdd-1-RxAdd-0-AdvA-010203040506-LOCAL_NAME09-2M"
    out, ref = tmp_path / "tx2m.bin", tmp_path / "ref2m.bin"
    _port_cli("tx", desc, "--phy", "2m", "--out", str(out))
    assert jax_cli_main(["tx", desc, "--phy", "2m", "--out", str(ref)]) == 0
    assert out.read_bytes() == ref.read_bytes()
    got = _json_lines(_port_cli("decode", "--bin", str(out), "--format", "f32",
                                "--phy", "2m", "--json"))
    capsys.readouterr()
    assert jax_cli_main(["decode", "--bin", str(out), "--format", "f32", "--phy", "2m",
                         "--json"]) == 0
    assert got == _json_lines(capsys.readouterr().out)
    pkts = [p for p in got if p.get("t") == "pkt"]
    assert len(pkts) == 1 and pkts[0]["crc_ok"]
    assert pkts[0]["adv_a"] == "01:02:03:04:05:06"


def test_tx_2m_wideband_roundtrip(tmp_path, capsys):
    """``tx --phy 2m --wideband-out`` -> ``wideband --phy 2m``: the 2M packet
    rides the 2 MHz channel grid (40 samples a symbol at 80 Msps) and
    decodes at sps 2; the capture and the text lines equal the JAX CLI's."""
    desc = "37-ADV_IND-TxAdd-1-RxAdd-0-AdvA-010203040506-AdvData-00112233-Space-1"
    wb, ref = tmp_path / "wb2m.bin", tmp_path / "ref2m.bin"
    _port_cli("tx", desc, "--phy", "2m", "--wideband-out", str(wb))
    assert jax_cli_main(["tx", desc, "--phy", "2m", "--wideband-out", str(ref)]) == 0
    assert wb.read_bytes() == ref.read_bytes()
    out = _port_cli("wideband", "--bin", str(wb), "--format", "f32", "--phy", "2m")
    capsys.readouterr()
    assert jax_cli_main(["wideband", "--bin", str(wb), "--format", "f32",
                         "--phy", "2m"]) == 0
    want = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("ch37 ") and " crc0 " in ln]
    assert lines, out
    assert lines == [ln for ln in want.splitlines()
                     if ln.startswith("ch37 ") and " crc0 " in ln]
    assert "06050403020100112233" in lines[0]
