"""The port's recon chain (cli/events, aggregate, vendors, pcap_loader,
recon; the scan, recon and analyze subcommands) against btle_tpu's on the
CPU, mirroring tests/test_cli.py's events, aggregate and recon classes,
its scan -> pcap -> recon chain (on a synthesized capture: the reference
capture is not in the repo, so btle_tpu's output is the truth) and
tests/test_cli_extra.py::TestBundledOuiRegistry.

The port has no pydantic: its events and reports are dataclasses with a
JSON writer of their own. Every report and event dump must be byte-equal
to pydantic's (exact), ``parse_line`` must return None exactly where
btle_tpu's does (a hypothesis test over random and malformed NDJSON
lines), and every CLI output must be byte-equal to ``btle_tpu``'s on the
same capture.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pydantic = pytest.importorskip("pydantic")
pydantic_core = pytest.importorskip("pydantic_core")

from hypothesis import HealthCheck, given, settings, strategies as st

from btle_tpu.cli import aggregate as jagg
from btle_tpu.cli import app as japp
from btle_tpu.cli import events as jev
from btle_tpu.cli import pcap_loader as jload
from btle_tpu.cli import recon as jrecon
from btle_tpu.cli import vendors as jvendors
from btle_tpu.golden import model as G
from btle_tpu.spec import bits as B

from btle_tpu_torch.cli import aggregate as tagg
from btle_tpu_torch.cli import app as tapp
from btle_tpu_torch.cli import events as tev
from btle_tpu_torch.cli import pcap_loader as tload
from btle_tpu_torch.cli import recon as trecon
from btle_tpu_torch.cli import vendors as tvendors

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# --------------------------------------------------------------------------
# a synthesized advertising capture (4 Msps, channel 37, int16)
# --------------------------------------------------------------------------

SPS = 4
ADV_SPACING = 60_000                # 15 ms of air between packets


def _adv_payload(adv_a: str, ads: list) -> bytes:
    """AdvA (display order) then AD structures [(type, body)]."""
    out = bytes.fromhex(adv_a.replace(":", ""))[::-1]
    for t, body in ads:
        out += bytes([len(body) + 1, t]) + body
    return out


def _connect_req(init_a: str, adv_a: str) -> bytes:
    ll = (bytes.fromhex("1b0a8560") + bytes.fromhex("a77b22") + bytes([2])
          + (15).to_bytes(2, "little") + (40).to_bytes(2, "little")
          + bytes(2) + (2000).to_bytes(2, "little") + bytes.fromhex("ffffffff1f")
          + bytes([9 | 5 << 5]))
    return (bytes.fromhex(init_a.replace(":", ""))[::-1]
            + bytes.fromhex(adv_a.replace(":", ""))[::-1] + ll)


def recon_packets(variant: int = 0) -> list:
    """[(header byte, payload)] of the scene: an iBeacon with a non-ASCII
    name, a Nordic sensor whose manufacturer data counts, a Raspberry Pi
    OUI with the Nordic UART service, a SCAN_RSP and a CONNECT_REQ.
    variant 1 drops the Pi and moves the sensor's counter on."""
    beacon, sensor, pi = "aa:bb:cc:dd:ee:01", "11:22:33:44:55:66", "b8:27:eb:00:00:07"
    uart = bytes.fromhex("6e400001b5a3f393e0a9e50e24dcca9e")[::-1]
    out = []
    for k in range(9):
        out.append((0x40, _adv_payload(beacon, [
            (0x01, b"\x06"), (0x09, "Lampe-Café".encode()),
            (0xFF, bytes.fromhex("4c000215") + bytes(range(k, k + 4)))])))
        out.append((0x02, _adv_payload(sensor, [
            (0x03, bytes.fromhex("0d18")), (0x0A, bytes([0xF8])),
            (0xFF, bytes([0x59, 0x00, 7 * variant + k, 0x42, 0x99]))])))
        if variant == 0 and k % 2 == 0:
            out.append((0x06, _adv_payload(pi, [(0x07, uart), (0x08, b"pi")])))
    out.insert(3, (0x04, _adv_payload(beacon, [(0x02, bytes.fromhex("0f180a18"))])))
    out.insert(8, (0x05, _connect_req("01:02:03:04:05:06", beacon)))
    return out


def recon_capture(path, seed: int = 5, variant: int = 0):
    """The scene's packets every 15 ms at int16 amplitude 2000 plus noise
    of std 40, written as interleaved i16; returns the packets."""
    pkts = recon_packets(variant)
    n = ADV_SPACING * (len(pkts) + 1)
    rng = np.random.default_rng(seed)
    i = rng.normal(0, 40, n)
    q = rng.normal(0, 40, n)
    for k, (hdr, payload) in enumerate(pkts):
        pdu = B.bytes_to_bits(np.frombuffer(bytes([hdr, len(payload)]) + payload, np.uint8))
        ci, cq = G.gfsk_modulate_float(G.assemble_phy_bits(pdu, 37), SPS, 2000.0)
        at = 3000 + ADV_SPACING * k
        i[at:at + len(ci)] += ci
        q[at:at + len(cq)] += cq
    inter = np.empty(2 * n, np.int16)
    inter[0::2] = np.clip(np.round(i), -32768, 32767)
    inter[1::2] = np.clip(np.round(q), -32768, 32767)
    inter.tofile(path)
    return pkts


def run_main(main, argv) -> str:
    """A CLI main() in this process: its standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(list(argv)) == 0
    return out.getvalue()


def both(argv, port_extra=("--device", "cpu")) -> tuple[str, str]:
    return run_main(japp.main, argv), run_main(tapp.main, [*argv, *port_extra])


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    d = tmp_path_factory.mktemp("recon")
    a, b = d / "a.i16", d / "b.i16"
    recon_capture(a, seed=5, variant=0)
    recon_capture(b, seed=6, variant=1)
    pcaps = {}
    for name, path in (("a", a), ("b", b)):
        pcaps[name] = str(d / f"{name}.pcap")
        run_main(japp.main, ["decode", "--bin", str(path), "--format", "i16",
                             "--quiet-text", "--pcap", pcaps[name]])
        port_pcap = str(d / f"{name}.port.pcap")
        run_main(tapp.main, ["decode", "--bin", str(path), "--format", "i16",
                             "--quiet-text", "--pcap", port_pcap, "--device", "cpu"])
        # pcap timestamps are wall-clock: the records must agree apart
        # from the timestamp
        jr = [(r.channel, r.rssi_dbm, r.access_addr, r.packet) for r in jload.load(pcaps[name]).packets]
        tr = [(r.channel, r.rssi_dbm, r.access_addr, r.packet) for r in tload.load(port_pcap).packets]
        assert jr == tr and len(jr) >= 20
    return {"a": str(a), "b": str(b), **{f"{k}.pcap": v for k, v in pcaps.items()}}


# --------------------------------------------------------------------------
# events
# --------------------------------------------------------------------------


def make_adv_event(mod, ts, adv_a="aa:bb:cc:dd:ee:ff", payload_hex=None, pdu_type=0,
                   rssi=-60, ch=37):
    """tests/test_cli.py's make_adv_event in either package."""
    if payload_hex is None:
        payload_hex = ("ffeeddccbbaa" + "020106" + "0409546167" + "07ff4c0002155510")
    return mod.PktEvent(
        v=1, t="pkt", ts=ts, pkt=1, ch=ch, aa="8e89bed6", crc_ok=True,
        kind="adv", pdu_type=pdu_type, pdu_name="ADV_IND", tx_add=0, rx_add=0,
        plen=len(payload_hex) // 2, adv_a=adv_a, payload_hex=payload_hex,
        rssi_est=rssi)


DUMPS = ({}, {"exclude_none": True}, {"indent": 2, "exclude_none": True}, {"indent": 2})


def assert_same_dumps(j, t):
    for kw in DUMPS:
        assert t.model_dump_json(**kw) == j.model_dump_json(**kw), kw
    assert repr(t.model_dump(exclude_none=True)) == repr(j.model_dump(exclude_none=True))


class TestEvents:
    def test_parse_line_roundtrip(self):
        from btle_tpu_torch.stream import NdjsonEmitter

        buf = io.StringIO()
        NdjsonEmitter(buf).pkt_adv(1.5, 3, 37, 0x8E89BED6, True, 0, "ADV_IND",
                                   1, 0, 10, bytes(6), b"\x01\x02", -50)
        ev = tev.parse_line(buf.getvalue())
        assert isinstance(ev, tev.PktEvent)
        assert ev.kind == "adv" and ev.crc_ok and ev.rssi_est == -50
        assert_same_dumps(jev.parse_line(buf.getvalue()), ev)

    def test_parse_line_garbage(self):
        assert tev.parse_line("") is None
        assert tev.parse_line("not json") is None
        assert tev.parse_line('{"v":1,"t":"nope","ts":0}') is None

    def test_extras_kept_and_dumped_last(self):
        line = ('{"v":1,"t":"pkt","ts":2,"pkt":"4","ch":9.0,"aa":"x","crc_ok":"yes",'
                '"kind":"data","plen":3,"payload_hex":"ab","plain_hex":"c0ffee","zz":null}')
        ev = tev.parse_line(line)
        assert ev.plain_hex == "c0ffee" and ev.pkt == 4 and ev.ch == 9 and ev.crc_ok is True
        assert ev.model_extra == {"plain_hex": "c0ffee", "zz": None}
        assert_same_dumps(jev.parse_line(line), ev)
        # extras named like the model's API stay data
        line = ('{"v":1,"t":"status","ts":0,"event":"x","model_dump_json":1,'
                '"model_extra":[2],"model_validate":null}')
        ev = tev.parse_line(line)
        assert ev.model_extra == {"model_dump_json": 1, "model_extra": [2], "model_validate": None}
        assert_same_dumps(jev.parse_line(line), ev)

    def test_construction_validates(self):
        with pytest.raises(ValueError):
            tev.PktEvent(v=1, t="pkt", ts=0.0)          # missing fields
        with pytest.raises(ValueError):
            make_adv_event(tev, 1.0, pdu_type="x")
        with pytest.raises(ValueError):
            trecon.DeviceBrief(adv_a="a", bogus=1)      # reports forbid extras
        ev = make_adv_event(tev, 3)
        assert ev.ts == 3.0 and isinstance(ev.ts, float)
        assert_same_dumps(make_adv_event(jev, 3), ev)


# random and malformed NDJSON lines: parse_line must give None where
# btle_tpu's gives None (or raises: its lookup of an unhashable "t"), and
# equal dumps everywhere else
_NUMERIC_TEXT = st.text(alphabet="0123456789_.+-eEinfatyosINFAF \t\xa0\x1c", max_size=12)
_SCALARS = st.one_of(
    st.none(), st.booleans(), st.integers(-2 ** 70, 2 ** 70),
    st.floats(allow_nan=True, allow_infinity=True), st.text(max_size=8), _NUMERIC_TEXT,
    st.sampled_from(["37", " 37 ", "37.0", "1_000", "0_-1", "yes", "Off", "pkt",
                     "adv", "data", "1e-7", "inf", "-nan", "\ud800", "é", "\x00"]))
_VALUES = st.recursive(_SCALARS, lambda c: st.lists(c, max_size=3)
                       | st.dictionaries(st.text(max_size=4), c, max_size=3), max_leaves=6)

_VALID = {
    "pkt": dict(v=1, t="pkt", ts=1.25, pkt=7, ch=37, aa="8e89bed6", crc_ok=True,
                kind="adv", plen=8, payload_hex="0102030405060708", rssi_est=-61,
                pdu_type=0, pdu_name="ADV_IND", tx_add=0, rx_add=1,
                adv_a="aa:bb:cc:dd:ee:ff", ll_pdu_type=None, nesn=0, sn=1, md=0),
    "hop": dict(v=1, t="hop", ts=2.5, event="track_start", state_from=0, state_to=1,
                ch=9, freq_mhz=2422, aa="60850a1b", crc_init="a77b22",
                interval_us=50000, hop=9, chm="1fffffffff"),
    "status": dict(v=1, t="status", ts=0.0, event="start", board="wideband", ch=-1,
                   freq_hz=0, gain=0, lna=0, amp=0, filter_adva=None, msg="m"),
}


@st.composite
def ndjson_lines(draw):
    kind = draw(st.sampled_from(["pkt", "hop", "status", "text"]))
    if kind == "text":
        return draw(st.text(max_size=40))
    obj = dict(_VALID[kind])
    for key in draw(st.lists(st.sampled_from(sorted(obj)), max_size=3)):
        if draw(st.booleans()):
            obj.pop(key, None)
        else:
            obj[key] = draw(_VALUES)
    for key in draw(st.lists(st.text(max_size=6), max_size=2)):
        obj[key] = draw(_VALUES)
    line = json.dumps(obj, ensure_ascii=draw(st.booleans()))
    cut = draw(st.integers(0, 3))
    return line[: len(line) - cut] if cut == 3 else line


def _jax_parse(line):
    try:
        return jev.parse_line(line)
    except TypeError:
        return None


@settings(max_examples=400, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(ndjson_lines())
def test_parse_line_matches_pydantic(line):
    j, t = _jax_parse(line), tev.parse_line(line)
    assert (j is None) == (t is None), line
    if j is None:
        return
    assert type(j).__name__ == type(t).__name__
    for kw in DUMPS:
        try:
            want = j.model_dump_json(**kw)
        except pydantic_core.PydanticSerializationError:
            with pytest.raises(ValueError):
                t.model_dump_json(**kw)
            continue
        assert t.model_dump_json(**kw) == want, (line, kw)


def _lax(adapter, value):
    try:
        return ("ok", repr(adapter.validate_python(value)))
    except pydantic.ValidationError:
        return ("invalid",)


def _port_lax(check, value):
    try:
        return ("ok", repr(check(value)))
    except ValueError:
        return ("invalid",)


@pytest.mark.parametrize("kind,alphabet,longest", [
    (int, "01-+_. ", 6), (float, "1_.e-+ ", 6), (float, "inf_a ", 6), (bool, "tTrRuUeE01 ", 4)])
def test_lax_strings_match_pydantic(kind, alphabet, longest):
    """Every string over a small alphabet (signs, underscores, dots,
    spaces, exponents, inf/nan spellings) up to a few characters:
    accepted and converted by the port's lax check exactly where
    pydantic's lax mode accepts it."""
    import itertools

    adapter = pydantic.TypeAdapter(kind)
    check = tev._COERCE[kind]
    for n in range(longest + 1):
        for chars in itertools.product(alphabet, repeat=n):
            text = "".join(chars)
            assert _port_lax(check, text) == _lax(adapter, text), repr(text)


@pytest.mark.parametrize("kind", [int, float, bool, str])
def test_lax_values_match_pydantic(kind):
    """The JSON scalars json.loads yields, at the edges of each kind."""
    adapter = pydantic.TypeAdapter(kind)
    check = tev._COERCE[kind]
    values = [None, True, False, 0, 1, -1, 2, 2 ** 63, -2 ** 63, 10 ** 400, 0.0, -0.0, 1.0,
              0.5, 37.0, 1e20, 9.223372036854775e18, 9.223372036854776e18, float("inf"),
              float("nan"), "", " ", "37", "\xa037\u3000", "\x1c37", "٣", "3" * 4301,
              "1" * 4300, [], {}, "1e400"]
    for v in values:
        assert _port_lax(check, v) == _lax(adapter, v), repr(v)[:40]


@settings(max_examples=500, deadline=None)
@given(st.floats(allow_nan=True, allow_infinity=True))
def test_float_writer_matches_pydantic(x):
    # model_dump_json writes non-finite floats as null (ser_json_inf_nan)
    assert tev.dumps(x) == pydantic_core.to_json(x, inf_nan_mode="null").decode()
    assert tev.dumps([x], indent=2) == pydantic_core.to_json(
        [x], indent=2, inf_nan_mode="null").decode()


@pytest.mark.parametrize("x", [1e-7, 1e16, 1e15, 1e-5, 1e-6, 0.30000000000000004, -0.0,
                               5e-324, 1.7976931348623157e308, 123456789012345680.0,
                               100.0, 0.1, -2.5e-9, 9007199254740993.0])
def test_float_writer_edges(x):
    assert tev.dumps(x) == pydantic_core.to_json(x).decode()


def test_report_json_pinned():
    """A hand-made report with floats on both sides of the positional
    range and a non-ASCII name: the port prints what pydantic prints, and
    both print these bytes."""
    kw = dict(duration_s=1e-7, n_devices=2, n_packets=5, crc_ok_ratio=1e16,
              channels_scanned=[37, 38], fingerprints_seen={"ibeacon": 1})
    briefs = [dict(adv_a="aa:bb:cc:dd:ee:01", name="Lampe-Café ☕", vendor_hint=None,
                   rssi_dbm=-61, n_pkts=3),
              dict(adv_a="11:22:33:44:55:66", n_pkts=2)]
    j = jrecon.ScanSummary(devices_top=[jrecon.DeviceBrief(**b) for b in briefs], **kw)
    t = trecon.ScanSummary(devices_top=[trecon.DeviceBrief(**b) for b in briefs], **kw)
    want = """{
  "duration_s": 1e-7,
  "n_devices": 2,
  "n_packets": 5,
  "crc_ok_ratio": 1e16,
  "channels_scanned": [
    37,
    38
  ],
  "devices_top": [
    {
      "adv_a": "aa:bb:cc:dd:ee:01",
      "name": "Lampe-Café ☕",
      "rssi_dbm": -61,
      "n_pkts": 3
    },
    {
      "adv_a": "11:22:33:44:55:66",
      "n_pkts": 2
    }
  ],
  "fingerprints_seen": {
    "ibeacon": 1
  }
}"""
    assert j.model_dump_json(indent=2, exclude_none=True) == want
    assert t.model_dump_json(indent=2, exclude_none=True) == want
    p = dict(adv_a="x", avg_interval_ms=0.30000000000000004, duration_s=3, notes=["ünïcode"],
             primary_service_uuids=[])
    assert_same_dumps(jrecon.TargetProfile(**p), trecon.TargetProfile(**p))


# --------------------------------------------------------------------------
# aggregate and recon (tests/test_cli.py's classes)
# --------------------------------------------------------------------------


class TestAggregate:
    def test_ad_parse(self):
        hexs = ("ffeeddccbbaa" + "020106" + "0409546167" + "0302180d" + "07ff4c0002155510")
        p = tagg.parse_ad_structures(hexs)
        assert p.flags == 6 and p.local_name == "Tag"
        assert p.service_uuids_16 == ["0d18"] and p.manufacturer_id == 0x004C
        assert dataclasses.asdict(p) == dataclasses.asdict(jagg.parse_ad_structures(hexs))

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_ad_parse_random_streams(self, seed):
        rng = np.random.default_rng(seed)
        for _ in range(200):
            raw = rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8)
            for k in range(6, len(raw) - 1, 5):      # plausible AD types
                raw[k] = rng.choice([1, 2, 3, 6, 7, 8, 9, 10, 0xFF])
            h = raw.tobytes().hex() + ("z" if rng.random() < 0.05 else "")
            assert dataclasses.asdict(tagg.parse_ad_structures(h)) == \
                dataclasses.asdict(jagg.parse_ad_structures(h))

    def test_device_records(self):
        recs = {}
        for mod, agg_mod in ((jev, jagg), (tev, tagg)):
            agg = agg_mod.ScanAggregator()
            for k in range(5):
                agg.update(make_adv_event(mod, 10.0 + 0.1 * k))
            agg.update(make_adv_event(mod, 10.6, adv_a="11:22:33:44:55:66"))
            assert len(agg.devices) == 2
            rec = agg.devices["aa:bb:cc:dd:ee:ff"]
            assert rec.pkt_count == 5 and rec.name == "Tag" and rec.vendor == "Apple"
            assert len(rec.advert_intervals_ms) == 4
            assert abs(np.mean(rec.advert_intervals_ms) - 100) < 1
            recs[mod] = [(r.adv_a, r.pkt_count, r.vendor, r.name, list(r.advert_intervals_ms),
                          sorted(r.pdu_types_seen)) for r in agg.snapshot("pkts")]
        assert recs[jev] == recs[tev]


def _aggs(fill):
    out = []
    for mod, agg_mod in ((jev, jagg), (tev, tagg)):
        agg = agg_mod.ScanAggregator()
        fill(mod, agg)
        out.append(agg)
    return out


def _six(mod, agg):
    for k in range(6):
        agg.update(make_adv_event(mod, 5.0 + 0.2 * k))


class TestRecon:
    def test_quickscan(self):
        j, t = (r.quickscan(a) for r, a in zip((jrecon, trecon), _aggs(_six)))
        assert t.n_devices == 1 and t.devices_top[0].vendor_hint == "Apple"
        assert t.fingerprints_seen.get("ibeacon") == 1
        assert_same_dumps(j, t)

    def test_profile(self):
        j, t = (r.profile(a, "AA:BB:CC:DD:EE:FF") for r, a in zip((jrecon, trecon), _aggs(_six)))
        assert t.name == "Tag" and t.protocol_fingerprint == "ibeacon" and t.is_connectable
        assert t.avg_interval_ms == pytest.approx(200, rel=0.05)
        assert_same_dumps(j, t)
        j, t = (r.profile(a, "00:00:00:00:00:01") for r, a in zip((jrecon, trecon), _aggs(_six)))
        assert_same_dumps(j, t)

    def test_diff(self):
        def other(mod, agg):
            agg.update(make_adv_event(mod, 1.0, adv_a="11:22:33:44:55:66", rssi=-40))
            agg.update(make_adv_event(mod, 1.5, rssi=-30, payload_hex="ffeeddccbbaa020105"))

        (ja, ta), (jb, tb) = _aggs(_six), _aggs(other)
        j, t = jrecon.diff(ja, jb), trecon.diff(ta, tb)
        assert t.only_in_b == ["11:22:33:44:55:66"] and t.rssi_shifts
        assert_same_dumps(j, t)

    def test_payload_entropy_counter(self):
        def fill(mod, agg):
            for k in range(8):
                payload = "ffeeddccbbaa" + f"07ff4c000215{k:02x}55"
                agg.update(make_adv_event(mod, 1.0 + k, payload_hex=payload))

        j, t = (r.payload_entropy(a, "aa:bb:cc:dd:ee:ff") for r, a in zip((jrecon, trecon), _aggs(fill)))
        assert t.n_samples == 8 and t.likely_counter_positions == [4]
        assert t.static_prefix_bytes == 4
        assert_same_dumps(j, t)
        empty = [r.payload_entropy(a, "00:00:00:00:00:09") for r, a in zip((jrecon, trecon), _aggs(fill))]
        assert_same_dumps(*empty)

    def test_fingerprint_rules(self):
        cases = ["ffeeddccbbaa" + body for body in (
            "07ff4c0002155510", "05ff4c001005", "04ff0600aa", "04ff5900bb", "04ff3713cc",
            "11079e0edcca240ea9e093f3a3b5010040" + "6e", "0303aafe", "03035afd", "03039ffe",
            "0303f3fe", "1107" + "23d1bcea5f782315deef121223150000", "03020d18", "")]
        for h in cases:
            assert trecon.fingerprint(tagg.parse_ad_structures(h)) == \
                jrecon.fingerprint(jagg.parse_ad_structures(h)), h


class TestBundledOuiRegistry:
    """The port's copy of the bundled IEEE registry (cli/data/oui.tsv.gz):
    the same table as btle_tpu's, and the same lookups."""

    def test_bundled_db_loaded(self):
        tvendors._oui_table.cache_clear()
        table = tvendors._oui_table()
        assert len(table) > 30_000
        jvendors._oui_table.cache_clear()
        assert table == jvendors._oui_table()
        assert tvendors._BUNDLED_DB.startswith(os.path.join(ROOT, "btle_tpu_torch"))

    def test_lookup_parity_sample(self):
        table = jvendors._oui_table()
        for prefix in sorted(table)[:: max(1, len(table) // 50)][:50]:
            mac = prefix + ":00:00:00"
            got = tvendors.oui_lookup(mac)
            assert got is not None and got == jvendors.oui_lookup(mac), prefix
        for mid in range(0, 0x0500, 7):
            assert tvendors.manufacturer_name(mid) == jvendors.manufacturer_name(mid)

    def test_unknown_prefix_none(self):
        assert tvendors.oui_lookup("ff:ff:ff:00:00:00") is None
        assert tvendors.oui_lookup("zz") is None


# --------------------------------------------------------------------------
# the CLI chain: scan, decode --pcap, recon, analyze (byte-equal)
# --------------------------------------------------------------------------


class TestCliChain:
    def test_scan_json_and_table(self, captures):
        for extra in ((), ("--json",)):
            argv = ["scan", "--bin", captures["a"], "--format", "i16", *extra]
            j, t = both(argv)
            assert t == j
        summary = json.loads(t)
        assert summary["n_devices"] == 3 and summary["n_packets"] >= 20
        tops = {d["adv_a"]: d for d in summary["devices_top"]}
        assert tops["aa:bb:cc:dd:ee:01"]["name"] == "Lampe-Café"
        assert tops["aa:bb:cc:dd:ee:01"]["fingerprint"] == "ibeacon"
        assert tops["b8:27:eb:00:00:07"]["fingerprint"] == "nordic_uart"
        assert "é" in t                                    # written raw

    def test_recon_ops(self, captures):
        pcap_a, pcap_b = captures["a.pcap"], captures["b.pcap"]
        for argv in (["recon", "quickscan", pcap_a],
                     ["recon", "profile", pcap_a, "--adv-a", "AA:BB:CC:DD:EE:01"],
                     ["recon", "profile", pcap_a, "--adv-a", "11:22:33:44:55:66"],
                     ["recon", "diff", pcap_a, pcap_b],
                     ["recon", "entropy", pcap_a, "--adv-a", "11:22:33:44:55:66"],
                     ["recon", "entropy", pcap_a, "--adv-a", "aa:bb:cc:dd:ee:01"],
                     ["recon", "gatt", pcap_a]):
            j, t = both(argv, port_extra=())
            assert t == j, argv
        prof = json.loads(both(["recon", "profile", pcap_a, "--adv-a", "aa:bb:cc:dd:ee:01"],
                               port_extra=())[1])
        assert prof["is_connectable"] and prof["is_scan_responsive"]
        assert any("CONNECT_REQ" in n for n in prof["notes"])
        d = json.loads(both(["recon", "diff", pcap_a, pcap_b], port_extra=())[1])
        assert d["only_in_a"] == ["b8:27:eb:00:00:07"] and "11:22:33:44:55:66" in d["payload_changed"]
        ent = json.loads(both(["recon", "entropy", pcap_a, "--adv-a", "11:22:33:44:55:66"],
                              port_extra=())[1])
        assert ent["likely_counter_positions"] == [2]

    def test_analyze(self, captures):
        j, t = both(["analyze", captures["a.pcap"]], port_extra=())
        assert t == j and "devices: 3" in t

    def test_scan_pcap_recon_subprocess(self, captures, tmp_path):
        """tests/test_cli.py::test_scan_and_pcap_and_recon through
        ``python -m btle_tpu_torch`` in child processes: decode --pcap,
        then recon quickscan and analyze, equal to the in-process runs of
        btle_tpu."""
        pcap = tmp_path / "cap.pcap"

        def run(*argv):
            r = subprocess.run([sys.executable, "-m", "btle_tpu_torch", *argv],
                               capture_output=True, text=True, timeout=300, cwd=ROOT,
                               env={**os.environ, "PYTHONPATH": ROOT})
            assert r.returncode == 0, r.stderr
            return r.stdout

        run("decode", "--bin", captures["a"], "--format", "i16", "--quiet-text",
            "--pcap", str(pcap), "--device", "cpu")
        cap = tload.load(pcap)
        assert len(cap.packets) >= 20
        assert cap.packets[0].adv_a == "aa:bb:cc:dd:ee:01"
        out = run("recon", "quickscan", str(pcap))
        assert out == run_main(japp.main, ["recon", "quickscan", str(pcap)])
        assert json.loads(out)["n_devices"] == 3
        out = run("analyze", str(pcap))
        assert out == run_main(japp.main, ["analyze", str(pcap)]) and "devices: 3" in out
