"""The port's capture analysis (cli/analyze.py, a copy of
btle_tpu.cli.analyze, and the ``analyze`` subcommand) against btle_tpu
on the CPU, mirroring tests/test_analyze_figures.py (the figures' data
and the files written) and tests/test_system.py (a simulated airspace
through the port's wideband follower, summarized by the recon layer).
Summaries, figure data and file names are compared exactly; the
no-matplotlib branch is exercised by hiding the package."""

import contextlib
import io
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
mpl = pytest.importorskip("matplotlib")
mpl.use("Agg")

from btle_tpu.cli import analyze as JA
from btle_tpu.cli import app as japp
from btle_tpu.golden import model as G
from btle_tpu.spec import bits as B

from btle_tpu_torch.cli import analyze as TA
from btle_tpu_torch.cli import app as tapp
from btle_tpu_torch.stream.pcap import PcapWriter

torch.set_num_threads(2)


def _adv_packet(adv_a_hex: str, name: str = "") -> bytes:
    payload = bytes.fromhex(adv_a_hex)[::-1]
    if name:
        nb = name.encode()
        payload += bytes([len(nb) + 1, 0x09]) + nb
    return bytes([0x00, len(payload)]) + payload


@pytest.fixture
def pcap(tmp_path):
    """Three devices, staggered timestamps, two with repeat packets
    (tests/test_analyze_figures.py's, written by the port's PcapWriter)."""
    p = tmp_path / "cap.pcap"
    with PcapWriter(str(p)) as w:
        t = 1000.0
        for k in range(6):
            w.write_packet(_adv_packet("0a0b0c0d0e0f", "Lamp"), 37, 0x8E89BED6,
                           rssi_dbm=-50, ts=t + 0.1 * k)
            w.write_packet(_adv_packet("112233445566"), 38, 0x8E89BED6,
                           rssi_dbm=-70, ts=t + 0.05 + 0.1 * k)
        w.write_packet(_adv_packet("77445566aabb", "One"), 39, 0x8E89BED6,
                       rssi_dbm=-60, ts=t + 0.3)
    return p


def _axes_data(fig):
    """What a figure shows: per axes its title, labels, tick labels,
    texts, bar geometry and line data."""
    out = []
    for ax in fig.axes:
        out.append((ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
                    [t.get_text() for t in ax.get_yticklabels()],
                    [t.get_text() for t in ax.texts],
                    [(round(p.get_x(), 9), round(p.get_y(), 9), round(p.get_width(), 9),
                      round(p.get_height(), 9)) for p in ax.patches],
                    [np.asarray(ln.get_xydata()).round(9).tolist() for ln in ax.lines]))
    return out


class TestFigures:
    def test_timeline_rows_are_devices(self, pcap):
        fig = TA.timeline_figure(str(pcap))
        labels = [t.get_text() for t in fig.axes[0].get_yticklabels()]
        assert len(labels) == 3 and "0a:0b:0c:0d:0e:0f" in labels
        jfig = JA.timeline_figure(str(pcap))
        assert _axes_data(fig) == _axes_data(jfig)
        mpl.pyplot.close(fig)
        mpl.pyplot.close(jfig)

    def test_timeline_top_n_truncates(self, pcap):
        fig = TA.timeline_figure(str(pcap), top_n=2)
        assert len(fig.axes[0].get_yticklabels()) == 2
        mpl.pyplot.close(fig)

    def test_intervals_histogram_and_median(self, pcap):
        fig = TA.intervals_figure(str(pcap))
        ax = fig.axes[0]
        assert ax.patches
        assert "median 100.0 ms" in " ".join(t.get_text() for t in ax.texts)
        jfig = JA.intervals_figure(str(pcap))
        assert _axes_data(fig) == _axes_data(jfig)
        mpl.pyplot.close(fig)
        mpl.pyplot.close(jfig)

    def test_intervals_single_device_filter(self, pcap):
        fig = TA.intervals_figure(str(pcap), adv_a="0a:0b:0c:0d:0e:0f")
        assert "0a:0b:0c:0d:0e:0f" in fig.axes[0].get_title()
        mpl.pyplot.close(fig)

    def test_vendors_bars(self, pcap):
        fig = TA.vendors_figure(str(pcap))
        assert fig.axes[0].patches and "3 devices" in fig.axes[0].get_title()
        jfig = JA.vendors_figure(str(pcap))
        assert _axes_data(fig) == _axes_data(jfig)
        mpl.pyplot.close(fig)
        mpl.pyplot.close(jfig)

    def test_waterfall_figure(self):
        rng = np.random.default_rng(2)
        i, q = rng.normal(size=4096), rng.normal(size=4096)
        figs = [m.waterfall_figure(i, q, 8e6, center_hz=2.44e9, fft_size=128) for m in (TA, JA)]
        im = [f.axes[0].images[0] for f in figs]
        assert np.array_equal(im[0].get_array(), im[1].get_array())
        assert im[0].get_extent() == im[1].get_extent() and im[0].get_clim() == im[1].get_clim()
        assert _axes_data(figs[0])[0][:3] == _axes_data(figs[1])[0][:3]
        for f in figs:
            mpl.pyplot.close(f)

    def test_save_figures_writes_three(self, pcap, tmp_path):
        written = TA.save_figures(str(pcap), str(tmp_path / "out.png"))
        assert [w.rsplit("-", 1)[-1] for w in written] == [
            "timeline.png", "intervals.png", "vendors.png"]
        for w in written:
            assert (tmp_path / w.split("/")[-1]).stat().st_size > 1000
        jwritten = JA.save_figures(str(pcap), str(tmp_path / "jax.png"))
        assert [w.replace("jax", "out") for w in jwritten] == written


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main(argv) == 0
    return out.getvalue(), err.getvalue()


class TestCliPlotWiring:
    def test_analyze_plot_writes_all_figures(self, pcap, tmp_path):
        out = tmp_path / "plots.png"
        tout, terr = _run(tapp.main, ["analyze", str(pcap), "--plot", str(out)])
        assert out.exists()
        for suffix in ("timeline", "intervals", "vendors"):
            assert (tmp_path / f"plots-{suffix}.png").exists(), suffix
        jout, jerr = _run(japp.main, ["analyze", str(pcap), "--plot", str(out)])
        assert tout == jout and terr == jerr and "# plots written: " in terr
        assert "devices: 3" in tout
        assert TA.analyze_pcap(str(pcap)).summary_lines() == JA.analyze_pcap(str(pcap)).summary_lines()

    def test_analyze_without_matplotlib(self, pcap, tmp_path, monkeypatch):
        """Where matplotlib is missing (the card's machine) the plots are
        skipped, exactly as in btle_tpu, and nothing fails."""
        for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
            monkeypatch.delitem(sys.modules, name)
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        argv = ["analyze", str(pcap), "--plot", str(tmp_path / "x.png")]
        tout, terr = _run(tapp.main, argv)
        assert (tout, terr) == _run(japp.main, argv)
        assert terr == "# plots skipped (no matplotlib)\n"
        assert not (tmp_path / "x.png").exists()
        assert TA.timeline_figure(str(pcap)) is None and TA.save_figures(str(pcap), "y.png") == []


# --------------------------------------------------------------------------
# tests/test_system.py: a simulated airspace on the port
# --------------------------------------------------------------------------


def test_full_airspace_scenario():
    """Three advertisers on 37/38/39, a CONNECT_REQ and LL control and
    data traffic on hopped data channels, through the port's wideband
    follower on the CPU; the ADV traffic summarized by the port's
    quickscan, equal to btle_tpu's over its own sniffer's packets."""
    from btle_tpu.cli.aggregate import ScanAggregator as JAgg
    from btle_tpu.cli.events import PktEvent as JPkt
    from btle_tpu.cli.recon import quickscan as jquickscan
    from btle_tpu.ll import extract_adv_a as j_extract_adv_a
    from btle_tpu.wideband import WidebandConfig as JConfig
    from btle_tpu.wideband import WidebandSniffer as JSniffer

    from btle_tpu_torch.cli.aggregate import ScanAggregator
    from btle_tpu_torch.cli.events import PktEvent
    from btle_tpu_torch.cli.recon import quickscan
    from btle_tpu_torch.ll import LlCtrlOpcode, LlPduType, extract_adv_a
    from btle_tpu_torch.wideband import WidebandConfig, WidebandSniffer, synthesize_wideband
    from test_hop import CONN_AA, CONN_AA_HEX, CRC_INIT_HEX, connect_req_pdu

    def adv_ind(adv_a_hex, name, mfg=None):
        payload = list(bytes.fromhex(adv_a_hex)[::-1]) + [2, 0x01, 0x06]
        payload += [len(name) + 1, 0x09, *name]
        if mfg:
            payload += [len(mfg) + 1, 0xFF, *mfg]
        return B.bytes_to_bits(np.array([0x40, len(payload)] + payload, np.uint8))

    def burst(pdu, ch, **kw):
        return G.gfsk_modulate_float(G.assemble_phy_bits(pdu, ch, **kw), 80)

    def ll_ctrl(body):
        return B.bytes_to_bits(np.frombuffer(bytes([0x03, len(body)]) + body, np.uint8))

    block = 8192 * 20
    n = 3 * block
    wi = np.zeros(n, np.float32)
    wq = np.zeros(n, np.float32)
    devices = {37: ("aabbccddeeff", b"SensorTag", bytes([0x59, 0x00, 1, 2])),
               38: ("102030405060", b"Beacon-X", bytes([0x4C, 0x00, 0x02, 0x15])),
               39: ("0a0b0c0d0e0f", b"tpu-node", None)}
    expected = {}
    for k, (ch, (mac, name, mfg)) in enumerate(devices.items()):
        pdu = adv_ind(mac, name, mfg)
        expected[ch] = B.bits_to_bytes(pdu)
        si, sq = synthesize_wideband({ch: burst(pdu, ch)}, n, {ch: 10_000 + 30_000 * k})
        wi += si
        wq += sq
    si, sq = synthesize_wideband({37: burst(connect_req_pdu(), 37)}, n, {37: 120_000})
    wi += si
    wq += sq
    conn_kw = dict(crc_init_hex=CRC_INIT_HEX, access_address_hex=CONN_AA_HEX)
    ll_msgs = {
        9: ll_ctrl(bytes([0x0C, 7]) + (0x59).to_bytes(2, "little") + (0x1234).to_bytes(2, "little")),
        18: ll_ctrl(bytes([0x01]) + bytes.fromhex("1FFFFFFFFF")[::-1] + (6).to_bytes(2, "little")),
        27: B.bytes_to_bits(np.frombuffer(b"\x01\x05hello", np.uint8)),
    }
    for k, (ch, pdu) in enumerate(ll_msgs.items()):
        si, sq = synthesize_wideband({ch: burst(pdu, ch, **conn_kw)}, n,
                                     {ch: block + 40_000 + 60_000 * k})
        wi += si
        wq += sq

    sn = WidebandSniffer(WidebandConfig(follow_connections=True), device="cpu")
    pkts = [p for p in sn.run(wi, wq) if p.crc_ok]
    by_ch = {}
    for p in pkts:
        by_ch.setdefault(p.channel, []).append(p)
    for ch, exp in expected.items():
        assert any(np.array_equal(p.pdu_bytes, exp) for p in by_ch[ch]), ch
    assert sn.connection.access_addr == CONN_AA
    assert by_ch[9][0].payload.ctrl.opcode == LlCtrlOpcode.LL_VERSION_IND
    assert by_ch[9][0].payload.ctrl.fields["comp_id"] == 0x59
    assert by_ch[18][0].payload.ctrl.fields["instant"] == 6
    assert by_ch[27][0].header.llid == LlPduType.LL_DATA1
    assert by_ch[27][0].pdu_bytes[2:].tobytes() == b"hello"

    def summarize(pkts, agg, event, extract):
        for p in pkts:
            if p.channel not in (37, 38, 39) or p.header is None:
                continue
            adv_a = extract(p.payload, p.header.pdu_type) if p.payload else None
            agg.update(event(
                v=1, t="pkt", ts=p.sample_pos / 4e6, pkt=0, ch=p.channel, aa="8e89bed6",
                crc_ok=True, kind="adv", pdu_type=int(p.header.pdu_type),
                pdu_name=p.header.pdu_type.display_name, tx_add=p.header.tx_add,
                rx_add=p.header.rx_add, plen=p.header.payload_len,
                adv_a=":".join(f"{b:02x}" for b in adv_a) if adv_a else None,
                payload_hex=bytes(p.pdu_bytes[2:]).hex(), rssi_est=None))
        return agg

    s = quickscan(summarize(pkts, ScanAggregator(), PktEvent, extract_adv_a))
    assert s.n_devices >= 3
    assert {"SensorTag", "Beacon-X", "tpu-node"} <= {d.name for d in s.devices_top}
    vendors = {d.vendor_hint for d in s.devices_top}
    assert "Nordic Semiconductor" in vendors and "Apple" in vendors
    assert s.fingerprints_seen.get("ibeacon") == 1
    jpkts = [p for p in JSniffer(JConfig(follow_connections=True)).run(wi, wq) if p.crc_ok]
    js = jquickscan(summarize(jpkts, JAgg(), JPkt, j_extract_adv_a))
    assert s.model_dump_json(indent=2, exclude_none=True) == \
        js.model_dump_json(indent=2, exclude_none=True)
