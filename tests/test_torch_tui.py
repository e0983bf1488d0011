"""The port's multi-screen TUI (btle_tpu_torch.cli.tui) driven headless
beside the JAX package's: tests/test_tui.py case for case, plus
tests/test_analyze_figures.py::TestTuiPlotKey. Both packages' BtleTui
take the same events (each package's own PktEvent) and the same keys,
and every render must be equal, line for line (capture paths aside, as
each package writes into its own directory); the JAX test's assertions
then hold on the port's render."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from btle_tpu.cli import events as jevents
from btle_tpu.cli import tui as jtui

from btle_tpu_torch.cli import events as tevents
from btle_tpu_torch.cli import tui as ttui

PACKAGES = ((jtui, jevents), (ttui, tevents))


def _adv(ev, ts, adv_a="aa:bb:cc:dd:ee:ff", ch=37, rssi=-50, name=None, pdu_type=0):
    adva_hex = bytes.fromhex(adv_a.replace(":", ""))[::-1].hex()
    payload = adva_hex
    if name:
        nb = name.encode()
        payload += f"{len(nb) + 1:02x}09" + nb.hex()
    return ev.PktEvent(
        v=1, t="pkt", ts=ts, pkt=0, ch=ch, aa="8e89bed6", crc_ok=True,
        kind="adv", pdu_type=pdu_type, pdu_name="ADV_IND", tx_add=0,
        rx_add=0, plen=len(payload) // 2, adv_a=adv_a,
        payload_hex=payload, rssi_est=rssi)


def _stream(ev, n=6):
    evts = []
    for k in range(n):
        evts.append(_adv(ev, 1000.0 + 0.1 * k, name="Lamp"))
        evts.append(_adv(ev, 1000.05 + 0.1 * k, adv_a="11:22:33:44:55:66",
                         ch=38, rssi=-70))
    return evts


@pytest.fixture(autouse=True)
def fixed_clock(monkeypatch):
    """The capture screen shows seconds since it opened: one clock for
    both packages' screens."""
    monkeypatch.setattr(jtui.time, "time", lambda: 1000.0)


def _both(scenario, tmp_path=None):
    """scenario(tui module, events module, capture dir) for each package;
    returns the port's result after holding it equal to the JAX one's
    (the port's capture directory written as the JAX one's)."""
    outs = []
    for k, (tui, ev) in enumerate(PACKAGES):
        cap = None
        if tmp_path is not None:
            cap = tmp_path / ("jaxp", "port")[k]   # equal lengths: renders truncate
            cap.mkdir()
        out = scenario(tui, ev, cap)
        if cap is not None:
            out = _swap(out, str(cap), str(tmp_path / "jaxp"))
        outs.append(out)
    assert outs[1] == outs[0]
    return outs[1]


def _swap(obj, old, new):
    if isinstance(obj, str):
        return obj.replace(old, new)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_swap(o, old, new) for o in obj)
    return obj


class TestScanScreen:
    def test_table_and_sort_and_selection(self):
        def run(tui, ev, _):
            app = tui.BtleTui(_stream(ev))
            app.pump(999)
            lines = app.render(100, 24)
            first = app.screen.selected().adv_a
            app.key("KEY_DOWN")
            second = app.screen.selected().adv_a
            app.key("s")
            return lines, first, second, app.render(100, 24), type(app.screen).__name__
        lines, first, second, sorted_lines, screen = _both(run)
        text = "\n".join(lines)
        assert "aa:bb:cc:dd:ee:ff" in text
        assert "11:22:33:44:55:66" in text
        assert "Lamp" in text
        assert "scan" in lines[0]
        assert screen == "ScanScreen"
        assert second != first
        assert "last_seen" in sorted_lines[1]

    def test_quit_closes(self):
        def run(tui, ev, _):
            app = tui.BtleTui(_stream(ev))
            app.key("q")
            return app.quit
        assert _both(run)

    def test_esc_quits_from_root_but_pops_subscreens(self):
        def run(tui, ev, _):
            app = tui.BtleTui(_stream(ev))
            app.pump(999)
            app.key("\n")
            states = [(type(app.screen).__name__, app.quit, app.render(100, 24))]
            app.key("\x1b")
            states.append((type(app.screen).__name__, app.quit, app.render(100, 24)))
            app.key("\x1b")
            states.append((type(app.screen).__name__, app.quit))
            return states
        states = _both(run)
        assert [s[:2] for s in states] == [("DeviceDetailScreen", False),
                                           ("ScanScreen", False), ("ScanScreen", True)]


class TestAggregateMerge:
    def test_empty_name_ad_keeps_learned_name(self):
        from btle_tpu.cli.aggregate import parse_ad_structures as jparse

        from btle_tpu_torch.cli.aggregate import parse_ad_structures as tparse

        got = []
        for parse in (jparse, tparse):
            named = parse("00" * 6 + "050954657374")  # "Test"
            empty = parse("00" * 6 + "0109")
            before = (named.local_name, empty.local_name)
            named.absorb(empty)
            got.append((*before, named.local_name))
        assert got[1] == got[0] == ("Test", None, "Test")


class TestDeviceDetail:
    def test_enter_opens_detail_with_fields(self):
        def run(tui, ev, _):
            app = tui.BtleTui(_stream(ev))
            app.pump(999)
            app.key("\n")
            screen = type(app.screen).__name__
            lines = app.render(100, 30)
            app.key("\x1b")
            return screen, lines, type(app.screen).__name__
        screen, lines, back = _both(run)
        text = "\n".join(lines)
        assert screen == "DeviceDetailScreen" and back == "ScanScreen"
        assert "name=Lamp" in text
        assert "intervals(ms)" in text
        assert "ADV_IND" in text


class TestCaptureScreen:
    def test_capture_filtered_to_pcap(self, tmp_path):
        def run(tui, ev, cap):
            from btle_tpu_torch.stream.pcap import read_pcap

            app = tui.BtleTui(iter(_stream(ev, 4)), capture_dir=str(cap))
            app.pump(2)
            app.key("c")
            screen, target = type(app.screen).__name__, app.screen.filter_adva
            app.pump(999)
            lines = app.render(100, 24)
            app.key("x")
            pcaps = list(cap.glob("*.pcap"))
            recs = [bytes(r.packet) for r in read_pcap(pcaps[0])]
            return (screen, target, lines, type(app.screen).__name__,
                    [p.name for p in pcaps], recs, pcaps[0].read_bytes())
        screen, target, lines, back, names, recs, raw = _both(run, tmp_path)
        assert screen == "CaptureScreen" and back == "ScanScreen"
        assert target in ("aa:bb:cc:dd:ee:ff", "11:22:33:44:55:66")
        assert "capturing " + target in "\n".join(lines)
        assert len(names) == 1 and len(recs) >= 3
        for r in recs:
            assert r[2:8] == bytes.fromhex(target.replace(":", ""))[::-1]

    def test_capture_all_unfiltered(self, tmp_path):
        def run(tui, ev, cap):
            from btle_tpu_torch.stream.pcap import read_pcap

            evts = _stream(ev, 3)
            app = tui.BtleTui(iter(evts), capture_dir=str(cap))
            app.screen.cursor = 99
            app.key("c")
            target = app.screen.filter_adva
            app.pump(999)
            app.key("q")
            pcap = list(cap.glob("*.pcap"))[0]
            return target, len(evts), len(read_pcap(pcap)), pcap.read_bytes()
        target, n_evts, n_recs, _ = _both(run, tmp_path)
        assert target is None and n_recs == n_evts


class TestAnalyzeScreen:
    def test_summarize_captured_pcap(self, tmp_path):
        def run(tui, ev, cap):
            app = tui.BtleTui(iter(_stream(ev, 5)), capture_dir=str(cap))
            app.screen.cursor = 99
            app.key("c")
            app.pump(999)
            app.key("x")
            app.key("a")
            screen = type(app.screen).__name__
            listed = app.render(100, 30)
            app.key("\n")
            summary = app.render(100, 30)
            app.key("\x1b")
            return screen, listed, summary, type(app.screen).__name__
        screen, listed, summary, back = _both(run, tmp_path)
        assert screen == "AnalyzeScreen" and back == "ScanScreen"
        assert any(".pcap" in ln for ln in listed)
        text = "\n".join(summary)
        assert "devices" in text
        assert "aa:bb:cc:dd:ee:ff" in text


class TestHeadless:
    def test_run_headless_aggregates(self):
        def run(tui, ev, _):
            agg = tui.run_headless(_stream(ev))
            return sorted((a, r.pkt_count, r.last_rssi) for a, r in agg.devices.items())
        assert len(_both(run)) == 2


class TestSpectrumScreen:
    """The fifth screen: ASCII spectrum of the source IQ capture."""

    def _tone_file(self, tmp_path, f_hz=1e6, fs=8e6, n=65536):
        t = np.arange(n) / fs
        z = 80 * np.exp(1j * 2 * np.pi * f_hz * t)
        iq = np.empty(2 * n, np.int16)
        iq[0::2], iq[1::2] = z.real, z.imag
        path = tmp_path / "tone.bin"
        iq.tofile(path)
        return str(path)

    def test_spectrum_screen_shows_tone(self, tmp_path):
        path = self._tone_file(tmp_path)

        def run(tui, ev, _):
            app = tui.BtleTui(_stream(ev), iq_path=path, iq_format="i16",
                              sample_rate_hz=8e6)
            app.pump(99)
            app.key("w")
            screen = type(app.screen).__name__
            text = "\n".join(app.render(100, 30))
            rows = [ln for ln in app.screen.lines(100, 28) if "kHz" in ln]
            app.key("\x1b")
            return screen, text, rows, type(app.screen).__name__
        screen, text, rows, back = _both(run)
        assert screen == "SpectrumScreen" and back == "ScanScreen"
        assert "8 Msps" in text and "kHz" in text
        best = max(rows, key=lambda ln: ln.count("#"))
        f_off = float(best.split("kHz")[0].strip().split()[-1])
        assert abs(f_off - 1000) < 200
        assert "100%" in best

    def test_spectrum_without_source_reports_gracefully(self):
        def run(tui, ev, _):
            app = tui.BtleTui(_stream(ev))
            app.key("w")
            return app.render(100, 30)
        assert "no IQ source" in "\n".join(_both(run))


class TestTuiPlotKey:
    """tests/test_analyze_figures.py::TestTuiPlotKey: the analyze screen's
    ``p`` key writes the figures next to the selected pcap."""

    def test_p_key_saves_figures(self, tmp_path):
        pytest.importorskip("matplotlib")
        from btle_tpu.stream.pcap import PcapWriter

        def run(tui, ev, cap):
            w = PcapWriter(str(cap / "cap.pcap"))
            for k, adva in enumerate(("0a0b0c0d0e0f", "112233445566", "a1a2a3a4a5a6")):
                for j in range(3):
                    payload = bytes.fromhex(adva)[::-1] + bytes([2, 1, 6])
                    w.write_packet(bytes([0x40, len(payload)]) + payload, 37 + k,
                                   0x8E89BED6, -50 - j)
            w.close()
            app = tui.BtleTui(iter([]), capture_dir=str(cap))
            app.push(tui.AnalyzeScreen(app))
            app.key("p")
            return app.render(100, 30), sorted(p.name for p in cap.glob("*.png"))
        lines, pngs = _both(run, tmp_path)
        assert "wrote" in "\n".join(lines)
        assert "cap-timeline.png" in pngs


def test_tui_cli_draws_on_a_pty(tmp_path):
    """``python -m btle_tpu_torch tui --device cpu`` in a child process on
    a pseudo-terminal (chip_smoke.py's runner, which the card's "app"
    phase uses): exit 0 after --seconds, the device table drawn."""
    import chip_smoke

    from btle_tpu_torch.golden import btle_tx
    from btle_tpu_torch.spec import bits as B

    pdu = bytes.fromhex("420f" + "060504030201" + "020106" + "05094c616d70")
    i, q, _ = btle_tx(B.bytes_to_bits(np.frombuffer(pdu, np.uint8)), 37, sps=4, flavor="c")
    pad = np.zeros(4000, np.int16)
    path = tmp_path / "cap.i16"
    np.stack([np.concatenate([pad, i.astype(np.int16) * 32, pad]),
              np.concatenate([pad, q.astype(np.int16) * 32, pad])],
             axis=1).reshape(-1).tofile(path)
    rc, drawn, _ = chip_smoke.run_on_pty(["tui", "--bin", path, "--format", "i16",
                                          "--seconds", "1", "--device", "cpu"])
    assert rc == 0
    assert "AdvA" in drawn and "Pkts" in drawn and "01:02:03:04:05:06" in drawn
