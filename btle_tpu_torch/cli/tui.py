"""Multi-screen terminal UI: scan -> device detail -> capture -> analyze
(+ spectrum).

Capability parity with the reference's four-screen Textual app
(host/python/btle_cli/src/btle_cli/tui/: scan.py, device_detail.py,
capture_live.py + capture_select.py, analyze.py) on the stdlib curses
module so it runs everywhere — plus a fifth spectrum screen (the
iq-show waterfall, ASCII-rendered) the reference does not have.

Architecture: every screen renders to plain text lines
(``lines(w, h) -> list[str]``) and consumes key strings
(``on_key(key)``); the ``BtleTui`` app owns a screen stack, the event
pump and the shared ScanAggregator. The curses layer only blits lines,
so the whole UI is drivable headless in tests (fake event stream + key
script, no terminal).
"""

from __future__ import annotations

import statistics
import time
from pathlib import Path
from typing import Iterable, Iterator, Optional

from .aggregate import DeviceRecord, ScanAggregator
from .events import Event, PktEvent


def _fit(s: str, n: int) -> str:
    return s[:n].ljust(n)


# ---------------------------------------------------------------- screens


class Screen:
    """One UI state. Subclasses render text lines and handle keys."""

    title = ""
    footer = "q quit"

    def __init__(self, app: "BtleTui"):
        self.app = app

    def lines(self, w: int, h: int) -> list[str]:
        return []

    def on_key(self, key: str) -> None:
        pass


class ScanScreen(Screen):
    """Device table (the reference ScanScreen): sortable, selectable."""

    title = "scan"
    footer = ("up/down select  enter detail  c capture  a analyze  "
              "w spectrum  s sort  q quit")
    SORTS = ("pkts", "last_seen", "rssi", "name")

    def __init__(self, app):
        super().__init__(app)
        self.sort_idx = 0
        self.cursor = 0

    def visible(self) -> list[DeviceRecord]:
        return self.app.agg.snapshot(sort=self.SORTS[self.sort_idx])

    def selected(self) -> Optional[DeviceRecord]:
        recs = self.visible()
        return recs[self.cursor] if 0 <= self.cursor < len(recs) else None

    def lines(self, w, h):
        agg = self.app.agg
        out = [f"{'AdvA':18} {'Name':20} {'Vendor':14} "
               f"{'Pkts':>5} {'CRC%':>5} {'RSSI':>5} Ch  (sort: "
               f"{self.SORTS[self.sort_idx]})"]
        for k, rec in enumerate(self.visible()[: h - 3]):
            rssi = str(rec.last_rssi) if rec.last_rssi is not None else "-"
            mark = ">" if k == self.cursor else " "
            out.append(
                f"{mark}{_fit(rec.adv_a, 17)} {_fit(rec.name, 20)} "
                f"{_fit(rec.vendor, 14)} {rec.pkt_count:5d} "
                f"{100 * rec.crc_ok_ratio():5.1f} {rssi:>5} "
                f"{rec.last_channel:2d}"
            )
        hop = agg.hop
        if hop.following_aa:
            out.append(f"following {hop.following_aa} ch{hop.current_ch} "
                       f"interval {hop.interval_us}us hop {hop.hop_increment}")
        return out

    def on_key(self, key):
        n = len(self.visible())
        if key == "KEY_DOWN":
            self.cursor = min(self.cursor + 1, max(0, n - 1))
        elif key == "KEY_UP":
            self.cursor = max(self.cursor - 1, 0)
        elif key == "s":
            self.sort_idx = (self.sort_idx + 1) % len(self.SORTS)
            self.cursor = 0
        elif key == "\n" and self.selected() is not None:
            self.app.push(DeviceDetailScreen(self.app, self.selected()))
        elif key == "c":
            sel = self.selected()
            self.app.push(CaptureScreen(
                self.app, filter_adva=sel.adv_a if sel else None))
        elif key == "a":
            self.app.push(AnalyzeScreen(self.app))
        elif key == "w":
            self.app.push(SpectrumScreen(self.app))


class DeviceDetailScreen(Screen):
    """Per-device drill-down (reference DeviceDetailScreen): AD fields,
    recent adverts, advert-interval statistics."""

    title = "device"
    footer = "c capture this  esc back  q quit"

    def __init__(self, app, record: DeviceRecord):
        super().__init__(app)
        self.record = record

    def lines(self, w, h):
        r = self.record
        ad = r.parsed_ad
        out = [
            f"{r.adv_a}  pkts={r.pkt_count} crc_ok={100 * r.crc_ok_ratio():.0f}% "
            f"rssi={r.last_rssi if r.last_rssi is not None else '-'}dBm "
            f"ch={r.last_channel}",
            f"name={ad.local_name or '-'}  vendor={r.vendor or '-'}  "
            f"tx_power={ad.tx_power if ad.tx_power is not None else '-'}  "
            f"flags={f'0x{ad.flags:02x}' if ad.flags is not None else '-'}",
        ]
        if ad.service_uuids_16 or ad.service_uuids_128:
            out.append("services: " + " ".join(
                ad.service_uuids_16 + ad.service_uuids_128)[: w - 11])
        if ad.manufacturer_id is not None:
            out.append(f"mfg: 0x{ad.manufacturer_id:04x} "
                       f"data={ad.manufacturer_data_hex or ''}"[: w - 1])
        iv = list(r.advert_intervals_ms)
        if iv:
            out.append(
                f"intervals(ms): mean={statistics.mean(iv):.1f} "
                f"median={statistics.median(iv):.1f} "
                f"min={min(iv):.1f} max={max(iv):.1f} n={len(iv)}")
        out.append("")
        out.append(f"{'ts':>12} {'ch':>3} {'pdu':12} {'rssi':>5}  payload")
        for e in list(r.history)[-(h - len(out) - 2):]:
            rssi = str(e.rssi_est) if e.rssi_est is not None else "-"
            out.append(f"{e.ts:12.3f} {e.ch:3d} "
                       f"{_fit(e.pdu_name or '?', 12)} {rssi:>5}  "
                       f"{e.payload_hex[: max(0, w - 40)]}")
        return out

    def on_key(self, key):
        if key == "\x1b":
            self.app.pop()
        elif key == "c":
            self.app.push(CaptureScreen(self.app,
                                        filter_adva=self.record.adv_a))


class CaptureScreen(Screen):
    """Capture-to-pcap (reference CaptureLiveScreen): streams incoming
    adv packets — optionally one device only — into a pcap file and shows
    running statistics; the reference's CaptureSelect options (target,
    output path) are constructor arguments here."""

    title = "capture"
    footer = "x stop+close pcap  esc back  q quit"

    def __init__(self, app, filter_adva: Optional[str] = None,
                 out_path: Optional[str] = None):
        super().__init__(app)
        self.filter_adva = filter_adva
        self.out_path = out_path or self._default_path()
        self.n_written = 0
        self.n_seen = 0
        self.started = time.time()
        self.log: list[str] = []
        self._writer = None
        app.capture_sinks.append(self)

    def _default_path(self) -> str:
        tag = (self.filter_adva or "all").replace(":", "")
        return str(Path(self.app.capture_dir) / f"capture_{tag}.pcap")

    def _ensure_writer(self):
        if self._writer is None:
            from ..stream.pcap import PcapWriter

            Path(self.out_path).parent.mkdir(parents=True, exist_ok=True)
            self._writer = PcapWriter(self.out_path)
        return self._writer

    def feed(self, evt: Event) -> None:
        """Called by the app's event pump for every incoming event."""
        if not isinstance(evt, PktEvent) or evt.kind != "adv":
            return
        self.n_seen += 1
        if self.filter_adva and evt.adv_a != self.filter_adva:
            return
        if evt.pdu_type is None or evt.plen is None:
            return
        hdr0 = (int(evt.pdu_type) & 0x0F) | ((evt.tx_add or 0) << 6) \
            | ((evt.rx_add or 0) << 7)
        pdu = bytes([hdr0, evt.plen]) + bytes.fromhex(evt.payload_hex)
        self._ensure_writer().write_packet(pdu, evt.ch, int(evt.aa, 16),
                                           evt.rssi_est)
        self.n_written += 1
        self.log.append(f"{evt.ts:.3f} ch{evt.ch} {evt.pdu_name or '?'} "
                        f"{evt.adv_a or ''} plen{evt.plen}")

    def close(self):
        if self in self.app.capture_sinks:
            self.app.capture_sinks.remove(self)
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def lines(self, w, h):
        target = self.filter_adva or "all devices"
        out = [
            f"capturing {target} -> {self.out_path}",
            f"{self.n_written} written / {self.n_seen} seen, "
            f"{time.time() - self.started:.1f}s",
            "",
        ]
        out.extend(self.log[-(h - 5):])
        return out

    def on_key(self, key):
        if key in ("x", "\x1b"):
            self.close()
            self.app.pop()


class AnalyzeScreen(Screen):
    """Offline analysis (reference AnalyzeScreen): list pcaps in the
    capture directory, render a quickscan summary of the selection."""

    title = "analyze"
    footer = "up/down select  enter summarize  p plots  esc back  q quit"

    def __init__(self, app, pcap: Optional[str] = None):
        super().__init__(app)
        self.cursor = 0
        self.summary: list[str] = []
        if pcap:
            self._summarize(Path(pcap))

    def pcaps(self) -> list[Path]:
        return sorted(Path(self.app.capture_dir).glob("*.pcap"))

    def _summarize(self, path: Path):
        from .recon import quickscan

        try:
            s = quickscan(str(path))
        except Exception as e:  # noqa: BLE001 — show the problem in-UI
            self.summary = [f"error reading {path.name}: {e}"]
            return
        self.summary = [
            f"{path.name}: {s.n_packets} pkts, {s.n_devices} devices, "
            f"crc_ok {100 * s.crc_ok_ratio:.0f}%, "
            f"channels {s.channels_scanned}",
        ]
        for d in s.devices_top[:10]:
            self.summary.append(
                f"  {_fit(d.adv_a, 18)} {_fit(d.name or '', 16)} "
                f"{_fit(d.vendor_hint or '', 14)} "
                f"{_fit(d.fingerprint or '', 14)} {d.n_pkts:5d}")
        if s.fingerprints_seen:
            self.summary.append("  fingerprints: " + ", ".join(
                f"{k}x{v}" for k, v in s.fingerprints_seen.items()))

    def lines(self, w, h):
        files = self.pcaps()
        out = [f"pcaps in {self.app.capture_dir}:"]
        if not files:
            out.append("  (none captured yet)")
        for k, f in enumerate(files[: max(1, h // 3)]):
            mark = ">" if k == self.cursor else " "
            out.append(f" {mark}{f.name}")
        out.append("")
        out.extend(self.summary)
        return out

    def on_key(self, key):
        files = self.pcaps()
        if key == "KEY_DOWN":
            self.cursor = min(self.cursor + 1, max(0, len(files) - 1))
        elif key == "KEY_UP":
            self.cursor = max(self.cursor - 1, 0)
        elif key == "\n" and files:
            self._summarize(files[min(self.cursor, len(files) - 1)])
        elif key == "p" and files:
            self._plots(files[min(self.cursor, len(files) - 1)])
        elif key == "\x1b":
            self.app.pop()

    def _plots(self, path: Path):
        """Write the timeline/intervals/vendors figures next to the pcap
        (the reference TUI consumes the same figure functions its CLI
        does, analyze.py:89-140 — a curses UI saves them instead)."""
        from .analyze import save_figures

        try:
            written = save_figures(str(path), str(path.with_suffix(".png")))
        except Exception as e:  # noqa: BLE001 — show the problem in-UI
            self.summary = [f"error plotting {path.name}: {e}"]
            return
        self.summary = ([f"wrote {w}" for w in written]
                        or ["plots skipped (no matplotlib)"])


class SpectrumScreen(Screen):
    """Terminal spectrum of the source IQ capture — a 5th screen beyond
    the reference TUI's four: the iq-show waterfall (utils/spectrum ≡
    water_fall.m) rendered as ASCII per-bin power bars + the occupancy
    table, for eyeballing RF activity without leaving the terminal."""

    title = "spectrum"
    footer = "r reload  esc back  q quit"
    MAX_SAMPLES = 1_000_000

    def __init__(self, app):
        super().__init__(app)
        self.error: Optional[str] = None
        self.db = None               # (fft,) mean power per bin, dB
        self.duty = None             # (fft,) fraction of columns above thr
        self.n_samples = 0
        self._load()

    def _load(self):
        import numpy as np

        from ..stream.sources import load_iq_capped
        from ..utils.spectrum import waterfall

        if not self.app.iq_path:
            self.error = "no IQ source attached (event-stream-only tui)"
            return
        try:
            i, q = load_iq_capped(self.app.iq_path, self.app.iq_format,
                                  self.MAX_SAMPLES)
            power = waterfall(i, q, fft_size=128)
            mean = power.mean(axis=1)
            self.db = 10.0 * np.log10(np.maximum(mean, 1e-30))
            floor = np.median(power)
            self.duty = (power > 10.0 * max(floor, 1e-30)).mean(axis=1)
            self.n_samples = len(i)
            self.error = None
        except Exception as e:  # noqa: BLE001 — show the problem in-UI
            self.error = f"spectrum failed: {e}"

    def lines(self, w, h):
        import numpy as np

        if self.error:
            return [self.error]
        fs = self.app.sample_rate_hz
        out = [f"{self.n_samples} samples @ {fs/1e6:g} Msps "
               f"({self.n_samples/fs*1e3:.1f} ms), 128-bin mean spectrum"]
        rows = max(4, min(h - 3, 32))
        groups = np.array_split(np.arange(len(self.db)), rows)
        db_r = np.array([self.db[g].max() for g in groups])
        duty_r = np.array([self.duty[g].max() for g in groups])
        lo, hi = float(db_r.min()), float(db_r.max())
        span = max(hi - lo, 1.0)
        bar_w = max(8, w - 30)
        for g, dbv, duty in zip(groups, db_r, duty_r):
            # group center frequency offset (bins are fftshifted)
            bin_c = (g[0] + g[-1]) / 2.0
            f_off = (bin_c - len(self.db) // 2) * fs / len(self.db)
            n = int(round((dbv - lo) / span * bar_w))
            out.append(f"{f_off/1e3:+9.0f} kHz {dbv:6.1f} dB "
                       f"|{'#' * n}{' ' * (bar_w - n)}|"
                       + (f" {100*duty:3.0f}%" if duty > 0 else ""))
        return out

    def on_key(self, key):
        if key == "r":
            self._load()
        elif key == "\x1b":
            self.app.pop()


# ---------------------------------------------------------------- app


class BtleTui:
    """Screen-stack app over an event stream (the reference BtleApp).

    Headless driving for tests: ``pump(n)`` consumes events, ``key(k)``
    dispatches a key, ``render(w, h)`` returns the visible text.
    """

    def __init__(self, event_iter: Iterable[Event],
                 capture_dir: str | None = None,
                 iq_path: str | None = None, iq_format: str = "i16",
                 sample_rate_hz: float = 4e6):
        self.agg = ScanAggregator()
        self.iq_path = iq_path
        self.iq_format = iq_format
        self.sample_rate_hz = sample_rate_hz
        self._events: Iterator[Event] = iter(event_iter)
        self.exhausted = False
        self.capture_dir = capture_dir or str(Path.home() / "btle_captures")
        self.capture_sinks: list[CaptureScreen] = []
        self.stack: list[Screen] = [ScanScreen(self)]
        self.quit = False

    # -- state machine ------------------------------------------------
    @property
    def screen(self) -> Screen:
        return self.stack[-1]

    def push(self, s: Screen):
        self.stack.append(s)

    def pop(self):
        if len(self.stack) > 1:
            self.stack.pop()

    def key(self, k: str):
        if k == "q" or (k == "\x1b" and len(self.stack) == 1):
            # ESC on the root scan screen exits like 'q' (sub-screens
            # handle ESC themselves as "back")
            for sink in list(self.capture_sinks):
                sink.close()
            self.quit = True
        else:
            self.screen.on_key(k)

    def pump(self, limit: int = 256) -> int:
        """Drain up to ``limit`` events into the aggregator + captures."""
        n = 0
        while n < limit and not self.exhausted:
            try:
                evt = next(self._events)
            except StopIteration:
                self.exhausted = True
                break
            self.agg.update(evt)
            for sink in self.capture_sinks:
                sink.feed(evt)
            n += 1
        return n

    def render(self, w: int = 100, h: int = 30) -> list[str]:
        agg = self.agg
        head = (f" btle_tpu {self.screen.title} — {len(agg.devices)} devices, "
                f"{agg.total_pkts} pkts, "
                f"{100 * agg.crc_ok_pkts / max(1, agg.total_pkts):.0f}% CRC ok")
        body = self.screen.lines(w, h - 2)
        return [head[: w]] + [ln[: w] for ln in body[: h - 2]] \
            + [f" {self.screen.footer}"[: w]]


# ---------------------------------------------------------------- curses

_KEYMAP = {10: "\n", 13: "\n", 27: "\x1b"}


def run_curses(event_iter: Iterable[Event], refresh_s: float = 0.25,
               max_seconds: float | None = None,
               capture_dir: str | None = None,
               iq_path: str | None = None, iq_format: str = "i16",
               sample_rate_hz: float = 4e6) -> ScanAggregator:
    """Blit the app under curses until quit/EOF-timeout. Returns the
    final aggregator (tests use max_seconds for auto-exit)."""
    import curses

    app = BtleTui(event_iter, capture_dir=capture_dir, iq_path=iq_path,
                  iq_format=iq_format, sample_rate_hz=sample_rate_hz)

    def loop(stdscr):
        curses.curs_set(0)
        stdscr.nodelay(True)
        stdscr.keypad(True)
        last_draw = 0.0
        t0 = time.time()
        while not app.quit:
            drained = app.pump()
            now = time.time()
            if now - last_draw >= refresh_s:
                last_draw = now
                stdscr.erase()
                h, w = stdscr.getmaxyx()
                for row, text in enumerate(app.render(w - 1, h)[:h]):
                    attr = curses.A_REVERSE if row in (0, h - 1) else (
                        curses.A_BOLD if row == 1 else 0)
                    stdscr.addnstr(row, 0, text.ljust(w - 1), w - 1, attr)
                stdscr.refresh()
            ch = stdscr.getch()
            if ch != -1:
                name = _KEYMAP.get(ch)
                if name is None:
                    import curses as _c

                    name = {_c.KEY_UP: "KEY_UP", _c.KEY_DOWN: "KEY_DOWN"}.get(
                        ch, chr(ch) if 32 <= ch < 127 else "")
                if name:
                    app.key(name)
            if app.exhausted and drained == 0:
                time.sleep(0.05)
            if max_seconds is not None and now - t0 > max_seconds:
                return

    curses.wrapper(loop)
    return app.agg


def run_headless(event_iter: Iterable[Event]) -> ScanAggregator:
    """The TUI's aggregation loop without a terminal (tests, pipelines)."""
    app = BtleTui(event_iter)
    while not app.exhausted:
        app.pump()
    return app.agg
