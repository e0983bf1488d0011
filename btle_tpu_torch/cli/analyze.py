"""Capture analysis: summaries and optional plots from pcap files.

Equivalent of btle_cli.analyze (timeline / interval / vendor views).
Plot rendering requires matplotlib and is optional; the textual summary
always works.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field

import numpy as np

from .pcap_loader import load as load_pcap
from .recon import aggregator_from_pcap, fingerprint


@dataclass
class CaptureAnalysis:
    path: str
    n_packets: int
    duration_s: float
    channels: dict[int, int]
    pdu_types: dict[str, int]
    vendors: dict[str, int]
    devices: int
    busiest_device: str | None
    mean_interval_ms: float | None
    fingerprints: dict[str, int] = field(default_factory=dict)

    def summary_lines(self) -> list[str]:
        lines = [
            f"capture: {self.path}",
            f"packets: {self.n_packets} over {self.duration_s:.2f}s "
            f"({self.n_packets / self.duration_s:.1f}/s)" if self.duration_s
            else f"packets: {self.n_packets}",
            f"devices: {self.devices}",
        ]
        if self.busiest_device:
            lines.append(f"busiest: {self.busiest_device}")
        if self.mean_interval_ms:
            lines.append(f"mean advert interval: {self.mean_interval_ms:.1f} ms")
        lines.append("channels: " + ", ".join(
            f"ch{c}:{n}" for c, n in sorted(self.channels.items())))
        lines.append("pdu types: " + ", ".join(
            f"{t}:{n}" for t, n in sorted(self.pdu_types.items(), key=lambda x: -x[1])))
        if self.vendors:
            lines.append("vendors: " + ", ".join(
                f"{v}:{n}" for v, n in sorted(self.vendors.items(), key=lambda x: -x[1])[:8]))
        if self.fingerprints:
            lines.append("fingerprints: " + ", ".join(
                f"{t}:{n}" for t, n in self.fingerprints.items()))
        return lines


def analyze_pcap(path) -> CaptureAnalysis:
    cap = load_pcap(path)
    agg = aggregator_from_pcap(cap)
    channels = collections.Counter(p.channel for p in cap.packets)
    pdu_types = collections.Counter(p.pdu_type_name for p in cap.packets)
    vendors: collections.Counter = collections.Counter()
    fps: collections.Counter = collections.Counter()
    intervals = []
    busiest = None
    best = 0
    for rec in agg.devices.values():
        if rec.vendor:
            vendors[rec.vendor] += 1
        tag = fingerprint(rec.parsed_ad)
        if tag:
            fps[tag] += 1
        intervals.extend(rec.advert_intervals_ms)
        if rec.pkt_count > best:
            best = rec.pkt_count
            busiest = f"{rec.adv_a} ({rec.name or rec.vendor or 'unknown'}, {rec.pkt_count} pkts)"
    return CaptureAnalysis(
        path=str(path),
        n_packets=len(cap.packets),
        duration_s=cap.duration_s,
        channels=dict(channels),
        pdu_types=dict(pdu_types),
        vendors=dict(vendors),
        devices=len(agg.devices),
        busiest_device=busiest,
        mean_interval_ms=(sum(intervals) / len(intervals)) if intervals else None,
        fingerprints=dict(fps),
    )


def _plt():
    """Lazy Agg-backend matplotlib, or None when absent."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError:
        return None


def _as_capture(cap_or_path):
    return cap_or_path if hasattr(cap_or_path, "packets") else load_pcap(cap_or_path)


# Figure-returning API (reference analyze.py:89-140 returns one
# matplotlib Figure per view so the CLI and the TUI share them; same
# contract here — savefig or embed as the caller likes).

def timeline_figure(cap_or_path, top_n: int = 20):
    """Per-device activity lanes over capture time, one row per device
    (top-N by packet count), marks colored by advertising channel.
    Returns a Figure, or None when matplotlib is absent."""
    plt = _plt()
    if plt is None:
        return None
    cap = _as_capture(cap_or_path)
    by_dev: dict[str, list] = collections.defaultdict(list)
    t0 = cap.packets[0].ts if cap.packets else 0.0
    for p in cap.packets:
        if p.adv_a:
            by_dev[p.adv_a].append((p.ts - t0, p.channel))
    top = sorted(by_dev, key=lambda a: -len(by_dev[a]))[:top_n]
    fig, ax = plt.subplots(figsize=(10, max(2.5, 0.35 * len(top) + 1)))
    colors = {37: "tab:blue", 38: "tab:orange", 39: "tab:green"}
    seen_ch = set()
    for row, adv_a in enumerate(top):
        for t, ch in by_dev[adv_a]:
            label = f"ch{ch}" if ch not in seen_ch else None
            seen_ch.add(ch)
            ax.plot(t, row, "|", ms=10, color=colors.get(ch, "0.5"),
                    label=label)
    ax.set_yticks(range(len(top)))
    ax.set_yticklabels(top, family="monospace", fontsize=8)
    ax.invert_yaxis()
    ax.set_xlabel("time (s)")
    ax.set_title(f"device activity ({len(top)} of {len(by_dev)} devices)")
    if seen_ch:
        ax.legend(loc="upper right", fontsize=8)
    ax.grid(True, axis="x", alpha=0.3)
    fig.tight_layout()
    return fig


def intervals_figure(cap_or_path, adv_a: str | None = None):
    """Histogram of advertising intervals (consecutive same-device packet
    deltas under 10 s), for one device or all. Returns a Figure or None."""
    plt = _plt()
    if plt is None:
        return None
    cap = _as_capture(cap_or_path)
    by_dev: dict[str, list[float]] = collections.defaultdict(list)
    for p in cap.packets:
        if p.adv_a and (adv_a is None or p.adv_a == adv_a):
            by_dev[p.adv_a].append(p.ts)
    deltas = [1e3 * (b - a) for ts in by_dev.values()
              for a, b in zip(ts, ts[1:]) if 0 < b - a < 10.0]
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.set_xlabel("interval (ms)")
    ax.set_ylabel("count")
    ax.set_title("advertising intervals" + (f" — {adv_a}" if adv_a else ""))
    if deltas:
        ax.hist(deltas, bins=40, color="tab:blue", alpha=0.8)
        med = float(np.median(deltas))
        ax.axvline(med, color="tab:red", ls="--")
        ax.annotate(f"median {med:.1f} ms\nn={len(deltas)}",
                    xy=(0.98, 0.95), xycoords="axes fraction",
                    ha="right", va="top", fontsize=9,
                    bbox=dict(boxstyle="round", fc="white", alpha=0.8))
    else:
        ax.annotate("no repeated-device packets", xy=(0.5, 0.5),
                    xycoords="axes fraction", ha="center")
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    return fig


def vendors_figure(cap_or_path, top_n: int = 12):
    """Horizontal bars of DEVICE counts per resolved vendor (OUI or
    manufacturer AD struct, via the recon aggregator). Returns a Figure
    or None."""
    plt = _plt()
    if plt is None:
        return None
    cap = _as_capture(cap_or_path)
    agg = aggregator_from_pcap(cap)
    counts: collections.Counter = collections.Counter(
        rec.vendor or "unknown" for rec in agg.devices.values())
    top = counts.most_common(top_n)
    fig, ax = plt.subplots(figsize=(8, max(2.5, 0.4 * len(top) + 1)))
    if top:
        names = [n for n, _ in top][::-1]
        vals = [v for _, v in top][::-1]
        ax.barh(names, vals, color="tab:blue", alpha=0.85)
        ax.set_xlabel("devices")
        for i, v in enumerate(vals):
            ax.annotate(f" {v}", xy=(v, i), va="center", fontsize=9)
    else:
        ax.annotate("no devices", xy=(0.5, 0.5), xycoords="axes fraction",
                    ha="center")
    ax.set_title(f"vendors ({len(agg.devices)} devices)")
    fig.tight_layout()
    return fig


def waterfall_figure(i, q, fs_hz: float, center_hz: float | None = None,
                     fft_size: int = 256, win_len: int | None = None,
                     hop: int | None = None, power=None):
    """Sliding-FFT waterfall of an IQ capture — the reference's
    water_fall view (host/ble_fpga_ctl/water_fall.m:24-38: imagesc with
    0.1/99.9-percentile color limits, time in us rightward, frequency
    ascending).  center_hz labels the axis with absolute RF frequencies
    when given (wideband captures), offsets otherwise.  Returns a Figure
    or None when matplotlib is absent."""
    plt = _plt()
    if plt is None:
        return None
    from ..utils.spectrum import waterfall, waterfall_extent

    if power is None:  # callers with a computed matrix pass it through
        power = waterfall(i, q, fft_size=fft_size, win_len=win_len, hop=hop)
    wl = win_len or fft_size
    t0, t1, f_lo, f_hi = waterfall_extent(len(i), fs_hz, wl, hop or wl)
    if center_hz is not None:
        f_lo, f_hi = f_lo + center_hz, f_hi + center_hz
    db = 10.0 * np.log10(np.maximum(power, 1e-30))
    vmin, vmax = np.percentile(db, [0.1, 99.9])
    fig, ax = plt.subplots(figsize=(10, 5))
    im = ax.imshow(db, aspect="auto", origin="lower",
                   extent=(t0, t1, f_lo, f_hi), cmap="viridis",
                   vmin=vmin, vmax=max(vmax, vmin + 1.0))
    fig.colorbar(im, ax=ax, label="power (dB)")
    ax.set_xlabel("time (us)")
    ax.set_ylabel("freq (Hz)" if center_hz is not None
                  else "freq offset (Hz)")
    ax.set_title(f"waterfall ({len(i)} samples @ {fs_hz/1e6:g} Msps, "
                 f"fft {fft_size})")
    fig.tight_layout()
    return fig


def save_figures(path, base_png: str) -> list[str]:
    """Write the three analysis figures next to ``base_png`` as
    <stem>-timeline/-intervals/-vendors.png. Returns the written paths
    (empty when matplotlib is absent)."""
    import os

    cap = load_pcap(path)
    stem, ext = os.path.splitext(base_png)
    written = []
    for name, fig in (("timeline", timeline_figure(cap)),
                      ("intervals", intervals_figure(cap)),
                      ("vendors", vendors_figure(cap))):
        if fig is None:
            continue
        out = f"{stem}-{name}{ext or '.png'}"
        fig.savefig(out, dpi=120)
        _plt().close(fig)
        written.append(out)
    return written


def plot_capture(path, out_png: str) -> bool:
    """Timeline + channel plots. Returns False when matplotlib is absent."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    cap = load_pcap(path)
    if not cap.packets:
        return False
    t0 = cap.packets[0].ts
    ts = [p.ts - t0 for p in cap.packets]
    chans = [p.channel for p in cap.packets]
    rssi = [p.rssi_dbm for p in cap.packets]
    fig, axes = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
    axes[0].scatter(ts, chans, s=8)
    axes[0].set_ylabel("channel")
    axes[0].grid(True, alpha=0.3)
    axes[1].scatter(ts, rssi, s=8, c="tab:red")
    axes[1].set_ylabel("RSSI (dBm)")
    axes[1].set_xlabel("time (s)")
    axes[1].grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return True
