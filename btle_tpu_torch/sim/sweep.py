"""The reference-depth BER regression sweep as one reusable routine.

Reproduces the published methodology at full statistical depth
(python/test_btle_ber.py:26-80, open_btle_baseband_chip.md:299): for each
ppm in {0, 20, 30, 50}, four SNR points ending at the ppm's anchor
(test_btle_ber.py:29-30), with 100/200/300/300 random max-length packets
per point (≈93,600 bits at the anchor). The pass criterion is the
reference's own: BER ≤ 0.1% at every anchor — not the 0.5%-slack proxy
the fast unit tests use.

Port of btle_tpu/sim/sweep.py. Entry points: ``python -m
btle_tpu_torch.tools.ber_sweep`` (command line, writes the table) and
chip_smoke.py's "ber" phase (on the card, at full depth).
"""

from __future__ import annotations

from dataclasses import dataclass

from .ber import BerHarness, reference_max_snr

ANCHOR_CRITERION = 1e-3   # open_btle_baseband_chip.md:299 ("0.1% BER")
PPMS = (0.0, 20.0, 30.0, 50.0)
# SNR offsets below the anchor and packet depth per point, mirroring the
# waterfall sampling of BER_CURVES.md / the reference harness
POINT_PLAN = ((-4.0, 100), (-2.5, 200), (-1.0, 300), (0.0, 300))


@dataclass
class SweepPoint:
    ppm: float
    snr_db: float
    is_anchor: bool
    packets: int
    ber: float
    pkts_ok: int
    bits: int

    @property
    def anchor_pass(self) -> bool:
        return (not self.is_anchor) or self.ber <= ANCHOR_CRITERION


def run_sweep(harness: BerHarness | None = None, seed: int = 11,
              progress=None, device=None) -> list[SweepPoint]:
    """Run the full 16-point sweep; ~3600 packets total. Without a
    harness, a 1M one on ``device`` (cuda unless the caller passes
    another)."""
    h = harness or BerHarness(device=device)
    points: list[SweepPoint] = []
    for ppm in PPMS:
        anchor = reference_max_snr(ppm)
        for off, n_pkts in POINT_PLAN:
            snr = anchor + off
            ber, ok, nbits = h.ber_point(snr, ppm, n_pkts, seed=seed)
            points.append(SweepPoint(ppm, snr, off == 0.0, n_pkts,
                                     float(ber), int(ok), int(nbits)))
            if progress is not None:
                progress(points[-1])
    return points


def anchors_pass(points: list[SweepPoint]) -> bool:
    return all(p.anchor_pass for p in points)


def as_markdown(points: list[SweepPoint]) -> str:
    rows = ["| ppm | SNR (dB) | packets | BER | pkts OK |",
            "|----:|---------:|--------:|---------:|--------:|"]
    for p in points:
        tag = " (anchor)" if p.is_anchor else ""
        rows.append(f"| {p.ppm:.0f} | {p.snr_db:.1f}{tag} | {p.packets} "
                    f"| {p.ber:.1e} | {p.pkts_ok}/{p.packets} |")
    return "\n".join(rows)
