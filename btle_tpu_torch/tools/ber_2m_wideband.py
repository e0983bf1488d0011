"""LE-2M wideband sensitivity table: the channelized 2M penalty, measured.

Port of tools/ber_2m_wideband.py. The narrowband BER harness shows the
GFSK demod itself is rate-invariant at fixed samples/symbol; the real 2M
cost is the channelizer: a 2 Msym/s GFSK spectrum passing a 4 Msps
channel filter. This measures packet decode counts against
int8-peak-referenced SNR for three configurations over dense
all-40-channel scenes (shipped TX composition, several noise seeds):

    1M, cutoff 1.0 MHz   (the classic channel filter — baseline)
    2M, cutoff 1.0 MHz   (the shared filter: a truncated 2M spectrum)
    2M, cutoff 1.2 MHz   (the phy-aware prototype, sniffer.CUTOFF_MHZ_2M_SENS)

Output is the BER_CURVES.md table, through the plain scan (the
channelizer, then the narrowband scan and candidate decode kernels on a
card).

Usage: python -m btle_tpu_torch.tools.ber_2m_wideband [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .dev_2m_cutoff import N_WB, build_scene, count_cell, scan

SEEDS = (0x2A, 0x2B, 0x2C)
SNRS = (-6.0, -4.0, -2.0, 0.0, 2.0)
CONFIGS = (("1m", 1.0), ("2m", 1.0), ("2m", 1.2))


def run(device=None, seeds=SEEDS, snrs=SNRS, configs=CONFIGS,
        n_wb: int = N_WB) -> dict:
    """The table on ``device`` (cuda unless the caller asks for another):
    {"snrs", "rows": {"<phy> cutoff <c> MHz": [[decoded, total] per
    SNR]}}."""
    from .._device import resolve_device

    dev = resolve_device(device)
    rows = {}
    for phy, cutoff in configs:
        cells = []
        for snr in snrs:
            ok = tot = 0
            for seed in seeds:
                wi, wq, expected = build_scene(np.random.default_rng(seed),
                                               n_wb, phy)
                peak = float(np.max(np.abs(wi)))
                sig = peak * 10 ** (-snr / 20)
                nz = np.random.default_rng(seed + 1).normal(
                    0, sig, (2, len(wi))).astype(np.float32)
                out = scan(dev, wi + nz[0], wq + nz[1], phy, cutoff)
                ok += count_cell(out, expected)[0]
                tot += len(expected)
            cells.append([ok, tot])
            print(f"{phy}@{cutoff}: {snr:+.0f} dB -> {ok}/{tot}",
                  file=sys.stderr, flush=True)
        rows[f"{phy} cutoff {cutoff} MHz"] = cells
    return {"snrs": list(snrs), "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device)
    hdr = " | ".join(f"{s:+.0f} dB" for s in out["snrs"])
    print(f"| config | {hdr} |")
    print("|---|" + "---:|" * len(out["snrs"]))
    for name, cells in out["rows"].items():
        print(f"| {name} | " + " | ".join(f"{ok}/{tot}" for ok, tot in cells)
              + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
