"""Regenerate the full-depth BER table (BER_CURVES.md data) and assert
the reference anchors, on the card.

Port of tools/ber_sweep.py: the 16-point sweep of sim.sweep (4 ppms x 4
SNR points ending at each ppm's anchor, 100/200/300/300 max-length
packets a point, 3600 packets) through the batched harness. Exits
nonzero if any ppm anchor exceeds the reference 0.1% criterion.

Usage: python -m btle_tpu_torch.tools.ber_sweep [--json out.json]
       [--seed 11] [--phy 1m|2m] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def run(device=None, seed: int = 11, phy: str = "1m", progress=None) -> dict:
    """The sweep on ``device`` (cuda unless the caller asks for another):
    {"points": the JAX tool's --json records (one per point), "markdown":
    its table, "anchors_pass", "packets", "seconds" (host clock around
    the sweep, every point's counts fetched)}."""
    from ..sim.ber import BerHarness
    from ..sim.sweep import anchors_pass, as_markdown, run_sweep

    harness = BerHarness(phy=phy, device=device)
    t0 = time.perf_counter()
    points = run_sweep(harness=harness, seed=seed, progress=progress)
    seconds = time.perf_counter() - t0
    return {"points": [dataclasses.asdict(p) for p in points],
            "markdown": as_markdown(points),
            "anchors_pass": anchors_pass(points),
            "packets": sum(p.packets for p in points), "seconds": seconds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--phy", default="1m", choices=["1m", "2m"],
                    help="LE PHY framing (2m: 16-bit preamble packets; "
                         "beyond-reference — the C harness is 1M-only)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    out = run(args.device, args.seed, args.phy, progress=lambda p: print(
        f"ppm {p.ppm:4.0f}  snr {p.snr_db:5.1f}  ber {p.ber:.2e}  "
        f"ok {p.pkts_ok}/{p.packets}", file=sys.stderr))
    print(out["markdown"])
    print(f"# sweep: {out['packets']} packets in {out['seconds']:.1f}s",
          file=sys.stderr)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out["points"], f, indent=1)
    if not out["anchors_pass"]:
        bad = [(p["ppm"], p["snr_db"], p["ber"]) for p in out["points"]
               if p["is_anchor"] and p["ber"] > 1e-3]
        print(f"# FAIL: anchors above 0.1%: {bad}", file=sys.stderr)
        return 1
    print("# all anchors <= 0.1% BER (reference criterion)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
