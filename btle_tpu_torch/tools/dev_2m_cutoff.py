"""Dev sweep: pick the LE-2M channel-filter passband (prototype cutoff).

Port of tools/dev_2m_cutoff.py. The 2 Msym/s GFSK spectrum extends past
the classic +-1 MHz half-channel cutoff, so the shared 1M prototype
truncates the 2M signal; wider passbands recover signal energy but admit
decimation aliasing (folds start at 4 - cutoff MHz) and adjacent-channel
leakage. This sweeps cutoff x SNR over a dense all-40-channel 2M scene
(shipped TX composition) and reports byte-exact decode counts and ghost
CRC-OK packets per cell — the filter-design evidence behind
sniffer.CUTOFF_MHZ_2M_SENS. It runs the plain scan (wideband_scan: the
channelizer, then the narrowband scan and candidate decode kernels on a
card).

Usage: python -m btle_tpu_torch.tools.dev_2m_cutoff [--1m]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

N_WB = 12_000 + 55_000 * 40 + 60_000
SNRS = (-4.0, -2.0, 0.0, 2.0, 4.0, 8.0)
CUTOFFS = (1.0, 1.1, 1.2, 1.3, 1.4, 1.5)


def build_scene(rng, n_wb, phy="2m"):
    """~40 packets, one per channel, random payloads, explicit offsets."""
    from ..spec import bits as B
    from ..tx import parse_descriptor
    from ..tx.synth import scene_to_wideband

    placed, expected = [], {}
    for k, ch in enumerate(range(40)):
        payload = rng.integers(0, 256, 8 + (k % 12), dtype=np.uint8)
        if ch in (37, 38, 39):
            d = (f"{ch}-ADV_NONCONN_IND-TxAdd-0-RxAdd-0"
                 f"-AdvA-{bytes(payload[:6]).hex()}"
                 f"-AdvData-{bytes(payload[6:]).hex()}-Space-1")
        else:
            d = (f"{ch}-LL_DATA-AA-8E89BED6-LLID-1-NESN-0-SN-0-MD-0"
                 f"-DATA-{bytes(payload).hex()}-CRCInit-555555-Space-1")
        spec = parse_descriptor(d)
        if phy == "2m":
            spec = spec.to_2m()
        placed.append((spec, 12_000 + 55_000 * k))
        expected[ch] = np.asarray(
            B.bits_to_bytes(spec.info_bits[spec.pdu_start:]), np.uint8)
    wi, wq = scene_to_wideband(placed, n_wb, noise_std=0.0)
    return wi, wq, expected


def count_cell(out: dict, expected: dict) -> tuple[int, int]:
    """(expected packets decoded byte-exact, CRC-OK packets that are not
    their channel's) of one scan's candidate arrays (numpy)."""
    from ..wideband.channelizer import bin_to_channel, channel_to_bin

    n_ok = ghosts = 0
    for ch, pdu in expected.items():
        m = channel_to_bin(ch)
        n_ok += any(np.array_equal(
            out["pdu_bytes"][m, k, : len(pdu)].astype(np.uint8), pdu)
            for k in np.flatnonzero(out["crc_ok"][m]))
    for m in range(40):
        pdu = expected.get(bin_to_channel(m))
        for k in np.flatnonzero(out["crc_ok"][m]):
            if pdu is None or not np.array_equal(
                    out["pdu_bytes"][m, k, : len(pdu)].astype(np.uint8), pdu):
                ghosts += 1
    return n_ok, ghosts


def scan(dev, wi, wq, phy: str, cutoff: float) -> dict:
    """One plain wideband scan of the capture (8 candidate slots, lag =
    sps) -> its candidate arrays as numpy."""
    from ..wideband.sniffer import ch_sps_for_phy, default_scan_tables, wideband_scan

    sps = ch_sps_for_phy(phy)
    out = wideband_scan(wi, wq, *default_scan_tables(dev), sps=sps, lag=sps,
                        max_candidates=8, cutoff_mhz=cutoff, device=dev)
    return {k: v.cpu().numpy() for k, v in out.items()}


def run(device=None, phy: str = "2m", snrs=SNRS, cutoffs=CUTOFFS,
        n_wb: int = N_WB) -> dict:
    """The cutoff x SNR table on ``device`` (cuda unless the caller asks
    for another): {"phy", "snrs", "rows": {cutoff: [[decoded, ghosts] per
    SNR]}, "expected": packets in the scene}."""
    from .._device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(0x2A)
    wi, wq, expected = build_scene(rng, n_wb, phy)
    # int8-peak-referenced SNR like the JAX tool's: the C-flavor bursts
    # are int8-scale, so sigma = peak * 10^(-snr/20)
    peak = float(np.max(np.abs(wi)))
    noise = np.random.default_rng(1).normal(
        0, 1.0, (2, len(wi))).astype(np.float32)
    rows = {}
    for cutoff in cutoffs:
        rows[cutoff] = []
        for snr in snrs:
            sig = peak * 10 ** (-snr / 20)
            out = scan(dev, wi + sig * noise[0], wq + sig * noise[1], phy,
                       cutoff)
            rows[cutoff].append(list(count_cell(out, expected)))
    return {"phy": phy, "snrs": list(snrs), "rows": rows,
            "expected": len(expected)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--1m", dest="one_m", action="store_true",
                    help="sweep the LE 1M scene instead of 2M")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device, "1m" if args.one_m else "2m")
    print(f"phy={out['phy']}  cells: decoded/{out['expected']} "
          "(ghost CRC-OK pkts)", flush=True)
    print("cutoff  " + "  ".join(f"{s:>5.0f}dB" for s in out["snrs"]))
    for cutoff, cells in out["rows"].items():
        print(f"{cutoff:5.1f}  " + "  ".join(
            f"{f'{ok:3d}({gh})':>7s}" for ok, gh in cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
