"""Sensitivity at the anchor SNR of every shipped fused front-end mode.

The reduced-precision fused modes ("bf16x2w", "bf16") are held against
"f32" on high-SNR scenes by packet-set equality; noise that a
reduced-precision filterbank adds would cost packets first near the
anchor SNR. This runs tests/test_wideband_sensitivity.py's 1M scene —
25 captures, each one 30-byte packet on channel 17 at the reference's
0-ppm anchor (11 dB int8-peak SNR, wideband noise sqrt(20)x the
in-channel sigma) — through the fused scan in each mode and through the
plain scan (channelize + dense decode), and counts the packets decoded
CRC-OK and byte-exact. The JAX test's bound: at least 23 of 25; here
each fused mode must also be within 1 packet of "f32".

Usage: python -m btle_tpu_torch.tools.sensitivity [--device cuda|cpu]
One JSON line: {"trials", "decoded": {mode: n}, "plain": n}.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

MODES = ("bf16x2w", "bf16", "f32")
CHANNEL = 17
SNR_DB = 11.0


def scene(trials: int = 25, seed: int = 1):
    """[(wi, wq, expected PDU bytes)] of the JAX test's trials, in its
    order of draws."""
    from ..golden import model as G
    from ..spec import bits as B
    from ..wideband import synthesize_wideband

    rng = np.random.default_rng(seed)
    sigma80 = 127 / 10 ** (SNR_DB / 20) / np.sqrt(2) * np.sqrt(20)
    out = []
    for _ in range(trials):
        payload = rng.integers(0, 256, 30, dtype=np.uint8)
        pdu = B.bytes_to_bits(np.concatenate([[0x40, 30], payload]).astype(np.uint8))
        i80, q80 = G.gfsk_modulate_float(G.assemble_phy_bits(pdu, CHANNEL), 80)
        wi, wq = synthesize_wideband({CHANNEL: (i80, q80)}, len(i80) + 8000,
                                     {CHANNEL: 4000})
        wi = wi + rng.normal(0, sigma80, len(wi)).astype(np.float32)
        wq = wq + rng.normal(0, sigma80, len(wq)).astype(np.float32)
        out.append((wi, wq, B.bits_to_bytes(pdu)))
    return out


def _decoded(out: dict, exp: np.ndarray) -> bool:
    from ..wideband.channelizer import channel_to_bin

    m = channel_to_bin(CHANNEL)
    ok = out["crc_ok"][m].cpu().numpy()
    pdu = out["pdu_bytes"][m].cpu().numpy()
    return any(ok[k] and np.array_equal(pdu[k][: len(exp)].astype(np.uint8), exp)
               for k in range(ok.shape[0]))


def run(device=None, modes=MODES, trials: int = 25) -> dict:
    """Packets decoded per fused mode and by the plain scan, on ``device``
    (cuda unless the caller asks for another)."""
    from .._device import resolve_device
    from ..wideband.fused import wideband_scan_fused
    from ..wideband.sniffer import default_scan_tables, wideband_scan

    dev = resolve_device(device)
    aa, mask, whiten, crc, adv = default_scan_tables(dev)
    adv = torch.ones_like(adv)          # the JAX test decodes as advertising
    caps = [(torch.as_tensor(wi, device=dev), torch.as_tensor(wq, device=dev), exp)
            for wi, wq, exp in scene(trials)]
    decoded = {}
    for mode in modes:
        decoded[mode] = sum(_decoded(wideband_scan_fused(
            wi, wq, aa, mask, whiten, crc, adv, sps=4, lag=4,
            max_candidates=4, compute_dtype=mode, device=dev), exp)
            for wi, wq, exp in caps)
    plain = sum(_decoded(wideband_scan(wi, wq, aa, mask, whiten, crc, adv,
                                       max_candidates=4, device=dev), exp)
                for wi, wq, exp in caps)
    return {"trials": trials, "decoded": decoded, "plain": plain}


def check(res: dict) -> list:
    """The failures of a run() result: a mode below trials - 2, or more
    than 1 packet from "f32"."""
    bad = []
    ref = res["decoded"].get("f32", res["plain"])
    for mode, n in {**res["decoded"], "plain": res["plain"]}.items():
        if n < res["trials"] - 2 or abs(n - ref) > 1:
            bad.append(f"{mode}: {n}/{res['trials']} (f32 {ref})")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--trials", type=int, default=25)
    args = ap.parse_args(argv)
    res = run(args.device, trials=args.trials)
    print(json.dumps(res), flush=True)
    bad = check(res)
    print(f"RESULT: {'FAIL ' + '; '.join(bad) if bad else 'PASS'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
