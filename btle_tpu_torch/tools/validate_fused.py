"""Card validation: the fused kernels against the plain path on one scene.

Port of tools/validate_fused_tpu.py. One packet on each of 8 channels
(37, 0, 9, 17, 25, 36, 38, 39) in 300000 wideband samples, built as the
JAX tool builds it, goes through the port's plain scan
(``wideband.sniffer.wideband_scan``, the counterpart of the XLA path) and
through ``wideband_scan_fused`` on the card. Checks, as the tool's:

  * the exact "f32" mode is slot-exact against the plain scan on pos,
    valid, crc_ok, payload_len, len_ok and num_hits;
  * the PDU octets of every CRC-OK slot are equal over header + payload
    + CRC;
  * mag_mean of the valid slots is within rtol 0.02;
  * at least 8 CRC-OK packets;
  * the shipped "bf16x2w" mode gives the same CRC-OK packet set
    (channel bin, PDU octets).

Usage: python -m btle_tpu_torch.tools.validate_fused [--device cuda|cpu]
Exit code 0 and "RESULT: PASS" when every check holds.
"""

from __future__ import annotations

import argparse

import numpy as np

CHANNELS = (37, 0, 9, 17, 25, 36, 38, 39)
N_SAMPLES = 300_000
SLOT_KEYS = ("pos", "valid", "crc_ok", "payload_len", "len_ok", "num_hits")
MAG_RTOL = 0.02


def make_scene(seed: int = 0):
    """The tool's scene: (wi, wq) float32, one burst per channel of
    CHANNELS at 9000 + 30000 k, payloads of 8 + k bytes, noise std 0.01."""
    from ..golden import model as G
    from ..spec import bits as B
    from ..wideband import synthesize_wideband

    rng = np.random.default_rng(seed)

    def burst(ch, n_payload):
        hdr = 0x40 if ch in (37, 38, 39) else 0x01
        payload = rng.integers(0, 256, n_payload, dtype=np.uint8)
        pdu = B.bytes_to_bits(
            np.concatenate([[hdr, n_payload], payload]).astype(np.uint8))
        phy = G.assemble_phy_bits(pdu, ch)
        return G.gfsk_modulate_float(phy, 80)

    signals, offsets = {}, {}
    for k, ch in enumerate(CHANNELS):
        signals[ch] = burst(ch, 8 + k)
        offsets[ch] = 9000 + 30000 * k
    wi, wq = synthesize_wideband(signals, N_SAMPLES, offsets)
    wi += rng.normal(0, 0.01, wi.shape).astype(np.float32)
    wq += rng.normal(0, 0.01, wq.shape).astype(np.float32)
    return wi, wq


def scan_tables():
    """The tool's tables as numpy arrays: the advertising AA, an all-care
    mask, per-bin whitening, CRC init 0x555555, advertising flags."""
    from ..spec import bits as B
    from ..spec import crc24 as C
    from ..spec import whitening as W
    from ..wideband.channelizer import bin_to_channel

    aa = B.hex_to_bits("d6be898e")
    mask = np.ones(32, np.int8)
    whiten = np.stack([W.whitening_bits(bin_to_channel(m), 336) for m in range(40)])
    crc = np.full(40, C.lfsr_init_to_table_init("555555"), np.int32)
    adv = np.array([bin_to_channel(m) in (37, 38, 39) for m in range(40)])
    return aa, mask, whiten, crc, adv


def _numpy(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


def packet_set(o: dict) -> set:
    """{(channel bin, PDU octets over header + payload + CRC)} of the
    CRC-OK slots."""
    out = set()
    for m, k in np.argwhere(o["crc_ok"]):
        span = 2 + int(o["payload_len"][m, k]) + 3
        out.add((int(m), bytes(o["pdu_bytes"][m, k, :span].astype(np.uint8))))
    return out


def scans(device=None) -> dict:
    """{"reference", "f32", "bf16x2w"}: the scene's candidate dicts as
    numpy arrays, through the plain scan and both fused modes."""
    from .._device import resolve_device
    from ..wideband.fused import wideband_scan_fused
    from ..wideband.sniffer import wideband_scan

    dev = resolve_device(device)
    wi, wq = make_scene()
    args = (wi, wq, *scan_tables())
    kw = dict(sps=4, lag=4, max_candidates=16, device=dev)
    return {"reference": _numpy(wideband_scan(*args, **kw)),
            **{mode: _numpy(wideband_scan_fused(*args, compute_dtype=mode, **kw))
               for mode in ("f32", "bf16x2w")}}


def run(device=None) -> dict:
    """Every check of the module docstring: {"checks": {name: ok},
    "failures", "crc_ok", "mag_max_rel", "packets", "result"}."""
    out = scans(device)
    ref, got, prod = out["reference"], out["f32"], out["bf16x2w"]
    checks = {k: bool(np.array_equal(ref[k], got[k])) for k in SLOT_KEYS}
    checks["pdu_octets"] = all(
        np.array_equal(ref["pdu_bytes"][m, k, :5 + int(ref["payload_len"][m, k])],
                       got["pdu_bytes"][m, k, :5 + int(ref["payload_len"][m, k])])
        for m, k in np.argwhere(ref["crc_ok"]))
    n_ok = int(ref["crc_ok"].sum())
    rel = 0.0
    if checks["valid"]:
        a, b = ref["mag_mean"][ref["valid"]], got["mag_mean"][got["valid"]]
        rel = float((np.abs(a - b) / np.maximum(np.abs(a), 1e-6)).max(initial=0.0))
    checks["mag_mean"] = checks["valid"] and rel < MAG_RTOL
    checks["crc_ok_count"] = n_ok >= len(CHANNELS)
    checks["bf16x2w_packet_set"] = packet_set(prod) == packet_set(ref)
    failures = sum(not ok for ok in checks.values())
    return {"checks": checks, "failures": failures, "crc_ok": n_ok,
            "mag_max_rel": rel, "packets": len(packet_set(ref)),
            "result": "PASS" if failures == 0 else f"FAIL ({failures})"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = run(args.device)
    for name, ok in res["checks"].items():
        print(f"{'ok  ' if ok else 'FAIL'} {name}", flush=True)
    print(f"{res['crc_ok']} CRC-OK packets, mag_mean max rel diff "
          f"{res['mag_max_rel']:.2e}", flush=True)
    print("RESULT:", res["result"], flush=True)
    return 0 if res["failures"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
