"""Known-answer self-test (KAT) for the wideband pipeline on the card.

Port of btle_tpu/wideband/selftest.py. A kernel can compile, run and
return well-formed arrays that decode NOTHING (the JAX package saw it
on TPU hardware with an AA-correlation variant that was correct in
interpret mode); only a known-answer run on the attached device catches
that class of fault. ``fused_selftest()`` synthesizes a deterministic
80 Msps scene — three packets with fixed payloads on channels 37 / 17 /
39 — runs it through the configured scan and verifies that every
injected packet decodes CRC-OK with byte-exact PDU content on its
channel, and that no other channel decodes a CRC-OK packet.

The scene is built with the port's golden-model and compose_wideband
copies (the descriptor / synth TX path is not ported yet); its PDUs,
framing, placement and noise are those of the JAX package's scene.
"""

from __future__ import annotations

import numpy as np


class WidebandSelfTestError(RuntimeError):
    """The pipeline failed to reproduce the known answer."""


SELFTEST_CHANNELS = (37, 17, 39)
_N_WB = 280_000  # 3.5 ms of 80 Msps air
_WB_FS = 80      # wideband samples per microsecond


def _scene(phy: str = "1m"):
    """Deterministic packets -> (wi, wq, expected {channel: pdu bytes}):
    an ADV_NONCONN_IND (AdvA + AdvData) on each advertising channel and an
    LL data PDU (LLID 1) on data channels, all on the advertising access
    address and CRC init, 80k wideband samples apart."""
    from ..golden.model import assemble_phy_bits, gfsk_modulate_float
    from ..spec import bits as B
    from .channelizer import compose_wideband

    rng = np.random.default_rng(0xB7E)
    sps = _WB_FS // (2 if phy == "2m" else 1)
    placements, expected = [], {}
    for k, ch in enumerate(SELFTEST_CHANNELS):
        payload = rng.integers(0, 256, 10 + 2 * k, dtype=np.uint8)
        if ch in (37, 38, 39):
            # ADV_NONCONN_IND, TxAdd 0, RxAdd 0; AdvA goes on air LSB first
            body = np.concatenate([payload[:6][::-1], payload[6:]])
            pdu = np.concatenate([[0x02, len(body)], body]).astype(np.uint8)
        else:
            # LL data PDU: LLID 1, NESN 0, SN 0, MD 0
            pdu = np.concatenate([[0x01, len(payload)], payload]).astype(np.uint8)
        phy_bits = assemble_phy_bits(B.bytes_to_bits(pdu), ch, phy=phy)
        ci, cq = gfsk_modulate_float(phy_bits, sps)
        placements.append((ch, 12_000 + 80_000 * k, ci.astype(np.float32),
                           cq.astype(np.float32)))
        expected[ch] = pdu
    wi, wq = compose_wideband(placements, _N_WB)
    # light deterministic noise so bit decisions are not degenerate ties
    noise = np.random.default_rng(0xB7E)
    wi = wi + noise.normal(0.0, 0.01, _N_WB).astype(np.float32)
    wq = wq + noise.normal(0.0, 0.01, _N_WB).astype(np.float32)
    return wi, wq, expected


def fused_selftest(compute_dtype: str = "f32", tile: int | None = None,
                   inner: str | None = None, decode: str = "pallas",
                   max_candidates: int = 8, pipeline: str = "fused",
                   phy: str = "1m", cutoff_mhz: float | None = None,
                   device=None) -> dict[int, int]:
    """Run the known-answer scene through the scan pipeline and verify.

    Arguments mirror ``wideband_scan_fused``'s configuration so the test
    exercises exactly the mode about to be deployed: every
    (compute_dtype, inner) pair of ``fused.FILTERBANK_KIND``; ``tile``
    is accepted and changes nothing, as there. pipeline="xla" tests the
    plain torch path instead (the kernel arguments are then ignored).
    Runs on ``device`` (cuda unless the caller passes another). Returns
    {channel: hit position} on success; raises WidebandSelfTestError
    naming every missing/corrupt packet.
    """
    import torch

    from .._device import resolve_device
    from .channelizer import bin_to_channel, channel_to_bin
    from .fused import wideband_scan_fused
    from .sniffer import ch_sps_for_phy, cutoff_for_phy, default_scan_tables, wideband_scan

    dev = resolve_device(device)
    wi, wq, expected = _scene(phy=phy)
    aa, mask, whiten, crc, adv = default_scan_tables(dev)
    sps = ch_sps_for_phy(phy)
    if cutoff_mhz is None:
        cutoff_mhz = cutoff_for_phy(phy)
    xi = torch.as_tensor(wi, device=dev)
    xq = torch.as_tensor(wq, device=dev)
    if pipeline == "fused":
        out = wideband_scan_fused(xi, xq, aa, mask, whiten, crc, adv, sps=sps,
                                  lag=sps, max_candidates=max_candidates,
                                  tile=tile, compute_dtype=compute_dtype,
                                  inner=inner, decode=decode,
                                  cutoff_mhz=cutoff_mhz, device=dev)
    elif pipeline == "xla":
        out = wideband_scan(xi, xq, aa, mask, whiten, crc, adv, sps=sps,
                            lag=sps, max_candidates=max_candidates,
                            cutoff_mhz=cutoff_mhz, device=dev)
    else:
        raise ValueError(f"unknown pipeline {pipeline!r}")
    out = {k: v.cpu().numpy() for k, v in out.items()}

    failures, positions = [], {}
    for ch, pdu in expected.items():
        m = channel_to_bin(ch)
        ok_slots = np.flatnonzero(out["crc_ok"][m])
        matched = False
        for k in ok_slots:
            got = out["pdu_bytes"][m, k, : len(pdu)].astype(np.uint8)
            if np.array_equal(got, pdu):
                positions[ch] = int(out["pos"][m, k])
                matched = True
                break
        if not matched:
            if len(ok_slots) == 0:
                failures.append(
                    f"channel {ch}: no CRC-OK candidate "
                    f"(num_hits={int(out['num_hits'][m])})")
            else:
                failures.append(
                    f"channel {ch}: {len(ok_slots)} CRC-OK candidate(s) "
                    "but none byte-match the injected PDU")
    # any OTHER channel decoding CRC-OK would be a ghost (filterbank
    # leakage or whitening/CRC row confusion) — equally a failure
    inject_bins = {channel_to_bin(ch) for ch in expected}
    ghosts = [bin_to_channel(m) for m in range(40)
              if m not in inject_bins and out["crc_ok"][m].any()]
    if ghosts:
        failures.append(f"ghost CRC-OK packets on channels {sorted(ghosts)}")

    if failures:
        raise WidebandSelfTestError(
            f"wideband self-test FAILED (pipeline={pipeline}, "
            f"compute_dtype={compute_dtype}, inner={inner}, decode={decode}, "
            f"phy={phy}, device={dev}): " + "; ".join(failures))
    return positions
