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
"""

from __future__ import annotations

import numpy as np


class WidebandSelfTestError(RuntimeError):
    """The pipeline failed to reproduce the known answer."""


SELFTEST_CHANNELS = (37, 17, 39)
_N_WB = 280_000  # 3.5 ms of 80 Msps air


def _scene(phy: str = "1m"):
    """Deterministic packets -> (wi, wq, expected {channel: pdu bytes}).

    Built through the shipped TX path — descriptor parse ->
    tx.synth.scene_to_wideband (the same composition `tx --wideband-out`
    runs) — so the gate on the card validates the code users run, not a
    private synthesis twin. Expected PDU bytes are derived from the
    parsed specs, keeping the known answer self-consistent.
    """
    from ..spec import bits as B
    from ..tx import parse_descriptor_sequence
    from ..tx.synth import scene_to_wideband

    rng = np.random.default_rng(0xB7E)
    descs = []
    for k, ch in enumerate(SELFTEST_CHANNELS):
        payload = rng.integers(0, 256, 10 + 2 * k, dtype=np.uint8)
        if ch in (37, 38, 39):
            descs.append(
                f"{ch}-ADV_NONCONN_IND-TxAdd-0-RxAdd-0"
                f"-AdvA-{bytes(payload[:6]).hex()}"
                f"-AdvData-{bytes(payload[6:]).hex()}-Space-1")
        else:
            descs.append(
                f"{ch}-LL_DATA-AA-8E89BED6-LLID-1-NESN-0-SN-0-MD-0"
                f"-DATA-{bytes(payload).hex()}-CRCInit-555555-Space-1")
    specs, _ = parse_descriptor_sequence(descs)
    if phy == "2m":
        specs = [s.to_2m() for s in specs]
    placed = [(s, 12_000 + 80_000 * k) for k, s in enumerate(specs)]
    expected = {s.channel: np.asarray(
        B.bits_to_bytes(s.info_bits[s.pdu_start:]), np.uint8)
        for s in specs}
    # light deterministic noise so bit decisions are not degenerate ties
    wi, wq = scene_to_wideband(placed, _N_WB, noise_std=0.01, seed=0xB7E)
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
