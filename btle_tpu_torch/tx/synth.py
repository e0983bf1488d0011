"""Batched IQ synthesis for parsed packet descriptors.

Port of btle_tpu/tx/synth.py. Replaces the reference's per-packet serial
gen_sample_from_phy_bit loop (btle_tx.c:3968-4014) with one padded,
batched modulator call: all packets of a transmission plan are
synthesized in one pass of the fixed-point modulator on the device
(``phy.modulator``, cuda unless the caller passes another) and the true
per-packet sample counts are tracked host-side. The float flavor and the
wideband composition stay numpy (the golden model and the port's
``compose_wideband`` copy).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .._device import resolve_device
from ..phy.modulator import modulate_batch, num_samples
from .descriptor import PacketSpec


@dataclass
class SynthesizedPacket:
    spec: PacketSpec
    i: np.ndarray          # int8 (fixed-point flavors) / float32 ("float")
    q: np.ndarray
    space_ms: int


def synthesize(specs: list[PacketSpec], flavor: str = "c", sps: int | None = None,
               device=None) -> list[SynthesizedPacket]:
    """Synthesize all packets with one batched modulator invocation.

    flavor "c"/"python" are the bit-exact fixed-point device modulators,
    run on ``device`` (cuda unless the caller passes another); flavor
    "float" is the golden float modulator (btlelib.gfsk_modulation, numpy),
    the only flavor valid at arbitrary sps — the fixed-point phase tables
    exist only at power-of-two sizes (sps 4/8; see golden.model fence).
    Returns numpy samples.
    """
    if not specs:
        return []
    sps = sps or (4 if flavor == "c" else 8)
    phy_bits = [s.phy_bits() for s in specs]
    if flavor == "float":
        from ..golden.model import gfsk_modulate_float

        out = []
        for s, b in zip(specs, phy_bits):
            fi, fq = gfsk_modulate_float(b, sps)
            out.append(SynthesizedPacket(
                s, fi.astype(np.float32), fq.astype(np.float32), s.space_ms))
        return out
    max_bits = max(len(b) for b in phy_bits)
    batch = np.zeros((len(specs), max_bits), dtype=np.int8)
    for k, b in enumerate(phy_bits):
        batch[k, : len(b)] = b
    import torch

    dev = resolve_device(device)
    bi, bq = modulate_batch(torch.as_tensor(batch, device=dev), flavor=flavor,
                            sps=sps)
    bi = bi.cpu().numpy()
    bq = bq.cpu().numpy()
    out = []
    for k, s in enumerate(specs):
        n = num_samples(len(phy_bits[k]), flavor=flavor, sps=sps)
        out.append(SynthesizedPacket(s, bi[k, :n].copy(), bq[k, :n].copy(), s.space_ms))
    return out


def plan_to_stream(packets: list[SynthesizedPacket], sps: int = 4,
                   num_repeat: int = 1, sym_rate_msym: int = 1
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate a transmission plan into one IQ stream with Space gaps
    (zero samples), the way tx_one_buf + the Space busy-wait would put it
    on the air (btle_tx.c:4307-4331). num_repeat=-1 is rejected here —
    streaming callers should loop themselves.

    sym_rate_msym: symbol rate in Msym/s (1 for LE 1M, 2 for LE 2M) —
    the wall-clock Space gap is the same, but at 2M it spans twice the
    samples for a given sps."""
    if num_repeat < 0:
        raise ValueError("infinite repeat cannot be materialized")
    phys = {p.spec.phy for p in packets}
    if len(phys) > 1:
        # one stream has ONE sample rate; a 1M/2M mix would concatenate
        # waveforms synthesized at different rates and mis-scale every
        # Space gap after the first PHY switch
        raise ValueError(f"plan mixes PHYs {sorted(phys)}; one stream "
                         "carries one sample rate — split the plan per PHY")
    if phys and sym_rate_msym != (2 if phys == {"2m"} else 1):
        raise ValueError(f"sym_rate_msym={sym_rate_msym} does not match "
                         f"the plan's PHY {phys.pop()!r}")
    segs_i, segs_q = [], []
    for _ in range(num_repeat):
        for p in packets:
            segs_i.append(p.i.astype(np.int16))
            segs_q.append(p.q.astype(np.int16))
            # ms -> samples at sps*sym_rate Msps
            gap = int(p.space_ms * 1000 * sps * sym_rate_msym)
            segs_i.append(np.zeros(gap, np.int16))
            segs_q.append(np.zeros(gap, np.int16))
    return np.concatenate(segs_i), np.concatenate(segs_q)


# lead-in/tail margins for composed wideband captures: the channelizer
# halo (prototype span + demod window) must fit around every burst
_WB_FS = 80            # wideband sample rate, Msps (channelizer.FS_MSPS)
_WB_LEAD = 8_000       # 100 us of quiet airspace before the first burst
_WB_TAIL = 48_000      # 600 us after the last burst (decode window + halo)


def _wb_sps(spec: PacketSpec) -> int:
    """Samples per symbol at the 80 Msps wideband rate: 80 for LE 1M,
    40 for LE 2M (2 Msym/s)."""
    return _WB_FS // (2 if spec.phy == "2m" else 1)


def _synthesize_bursts(specs: list[PacketSpec]) -> dict:
    """id(spec) -> SynthesizedPacket at the wideband rate, grouping by
    PHY so 1M and 2M packets share one scene (float flavor; the
    fixed-point phase tables don't exist at these sps)."""
    bursts: dict = {}
    for sps in sorted({_wb_sps(s) for s in specs}):
        grp = [s for s in specs if _wb_sps(s) == sps]
        for s, p in zip(grp, synthesize(grp, flavor="float", sps=sps)):
            bursts[id(s)] = p
    return bursts


def plan_to_wideband(specs: list[PacketSpec], num_repeat: int = 1,
                     amplitude: float = 1.0, noise_std: float = 0.0,
                     seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Compose a transmission plan into ONE 80 Msps wideband capture with
    every packet on its own BLE channel carrier — the TX counterpart of the
    wideband sniffer, and the closed loop `tx --wideband-out` -> `wideband`.

    The timeline is the reference transmitter's serial air schedule
    (tx_one_buf + Space busy-wait, btle_tx.c:4307-4331): packet k+1 starts
    space_ms after packet k ends — but each burst is heterodyned onto its
    descriptor's channel, so a 40-channel test scene is one file.

    Modulation is the float-flavor golden modulator at 80 samples/symbol —
    the fixed-point flavors are undefined here (their power-of-two phase
    tables don't exist at sps=80; golden.gfsk_modulate_python raises).
    amplitude scales the int8-range (+-127) bursts; noise_std adds AWGN in
    the same units. Returns float32 (i, q).
    """
    if num_repeat < 0:
        raise ValueError("infinite repeat cannot be materialized")
    bursts = _synthesize_bursts(specs)
    placed = []
    t = _WB_LEAD
    for _ in range(num_repeat):
        for s in specs:
            p = bursts[id(s)]
            placed.append((s, t))
            # the Space gap is wall-clock: 80k wb-samples per ms
            t += len(p.i) + int(p.space_ms * 1000 * _WB_FS)
    return scene_to_wideband(placed, t + _WB_TAIL, amplitude=amplitude,
                             noise_std=noise_std, seed=seed,
                             _bursts=bursts)


def scene_to_wideband(placed_specs: list, num_samples: int,
                      amplitude: float = 1.0, noise_std: float = 0.0,
                      seed: int = 0, _bursts: dict | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Compose packets at EXPLICIT wideband offsets into one 80 Msps
    capture: ``placed_specs`` is a list of (PacketSpec, offset_samples).

    This is the one scene-synthesis path shared by `plan_to_wideband`
    (serial air schedule), the deployment known-answer selftest
    (wideband.selftest) and chip_smoke.py's TX phase — the gates on the
    card exercise EXACTLY the shipped TX composition, not a private
    twin. Bursts may overlap across channels (they sum, like real
    airspace).
    """
    from ..wideband.channelizer import compose_wideband

    if _bursts is None:
        uniq = list({id(s): s for s, _ in placed_specs}.values())
        _bursts = _synthesize_bursts(uniq)
    placements = [(s.channel, off, _bursts[id(s)].i.astype(np.float32),
                   _bursts[id(s)].q.astype(np.float32))
                  for s, off in placed_specs]
    wi, wq = compose_wideband(placements, num_samples, amplitude)
    if noise_std > 0.0:
        rng = np.random.default_rng(seed)
        wi = wi + rng.normal(0.0, noise_std, num_samples).astype(np.float32)
        wq = wq + rng.normal(0.0, noise_std, num_samples).astype(np.float32)
    return wi, wq


def burst_num_samples(spec: PacketSpec) -> int:
    """Wideband sample count of one synthesized burst (float flavor at
    80 Msps) without synthesizing it — len(phy_bits)*sps + conv tail."""
    from ..golden.model import gauss_fir

    sps = _wb_sps(spec)
    return len(spec.phy_bits()) * sps + len(gauss_fir(sps)) - 1
