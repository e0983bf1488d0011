"""Batched BER sweeps: the whole Monte-Carlo batch as tensor ops on the card.

Port of btle_tpu/sim/ber.py. The reference harness
(python/test_btle_ber.py:26-80) runs 100-300 packets serially through
TX -> ppm -> AWGN -> RX per SNR point. Here a packet batch is one pass of
batched torch ops (the JAX package's vmap is the leading batch axis):
modulate, impair and decode hundreds of packets at once, with the golden
model's per-phase first-CRC-OK selection (btlelib.py:459-518) reproduced
densely (no early exit — all phases decode, a masked argmax picks the
winner).

Error accounting matches the reference (test_btle_ber.py:62-72): a packet
that decodes CRC-OK contributes zero errors; a failed packet contributes
the mismatch count over min(len(tx), len(rx)) PDU bits, or the full packet
length when no access address was found.

Noise: the JAX package draws it from jax.random keys; the port from a
``torch.Generator`` on the harness's device, seeded ``seed + 7919 *
batch_idx`` as the JAX keys are. The two streams are statistically
equal, not bit-equal, so BER points agree within Monte-Carlo spread;
``run_batch(..., noise=...)`` takes injected draws for exact parity.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from ..phy.demodulator import aa_match_counts, decisions
from ..phy.modulator import modulate_python
from ..rx.pipeline import _decode_candidate
from ..spec import bits as B
from ..spec import crc24 as C
from ..spec import whitening as W
from ..spec.constants import MAX_PDU_CRC_BITS
from .channel import apply_ppm, awgn, quantize_int16

# The reference BER packet: max-length ADV payload (test_btle_ber.py:27)
BER_PDU_HEX = "422506050403020119095344522f426c7565746f6f74682f4c6f772f456e657267791234567890"


def _first_true(x: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 where none), as
    ``jnp.argmax`` of a bool array."""
    return x.to(torch.int8).argmax(-1)


def golden_rx_dense(i, q, aa_bits, whiten, crc_init, adv_flag, sps: int):
    """Dense equivalent of btlelib.btle_rx phase selection, over a batch.

    i, q: (N,) or (B, N) int16 captures; aa_bits (32,); whiten (336,);
    crc_init: table-form init; adv_flag: bool. Returns (found, crc_ok,
    payload_len, pdu_bits (336,)) — each with the batch's leading axis —
    for the phase the reference would have selected: first CRC-OK phase,
    else the last phase with an AA hit.
    """
    one = i.ndim == 1
    if one:
        i, q = i[None], q[None]
    dev = i.device
    n_pk, n = i.shape
    bits = decisions(i, q, sps)                                   # (B, n-sps)
    counts = aa_match_counts(bits, aa_bits, torch.ones(32, dtype=torch.int8,
                                                       device=dev), sps)
    hit = counts == 32
    num_bit = int(round(n / sps)) - 1
    mhit = hit.shape[-1]

    # hp[b, p, k] = hit[b, p + k*sps] (False past the lattice)
    lat = (torch.arange(sps, device=dev)[:, None]
           + torch.arange(num_bit, device=dev) * sps)             # (sps, nb)
    hp = hit[:, lat.clamp(0, mhit - 1)] & (lat < mhit)
    found_p = hp.any(-1)                                          # (B, sps)
    pos = torch.arange(sps, device=dev) + _first_true(hp) * sps
    # golden model semantics: CRC at the clamped length, NO ADV length
    # gating (btlelib.py:477-497) — so len_ok is ignored here
    whiten = as_tensor(whiten, dev).reshape(1, -1).expand(n_pk, -1)
    crc = torch.as_tensor(crc_init, device=dev).reshape(1).expand(n_pk)
    adv = torch.as_tensor(adv_flag, device=dev).reshape(1).expand(n_pk)
    plen, crc_match, _, _, dew = _decode_candidate(pos, bits, whiten, crc,
                                                   adv, sps)
    ok_p = found_p & crc_match
    plen_p = plen.clamp(0, 37)

    any_ok = ok_p.any(-1)
    last_found = sps - 1 - _first_true(found_p.flip(-1))
    sel = torch.where(any_ok, _first_true(ok_p), last_found)[:, None]
    out = (found_p.any(-1), ok_p.gather(1, sel)[:, 0],
           plen_p.gather(1, sel)[:, 0],
           dew.gather(1, sel[..., None].expand(-1, 1, dew.shape[-1]))[:, 0])
    if one:
        return tuple(v[0] for v in out)
    return out


class BerHarness:
    """Batched Monte-Carlo BER runner (config 3 of BASELINE.json)."""

    def __init__(self, sps: int = 8, channel: int = 37, phy: str = "1m",
                 device=None):
        """sps = samples per SYMBOL (8 -> 8 Msps at 1M, 16 Msps at 2M).
        phy="2m" frames packets with the LE 2M 16-bit preamble
        (beyond-reference: the C harness is 1M-only); the GFSK math is
        rate-invariant at fixed samples/symbol, so 2M anchors match 1M
        within Monte-Carlo spread. Runs on ``device`` (cuda unless the
        caller passes another).
        """
        if phy not in ("1m", "2m"):
            raise ValueError(f"unknown phy {phy!r}")
        self.phy = phy
        self.sps = sps
        self.channel = channel
        self.device = resolve_device(device)
        self.aa_bits = torch.as_tensor(B.hex_to_bits("d6be898e"),
                                       device=self.device)
        self.whiten = torch.as_tensor(
            np.array(W.whitening_bits(channel, MAX_PDU_CRC_BITS)),
            device=self.device)
        self.crc_init = C.lfsr_init_to_table_init("555555")

    def run_batch(self, phy_bits, pdu_bits, snr_db: float, ppm: float,
                  generator: torch.Generator | None = None, noise=None):
        """One batch through TX -> ppm -> AWGN -> int16 -> RX. Returns
        (summed bit errors, CRC-OK packets) as device scalars. ``noise``
        = (ni, nq) standard-normal draws of the modulated shape replace
        the generator's."""
        phy_bits = as_tensor(phy_bits, self.device)
        pdu = as_tensor(pdu_bits, self.device)
        i8, q8 = modulate_python(phy_bits, sps=self.sps)
        i1, q1 = apply_ppm(i8, q8, ppm, self.sps)
        i2, q2 = awgn(i1, q1, snr_db, generator=generator, noise=noise)
        i3, q3 = quantize_int16(i2, q2)
        found, crc_ok, plen, dew = golden_rx_dense(
            i3, q3, self.aa_bits, self.whiten, self.crc_init, True, self.sps)
        lpdu = pdu.shape[1]
        rx_len_bits = 16 + plen.to(torch.int64) * 8
        jj = torch.arange(lpdu, device=self.device)
        mism = ((jj < rx_len_bits[:, None])
                & (dew[:, :lpdu] != pdu.to(dew.dtype))).sum(-1)
        errors = torch.where(crc_ok, 0, torch.where(found, mism, lpdu))
        return errors.sum(), crc_ok.to(torch.int32).sum()

    def make_packets(self, num_packets: int, rng: np.random.Generator):
        """Random max-length ADV packets a la test_btle_ber.py:48-49, as
        (phy bits, PDU bits) int8 tensors on the harness's device.

        Assembly (CRC24 + whitening) is batch-vectorized in NumPy — the
        byte-table CRC runs as 39 vector steps over the whole batch instead
        of a per-packet bit-LFSR loop."""
        base = B.hex_to_bits(BER_PDU_HEX)
        pdus = np.tile(base, (num_packets, 1)).astype(np.int8)
        pdus[:, 16:] = rng.integers(0, 2, (num_packets, len(base) - 16), dtype=np.int8)

        # preamble (16 symbols at 2M, by-AA-LSB alternation) + AA
        head = B.hex_to_bits("aaaad6be898e" if self.phy == "2m"
                             else "aad6be898e")
        pdu_bytes = np.packbits(pdus.astype(np.uint8), axis=1, bitorder="little")
        state = np.full(num_packets, C.lfsr_init_to_table_init("555555"), np.int64)
        table = C.CRC24_TABLE.astype(np.int64)
        for k in range(pdu_bytes.shape[1]):
            state = table[(state ^ pdu_bytes[:, k]) & 0xFF] ^ (state >> 8)
        crc_bits = ((state[:, None] >> np.arange(24)) & 1).astype(np.int8)

        body = np.concatenate([pdus, crc_bits], axis=1)
        body ^= W.whitening_bits(self.channel, body.shape[1])
        phys = np.concatenate(
            [np.tile(head, (num_packets, 1)), body], axis=1
        ).astype(np.int8)
        return (torch.as_tensor(phys, device=self.device),
                torch.as_tensor(pdus, device=self.device))

    BATCH = 100  # fixed batch width, as the JAX package's vmap width

    def ber_point(self, snr_db: float, ppm: float, num_packets: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        total_err = 0
        total_ok = 0
        nbits = 0
        remaining = num_packets
        batch_idx = 0
        while remaining > 0:
            phys, pdus = self.make_packets(self.BATCH, rng)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed + 7919 * batch_idx)
            # the whole batch always runs and counts: the extra lanes of a
            # last partial batch only improve the statistics
            n = self.BATCH
            err, ok = self.run_batch(phys, pdus, snr_db, ppm, generator=gen)
            total_err += int(err)
            total_ok += int(ok)
            nbits += n * pdus.shape[1]
            remaining -= n
            batch_idx += 1
        return total_err / nbits, total_ok, nbits

    def sweep(self, snr_list, ppm: float, num_packets: int, seed: int = 0):
        return [self.ber_point(s, ppm, num_packets, seed + k) for k, s in enumerate(snr_list)]


# reference ppm -> usable max-SNR anchors (test_btle_ber.py:29-30)
PPM_ANCHORS = np.array([0, 10, 20, 25, 30, 35, 40, 45, 50], dtype=np.float64)
SNR_ANCHORS = np.array([11, 12, 13, 14, 15, 17, 19, 21, 26], dtype=np.float64)


def reference_max_snr(ppm: float) -> float:
    return float(np.interp(abs(ppm), PPM_ANCHORS, SNR_ANCHORS))
