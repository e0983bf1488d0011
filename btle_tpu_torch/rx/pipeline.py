"""Dense receive pipeline: demod -> AA correlate -> dewhiten -> CRC (torch).

Port of btle_tpu/rx/pipeline.py with the channel axis written out as a
leading batch dimension: every (N,) lattice of the JAX functions is a
(C, N) tensor here and every per-channel scalar a (C,) tensor.

  1. phase-difference decisions over the full-rate lattice,
  2. access-address correlation as a 32-tap symbol-spaced filter,
  3. the earliest K hit positions (top-k over the masked iota),
  4. per-candidate gather of the max-length packet bit window, XOR
     de-whitening, byte packing,
  5. CRC24 over all 42 prefix lengths with the verdict selected at the
     data-dependent payload length.

On CUDA tensors, steps 1-2 run the narrowband scan kernel
(phy.scan_kernel) and steps 4-5 the candidate decode kernel
(rx.decode_kernel, with the XLA decode's clamped gathers); on CPU
tensors both run their plain twins.
"""

from __future__ import annotations

import numpy as np
import torch

from ..phy.scan_kernel import scan_block  # noqa: F401  (steps 1-2)
from ..spec.constants import MAX_PDU_CRC_BITS, MAX_PDU_CRC_BYTE
from ..spec.crc24 import CRC24_TABLE

AA_BITS = 32
_BIG = np.iinfo(np.int32).max // 2


def required_halo(sps: int, lag: int) -> int:
    """Samples needed beyond a hit position to decode a max-length packet."""
    return (AA_BITS + MAX_PDU_CRC_BITS) * sps + lag


def decode_window(dew: torch.Tensor, crc_init, adv_flag):
    """Length, CRC verdict and bytes of dewhitened candidate windows.

    dew: (C, K, 336) 0/1; crc_init (C,) table-form CRC init (low 24 bits
    used); adv_flag (C,) bool. Returns (plen (C, K) int32, crc_match
    bool, pkt_bytes (C, K, 42) int32, len_ok bool). ``crc_match`` is the
    raw comparison at the clamped length: the CRC state after header +
    payload (plen + 2 bytes) against the three bytes that follow.
    """
    dev = dew.device
    dew = dew.to(torch.int64)
    weights = 1 << torch.arange(8, device=dev)
    pkt_bytes = (dew.reshape(*dew.shape[:-1], MAX_PDU_CRC_BYTE, 8)
                 * weights).sum(-1)                               # (C, K, 42)
    adv = torch.as_tensor(adv_flag, device=dev).to(torch.bool)[:, None]
    plen6 = (dew[..., 8:14] * weights[:6]).sum(-1)
    plen5 = (dew[..., 8:13] * weights[:5]).sum(-1)
    plen = torch.where(adv, plen6, plen5)
    # ADV payload must be 6..37 (btle_rx.c:2293); data-channel max 31 by field width
    len_ok = torch.where(adv, (plen >= 6) & (plen <= 37), plen <= 31)
    plen_c = plen.clamp(0, 37)

    # reflected table CRC (btle_rx.c:1211-1222) over all 42 prefixes
    table = torch.as_tensor(CRC24_TABLE.astype(np.int64), device=dev)
    init = torch.as_tensor(crc_init, device=dev).to(torch.int64) & 0xFFFFFF
    crc = init[:, None].expand(pkt_bytes.shape[:-1])
    states = []
    for b in range(MAX_PDU_CRC_BYTE):
        crc = table[(crc ^ pkt_bytes[..., b]) & 0xFF] ^ (crc >> 8)
        states.append(crc)
    states = torch.stack(states, -1)             # states[k] = CRC after bytes 0..k
    crc_state = states.gather(-1, (plen_c + 1)[..., None])[..., 0]
    rcv = [pkt_bytes.gather(-1, (plen_c + k)[..., None])[..., 0]
           for k in (2, 3, 4)]
    crc_rcv = rcv[0] + rcv[1] * 256 + rcv[2] * 65536
    return (plen.to(torch.int32), crc_state == crc_rcv,
            pkt_bytes.to(torch.int32), len_ok)


def window_index(pos: torch.Tensor, sps: int) -> torch.Tensor:
    """Lattice index of each of the 336 window bits of every candidate:
    pos + 32*sps + k*sps."""
    k = torch.arange(MAX_PDU_CRC_BITS, device=pos.device) * sps
    return pos.to(torch.int64)[..., None] + AA_BITS * sps + k


def _decode_candidate(pos, bits, whiten, crc_init, adv_flag, sps: int):
    """Decode candidate AA hits at lattice positions ``pos`` (C, K) of
    ``bits`` (C, N). Gathers clamp to the last lattice element, as the
    XLA path does. Returns (plen, crc_match, pdu_bytes (C, K, 42),
    len_ok, dew (C, K, 336))."""
    idx = window_index(pos, sps).clamp(0, bits.shape[-1] - 1)
    raw = bits.gather(1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)
    dew = raw.to(torch.int32) ^ whiten.to(torch.int32)[:, None, :]
    plen, crc_match, pkt_bytes, len_ok = decode_window(dew, crc_init, adv_flag)
    return plen, crc_match, pkt_bytes, len_ok, dew


def earliest_hits(hit: torch.Tensor, max_candidates: int, min_pos=0):
    """Earliest ``max_candidates`` hit positions of (C, N) hit lattices, in
    stream order, ignoring positions before ``min_pos`` (int or (C,)).

    Returns (pos (C, K) int32, valid (C, K) bool, num_hits (C,) int32);
    pos is 0 where no hit was found.
    """
    npos = hit.shape[-1]
    iota = torch.arange(npos, dtype=torch.int32, device=hit.device)
    if isinstance(min_pos, torch.Tensor):
        min_pos = min_pos.to(device=hit.device, dtype=torch.int32).reshape(-1, 1)
    hit = hit & (iota >= min_pos)
    masked = torch.where(hit, iota, torch.full_like(iota, _BIG))
    k = min(max_candidates, npos)
    top = torch.topk(masked, k, dim=-1, largest=False, sorted=True).values
    if k < max_candidates:
        top = torch.nn.functional.pad(top, (0, max_candidates - k), value=_BIG)
    valid = top < _BIG
    pos = torch.where(valid, top, torch.zeros_like(top))
    return pos, valid, hit.to(torch.int32).sum(-1, dtype=torch.int32)


def decode_from_lattice(hit, bits, mag_win, whiten, crc_init, adv_flag,
                        sps: int, max_candidates: int = 16, min_pos=0):
    """Candidate selection + CRC decode over precomputed (C, N) lattices
    and per-position RSSI window means. Output dict matches decode_block."""
    pos, valid, num_hits = earliest_hits(hit, max_candidates, min_pos)
    plen, crc_match, pkt_bytes, len_ok, _ = _decode_candidate(
        pos, bits, whiten, crc_init, adv_flag, sps)
    mag_mean = mag_win.gather(
        1, pos.to(torch.int64).clamp(0, mag_win.shape[-1] - 1))
    return {
        "pos": pos,
        "valid": valid,
        "payload_len": plen,
        "len_ok": len_ok,
        "crc_ok": crc_match & len_ok & valid,
        "pdu_bytes": pkt_bytes,
        "mag_mean": mag_mean,
        "num_hits": num_hits,
    }


def decode_block(i, q, aa_bits, aa_mask, whiten, crc_init, adv_flag,
                 sps: int, lag: int, max_candidates: int = 16,
                 with_mag: bool = True, min_pos=0):
    """Fully dense block decode of (C, N) IQ blocks. Returns a dict of
    per-candidate arrays (earliest ``max_candidates`` AA hits per
    channel) plus the total hit count.

    aa_bits (32,) or (C, 32) over-the-air access-address bits; aa_mask
    (32,) per-bit care mask; whiten (C, 336); crc_init (C,) table-form;
    adv_flag (C,) advertising (6-bit length) vs data channel.
    """
    from .decode_kernel import decode_candidates

    hit, bits = scan_block(i, q, aa_bits, aa_mask, sps, lag)
    pos, valid, num_hits = earliest_hits(hit, max_candidates, min_pos)
    decoded = decode_candidates(
        bits, pos, whiten, crc_init, adv_flag, sps=sps, clamp_tail=True)
    return block_candidates(i, q, pos, valid, num_hits, decoded, sps, with_mag)


def block_candidates(i, q, pos, valid, num_hits, decoded, sps: int,
                     with_mag: bool = True) -> dict:
    """decode_block's output dict from its candidate positions and the
    candidate decode's (pdu_bytes, payload_len, crc_match, len_ok)."""
    pkt_bytes, plen, crc_match, len_ok = decoded
    # RSSI statistic: mean(|I|+|Q|) over the 32-symbol AA window
    # (btle_rx.c:2234-2252), over integer samples as the XLA path takes
    # it (float channel samples truncate toward zero)
    if with_mag:
        win = AA_BITS * sps
        mag = i.to(torch.int32).abs() + q.to(torch.int32).abs()
        cmag = torch.nn.functional.pad(
            torch.cumsum(mag, -1, dtype=torch.int32), (1, 0))
        p64 = pos.to(torch.int64)
        upper = (p64 + win).clamp(0, mag.shape[-1])
        mag_mean = ((cmag.gather(1, upper) - cmag.gather(1, p64))
                    .to(torch.float32) / win)
    else:
        mag_mean = torch.zeros(pos.shape, dtype=torch.float32, device=pos.device)

    return {
        "pos": pos,
        "valid": valid,
        "payload_len": plen,
        "len_ok": len_ok,
        "crc_ok": crc_match & len_ok & valid,
        "pdu_bytes": pkt_bytes,
        "mag_mean": mag_mean,
        "num_hits": num_hits,
    }


PACK_KEYS = ("pos", "valid", "payload_len", "len_ok", "crc_ok", "pdu_bytes",
             "mag_mean", "num_hits")


def pack_candidates(out: dict):
    """Flatten a candidate dict into ONE int32 vector on its device (floats
    ride as bit patterns), so a block costs one device-to-host copy.
    Returns (packed, {key: (shape, numpy dtype)})."""
    segs, layout = [], {}
    for k in PACK_KEYS:
        v = out[k]
        layout[k] = (tuple(v.shape), np.float32 if v.dtype == torch.float32
                     else np.bool_ if v.dtype == torch.bool else np.int32)
        v32 = (v.view(torch.int32) if v.dtype == torch.float32
               else v.to(torch.int32))
        segs.append(v32.reshape(-1))
    return torch.cat(segs), layout


def unpack_candidates(buf: np.ndarray, layout: dict) -> dict:
    """Inverse of pack_candidates on the host copy: {key: numpy array}."""
    out, off = {}, 0
    for k, (shape, dtype) in layout.items():
        n = int(np.prod(shape))
        v = buf[off: off + n].reshape(shape)
        if dtype == np.float32:
            v = v.view(np.float32)
        elif dtype == np.bool_:
            v = v.astype(bool)
        out[k] = v
        off += n
    return out


def rssi_dbm_from_mag(mag_mean: float) -> int:
    """Reference RSSI mapping (btle_rx.c:2246-2251)."""
    mean = max(float(mag_mean), 1.0)
    v = int(20.0 * np.log10(mean / 256.0) - 50.0)
    return max(-127, min(20, v))
