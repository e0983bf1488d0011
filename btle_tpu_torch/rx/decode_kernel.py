"""Candidate decode kernel: dewhiten + byte-pack + CRC per AA hit.

Port of btle_tpu/rx/pallas_decode.py. ``decode_candidates`` runs the
hand-written CUDA kernel (``csrc/decode_candidates.cu``) on CUDA tensors
and its plain twin ``decode_candidates_reference`` on CPU tensors.
``clamp_tail`` picks what a window reads past the end of the lattice:
False (the fused wideband scan) keeps the TPU kernel's semantics —
positions clamp to [0, Kb-1] and those bits read as zero; True (every
dense block decode, rx.pipeline.decode_block) clamps each window index
to [0, Kb-1] as the XLA decode, rx.pipeline._decode_candidate, does.
The two differ only for candidates whose window runs past the lattice.
"""

from __future__ import annotations

import torch

from .._build import CudaKernel
from ..spec.constants import MAX_PDU_CRC_BITS, MAX_PDU_CRC_BYTE
from .pipeline import decode_window, window_index

DECODE_CANDIDATES = CudaKernel("decode_candidates",
                               replaces="btle_tpu/rx/pallas_decode.py:68")


def decode_candidates_reference(bits, pos, whiten_rows, crc_inits, adv_flags,
                                sps: int = 4, clamp_tail: bool = False):
    """Plain twin of ``decode_candidates``: the window gather (zero-padded,
    or clamped with ``clamp_tail``), XOR whitening, then the byte packing
    and table CRC of rx.pipeline.decode_window."""
    kb = bits.shape[1]
    if clamp_tail:
        idx = window_index(pos, sps).clamp(0, kb - 1)
        raw = bits.gather(1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)
    else:
        idx = window_index(pos.clamp(0, kb - 1), sps)
        flat = idx.clamp(max=kb - 1).reshape(idx.shape[0], -1)
        raw = torch.where(idx < kb, bits.gather(1, flat).reshape(idx.shape),
                          torch.zeros((), dtype=bits.dtype, device=bits.device))
    dew = raw.to(torch.int32) ^ whiten_rows.to(torch.int32)[:, None, :]
    plen, crc_match, pkt_bytes, len_ok = decode_window(dew, crc_inits, adv_flags)
    return pkt_bytes, plen, crc_match, len_ok


def decode_candidates(bits, pos, whiten_rows, crc_inits, adv_flags,
                      sps: int = 4, clamp_tail: bool = False):
    """Decode candidate windows for all channels.

    bits: (M, Kb) int8 full-rate lattices; pos: (M, C) int32 positions;
    whiten_rows: (M, 336); crc_inits: (M,) table-form init; adv_flags (M,).
    Returns (pkt_bytes (M, C, 42) int32, plen (M, C) int32, crc_match
    (M, C) bool, len_ok (M, C) bool).
    """
    if bits.device.type == "cpu":
        return decode_candidates_reference(bits, pos, whiten_rows, crc_inits,
                                           adv_flags, sps, clamp_tail)
    dev = bits.device
    if dev.type != "cuda":
        raise ValueError(f"decode_candidates: unsupported device {dev}")
    m, kb = bits.shape
    c_slots = pos.shape[1]
    bits = bits.to(torch.int8).contiguous()
    pos = pos.to(device=dev, dtype=torch.int32).contiguous()
    whiten_rows = whiten_rows.to(device=dev, dtype=torch.int8).contiguous()
    crc_inits = crc_inits.to(device=dev, dtype=torch.int32).contiguous()
    adv_flags = adv_flags.to(device=dev, dtype=torch.uint8).contiguous()
    if (pos.shape[0] != m or tuple(whiten_rows.shape) != (m, MAX_PDU_CRC_BITS)
            or crc_inits.shape[0] != m or adv_flags.shape[0] != m):
        raise ValueError("decode_candidates: bad shapes")
    pkt_bytes = torch.empty((m, c_slots, MAX_PDU_CRC_BYTE), dtype=torch.int32,
                            device=dev)
    plen = torch.empty((m, c_slots), dtype=torch.int32, device=dev)
    match = torch.empty((m, c_slots), dtype=torch.bool, device=dev)
    len_ok = torch.empty((m, c_slots), dtype=torch.bool, device=dev)
    if m * c_slots:
        DECODE_CANDIDATES.launch(bits, pos, whiten_rows, crc_inits, adv_flags,
                                 pkt_bytes, plen, match, len_ok, m, kb,
                                 c_slots, sps, int(clamp_tail))
    return pkt_bytes, plen, match, len_ok
