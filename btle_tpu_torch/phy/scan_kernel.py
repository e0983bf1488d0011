"""Narrowband scan kernel: decisions + 32-tap access-address correlation.

Port of btle_tpu/phy/pallas_scan.py. ``scan_block_kernel`` launches the
hand-written CUDA kernel (``csrc/scan_block.cu``) on CUDA tensors;
``scan_block_reference`` is its plain twin (phy.demodulator's
``decisions`` + ``aa_match_counts``). Both give the answer of the JAX
main path, rx.pipeline.scan_block: exact int32 products for integer IQ,
float32 products for float IQ (the Pallas kernel casts integer IQ to
float32 instead). ``rx.pipeline.scan_block`` picks one by the device of
its inputs.
"""

from __future__ import annotations

import torch

from .._build import CudaKernel
from .demodulator import AA_BITS, aa_match_counts, decisions

SCAN_BLOCK = CudaKernel("scan_block", replaces="btle_tpu/phy/pallas_scan.py:72")


def scan_block_reference(i, q, aa_bits, aa_mask, sps: int, lag: int):
    """Plain twin: (hit (C, N-lag-31*sps) bool, bits (C, N-lag) int8) of
    (C, N) IQ rows; aa_bits (32,) or (C, 32), aa_mask (32,)."""
    bits = decisions(i, q, lag)
    counts = aa_match_counts(bits, aa_bits, aa_mask, sps)
    n_mask = int(torch.as_tensor(aa_mask).to(torch.int32).sum())
    return counts == n_mask, bits


def scan_block_kernel(i, q, aa_bits, aa_mask, sps: int, lag: int):
    """The CUDA kernel on CUDA tensors; the same outputs as the twin.
    int8/uint8 IQ is widened to int16 and any float IQ cast to float32
    (as the twin does); other integer types are refused."""
    if i.ndim == 1:
        hit, bits = scan_block_kernel(i[None], q[None], aa_bits, aa_mask,
                                      sps, lag)
        return hit[0], bits[0]
    dev = i.device
    if dev.type != "cuda" or q.device != dev:
        raise ValueError(f"scan_block_kernel: needs CUDA tensors, got {dev}")
    if i.shape != q.shape:
        raise ValueError("scan_block_kernel: i and q differ in shape")
    if i.is_floating_point():
        dt, is_float = torch.float32, 1
    elif i.dtype in (torch.int16, torch.int8, torch.uint8):
        dt, is_float = torch.int16, 0
    else:
        raise ValueError(f"scan_block_kernel: IQ dtype {i.dtype} (want "
                         "int16, int8 or float)")
    rows, n = i.shape
    n_bits = n - lag
    n_hit = n_bits - (AA_BITS - 1) * sps
    if sps < 1 or lag < 1 or n_hit < 0:
        raise ValueError(f"scan_block_kernel: {n} samples are too few for "
                         f"sps {sps}, lag {lag}")
    i = i.to(dt).contiguous()
    q = q.to(dt).contiguous()
    aa = torch.as_tensor(aa_bits, device=dev).to(torch.int8)
    aa = aa.expand(rows, AA_BITS).contiguous() if aa.ndim == 1 else aa.contiguous()
    mask = torch.as_tensor(aa_mask, device=dev).to(torch.int8).contiguous()
    if tuple(aa.shape) != (rows, AA_BITS) or tuple(mask.shape) != (AA_BITS,):
        raise ValueError("scan_block_kernel: AA rows must be (32,) or "
                         "(C, 32) and the mask (32,)")
    bits = torch.empty((rows, n_bits), dtype=torch.int8, device=dev)
    hit = torch.empty((rows, n_hit), dtype=torch.bool, device=dev)
    if n_bits:
        SCAN_BLOCK.launch(i, q, aa, mask, bits, hit, rows, n, sps, lag,
                          is_float)
    return hit, bits


def scan_block_plan(rows: int, n: int, sps: int, lag: int, floats: bool) -> dict:
    """The launch shape ``scan_block_kernel`` takes for (rows, n) IQ rows
    (float32 if ``floats``, else int16): dynamic shared memory, resident
    CTAs per SM, grid, threads and positions per CTA
    (``_build.PLAN_KEYS``)."""
    return SCAN_BLOCK.plan(rows, n, sps, lag, int(floats))


def scan_block(i, q, aa_bits, aa_mask, sps: int, lag: int):
    """(hit_mask, bit_lattice) of (C, N) IQ rows (or one (N,) row):
    hit_mask[c, n] is True iff an access address starts at lattice
    position n (every unmasked AA bit matches with symbol stride sps).
    The kernel on CUDA tensors, the twin on CPU tensors."""
    if i.device.type == "cpu":
        return scan_block_reference(i, q, aa_bits, aa_mask, sps, lag)
    return scan_block_kernel(i, q, aa_bits, aa_mask, sps, lag)
