"""Viterbi decoder for the LE Coded PHY FEC (rate 1/2, K=4, 8 states).

Port of btle_tpu/phy/viterbi.py. The state is the last three input bits
(newest in bit 0), so the transition ``s' = ((s << 1) | x) & 7`` makes
the consumed input ``s' & 1`` and a traceback needs only the winning
predecessor of each (step, state).

Soft inputs: per-position metrics (la, lb) for the (a, b) FEC bit pair,
positive = bit 1 (pattern_demap_soft feeds these; hard bits enter as
+-1). TERM bits guarantee end state 0 (exact termination).

``viterbi_decode`` (radix-1, masked by ``n_valid``) and
``fec_decode_bits`` are plain torch: no scan path runs them. The JAX
package's ``viterbi_decode_r2`` is a ``lax.scan`` that XLA keeps on the
device; a PyTorch loop of it would be ~1000 host-driven launches a call,
so on a card it is one hand-written CUDA kernel (``csrc/viterbi.cu``,
V1) over a batch of trellises, and ``viterbi_decode_r2_reference`` its
plain twin. Every function takes a leading batch axis (the JAX package
vmaps over candidates) or none.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .._build import CudaKernel
from .._device import as_tensor, resolve_device
from ..spec.coded import FEC_G0, FEC_G1, FEC_K

N_STATES = 1 << (FEC_K - 1)

VITERBI_R2 = CudaKernel("viterbi_r2", replaces="btle_tpu/phy/viterbi.py:138")


def _output_tables():
    """A[s, x], B[s, x] in {+1,-1}: encoder outputs for input x at state s
    (sign convention: +1 = FEC bit 1)."""
    a = np.zeros((N_STATES, 2), np.float32)
    b = np.zeros((N_STATES, 2), np.float32)
    for s in range(N_STATES):
        for x in range(2):
            reg = (x, s & 1, (s >> 1) & 1, (s >> 2) & 1)
            a[s, x] = 2 * (sum(g & r for g, r in zip(FEC_G0, reg)) & 1) - 1
            b[s, x] = 2 * (sum(g & r for g, r in zip(FEC_G1, reg)) & 1) - 1
    return a, b


_A, _B = _output_tables()
# predecessors of next-state ns: s in {ns>>1, (ns>>1)|4}, input x = ns&1
_PRED0 = np.arange(N_STATES) >> 1
_PRED1 = (np.arange(N_STATES) >> 1) | (N_STATES >> 1)
_XIN = np.arange(N_STATES) & 1


def _radix2_tables():
    """Transition tables for the two-steps-per-iteration trellis.

    For next-state ns (after TWO inputs) there are 4 predecessor paths
    j in 0..3: PRED2[ns, j] = s_k, and the consumed inputs are fixed by
    ns (x2 = ns&1, x1 = (ns>>1)&1). Output-sign tables for the four
    branch symbols (a1 b1 a2 b2) are precomputed per (ns, j)."""
    pred = np.zeros((N_STATES, 4), np.int32)
    a1 = np.zeros((N_STATES, 4), np.float32)
    b1 = np.zeros((N_STATES, 4), np.float32)
    a2 = np.zeros((N_STATES, 4), np.float32)
    b2 = np.zeros((N_STATES, 4), np.float32)
    for ns in range(N_STATES):
        x2 = ns & 1
        x1 = (ns >> 1) & 1
        j = 0
        for s_k in range(N_STATES):
            s_mid = ((s_k << 1) | x1) & (N_STATES - 1)
            if ((s_mid << 1) | x2) & (N_STATES - 1) != ns:
                continue
            pred[ns, j] = s_k
            a1[ns, j] = _A[s_k, x1]
            b1[ns, j] = _B[s_k, x1]
            a2[ns, j] = _A[s_mid, x2]
            b2[ns, j] = _B[s_mid, x2]
            j += 1
        assert j == 4
    return pred, a1, b1, a2, b2


_P2, _A1, _B1, _A2, _B2 = _radix2_tables()
NEG = -1e30                    # initial metric of every state but 0


def _rows(la, lb):
    """Soft inputs -> float32 (B, N) tensors on la's device (a 1-D input
    is one row), and whether the input was 1-D."""
    la = la if isinstance(la, torch.Tensor) else torch.as_tensor(np.asarray(la))
    lb = lb if isinstance(lb, torch.Tensor) else torch.as_tensor(np.asarray(lb))
    one = la.ndim == 1
    la = la.to(torch.float32).reshape(-1, la.shape[-1])
    lb = lb.to(device=la.device, dtype=torch.float32).reshape(-1, lb.shape[-1])
    return la, lb, one


def viterbi_decode(la, lb, n_valid):
    """Soft-decision Viterbi over a masked max-length trellis (plain torch).

    la, lb: (N,) or (B, N) float metrics for the a/b FEC bits (positive =
    1); n_valid: the number of real steps (int or (B,)), the rest mask.
    Returns (bits int8 of la's shape, path metric of state 0: a scalar or
    (B,)) — bits beyond n_valid are 0; the path ends in state 0
    (TERM-flushed). Ties keep the first predecessor, as the JAX
    ``take1 = c1 > c0`` does.
    """
    la, lb, one = _rows(la, lb)
    dev = la.device
    n_rows, n = la.shape
    nv = torch.as_tensor(n_valid, device=dev).reshape(-1, 1)
    valid = torch.arange(n, device=dev) < nv                      # (B, N)
    valid = valid.expand(n_rows, n)
    p0 = torch.as_tensor(_PRED0, device=dev)
    p1 = torch.as_tensor(_PRED1, device=dev)
    xin = torch.as_tensor(_XIN, device=dev)
    a, b = torch.as_tensor(_A, device=dev), torch.as_tensor(_B, device=dev)
    a0, b0, a1, b1 = a[p0, xin], b[p0, xin], a[p1, xin], b[p1, xin]

    pm = torch.full((n_rows, N_STATES), NEG, dtype=torch.float32, device=dev)
    pm[:, 0] = 0.0
    decs = torch.zeros((n_rows, n, N_STATES), dtype=torch.bool, device=dev)
    for t in range(n):
        la_t, lb_t = la[:, t: t + 1], lb[:, t: t + 1]
        c0 = pm[:, p0] + (a0 * la_t + b0 * lb_t)
        c1 = pm[:, p1] + (a1 * la_t + b1 * lb_t)
        take1 = c1 > c0
        v = valid[:, t: t + 1]
        pm = torch.where(v, torch.where(take1, c1, c0), pm)
        decs[:, t] = take1 & v

    bits = torch.zeros((n_rows, n), dtype=torch.int8, device=dev)
    state = torch.zeros(n_rows, dtype=torch.int64, device=dev)
    for t in range(n - 1, -1, -1):
        v = valid[:, t]
        d = decs[:, t].gather(1, state[:, None])[:, 0]
        bits[:, t] = torch.where(v, state & 1, 0).to(torch.int8)
        pred = torch.where(d, (state >> 1) | (N_STATES >> 1), state >> 1)
        state = torch.where(v, pred, state)
    if one:
        return bits[0], pm[0, 0]
    return bits, pm[:, 0]


@lru_cache(maxsize=None)
def _r2_tables(device: torch.device):
    """(pred (8, 4) int32, signs (8, 4, 4) float32: A1, B1, A2, B2 of each
    (next state, predecessor j)) on ``device``, made once per device and
    never written."""
    signs = np.stack([_A1, _B1, _A2, _B2], axis=-1)
    return (torch.as_tensor(_P2, device=device),
            torch.as_tensor(np.ascontiguousarray(signs), device=device))


def viterbi_decode_r2_reference(la: torch.Tensor, lb: torch.Tensor):
    """Plain twin of the V1 kernel: (B, n) float32 soft inputs, n even ->
    (bits (B, n) int8, pm_end[0] (B,) float32).

    Each iteration takes two trellis steps: for next state ns the four
    candidates are pm[P2[ns, j]] + (((A1*la0 + B1*lb0) + A2*la1) + B2*lb1)
    (the JAX package's order; the +-1 products are exact) and the first
    maximal j wins, as ``jnp.argmax`` picks it. The traceback starts from
    state 0 and emits (x1, x2) = ((s >> 1) & 1, s & 1) per iteration.
    """
    dev = la.device
    n_rows, n = la.shape
    pred, signs = _r2_tables(dev)
    pred = pred.to(torch.int64)
    a1, b1, a2, b2 = signs.unbind(-1)                              # (8, 4)
    la2 = la.reshape(n_rows, n // 2, 2)
    lb2 = lb.reshape(n_rows, n // 2, 2)
    pm = torch.full((n_rows, N_STATES), NEG, dtype=torch.float32, device=dev)
    pm[:, 0] = 0.0
    win = torch.empty((n_rows, n // 2, N_STATES), dtype=torch.int64, device=dev)
    for t in range(n // 2):
        la0, la1 = la2[:, t, 0, None, None], la2[:, t, 1, None, None]
        lb0, lb1 = lb2[:, t, 0, None, None], lb2[:, t, 1, None, None]
        cand = pm[:, pred] + (a1 * la0 + b1 * lb0 + a2 * la1 + b2 * lb1)
        best, bp = cand[..., 0], pred[:, 0].expand(n_rows, N_STATES)
        for j in range(1, 4):
            take = cand[..., j] > best
            best = torch.where(take, cand[..., j], best)
            bp = torch.where(take, pred[:, j], bp)
        pm = best
        win[:, t] = bp

    bits = torch.empty((n_rows, n // 2, 2), dtype=torch.int8, device=dev)
    state = torch.zeros((n_rows, 1), dtype=torch.int64, device=dev)
    for t in range(n // 2 - 1, -1, -1):
        bits[:, t, 0] = ((state[:, 0] >> 1) & 1).to(torch.int8)
        bits[:, t, 1] = (state[:, 0] & 1).to(torch.int8)
        state = win[:, t].gather(1, state)
    return bits.reshape(n_rows, n), pm[:, 0]


def viterbi_r2_kernel(la: torch.Tensor, lb: torch.Tensor):
    """V1 on the card: (B, n) float32 CUDA soft inputs -> (bits (B, n)
    int8, pm_end[0] (B,) float32), one warp per trellis."""
    dev = la.device
    if dev.type != "cuda" or lb.device != dev:
        raise ValueError("viterbi_r2_kernel: inputs must be CUDA tensors on "
                         "one device")
    if la.dtype != torch.float32 or lb.dtype != torch.float32:
        raise ValueError("viterbi_r2_kernel: soft inputs must be float32")
    if la.ndim != 2 or la.shape != lb.shape or la.shape[1] % 2:
        raise ValueError(f"viterbi_r2_kernel: want two (B, n) inputs with n "
                         f"even, got {tuple(la.shape)} and {tuple(lb.shape)}")
    n_rows, n = la.shape
    la, lb = la.contiguous(), lb.contiguous()
    pred, signs = _r2_tables(dev)
    bits = torch.empty((n_rows, n), dtype=torch.int8, device=dev)
    pm_end = torch.empty(n_rows, dtype=torch.float32, device=dev)
    if n_rows and n:
        VITERBI_R2.launch(la, lb, pred, signs, bits, pm_end, n_rows, n)
    elif n_rows:
        pm_end.zero_()
    return bits, pm_end


def viterbi_decode_r2(la, lb, n_steps: int):
    """Radix-2 Viterbi over an UNMASKED trellis of exactly ``n_steps``
    inputs (n_steps even): two trellis steps per iteration halve the
    sequential chain. la, lb: (N,) or (B, N) with N >= n_steps (only the
    first n_steps are read). Returns (bits (n_steps,) or (B, n_steps)
    int8, pm_end[0] scalar or (B,)) — the same maximum-likelihood path as
    viterbi_decode (ties may resolve differently).

    CUDA tensors run the V1 kernel (one launch for the whole batch), CPU
    tensors and arrays its plain twin.
    """
    if n_steps % 2:
        raise ValueError("radix-2 path needs an even step count")
    la, lb, one = _rows(la, lb)
    la, lb = la[:, :n_steps].contiguous(), lb[:, :n_steps].contiguous()
    if la.shape[1] != n_steps:
        raise ValueError(f"viterbi_decode_r2: {la.shape[1]} inputs for "
                         f"{n_steps} steps")
    if la.device.type == "cpu":
        bits, pm = viterbi_decode_r2_reference(la, lb)
    else:
        bits, pm = viterbi_r2_kernel(la, lb)
    if one:
        return bits[0], pm[0]
    return bits, pm


def fec_decode_bits(fec_bits, n_valid=None, device=None):
    """Hard-decision convenience: interleaved [a0 b0 a1 b1 ...] 0/1 ->
    decoded input bits (incl. the TERM zeros), numpy int8. Runs the
    radix-1 decoder on ``device`` (cuda unless the caller passes
    another)."""
    dev = resolve_device(device)
    fec_bits = np.asarray(fec_bits)
    la = fec_bits[0::2].astype(np.float32) * 2 - 1
    lb = fec_bits[1::2].astype(np.float32) * 2 - 1
    nv = len(la) if n_valid is None else n_valid
    bits, _ = viterbi_decode(as_tensor(la, dev), as_tensor(lb, dev), nv)
    return bits.cpu().numpy()
