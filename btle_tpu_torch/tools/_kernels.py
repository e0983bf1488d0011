"""The probes' own CUDA kernels and their plain PyTorch twins.

Three wrappers over two hand-written sources (``csrc/aa_corr.cu``,
``csrc/shift_fma.cu``):

- ``aa_corr``: the 32-tap access-address correlation alone, on a float
  lattice or on int8 decisions (the AA stage of K2, as the TPU probes
  K8, K9 and K11 isolate it);
- ``shift_stack``: the strided-roll stack of K9, wrap-around included;
- ``shift_fma``: K10's shifted per-row FMAs folded to 40 rows.

Each wrapper takes its twin only for tensors on the CPU; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .._build import CudaKernel
from ..wideband.fused import _check_cuda

AA_BITS = 32
OUT_ROWS = 40       # the 40 channels every probe folds or correlates to

AA_CORR = CudaKernel("aa_corr", replaces="tools/dev_aagrp_repro.py:118")
SHIFT_STACK = CudaKernel("shift_stack", replaces="tools/dev_aagrp_repro.py:118")
SHIFT_FMA = CudaKernel("shift_fma", replaces="tools/dev_rollscale.py:75")
GROUPS = (1, 2, 4, 8, 16, 32)   # accumulation groupings aa_corr takes
SHIFT_FMA_STEPS = (2, 4, 8)     # the slice strides the shift_fma kernel takes


def aa_corr_reference(s, w, sps: int, n_out: int, grp: int = 8,
                      n_mask: int = AA_BITS):
    """Plain twin of ``aa_corr``: the 32 shifted FMAs of the lattice rows
    against the per-row weights, tap by tap (as demod_tail_reference
    does), int8 decisions mapped to +1 (> 0) and -1. ``grp`` is the
    kernel's accumulation grouping, which cannot change a sum of +-1/0
    products; the twin ignores it."""
    del grp
    lat = torch.where(s > 0, 1.0, -1.0) if s.dtype == torch.int8 else s
    acc = torch.zeros((s.shape[0], n_out), dtype=torch.float32, device=s.device)
    for j in range(AA_BITS):
        acc = acc + lat[:, j * sps: j * sps + n_out] * w[:, j: j + 1]
    return acc, (acc == n_mask).to(torch.int8)


def aa_corr(s, w, sps: int, n_out: int, grp: int = 8, n_mask: int = AA_BITS):
    """(rows, L) float32 lattice or int8 decisions, (rows, 32) float32
    weights -> acc (rows, n_out) float32 = sum_j w[:, j] * s[:, t + sps*j]
    and hit (rows, n_out) int8 = acc == n_mask. Needs L >= n_out +
    31*sps. The taps are summed in groups of ``grp`` (the TPU's roll
    groups; exact either way for +-1/0 operands)."""
    if s.shape[1] < n_out + (AA_BITS - 1) * sps:
        raise ValueError("aa_corr: the lattice is too short for n_out")
    if grp not in GROUPS:
        raise ValueError(f"aa_corr: grp must be one of {GROUPS}")
    if s.device.type == "cpu":
        return aa_corr_reference(s, w, sps, n_out, grp, n_mask)
    _check_cuda("aa_corr", s, w)
    rows = s.shape[0]
    if (s.dtype not in (torch.float32, torch.int8) or w.dtype != torch.float32
            or tuple(w.shape) != (rows, AA_BITS) or not 1 <= sps <= 8):
        raise ValueError("aa_corr: bad dtypes, shapes or sps")
    acc = torch.empty((rows, n_out), dtype=torch.float32, device=s.device)
    hit = torch.empty((rows, n_out), dtype=torch.int8, device=s.device)
    AA_CORR.launch(s, w, acc, hit, rows, s.shape[1], n_out, sps, grp,
                   int(s.dtype == torch.int8), n_mask)
    return acc, hit


def shift_stack_reference(s, grp: int, sps: int, k0: int = 0):
    """Plain twin of ``shift_stack``: row group r is the lattice rolled
    left by k0 + sps*(grp-1-r) columns (``np.roll``'s wrap-around)."""
    return torch.cat([torch.roll(s, -(k0 + sps * (grp - 1 - r)), dims=1)
                      for r in range(grp)])


def shift_stack(s, grp: int, sps: int, k0: int = 0):
    """(rows, nbp) float32 -> x (grp*rows, nbp) float32 with
    x[r*rows + c, t] = s[c, (t + k0 + sps*(grp-1-r)) mod nbp]: the stack
    one strided pltpu.roll over a broadcast builds on the TPU."""
    if s.device.type == "cpu":
        return shift_stack_reference(s, grp, sps, k0)
    _check_cuda("shift_stack", s)
    if s.dtype != torch.float32 or grp < 1:
        raise ValueError("shift_stack: takes float32 rows and grp >= 1")
    rows, nbp = s.shape
    x = torch.empty((grp * rows, nbp), dtype=torch.float32, device=s.device)
    SHIFT_STACK.launch(s, x, rows, nbp, grp, sps, k0)
    return x


def fold_rows(a: torch.Tensor) -> torch.Tensor:
    """The tool's fold: rows [0, h) += rows [h, 2h), h halving to 40."""
    h = a.shape[0]
    while h > OUT_ROWS:
        h //= 2
        a = a[:h] + a[h: 2 * h]
    return a


def shift_fma_reference(f, kc, n_cols: int, step: int, grp: int = 8):
    """Plain twin of ``shift_fma`` in the tool's order
    (tools/dev_rollscale.py:53-67): the slices of a group of ``grp``
    multiplied and summed, the group sums added in turn, then the fold."""
    n = kc.shape[1]
    total = None
    for g0 in range(0, n, grp):
        acc = None
        for j in range(g0, min(g0 + grp, n)):
            t = f[:, j * step: j * step + n_cols] * kc[:, j: j + 1]
            acc = t if acc is None else acc + t
        total = acc if total is None else total + acc
    return fold_rows(total)


def shift_fma(f, kc, n_cols: int, step: int, grp: int = 8):
    """(R, L) float32 frame rows, (R, N) float32 coefficients, R in
    {40, 80, 160}, L >= n_cols + step*(N-1) -> (40, n_cols) float32:
    out = fold(sum_j f[:, k + step*j] * kc[:, j]). ``grp`` orders the
    twin's sum (the tool's register groups); the kernel sums each row in
    j order, so the two agree to float32 rounding. On a card ``step`` is
    one of SHIFT_FMA_STEPS (the tool's three configurations)."""
    rows, n = kc.shape
    if rows not in (OUT_ROWS, 2 * OUT_ROWS, 4 * OUT_ROWS) or f.shape[0] != rows:
        raise ValueError("shift_fma: R must be 40, 80 or 160 rows")
    if f.shape[1] < n_cols + step * (n - 1):
        raise ValueError("shift_fma: the frames are too short for n_cols")
    if f.device.type == "cpu":
        return shift_fma_reference(f, kc, n_cols, step, grp)
    _check_cuda("shift_fma", f, kc)
    if f.dtype != torch.float32 or kc.dtype != torch.float32:
        raise ValueError("shift_fma: takes float32 frames and coefficients")
    if step not in SHIFT_FMA_STEPS:
        raise ValueError(f"shift_fma: the kernel takes step {SHIFT_FMA_STEPS}")
    out = torch.empty((OUT_ROWS, n_cols), dtype=torch.float32, device=f.device)
    SHIFT_FMA.launch(f, kc, out, rows, f.shape[1], n_cols, n, step)
    return out


def shift_fma_plan(f, kc, n_cols: int, step: int) -> dict:
    """The launch shape ``shift_fma`` takes for these CUDA operands:
    dynamic shared memory, resident CTAs per SM, grid, threads and
    columns per CTA (``_build.PLAN_KEYS``), and whether the rows go
    through 16-byte copies (row stride and base 16-byte aligned)."""
    vec16 = f.shape[1] % 4 == 0 and f.data_ptr() % 16 == 0
    return {**SHIFT_FMA.plan(kc.shape[0], kc.shape[1], step, n_cols, int(vec16)),
            "copy_bytes": 16 if vec16 else 4}


KERNELS = (AA_CORR, SHIFT_STACK, SHIFT_FMA)
