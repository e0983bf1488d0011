"""Fused wideband front end on Hopper: channelize + demod + AA + RSSI.

Port of btle_tpu/wideband/fused.py. The TPU runs the whole front end in
one Pallas kernel per time tile; here it is two hand-written CUDA
kernels per block (``csrc/``), each with a plain PyTorch twin in this
module:

  1. the filterbank. ``filterbank_kind(compute_dtype, inner)`` maps each
     (numerics class, inner) pair the JAX package accepts onto one
     kernel (``FILTERBANK_KIND``):
     - ``"bf16x2w"`` (shipped default; inners im2col, im2colp) and
       ``"f32x2"`` (im2col): the DFT-folded polyphase filterbank as a
       bf16 tensor-core GEMM (mma.sync) of the exact bf16 hi/lo weight
       pair, y^T = A . B with A the im2col (Toeplitz) view of the
       time-major frames and B the (K_pad, 160) hi/lo table of
       ``convert.hilo_weights`` (``filterbank_bf16x2w``, K1, and
       ``filterbank_im2col(kind="f32x2")``, K5 at "f32x2"; one template,
       ``csrc/filterbank_hilo_mma.cu``). ``hilo_frames`` writes the frames
       time-major, (J, 40) bf16, and at "f32x2" also their exact bf16
       hi/lo split, (2, J, 40), whose four products per term the kernel
       sums into one accumulator;
     - ``"bf16"`` (im2col, im2colp, dots): the same folded filterbank
       with the bf16 weights and (40, J) frames on the CUDA cores
       (``filterbank_im2col(kind="bf16")``, K5, ``csrc/filterbank_im2col.cu``);
     - ``"f32"`` with im2col, im2colp or dots: the same in true FP32 as a
       CUDA-core SGEMM of the (40, J) frames and the (40, S, 80) table of
       ``convert.sgemm_weights`` (``filterbank_im2col(kind="f32_im2col")``,
       K5, ``csrc/filterbank_sgemm_f32.cu``);
     - ``"f32"`` with polyx (its default), poly or polyroll, and
       ``"bf16"`` with poly (the frames rounded to bf16, the taps exact):
       the stacked true-polyphase FMAs, then the 80x80 DFT, in true FP32
       (``filterbank_polyx_f32``, K3);
  2. the demod tail shared by all (``demod_tail``, port of
     ``_demod_tail``): phase-difference decisions, the per-channel
     32-tap access-address test, RSSI window sums.

The 80-row baseband y goes through device memory between the two
launches; keeping it on chip, as the TPU kernel does, is ROADMAP perf
work. The (-1)^(mk) half-band sign is never applied to y: it cancels in
the demod at even lag and flips odd bins' decisions at odd lag.

Wrappers take the plain twin only for tensors on the CPU; a CUDA tensor
launches the kernel or raises. The inners (pair stacking, per-shift
dots, roll manufacture), ``tile``, ``_POLY_GROUP``, ``AA_GRP``, 128-lane
padding and ``dev_skip`` were Mosaic scheduling choices, not semantics:
``tile`` is accepted for signature compatibility and changes nothing.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .._build import CudaKernel
from .._device import as_tensor, resolve_device
from ..convert import HILO_K_ALIGN
from .channelizer import (D, DEFAULT_TAPS, M, _dft_matrix, _fused_kernel,
                          _poly_kernel, branch_columns, frame_rows, true_fp32)

AA_BITS = 32
N_CHUNKS = 5        # im2col chunking of the shift axis (width 65 -> 5 x 13)
POLYX_STACK = 2     # pre-shifted frame copies stacked per slice ("polyx")

# K1 and K5 at "f32x2": the tensor-core hi/lo template (filterbank_hilo_mma.cu)
FILTERBANK_BF16X2W = CudaKernel("filterbank_bf16x2w",
                                replaces="btle_tpu/wideband/fused.py:373")
FILTERBANK_POLYX_F32 = CudaKernel("filterbank_polyx_f32",
                                  replaces="btle_tpu/wideband/fused.py:620")
# K5: one kernel per numerics class ("bf16" in filterbank_im2col.cu,
# "f32_im2col" in filterbank_sgemm_f32.cu, "f32x2" the hi/lo template's
# second instance)
FILTERBANK_IM2COL = {
    kind: CudaKernel(f"filterbank_im2col_{cls}",
                     replaces="btle_tpu/wideband/fused.py:373")
    for kind, cls in (("bf16", "bf16"), ("f32x2", "f32x2"),
                      ("f32_im2col", "f32"))}
DEMOD_TAIL = CudaKernel("demod_tail", replaces="btle_tpu/wideband/fused.py:458")

# (compute_dtype, inner) -> filterbank kind, for every pair the JAX
# package accepts (fused.py:740-880): the inners of one numerics class
# compute one function in different Mosaic schedules, so they share a
# kernel. "bf16_poly" is K3 with the frames rounded to bf16 before the
# row gather (the JAX poly inner keeps the taps exact at "bf16").
FILTERBANK_KIND = {
    ("bf16x2w", "im2col"): "bf16x2w", ("bf16x2w", "im2colp"): "bf16x2w",
    ("bf16", "im2col"): "bf16", ("bf16", "im2colp"): "bf16",
    ("bf16", "dots"): "bf16", ("bf16", "poly"): "bf16_poly",
    ("f32x2", "im2col"): "f32x2",
    ("f32", "im2col"): "f32_im2col", ("f32", "im2colp"): "f32_im2col",
    ("f32", "dots"): "f32_im2col",
    ("f32", "polyx"): "f32", ("f32", "poly"): "f32", ("f32", "polyroll"): "f32",
}
# the JAX package's _default_inner
DEFAULT_INNER = {"bf16x2w": "im2col", "bf16": "im2col", "f32x2": "im2col",
                 "f32": "polyx"}


# --------------------------------------------------------------------------
# Static tables (numpy copies of btle_tpu/wideband/fused.py:79-332)
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _g_stack(num_taps: int, cutoff_mhz: float = 1.0) -> np.ndarray:
    """(65, 80, 40) filterbank+DFT weights: y[o, k] = sum_s G[s] @ F[:, k+s].

    From channelizer._fused_kernel's conv weights w[o, i, s] (OIW layout):
    G[s][o, i] = w[o, i, s]. Input rows i: 0..19 = I decimated streams,
    20..39 = Q; output rows o: 0..39 = y_i bins, 40..79 = y_q bins.
    """
    w = _fused_kernel(num_taps, cutoff_mhz)  # (80, 40, width)
    return np.ascontiguousarray(np.transpose(w, (2, 0, 1)))


@lru_cache(maxsize=None)
def _g_chunks(num_taps: int, cutoff_mhz: float = 1.0) -> np.ndarray:
    """(N_CHUNKS, 80, chunk*40) im2col weights: chunk c contracts over the
    rows X[j*40+i, k] = F[i, k + c*chunk + j]."""
    g = _g_stack(num_taps, cutoff_mhz)   # (width, 80, 40)
    width = g.shape[0]
    chunk = -(-width // N_CHUNKS)
    gp = np.zeros((N_CHUNKS * chunk, 2 * M, 2 * D), g.dtype)
    gp[:width] = g
    # gc[c][o, j*40 + i] = g[c*chunk + j][o, i]
    gc = gp.reshape(N_CHUNKS, chunk, 2 * M, 2 * D)
    gc = np.transpose(gc, (0, 2, 1, 3)).reshape(N_CHUNKS, 2 * M, chunk * 2 * D)
    return np.ascontiguousarray(gc)


@lru_cache(maxsize=None)
def _g_chunks_hilo(num_taps: int, cutoff_mhz: float = 1.0) -> np.ndarray:
    """(N_CHUNKS, 160, chunk*40) bf16 hi/lo im2col weight pair, stacked.

    gc = hi + lo to ~16 mantissa bits (~-96 dB — each half carries 8
    bf16 mantissa bits), both halves bf16-representable; rows 0..79 = hi,
    80..159 = lo. Rounded with torch's float32 -> bfloat16 conversion,
    which rounds to nearest even like ml_dtypes.
    """
    gc = torch.from_numpy(_g_chunks(num_taps, cutoff_mhz).astype(np.float32))
    hi = gc.to(torch.bfloat16).to(torch.float32)
    lo = (gc - hi).to(torch.bfloat16).to(torch.float32)
    return np.ascontiguousarray(torch.cat([hi, lo], dim=1).numpy())


@lru_cache(maxsize=None)
def _g_chunks_x2(num_taps: int, cutoff_mhz: float = 1.0) -> np.ndarray:
    """(N_CHUNKS, 160, chunk*80) weights of the "f32x2" class: rows
    [hi; lo] of the exact bf16 split of _g_chunks, each weight column
    duplicated over the [xhi(40); xlo(40)] operand rows of one shift, so
    yc = W2 @ X2 gives y = yc[:80] + yc[80:] = (Ghi + Glo) @ (xhi + xlo).
    Rounded with torch's float32 -> bfloat16 conversion (round to nearest
    even, as ml_dtypes)."""
    gc = torch.from_numpy(_g_chunks(num_taps, cutoff_mhz).astype(np.float32))
    hi = gc.to(torch.bfloat16).to(torch.float32)
    lo = (gc - hi).to(torch.bfloat16).to(torch.float32)
    n, rows, cols = gc.shape
    chunk = cols // (2 * D)

    def dup(a):
        return (a.reshape(n, rows, chunk, 1, 2 * D)
                .expand(n, rows, chunk, 2, 2 * D).reshape(n, rows, chunk * 4 * D))

    return np.ascontiguousarray(torch.cat([dup(hi), dup(lo)], dim=1).numpy())


@lru_cache(maxsize=None)
def _poly_tables(num_taps: int, cutoff_mhz: float = 1.0):
    """Static tables for the true-polyphase form.

    Returns (perm, kcoef, wdft):
      perm  (80,)  frame-row gather building f_perm = f_t[perm], rows
                   [even-parity I(20) | even Q(20) | odd I(20) | odd Q(20)]
      kcoef (80, width) per-row tap value at shift s (zeros elsewhere)
      wdft  (80, 80) DFT + row-permutation matmul: [y_i; y_q] = W @ u
    """
    assert num_taps % (2 * D) == 0, \
        f"poly inner needs num_taps % {2 * D} == 0, got {num_taps}"
    kern, row_of_p = _poly_kernel(num_taps, cutoff_mhz)
    width = kern.shape[2]
    cols = branch_columns()
    even_p = [0] + list(range(D + 1, M))
    odd_p = list(range(1, D + 1))
    perm = np.array(
        [cols[p] for p in even_p] + [D + cols[p] for p in even_p]
        + [cols[p] for p in odd_p] + [D + cols[p] for p in odd_p],
        np.int32)
    kcoef = np.zeros((2 * M, width), np.float32)
    half = len(even_p)                                    # 20
    for g, p in enumerate(even_p):
        kcoef[g] = kcoef[half + g] = kern[row_of_p[p], 0]
    for g, p in enumerate(odd_p):
        kcoef[2 * half + g] = kcoef[3 * half + g] = kern[row_of_p[p], 0]
    ri = np.zeros(M, np.int64)
    rq = np.zeros(M, np.int64)
    for g, p in enumerate(even_p):
        ri[p], rq[p] = g, half + g
    for g, p in enumerate(odd_p):
        ri[p], rq[p] = 2 * half + g, 3 * half + g
    er, ei = _dft_matrix()
    er64, ei64 = er.astype(np.float64), ei.astype(np.float64)
    wdft = np.zeros((2 * M, 2 * M), np.float64)
    rows = np.arange(M)[:, None]
    wdft[rows, ri[None, :]] = er64                        # y_i <- Er u_i
    wdft[rows, rq[None, :]] = -ei64                       # y_i <- -Ei u_q
    wdft[M + rows, ri[None, :]] = ei64                    # y_q <- Ei u_i
    wdft[M + rows, rq[None, :]] = er64                    # y_q <- Er u_q
    return perm, kcoef, wdft.astype(np.float32)


@lru_cache(maxsize=None)
def _polyx_tables(num_taps: int, stack: int = POLYX_STACK,
                  cutoff_mhz: float = 1.0):
    """Static tables for the stacked true-polyphase form ("polyx").

    Row group g of the stacked frames holds parity-(g%2) permuted rows
    left-shifted by g columns, so one slice at offset stack*j covers tap
    shifts stack*j .. stack*j+stack-1.

    Returns (perm, kcoefx, w4x, n_slices):
      perm    (80,)   frame-row gather (same as _poly_tables)
      kcoefx  (stack*40, n_slices) tap value of row r's branch at shift
                      stack*j + (r//40), zero where that shift >= width
      w4x     (80, stack*40) DFT matmul over the stacked accumulator
    """
    assert stack % 2 == 0, "stack must pair the even/odd parity groups"
    perm, kcoef, wdft = _poly_tables(num_taps, cutoff_mhz)
    width = kcoef.shape[1]
    n_slices = -(-width // stack)
    kcoefx = np.zeros((stack * 2 * D, n_slices), np.float32)
    for g in range(stack):
        block = kcoef[:2 * D] if g % 2 == 0 else kcoef[2 * D:]
        for j in range(n_slices):
            s = stack * j + g
            if s < width:
                kcoefx[g * 2 * D : (g + 1) * 2 * D, j] = block[:, s]
    we, wo = wdft[:, :2 * D], wdft[:, 2 * D:]
    w4x = np.concatenate([we if g % 2 == 0 else wo
                          for g in range(stack)], axis=1)
    return perm, kcoefx, np.ascontiguousarray(w4x), n_slices


def host_tables(kind: str, num_taps: int, cutoff_mhz: float = 1.0) -> tuple:
    """The numpy weight tables of a filterbank kind, as the JAX package
    builds them (``convert.filter_tables_from_numpy`` takes them over)."""
    if kind == "bf16x2w":
        return (_g_chunks_hilo(num_taps, cutoff_mhz),)
    if kind in ("bf16", "f32_im2col"):
        return (_g_chunks(num_taps, cutoff_mhz),)
    if kind == "f32x2":
        return (_g_chunks_x2(num_taps, cutoff_mhz),)
    return _polyx_tables(num_taps, POLYX_STACK, cutoff_mhz)


@lru_cache(maxsize=32)
def _device_tables(kind: str, num_taps: int, cutoff_mhz: float,
                   device: torch.device):
    """The kind's weight tensors on ``device`` (uploaded once)."""
    from ..convert import filter_tables_from_numpy

    return filter_tables_from_numpy(kind, host_tables(kind, num_taps, cutoff_mhz),
                                    device)


# --------------------------------------------------------------------------
# Kernels and their plain twins
# --------------------------------------------------------------------------


def _check_cuda(name: str, *tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must all lie on one CUDA "
                             f"device or all on the CPU, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


@lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def hilo_warps_m(ky: int, sms: int) -> int:
    """The tensor-core filterbank's column tile in 64-column warps (4, 2
    or 1): the widest whose grid still gives each of ``sms`` SMs a CTA
    (the kernel reads all the weights once per CTA, so wider is better
    while every SM has work)."""
    warps = 4
    while warps > 1 and -(-ky // (64 * warps)) < sms:
        warps //= 2
    return warps


def sgemm_warps(ky: int, sms: int) -> int:
    """The FP32 filterbank's column tile in 32-column warps (8, 4 or 2):
    the widest whose grid still gives each of ``sms`` SMs a CTA (each CTA
    streams all the weights, so wider is better while every SM has
    work)."""
    warps = 8
    while warps > 2 and -(-ky // (32 * warps)) < sms:
        warps //= 2
    return warps


def hilo_frames(f_t, n_cols: int, split: bool):
    """(40, J) float32 frames -> the tensor-core filterbank's time-major
    bf16 operand, zero past J up to ``n_cols`` rows: (n_cols, 40), or with
    ``split`` (the "f32x2" class) the exact bf16 split (2, n_cols, 40),
    xhi = bf16(x), xlo = bf16(x - xhi). Rounds to nearest even."""
    x = f_t.t()
    out = torch.zeros((2 if split else 1, n_cols, 2 * D), dtype=torch.bfloat16,
                      device=f_t.device)
    out[0, : x.shape[0]] = x
    if split:
        out[1, : x.shape[0]] = x - out[0, : x.shape[0]].to(torch.float32)
    return out if split else out[0]


def _hilo_conv_weights(b, width: int):
    """The (K_pad, 160) hi/lo table -> float32 conv weights (160, 40,
    width), W[o', i, s] = B[s*40 + i, o']."""
    return (b[: width * 2 * D].to(torch.float32).reshape(width, 2 * D, 4 * M)
            .permute(2, 1, 0).contiguous())


def filterbank_bf16x2w_reference(frames, b, width: int, ky: int):
    """Plain twin of ``filterbank_bf16x2w``: one float32 convolution of the
    frames with the (160, 40, width) hi/lo weights, then the hi and lo row
    halves summed (bf16 x bf16 products are exact in float32)."""
    x = frames.to(torch.float32).t()[None, :, : ky + width - 1]
    with true_fp32():
        y2 = torch.nn.functional.conv1d(x, _hilo_conv_weights(b, width))[0]
    return y2[: 2 * M] + y2[2 * M:]


def filterbank_f32x2_reference(frames, b, width: int, ky: int):
    """Plain twin of ``filterbank_im2col(kind="f32x2")``: the four-product
    form the kernel and the TPU compute. The [xhi; xlo] frame rows are
    convolved with the (160, 80, width) pair (each weight column over both
    halves), the hi and lo row halves summed, one convolution per im2col
    chunk of shifts, the chunk sums added — the TPU kernel's chunk
    contractions (one convolution over all 65 shifts sums 2600 terms in a
    row on the CPU, which flips ~1e-3 of the noise-floor decisions against
    the JAX package at lag 1)."""
    w = _hilo_conv_weights(b, width)
    w2 = torch.cat([w, w], dim=1)
    x = frames.to(torch.float32).permute(0, 2, 1).reshape(4 * D, -1)
    chunk = -(-width // N_CHUNKS)
    y = torch.zeros((2 * M, ky), dtype=torch.float32, device=frames.device)
    with true_fp32():
        for s0 in range(0, width, chunk):
            s1 = min(s0 + chunk, width)
            yc = torch.nn.functional.conv1d(
                x[None, :, s0: s1 + ky - 1], w2[:, :, s0:s1].contiguous())[0]
            y += yc[: 2 * M] + yc[2 * M:]
    return y


def _launch_hilo(kernel, frames, b, width: int, ky: int, n_ops: int):
    _check_cuda(kernel.name, frames, b)
    if (frames.dtype != torch.bfloat16 or b.dtype != torch.bfloat16
            or frames.ndim != (2 if n_ops == 1 else 3) or frames.shape[-1] != 2 * D
            or (n_ops == 2 and frames.shape[0] != 2)
            or b.ndim != 2 or b.shape[1] != 4 * M or b.shape[0] % HILO_K_ALIGN
            or b.shape[0] < width * 2 * D):
        raise ValueError(f"{kernel.name}: bad dtypes or shapes "
                         f"{tuple(frames.shape)} {frames.dtype}, "
                         f"{tuple(b.shape)} {b.dtype}")
    y = torch.empty((2 * M, ky), dtype=torch.float32, device=frames.device)
    kernel.launch(frames, b, y, frames.shape[-2], ky, b.shape[0],
                  hilo_warps_m(ky, _sm_count(frames.device)))
    return y


def filterbank_bf16x2w(frames, b, width: int, ky: int):
    """K1: (J, 40) time-major bf16 frames (``hilo_frames``, zero-padded to
    at least ky + width - 1 rows) and the (K_pad, 160) bf16 hi/lo weights
    (``convert.hilo_weights``) -> y (80, ky) float32, the 40-channel
    baseband before the demod tail."""
    if frames.device.type == "cpu":
        return filterbank_bf16x2w_reference(frames, b, width, ky)
    return _launch_hilo(FILTERBANK_BF16X2W, frames, b, width, ky, 1)


def filterbank_im2col_reference(frames, gk, width: int, ky: int, kind: str):
    """Plain twin of ``filterbank_im2col`` (K5): at "f32x2"
    ``filterbank_f32x2_reference``; else the class's frames convolved
    with its (80, 40, width) weights in true FP32, one convolution per
    im2col chunk of shifts, summed — the TPU kernel's chunk contractions
    (see ``filterbank_f32x2_reference`` for why)."""
    if kind == "f32x2":
        return filterbank_f32x2_reference(frames, gk, width, ky)
    if kind == "f32_im2col":
        # W[o, i, s] = T[i, s, o]; the table holds N_CHUNKS chunks of shifts
        w = gk.permute(2, 0, 1)
        chunk = gk.shape[1] // N_CHUNKS
    else:
        n_chunks, rows, cols = gk.shape
        chunk = cols // (2 * D)
        # W[o, i, c*chunk + j] = g[c, o, j*40 + i]
        w = (gk.to(torch.float32).reshape(n_chunks, 2 * M, chunk, 2 * D)
             .permute(1, 3, 0, 2).reshape(2 * M, 2 * D, n_chunks * chunk))
    x = frames.to(torch.float32)
    y = torch.zeros((2 * M, ky), dtype=torch.float32, device=frames.device)
    with true_fp32():
        for s0 in range(0, width, chunk):
            s1 = min(s0 + chunk, width)
            y += torch.nn.functional.conv1d(
                x[None, :, s0: s1 + ky - 1], w[:, :, s0:s1].contiguous())[0]
    return y


def filterbank_im2col(frames, gk, width: int, ky: int, kind: str):
    """K5: the folded filterbank in numerics class ``kind`` — "bf16":
    (40, J) bf16 frames, (n_chunks, 80, chunk*40) bf16 weights;
    "f32_im2col": (40, J) float32 frames and the (40, S, 80) float32
    table of ``convert.sgemm_weights`` (S = N_CHUNKS chunks of shifts,
    at least ``width``); "f32x2": the (2, J, 40) time-major [xhi; xlo]
    bf16 frames (``hilo_frames``) and the (K_pad, 160) hi/lo weights, on
    the tensor-core template. Frames zero-padded to at least ky + width -
    1 columns (the kernels read zeros past J) -> y (80, ky) float32."""
    if frames.device.type == "cpu":
        return filterbank_im2col_reference(frames, gk, width, ky, kind)
    kernel = FILTERBANK_IM2COL[kind]
    if kind == "f32x2":
        return _launch_hilo(kernel, frames, gk, width, ky, 2)
    _check_cuda(kernel.name, frames, gk)
    if kind == "f32_im2col":
        if (frames.dtype != torch.float32 or gk.dtype != torch.float32
                or frames.ndim != 2 or frames.shape[0] != 2 * D
                or gk.ndim != 3 or gk.shape[0] != 2 * D or gk.shape[2] != 2 * M
                or gk.shape[1] < width or gk.data_ptr() % 16):
            raise ValueError(f"{kernel.name}: bad dtypes or shapes "
                             f"{tuple(frames.shape)} {frames.dtype}, "
                             f"{tuple(gk.shape)} {gk.dtype}")
        y = torch.empty((2 * M, ky), dtype=torch.float32, device=frames.device)
        kernel.launch(frames, gk, y, frames.shape[1], ky, gk.shape[1], width,
                      sgemm_warps(ky, _sm_count(frames.device)))
        return y
    n_chunks, rows, cols = gk.shape
    if (frames.dtype != torch.bfloat16 or gk.dtype != torch.bfloat16
            or frames.shape[0] != 2 * D or rows != 2 * M
            or cols % (2 * D) or n_chunks * (cols // (2 * D)) < width):
        raise ValueError(f"{kernel.name}: bad dtypes or shapes "
                         f"{tuple(frames.shape)} {frames.dtype}, "
                         f"{tuple(gk.shape)} {gk.dtype}")
    y = torch.empty((2 * M, ky), dtype=torch.float32, device=frames.device)
    kernel.launch(frames, gk, y, frames.shape[1], ky, cols // (2 * D), width)
    return y


def filterbank_polyx_f32_reference(f4, kcoefx, w4x, ky: int,
                                   stack: int = POLYX_STACK):
    """Plain twin of ``filterbank_polyx_f32``: the stacked shifted FMAs,
    slice by slice, then the DFT product, in true FP32."""
    acc = torch.zeros((f4.shape[0], ky), dtype=torch.float32, device=f4.device)
    for j in range(kcoefx.shape[1]):
        acc = acc + f4[:, stack * j: stack * j + ky] * kcoefx[:, j: j + 1]
    with true_fp32():
        return w4x @ acc


def filterbank_polyx_f32(f4, kcoefx, w4x, ky: int, stack: int = POLYX_STACK):
    """(stack*40, J) float32 stacked pre-shifted frames (J at least
    ky + stack*(n_slices-1)), kcoefx (stack*40, n_slices) and the
    (80, stack*40) DFT -> y (80, ky) float32, in true FP32."""
    if f4.device.type == "cpu":
        return filterbank_polyx_f32_reference(f4, kcoefx, w4x, ky, stack)
    _check_cuda("filterbank_polyx_f32", f4, kcoefx, w4x)
    rows, n_slices = kcoefx.shape
    if (f4.dtype != torch.float32 or f4.shape[0] != rows
            or f4.shape[1] < ky + stack * (n_slices - 1)
            or tuple(w4x.shape) != (2 * M, rows)):
        raise ValueError("filterbank_polyx_f32: bad shapes or dtype")
    y = torch.empty((2 * M, ky), dtype=torch.float32, device=f4.device)
    FILTERBANK_POLYX_F32.launch(f4, kcoefx, w4x, y, f4.shape[1], ky, rows,
                                n_slices, stack)
    return y


def demod_tail_reference(y, aa_rows, aa_mask, sps: int, lag: int,
                         n_bits: int, n_hit: int):
    """Plain twin of ``demod_tail`` — the arithmetic of fused.py's
    _demod_tail on whole rows: decisions, the 32-tap AA correlation of the
    +-1 lattice against the masked AA signs (exact small integers in
    float32), and the RSSI window sums by the same pairwise doubling."""
    y_i, y_q = y[:M], y[M:]
    d = (y_i[:, :n_bits] * y_q[:, lag: n_bits + lag]
         - y_i[:, lag: n_bits + lag] * y_q[:, :n_bits])
    if lag % 2:
        odd = (torch.arange(M, device=y.device) % 2 == 1)[:, None]
        bits = torch.where(odd, d < 0, d > 0)
    else:
        bits = d > 0
    s_lat = bits.to(torch.float32) * 2 - 1
    mask = aa_mask.to(torch.float32)
    tsign = (aa_rows.to(torch.float32) * 2 - 1) * mask[None, :]
    acc = torch.zeros((M, n_hit), dtype=torch.float32, device=y.device)
    for j in range(AA_BITS):
        acc = acc + s_lat[:, j * sps: j * sps + n_hit] * tsign[:, j: j + 1]
    hit = acc == mask.sum()
    win = AA_BITS * sps
    w = y_i.abs() + y_q.abs()
    span = 1
    while span < win:
        w = w[:, : w.shape[1] - span] + w[:, span:]
        span *= 2
    return bits.to(torch.int8), hit, w[:, :n_hit] * (1.0 / win)


def demod_tail(y, aa_rows, aa_mask, sps: int, lag: int, n_bits: int,
               n_hit: int):
    """y (80, Ky) float32 baseband, aa_rows (40, 32) and aa_mask (32,) int8
    -> bits (40, n_bits) int8, hit (40, n_hit) bool, mag (40, n_hit)
    float32. Needs Ky >= n_bits + lag and Ky >= n_hit + 32*sps - 1."""
    win = AA_BITS * sps
    if y.shape[1] < max(n_bits + lag, n_hit + win - 1):
        raise ValueError("demod_tail: y has too few columns")
    if y.device.type == "cpu":
        return demod_tail_reference(y, aa_rows, aa_mask, sps, lag, n_bits, n_hit)
    _check_cuda("demod_tail", y, aa_rows, aa_mask)
    if (y.dtype != torch.float32 or y.shape[0] != 2 * M
            or aa_rows.dtype != torch.int8 or tuple(aa_rows.shape) != (M, AA_BITS)
            or aa_mask.dtype != torch.int8 or tuple(aa_mask.shape) != (AA_BITS,)
            or not 1 <= sps <= 8 or win & (win - 1)):
        raise ValueError("demod_tail: bad dtype, shape or sps")
    dev = y.device
    bits = torch.empty((M, n_bits), dtype=torch.int8, device=dev)
    hit = torch.empty((M, n_hit), dtype=torch.bool, device=dev)
    mag = torch.empty((M, n_hit), dtype=torch.float32, device=dev)
    DEMOD_TAIL.launch(y, aa_rows, aa_mask, bits, hit, mag, y.shape[1],
                      n_bits, n_hit, sps, lag)
    return bits, hit, mag


# --------------------------------------------------------------------------
# Front end and scan
# --------------------------------------------------------------------------


def filterbank_kind(compute_dtype: str, inner: str | None = None) -> str:
    """The filterbank kind (key of FILTERBANKS) that runs
    ``compute_dtype`` at ``inner`` (None: the JAX package's default).
    Raises ValueError for the pairs the JAX package asserts against
    (e.g. bf16x2w/dots, f32x2/poly, bf16/polyroll) and unknown names."""
    if compute_dtype not in DEFAULT_INNER:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r} (want one "
                         f"of {sorted(DEFAULT_INNER)})")
    inner = DEFAULT_INNER[compute_dtype] if inner is None else inner
    kind = FILTERBANK_KIND.get((compute_dtype, inner))
    if kind is None:
        ok = sorted(i for d, i in FILTERBANK_KIND if d == compute_dtype)
        raise ValueError(f"inner {inner!r} does not run at compute_dtype "
                         f"{compute_dtype!r} (accepted: {ok})")
    return kind


def frontend_operands(i_wb, q_wb, aa_rows, aa_mask, num_taps: int,
                      has_context: bool, sps: int, lag: int,
                      compute_dtype: str, cutoff_mhz: float,
                      device: torch.device, inner: str | None = None):
    """Frame prep (identical to channelize's) and the operands of the
    two kernels of (compute_dtype, inner): (filterbank_args, tail_args)
    such that ``demod_tail(FILTERBANKS[filterbank_kind(compute_dtype,
    inner)][0](*filterbank_args), *tail_args)`` is the front end's
    output."""
    kind = filterbank_kind(compute_dtype, inner)
    win = AA_BITS * sps
    if win & (win - 1):
        raise ValueError("RSSI doubling needs 32*sps to be a power of 2")
    i_wb, q_wb = as_tensor(i_wb, device), as_tensor(q_wb, device)
    aa_rows = as_tensor(aa_rows, device, torch.int8)
    if aa_rows.ndim == 1:
        aa_rows = aa_rows.expand(M, AA_BITS)
    aa_rows = aa_rows.contiguous()
    aa_mask = as_tensor(aa_mask, device, torch.int8).contiguous()

    width = _g_stack(num_taps, cutoff_mhz).shape[0]
    f_t = frame_rows(i_wb, q_wb, num_taps, has_context)   # (40, J)
    k_out = f_t.shape[1] - (width - 1)                    # == channelize K
    n_bits = k_out - lag
    n_hit = n_bits - (AA_BITS - 1) * sps
    if n_hit <= 0:
        raise ValueError("block too short for one access-address window")
    # y columns the tail reads: the demod lag, or the RSSI window past the
    # last hit position; columns past K come from zero frames, as on the TPU
    ky = max(k_out, n_hit + win - 1)

    if kind in ("bf16x2w", "f32x2"):
        (b,) = _device_tables(kind, num_taps, cutoff_mhz, device)
        frames = hilo_frames(f_t, ky + width - 1, kind == "f32x2")
        fb_args = ((frames, b, width, ky) if kind == "bf16x2w"
                   else (frames, b, width, ky, kind))
    elif kind in ("bf16", "f32_im2col"):
        (gk,) = _device_tables(kind, num_taps, cutoff_mhz, device)
        frames = torch.nn.functional.pad(f_t, (0, ky + width - 1 - f_t.shape[1]))
        if kind == "bf16":
            frames = frames.to(torch.bfloat16)
        fb_args = (frames.contiguous(), gk, width, ky, kind)
    else:
        if kind == "bf16_poly":
            f_t = f_t.to(torch.bfloat16).to(torch.float32)
        perm, kcoefx, w4x = _device_tables("f32", num_taps, cutoff_mhz, device)
        stack, n_slices = POLYX_STACK, kcoefx.shape[1]
        jp = ky + stack * (n_slices - 1)
        fp = torch.nn.functional.pad(f_t, (0, jp + stack - 1 - f_t.shape[1]))[perm]
        half = 2 * D
        f4 = torch.cat([fp[(g % 2) * half: (g % 2 + 1) * half, g: g + jp]
                        for g in range(stack)]).contiguous()
        fb_args = (f4, kcoefx, w4x, ky, stack)
    return fb_args, (aa_rows, aa_mask, sps, lag, n_bits, n_hit)


# filterbank kind -> (kernel wrapper, its plain twin)
FILTERBANKS = {
    "bf16x2w": (filterbank_bf16x2w, filterbank_bf16x2w_reference),
    "bf16": (filterbank_im2col, filterbank_im2col_reference),
    "f32x2": (filterbank_im2col, filterbank_im2col_reference),
    "f32_im2col": (filterbank_im2col, filterbank_im2col_reference),
    "f32": (filterbank_polyx_f32, filterbank_polyx_f32_reference),
    "bf16_poly": (filterbank_polyx_f32, filterbank_polyx_f32_reference),
}


def fused_frontend(i_wb, q_wb, aa_rows, aa_mask, num_taps: int = DEFAULT_TAPS,
                   has_context: bool = False, sps: int = 4, lag: int = 4,
                   tile: int | None = None, compute_dtype: str = "f32",
                   inner: str | None = None, cutoff_mhz: float = 1.0,
                   device=None):
    """80 Msps wideband IQ -> per-channel (bits, hit, mag) lattices.

    Drop-in for channelize + scan_block per channel: returns
      bits (M, K-lag)          decision lattice (int8 0/1)
      hit  (M, K-lag-31*sps)   AA-match mask (bool)
      mag  (M, K-lag-31*sps)   RSSI window mean at each position (f32)
    with K the per-channel sample count channelize() would produce.
    aa_rows: (M, 32) per-channel AA bits (or (32,), broadcast).
    ``compute_dtype`` / ``inner`` take every pair the JAX package takes
    (``filterbank_kind``). Runs on ``device`` (cuda unless the caller
    passes another); ``tile`` is accepted for signature compatibility
    and changes nothing.
    """
    del tile
    kind = filterbank_kind(compute_dtype, inner)
    fb_args, tail_args = frontend_operands(
        i_wb, q_wb, aa_rows, aa_mask, num_taps, has_context, sps, lag,
        compute_dtype, cutoff_mhz, resolve_device(device), inner)
    y = FILTERBANKS[kind][0](*fb_args)
    return demod_tail(y, *tail_args)


def wideband_scan_fused(i_wb, q_wb, aa_rows, aa_mask, whiten_rows, crc_inits,
                        adv_flags, sps: int = 4, lag: int = 4,
                        max_candidates: int = 8, num_taps: int = DEFAULT_TAPS,
                        has_context: bool = False, tile: int | None = None,
                        compute_dtype: str = "f32", inner: str | None = None,
                        decode: str = "pallas", cutoff_mhz: float = 1.0,
                        device=None):
    """Drop-in for sniffer.wideband_scan with the fused front end: the
    same per-channel candidate dict. decode="pallas" runs the candidate
    decode kernel (rx.decode_kernel, the port of rx.pallas_decode);
    decode="xla" the plain rx.pipeline decode — names kept from the JAX
    package so a reader finds the counterpart."""
    from ..rx.decode_kernel import decode_candidates
    from ..rx.pipeline import decode_from_lattice, earliest_hits

    if decode not in ("pallas", "xla"):
        raise ValueError(f"unknown decode {decode!r} (want 'pallas'|'xla')")
    dev = resolve_device(device)
    bits, hit, mag = fused_frontend(
        i_wb, q_wb, aa_rows, aa_mask, num_taps=num_taps,
        has_context=has_context, sps=sps, lag=lag, tile=tile,
        compute_dtype=compute_dtype, inner=inner, cutoff_mhz=cutoff_mhz,
        device=dev)
    whiten_rows = as_tensor(whiten_rows, dev, torch.int8)
    crc_inits = as_tensor(crc_inits, dev, torch.int32)
    adv_flags = as_tensor(adv_flags, dev, torch.bool)
    if decode == "xla":
        return decode_from_lattice(hit, bits, mag, whiten_rows, crc_inits,
                                   adv_flags, sps=sps,
                                   max_candidates=max_candidates)
    pos, valid, num_hits = earliest_hits(hit, max_candidates, 0)
    pkt_bytes, plen, crc_match, len_ok = decode_candidates(
        bits, pos, whiten_rows, crc_inits, adv_flags, sps=sps)
    mag_mean = mag.gather(1, pos.to(torch.int64).clamp(0, mag.shape[1] - 1))
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
