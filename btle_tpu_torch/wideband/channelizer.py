"""Oversampled polyphase channelizer: one 80 Msps capture -> 40 BLE channels.

Numpy copies of btle_tpu/wideband/channelizer.py's table functions
(prototype filter, polyphase kernel, DFT, DFT-folded kernel), its scene
composition helpers, and the torch twin of its XLA ``channelize``: a
grouped conv1d over the 20 decimated streams, the 40-point DFT as
matmuls and the (-1)^(mk) half-band sign. All 40 BLE channel centres
sit on the uniform grid 2402 + 2k MHz, so a capture at FS = 80 Msps
centred at 2442 MHz maps each channel to DFT bin m = (grid + 20) mod 40.
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from ..spec.channels import CHANNEL_TO_GRID, GRID_TO_CHANNEL
from ..utils.profiling import count

M = 40                 # channels / DFT size
D = 20                 # decimation (output 2x oversampled: 4 Msps)
FS_MSPS = 80           # wideband input rate
CENTER_FREQ_HZ = 2_442_000_000
TAPS_PER_BRANCH = 32
DEFAULT_TAPS = M * TAPS_PER_BRANCH


def channel_to_bin(channel: int) -> int:
    """BLE channel number -> channelizer output bin."""
    return (int(CHANNEL_TO_GRID[channel]) + M // 2) % M


def bin_to_channel(m: int) -> int:
    return int(GRID_TO_CHANNEL[(m - M // 2) % M])


@lru_cache(maxsize=None)
def prototype_filter(num_taps: int = M * TAPS_PER_BRANCH, cutoff_mhz: float = 1.0,
                     beta: float = 10.0) -> np.ndarray:
    """Kaiser lowpass, cutoff at the channel half-width: flat to 0.8 MHz,
    ~-100 dB past 1.2 MHz (cf. the AD9361 pass0.8/stop1.1 profile)."""
    from scipy import signal

    h = signal.firwin(num_taps, cutoff_mhz, window=("kaiser", beta), fs=FS_MSPS)
    return (h / h.sum()).astype(np.float64)


def branch_columns() -> np.ndarray:
    """c(p): the decimated frame column each polyphase branch p reads
    (derivation in _poly_kernel's docstring)."""
    p = np.arange(M)
    c = np.where(p % D == 0, 0, np.where(p <= D - 1, D - p, 2 * D - p))
    return c.astype(np.int32)


@lru_cache(maxsize=None)
def _poly_kernel(num_taps: int, cutoff_mhz: float = 1.0):
    """Grouped polyphase kernel: the L-tap strided conv re-expressed over
    D=20 decimated streams so the compute is the TRUE polyphase work
    (M x L/M MACs per output frame) instead of an L-wide dense window.

    Derivation: with a 20·ceil(L/20)=L-sample left pad, output
    u_p[k] = sum_r h[p+40r] · x[20k + L - p - 40r]. Writing the padded
    stream as frames x20[j, c] = x[20j + c], every branch p reads ONE
    column c(p) with taps at window offsets s = base(p) - 2r:
        p = 0:      c = 0,      base = 64
        p in 1..19: c = 20 - p, base = 63
        p = 20:     c = 0,      base = 63
        p in 21..39:c = 40 - p, base = 62
    Each column feeds exactly two branches -> a groups = 20 conv with
    kernel (M, 1, L/20 + 1). Returns (kernel, row_of_p) where conv output
    row row_of_p[p] is branch p.
    """
    h = prototype_filter(num_taps, cutoff_mhz)
    L = len(h)
    width = L // D + 1
    taps_per = L // M
    kern = np.zeros((M, 1, width), dtype=np.float32)
    row_of_p = np.zeros(M, dtype=np.int32)
    slot_used: dict[int, int] = {}
    cols = branch_columns()
    for p in range(M):
        c = int(cols[p])
        if p == 0:
            base = width - 1
        elif p <= D - 1 or p == D:
            base = width - 2
        else:
            base = width - 3
        slot = slot_used.get(c, 0)
        slot_used[c] = slot + 1
        j = 2 * c + slot
        row_of_p[p] = j
        for r in range(taps_per):
            kern[j, 0, base - 2 * r] = h[p + M * r]
    return kern, row_of_p


@lru_cache(maxsize=None)
def _dft_matrix():
    p = np.arange(M)
    m = np.arange(M)[:, None]
    e = np.exp(1j * 2 * np.pi * m * p / M)  # E[m, p]
    return e.real.astype(np.float32), e.imag.astype(np.float32)


@lru_cache(maxsize=None)
def _fused_kernel(num_taps: int, cutoff_mhz: float = 1.0):
    """Dense conv kernel with the DFT folded in: input channels are the
    20 I-frames + 20 Q-frames, output channels are y_i[0..39] + y_q[0..39]
    (before the (-1)^(mk) correction)."""
    kern, row_of_p = _poly_kernel(num_taps, cutoff_mhz)
    width = kern.shape[2]
    # K_p[c, s]: branch p's taps laid out over (column, shift)
    kp = np.zeros((M, D, width), dtype=np.float64)
    cols = branch_columns()
    for p in range(M):
        kp[p, cols[p], :] = kern[row_of_p[p], 0, :]
    er, ei = _dft_matrix()
    g_r = np.einsum("mp,pcs->mcs", er.astype(np.float64), kp)
    g_i = np.einsum("mp,pcs->mcs", ei.astype(np.float64), kp)
    w = np.zeros((2 * M, 2 * D, width), dtype=np.float32)
    w[:M, :D] = g_r          # y_i from I-frames:  er . u_i
    w[:M, D:] = -g_i         # y_i from Q-frames: -ei . u_q
    w[M:, :D] = g_i          # y_q from I-frames:  ei . u_i
    w[M:, D:] = g_r          # y_q from Q-frames:  er . u_q
    return w


@contextmanager
def true_fp32():
    """Run float32 convolutions and matmuls in true FP32. PyTorch lets
    cuDNN convolve float32 in TF32 by default (~3 decimal digits); a
    reduced-precision filterbank pass turns the -100 dB prototype into
    a ~-48 dB stopband and strong bursts ghost into other channels."""
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def frame_rows(i, q, num_taps: int, has_context: bool) -> torch.Tensor:
    """Frame prep shared by channelize and the fused front end: (N,) I/Q
    -> (40, J) float32 decimated frames, rows 0..19 = I streams, 20..39 =
    Q streams.

    The left pad is exactly L samples (one more than the filter history;
    the extra sample only makes the length frame-aligned), or 1 sample
    when the first num_taps-1 inputs are real history (has_context).
    """
    x = torch.stack([i.to(torch.float32), q.to(torch.float32)])   # (2, N)
    left = num_taps if not has_context else 1
    right = (-(left + x.shape[1])) % D
    x = torch.nn.functional.pad(x, (left, right))
    frames = x.reshape(2, x.shape[1] // D, D)                      # (2, J, 20)
    return frames.transpose(1, 2).reshape(2 * D, -1)               # (40, J)


def channelize(i, q, num_taps: int = DEFAULT_TAPS, has_context: bool = False,
               cutoff_mhz: float = 1.0, device=None):
    """(N,) wideband I/Q at 80 Msps -> (M, K) per-channel I/Q at 4 Msps.

    Output bin m covers BLE channel bin_to_channel(m). has_context=False:
    the input is zero-padded on the left, K = N // D and the first ~L/D
    outputs carry filter warm-up. has_context=True: the first
    num_taps-1 input samples are real history, K = (N - (num_taps-1)) // D
    and output k aligns with input sample (num_taps-1) + k*D. Runs on
    ``device`` (cuda unless the caller passes another).
    """
    dev = resolve_device(device)
    f_t = frame_rows(as_tensor(i, dev), as_tensor(q, dev), num_taps,
                     has_context)
    lhs = f_t.reshape(2, D, -1)                                    # (2, 20, J)
    kern, row_of_p = _poly_kernel(num_taps, cutoff_mhz)
    count("h2d_copies", 4)      # the DFT pair, the kernel, the row map
    er, ei = (torch.as_tensor(a, device=dev) for a in _dft_matrix())
    with true_fp32():
        u = torch.nn.functional.conv1d(
            lhs, torch.as_tensor(kern, device=dev), groups=D)       # (2, M, K)
        u = u[:, torch.as_tensor(row_of_p, dtype=torch.long, device=dev)]
        u_i, u_q = u[0], u[1]
        y_i = er @ u_i - ei @ u_q
        y_q = er @ u_q + ei @ u_i
    # (-1)^(m k) correction from D = M/2
    k_idx = torch.arange(y_i.shape[1], device=dev)
    m_idx = torch.arange(M, device=dev)[:, None]
    sign = 1.0 - 2.0 * ((m_idx * k_idx) % 2).to(torch.float32)
    return y_i * sign, y_q * sign


def compose_wideband(placements: list[tuple[int, int, np.ndarray, np.ndarray]],
                     num_samples: int, amplitude: float = 1.0,
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Place baseband bursts at their BLE channel carriers in one wideband
    stream — the TX-side inverse of the channelizer.

    placements: (ble_channel, start_sample, i80, q80) per burst, all at
    FS_MSPS; bursts may share a channel and may overlap in time (they sum,
    like real airspace).
    """
    x = np.zeros(num_samples, dtype=np.complex64)
    for ch, start, ci, cq in placements:
        seg = slice(max(0, start), min(start + len(ci), num_samples))
        m = seg.stop - seg.start
        if m <= 0:
            continue
        f_off = (2_402_000_000 + 2_000_000 * int(CHANNEL_TO_GRID[ch]) - CENTER_FREQ_HZ)
        n_seg = seg.start + np.arange(m)  # absolute index keeps carriers coherent
        carrier = np.exp(1j * 2 * np.pi * (f_off / (FS_MSPS * 1e6)) * n_seg)
        lo = seg.start - start
        x[seg] += (amplitude * (np.asarray(ci[lo:lo + m])
                                + 1j * np.asarray(cq[lo:lo + m])) * carrier
                   ).astype(np.complex64)
    return x.real.astype(np.float32), x.imag.astype(np.float32)


def synthesize_wideband(channel_signals: dict[int, tuple[np.ndarray, np.ndarray]],
                        num_samples: int, offsets: dict[int, int] | None = None,
                        amplitude: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """Test/benchmark helper: place per-channel 80 Msps baseband bursts at
    their BLE channel offsets in one wideband stream.

    channel_signals: {ble_channel: (i80, q80)} already at 80 Msps.
    offsets: optional start sample per channel.
    """
    return compose_wideband(
        [(ch, (offsets or {}).get(ch, 0), ci, cq)
         for ch, (ci, cq) in channel_signals.items()],
        num_samples, amplitude)
