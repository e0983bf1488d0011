"""Channel impairment models as batched torch ops.

Port of btle_tpu/sim/channel.py. Semantics follow the reference
simulators (btlelib.py:823-873):
  * ppm model — joint sampling-clock stretch (linear resample) and carrier
    frequency offset exp(j*2*pi*ppm*2450MHz*t),
  * AWGN with SNR referenced to the int8 peak power 127^2.
Every function works on the last axis and takes any leading batch axes
(the JAX package vmaps over packets). The float32 arithmetic runs in the
order the JAX code compiles to, so the resample and the CFO phase agree
with it to a few float32 ulps: the phase reaches ~300 rad, where one ulp
of it moves a sample by 127 * 3e-5 = 0.004.
"""

from __future__ import annotations

import math

import numpy as np
import torch

CENTER_FREQ_HZ = 2450e6


def apply_ppm(i, q, ppm, sps: int):
    """Resample by (1+ppm*1e-6) and rotate by the induced CFO."""
    i = i.to(torch.float32)
    q = q.to(torch.float32)
    n = i.shape[-1]
    # the scalars in float32 on the host. The phase is 2*pi * fo * ts * idx
    # with fo = err * 2450e6 and ts = (1/sps) * 1e-6 * (1 + err), its
    # constants grouped as XLA folds the JAX expression:
    # ((ppm * f32(1e-6 * 2450e6)) * (1 + err)) * f32(2*pi * 1e-6/sps)
    f32 = np.float32
    p = f32(ppm)
    stretch = f32(1.0) + p * f32(1e-6)
    step = (p * (f32(1e-6) * f32(CENTER_FREQ_HZ)) * stretch
            * (f32(2.0 * math.pi) * f32((1.0 / sps) * 1e-6)))
    idx = torch.arange(n, dtype=torch.float32, device=i.device)
    pos = idx * float(stretch)
    i0 = torch.floor(pos).to(torch.int64).clamp(0, n - 1)
    i1 = (i0 + 1).clamp(0, n - 1)
    frac = (pos - i0.to(torch.float32)).clamp(0.0, 1.0)
    ir = i[..., i0] * (1 - frac) + i[..., i1] * frac
    qr = q[..., i0] * (1 - frac) + q[..., i1] * frac
    phase = idx * float(step)
    c = torch.cos(phase)
    s = torch.sin(phase)
    return ir * c - qr * s, ir * s + qr * c


def awgn(i, q, snr_db, generator: torch.Generator | None = None,
         noise=None):
    """AWGN at int8-peak-referenced SNR (btlelib.py:859-873): per-component
    sigma 127 / 10^(snr/20) / sqrt(2), in float32 as the JAX code has it.

    The standard normal draws come from ``generator`` (on the device of
    ``i``; torch's default generator when None) or, for tests that feed
    two packages the same draws, from ``noise`` = (ni, nq) of i's shape.
    Statistically equal to the JAX package's jax.random stream, not
    bit-equal to it.
    """
    i = i.to(torch.float32)
    q = q.to(torch.float32)
    snr = torch.tensor(float(snr_db), dtype=torch.float32)
    sigma = float(127.0 / torch.pow(torch.tensor(10.0), snr / 20.0)
                  / torch.sqrt(torch.tensor(2.0)))
    if noise is None:
        ni = torch.randn(i.shape, generator=generator, device=i.device)
        nq = torch.randn(q.shape, generator=generator, device=q.device)
    else:
        ni, nq = (torch.as_tensor(v, dtype=torch.float32, device=i.device)
                  for v in noise)
    return i + ni * sigma, q + nq * sigma


def quantize_int16(i, q):
    """Round to int16 the way captures are fed to the receiver."""
    return (i.round().clamp(-32768, 32767).to(torch.int16),
            q.round().clamp(-32768, 32767).to(torch.int16))
