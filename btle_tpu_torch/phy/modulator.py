"""GFSK modulators in PyTorch, batched over a leading dimension.

Port of btle_tpu/phy/modulator.py. Two bit-exact fixed-point flavors
(see golden.model for the reference semantics and citations):

* ``python`` flavor — btlelib.gfsk_modulation_fixed_point semantics
  (btlelib.py:146-189): sample-repeat NRZ upsample, int FIR, >>1, phase
  accumulator over a 2048-entry table (at sps=8).
* ``c`` flavor — gen_sample_from_phy_bit semantics (btle_tx.c:1022-1085):
  zero-stuffed impulse train, 9-tap FIR accumulated straight into a
  mod-1024 phase accumulator (at sps=4).

Everything is integer arithmetic, so results are exact on any device.
The convolutions are windowed integer sums (``unfold`` and an int64
sum), never a float ``conv1d``: CUDA has no integer convolution, and a
float one is not exact under TF32 or a reordered sum. ``torch.cumsum``
of int32 returns int64 where ``jnp.cumsum`` wraps at 32 bits; the
``& mask`` that follows keeps only the low bits, which agree. The
modulators run on the device of their ``bits`` tensor; the JAX
package's ``jax.vmap`` becomes the leading batch dimension.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .tables import c_mod_tables, golden_mod_tables


@lru_cache(maxsize=None)
def _device_tables(flavor: str, sps: int, device: torch.device):
    """(taps int64, cos int8, sin int8, mask) of a flavor on ``device``."""
    taps, cos_t, sin_t, mask = (golden_mod_tables if flavor == "python"
                                else c_mod_tables)(sps)
    return (torch.as_tensor(taps, dtype=torch.int64, device=device),
            torch.as_tensor(cos_t, device=device),
            torch.as_tensor(sin_t, device=device), mask)


def _correlate_valid(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[..., k] = sum_m x[..., k + m] * w[m] over the valid range,
    exact in int64."""
    return (x.to(torch.int64).unfold(-1, w.shape[0], 1) * w).sum(-1)


def _conv_full_i32(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """'full' integer convolution of the last axis with ``taps``."""
    t = taps.shape[0]
    xp = torch.nn.functional.pad(x.to(torch.int64), (t - 1, t - 1))
    return _correlate_valid(xp, taps.flip(0)).to(torch.int32)


def modulate_python(bits: torch.Tensor, sps: int = 8):
    """python-flavor modulator. bits: (..., L) of 0/1 -> (i8, q8) of
    length L*sps + 2*sps, bit-exact vs golden.gfsk_modulate_python."""
    taps, cos_t, sin_t, mask = _device_tables("python", sps, bits.device)
    nrz = bits.to(torch.int32) * 2 - 1
    up = nrz.repeat_interleave(sps, dim=-1)
    t = taps.shape[0]
    warm = torch.full((*up.shape[:-1], t), -1, dtype=torch.int32,
                      device=bits.device)
    y = _conv_full_i32(torch.cat([warm, up], dim=-1), taps)
    y = y[..., t: t + up.shape[-1] + t - 1]
    y = y >> 1                                  # arithmetic, as jnp.right_shift
    acc = torch.cumsum(y, dim=-1) & mask
    return cos_t[acc], sin_t[acc]


def modulate_c(bits: torch.Tensor, sps: int = 4):
    """C-flavor modulator. bits: (..., L) of 0/1 -> (i8, q8) of length
    L*sps + 4*sps, bit-exact vs gen_sample_from_phy_bit."""
    taps, cos_t, sin_t, mask = _device_tables("c", sps, bits.device)
    lg = 4 * sps
    n_bits = bits.shape[-1]
    num_sample = n_bits * sps + lg

    # impulse train with lg-1 leading and lg-1 trailing zeros
    x = torch.zeros((*bits.shape[:-1], num_sample + lg - 2), dtype=torch.int32,
                    device=bits.device)
    at = torch.arange(n_bits, device=bits.device) * sps + (lg - 1)
    x[..., at] = bits.to(torch.int32) * 2 - 1

    # effective taps: gauss_coef_int8[4..12] applied at window offset 3
    corr = _correlate_valid(x, taps[4:13])
    a = corr[..., 3: 3 + num_sample - 1]
    acc = torch.cumsum(a, dim=-1) & mask
    idx = torch.cat([torch.zeros((*acc.shape[:-1], 1), dtype=acc.dtype,
                                 device=acc.device), acc], dim=-1)
    return cos_t[idx], sin_t[idx]


def modulate_batch(bits: torch.Tensor, flavor: str = "python",
                   sps: int | None = None):
    """(B, L) bit batch -> (B, num_sample) int8 i and q, on the device of
    ``bits``.

    Fixed L per batch; variable-length packets are handled by the caller
    padding bits with zeros and tracking true lengths (output sample count
    for a packet of ``l`` bits is l*sps + span*sps).
    """
    if flavor == "python":
        return modulate_python(bits, sps=sps or 8)
    if flavor == "c":
        return modulate_c(bits, sps=sps or 4)
    raise ValueError(flavor)


def num_samples(num_bits: int, flavor: str = "python", sps: int | None = None) -> int:
    if flavor == "python":
        sps = sps or 8
        return num_bits * sps + 2 * sps
    sps = sps or 4
    return num_bits * sps + 4 * sps
