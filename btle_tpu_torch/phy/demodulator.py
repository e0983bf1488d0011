"""Phase-difference GFSK demodulation + access-address correlation (torch).

Port of btle_tpu/phy/demodulator.py. d[n] = i[n]*q[n+lag] - i[n+lag]*q[n],
bit[n] = d[n] > 0; the access-address correlation is a 32-tap filter
over the bit lattice with tap spacing ``sps`` (one symbol). Every
function takes a leading batch axis (the channel axis) or none: the JAX
package vmaps over channels, the port writes that axis out.
"""

from __future__ import annotations

import torch

AA_BITS = 32


def phase_diff(i: torch.Tensor, q: torch.Tensor, lag: int) -> torch.Tensor:
    """d[n] = i[n]*q[n+lag] - i[n+lag]*q[n] over the last axis, length
    N-lag. Integer inputs use exact int32 arithmetic; float inputs
    (channelizer output) stay float32."""
    dt = torch.float32 if i.is_floating_point() else torch.int32
    i, q = i.to(dt), q.to(dt)
    return i[..., :-lag] * q[..., lag:] - i[..., lag:] * q[..., :-lag]


def decisions(i: torch.Tensor, q: torch.Tensor, lag: int) -> torch.Tensor:
    """Hard bit decisions on the full-rate lattice (int8 of 0/1)."""
    return (phase_diff(i, q, lag) > 0).to(torch.int8)


def aa_match_counts(bits: torch.Tensor, aa_bits, aa_mask, sps: int) -> torch.Tensor:
    """Per-position count of matching (unmasked) access-address bits.

    bits: (..., N) 0/1 lattice; aa_bits (32,) or (..., 32). Returns
    (..., N - 31*sps) int32 where entry n is
    #{j : mask[j] and bits[n+j*sps] == aa[j]}. With s = 2b-1 and
    t = (2a-1)*mask, sum(s*t) = matches - mismatches over masked taps
    (exact small integers in float32), so matches = (corr + n_mask) / 2.
    """
    s = bits.to(torch.float32) * 2 - 1
    aa = torch.as_tensor(aa_bits, device=bits.device).to(torch.float32)
    mask = torch.as_tensor(aa_mask, device=bits.device).to(torch.float32)
    t = (aa * 2 - 1) * mask
    n_out = bits.shape[-1] - (AA_BITS - 1) * sps
    corr = torch.zeros(bits.shape[:-1] + (n_out,), dtype=torch.float32,
                       device=bits.device)
    for j in range(AA_BITS):
        corr = corr + s[..., j * sps: j * sps + n_out] * t[..., j: j + 1]
    n_mask = mask.sum()
    return ((corr + n_mask) * 0.5).to(torch.int32)


def aa_hits(i, q, aa_bits, aa_mask, sps: int, lag: int):
    """Full-rate hit mask: position n is a hit iff all unmasked AA bits
    match starting at lattice position n with symbol stride sps. Returns
    (hit (..., N - lag - 31*sps) bool, bits (..., N - lag) int8)."""
    bits = decisions(i, q, lag)
    counts = aa_match_counts(bits, aa_bits, aa_mask, sps)
    n_mask = torch.as_tensor(aa_mask, device=bits.device).to(torch.int32).sum()
    return counts == n_mask, bits
