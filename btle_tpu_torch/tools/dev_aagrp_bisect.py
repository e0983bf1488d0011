"""K8 on Hopper: the AA stage and the demod tail on real GFSK lattices.

Port of tools/dev_aagrp_bisect.py. The TPU tool added the fused
kernel's context back around the AA correlation one layer at a time to
bisect the AA_GRP=4 hardware miscompile; each layer was a standalone
Pallas kernel diffed against numpy. On Hopper each layer maps onto the
port's kernels, with no new code in them:

  aa-only, aa-only-scratch  the AA stage on loaded decisions: ``aa_corr``
            on the int8 decision lattice (+-1 in the kernel). The VMEM
            scratch round trip of the second form has no counterpart.
  dma-mm    the production kernel's shape: the tool's identity 80x80
            product of a frame tile in true FP32, then the demod tail:
            K3 (``filterbank_polyx_f32``) at 80 rows, one slice, all-ones
            coefficients and w4x = the identity (x 1.0 and one nonzero
            term per row are exact), then K2 (``demod_tail``), 2 tiles.
  tail      K2 on y = [y_i; y_q] with the tool's AA rows and a full mask.
  grid2     the same under the tool's 2-tile grid whose tiles both read
            the same y (index map (0, 0)): K2 launched once per tile.

Each variant runs at GRP 8 and 4, the TPU's roll groupings; on Hopper
GRP is aa_corr's accumulation grouping and K2's AA test is an exact
integer compare, so neither can change a result. Every variant must
equal the tool's numpy truth (bits and hits) exactly.

Usage: python -m btle_tpu_torch.tools.dev_aagrp_bisect [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from functools import lru_cache

import numpy as np

M = 40
AA_BITS = 32
SPS = 4
LAG = 4
T = 2048
YCOLS = T + max((AA_BITS - 1) * SPS + LAG, AA_BITS * SPS - 1)   # fused._ycols
NB = T + (AA_BITS - 1) * SPS
GROUPS = (8, 4)


def numpy_tail(y_i, y_q, tsign, lag=LAG, sps=SPS):
    """Ground truth for _demod_tail's bits/hit outputs (even lag)."""
    nb = T + (AA_BITS - 1) * sps
    d = (y_i[:, :nb] * y_q[:, lag: nb + lag]
         - y_i[:, lag: nb + lag] * y_q[:, :nb])
    bits = (d > 0)
    s = np.where(bits, 1.0, -1.0)
    acc = np.zeros((M, T), np.float64)
    for j in range(AA_BITS):
        acc += tsign[:, j: j + 1] * s[:, j * sps: j * sps + T]
    hit = acc == AA_BITS
    return bits[:, :T].astype(np.int8), hit.astype(np.int8)


@lru_cache(maxsize=1)
def make_inputs():
    """The tool's scene: per-channel AA rows and REAL GFSK lattices with
    each channel's AA planted at a known position (random decisions never
    reach acc == 32). Returns (aa_rows (M, 32) float32 0/1, tsign, y_i,
    y_q (M, YCOLS) float32)."""
    from ..golden.model import gfsk_modulate_float

    rng = np.random.default_rng(3)
    aa_rows = rng.integers(0, 2, (M, AA_BITS)).astype(np.float32)
    tsign = aa_rows * 2 - 1
    y_i = np.zeros((M, YCOLS), np.float32)
    y_q = np.zeros((M, YCOLS), np.float32)
    for c in range(M):
        nbits = YCOLS // SPS + 8
        bits = rng.integers(0, 2, nbits).astype(np.int8)
        p0 = 40 + 3 * c
        bits[p0: p0 + AA_BITS] = aa_rows[c].astype(np.int8)
        gi, gq = gfsk_modulate_float(bits, SPS)
        y_i[c] = gi[:YCOLS] / 127.0
        y_q[c] = gq[:YCOLS] / 127.0
    return aa_rows, tsign, y_i, y_q


def dma_frames(y_i, y_q, n_tiles: int = 2) -> np.ndarray:
    """The tool's dma-mm frames: the y lattices tiled across the grid
    (tile t's window starts at t*T), 80 rows."""
    fcols = -(-YCOLS // 128) * 128
    frames = np.zeros((80, (n_tiles - 1) * T + fcols), np.float32)
    for t in range(n_tiles):
        frames[:M, t * T: t * T + YCOLS] = y_i[:, :YCOLS]
        frames[M:, t * T: t * T + YCOLS] = y_q[:, :YCOLS]
    return frames


def dma_truth(frames: np.ndarray, tsign, n_tiles: int = 2):
    """numpy_tail per tile of the frames, concatenated."""
    wb, wh = [], []
    for t in range(n_tiles):
        ftile = frames[:, t * T: t * T + YCOLS]
        b, h = numpy_tail(ftile[:M], ftile[M:], tsign)
        wb.append(b)
        wh.append(h)
    return np.concatenate(wb, 1), np.concatenate(wh, 1)


def tail(y, aa_rows, mask, n_tiles: int = 1):
    """K2 over the (80, ky) y: bits (M, n_tiles*T) int8 and hits; the AA
    test reads n_tiles*T + 31*sps decisions."""
    from ..wideband.fused import demod_tail

    n_hit = n_tiles * T
    bits, hit, _ = demod_tail(y, aa_rows, mask, SPS, LAG,
                              n_hit + (AA_BITS - 1) * SPS, n_hit)
    return bits[:, :n_hit], hit.to(bits.dtype)


def dma_mm(frames, aa_rows, mask, n_tiles: int = 2):
    """K3 at rows 80, one slice (y = I @ (frames x 1.0), true FP32), then
    K2 over the whole grid's columns."""
    import torch

    from ..wideband.fused import filterbank_polyx_f32

    dev = frames.device
    ones = torch.ones((80, 1), dtype=torch.float32, device=dev)
    eye = torch.eye(80, dtype=torch.float32, device=dev)
    y = filterbank_polyx_f32(frames, ones, eye, (n_tiles - 1) * T + YCOLS,
                             stack=1)
    return tail(y, aa_rows, mask, n_tiles)


def run(device=None, echo=None) -> dict:
    """Every variant at GRP 8 and 4 on ``device`` (cuda unless the caller
    passes another), each against the numpy truth. Returns {"device",
    "planted_hits", "variants": {name: "exact match" | mismatch text},
    "failures"}; ``echo`` receives the tool's result lines."""
    import torch

    from .._device import resolve_device
    from ._kernels import aa_corr

    dev = resolve_device(device)
    say = echo or (lambda line: None)
    say(f"device: {dev}")
    aa_rows, tsign, y_i, y_q = make_inputs()
    want_bits, want_hit = numpy_tail(y_i, y_q, tsign)
    d_full = (y_i[:, :NB] * y_q[:, LAG: NB + LAG]
              - y_i[:, LAG: NB + LAG] * y_q[:, :NB])
    want_bits_full = (d_full > 0).astype(np.int8)
    n_hits = int(want_hit.sum())
    if n_hits < M:
        raise AssertionError(f"scene must plant hits, got {n_hits}")
    say(f"planted AA hits in truth: {n_hits}")

    rows = torch.as_tensor(aa_rows.astype(np.int8), device=dev)
    mask = torch.ones(AA_BITS, dtype=torch.int8, device=dev)
    signs = torch.as_tensor(tsign, device=dev)
    decisions = torch.as_tensor(want_bits_full, device=dev)
    y = torch.as_tensor(np.concatenate([y_i, y_q]), device=dev)
    frames_np = dma_frames(y_i, y_q)
    frames = torch.as_tensor(frames_np, device=dev)
    dma_bits, dma_hit = dma_truth(frames_np, tsign)

    variants, failures = {}, 0

    def check(name, got_bits, got_hit, w_bits, w_hit):
        nonlocal failures
        nb = 0 if got_bits is None else int((got_bits.cpu().numpy() != w_bits).sum())
        nh = int((got_hit.cpu().numpy() != w_hit).sum())
        text = "exact match" if nb == 0 and nh == 0 else f"MISMATCH bits={nb} hit={nh}"
        failures += text != "exact match"
        variants[name] = text
        say(f"{name}: {text}")

    for grp in GROUPS:
        for form in ("aa-only", "aa-only-scratch"):
            _, hit = aa_corr(decisions, signs, SPS, T, grp=grp)
            check(f"{form} GRP={grp}", None, hit, None, want_hit)
    for grp in GROUPS:
        bits, hit = dma_mm(frames, rows, mask)
        check(f"dma-mm GRP={grp}", bits, hit, dma_bits, dma_hit)
    for name, n_tiles in (("tail", 1), ("grid2", 2)):
        for grp in GROUPS:
            outs = [tail(y, rows, mask) for _ in range(n_tiles)]
            check(f"{name} GRP={grp}", torch.cat([o[0] for o in outs], 1),
                  torch.cat([o[1] for o in outs], 1),
                  np.tile(want_bits, (1, n_tiles)), np.tile(want_hit, (1, n_tiles)))
    say("RESULT: " + ("no divergence at this layer" if failures == 0
                      else f"{failures} diverging variants"))
    return {"device": str(dev), "planted_hits": n_hits, "variants": variants,
            "failures": failures}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain twins)")
    args = ap.parse_args(argv)
    return 1 if run(args.device, echo=lambda line: print(line, flush=True))["failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
