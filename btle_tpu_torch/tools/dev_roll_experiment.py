"""K11 on Hopper: the im2col filterbank and the AA correlation, each in
the TPU tool's variants, at one 131072-sample block.

Port of tools/dev_roll_experiment.py. The TPU tool asked whether one
strided pltpu.roll could replace the chains of lane rolls (slice copies)
of the im2col filterbank and of the AA correlation. Its variants are
Mosaic schedules of two functions, and on Hopper each function is one
kernel, fed each variant's operands with that variant's reordering
undone:

  im2col-copy, im2col-sroll (sroll32 in bf16)  K5 (``filterbank_im2col``,
            kind "f32_im2col", or "bf16" with --dtype bf16) on the tool's
            G (5, 80, 520), which is already K5's bf16 weight layout (at
            f32, ``convert.sgemm_weights`` lays it out as (40, 65, 80));
            the sroll variants reverse the shifts inside each chunk of G,
            undone before the launch.
  aa-fma, aa-sroll, aa-mxu  ``aa_corr`` on the +-1 lattice: the per-tap
            weights as they are (fma, summed one tap at a time), reversed
            inside each group of 8 (sroll) or spread over the
            block-diagonal (4, 40, 320) matmul weights (mxu), both undone
            and summed in groups of 8.

The checksums (sum of y or acc, and the float64 sum of its first 64
columns) must MATCH pairwise, as the tool requires; the AA variants must
also equal the numpy truth exactly. Times are CUDA events over 4
distinct device-resident blocks (the median of the trials), beside each
kernel's bound and a library yardstick: one cuDNN convolution (true FP32
or bf16) for im2col, one grouped dilated convolution for the AA stage.

Usage: python -m btle_tpu_torch.tools.dev_roll_experiment [im2col|aa|all]
           [--dtype f32|bf16] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from functools import lru_cache

import numpy as np

M, D = 40, 20
T = 2048
YCOLS = T + 128          # _ycols(2048, 4, 4)
FCOLS = 2304             # _fcols(2048, 65, 4, 4)
WIDTH = 65
N_CHUNKS = 5
CHUNK = 13
N_TILES = 64             # one 131k block worth
N_BLOCKS = 4             # distinct input blocks rotated per dispatch
AA_GRP = 8
SPS = 4


@lru_cache(maxsize=2)
def make_inputs(n_tiles: int = N_TILES):
    """The tool's inputs, drawn in its order from one seeded generator:
    (G (5, 80, 520), FRAMES [(40, n_tiles*T + FCOLS)] x 4, TSIGN (40, 32),
    LAT [(40, n_tiles*T + 128) +-1] x 4), float32."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(N_CHUNKS, 2 * M, CHUNK * 2 * D)).astype(np.float32)
    frames = [rng.normal(size=(2 * D, n_tiles * T + FCOLS)).astype(np.float32)
              for _ in range(N_BLOCKS)]
    tsign = rng.choice([-1.0, 1.0], size=(M, 32)).astype(np.float32)
    lat = [rng.choice([-1.0, 1.0], size=(M, n_tiles * T + 128)).astype(np.float32)
           for _ in range(N_BLOCKS)]
    return g, frames, tsign, lat


def reverse_chunks(g: np.ndarray) -> np.ndarray:
    """The sroll variants' G: column block j of each chunk <- CHUNK-1-j.
    Its own inverse."""
    gr = g.reshape(N_CHUNKS, 2 * M, CHUNK, 2 * D)[:, :, ::-1, :]
    return np.ascontiguousarray(gr.reshape(N_CHUNKS, 2 * M, CHUNK * 2 * D))


def aa_weights(variant: str, tsign: np.ndarray) -> np.ndarray:
    """The tool's AA weight layout of ``variant`` (make_aa)."""
    if variant == "sroll":
        return np.ascontiguousarray(
            tsign.reshape(M, 32 // AA_GRP, AA_GRP)[:, :, ::-1].reshape(M, 32))
    if variant == "mxu":
        w4 = np.zeros((4, M, AA_GRP * M), np.float32)
        for g in range(4):
            for r in range(AA_GRP):
                j = AA_GRP * g + AA_GRP - 1 - r
                w4[g, np.arange(M), r * M + np.arange(M)] = tsign[:, j]
        return w4
    return tsign


def aa_signs(variant: str, w: np.ndarray) -> np.ndarray:
    """Undo ``aa_weights``: the (40, 32) per-tap signs."""
    if variant == "sroll":
        return aa_weights("sroll", w)           # the reversal is an involution
    if variant == "mxu":
        out = np.zeros((M, 32), np.float32)
        for g in range(4):
            for r in range(AA_GRP):
                out[:, AA_GRP * g + AA_GRP - 1 - r] = w[g, np.arange(M),
                                                       r * M + np.arange(M)]
        return out
    return w


def aa_truth(lat: np.ndarray, tsign: np.ndarray, n_cols: int) -> np.ndarray:
    """acc[c, t] = sum_j tsign[c, j] * lat[c, t + 4j], in float64."""
    acc = np.zeros((M, n_cols), np.float64)
    for j in range(32):
        acc += tsign[:, j: j + 1] * lat[:, SPS * j: SPS * j + n_cols]
    return acc


def im2col_weights(g):
    """The (80, 40, 65) convolution weights of G: W[o, i, c*13 + j] =
    G[c, o, j*40 + i] (the cuDNN yardstick's layout)."""
    return (g.reshape(N_CHUNKS, 2 * M, CHUNK, 2 * D).permute(1, 3, 0, 2)
            .reshape(2 * M, 2 * D, N_CHUNKS * CHUNK).contiguous())


def checksums(out) -> tuple[float, float]:
    """The tool's two checksums: the sum, and the float64 sum of the
    first 64 columns."""
    import torch

    return float(out.sum()), float(out[:, :64].to(torch.float64).sum())


def _timed(res: dict, dev, kernel, plain, library, blocks, iters, trials):
    from ._measure import time_blocks

    if dev.type != "cuda":
        res["ms"] = res["plain_ms"] = res["library_ms"] = "not measured"
        return
    res["ms"], res["ms_trials"] = time_blocks(kernel, blocks, iters, trials)
    res["plain_ms"], _ = time_blocks(plain, blocks, 2, 1)
    res["library_ms"], _ = time_blocks(library, blocks, iters, trials)


def run_im2col(dev, dtype: str, n_tiles: int, iters: int, trials: int) -> dict:
    import torch

    from ..convert import sgemm_weights
    from ..wideband.channelizer import true_fp32
    from ..wideband.fused import filterbank_im2col, filterbank_im2col_reference
    from ._measure import BF16_FLOPS, FP32_FLOPS, bound_ms

    g, frames_np, _, _ = make_inputs(n_tiles)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    kind = "f32_im2col" if dtype == "f32" else "bf16"
    frames = [torch.as_tensor(f, device=dev).to(tdt) for f in frames_np]
    n_cols = n_tiles * T
    out = {}
    for variant in (("copy", "sroll") if dtype == "f32" else ("copy", "sroll32")):
        layout = g if variant == "copy" else reverse_chunks(g)
        gk = torch.as_tensor(layout if variant == "copy" else reverse_chunks(layout),
                             device=dev).to(tdt)
        w = im2col_weights(gk)
        if dtype == "f32":      # the FP32 kernel's (40, S, 80) layout
            gk = sgemm_weights(gk)
        y = filterbank_im2col(frames[0], gk, WIDTH, n_cols, kind)
        res = {"checksum": checksums(y)}
        res["bound_ms"], res["bound_by"] = bound_ms(
            frames[0].numel() * frames[0].element_size()
            + gk.numel() * gk.element_size() + 80 * n_cols * 4,
            2 * 80 * 40 * WIDTH * n_cols, FP32_FLOPS if dtype == "f32" else BF16_FLOPS)

        def library(f, w=w):
            with true_fp32():
                return torch.nn.functional.conv1d(f[None], w)[0, :, :n_cols]
        _timed(res, dev, lambda f, gk=gk: filterbank_im2col(f, gk, WIDTH, n_cols, kind),
               lambda f, gk=gk: filterbank_im2col_reference(f, gk, WIDTH, n_cols, kind),
               library, frames, iters, trials)
        out[f"im2col-{variant}"] = res
    return out


def run_aa(dev, n_tiles: int, iters: int, trials: int) -> dict:
    import torch

    from ..wideband.channelizer import true_fp32
    from ._kernels import aa_corr, aa_corr_reference
    from ._measure import FP32_FLOPS, bound_ms

    _, _, tsign, lat_np = make_inputs(n_tiles)
    lat = [torch.as_tensor(v, device=dev) for v in lat_np]
    n_cols = n_tiles * T
    truth = aa_truth(lat_np[0], tsign, n_cols)
    truth_chk = (float(truth.sum()), float(truth[:, :64].sum()))
    out = {}
    for variant in ("fma", "sroll", "mxu"):
        w = torch.as_tensor(aa_signs(variant, aa_weights(variant, tsign)), device=dev)
        grp = 1 if variant == "fma" else AA_GRP
        acc, _ = aa_corr(lat[0], w, SPS, n_cols, grp=grp)
        res = {"checksum": checksums(acc), "truth_checksum": truth_chk,
               "exact": bool(np.array_equal(acc.cpu().numpy(), truth))}
        res["bound_ms"], res["bound_by"] = bound_ms(
            lat[0].numel() * 4 + w.numel() * 4 + M * n_cols * 5,
            2 * M * 32 * n_cols, FP32_FLOPS)

        def library(s, w=w):
            with true_fp32():
                return torch.nn.functional.conv1d(s[None], w[:, None, :], groups=M,
                                                  dilation=SPS)[0, :, :n_cols]
        _timed(res, dev, lambda s, w=w, grp=grp: aa_corr(s, w, SPS, n_cols, grp=grp),
               lambda s, w=w: aa_corr_reference(s, w, SPS, n_cols),
               library, lat, iters, trials)
        out[f"aa-{variant}"] = res
    return out


PAIRS = (("im2col-copy", "im2col-sroll"), ("im2col-copy", "im2col-sroll32"),
         ("aa-fma", "aa-sroll"), ("aa-fma", "aa-mxu"))


def run(device=None, which: str = "all", dtype: str = "f32",
        n_tiles: int = N_TILES, iters: int = 192, trials: int = 9,
        echo=None) -> dict:
    """The tool's variants of ``which`` ("im2col", "aa" or "all") at
    ``dtype`` on ``device`` (cuda unless the caller passes another).
    Returns {"device", "dtype", "variants": {name: result}, "pairs":
    {new: "MATCH" | "DIFF!"}, "failures"}; ``echo`` receives the tool's
    result lines."""
    from .._device import resolve_device
    from ._measure import checksums_match

    if which not in ("im2col", "aa", "all") or dtype not in ("f32", "bf16"):
        raise ValueError(f"which must be im2col|aa|all and dtype f32|bf16, got "
                         f"{which!r}, {dtype!r}")
    dev = resolve_device(device)
    say = echo or (lambda line: None)
    say(f"device: {dev} dtype: {dtype}")
    results = {}
    if which in ("all", "im2col"):
        results.update(run_im2col(dev, dtype, n_tiles, iters, trials))
    if which in ("all", "aa"):
        results.update(run_aa(dev, n_tiles, iters, trials))
    failures = 0
    for name, r in results.items():
        t = ("time not measured (no card)" if r["ms"] == "not measured" else
             f"{r['ms']:.4f} ms/block ({min(r['ms_trials']):.4f}-"
             f"{max(r['ms_trials']):.4f}) library {r['library_ms']:.4f} ms "
             f"plain {r['plain_ms']:.4f} ms")
        exact = "" if "exact" not in r else (
            " exact match" if r["exact"] else " MISMATCH vs numpy truth")
        failures += "exact" in r and not r["exact"]
        say(f"{name}: {t} bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
            f"chk={r['checksum'][1]:.6f}{exact}")
    pairs = {}
    for base, new in PAIRS:
        if base in results and new in results:
            cb, cn = results[base]["checksum"][1], results[new]["checksum"][1]
            pairs[new] = "MATCH" if checksums_match(cb, cn) else "DIFF!"
            failures += pairs[new] != "MATCH"
            mb, mn = results[base]["ms"], results[new]["ms"]
            speed = f"{mb / mn:.2f}x" if isinstance(mb, float) else "not measured"
            say(f"{new}: {speed} vs {base} [checksum {pairs[new]}]")
    say("RESULT: " + ("every checksum MATCH" if failures == 0
                      else f"{failures} variants DIFF"))
    return {"device": str(dev), "dtype": dtype, "variants": results,
            "pairs": pairs, "failures": failures}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="all", choices=["im2col", "aa", "all"])
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                    help="the im2col frames' and weights' type")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain twins "
                         "and times nothing)")
    args = ap.parse_args(argv)
    res = run(args.device, args.which, args.dtype,
              echo=lambda line: print(line, flush=True))
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
