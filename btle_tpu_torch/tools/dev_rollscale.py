"""K10 on Hopper: how does the cost of shifted per-row FMAs scale with
the number of stacked frame rows?

Port of tools/dev_rollscale.py. The TPU tool measured the same total FMA
work three ways — R = 40 rows and N = 65 unaligned slices, R = 80 and
N = 33 (2 pre-shifted copies stacked), R = 160 and N = 17 (4 copies) —
to learn whether Mosaic's lane rolls cost per op or per row (K3's
POLYX_STACK question). On Hopper there is no roll: ``shift_fma`` streams
the rows of 512 + STEP*(N-1)-column tiles through a cp.async ring in
shared memory and reads the shifted slices from there, so the question
becomes whether the time follows the bytes (R grows) or the FMAs
(constant). Each configuration:

  out[c, k] = fold( sum_{j<N} f[r, k + STEP*j] * kc[r, j] ),  k < 64*2048

with the tool's fold of row groups down to 40 and GRP, the tool's
register grouping, ordering only the plain twin's sum. The kernel is
held against the twin (max |d| <= 1e-5 of max |out|, float32 sums in
another order) and the checksums must MATCH; the time is CUDA events,
the median of the trials, over 4 distinct device-resident frame blocks,
beside the bound and a library yardstick (one grouped dilated true-FP32
convolution, then the fold).

Usage: python -m btle_tpu_torch.tools.dev_rollscale [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

T = 2048
YCOLS = T + 128
N_TILES = 64
N_BLOCKS = 4
CONFIGS = ((40, 65, 2, 8), (80, 33, 4, 8), (160, 17, 8, 4), (160, 17, 8, 2))
TOLERANCE = 1e-5    # max |kernel - twin| over max |twin|


def fcols(n: int, step: int) -> int:
    """Frame columns per tile in the tool (make_kernel's FCOLS)."""
    return -(-(YCOLS + n * step) // 128) * 128


def make_inputs(rows: int, n: int, step: int, n_tiles: int, device, seed: int = 0):
    """kc (rows, n) and N_BLOCKS distinct frame blocks (rows, n_tiles*T +
    FCOLS), standard normal, drawn on ``device`` from a seeded generator."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    kc = torch.randn((rows, n), generator=gen, device=device)
    frames = [torch.randn((rows, n_tiles * T + fcols(n, step)), generator=gen,
                          device=device) for _ in range(N_BLOCKS)]
    return kc, frames


def library_call(f, kc, n_cols: int, step: int):
    """One grouped, dilated true-FP32 convolution (row r with its own N
    taps, STEP apart) and the fold: the same function as a yardstick."""
    import torch

    from ..wideband.channelizer import true_fp32
    from ._kernels import fold_rows

    with true_fp32():
        a = torch.nn.functional.conv1d(f[None], kc[:, None, :], groups=kc.shape[0],
                                       dilation=step)[0]
    return fold_rows(a[:, :n_cols])


def probe(rows: int, n: int, step: int, grp: int, kc, frames, n_cols: int,
          iters: int = 96, trials: int = 3) -> dict:
    """One configuration on the device of ``kc``: the kernel against its
    twin and its checksum, and on a card its time, bound, the twin's and
    the library call's time."""
    from ._kernels import shift_fma, shift_fma_reference
    from ._measure import FP32_FLOPS, bound_ms, checksums_match, time_blocks

    out = shift_fma(frames[0], kc, n_cols, step, grp)
    ref = shift_fma_reference(frames[0], kc, n_cols, step, grp)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    chk, chk_ref = float(out.double().sum()), float(ref.double().sum())
    res = {"rows": rows, "n": n, "step": step, "grp": grp, "n_cols": n_cols,
           "checksum": chk, "checksum_twin": chk_ref,
           "match": checksums_match(chk_ref, chk), "max_abs_err": err,
           "max_abs_out": scale, "within_tolerance": err <= TOLERANCE * scale}
    nbytes = 4 * (frames[0].numel() + kc.numel() + 40 * n_cols)
    res["bound_ms"], res["bound_by"] = bound_ms(nbytes, 2 * rows * n * n_cols,
                                                FP32_FLOPS)
    if kc.device.type != "cuda":
        res["ms"] = res["plain_ms"] = res["library_ms"] = "not measured"
        return res
    lib = library_call(frames[0], kc, n_cols, step)
    res["library_max_abs_err"] = float((lib - ref).abs().max())
    res["ms"], res["ms_trials"] = time_blocks(
        lambda f: shift_fma(f, kc, n_cols, step, grp), frames, iters, trials)
    res["plain_ms"], _ = time_blocks(
        lambda f: shift_fma_reference(f, kc, n_cols, step, grp), frames, 2, 1)
    res["library_ms"], _ = time_blocks(
        lambda f: library_call(f, kc, n_cols, step), frames, iters, trials)
    return res


def _line(name: str, r: dict) -> str:
    if r["ms"] == "not measured":
        t = "time not measured (no card)"
    else:
        t = (f"{r['ms']:.4f} ms/block [{', '.join(f'{x:.4f}' for x in r['ms_trials'])}]"
             f" library {r['library_ms']:.4f} ms plain {r['plain_ms']:.4f} ms")
    return (f"{name}: {t} bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
            f"[checksum {'MATCH' if r['match'] else 'DIFF!'}, max|d| "
            f"{r['max_abs_err']:.3g} of {r['max_abs_out']:.3g}]")


def run(device=None, n_tiles: int = N_TILES, iters: int = 96, trials: int = 3,
        echo=None, configs=CONFIGS) -> dict:
    """The tool's (R, N, STEP, GRP) ``configs`` (default all) on
    ``device`` (cuda unless the caller passes another). Returns
    {"device", "configs": {name: probe result}, "failures"}; ``echo``
    receives the tool's result lines."""
    from .._device import resolve_device

    dev = resolve_device(device)
    say = echo or (lambda line: None)
    say(f"device: {dev}")
    results, failures = {}, 0
    for rows, n, step, grp in configs:
        name = f"R{rows}-N{n}-grp{grp}"
        kc, frames = make_inputs(rows, n, step, n_tiles, dev)
        r = probe(rows, n, step, grp, kc, frames, n_tiles * T, iters, trials)
        del kc, frames
        failures += not (r["match"] and r["within_tolerance"])
        results[name] = r
        say(_line(name, r))
    say("RESULT: " + ("every checksum MATCH" if failures == 0
                      else f"{failures} configurations DIFF"))
    return {"device": str(dev), "configs": results, "failures": failures}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain twins "
                         "and times nothing)")
    args = ap.parse_args(argv)
    res = run(args.device, echo=lambda line: print(line, flush=True))
    return 1 if res["failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
