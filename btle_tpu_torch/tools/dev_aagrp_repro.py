"""K9 on Hopper: the AA correlation and its strided-roll stack, exact.

Port of tools/dev_aagrp_repro.py. The TPU tool isolated the op pair of
the fused kernel's AA correlation — one strided pltpu.roll over a
broadcast that manufactures AA_GRP shifted copies of the decision
lattice, then a block-diagonal matmul per group — to hunt the AA_GRP=4
hardware miscompile (interpret mode right, the chip decoding nothing).
That miscompile was Mosaic's; it has no Hopper counterpart. Here the two
functions run on the card for GRP in {4, 8, 16} and are diffed against
the tool's numpy ground truth:

  * "roll": the rolled stack itself (``shift_stack``, the wrap-around of
    ``np.roll`` included), against truth_roll;
  * "corr": the correlation (``aa_corr`` with the block-diagonal weights
    undone to the per-channel signs), against truth.

GRP is the kernel's accumulation grouping (a partial sum per group of
GRP taps, as the TPU's per-group matmul): with +-1/0 operands every
partial sum is a small integer, so no grouping changes the result.

Usage: python -m btle_tpu_torch.tools.dev_aagrp_repro [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

M = 40
AA_BITS = 32
SPS = 4
T = 2048
GROUPS = (4, 8, 16)


def make_inputs(grp: int, seed: int = 0):
    """The tool's inputs, drawn the same way: a +-1 lattice (zero past the
    AA window), the block-diagonal weights of fused._aa_w4 and the signs."""
    rng = np.random.default_rng(seed)
    nb = T + (AA_BITS - 1) * SPS
    nbp = -(-nb // 128) * 128
    s = np.where(rng.integers(0, 2, (M, nbp)) > 0, 1.0, -1.0)
    s[:, nb:] = 0.0
    n_grp = AA_BITS // grp
    tsign = np.where(rng.integers(0, 2, (M, AA_BITS)) > 0, 1.0, -1.0)
    w4 = np.zeros((n_grp, M, grp * M), np.float32)
    for g in range(n_grp):
        for c in range(M):
            for r in range(grp):
                w4[g, c, r * M + c] = tsign[c, g * grp + grp - 1 - r]
    return s.astype(np.float32), w4, tsign


def truth(s, tsign, grp):
    """acc[c, t] = sum_j tsign[c, j] * s[c, t + j*sps] (the AA corr)."""
    del grp
    acc = np.zeros((M, T), np.float64)
    for j in range(AA_BITS):
        acc += tsign[:, j: j + 1] * s[:, j * SPS: j * SPS + T]
    return acc.astype(np.float32)


def truth_roll(s, grp, g: int):
    """x[r*M + c, t] = s[c, (t + sps*(g*grp + grp-1-r)) % nbp]."""
    nbp = s.shape[1]
    x = np.zeros((grp * M, nbp), np.float32)
    for r in range(grp):
        k = SPS * (g * grp + grp - 1 - r)
        x[r * M: (r + 1) * M] = np.roll(s, -k, axis=1)
    return x


def signs_of_w4(w4: np.ndarray, grp: int) -> np.ndarray:
    """Undo the block-diagonal layout: the (M, 32) per-channel signs
    (w4[g, c, r*M + c] = tsign[c, g*grp + grp-1-r])."""
    tsign = np.zeros((M, AA_BITS), np.float32)
    c = np.arange(M)
    for g in range(w4.shape[0]):
        for r in range(grp):
            tsign[:, g * grp + grp - 1 - r] = w4[g, c, r * M + c]
    return tsign


def _compare(got: np.ndarray, want: np.ndarray) -> tuple[bool, str]:
    if np.array_equal(got, want):
        return True, "exact match"
    bad = np.argwhere(got != want)
    r, c = bad[0]
    return False, (f"{len(bad)} mismatches, first at ({r},{c}): got "
                   f"{got[r, c]} want {want[r, c]}")


def run(device=None, echo=None) -> dict:
    """Every GRP's "roll" and "corr" on ``device`` (cuda unless the
    caller passes another), each against the numpy truth. Returns
    {"device", "variants": {name: "exact match" | mismatch text},
    "failures"}; ``echo`` receives the tool's result lines."""
    import torch

    from .._device import resolve_device
    from ._kernels import aa_corr, shift_stack

    dev = resolve_device(device)
    say = echo or (lambda line: None)
    say(f"device: {dev}")
    variants, failures = {}, 0
    for grp in GROUPS:
        s, w4, tsign = make_inputs(grp)
        st = torch.as_tensor(s, device=dev)
        w = torch.as_tensor(signs_of_w4(w4, grp), device=dev)
        x = shift_stack(st, grp, SPS)
        acc, _ = aa_corr(st, w, SPS, T, grp=grp)
        for name, got, want in (("roll", x, truth_roll(s, grp, 0)),
                                ("corr", acc, truth(s, tsign, grp))):
            ok, text = _compare(got.cpu().numpy(), want)
            failures += not ok
            variants[f"GRP={grp} {name}"] = text
            say(f"GRP={grp:2d} {name}: {text}")
    say("RESULT: " + ("all-match (the AA stage is exact at every grouping)"
                      if failures == 0 else f"{failures} mismatching kernels"))
    return {"device": str(dev), "variants": variants, "failures": failures}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain twins)")
    args = ap.parse_args(argv)
    return 1 if run(args.device, echo=lambda line: print(line, flush=True))["failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
