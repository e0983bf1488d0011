"""Knob matrix of the fused wideband pipeline: every shipped and
supported configuration through the known-answer self-test on a device.

Port of ``config_matrix(full=True)`` of tools/knobmatrix_fused_tpu.py:
compute_dtype x inner x decode path x LE PHY x channel-filter cutoff,
each row checked by ``fused_selftest`` on the device the caller names.
Two things of the TPU matrix have no Hopper counterpart:

- the ``aa_grp=4`` "known_bad" pins record a Mosaic miscompile of the
  TPU's strided-roll AA correlation; the port's AA test (``demod_tail``)
  has no roll groups, so those rows are left out;
- the tile steps (one "info" row per step either side of the default
  tile) collapse to one "info" row each, because ``tile`` changes
  nothing here.

The port never writes KNOBMATRIX.json (the JAX package's artifact):
``run`` returns the rows.
"""

from __future__ import annotations

import time


def config_matrix() -> list[tuple[str, dict, str]]:
    """[(label, fused_selftest kwargs, expected)] — expected "pass" rows
    gate, "info" rows (the collapsed tile steps) are recorded."""
    rows = []

    def add(dtype, inner, decode="pallas", expected="pass", phy="1m",
            cutoff=None):
        label = f"{dtype}/{inner}/{decode}" + (
            "" if phy == "1m" else f"/{phy}") + (
            "" if cutoff is None else f"/c{cutoff}") + (
            "" if expected == "pass" else f"/{expected}")
        cfg = dict(compute_dtype=dtype, inner=inner, decode=decode, phy=phy)
        if cutoff is not None:
            cfg["cutoff_mhz"] = cutoff
        rows.append((label, cfg, expected))

    # the two shipped modes, both decode paths
    add("f32", "polyx")
    add("f32", "polyx", decode="xla")
    add("bf16x2w", "im2col")
    add("bf16x2w", "im2col", decode="xla")
    # LE 2M wideband and the 2M sensitivity-optimized filter option
    add("bf16x2w", "im2col", phy="2m")
    add("f32", "polyx", phy="2m")
    add("bf16x2w", "im2col", phy="2m", cutoff=1.2)
    # supported non-default modes
    add("f32", "poly")
    add("f32x2", "im2col")
    # the tile steps of the full matrix, one row each
    add("f32", "poly", expected="info")
    add("bf16x2w", "im2col", expected="info")
    # non-default combinations someone could reasonably deploy
    add("bf16", "im2col")
    add("bf16x2w", "im2colp")
    add("bf16", "poly")
    add("f32", "im2col")
    add("f32", "polyroll")
    add("f32", "poly", phy="2m")
    return rows


def run(device=None) -> list[dict]:
    """Self-test every row on ``device`` (cuda unless the caller passes
    another). Returns one dict per row: label, expected, status ("pass",
    "selftest_fail" or "error"), seconds and, on failure, the detail."""
    from .selftest import WidebandSelfTestError, fused_selftest

    out = []
    for label, cfg, expected in config_matrix():
        t0 = time.perf_counter()
        status, detail = "pass", ""
        try:
            fused_selftest(device=device, **cfg)
        except WidebandSelfTestError as e:
            status, detail = "selftest_fail", str(e)[:400]
        except (RuntimeError, ValueError) as e:
            status, detail = "error", f"{type(e).__name__}: {str(e)[:400]}"
        row = {"config": label, "expected": expected, "status": status,
               "seconds": time.perf_counter() - t0}
        if detail:
            row["detail"] = detail
        out.append(row)
    return out
