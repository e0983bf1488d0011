"""The Hopper probes (btle_tpu_torch.tools) on their plain twins, against
the TPU tools they port, on the CPU:

- K9 (dev_aagrp_repro) and K8 (dev_aagrp_bisect): the port's inputs are
  the tools' and every variant equals the tools' own numpy truths
  (``truth``, ``truth_roll``, ``numpy_tail``) exactly;
- K10 (dev_rollscale) and K11 (dev_roll_experiment) at 1-2 tiles: the
  twins against a float64 numpy reference of the kernel body (K10 and
  K11 im2col within 1e-5 of max |out|, K11 AA exact), and against the
  tools' own Pallas kernels run in interpret mode. Those tools measure
  at import, so only their kernel ``def``s and the ``def``s that wrap
  them are compiled from the source (read with ``ast``, the file
  untouched), at a small N_TILES, with ``pallas_call`` in interpret mode
  and HBM operands in ``pl.ANY`` as the JAX package runs Pallas on the
  CPU. Their results are the tools' checksums, compared as the tools
  compare them.
"""

import ast
import importlib.util
import pathlib
import types
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from btle_tpu_torch.tools import (_kernels, dev_aagrp_bisect, dev_aagrp_repro,
                                  dev_roll_experiment, dev_rollscale)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _tool(name: str):
    """A tool module whose top level imports only numpy (its main() is
    not run)."""
    spec = importlib.util.spec_from_file_location(f"_tool_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool_defs(name: str, defs: set, **consts) -> dict:
    """Compile only the named top-level ``def``s of tools/<name>.py into a
    namespace holding ``consts``, numpy, jax and Pallas shims that run
    every pallas_call in interpret mode with HBM operands as pl.ANY."""
    path = ROOT / "tools" / f"{name}.py"
    tree = ast.parse(path.read_text())
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in defs]
    assert {n.name for n in body} == defs
    pl_shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                       if not k.startswith("__")})
    pl_shim.pallas_call = partial(pl.pallas_call, interpret=True)
    tpu_shim = types.SimpleNamespace(**{k: getattr(pltpu, k) for k in dir(pltpu)
                                        if not k.startswith("__")})
    tpu_shim.HBM = pl.ANY
    ns = dict(np=np, jax=jax, jnp=jnp, pl=pl_shim, pltpu=tpu_shim, partial=partial,
              **consts)
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), ns)
    return ns


# --------------------------------------------------------------------------
# K9
# --------------------------------------------------------------------------


@pytest.mark.parametrize("grp", dev_aagrp_repro.GROUPS)
def test_k9_inputs_truths_and_twins_equal_the_tool(grp):
    tool = _tool("dev_aagrp_repro")
    s, w4, tsign = dev_aagrp_repro.make_inputs(grp)
    for a, b in zip((s, w4, tsign), tool.make_inputs(grp)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(dev_aagrp_repro.signs_of_w4(w4, grp), tsign)
    want = tool.truth(s, tsign, grp)
    assert np.array_equal(dev_aagrp_repro.truth(s, tsign, grp), want)
    st = torch.as_tensor(s)
    acc, hit = _kernels.aa_corr(st, torch.as_tensor(tsign.astype(np.float32)),
                                tool.SPS, tool.T, grp=grp)
    assert np.array_equal(acc.numpy(), want)
    assert np.array_equal(hit.numpy(), (want == 32).astype(np.int8))
    for g in range(2):
        x = _kernels.shift_stack(st, grp, tool.SPS, k0=tool.SPS * grp * g)
        assert np.array_equal(x.numpy(), tool.truth_roll(s, grp, g))
        assert np.array_equal(dev_aagrp_repro.truth_roll(s, grp, g),
                              tool.truth_roll(s, grp, g))


def test_k9_probe_runs_exact(capsys):
    res = dev_aagrp_repro.run("cpu", echo=print)
    assert res["failures"] == 0 and len(res["variants"]) == 6
    assert set(res["variants"].values()) == {"exact match"}
    assert capsys.readouterr().out.splitlines()[-1].startswith("RESULT: all-match")
    assert dev_aagrp_repro.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("exact match") == 6


def test_probes_run_nothing_at_import():
    """Unlike the TPU tools, the probe modules measure nothing when
    imported: a fresh interpreter importing all four prints nothing."""
    import subprocess
    import sys

    code = "; ".join(f"import btle_tpu_torch.tools.{m}" for m in (
        "dev_aagrp_bisect", "dev_aagrp_repro", "dev_rollscale", "dev_roll_experiment"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout == "", proc.stderr


# --------------------------------------------------------------------------
# K8
# --------------------------------------------------------------------------


def test_k8_inputs_equal_the_tools_construction():
    """The tool builds its GFSK lattices with the JAX package's golden
    model inside main(); the port's copy gives the same arrays."""
    from btle_tpu.golden import model as G
    from btle_tpu.wideband import fused as jfused

    tool = _tool("dev_aagrp_bisect")
    ycols = jfused._ycols(tool.T, tool.SPS, tool.LAG)
    assert ycols == dev_aagrp_bisect.YCOLS
    rng = np.random.default_rng(3)
    aa_rows = rng.integers(0, 2, (tool.M, tool.AA_BITS)).astype(np.float32)
    y_i = np.zeros((tool.M, ycols), np.float32)
    y_q = np.zeros((tool.M, ycols), np.float32)
    for c in range(tool.M):
        bits = rng.integers(0, 2, ycols // tool.SPS + 8).astype(np.int8)
        bits[40 + 3 * c: 40 + 3 * c + tool.AA_BITS] = aa_rows[c].astype(np.int8)
        gi, gq = G.gfsk_modulate_float(bits, tool.SPS)
        y_i[c], y_q[c] = gi[:ycols] / 127.0, gq[:ycols] / 127.0
    got = dev_aagrp_bisect.make_inputs()
    for a, b in zip(got, (aa_rows, aa_rows * 2 - 1, y_i, y_q)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_k8_variants_equal_numpy_tail():
    """Every variant's K2 / K3 + K2 / AA-stage twin equals the tool's
    numpy_tail, bits and hits, exactly."""
    tool = _tool("dev_aagrp_bisect")
    aa_rows, tsign, y_i, y_q = dev_aagrp_bisect.make_inputs()
    want_bits, want_hit = tool.numpy_tail(y_i, y_q, tsign)
    assert np.array_equal(want_bits, dev_aagrp_bisect.numpy_tail(y_i, y_q, tsign)[0])
    assert int(want_hit.sum()) >= tool.M
    rows = torch.as_tensor(aa_rows.astype(np.int8))
    mask = torch.ones(32, dtype=torch.int8)
    bits, hit = dev_aagrp_bisect.tail(torch.as_tensor(np.concatenate([y_i, y_q])),
                                      rows, mask)
    assert np.array_equal(bits.numpy(), want_bits) and np.array_equal(hit.numpy(), want_hit)
    frames = dev_aagrp_bisect.dma_frames(y_i, y_q)
    bits, hit = dev_aagrp_bisect.dma_mm(torch.as_tensor(frames), rows, mask)
    for t in range(2):
        ftile = frames[:, t * tool.T: t * tool.T + dev_aagrp_bisect.YCOLS]
        wb, wh = tool.numpy_tail(ftile[:tool.M], ftile[tool.M:], tsign)
        assert np.array_equal(bits.numpy()[:, t * tool.T: (t + 1) * tool.T], wb)
        assert np.array_equal(hit.numpy()[:, t * tool.T: (t + 1) * tool.T], wh)
    nb = dev_aagrp_bisect.NB
    d = y_i[:, :nb] * y_q[:, 4: nb + 4] - y_i[:, 4: nb + 4] * y_q[:, :nb]
    _, hit = _kernels.aa_corr(torch.as_tensor((d > 0).astype(np.int8)),
                              torch.as_tensor(tsign), tool.SPS, tool.T)
    assert np.array_equal(hit.numpy(), want_hit)


def test_k8_probe_runs_exact():
    res = dev_aagrp_bisect.run("cpu")
    assert res["failures"] == 0 and len(res["variants"]) == 10
    assert set(res["variants"].values()) == {"exact match"}


# --------------------------------------------------------------------------
# K10
# --------------------------------------------------------------------------


def _shift_fma_f64(f, kc, n_cols, step):
    a = np.zeros((f.shape[0], n_cols))
    for j in range(kc.shape[1]):
        a += f[:, j * step: j * step + n_cols].astype(np.float64) * kc[:, j: j + 1]
    h = a.shape[0]
    while h > 40:
        h //= 2
        a = a[:h] + a[h: 2 * h]
    return a


@pytest.mark.parametrize("rows,n,step,grp", dev_rollscale.CONFIGS)
@pytest.mark.parametrize("n_tiles", [1, 2])
def test_k10_twin_against_float64_body(rows, n, step, grp, n_tiles):
    kc, frames = dev_rollscale.make_inputs(rows, n, step, n_tiles, "cpu")
    n_cols = n_tiles * dev_rollscale.T
    got = _kernels.shift_fma(frames[0], kc, n_cols, step, grp).numpy()
    want = _shift_fma_f64(frames[0].numpy(), kc.numpy(), n_cols, step)
    assert got.shape == (40, n_cols)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_k10_against_the_tools_kernel_in_interpret_mode():
    """tools/dev_rollscale.py's make_kernel at one tile: its kernel's
    checksum (out.sum()) against the port's on the same inputs."""
    ns = _tool_defs("dev_rollscale", {"make_kernel"}, T=2048, YCOLS=2048 + 128,
                    N_TILES=1, N_BLOCKS=1, rng=np.random.default_rng(0))
    rng = np.random.default_rng(0)
    for rows, n, step, grp in dev_rollscale.CONFIGS:
        fc = dev_rollscale.fcols(n, step)
        step_fn, frames = ns["make_kernel"](rows, n, step, grp)
        kc = rng.normal(size=(rows, n)).astype(np.float32)
        f = rng.normal(size=(rows, 2048 + fc)).astype(np.float32)
        assert np.array_equal(np.asarray(frames[0]), f)
        want = float(step_fn(frames[0]))
        res = dev_rollscale.probe(rows, n, step, grp, torch.as_tensor(kc),
                                  [torch.as_tensor(f)], 2048)
        assert res["match"] and res["within_tolerance"]
        scale = np.abs(_shift_fma_f64(f, kc, 2048, step)).sum()
        assert abs(res["checksum"] - want) <= 1e-5 * scale


def test_k10_probe_runs():
    res = dev_rollscale.run("cpu", n_tiles=1)
    assert res["failures"] == 0 and len(res["configs"]) == 4
    for r in res["configs"].values():
        assert r["ms"] == "not measured" and r["bound_ms"] > 0


# --------------------------------------------------------------------------
# K11
# --------------------------------------------------------------------------


def test_k11_twins_against_float64_bodies():
    from btle_tpu_torch.convert import sgemm_weights
    from btle_tpu_torch.wideband.fused import filterbank_im2col

    g, frames, tsign, lat = dev_roll_experiment.make_inputs(1)
    n_cols = dev_roll_experiment.T
    y = filterbank_im2col(torch.as_tensor(frames[0]), sgemm_weights(g), 65,
                          n_cols, "f32_im2col").numpy()
    want = np.zeros((80, n_cols))
    f64 = frames[0].astype(np.float64)
    for c in range(5):
        for j in range(13):
            s = c * 13 + j
            want += g[c][:, j * 40:(j + 1) * 40].astype(np.float64) @ f64[:, s: s + n_cols]
    assert np.abs(y - want).max() <= 1e-5 * np.abs(want).max()
    for variant in ("fma", "sroll", "mxu"):
        w = dev_roll_experiment.aa_weights(variant, tsign)
        signs = dev_roll_experiment.aa_signs(variant, w)
        assert np.array_equal(signs, tsign)
        acc, _ = _kernels.aa_corr(torch.as_tensor(lat[0]), torch.as_tensor(signs), 4,
                                  n_cols)
        assert np.array_equal(acc.numpy(), dev_roll_experiment.aa_truth(lat[0], tsign, n_cols))
    assert np.array_equal(dev_roll_experiment.reverse_chunks(
        dev_roll_experiment.reverse_chunks(g)), g)


def test_k11_against_the_tools_kernels_in_interpret_mode():
    """tools/dev_roll_experiment.py's im2col and AA kernels at one tile:
    their checksums against the port's on the same inputs (the tool's
    MATCH rule for im2col; AA exactly)."""
    g, frames, tsign, lat = dev_roll_experiment.make_inputs(1)
    consts = dict(M=40, D=20, T=2048, YCOLS=2176, FCOLS=2304, WIDTH=65, N_CHUNKS=5,
                  CHUNK=13, N_TILES=1, DT=jnp.float32, G=g, FRAMES=frames,
                  TSIGN=tsign, LAT=lat)
    ns = _tool_defs("dev_roll_experiment",
                    {"_im2col_kernel", "make_im2col", "_aa_kernel", "make_aa"}, **consts)
    res = dev_roll_experiment.run("cpu", n_tiles=1)
    assert res["failures"] == 0 and set(res["pairs"].values()) == {"MATCH"}
    for variant in ("copy", "sroll"):
        step_fn, fr = ns["make_im2col"](variant)
        want = float(step_fn(fr[0])[1])
        got = res["variants"][f"im2col-{variant}"]["checksum"][1]
        assert abs(got - want) < 1e-3 * max(1.0, abs(want))
    for variant in ("fma", "sroll", "mxu"):
        step_fn, lt = ns["make_aa"](variant)
        total, first64 = (float(v) for v in step_fn(lt[0]))
        assert res["variants"][f"aa-{variant}"]["exact"]
        assert res["variants"][f"aa-{variant}"]["checksum"] == (total, first64)


def test_k11_bf16_probe_runs():
    res = dev_roll_experiment.run("cpu", which="im2col", dtype="bf16", n_tiles=1)
    assert res["failures"] == 0 and res["pairs"] == {"im2col-sroll32": "MATCH"}
    with pytest.raises(ValueError):
        dev_roll_experiment.run("cpu", which="nope", n_tiles=1)


def test_probe_wrappers_reject_bad_operands():
    s = torch.zeros((40, 100))
    with pytest.raises(ValueError, match="too short"):
        _kernels.aa_corr(s, torch.zeros((40, 32)), 4, 50)
    with pytest.raises(ValueError, match="grp"):
        _kernels.aa_corr(s, torch.zeros((40, 32)), 1, 10, grp=3)
    with pytest.raises(ValueError, match="40, 80 or 160"):
        _kernels.shift_fma(torch.zeros((60, 100)), torch.zeros((60, 4)), 10, 2)
    with pytest.raises(ValueError, match="too short"):
        _kernels.shift_fma(torch.zeros((40, 100)), torch.zeros((40, 10)), 90, 2)
