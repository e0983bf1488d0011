"""The port's fused scan in every (compute_dtype, inner) pair (plain
PyTorch twins of the CUDA kernels, on the CPU) against the JAX package:
the front-end lattices at LE 2M against the Pallas kernel in interpret
mode, the scans against the XLA wideband scan, the pairs the JAX
package rejects, and the knob matrix.

Bars (tests/test_wideband_fused.py's): "f32" at every inner and "f32x2"
slot-exact against the XLA scan (pos, valid, crc_ok, payload_len,
len_ok, num_hits; PDU bytes over header + payload + CRC; mag_mean rtol
0.02, windowed sums against the XLA path's block-wide cumsum); "bf16"
at every inner and "bf16x2w" at "im2colp" the same CRC-OK packet set and
no ghost channel.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from btle_tpu.wideband.channelizer import bin_to_channel

from btle_tpu_torch.wideband import fused_selftest, knobmatrix
from btle_tpu_torch.wideband.fused import (FILTERBANK_KIND, filterbank_kind,
                                           fused_frontend, wideband_scan_fused)
from test_torch_fused_modes import PAIRS, lattice_parity
from test_torch_frontend import _crc_ok_set, _jax_scan, _scene, _slot_exact, _tables

torch.set_num_threads(2)

GEOMETRIES = [(4, 4), (4, 1), (2, 2)]
EXACT_PAIRS = [p for p in PAIRS if p[0] in ("f32", "f32x2")]
SET_PAIRS = [p for p in PAIRS if p[0] == "bf16" or p == ("bf16x2w", "im2colp")]


@pytest.mark.parametrize("dtype,inner", PAIRS)
def test_mode_lattice_matches_pallas_interpret_2m(dtype, inner):
    lattice_parity(dtype, inner, 2, 2)


@pytest.fixture(scope="module")
def xla_scans():
    """The JAX package's XLA scan of one scene per geometry."""
    out = {}
    for sps, lag in GEOMETRIES:
        wi, wq = _scene(2, phy="2m" if sps == 2 else "1m")
        out[sps, lag] = (wi, wq, _jax_scan(wi, wq, _tables(), sps, lag))
    return out


def _port_scan(wi, wq, dtype, inner, sps, lag):
    out = wideband_scan_fused(wi, wq, *_tables(), sps=sps, lag=lag,
                              max_candidates=8, compute_dtype=dtype,
                              inner=inner, device="cpu")
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("sps,lag", GEOMETRIES)
@pytest.mark.parametrize("dtype,inner", EXACT_PAIRS)
def test_exact_mode_scan_slot_exact_vs_xla(xla_scans, dtype, inner, sps, lag):
    wi, wq, ref = xla_scans[sps, lag]
    out = _port_scan(wi, wq, dtype, inner, sps, lag)
    _slot_exact(ref, out, mag_rtol=0.02)
    got = {bin_to_channel(int(m)) for m, k in np.argwhere(out["crc_ok"])}
    assert got == {37, 4, 22, 39}


@pytest.mark.parametrize("sps,lag", GEOMETRIES)
@pytest.mark.parametrize("dtype,inner", SET_PAIRS)
def test_bf16_mode_scan_packet_set_vs_xla(xla_scans, dtype, inner, sps, lag):
    wi, wq, ref = xla_scans[sps, lag]
    out = _port_scan(wi, wq, dtype, inner, sps, lag)
    assert _crc_ok_set(out) == _crc_ok_set(ref)
    # no ghost channel: CRC-OK only on the four channels with a packet
    assert {bin_to_channel(int(m)) for m, _ in _crc_ok_set(out)} == {37, 4, 22, 39}


# pairs the JAX package asserts against (fused.py:746-748, :793, :825-828)
REJECTED = [("bf16x2w", "dots"), ("bf16x2w", "poly"), ("bf16x2w", "polyx"),
            ("f32x2", "poly"), ("f32x2", "im2colp"), ("f32x2", "dots"),
            ("bf16", "polyroll"), ("bf16", "polyx")]


@pytest.mark.parametrize("dtype,inner", REJECTED)
def test_rejected_pairs_raise(dtype, inner):
    from btle_tpu.wideband.fused import fused_frontend as jfrontend

    wi, wq = np.zeros(20000, np.float32), np.zeros(20000, np.float32)
    aa_rows, mask, *_ = _tables()
    with pytest.raises(AssertionError):
        jfrontend(wi, wq, aa_rows, mask, compute_dtype=dtype, inner=inner,
                  tile=512, interpret=True)
    with pytest.raises(ValueError, match="does not run"):
        fused_frontend(wi, wq, aa_rows, mask, compute_dtype=dtype, inner=inner,
                       device="cpu")
    with pytest.raises(ValueError):
        fused_selftest(compute_dtype=dtype, inner=inner, device="cpu")


def test_default_inner_and_tile_follow_jax():
    from btle_tpu.wideband.fused import _default_inner

    for dtype in ("bf16", "bf16x2w", "f32x2", "f32"):
        assert (dtype, _default_inner(dtype)) in FILTERBANK_KIND
        assert filterbank_kind(dtype) == FILTERBANK_KIND[dtype, _default_inner(dtype)]
    wi, wq = _scene(5, n=30000)
    aa_rows, mask, *_ = _tables()
    a = fused_frontend(wi, wq, aa_rows, mask, compute_dtype="bf16", device="cpu")
    b = fused_frontend(wi, wq, aa_rows, mask, compute_dtype="bf16", tile=2048,
                       device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_knob_matrix_covers_jax_matrix():
    """Every row of tools/knobmatrix_fused_tpu.py's full matrix but the
    AA_GRP=4 pins is a row of the port's, tile steps collapsed."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / "knobmatrix_fused_tpu.py"
    spec = importlib.util.spec_from_file_location("knobmatrix_fused_tpu", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    def key(cfg, expected):
        return (cfg["compute_dtype"], cfg["inner"], cfg["decode"], cfg["phy"],
                cfg.get("cutoff_mhz"), expected)

    want = {key(cfg, expected) for _, cfg, expected in tool.config_matrix(True)
            if cfg["aa_grp"] == 8}
    got = {key(cfg, expected) for _, cfg, expected in knobmatrix.config_matrix()}
    assert got == want
    assert len(knobmatrix.config_matrix()) == len(got)


def test_knob_matrix_passes_on_cpu():
    rows = knobmatrix.run("cpu")
    assert [r for r in rows if r["status"] != "pass"] == []
