"""The port's narrowband bench (btle_tpu_torch.tools.bench_narrowband,
BASELINE config 1) on the CPU at a small block: the JAX tool's numbers
(ms a block, Msps, times real time at 4 Msps) and a checksum equal to
the JAX package's decode_block over the same blocks."""

import numpy as np
import pytest

pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from btle_tpu.rx.pipeline import decode_block
from btle_tpu.spec import bits as B
from btle_tpu.spec import crc24 as C
from btle_tpu.spec import whitening as W

from btle_tpu_torch.tools import bench_narrowband as bn

N = 16384


def _jax_checksum(blocks) -> float:
    """tools/bench_narrowband.py's step over each block (float32 sum of
    every output leaf), the blocks' sums added in float64."""
    args = (jnp.asarray(B.hex_to_bits("d6be898e")), jnp.asarray(np.ones(32, np.int8)),
            jnp.asarray(W.whitening_bits(37, 336)),
            jnp.int32(C.lfsr_init_to_table_init("555555")), jnp.asarray(True))
    total = 0.0
    for i, q in blocks:
        out = decode_block(jnp.asarray(i.numpy()), jnp.asarray(q.numpy()), *args,
                           sps=4, lag=1, max_candidates=64)
        total += float(sum(leaf.astype(jnp.float32).sum()
                           for leaf in jax.tree_util.tree_leaves(out)))
    return total


def test_run_on_cpu_gives_the_tools_numbers_and_jaxs_checksum():
    res = bn.run("cpu", n=N, iters=2, trials=1)
    for key in ("ms_per_block", "msps", "x_real_time", "checksum"):
        assert np.isfinite(res[key]) and res[key] > 0, key
    assert res["msps"] == pytest.approx(N / res["ms_per_block"] / 1e3)
    assert res["x_real_time"] == pytest.approx(res["msps"] / 4)
    assert res["n"] == N and res["device"] == "cpu"
    assert "idle_share" not in res
    blocks = bn.make_blocks("cpu", N, bn.N_BLOCKS, 0)
    assert len({b[0].numpy().tobytes() for b in blocks}) == bn.N_BLOCKS
    assert res["checksum"] == _jax_checksum(blocks)


def test_plain_step_equals_the_wrappers_step():
    """decode_block_plain (K7's and K4's twins in place of the kernels)
    is decode_block on the CPU, output for output."""
    import torch

    from btle_tpu_torch.rx.pipeline import decode_block as tdecode

    i, q = bn.make_blocks("cpu", N, 1, 5)[0]
    tables = bn.scan_tables("cpu")
    kw = dict(sps=4, lag=1, max_candidates=64)
    got = bn.decode_block_plain(i[None], q[None], *tables, **kw)
    want = tdecode(i[None], q[None], *tables, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_main_prints_the_tools_line(capsys):
    assert bn.main(["--device", "cpu", "--n", str(N), "--iters", "1", "--trials", "1"]) == 0
    first = capsys.readouterr().out.splitlines()[0]
    assert first.startswith("narrowband scan: ") and "x real time at 4 Msps" in first
