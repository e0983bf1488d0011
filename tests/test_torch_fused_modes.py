"""Every (compute_dtype, inner) pair the port's fused front end accepts,
against the JAX package's Pallas front end at the same pair in
interpret mode: the port's plain PyTorch twins of the CUDA kernels (K1,
K3, K5) on the CPU. The LE 2M geometry, the scans and the rejected
pairs are in test_torch_fused_scans.py.

Bars (those btle_tpu holds its own Pallas kernels to,
tests/test_wideband_fused.py): hit lattice identical, < 1e-3 of decision
bits different (float ties in pure noise: the filterbank sums in another
order), mag rtol 1e-4 inside a burst.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from btle_tpu.wideband.fused import fused_frontend as jfrontend

from btle_tpu_torch.wideband.fused import FILTERBANK_KIND, fused_frontend
from test_torch_frontend import _scene, _tables

torch.set_num_threads(2)

PAIRS = sorted(FILTERBANK_KIND)


def lattice_parity(dtype, inner, sps, lag):
    """The port's (bits, hit, mag) equal JAX's at (dtype, inner) on a
    60k-sample scene with per-channel AA rows and care-mask holes."""
    wi, wq = _scene(1, phy="2m" if sps == 2 else "1m", n=60000)
    aa_rows, mask, *_ = _tables(mask_holes=(5, 17))
    with pltpu.force_tpu_interpret_mode():
        ref = jfrontend(jnp.asarray(wi), jnp.asarray(wq), jnp.asarray(aa_rows),
                        jnp.asarray(mask), sps=sps, lag=lag, tile=512,
                        compute_dtype=dtype, inner=inner, interpret=True)
    bits_r, hit_r, mag_r = (np.asarray(a) for a in ref)
    bits, hit, mag = (a.numpy() for a in fused_frontend(
        wi, wq, aa_rows, mask, sps=sps, lag=lag, compute_dtype=dtype,
        inner=inner, device="cpu"))
    assert bits.shape == bits_r.shape and hit.shape == hit_r.shape
    assert hit.dtype == np.bool_ and bits.dtype == np.int8
    np.testing.assert_array_equal(hit, hit_r)
    assert hit.sum() >= 4                      # every packet's AA found
    assert (bits != bits_r).mean() < 1e-3       # only noise-tie flips
    # inside the bursts: at "bf16" the -48 dB weights also leak AA hits
    # of a burst into other channels (ghosts the CRC rejects), where mag
    # is a heavily cancelled sum three orders of magnitude down
    m, n = np.nonzero(hit)
    burst = mag_r[m, n] >= 1e-2 * mag_r[m, n].max()
    np.testing.assert_allclose(mag[m, n][burst], mag_r[m, n][burst], rtol=1e-4)


@pytest.mark.parametrize("sps,lag", [(4, 4), (4, 1)])
@pytest.mark.parametrize("dtype,inner", PAIRS)
def test_mode_lattice_matches_pallas_interpret(dtype, inner, sps, lag):
    lattice_parity(dtype, inner, sps, lag)
