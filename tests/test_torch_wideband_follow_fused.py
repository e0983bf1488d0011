"""Wideband connection following through the fused front ends: the JAX
package's Pallas front end in interpret mode ("f32") against the port's
fused "f32" front end on the following scenes of
tests/test_torch_wideband_follow.py (split from it to keep each file
within the CPU budget). The packet lists and the hop-event lists must
be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from btle_tpu.wideband import WidebandConfig as JConfig
from btle_tpu.wideband import WidebandSniffer as JSniffer

from test_torch_wideband_follow import SCENES, _port, _run

torch.set_num_threads(2)

FUSED_SCENES = [s for s in SCENES if s != "map_update"]


@pytest.fixture(scope="module")
def scenes():
    # the same seeds as test_torch_wideband_follow.py's scenes fixture
    return {name: fn(np.random.default_rng(7 + k))
            for k, (name, (fn, _)) in enumerate(SCENES.items()) if name in FUSED_SCENES}


@pytest.mark.parametrize("scene", FUSED_SCENES)
def test_follow_matches_jax_fused(scenes, scene):
    """The JAX fused front end (Pallas in interpret mode, "f32") follows
    as the port's fused front end does, at the scene's own max_follow."""
    wi, wq = scenes[scene]
    mf = SCENES[scene][1]
    _, ref, ref_events = _run(JSniffer, JConfig, wi, wq, mf, interpret=True,
                              fused=True, fused_tile=512, fused_dtype="f32")
    _, got, events = _port(wi, wq, mf, "f32")
    assert got == ref and events == ref_events
    assert sum(p[3] for p in got) >= 2
