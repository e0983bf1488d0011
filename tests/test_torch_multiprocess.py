"""Two real processes of the port forming one gloo group (the counterpart
of tests/test_multiprocess.py, marked slow as it is): each feeds
MultiHostWidebandScan only its own half of the stream, and the packets
living in both halves decode, with the candidates and packets of the JAX
package's ShardedWidebandScan on the same (1, 2) mesh."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from btle_tpu.dist import ShardedWidebandScan, make_mesh
from btle_tpu.golden import model as G
from btle_tpu.spec import bits as B
from btle_tpu.wideband import synthesize_wideband

from btle_tpu_torch.dist import dryrun

import test_torch_dist_ranks as ranks_mod
from test_torch_dist import _tuples, assert_candidates_equal


@pytest.mark.slow
def test_two_process_distributed_scan():
    # tests/multihost_worker.py's scene: one packet in each half
    rng = np.random.default_rng(0)
    signals, offsets = {}, {}
    for ch, wb_off in ((37, 20000), (17, 200000)):
        hb = 0x40 if ch in (37, 38, 39) else 0x01
        payload = rng.integers(0, 256, 8, dtype=np.uint8)
        pdu = B.bytes_to_bits(np.concatenate([[hb, 8], payload]).astype(np.uint8))
        signals[ch] = G.gfsk_modulate_float(G.assemble_phy_bits(pdu, ch), 80)
        offsets[ch] = wb_off
    n = 8 * 40000
    wi, wq = synthesize_wideband(signals, n, offsets)
    kw = {"block_wb": n // 2, "num_taps": 640, "max_candidates": 4}
    ranks = dryrun.spawn(2, ranks_mod.scan_steps, (1, 2), [(wi, wq)], kw, "cpu", False, True,
                         backend="gloo", device_type="cpu", timeout=240)
    scan = ShardedWidebandScan(make_mesh(1, 2), **kw)
    out = scan(wi, wq)
    assert_candidates_equal({k: np.asarray(v) for k, v in out.items()},
                            ranks[0]["candidates"][0])
    want = _tuples(scan.gather_packets(out))
    assert ranks[0]["packets"][0] == ranks[1]["packets"][0] == want
    assert sorted(p[0] for p in want if p[3]) == [17, 37]
