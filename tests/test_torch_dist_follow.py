"""The port's sharded scan on 4 gloo ranks against the JAX package's
ShardedWidebandScan (tests/test_dist.py's TestShardedConnectionFollow
slot-overflow rescans, TestFusedSharded and TestSharded2m, case for
case): a starved candidate budget rescans to the full budget's packets,
the fused time-parallel layout ("f32" and "bf16x2w", the plain twins of
K1/K3, K2 and K4 on the CPU) gives the plain sharded scan's packet set,
and LE 2M decodes across shards; then the dry run of
__graft_entry__.dryrun_multichip on 4 ranks, and a rank that dies
without a result.

The JAX fused cases run the Pallas front end in interpret mode (20-25 s
each); here the port's fused ranks are held against the JAX program's
plain (XLA) sharded scan, which is what that JAX test compares them to.
"""

import pickle
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from btle_tpu.dist import ShardedWidebandScan, make_mesh
from btle_tpu.wideband import synthesize_wideband
from btle_tpu.wideband.channelizer import channel_to_bin

from btle_tpu_torch.dist import ShardedWidebandScan as TShardedWidebandScan
from btle_tpu_torch.dist import dryrun

import test_torch_dist_ranks as ranks_mod
from test_torch_dist import _key, _scene, _tuples, assert_candidates_equal
from test_wideband import make_channel_burst

OVERFLOW_MESHES = [(1, 4), (2, 2)]
FUSED = [("f32", 512), ("bf16x2w", 512)]
FUSED_BLOCK = 160000


def _overflow_scene(mesh_shape):
    """Nine packets on channel 9, 6000 samples apart: more AA hits in one
    (time, channel) cell than candidate slots."""
    rng = np.random.default_rng(0)
    bursts, expected = [], []
    gap = np.zeros(6000, np.float32)
    for _ in range(9):
        (bi, bq), pdu = make_channel_burst(rng, 9, n_payload=6)
        bursts.append((bi, bq))
        expected.append(pdu)
    sig_i = np.concatenate([x for b in bursts for x in (b[0], gap)])
    sig_q = np.concatenate([x for b in bursts for x in (b[1], gap)])
    n_time = mesh_shape[1]
    n = -(-(len(sig_i) + 200000) // (n_time * 20 * 128)) * (n_time * 20 * 128)
    wi, wq = synthesize_wideband({9: (sig_i, sig_q)}, n, {9: 4000})
    return wi, wq, expected, n


def _fused_boundary_scene():
    """One channel-38 packet across each of the three shard boundaries."""
    rng = np.random.default_rng(3)
    sig, expected = make_channel_burst(rng, 38, n_payload=20)
    n_time = 4
    n = FUSED_BLOCK * n_time
    wi = np.zeros(n, np.float32)
    wq = np.zeros(n, np.float32)
    burst_len = len(sig[0])
    for b in range(1, n_time):
        s, e = synthesize_wideband({38: sig}, burst_len, {38: 0})
        at = b * FUSED_BLOCK - burst_len // 2
        wi[at: at + burst_len] += s
        wq[at: at + burst_len] += e
    return wi, wq, expected


def _2m_scene():
    from btle_tpu.tx import parse_descriptor
    from btle_tpu.tx.synth import scene_to_wideband

    specs = []
    for ch, data in ((37, "00112233"), (17, "a1b2c3")):
        if ch == 37:
            d = (f"{ch}-ADV_NONCONN_IND-TxAdd-0-RxAdd-0-AdvA-"
                 f"0102030405{ch:02x}-AdvData-{data}")
        else:
            d = (f"{ch}-LL_DATA-AA-8E89BED6-LLID-1-NESN-0-SN-0-MD-0"
                 f"-DATA-{data}-CRCInit-555555")
        specs.append(parse_descriptor(d).to_2m())
    placed = [(s, 30_000 + 170_000 * k) for k, s in enumerate(specs)]
    n = 400_000
    wi, wq = scene_to_wideband(placed, n, noise_std=0.01, seed=3)
    from btle_tpu.spec import bits as B

    want = sorted((s.channel, bytes(B.bits_to_bytes(s.info_bits[s.pdu_start:])).hex())
                  for s in specs)
    return wi, wq, want, n


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """{case: (rank 0's result, every rank's packets)} of one group of 4
    ranks over every case of the module."""
    cases, jobs = [], []
    for shape in OVERFLOW_MESHES:
        wi, wq, _, n = _overflow_scene(shape)
        for slots in (64, 2):
            cases.append(("overflow", shape, slots))
            jobs.append((shape, [(wi, wq)], {"block_wb": n // shape[1],
                                             "max_candidates": slots}))
    wi, wq, _, _ = _scene()
    for dtype, tile in FUSED:
        cases.append(("fused", dtype))
        jobs.append(((1, 4), [(wi, wq)], {"block_wb": len(wi) // 4, "fused": True,
                                          "fused_tile": tile, "fused_dtype": dtype}))
    bi, bq, _ = _fused_boundary_scene()
    cases.append(("fused_boundary", "f32"))
    jobs.append(((1, 4), [(bi, bq)], {"block_wb": FUSED_BLOCK, "fused": True,
                                      "fused_tile": 512, "fused_dtype": "f32"}))
    mi, mq, _, n = _2m_scene()
    cases.append(("2m", (2, 2)))
    jobs.append(((2, 2), [(mi, mq)], {"block_wb": n // 2, "phy": "2m"}))
    path = tmp_path_factory.mktemp("dist4") / "jobs.pkl"
    with open(path, "wb") as fh:
        pickle.dump(jobs, fh)
    ranks = dryrun.spawn(4, ranks_mod.scan_jobs, str(path), backend="gloo",
                         device_type="cpu", timeout=300)
    return {case: (ranks[0][k], [r[k]["packets"] for r in ranks])
            for k, case in enumerate(cases)}


class TestShardedConnectionFollow:
    @pytest.mark.parametrize("mesh_shape", OVERFLOW_MESHES)
    def test_slot_overflow_rescans(self, port_runs, mesh_shape):
        """Dense traffic: more AA hits in one (time, channel) cell than
        candidate slots. The starved scan rescans (the plain channelizer,
        then K7 and K4) to the full budget's packets, reports every
        overflow on channel 9's bin, and equals the JAX program's starved
        scan: candidates, packets, rescans and overflow events."""
        wi, wq, expected, n = _overflow_scene(mesh_shape)
        ref, _ = port_runs[("overflow", mesh_shape, 64)]
        got, every_rank = port_runs[("overflow", mesh_shape, 2)]
        ref_ok = [p for p in ref["packets"][0] if p[3]]
        assert len(ref_ok) == 9 and ref["truncated"] == 0
        assert got["truncated"] > 0
        assert got["truncations"] and all(
            m == channel_to_bin(9) for _, m, _ in got["truncations"])
        ok = [p for p in got["packets"][0] if p[3]]
        assert [(p[0], p[1]) for p in ok] == [(p[0], p[1]) for p in ref_ok]
        for p, exp in zip(ok, expected):
            np.testing.assert_array_equal(np.frombuffer(p[4], np.uint8), exp)
        assert all(p == got["packets"] for p in every_rank)

        starved = ShardedWidebandScan(make_mesh(*mesh_shape), block_wb=n // mesh_shape[1],
                                      max_candidates=2)
        events = []
        starved.on_truncate = lambda t, m, hits: events.append((t, m, hits))
        out = starved(wi, wq)
        assert_candidates_equal({k: np.asarray(v) for k, v in out.items()},
                                got["candidates"][0])
        assert _tuples(starved.gather_packets(out)) == got["packets"][0]
        assert starved.truncated_cells == got["truncated"]
        assert events == got["truncations"]


class TestFusedSharded:
    """Time-parallel fused sharding (the fused front end on each rank)."""

    @pytest.mark.parametrize("dtype,tile", FUSED)
    def test_fused_matches_xla_sharded(self, port_runs, dtype, tile):
        wi, wq, expected, chans = _scene()
        ref = ShardedWidebandScan(make_mesh(1, 4), block_wb=len(wi) // 4)
        want = _key(ref.gather_packets(ref(wi, wq)))
        res, every_rank = port_runs[("fused", dtype)]
        assert _key(res["packets"][0]) == want
        assert len(want) == len(chans)
        assert all(p == res["packets"] for p in every_rank)

    def test_fused_boundary_straddling(self, port_runs):
        _, _, expected = _fused_boundary_scene()
        res, _ = port_runs[("fused_boundary", "f32")]
        ok = [p for p in res["packets"][0] if p[3]]
        assert len(ok) == 3
        for p in ok:
            assert p[4] == bytes(expected)

    def test_fused_requires_time_parallel_mesh(self):
        """Refused from the mesh's shape alone, before any group is used."""
        mesh = types.SimpleNamespace(size=lambda dim: (2, 4)[dim])
        with pytest.raises(ValueError, match="time-parallel"):
            TShardedWidebandScan(mesh, block_wb=20000, fused=True)


class TestSharded2m:
    def test_2m_scene_decodes_across_shards(self, port_runs):
        """LE 2M (phy='2m'): the 2M bursts decode on a (2, 2) mesh, with
        the JAX program's candidates and packets."""
        wi, wq, want, n = _2m_scene()
        res, every_rank = port_runs[("2m", (2, 2))]
        scan = ShardedWidebandScan(make_mesh(2, 2), block_wb=n // 2, phy="2m")
        out = scan(wi, wq)
        assert_candidates_equal({k: np.asarray(v) for k, v in out.items()},
                                res["candidates"][0])
        assert _tuples(scan.gather_packets(out)) == res["packets"][0]
        assert _key(res["packets"][0]) == want
        assert all(p == res["packets"] for p in every_rank)

    def test_unknown_phy_rejected(self):
        mesh = types.SimpleNamespace(size=lambda dim: (1, 2)[dim])
        with pytest.raises(ValueError):
            TShardedWidebandScan(mesh, block_wb=20000, phy="2M")


def test_spawn_reports_a_rank_that_dies_without_a_result():
    """A rank that exits before reporting fails the group at once, not at
    the time limit."""
    import os
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"exited \[3"):
        dryrun.spawn(2, os._exit, 3, backend="gloo", device_type="cpu", timeout=120)
    assert time.monotonic() - t0 < 60


def test_dryrun_multichip_on_four_gloo_ranks():
    """__graft_entry__.dryrun_multichip's counterpart on 4 gloo ranks: the
    branch-split step on tiny shapes, then the fused time-parallel layout
    with a CONNECT_REQ re-keying the next step and an LE 2M row."""
    dryrun.dryrun_multichip(4, backend="gloo", device_type="cpu")
