"""The port's sharded wideband scan (btle_tpu_torch.dist) on gloo ranks
against the JAX package's ShardedWidebandScan on the 8-device virtual CPU
mesh (tests/test_dist.py's TestShardedScan and TestMultiHost, case for
case): mesh-shape invariance, equivalence with the single-device
sniffer, boundary-straddling packets through the halo exchange, the
multi-host entry point with each rank fed only its own time block, and a
CONNECT_REQ re-keying the next step (TestShardedConnectionFollow's).

Each world size runs as one spawned group of ranks (a free port on
localhost) over every case of the module, from one file of streams;
every case's candidate arrays must equal the JAX program's slot for slot
on the same mesh, and its packets the JAX program's, on every rank.
"""

import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from btle_tpu.dist import ShardedWidebandScan, make_mesh
from btle_tpu.wideband import WidebandSniffer, synthesize_wideband

from btle_tpu_torch.dist import dryrun

import test_torch_dist_ranks as ranks_mod
from test_wideband import make_channel_burst

MESHES_8 = [(2, 4), (4, 2), (1, 8), (8, 1)]
BOUNDARY_MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]


def _scene():
    """tests/test_dist.py's scene: six packets 50000 samples apart."""
    rng = np.random.default_rng(7)
    signals, expected, offsets = {}, {}, {}
    chans = (37, 38, 0, 17, 25, 39)
    for k, ch in enumerate(chans):
        signals[ch], expected[ch] = make_channel_burst(rng, ch, n_payload=10 + k)
        offsets[ch] = 5000 + 50000 * k
    wi, wq = synthesize_wideband(signals, 320000, offsets)
    return wi, wq, expected, chans


def _boundary_scene(mesh_shape):
    """One packet across every time-shard boundary of the mesh (the tail
    of the only shard when n_time = 1), on channels of different channel
    groups."""
    rng = np.random.default_rng(3)
    n_ch, n_time = mesh_shape
    block_wb = 60000
    n = max(n_time, 2) * block_wb
    chans = (17, 9, 30, 2, 25, 36, 12)
    signals, offsets, expected = {}, {}, {}
    for b in range(max(n_time - 1, 1)):
        ch = chans[b % len(chans)]
        signals[ch], expected[ch] = make_channel_burst(rng, ch, n_payload=20)
        offsets[ch] = n - 25000 if n_time == 1 else (b + 1) * block_wb - 9000
    wi, wq = synthesize_wideband(signals, n, offsets)
    return wi, wq, expected, n


def _key(pkts):
    """Sorted (channel, PDU hex) of the CRC-OK packets (port tuples or
    JAX WidebandPackets)."""
    if pkts and isinstance(pkts[0], tuple):
        return sorted((p[0], p[4].hex()) for p in pkts if p[3])
    return sorted((p.channel, bytes(p.pdu_bytes).hex()) for p in pkts if p.crc_ok)


def _tuples(pkts):
    return [ranks_mod.packet_tuple(p) for p in pkts]


def _jax_run(mesh_shape, wi, wq, **kw):
    scan = ShardedWidebandScan(make_mesh(*mesh_shape), **kw)
    out = scan(wi, wq)
    cands = {k: np.asarray(v) for k, v in out.items()}
    return cands, _tuples(scan.gather_packets(out))


def assert_candidates_equal(want, got):
    """Slot-exact, the rule of tests/test_torch_frontend.py's plain scan,
    with the length fields held at the valid slots: the scenes are
    noiseless, so an empty slot's window (at position 0) reads decisions
    on filter tails of about 1e-10, whose sign is a rounding tie."""
    for key in ("pos", "valid", "crc_ok", "num_hits"):
        np.testing.assert_array_equal(want[key], got[key], err_msg=key)
    for key in ("payload_len", "len_ok"):
        np.testing.assert_array_equal(want[key][want["valid"]], got[key][want["valid"]],
                                      err_msg=key)
    for idx in np.argwhere(want["crc_ok"]):
        span = 2 + int(want["payload_len"][tuple(idx)]) + 3
        np.testing.assert_array_equal(want["pdu_bytes"][tuple(idx)][:span],
                                      got["pdu_bytes"][tuple(idx)][:span])
    np.testing.assert_allclose(got["mag_mean"][want["crc_ok"]],
                               want["mag_mean"][want["crc_ok"]], rtol=1e-3)


def _spawn(tmp_path_factory, world, jobs):
    path = tmp_path_factory.mktemp(f"dist{world}") / "jobs.pkl"
    with open(path, "wb") as fh:
        pickle.dump(jobs, fh)
    return dryrun.spawn(world, ranks_mod.scan_jobs, str(path), backend="gloo",
                        device_type="cpu", timeout=300)


REKEY_BLOCK = 80000


def _rekey_steps():
    """Step 1: a CONNECT_REQ on 37; step 2: a data packet of the
    connection on channel 14 (tests/test_dist.py's scene)."""
    from btle_tpu.golden import model as G

    from test_hop import CONN_AA_HEX, CRC_INIT_HEX, connect_req_pdu, data_pdu

    n = 4 * REKEY_BLOCK
    cr80 = G.gfsk_modulate_float(G.assemble_phy_bits(connect_req_pdu(), 37), 80)
    step1 = synthesize_wideband({37: cr80}, n, {37: 30000})
    d1 = data_pdu(np.random.default_rng(0), 10)
    phy = G.assemble_phy_bits(d1, 14, crc_init_hex=CRC_INIT_HEX,
                              access_address_hex=CONN_AA_HEX)
    step2 = synthesize_wideband({14: G.gfsk_modulate_float(phy, 80)}, n, {14: 100000})
    return [step1, step2], d1


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def port_runs(scene, tmp_path_factory):
    """{case: (rank 0's result, every rank's packets)} of the two groups:
    8 ranks (the four 8-device meshes, the boundary scenes, the multi-host
    entry point at n_ch 2) and 1 rank (mesh (1, 1))."""
    wi, wq, _, _ = scene
    cases8, jobs8 = [], []
    for shape in MESHES_8:
        cases8.append(("scene", shape))
        jobs8.append((shape, [(wi, wq)], {"block_wb": len(wi) // shape[1]}))
    for shape in BOUNDARY_MESHES:
        bi, bq, _, n = _boundary_scene(shape)
        cases8.append(("boundary", shape))
        jobs8.append((shape, [(bi, bq)], {"block_wb": n // shape[1]}))
    cases8.append(("multihost", (2, 4)))
    jobs8.append(((2, 4), [(wi, wq)], {"block_wb": len(wi) // 4}, "cpu", False, True))
    cases8.append(("rekey", (2, 4)))
    jobs8.append(((2, 4), _rekey_steps()[0], {"block_wb": REKEY_BLOCK}, "cpu", True))
    runs = {}
    for world, cases, jobs in ((8, cases8, jobs8),
                               (1, [("scene", (1, 1))],
                                [((1, 1), [(wi, wq)], {"block_wb": len(wi)})])):
        ranks = _spawn(tmp_path_factory, world, jobs)
        for k, case in enumerate(cases):
            runs[case] = (ranks[0][k], [r[k]["packets"] for r in ranks])
    return runs


class TestShardedScan:
    @pytest.mark.parametrize("mesh_shape", MESHES_8 + [(1, 1)])
    def test_mesh_shapes_agree(self, scene, port_runs, mesh_shape):
        wi, wq, expected, chans = scene
        res, every_rank = port_runs[("scene", mesh_shape)]
        want_c, want_p = _jax_run(mesh_shape, wi, wq, block_wb=len(wi) // mesh_shape[1])
        assert_candidates_equal(want_c, res["candidates"][0])
        assert res["packets"][0] == want_p
        assert all(p == res["packets"] for p in every_rank)
        assert _key(res["packets"][0]) == sorted(
            (ch, bytes(expected[ch]).hex()) for ch in chans)

    def test_matches_single_device(self, scene, port_runs):
        wi, wq, expected, chans = scene
        ref = _key(WidebandSniffer().run(wi, wq))
        res, _ = port_runs[("scene", (2, 4))]
        assert _key(res["packets"][0]) == ref

    @pytest.mark.parametrize("mesh_shape", BOUNDARY_MESHES)
    def test_boundary_straddling_packet(self, port_runs, mesh_shape):
        bi, bq, expected, n = _boundary_scene(mesh_shape)
        res, every_rank = port_runs[("boundary", mesh_shape)]
        want_c, want_p = _jax_run(mesh_shape, bi, bq, block_wb=n // mesh_shape[1])
        assert_candidates_equal(want_c, res["candidates"][0])
        assert res["packets"][0] == want_p
        assert all(p == res["packets"] for p in every_rank)
        ok = [p for p in res["packets"][0] if p[3]]
        assert sorted(p[0] for p in ok) == sorted(expected), mesh_shape
        for p in ok:
            np.testing.assert_array_equal(np.frombuffer(p[4], np.uint8), expected[p[0]])


class TestMultiHost:
    def test_single_process_path(self, scene, port_runs):
        """MultiHostWidebandScan at n_ch 2 over 8 ranks, each fed only
        its own time block: the JAX multi-host scan's packets on its
        8-device virtual mesh."""
        from btle_tpu.dist import MultiHostWidebandScan

        wi, wq, expected, chans = scene
        res, every_rank = port_runs[("multihost", (2, 4))]
        scan = MultiHostWidebandScan(n_ch=2, block_wb=len(wi) // 4)
        assert _tuples(scan.gather_packets(scan(wi, wq))) == res["packets"][0]
        assert all(p == res["packets"] for p in every_rank)
        assert _key(res["packets"][0]) == sorted(
            (ch, bytes(expected[ch]).hex()) for ch in chans)
        assert res["block_wb"] == len(wi) // 4


class TestShardedConnectionFollow:
    def test_connect_req_rekeys_next_step(self, port_runs):
        """CONNECT_REQ decoded in step 1 re-keys the data channels so step
        2 hears the connection: both steps' candidates and packets equal
        the JAX program's."""
        from btle_tpu.spec.bits import bits_to_bytes

        from test_hop import CONN_AA

        steps, d1 = _rekey_steps()
        res, every_rank = port_runs[("rekey", (2, 4))]
        scan = ShardedWidebandScan(make_mesh(2, 4), block_wb=REKEY_BLOCK)
        scan.enable_connection_following()
        for k, (wi, wq) in enumerate(steps):
            out = scan(wi, wq)
            assert_candidates_equal({n: np.asarray(v) for n, v in out.items()},
                                    res["candidates"][k])
            assert _tuples(scan.gather_packets(out)) == res["packets"][k]
        assert all(p == res["packets"] for p in every_rank)
        assert any(p[3] and p[0] == 37 for p in res["packets"][0])
        assert res["connection_aa"] == CONN_AA
        ok = [p for p in res["packets"][1] if p[3]]
        assert [p[0] for p in ok] == [14]
        assert ok[0][4] == bits_to_bytes(d1).tobytes() and ok[0][5] == CONN_AA


def test_make_mesh_needs_a_group_and_enough_ranks():
    """make_mesh refuses without a process group, and (as JAX's does) a
    mesh larger than the world."""
    import torch.distributed as dist

    from btle_tpu_torch.dist import make_mesh as tmake_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmake_mesh(1, 1, "cpu")
    with pytest.raises(RuntimeError, match="need 3 devices, have 2"):
        dryrun.spawn(2, tmake_mesh, 1, 3, "cpu", backend="gloo", device_type="cpu",
                     timeout=120)

