"""The per-process sharded stream of btle_tpu_torch.dist on 4 gloo ranks,
mesh (1, 4), the fused front end at "bf16x2w" on its plain twins: each
rank fed only its own slice of each step (its block, and on the last
time shard the lookahead after it), against the plain reference of the
deployment (portbench/reference/sharded.py: one unsharded stream at the
block size).

Three steps of a small scene: a packet across the step boundary, one
across an interior shard boundary, one running into the last step's
lookahead, a cell whose slots overflow once and one that overflows
twice; positions are stream-absolute and every rank hands on the same
packets. Then a rank that exits mid-stream fails the group at once.
"""

import pickle
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from btle_tpu_torch.dist import dryrun
from btle_tpu_torch.golden import model as G
from btle_tpu_torch.spec import bits as B
from btle_tpu_torch.wideband.channelizer import channel_to_bin, compose_wideband

from portbench.reference import ble
from portbench.reference import sharded as RS

import test_torch_dist_ranks as ranks_mod

SCAN_LEN = 4096                    # channel samples a block
BLOCK_WB = SCAN_LEN * 20
N_TIME, N_STEPS, TAPS, SLOTS = 4, 3, 1280, 4
SCAN_KW = {"block_wb": BLOCK_WB, "fused": True, "fused_dtype": "bf16x2w",
           "max_candidates": SLOTS, "num_taps": TAPS}
# a packet's stream-absolute position, in channel samples past its burst's
# first sample / 20 (the preamble and the filters' delay)
POS_DELAY, POS_TOL = 66, 8

# case -> (channel, first wideband sample of each burst, payload octets)
PLACED = {
    "step_boundary": (37, [4 * BLOCK_WB - 9000], 12),          # step 0 | step 1
    "shard_boundary": (17, [6 * BLOCK_WB - 9000], 12),         # step 1, shards 1 | 2
    "lookahead": (38, [12 * BLOCK_WB - 6000], 10),             # into the lookahead
    "overflow_once": (5, [BLOCK_WB + 32000 + 14000 * k for k in range(2)], 6),
    "overflow_twice": (30, [9 * BLOCK_WB + 32000 + 14000 * k for k in range(3)], 6),
}
# the block of each overflowing cell and the rescans its channel needs
OVERFLOWS = {"overflow_once": (1, 1), "overflow_twice": (9, 2)}


def _scene():
    """int16 (i, q) of the stream (3 steps and the last lookahead), and
    {case: [(first sample, PDU)]}."""
    rng = np.random.default_rng(11)
    bursts, placed = [], {}
    for case, (ch, starts, n) in PLACED.items():
        for s in starts:
            hdr = 0x40 if ch in (37, 38, 39) else 0x01
            pdu = np.concatenate([[hdr, n], rng.integers(0, 256, n)]).astype(np.uint8)
            i80, q80 = G.gfsk_modulate_float(G.assemble_phy_bits(B.bytes_to_bits(pdu), ch), 80)
            bursts.append((ch, s, i80, q80))
            placed.setdefault(case, []).append((s, bytes(pdu)))
    n = N_TIME * N_STEPS * BLOCK_WB + RS.halo_wb(TAPS)
    wi, wq = compose_wideband(bursts, n, 100.0)
    wi = np.round(wi + rng.normal(0, 2, n)).astype(np.int16)
    wq = np.round(wq + rng.normal(0, 2, n)).astype(np.int16)
    return wi, wq, placed


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def stream_file(scene, tmp_path_factory):
    path = tmp_path_factory.mktemp("stream") / "stream.pkl"
    with open(path, "wb") as fh:
        pickle.dump(scene[:2], fh)
    return str(path)


@pytest.fixture(scope="module")
def ranks(stream_file):
    """Every rank's result of the stream."""
    return dryrun.spawn(N_TIME, ranks_mod.stream_steps, stream_file, N_STEPS, SCAN_KW,
                        backend="gloo", device_type="cpu", timeout=300)


@pytest.fixture(scope="module")
def reference(scene):
    """The reference's packets a step, and its rescans a block."""
    wi, wq, _ = scene
    stream = RS.Stream(lambda s, n: (wi[s: s + n], wq[s: s + n]), SCAN_LEN, TAPS, 1.0,
                       "bf16", ble.ADV_AA, ble.ADV_CRC_INIT_TABLE, SLOTS, "cpu")
    steps, rescans = [], []
    for _ in range(N_STEPS):
        pkts = []
        for _ in range(N_TIME):
            before = stream.walker.rescans
            pkts += stream.block()[1]
            rescans.append(stream.walker.rescans - before)
        steps.append(pkts)
    return steps, rescans


def _key(p):
    """(channel, position, payload length, CRC, PDU octets, AA)."""
    return p[:6] if isinstance(p, tuple) else (
        p.channel, p.sample_pos, p.payload_len, p.crc_ok, p.pdu, p.access_addr)


def test_steps_hand_on_the_reference_packets(ranks, reference):
    """Every step's packets, in order, are the reference's, with the
    reference's RSSI statistic to 1e-3, and the program rescans as often
    as the reference."""
    res = ranks[0]
    want, rescans = reference
    assert res["steps"] == N_STEPS
    for k in range(N_STEPS):
        assert [_key(p) for p in res["packets"][k]] == [_key(p) for p in want[k]], k
        np.testing.assert_allclose(res["rssi"][k], [p.rssi_mag for p in want[k]], rtol=1e-3)
    assert res["truncated"] == sum(rescans) > 0


@pytest.mark.parametrize("case", sorted(PLACED))
def test_each_placed_packet_decodes(ranks, scene, case):
    """Each burst is handed on once, CRC OK, with its PDU, at its
    stream-absolute position, in the step whose territory holds it."""
    _, _, placed = scene
    ch = PLACED[case][0]
    got = [(k, p) for k, pk in enumerate(ranks[0]["packets"]) for p in pk
           if p[0] == ch and p[3]]
    assert len(got) == len(placed[case])
    for (k, p), (start, pdu) in zip(got, placed[case]):
        assert abs(p[1] - (start // 20 + POS_DELAY)) <= POS_TOL
        assert p[1] // (N_TIME * SCAN_LEN) == k
        assert p[4] == pdu


@pytest.mark.parametrize("case", sorted(OVERFLOWS))
def test_overflowing_cells_are_rescanned(ranks, reference, case):
    """A cell whose hits outnumber its slots is reported once and
    rescanned until its territory is clean (once, or in two rounds),
    never dropped: its packets are all there."""
    block, n_rescans = OVERFLOWS[case]
    ch = PLACED[case][0]
    m = channel_to_bin(ch)
    assert reference[1][block] == n_rescans
    step, t = divmod(block, N_TIME)
    events = [(k, tt) for k, tt, mm, _ in ranks[0]["events"] if mm == m]
    assert events == [(step, t)]
    ok = [p for p in ranks[0]["packets"][step] if p[0] == ch and p[3]]
    assert len(ok) == len(PLACED[case][1])


def test_positions_are_stream_absolute(ranks):
    """Each packet lies in the territory of a block of its own step, and
    positions grow from step to step."""
    last = -1
    for k, pkts in enumerate(ranks[0]["packets"]):
        for p in pkts:
            assert k * N_TIME * SCAN_LEN <= p[1] < (k + 1) * N_TIME * SCAN_LEN
        firsts = [p[1] for p in pkts]
        if firsts:
            assert min(firsts) > last
            last = max(firsts)


def test_every_rank_hands_on_the_same_packets(ranks):
    assert all(r["packets"] == ranks[0]["packets"] for r in ranks[1:])
    assert all(r["truncated"] == ranks[0]["truncated"] for r in ranks[1:])


def test_a_rank_that_exits_mid_stream_fails_the_group(stream_file):
    """Rank 2 exits as step 1 starts, its peers inside the stream's
    collectives: the group fails within 60 s, naming rank 2 and its exit
    code."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[2\] exited \[3\]"):
        dryrun.spawn(N_TIME, ranks_mod.stream_steps, stream_file, N_STEPS, SCAN_KW,
                     False, (2, 1), backend="gloo", device_type="cpu", timeout=300)
    assert time.monotonic() - t0 < 60
