"""Wideband connection following in the port (ll.multifollow copy, the
follow half of WidebandSniffer) against the JAX package: the wideband
following scenes of tests/test_hop.py and tests/test_multifollow.py,
followed with one connection (max_follow 1, ll.hop) and with up to four
(ll.multifollow), through the plain path and the fused front end. The
packet lists and the hop-event lists must be equal. The JAX fused
front end (Pallas in interpret mode) on the same scenes is held against
the port's in tests/test_torch_wideband_follow_fused.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.experimental.pallas import tpu as pltpu

from btle_tpu.golden import model as G
from btle_tpu.spec import bits as B
from btle_tpu.wideband import WidebandConfig as JConfig
from btle_tpu.wideband import WidebandSniffer as JSniffer
from btle_tpu.wideband import synthesize_wideband
from btle_tpu.wideband.channelizer import compose_wideband

from btle_tpu_torch.wideband import WidebandConfig, WidebandSniffer
from test_hop import CONN_AA, CONN_AA_HEX, CRC_INIT_HEX, connect_req_pdu, data_pdu
from test_multifollow import AA_1, AA_2, CRC_1, CRC_2, connect_req_pdu_bytes

torch.set_num_threads(2)

BLOCK = 8192 * 20


def _air(pdu_bits, ch, crc_hex="555555", aa_hex="d6be898e"):
    phy = G.assemble_phy_bits(pdu_bits, ch, crc_init_hex=crc_hex,
                              access_address_hex=aa_hex)
    return G.gfsk_modulate_float(phy, 80)


def _compose(n, bursts):
    """bursts: [(channel, (i80, q80), wideband offset)], one at a time."""
    wi = np.zeros(n, np.float32)
    wq = np.zeros(n, np.float32)
    for ch, sig, pos in bursts:
        si, sq = synthesize_wideband({ch: sig}, n, {ch: pos})
        wi += si
        wq += sq
    return wi, wq


def _aa_hex(aa):
    return aa.to_bytes(4, "little").hex()


def scene_unlocks_data_channels(rng):
    """test_hop.py::test_connect_req_unlocks_data_channels."""
    d1, d2 = data_pdu(rng, 12), data_pdu(rng, 20)
    pos2 = BLOCK + 60_000
    return _compose(2 * BLOCK + 40_000, [
        (37, _air(connect_req_pdu(), 37), 50_000),
        (9, _air(d1, 9, CRC_INIT_HEX, CONN_AA_HEX), pos2),
        (18, _air(d2, 18, CRC_INIT_HEX, CONN_AA_HEX), pos2 + 30_000)])


def scene_second_connect_req(rng):
    """test_hop.py::test_second_connect_req_does_not_rekey."""
    pdu2 = B.bits_to_bytes(connect_req_pdu())
    pdu2[2 + 12: 2 + 16] = list((0x12345678).to_bytes(4, "little"))
    return _compose(3 * BLOCK, [
        (37, _air(connect_req_pdu(), 37), 30_000),
        (37, _air(B.bytes_to_bits(pdu2), 37), BLOCK + 30_000)])


def _data_bits(rng, n):
    payload = rng.integers(0, 256, n, dtype=np.uint8)
    return B.bytes_to_bits(np.concatenate([[0x01, n], payload]).astype(np.uint8))


def scene_two_connections(rng):
    """test_multifollow.py::test_two_connections_decode_concurrently."""
    cr1 = B.bytes_to_bits(connect_req_pdu_bytes(AA_1, CRC_1, 9, 16))
    cr2 = B.bytes_to_bits(connect_req_pdu_bytes(AA_2, CRC_2, 7, 16))
    d1, d2 = _data_bits(rng, 10), _data_bits(rng, 14)
    return _compose(2 * BLOCK + 60_000, [
        (37, _air(cr1, 37), 30_000), (38, _air(cr2, 38), 70_000),
        (9, _air(d1, 9, CRC_1, _aa_hex(AA_1)), BLOCK + 40_000),
        (7, _air(d2, 7, CRC_2, _aa_hex(AA_2)), BLOCK + 90_000)])


def scene_access_addr(rng):
    """test_multifollow.py::test_packet_access_addr_records_channel_key."""
    cr1 = B.bytes_to_bits(connect_req_pdu_bytes(AA_1, CRC_1, 9, 16))
    d1 = _data_bits(rng, 8)
    return _compose(2 * BLOCK + 40_000, [
        (37, _air(cr1, 37), 30_000),
        (9, _air(d1, 9, CRC_1, _aa_hex(AA_1)), BLOCK + 50_000)])


def scene_map_update(rng):
    """test_multifollow.py::test_map_update_rekeys_live_follow: a
    CONNECT_REQ, sync on channel 9, an LL_CHANNEL_MAP_REQ masking 18,
    and the dwell-2 packet on the remapped channel 19 (14 blocks)."""
    placements = []

    def place(ch, t_us, pdu, crc_hex="555555", aa="d6be898e"):
        si, sq = _air(B.bytes_to_bits(pdu), ch, crc_hex, aa)
        placements.append((ch, t_us * 80, si.astype(np.float32),
                           sq.astype(np.float32)))

    aa_hex = _aa_hex(AA_1)
    place(37, 200, connect_req_pdu_bytes(AA_1, CRC_1, 9, 16))
    place(9, 8300, np.concatenate([[0x01, 6], rng.integers(0, 256, 6)]).astype(np.uint8),
          CRC_1, aa_hex)
    place(9, 15000, np.array([0x03, 8, 0x01, 0xFF, 0xFF, 0xFB, 0xFF, 0x1F, 0x01, 0x00],
                             np.uint8), CRC_1, aa_hex)
    place(19, 24700, np.concatenate([[0x01, 7], rng.integers(0, 256, 7)]).astype(np.uint8),
          CRC_1, aa_hex)
    n_wb = 29000 * 80
    wi, wq = compose_wideband(placements, n_wb)
    wi += rng.normal(0, 0.01, n_wb).astype(np.float32)
    wq += rng.normal(0, 0.01, n_wb).astype(np.float32)
    return wi, wq


# scene -> the max_follow its original test runs (the JAX fused reference
# runs there; every scene is followed with 1 and 4 on the plain path)
SCENES = {"unlocks_data_channels": (scene_unlocks_data_channels, 1),
          "second_connect_req": (scene_second_connect_req, 1),
          "two_connections": (scene_two_connections, 4),
          "access_addr": (scene_access_addr, 4),
          "map_update": (scene_map_update, 4)}


def _packets(pkts):
    return [(p.channel, p.sample_pos, p.payload_len, p.crc_ok,
             p.pdu_bytes.tobytes(), p.access_addr) for p in pkts]


def _events(sn):
    follower = sn.multi_follower if sn.multi_follower is not None else sn.hop_tracker
    return [dataclasses.astuple(e) for e in follower.events]


def _run(sniffer_cls, cfg_cls, wi, wq, max_follow, interpret=False, **kw):
    sn = sniffer_cls(cfg_cls(follow_connections=True, max_follow=max_follow, **kw))
    if interpret:
        with pltpu.force_tpu_interpret_mode():
            pkts = sn.run(wi, wq)
    else:
        pkts = sn.run(wi, wq)
    return sn, _packets(pkts), _events(sn)


@pytest.fixture(scope="module")
def scenes():
    return {name: fn(np.random.default_rng(7 + k))
            for k, (name, (fn, _)) in enumerate(SCENES.items())}


@pytest.fixture(scope="module")
def jax_plain(scenes):
    out = {}
    for name, (wi, wq) in scenes.items():
        for mf in (1, 4):
            sn, pkts, events = _run(JSniffer, JConfig, wi, wq, mf)
            out[name, mf] = (pkts, events,
                             None if sn.connection is None else sn.connection.access_addr)
    return out


def _port(wi, wq, mf, mode):
    kw = {} if mode == "plain" else dict(fused=True, fused_dtype=mode)
    return _run(lambda cfg: WidebandSniffer(cfg, device="cpu"), WidebandConfig,
                wi, wq, mf, **kw)


@pytest.mark.parametrize("mode", ["plain", "f32", "bf16x2w", "bf16"])
@pytest.mark.parametrize("max_follow", [1, 4])
@pytest.mark.parametrize("scene", list(SCENES))
def test_follow_matches_jax(scenes, jax_plain, scene, max_follow, mode):
    wi, wq = scenes[scene]
    ref, ref_events, ref_conn = jax_plain[scene, max_follow]
    sn, got, events = _port(wi, wq, max_follow, mode)
    assert events == ref_events
    assert any(e[0] == "track_start" for e in events)
    if mode in ("plain", "f32"):
        assert got == ref
    else:
        # bf16 operands: the same CRC-OK packets (decisions in noise differ)
        assert [p for p in got if p[3]] == [p for p in ref if p[3]]
    conn = None if sn.connection is None else sn.connection.access_addr
    assert conn == ref_conn
    if max_follow == 1 and scene != "map_update":
        assert conn == (AA_1 if scene in ("two_connections", "access_addr") else CONN_AA)


# --------------------------------------------------------------------------
# dense multi-follow and LE 2M following
# --------------------------------------------------------------------------


DENSE_HOPS = [5, 6, 7, 8, 10, 11, 12, 13, 14, 15, 9, 9, 16]


def _dense_aa(j):
    return 0x53A00000 + j * 0x01101


def _dense_crc(j):
    return f"{0x111111 + j * 0x030201:06x}"


def scene_dense(rng):
    """test_multifollow.py::TestDenseMultiFollow's scene: 13 CONNECT_REQs
    in block 0; ten regular connections, A and B on the same first hop
    (channel 9, a collision), L at interval 8 that never sends data (a
    stale drop that frees channel 16); sync packets on each connection's
    first hop, then on its second after the re-key tick. Returns the
    wideband samples and the expected (channel, PDU, access address)."""
    intervals = [16] * 12 + [8]
    cr_ch = [[37, 38, 39][j % 3] for j in range(10)] + [39, 38, 37]
    cr_t = [200 + (j // 3) * 450 for j in range(13)]
    placements, expected = [], []

    def place(ch, t_us, pdu_bits, crc_hex="555555", aa_hex="d6be898e"):
        si, sq = _air(pdu_bits, ch, crc_hex, aa_hex)
        placements.append((ch, t_us * 80, si.astype(np.float32), sq.astype(np.float32)))

    for j in range(13):
        cr = connect_req_pdu_bytes(_dense_aa(j), _dense_crc(j), DENSE_HOPS[j], intervals[j])
        place(cr_ch[j], cr_t[j], B.bytes_to_bits(cr))
        expected.append((cr_ch[j], bytes(cr), 0x8E89BED6))

    def place_data(j, ch, t_us):
        payload = rng.integers(0, 256, 8 + j % 5, dtype=np.uint8)
        pdu = np.concatenate([[0x01, len(payload)], payload]).astype(np.uint8)
        place(ch, t_us, B.bytes_to_bits(pdu), _dense_crc(j), _aa_hex(_dense_aa(j)))
        expected.append((ch, bytes(pdu), _dense_aa(j)))

    for j in range(11):
        place_data(j, DENSE_HOPS[j] % 37, 8300 + j * 50)
    for j in range(11):
        place_data(j, (2 * DENSE_HOPS[j]) % 37, 24700 + j * 50)
    place_data(11, 9, 24000)
    n_wb = 29000 * 80
    wi, wq = compose_wideband(placements, n_wb)
    wi += rng.normal(0, 0.01, n_wb).astype(np.float32)
    wq += rng.normal(0, 0.01, n_wb).astype(np.float32)
    return wi, wq, expected


def scene_2m(rng):
    """LE 2M following: CONNECT_REQs for AA_1 (hop 9) and AA_2 (hop 7) on
    37 and 38, then a data packet of each on its first hop channel (9, 7)
    and, after the re-key tick, on its second (18, 14)."""
    placements = []

    def place(ch, t_us, pdu_bits, crc_hex="555555", aa_hex="d6be898e"):
        phy = G.assemble_phy_bits(pdu_bits, ch, crc_init_hex=crc_hex,
                                  access_address_hex=aa_hex, phy="2m")
        si, sq = G.gfsk_modulate_float(phy, 40)
        placements.append((ch, t_us * 80, si.astype(np.float32), sq.astype(np.float32)))

    for aa, crc, hop, ch, t in ((AA_1, CRC_1, 9, 37, 200), (AA_2, CRC_2, 7, 38, 700)):
        place(ch, t, B.bytes_to_bits(connect_req_pdu_bytes(aa, crc, hop, 16)))
        place(hop, 8300 + hop * 20, _data_bits(rng, 10), crc, _aa_hex(aa))
        place(2 * hop, 24700 + hop * 20, _data_bits(rng, 12), crc, _aa_hex(aa))
    n_wb = 29000 * 80
    wi, wq = compose_wideband(placements, n_wb)
    wi += rng.normal(0, 0.01, n_wb).astype(np.float32)
    wq += rng.normal(0, 0.01, n_wb).astype(np.float32)
    return wi, wq


@pytest.fixture(scope="module")
def dense():
    wi, wq, expected = scene_dense(np.random.default_rng(0))
    kw = dict(max_follow=16, drop_after_intervals=2)
    sn, pkts, events = _run(JSniffer, JConfig, wi, wq, **kw)
    return wi, wq, expected, (pkts, events, set(sn.multi_follower.connections))


@pytest.mark.parametrize("mode", ["plain", "f32"])
def test_dense_multi_follow_matches_jax(dense, mode):
    """13 connections, a same-hop channel collision, a stale drop, max_follow
    16: the packet list, hop events and connection set equal the JAX
    package's, and every injected packet decodes under its access address."""
    from btle_tpu_torch.wideband.channelizer import channel_to_bin

    wi, wq, expected, (ref, ref_events, ref_conns) = dense
    kw = {} if mode == "plain" else dict(fused=True, fused_dtype=mode)
    sn, got, events = _run(lambda cfg: WidebandSniffer(cfg, device="cpu"), WidebandConfig,
                           wi, wq, 16, drop_after_intervals=2, **kw)
    assert got == ref and events == ref_events
    f = sn.multi_follower
    assert set(f.connections) == ref_conns == {_dense_aa(j) for j in range(12)}
    decoded = {(p[0], p[4]): p[5] for p in got if p[3]}
    for ch, pdu, aa in expected:
        assert decoded.get((ch, pdu)) == aa, (ch, pdu.hex())
    assert [e.access_addr for e in f.events if e.event == "track_drop"] == [_dense_aa(12)]
    assert f._owners[channel_to_bin(9)] == _dense_aa(11)
    assert f._owners[channel_to_bin(18)] == _dense_aa(10)
    assert f._owners[channel_to_bin(16)] == _dense_aa(3)


@pytest.fixture(scope="module")
def scene_2m_runs():
    wi, wq = scene_2m(np.random.default_rng(21))
    return wi, wq, {mf: _run(JSniffer, JConfig, wi, wq, mf, phy="2m")[1:]
                    for mf in (1, 4)}


@pytest.mark.parametrize("mode", ["plain", "f32"])
@pytest.mark.parametrize("max_follow", [1, 4])
def test_2m_follow_matches_jax(scene_2m_runs, max_follow, mode):
    """LE 2M: two CONNECT_REQs, then data on each connection's first and
    second hop channels; followed with 1 and 4 connections, the packets
    and hop events equal the JAX package's."""
    wi, wq, ref = scene_2m_runs
    kw = {} if mode == "plain" else dict(fused=True, fused_dtype=mode)
    _, got, events = _run(lambda cfg: WidebandSniffer(cfg, device="cpu"), WidebandConfig,
                          wi, wq, max_follow, phy="2m", **kw)
    assert (got, events) == ref[max_follow]
    channels = {p[0] for p in got if p[3]}
    assert channels == ({37, 38, 9, 18} if max_follow == 1 else {37, 38, 9, 7, 18, 14})
