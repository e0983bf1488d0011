"""The scene generator: deterministic from the seed, and the same air
as the port's transmitter makes."""

import json

import numpy as np

from portbench import core
from portbench.reference import ble
from portbench.scenes import ble_air


def _params(traffic, **kw):
    return {**json.loads((core.HERE / "traffic" / f"{traffic}.json").read_text())["scene"],
            **kw}


def test_same_seed_same_scene():
    p = _params("replay_8k", air_s=0.01, advertisers=1000)
    a = ble_air.generate(p, 2**31 + 17, salt=1)
    b = ble_air.generate(p, 2**31 + 17, salt=1)
    c = ble_air.generate(p, 2**31 + 18, salt=1)
    assert np.array_equal(a.iq, b.iq)
    assert [(x.channel, x.start, x.pdu) for x in a.packets] == \
        [(x.channel, x.start, x.pdu) for x in b.packets]
    assert not np.array_equal(a.iq, c.iq)
    assert a.iq.dtype == np.int16 and not a.iq.flags.writeable


def test_scene_shape_and_spacing():
    p = _params("live4m_8k", air_s=0.5)
    s = ble_air.generate(p, 3, salt=2)
    assert s.iq.dtype == np.int8 and s.n_pairs == 2_000_000
    starts = [x.start for x in s.packets]
    longest = (8 + 32 + 8 * ble.MAX_PDU_CRC_BYTES) * s.sps
    assert all(b - a > longest for a, b in zip(starts, starts[1:]))
    assert all(6 <= len(x.pdu) - 2 <= 37 for x in s.packets)
    # 20 advertisers at 100 ms + advDelay: ~190 events a second
    assert abs(len(s.packets) - 95) < 15


def test_advertising_events_and_connections():
    p = _params("replay_8k", air_s=0.05)
    s = ble_air.generate(p, 2**33 + 1, salt=1)
    adv = s.packets_on(ble.ADV_AA)
    assert {x.channel for x in adv} == {37, 38, 39}
    # each event: one PDU on 37, 38 and 39 in turn
    by_pdu = {}
    for x in adv:
        by_pdu.setdefault(x.pdu, []).append(x)
    assert all([y.channel for y in sorted(v, key=lambda y: y.start)] == [37, 38, 39]
               for v in by_pdu.values())
    data = [x for x in s.packets if x.aa != ble.ADV_AA]
    assert data and all(not ble.is_adv(x.channel) for x in data)
    assert len({x.aa for x in data}) <= 8
    # ~190 events a second over 40 channels: ~570 advertising PDUs a second
    assert abs(len(adv) / 0.05 - 570) < 120
    for ch in range(40):
        v = sorted((x for x in s.packets if x.channel == ch), key=lambda x: x.start)
        assert all(b.start - a.start > (40 + 8 * (len(a.pdu) + 3)) * s.sps
                   for a, b in zip(v, v[1:])), ch


def test_connection_access_addresses():
    rng = np.random.default_rng(4)
    for _ in range(200):
        aa = ble_air.connection_aa(rng)
        bits = format(aa, "032b")
        assert bin(aa ^ ble.ADV_AA).count("1") > 1
        assert "0000000" not in bits and "1111111" not in bits


def test_modulator_and_framing_match_the_port():
    from btle_tpu_torch.golden.model import gfsk_modulate_float
    from btle_tpu_torch.spec import bits as B
    from btle_tpu_torch.tx import parse_descriptor

    bits = np.random.default_rng(0).integers(0, 2, 200)
    for sps in (4, 80):
        want = gfsk_modulate_float(bits, sps, 1.0)
        got = ble.gfsk_modulate(bits, sps, 1.0)
        assert np.allclose(want[0], got[0], atol=1e-12)
        assert np.allclose(want[1], got[1], atol=1e-12)
    for d in ("17-LL_DATA-AA-8E89BED6-LLID-1-NESN-0-SN-0-MD-0-DATA-000102030405"
              "-CRCInit-555555-Space-1",
              "37-ADV_NONCONN_IND-TxAdd-1-RxAdd-0-AdvA-010203040506"
              "-AdvData-0a0b0c-Space-1"):
        spec = parse_descriptor(d)
        pdu = bytes(B.bits_to_bytes(spec.info_bits[spec.pdu_start:]))
        assert np.array_equal(spec.phy_bits(), ble.phy_bits(pdu, spec.channel))
