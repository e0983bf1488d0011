"""AUX chain linking (btle_tpu_torch.ll.extchain) on the port's wideband
sniffer, and the typed TX plan builder (btle_tpu_torch.cli.tx_builder),
beside the JAX package's: tests/test_extchain.py and
tests/test_cli.py::TestTxBuilder case for case. The scenes go through
both packages' WidebandSniffer (the port's on the CPU) and both
linkers; the links, and the plans' descriptor lines and synthesized IQ,
must be equal."""

import json

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from btle_tpu.cli import tx_builder as jtb
from btle_tpu.golden import model as G
from btle_tpu.ll.extchain import AuxChainLinker as JLinker
from btle_tpu.ll.pdu import build_ext_adv_payload
from btle_tpu.spec import bits as B
from btle_tpu.wideband import WidebandConfig as JConfig
from btle_tpu.wideband import WidebandSniffer as JSniffer
from btle_tpu.wideband import synthesize_wideband

from btle_tpu_torch.cli import tx_builder as ttb
from btle_tpu_torch.ll.extchain import AuxChainLinker
from btle_tpu_torch.wideband import WidebandConfig, WidebandSniffer


def ext_pdu(payload: bytes) -> np.ndarray:
    return B.bytes_to_bits(np.frombuffer(bytes([0x07, len(payload)]) + payload, np.uint8))


def burst(pdu_bits, ch):
    return G.gfsk_modulate_float(G.assemble_phy_bits(pdu_bits, ch), 80)


def _compose(n, placed, rng=None):
    wi = np.zeros(n, np.float32)
    wq = np.zeros(n, np.float32)
    for ch, payload, t_us in placed:
        si, sq = synthesize_wideband({ch: burst(ext_pdu(payload), ch)}, n, {ch: t_us * 80})
        wi += si
        wq += sq
    if rng is not None:
        wi += rng.normal(0, 0.02, n).astype(np.float32)
        wq += rng.normal(0, 0.02, n).astype(np.float32)
    return wi, wq


def _link_keys(links):
    return [(lk.primary.channel, int(lk.primary.sample_pos), lk.aux.channel,
             int(lk.aux.sample_pos), bytes(lk.aux.pdu_bytes), lk.offset_error_us,
             lk.did, lk.sid) for lk in links]


def _both_links(wi, wq):
    """(the port's links, its CRC-OK packets) after holding both equal to
    the JAX package's."""
    jpk = [p for p in JSniffer(JConfig()).run(wi, wq) if p.crc_ok]
    tpk = [p for p in WidebandSniffer(WidebandConfig(), device="cpu").run(wi, wq)
           if p.crc_ok]
    assert [(p.channel, p.sample_pos, bytes(p.pdu_bytes)) for p in tpk] == \
        [(p.channel, p.sample_pos, bytes(p.pdu_bytes)) for p in jpk]
    links = AuxChainLinker().feed(tpk)
    assert _link_keys(links) == _link_keys(JLinker().feed(jpk))
    return links, tpk


def test_aux_pointer_links_across_channels(rng):
    adv_a = bytes.fromhex("0a0b0c0d0e0f")
    offset_us, t0_us, aux_ch = 1200, 2_000, 12
    primary = build_ext_adv_payload(adv_mode=0, adv_a=adv_a, adi=(0x234, 3),
                                    aux_ptr=(aux_ch, 0, offset_us, 0))
    aux = build_ext_adv_payload(adv_mode=0, adv_a=adv_a, adi=(0x234, 3),
                                adv_data=bytes.fromhex("0201060318ffee"))
    # decoy: same channel, WRONG ADI, inside the window — must not link
    decoy = build_ext_adv_payload(adv_mode=0, adv_a=adv_a, adi=(0x777, 1))
    wi, wq = _compose(600_000, ((37, primary, t0_us),
                                (aux_ch, decoy, t0_us + offset_us + 2_000),
                                (aux_ch, aux, t0_us + offset_us)), rng)
    links, pkts = _both_links(wi, wq)
    assert {p.channel for p in pkts} == {37, aux_ch}
    assert len(links) == 1
    lk = links[0]
    assert lk.primary.channel == 37 and lk.aux.channel == aux_ch
    assert (lk.did, lk.sid) == (0x234, 3)
    assert abs(lk.offset_error_us) <= 650
    from btle_tpu_torch.ll.pdu import parse_adv_header, parse_adv_payload

    hdr = parse_adv_header(bytes(lk.aux.pdu_bytes[:2]))
    pl = parse_adv_payload(bytes(lk.aux.pdu_bytes[2:]), hdr.pdu_type)
    assert bytes(pl.data) == bytes.fromhex("0201060318ffee")


def test_two_hop_chain():
    """ADV_EXT_IND -> AUX_ADV_IND (with its own AuxPtr) -> AUX_CHAIN_IND."""
    adv_a = bytes.fromhex("102030405060")
    p1 = build_ext_adv_payload(adv_mode=0, adi=(0x111, 2), aux_ptr=(9, 0, 900, 0))
    p2 = build_ext_adv_payload(adv_mode=0, adv_a=adv_a, adi=(0x111, 2),
                               aux_ptr=(21, 0, 1500, 0), adv_data=b"\xaa" * 8)
    p3 = build_ext_adv_payload(adv_mode=0, adi=(0x111, 2), adv_data=b"\xbb" * 8)
    wi, wq = _compose(800_000, ((38, p1, 1_500), (9, p2, 2_400), (21, p3, 3_900)))
    links, _ = _both_links(wi, wq)
    assert len(links) == 2
    assert [(lk.primary.channel, lk.aux.channel) for lk in links] == [(38, 9), (9, 21)]


def _plans(mod):
    return mod.TxPlan([
        mod.AdvInd(channel=37, adv_a="01:02:03:04:05:06", adv_data_hex="020106"),
        mod.IBeacon(channel=38, space_ms=100),
        mod.Discovery(channel=39, local_name="Hi", services_16=["180D"]),
        mod.Raw(channel=12, hex_payload="0102aabb"),
    ], repeat=5)


class TestTxBuilder:
    def test_lines_parse_back(self):
        plan, want = _plans(ttb), _plans(jtb)
        txt = plan.to_packets_txt()
        assert txt == want.to_packets_txt()
        assert txt.endswith("r5\n")
        specs = plan.specs()
        assert [s.channel for s in specs] == [37, 38, 39, 12]
        syn = plan.synthesize(device="cpu")
        ref = want.synthesize()
        assert len(syn) == len(ref) == 4
        for got, exp in zip(syn, ref):
            assert got.i.dtype == exp.i.dtype
            np.testing.assert_array_equal(got.i, exp.i)
            np.testing.assert_array_equal(got.q, exp.q)
            assert got.space_ms == exp.space_ms

    def test_json_plan(self, tmp_path):
        p = tmp_path / "plan.json"
        p.write_text(json.dumps({
            "packets": [{"type": "iBeacon", "channel": 37,
                         "fields": {"major": 17, "minor": 3}, "space_ms": 50},
                        {"type": "DISCOVERY", "channel": 38,
                         "fields": {"local_name": "Lamp", "tx_power": 4}}],
            "repeat": 3,
        }))
        from btle_tpu_torch.cli import load_plan

        plan = load_plan(p)
        assert plan.repeat == 3
        assert plan.packets[0].major == 17
        assert plan.packets[0].space_ms == 50
        assert plan.to_packets_txt() == jtb.load_plan(p).to_packets_txt()
        with pytest.raises(ValueError, match="unknown packet type"):
            p.write_text(json.dumps({"packets": [{"type": "Nope"}]}))
            load_plan(p)
