"""Property-based round trips (hypothesis) on the port, mirroring the
seven tests of tests/test_property.py: arbitrary payloads and link
parameters survive TX -> RX bit-exactly through the port's golden model,
golden_decode and stream_decode (the plain path on the CPU), the spec
primitives and descriptor serialization round-trip, and CSA#1 remaps
onto used channels. Each example is also fed to btle_tpu and the
results held equal (exact)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
hypothesis = pytest.importorskip("hypothesis")

from hypothesis import HealthCheck, given, settings, strategies as st

from btle_tpu.golden import model as JG
from btle_tpu.spec import bits as JB
from btle_tpu.spec import crc24 as JC

from btle_tpu_torch.golden import model as G
from btle_tpu_torch.rx import golden_decode, stream_decode
from btle_tpu_torch.spec import bits as B
from btle_tpu_torch.spec import crc24 as C
from btle_tpu_torch.spec import whitening as W

torch.set_num_threads(2)

SET = settings(max_examples=25, deadline=None,
               suppress_health_check=[HealthCheck.filter_too_much, HealthCheck.too_slow])


@st.composite
def adv_pdu(draw):
    plen = draw(st.integers(6, 37))
    pdu_type = draw(st.sampled_from([0, 1, 2, 3, 4, 5, 6]))
    txrx = draw(st.integers(0, 3))
    payload = draw(st.binary(min_size=plen, max_size=plen))
    return np.frombuffer(bytes([pdu_type | (txrx << 6), plen]) + payload, np.uint8)


@st.composite
def data_pdu(draw):
    plen = draw(st.integers(0, 31))
    h0 = draw(st.integers(0, 255)) & 0x1F | draw(st.sampled_from([1, 2, 3]))
    payload = draw(st.binary(min_size=plen, max_size=plen))
    return np.frombuffer(bytes([h0, plen]) + payload, np.uint8)


class TestRoundTrip:
    @SET
    @given(adv_pdu())
    def test_adv_roundtrip_golden_flavor(self, pdu_bytes):
        pdu_bits = B.bytes_to_bits(pdu_bytes)
        i, q, _ = G.btle_tx(pdu_bits, 37)
        ji, jq, _ = JG.btle_tx(pdu_bits, 37)
        assert np.array_equal(i, ji) and np.array_equal(q, jq)
        res = golden_decode(i, q, 37, device="cpu")
        assert res.crc_ok
        np.testing.assert_array_equal(res.pdu_bits, pdu_bits)

    @SET
    @given(data_pdu(), st.integers(0, 36), st.integers(0, 0xFFFFFF),
           st.integers(1, 0xFFFFFFFE))
    def test_data_roundtrip_c_flavor(self, pdu_bytes, channel, crc_init, aa):
        aa_hex = aa.to_bytes(4, "little").hex()
        crc_hex = f"{crc_init:06x}"
        pdu_bits = B.bytes_to_bits(pdu_bytes)
        i, q, _ = G.btle_tx(pdu_bits, channel, crc_init_hex=crc_hex,
                            access_address_hex=aa_hex, sps=4, flavor="c")
        pad = np.zeros(200, np.int16)
        i = np.concatenate([pad, i.astype(np.int16), pad])
        q = np.concatenate([pad, q.astype(np.int16), pad])
        # spec-plausible access addresses only (tests/test_property.py's
        # filter: no run of more than six equal bits, no alias into the
        # lattice before the true start)
        aa_bits = B.hex_to_bits(aa_hex)
        runs = np.diff(np.flatnonzero(np.diff(
            np.concatenate([[1 - aa_bits[0]], aa_bits, [1 - aa_bits[-1]]]))))
        hypothesis.assume(runs.max() <= 6)
        d = np.int32(i[:-1]) * np.int32(q[1:]) - np.int32(i[1:]) * np.int32(q[:-1])
        lattice = (d > 0).astype(np.int8)
        win = np.lib.stride_tricks.sliding_window_view(lattice, 32 * 4)[:, ::4]
        hits = np.flatnonzero((win == aa_bits).all(axis=1))
        hypothesis.assume(len(hits) > 0 and 232 <= hits[0] <= 248)
        sniffed = int.from_bytes(bytes.fromhex(crc_hex), "big")
        res = stream_decode(i, q, channel, access_address=aa,
                            crc_init_table=C.crc_init_reorder(sniffed), sps=4, device="cpu")
        ok = [p for p in res.packets if p.crc_ok]
        assert len(ok) >= 1
        np.testing.assert_array_equal(ok[0].pdu_bytes, pdu_bytes)


class TestPrimitivesProperties:
    @SET
    @given(st.binary(min_size=1, max_size=64), st.integers(0, 0xFFFFFF))
    def test_crc_lfsr_table_equivalence(self, data, init24):
        arr = np.frombuffer(data, np.uint8)
        init_hex = f"{init24:06x}"
        crc_bits = C.crc24_bits(B.bytes_to_bits(arr), B.hex_to_bits(init_hex))
        table = C.crc24_bytes(arr, C.lfsr_init_to_table_init(init_hex))
        assert B.bits_to_uint(crc_bits) == table
        assert table == JC.crc24_bytes(arr, JC.lfsr_init_to_table_init(init_hex))

    @SET
    @given(st.integers(0, 39), st.integers(1, 400))
    def test_whitening_involution(self, channel, n):
        from btle_tpu.spec import whitening as JW

        rng = np.random.default_rng(channel * 1000 + n)
        bits = rng.integers(0, 2, n).astype(np.int8)
        once = W.whiten_bits(bits, channel)
        assert np.array_equal(once, JW.whiten_bits(bits, channel))
        assert np.array_equal(W.whiten_bits(once, channel), bits)

    @SET
    @given(st.binary(min_size=1, max_size=64))
    def test_hex_roundtrip(self, data):
        h = data.hex()
        assert B.bits_to_hex(B.hex_to_bits(h)) == h
        assert np.array_equal(B.hex_to_bits(h), JB.hex_to_bits(h))


class TestDescriptorProperties:
    @SET
    @given(st.binary(min_size=6, max_size=31), st.integers(0, 1), st.integers(0, 1))
    def test_adv_ind_descriptor_roundtrip(self, adv_data, txadd, rxadd):
        from btle_tpu.tx import parse_descriptor as j_parse_descriptor

        from btle_tpu_torch.ll import parse_adv_payload
        from btle_tpu_torch.tx import parse_descriptor

        desc = (f"37-ADV_IND-TxAdd-{txadd}-RxAdd-{rxadd}-"
                f"AdvA-0A0B0C0D0E0F-AdvData-{adv_data.hex()}")
        spec = parse_descriptor(desc)
        assert np.array_equal(spec.info_bits, j_parse_descriptor(desc).info_bits)
        pdu = B.bits_to_bytes(spec.info_bits)[5:]
        assert pdu[0] == (txadd << 6) | (rxadd << 7)
        payload = parse_adv_payload(pdu[2:], 0)
        assert payload.adv_a == bytes.fromhex("0a0b0c0d0e0f")
        assert payload.data == adv_data


class TestCsa1Properties:
    @SET
    @given(st.integers(0, 2 ** 37 - 1), st.integers(5, 16), st.integers(0, 36))
    def test_remap_lands_on_used_channels(self, mask, hop, start):
        from btle_tpu.spec import channels as JCH

        from btle_tpu_torch.spec.channels import chm_used_channels, csa1_channel

        chm = bytes(int(mask).to_bytes(5, "little")[::-1])
        brute = tuple(ch for ch in range(37) if (mask >> ch) & 1)
        used = chm_used_channels(chm)
        assert used == brute == JCH.chm_used_channels(chm)
        if len(used) < 2:
            return
        un = start
        for _ in range(64):
            un = (un + hop) % 37
            ch = csa1_channel(un, used)
            assert ch in used and ch == JCH.csa1_channel(un, used)
            if un in used:
                assert ch == un
            else:
                assert ch == used[un % len(used)]
