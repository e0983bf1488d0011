"""BLE 5 extended advertising in the port (ll/pdu.py's extended-header
codec, a copy of btle_tpu's, the coded TX/RX chain and the wideband
sniffer's control-register re-keying) against btle_tpu on the CPU,
mirroring the nine tests of tests/test_extadv.py: each runs on the port
and its results are held equal to btle_tpu's on the same inputs
(exact)."""

import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from btle_tpu.ll import pdu as JP
from btle_tpu.spec import bits as B

from btle_tpu_torch.ll.pdu import (AdvPduType, build_ext_adv_payload, build_sync_info,
                                   extract_adv_a, parse_adv_header, parse_adv_payload,
                                   parse_ext_adv_payload, parse_sync_info)
from btle_tpu_torch.tx import parse_descriptor

torch.set_num_threads(2)


def _fields(x):
    return dataclasses.asdict(x)


class TestCodec:
    def test_full_field_roundtrip(self):
        kw = dict(adv_mode=2, adv_a=bytes.fromhex("0a0b0c0d0e0f"),
                  target_a=bytes.fromhex("102030405060"), adi=(0x123, 0xA),
                  aux_ptr=(12, 1, 2400, 2), tx_power=-8, adv_data=b"\x02\x01\x06")
        p = build_ext_adv_payload(**kw)
        assert p == JP.build_ext_adv_payload(**kw)
        ext = parse_ext_adv_payload(p)
        assert ext.adv_mode == 2
        assert ext.adv_a == bytes.fromhex("0a0b0c0d0e0f")
        assert ext.target_a == bytes.fromhex("102030405060")
        assert (ext.adi_did, ext.adi_sid) == (0x123, 0xA)
        assert (ext.aux_chan, ext.aux_ca, ext.aux_phy) == (12, 1, 2)
        assert ext.aux_offset_us == 2400 and ext.tx_power == -8
        assert p[1 + (p[0] & 0x3F):] == b"\x02\x01\x06"
        assert _fields(ext) == _fields(JP.parse_ext_adv_payload(p))

    def test_minimal_and_empty_header(self):
        p = build_ext_adv_payload(adv_mode=0, adv_data=b"\x11")
        ext = parse_ext_adv_payload(p)
        assert ext.adv_mode == 0 and ext.adv_a is None and p[1:] == b"\x11"
        assert _fields(ext) == _fields(JP.parse_ext_adv_payload(p))

    def test_aux_offset_units_300us(self):
        p = build_ext_adv_payload(adv_mode=0, aux_ptr=(5, 0, 600_000, 1))
        ext = parse_ext_adv_payload(p)
        assert ext.aux_offset_us == 600_000 and ext.aux_phy == 1
        assert p == JP.build_ext_adv_payload(adv_mode=0, aux_ptr=(5, 0, 600_000, 1))

    def test_truncated_header_rejected(self):
        p = bytearray(build_ext_adv_payload(adv_mode=0, adv_a=bytes(6)))
        p[0] = (p[0] & 0xC0) | 0x3F
        with pytest.raises(ValueError):
            parse_ext_adv_payload(bytes(p))
        with pytest.raises(ValueError):
            JP.parse_ext_adv_payload(bytes(p))

    def test_parse_adv_payload_integration(self):
        p = build_ext_adv_payload(adv_mode=1, adv_a=bytes.fromhex("a1b2c3d4e5f6"),
                                  adv_data=b"\x99")
        pl = parse_adv_payload(p, AdvPduType.ADV_EXT_IND)
        assert pl.ext is not None and pl.ext.adv_mode == 1
        assert extract_adv_a(pl, AdvPduType.ADV_EXT_IND) == bytes.fromhex("a1b2c3d4e5f6")
        assert bytes(pl.data) == b"\x99"
        jpl = JP.parse_adv_payload(p, JP.AdvPduType.ADV_EXT_IND)
        assert _fields(pl.ext) == _fields(jpl.ext) and pl.adv_a == jpl.adv_a


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert main(argv) == 0
    return out.getvalue()


class TestEndToEnd:
    def test_ext_adv_over_coded_phy(self, tmp_path):
        """An ADV_EXT_IND framed for the Coded PHY by the port's tx,
        decoded back by its coded receiver (both CLIs, in this process),
        parsed down to the extended-header fields; the files and the
        decode lines equal btle_tpu's."""
        from btle_tpu.cli import app as japp

        from btle_tpu_torch.cli import app as tapp

        desc = ("37-ADV_EXT_IND-TxAdd-0-RxAdd-0-AdvMode-0"
                "-AdvA-0A0B0C0D0E0F-AdvData-02010604097465-Space-1")
        outs = {}
        for name, main, extra in (("jax", japp.main, []), ("port", tapp.main, ["--device", "cpu"])):
            path = tmp_path / f"ext.{name}.bin"
            _cli(main, ["tx", desc, "--phy", "coded8", "--out", str(path), *extra])
            outs[name] = (path.read_bytes(), _cli(main, [
                "decode", "--bin", str(path), "--format", "f32", "--phy", "coded8",
                "--channel", "37", *extra]))
        assert outs["port"] == outs["jax"]
        line = [ln for ln in outs["port"][1].splitlines() if " crc0 " in ln][0]
        pdu = bytes.fromhex(line.split()[-1])
        hdr = parse_adv_header(pdu[:2])
        assert hdr.pdu_type == AdvPduType.ADV_EXT_IND
        pl = parse_adv_payload(pdu[2:], hdr.pdu_type)
        assert pl.adv_a == bytes.fromhex("0a0b0c0d0e0f")
        assert bytes(pl.data) == bytes.fromhex("02010604097465")

    def test_ext_adv_1m_wideband_scan(self):
        """ADV_EXT_IND on the uncoded 1M wideband path of the port."""
        from btle_tpu.tx import parse_descriptor as j_parse_descriptor
        from btle_tpu.tx.synth import scene_to_wideband as j_scene

        from btle_tpu_torch.tx.synth import scene_to_wideband
        from btle_tpu_torch.wideband import WidebandConfig, WidebandSniffer

        desc = ("38-ADV_EXT_IND-TxAdd-0-RxAdd-0-AdvMode-0"
                "-AdvA-A1B2C3D4E5F6-AdvData-CAFE-Space-1")
        wi, wq = scene_to_wideband([(parse_descriptor(desc), 9_000)], 200_000, noise_std=0.05)
        ji, jq = j_scene([(j_parse_descriptor(desc), 9_000)], 200_000, noise_std=0.05)
        assert np.array_equal(wi, ji) and np.array_equal(wq, jq)
        pkts = [p for p in WidebandSniffer(WidebandConfig(), device="cpu").run(wi, wq)
                if p.crc_ok and p.channel == 38]
        assert pkts
        p = pkts[0]
        assert p.header.pdu_type == AdvPduType.ADV_EXT_IND
        assert p.payload.ext is not None
        assert p.payload.adv_a == bytes.fromhex("a1b2c3d4e5f6")


class TestSyncInfo:
    def test_build_parse_roundtrip(self):
        args = (3000, 20000, bytes([0x1F, 0xFF, 0xFF, 0xFF, 0xFF]), 5, 0x60850A1B,
                0xA77B22, 0x1234)
        si = build_sync_info(*args)
        assert si == JP.build_sync_info(*args)
        p = parse_sync_info(si)
        assert (p.sync_offset_us, p.interval_us, p.sca) == (3000, 20000, 5)
        assert p.access_addr == 0x60850A1B and p.crc_init == 0xA77B22
        assert p.event_counter == 0x1234 and p.chm == bytes([0x1F, 0xFF, 0xFF, 0xFF, 0xFF])
        assert _fields(p) == _fields(JP.parse_sync_info(si))
        with pytest.raises(ValueError):
            parse_sync_info(si[:-1])

    def test_periodic_train_followed_by_rekey(self):
        """Parse the SyncInfo the port's wideband sniffer decodes, re-key
        the data channels with the train's AA/CRC init through
        apply_control_registers, and the AUX_SYNC_INDs decode on both
        data channels, as in btle_tpu."""
        from btle_tpu.golden import model as G
        from btle_tpu.wideband import WidebandConfig as JConfig
        from btle_tpu.wideband import WidebandSniffer as JSniffer

        from btle_tpu_torch.stream.control import REG_ACCESS_ADDR, REG_CRC_INIT
        from btle_tpu_torch.wideband import WidebandConfig, WidebandSniffer, synthesize_wideband

        per_aa = 0x71764129
        sync = build_sync_info(2400, 30000, bytes([0x1F] + [0xFF] * 4), 0, per_aa, 0x555555, 7)
        ext = build_ext_adv_payload(adv_mode=0, adv_a=bytes.fromhex("0a0b0c0d0e0f"),
                                    sync_info=sync)
        pdu = B.bytes_to_bits(np.frombuffer(bytes([0x07, len(ext)]) + ext, np.uint8))
        n = 600_000
        wi, wq = synthesize_wideband(
            {38: G.gfsk_modulate_float(G.assemble_phy_bits(pdu, 38), 80)}, n, {38: 4_000 * 80})
        train = build_ext_adv_payload(adv_mode=0, adv_data=b"\x55" * 6)
        tp = B.bytes_to_bits(np.frombuffer(bytes([0x07, len(train)]) + train, np.uint8))
        aa_hex = int(per_aa).to_bytes(4, "little").hex()
        for ch, t_us in ((11, 6_400), (29, 5_200)):
            si, sq = synthesize_wideband(
                {ch: G.gfsk_modulate_float(G.assemble_phy_bits(tp, ch, access_address_hex=aa_hex),
                                           80)}, n, {ch: t_us * 80})
            wi += si
            wq += sq
        ext_pkts = [p for p in WidebandSniffer(WidebandConfig(), device="cpu").run(wi, wq)
                    if p.crc_ok and p.channel == 38]
        assert ext_pkts
        raw = bytes(ext_pkts[0].pdu_bytes)
        info = parse_sync_info(parse_adv_payload(raw[2:], parse_adv_header(raw[:2]).pdu_type)
                               .ext.sync_info)
        assert info.access_addr == per_aa
        writes = [(REG_ACCESS_ADDR, info.access_addr), (REG_CRC_INIT, info.crc_init)]
        sn2 = WidebandSniffer(WidebandConfig(), device="cpu")
        sn2.apply_control_registers(writes)
        got = [p for p in sn2.run(wi, wq) if p.crc_ok and p.channel in (11, 29)]
        assert {p.channel for p in got} == {11, 29}
        assert all(p.access_addr == per_aa for p in got)
        jsn = JSniffer(JConfig())
        jsn.apply_control_registers(writes)
        want = [(p.channel, p.sample_pos, bytes(p.pdu_bytes)) for p in jsn.run(wi, wq)
                if p.crc_ok and p.channel in (11, 29)]
        assert [(p.channel, p.sample_pos, bytes(p.pdu_bytes)) for p in got] == want
