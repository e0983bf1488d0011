"""The port's L2CAP reassembly and ATT parsing (ll/l2cap.py, a copy of
btle_tpu.ll.l2cap) and ``recon gatt`` with and without the LTK, against
btle_tpu on the CPU, mirroring tests/test_l2cap.py: reassembly, ATT
opcodes, the sniffed and decrypted GATT notification through the port's
wideband sniffer, and the pcap -> decrypted GATT report. Random fragment
streams and ATT payloads go through both packages; the reports print the
same bytes. Every comparison is exact."""

import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("cryptography")

from btle_tpu.cli import app as japp
from btle_tpu.cli import recon as jrecon
from btle_tpu.golden import model as G
from btle_tpu.ll import l2cap as JL
from btle_tpu.spec import bits as B

from btle_tpu_torch.cli import app as tapp
from btle_tpu_torch.cli import recon as trecon
from btle_tpu_torch.ll import l2cap as TL
from btle_tpu_torch.ll.crypto import LlSession, session_key
from btle_tpu_torch.ll.l2cap import CID_ATT, L2capReassembler, att_stream, parse_att
from btle_tpu_torch.wideband import WidebandConfig, WidebandSniffer, synthesize_wideband
from test_hop import CONN_AA_HEX, CRC_INIT_HEX, connect_req_pdu

torch.set_num_threads(2)


def l2cap(cid: int, payload: bytes) -> bytes:
    return len(payload).to_bytes(2, "little") + cid.to_bytes(2, "little") + payload


class TestReassembly:
    def test_single_fragment(self):
        rs = L2capReassembler()
        frames = rs.feed(2, l2cap(CID_ATT, b"\x0a\x03\x00"))
        assert len(frames) == 1
        assert frames[0].cid == CID_ATT and frames[0].cid_name == "ATT"
        assert frames[0].payload == b"\x0a\x03\x00"

    def test_three_fragment_sdu(self):
        whole = l2cap(CID_ATT, bytes([0x1B, 0x10, 0x00]) + bytes(range(40)))
        rs = L2capReassembler()
        assert rs.feed(2, whole[:10]) == []
        assert rs.feed(1, whole[10:20]) == []
        frames = rs.feed(1, whole[20:])
        assert len(frames) == 1 and frames[0].payload == whole[4:]

    def test_two_sdus_in_one_pdu(self):
        a = l2cap(CID_ATT, b"\x0b\x42")
        b = l2cap(CID_ATT, b"\x13")
        frames = L2capReassembler().feed(2, a + b)
        assert [f.payload for f in frames] == [b"\x0b\x42", b"\x13"]

    def test_missed_start_discards(self):
        rs = L2capReassembler()
        assert rs.feed(1, b"\x99\x99") == []
        assert rs.discarded == 1
        whole = l2cap(CID_ATT, bytes(30))
        rs.feed(2, whole[:8])
        frames = rs.feed(2, l2cap(CID_ATT, b"\x0b"))
        assert rs.discarded == 2 and len(frames) == 1

    def test_empty_pdu_ignored(self):
        rs = L2capReassembler()
        whole = l2cap(CID_ATT, bytes([0x0B]) + bytes(10))
        rs.feed(2, whole[:6])
        assert rs.feed(1, b"") == []
        assert rs.feed(1, whole[6:])[0].payload == whole[4:]


class TestAtt:
    def test_common_ops(self):
        ntf = parse_att(bytes([0x1B, 0x2A, 0x00]) + b"\x64")
        assert ntf.name == "ATT_HANDLE_VALUE_NTF" and ntf.handle == 0x2A and ntf.value == b"\x64"
        w = parse_att(bytes([0x52, 0x10, 0x00]) + b"\x01")
        assert w.name == "ATT_WRITE_CMD" and w.handle == 0x10
        assert parse_att(bytes([0x02, 0xF7, 0x00])).mtu == 247
        assert parse_att(bytes([0x01, 0x0A, 0x05, 0x00, 0x0A])).error == (0x0A, 5, 0x0A)
        assert parse_att(bytes([0x0B]) + b"value!").value == b"value!"
        assert parse_att(b"") is None

    def test_att_stream_over_fragments(self):
        ops_in = [bytes([0x0A, 0x03, 0x00]), bytes([0x0B]) + b"hello",
                  bytes([0x1B, 0x2A, 0x00]) + b"\x42\x43"]
        pdus = []
        for k, op in enumerate(ops_in):
            whole = l2cap(CID_ATT, op)
            pdus += [(2, whole[:5]), (1, whole[5:])] if k == 1 else [(2, whole)]
        ops = att_stream(pdus)
        assert [o.name for o in ops] == ["ATT_READ_REQ", "ATT_READ_RSP", "ATT_HANDLE_VALUE_NTF"]
        assert ops[1].value == b"hello"
        assert ops[2].handle == 0x2A and ops[2].value == b"\x42\x43"


@pytest.mark.parametrize("seed", range(3))
def test_random_streams_equal_jax(seed):
    """Random ATT operations (every opcode of the table and unknown
    ones, odd lengths) on random CIDs, fragmented at random, with
    dropped, empty and LLID-3 PDUs: both reassemblers give the same
    frames and discards, both parsers the same operations."""
    rng = np.random.default_rng(seed)
    opcodes = sorted(JL.ATT_OPCODES) + [0x00, 0x7F, 0xFF]
    pdus = []
    for _ in range(60):
        op = bytes([int(rng.choice(opcodes))]) + rng.integers(
            0, 256, int(rng.integers(0, 30)), dtype=np.uint8).tobytes()
        whole = l2cap(int(rng.choice([4, 4, 4, 5, 6, 0x40])), op)
        cuts = sorted(rng.choice(np.arange(1, len(whole)), int(rng.integers(0, 3)),
                                 replace=False).tolist()) if len(whole) > 2 else []
        frags = [whole[a:b] for a, b in zip([0, *cuts], [*cuts, len(whole)])]
        for k, frag in enumerate(frags):
            if rng.random() < 0.05:
                continue                                  # missed PDU
            pdus.append((2 if k == 0 else 1, frag))
            if rng.random() < 0.1:
                pdus.append((int(rng.choice([1, 3])), b""))
    outs = []
    for mod in (JL, TL):
        rs = mod.L2capReassembler()
        frames = [(f.cid, f.cid_name, f.payload) for llid, p in pdus for f in rs.feed(llid, p)]
        ops = [dataclasses.astuple(o) for o in mod.att_stream(pdus)]
        outs.append((frames, rs.discarded, ops))
    assert outs[0] == outs[1]
    for _ in range(300):
        p = rng.integers(0, 256, int(rng.integers(0, 8)), dtype=np.uint8).tobytes()
        j, t = JL.parse_att(p), TL.parse_att(p)
        assert (j is None and t is None) or dataclasses.astuple(j) == dataclasses.astuple(t)


def _burst(octets: bytes, ch: int, **kw):
    pdu = B.bytes_to_bits(np.frombuffer(octets, np.uint8))
    return G.gfsk_modulate_float(G.assemble_phy_bits(pdu, ch, **kw), 80)


def _compose(n, bursts):
    wi = np.zeros(n, np.float32)
    wq = np.zeros(n, np.float32)
    for ch, sig, off in bursts:
        si, sq = synthesize_wideband({ch: sig}, n, {ch: off})
        wi += si
        wq += sq
    return wi, wq


class TestSniffedGatt:
    def test_gatt_over_decrypted_connection(self):
        """Encrypted LL PDUs carrying a fragmented ATT notification ->
        the port's wideband sniff -> decrypt -> reassembly -> the GATT
        operation."""
        ltk, skd = bytes(range(16)), bytes(range(16, 32))
        tx = LlSession(sk=session_key(ltk, skd), iv=bytes(8))
        rx = LlSession(sk=tx.sk, iv=tx.iv)
        whole = l2cap(CID_ATT, bytes([0x1B, 0x2A, 0x00]) + b"heart-rate=72")
        octets = []
        for llid, frag in ((2, whole[:9]), (1, whole[9:])):
            enc = tx.encrypt(llid, frag, 0)
            octets.append(bytes([llid, len(enc)]) + enc)
        wi, wq = _compose(400_000, [(21, _burst(o, 21), 20_000 + 120_000 * k)
                                    for k, o in enumerate(octets)])
        pkts = sorted((p for p in WidebandSniffer(WidebandConfig(), device="cpu").run(wi, wq)
                       if p.crc_ok and p.channel == 21), key=lambda p: p.sample_pos)
        assert len(pkts) == 2
        data_pdus = []
        for p in pkts:
            raw = bytes(p.pdu_bytes)
            plain = rx.decrypt(raw[0], raw[2:], 0)
            assert plain is not None
            data_pdus.append((raw[0] & 0x03, plain))
        ops = att_stream(data_pdus)
        assert len(ops) == 1 and ops[0].name == "ATT_HANDLE_VALUE_NTF"
        assert ops[0].handle == 0x2A and ops[0].value == b"heart-rate=72"


LTK = bytes.fromhex("4C68384139F574D836BCF34E9DFB01BF")
SKD_M, SKD_S = bytes.fromhex("13024212ACDEAF99"), bytes.fromhex("7907E2021B24D379")
IV_M, IV_S = bytes.fromhex("BADCAB24"), bytes.fromhex("DEAFBABE")


def _run(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


class TestReconGatt:
    def test_pcap_gatt_report_with_ltk(self, tmp_path):
        """recon gatt: the port's wideband runner writes the pcap of a
        followed connection whose LL_ENC_REQ/RSP key the session; the
        port's report (and ``recon gatt --ltk``) equals btle_tpu's on it,
        byte for byte."""
        from btle_tpu_torch.stream.pcap import PcapWriter
        from btle_tpu_torch.wideband.stream import WidebandStreamRunner

        tx = LlSession.from_enc_exchange(LTK, SKD_M, SKD_S, IV_M, IV_S)
        att = bytes([0x12, 0x33, 0x00]) + b"\x07\x08"
        enc = tx.encrypt(0x02, l2cap(CID_ATT, att), 0)
        enc_req = bytes([0x03, 23, 0x03]) + bytes(range(8)) + b"\x11\x22" + SKD_M + IV_M
        enc_rsp = bytes([0x03, 13, 0x04]) + SKD_S + IV_S
        block = 8192 * 20
        kw = dict(crc_init_hex=CRC_INIT_HEX, access_address_hex=CONN_AA_HEX)
        cr = B.bits_to_bytes(connect_req_pdu()).tobytes()
        wi, wq = _compose(2 * block, [
            (37, _burst(cr, 37), 20_000),
            (9, _burst(enc_req, 9, **kw), block + 20_000),
            (9, _burst(enc_rsp, 9, **kw), block + 60_000),
            (9, _burst(bytes([0x02, len(enc)]) + enc, 9, **kw), block + 100_000)])
        pcap_path = tmp_path / "conn.pcap"
        runner = WidebandStreamRunner(
            WidebandSniffer(WidebandConfig(follow_connections=True), device="cpu"),
            pcap=PcapWriter(str(pcap_path)))
        runner.run_capture(wi, wq)
        runner.pcap.close()

        rep = trecon.gatt(str(pcap_path), ltk_hex=LTK.hex())
        assert rep.n_ctrl_pdus >= 2 and rep.n_data_pdus >= 1
        assert rep.n_decrypted == 1 and len(rep.ops) == 1
        op = rep.ops[0]
        assert op.name == "ATT_WRITE_REQ" and op.handle == 0x33
        assert op.value_hex == "0708" and op.decrypted
        rep2 = trecon.gatt(str(pcap_path))
        assert rep2.n_decrypted == 0 and not any(o.decrypted for o in rep2.ops)
        for ltk in (LTK.hex(), None, bytes(16).hex()):
            j = jrecon.gatt(str(pcap_path), ltk_hex=ltk)
            t = trecon.gatt(str(pcap_path), ltk_hex=ltk)
            for kw in ({}, {"indent": 2, "exclude_none": True}):
                assert t.model_dump_json(**kw) == j.model_dump_json(**kw)
        argv = ["recon", "gatt", str(pcap_path), "--ltk", LTK.hex()]
        assert _run(tapp.main, argv) == _run(japp.main, argv)
