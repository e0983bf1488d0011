"""The port's LL encryption (ll/crypto.py: AES-128 and AES-CCM in numpy)
against btle_tpu.ll.crypto (AES from the ``cryptography`` package) on
the CPU, mirroring tests/test_llcrypto.py: the primitives, the session
(loopback, AAD masking, MIC tamper, counter resynchronisation,
directions), the sniffed end-to-end scenes through the port's wideband
sniffer, and ``wideband --ltk`` through its stream runner. Plus the
FIPS-197 and RFC 3610 vectors, and random keys and payloads of 0-251
bytes. Every comparison is exact (bytes)."""

import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("cryptography")

from cryptography.hazmat.primitives.ciphers.aead import AESCCM

from btle_tpu.golden import model as G
from btle_tpu.ll import crypto as J
from btle_tpu.ll.pdu import LlPduType, parse_ll_payload
from btle_tpu.spec import bits as B

from btle_tpu_torch.ll import crypto as T
from btle_tpu_torch.wideband import WidebandConfig, WidebandSniffer, synthesize_wideband
from test_hop import CONN_AA, CONN_AA_HEX, CRC_INIT_HEX, connect_req_pdu

torch.set_num_threads(2)

LTK = bytes.fromhex("4C68384139F574D836BCF34E9DFB01BF")
SKD_M = bytes.fromhex("13024212ACDEAF99")     # on-air LE order, as parsed
SKD_S = bytes.fromhex("7907E2021B24D379")
IV_M = bytes.fromhex("BADCAB24")
IV_S = bytes.fromhex("DEAFBABE")


def make_pair(mod=T):
    return tuple(mod.LlSession.from_enc_exchange(LTK, SKD_M, SKD_S, IV_M, IV_S)
                 for _ in range(2))


# --------------------------------------------------------------------------
# the standards' vectors
# --------------------------------------------------------------------------


@pytest.mark.parametrize("key,pt,ct", [
    # FIPS-197 Appendix C.1 (AES-128)
    ("000102030405060708090a0b0c0d0e0f", "00112233445566778899aabbccddeeff",
     "69c4e0d86a7b0430d8cdb78070b4c55a"),
    # FIPS-197 Appendix B
    ("2b7e151628aed2a6abf7158809cf4f3c", "3243f6a8885a308d313198a2e0370734",
     "3925841d02dc09fbdc118597196a0b32"),
])
def test_fips197_vectors(key, pt, ct):
    assert T.aes_e(bytes.fromhex(key), bytes.fromhex(pt)).hex() == ct
    assert J.aes_e(bytes.fromhex(key), bytes.fromhex(pt)).hex() == ct


# RFC 3610 section 8, packet vectors #1-#3 as printed there (the encrypted
# payload and MIC after the 8-byte header)
RFC3610_OUT = {
    1: "588c979a61c663d2f066d0c2c0f989806d5f6b61dac38417e8d12cfdf926e0",
    2: "72c91a36e135f8cf291ca894085c87e3cc15c439c9e43a3ba091d56e10400916",
    3: "51b1e5f44a197d1da46b0f8e2d282ae871e838bb64da8596574adaa76fbd9fb0c5",
}


@pytest.mark.parametrize("n", range(1, 13))
def test_rfc3610_vectors(n):
    """RFC 3610's packet vectors #1-#12 (key C0..CF, nonce 00 00 00 n+2
    n+1 n n-1 A0..A5, packets 00 01 02 ... of 31-33 bytes, 8- or 12-byte
    header, M = 8 for #1-#6 and 10 for #7-#12): the port's CCM equals
    the printed output (#1-#3) and the cryptography package's, and
    decrypts back."""
    key = bytes(range(0xC0, 0xD0))
    mic = 8 if n <= 6 else 10
    hdr = 8 if (n - 1) % 6 < 3 else 12
    pkt = bytes(range(31 + (n - 1) % 3))
    nonce = bytes([0, 0, 0, n + 2, n + 1, n, n - 1]) + bytes(range(0xA0, 0xA6))
    got = T.ccm_encrypt(key, nonce, pkt[hdr:], pkt[:hdr], mic)
    assert got == AESCCM(key, tag_length=mic).encrypt(nonce, pkt[hdr:], pkt[:hdr])
    if n in RFC3610_OUT:
        assert got.hex() == RFC3610_OUT[n]
    assert T.ccm_decrypt(key, nonce, got, pkt[:hdr], mic) == pkt[hdr:]
    bad = bytearray(got)
    bad[0] ^= 0x80
    assert T.ccm_decrypt(key, nonce, bytes(bad), pkt[:hdr], mic) is None


# --------------------------------------------------------------------------
# random keys and payloads against btle_tpu
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_aes_random_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(30):
        key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        pt = rng.integers(0, 256, 16 * int(rng.integers(1, 4)), dtype=np.uint8).tobytes()
        assert T.aes_e(key, pt) == J.aes_e(key, pt)
    with pytest.raises(ValueError):
        T.aes_e(bytes(16), bytes(15))
    with pytest.raises(ValueError):
        T.aes_e(bytes(24), bytes(16))


@pytest.mark.parametrize("seed", range(4))
def test_sessions_random_equal_jax(seed):
    """Random LTK, SKD and IV; payloads of 0-251 bytes in both
    directions: the port's ciphertexts, MICs, plaintexts, counters and
    rejections equal btle_tpu's."""
    rng = np.random.default_rng(100 + seed)
    r = lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    ltk, skd_m, skd_s, iv_m, iv_s = r(16), r(8), r(8), r(4), r(4)
    jtx, jrx = (J.LlSession.from_enc_exchange(ltk, skd_m, skd_s, iv_m, iv_s) for _ in range(2))
    ttx, trx = (T.LlSession.from_enc_exchange(ltk, skd_m, skd_s, iv_m, iv_s) for _ in range(2))
    assert (ttx.sk, ttx.iv) == (jtx.sk, jtx.iv)
    lengths = [0, 1, 15, 16, 17, 27, 251] + [int(x) for x in rng.integers(0, 252, 6)]
    for k, n in enumerate(lengths):
        direction, hdr = k % 2, int(rng.integers(0, 256))
        payload = r(n)
        ct = ttx.encrypt(hdr, payload, direction)
        assert ct == jtx.encrypt(hdr, payload, direction)
        assert len(ct) == n + T.MIC_LEN
        if k % 5 == 4:
            continue                                  # a PDU the sniffer missed
        got = trx.decrypt(hdr, ct, direction)
        assert got == jrx.decrypt(hdr, ct, direction)
        assert got == (payload if n else None)        # MIC-only PDUs are refused
        tampered = bytearray(ct)
        tampered[int(rng.integers(0, len(ct)))] ^= 1 << int(rng.integers(0, 8))
        assert trx.decrypt(hdr, bytes(tampered), direction) is None
        assert jrx.decrypt(hdr, bytes(tampered), direction) is None
        assert trx.counters == jrx.counters
    assert ttx.counters == jtx.counters


def test_sniff_decryptor_stream_equals_jax():
    """A packet stream (ENC_REQ, ENC_RSP, encrypted and plaintext data
    PDUs in both directions, a second connection never keyed) through
    both SniffDecryptors: the same plaintexts, counts and sessions."""
    from types import SimpleNamespace

    rng = np.random.default_rng(7)
    enc_req = bytes([0x03]) + bytes(range(8)) + b"\x11\x22" + SKD_M + IV_M
    enc_rsp = bytes([0x04]) + SKD_S + IV_S
    req = parse_ll_payload(enc_req, LlPduType.LL_CTRL)
    rsp = parse_ll_payload(enc_rsp, LlPduType.LL_CTRL)
    tx = T.LlSession.from_enc_exchange(LTK, SKD_M, SKD_S, IV_M, IV_S)
    stream = [SimpleNamespace(access_addr=CONN_AA, crc_ok=True, payload=req, pdu_bytes=b""),
              SimpleNamespace(access_addr=CONN_AA, crc_ok=True, payload=rsp, pdu_bytes=b"")]
    for k in range(12):
        body = rng.integers(0, 256, int(rng.integers(1, 28)), dtype=np.uint8).tobytes()
        hdr = (1, 2)[k % 2] | (k % 2) << 3
        enc = k % 4 != 3
        pdu = bytes([hdr, 0]) + (tx.encrypt(hdr, body, k % 3 == 0) if enc else body)
        aa = 0x11223344 if k == 5 else CONN_AA
        stream.append(SimpleNamespace(access_addr=aa, crc_ok=k != 8, payload=None, pdu_bytes=pdu))
    out = []
    for mod in (J, T):
        dec = mod.SniffDecryptor(LTK)
        out.append(([dec.on_packet(p) for p in stream], dec.decrypted, sorted(dec.sessions)))
    assert out[0] == out[1]
    assert out[1][1] >= 6


# --------------------------------------------------------------------------
# tests/test_llcrypto.py on the port
# --------------------------------------------------------------------------


class TestPrimitives:
    def test_aes_e_is_aes128(self):
        key = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
        pt = bytes.fromhex("00112233445566778899aabbccddeeff")
        assert T.aes_e(key, pt).hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"

    def test_session_key_deterministic(self):
        skd = (SKD_M + SKD_S)[::-1]
        sk = T.session_key(LTK, skd)
        assert sk == T.session_key(LTK, skd) and len(sk) == 16
        assert sk != T.session_key(LTK, bytes(16))
        assert sk == J.session_key(LTK, skd)

    def test_bad_lengths(self):
        with pytest.raises(ValueError):
            T.session_key(LTK[:8], bytes(16))


class TestSession:
    def test_loopback_both_directions(self):
        tx, rx = make_pair()
        jtx, _ = make_pair(J)
        for direction in (0, 1):
            for k in range(5):
                payload = bytes([direction] * 4 + [k] * 6)
                hdr = 0x02 | (k % 2) << 3          # SN toggles
                ct = tx.encrypt(hdr, payload, direction)
                assert ct == jtx.encrypt(hdr, payload, direction)
                assert len(ct) == len(payload) + 4  # MIC appended
                assert ct[: len(payload)] != payload
                assert rx.decrypt(hdr, ct, direction) == payload

    def test_aad_masks_retransmission_bits(self):
        tx, rx = make_pair()
        ct = tx.encrypt(0x02, b"hello-enc", 0)
        assert rx.decrypt(0x02 | 0x04 | 0x08 | 0x10, ct, 0) == b"hello-enc"

    def test_llid_is_authenticated(self):
        tx, rx = make_pair()
        ct = tx.encrypt(0x02, b"payload!", 0)
        assert rx.decrypt(0x01, ct, 0) is None      # LLID flip -> MIC fail

    def test_mic_tamper_detected(self):
        tx, rx = make_pair()
        ct = bytearray(tx.encrypt(0x02, b"abcdef", 0))
        ct[-1] ^= 1
        assert rx.decrypt(0x02, bytes(ct), 0) is None

    def test_counter_resync_over_missed_pdus(self):
        tx, rx = make_pair()
        cts = [tx.encrypt(0x02, bytes([k] * 8), 0) for k in range(6)]
        assert rx.decrypt(0x02, cts[4], 0) == bytes([4] * 8)
        assert rx.counters[0] == 5
        assert rx.decrypt(0x02, cts[5], 0) == bytes([5] * 8)
        tx2, rx2 = make_pair()
        cts2 = [tx2.encrypt(0x02, b"x" * 4, 0) for _ in range(12)]
        assert rx2.decrypt(0x02, cts2[11], 0) is None

    def test_directions_independent(self):
        tx, rx = make_pair()
        c0 = tx.encrypt(0x02, b"m2s", 0)
        c1 = tx.encrypt(0x02, b"s2m", 1)
        assert rx.decrypt(0x02, c0, 1) is None
        assert rx.decrypt(0x02, c0, 0) == b"m2s"
        assert rx.decrypt(0x02, c1, 1) == b"s2m"


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


class TestSniffedEndToEnd:
    def test_encrypted_connection_through_wideband(self):
        tx, rx_sess = make_pair()
        secret = b"top-secret-data"
        hdr = 0x02
        enc = tx.encrypt(hdr, secret, 0)
        n = 200_000
        wi, wq = _compose(n, [(9, _burst(bytes([hdr, len(enc)]) + enc, 9), 8_000)])
        rng = np.random.default_rng(0)
        wi += rng.normal(0, 0.02, n).astype(np.float32)
        wq += rng.normal(0, 0.02, n).astype(np.float32)
        pkts = [p for p in WidebandSniffer(WidebandConfig(), device="cpu").run(wi, wq)
                if p.crc_ok and p.channel == 9]
        assert pkts
        raw = bytes(pkts[0].pdu_bytes)
        assert raw[0] == hdr and raw[2:] == enc
        assert rx_sess.decrypt(raw[0], raw[2:], 0) == secret


ENC_REQ = bytes([0x03]) + bytes(range(8)) + b"\x11\x22" + SKD_M + IV_M
ENC_RSP = bytes([0x04]) + SKD_S + IV_S


class TestParsedExchange:
    def test_constructors_agree(self):
        req = parse_ll_payload(ENC_REQ, LlPduType.LL_CTRL).ctrl.fields
        rsp = parse_ll_payload(ENC_RSP, LlPduType.LL_CTRL).ctrl.fields
        a = T.LlSession.from_enc_exchange(LTK, SKD_M, SKD_S, IV_M, IV_S)
        b = T.LlSession.from_parsed_exchange(LTK, req, rsp)
        j = J.LlSession.from_parsed_exchange(LTK, req, rsp)
        assert a.sk == b.sk == j.sk and a.iv == b.iv == j.iv

    def test_full_sniffed_exchange_decrypts(self):
        from btle_tpu_torch.ll.pdu import LlPduType as TLlPduType
        from btle_tpu_torch.ll.pdu import parse_ll_payload as t_parse

        tx = T.LlSession.from_enc_exchange(LTK, SKD_M, SKD_S, IV_M, IV_S)
        secret = b"encrypted-link!"
        enc_payload = tx.encrypt(0x02, secret, 0)
        wi, wq = _compose(400_000, [
            (17, _burst(bytes([0x03, len(ENC_REQ)]) + ENC_REQ, 17), 8_000),
            (17, _burst(bytes([0x03, len(ENC_RSP)]) + ENC_RSP, 17), 150_000),
            (17, _burst(bytes([0x02, len(enc_payload)]) + enc_payload, 17), 290_000)])
        pkts = sorted((p for p in WidebandSniffer(WidebandConfig(), device="cpu").run(wi, wq)
                       if p.crc_ok and p.channel == 17), key=lambda p: p.sample_pos)
        assert len(pkts) == 3
        req = t_parse(bytes(pkts[0].pdu_bytes[2:]), TLlPduType.LL_CTRL).ctrl.fields
        rsp = t_parse(bytes(pkts[1].pdu_bytes[2:]), TLlPduType.LL_CTRL).ctrl.fields
        sess = T.LlSession.from_parsed_exchange(LTK, req, rsp)
        raw = bytes(pkts[2].pdu_bytes)
        assert sess.decrypt(raw[0], raw[2:], 0) == secret


def encrypted_connection_scene(secret: bytes = b"wideband-secret"):
    """tests/test_llcrypto.py::TestRunnerIntegration's scene: a
    CONNECT_REQ on 37 in block 0, then LL_ENC_REQ, LL_ENC_RSP and one
    encrypted LL data PDU on data channel 9 in block 1."""
    tx = J.LlSession.from_enc_exchange(LTK, SKD_M, SKD_S, IV_M, IV_S)
    enc_payload = tx.encrypt(0x02, secret, 0)
    block = 8192 * 20
    kw = dict(crc_init_hex=CRC_INIT_HEX, access_address_hex=CONN_AA_HEX)
    cr = B.bits_to_bytes(connect_req_pdu()).tobytes()
    return _compose(2 * block, [
        (37, _burst(cr, 37), 20_000),
        (9, _burst(bytes([0x03, 23]) + ENC_REQ, 9, **kw), block + 20_000),
        (9, _burst(bytes([0x03, 13]) + ENC_RSP, 9, **kw), block + 60_000),
        (9, _burst(bytes([0x02, len(enc_payload)]) + enc_payload, 9, **kw), block + 100_000)])


def _without_ts(text: str) -> list:
    evs = [json.loads(ln) for ln in text.splitlines()]
    for e in evs:
        e.pop("ts", None)
    return evs


class TestRunnerIntegration:
    def test_wideband_ltk_decrypts_followed_connection(self):
        """CONNECT_REQ followed -> data channels re-keyed -> LL_ENC_REQ/RSP
        sniffed on the connection's AA -> the encrypted PDU decrypts
        in-stream and lands in NDJSON as plain_hex (wideband --ltk); the
        port's events equal btle_tpu's, ts aside."""
        from btle_tpu.stream.ndjson import NdjsonEmitter as JEmitter
        from btle_tpu.wideband import WidebandConfig as JConfig
        from btle_tpu.wideband import WidebandSniffer as JSniffer
        from btle_tpu.wideband.stream import WidebandStreamRunner as JRunner

        from btle_tpu_torch.stream.ndjson import NdjsonEmitter
        from btle_tpu_torch.wideband.stream import WidebandStreamRunner

        wi, wq = encrypted_connection_scene()
        out, text = io.StringIO(), io.StringIO()
        runner = WidebandStreamRunner(
            WidebandSniffer(WidebandConfig(follow_connections=True), device="cpu"),
            ndjson=NdjsonEmitter(out), ltk=LTK)
        runner.run_capture(wi, wq)
        evs = [json.loads(ln) for ln in out.getvalue().splitlines()]
        data = [e for e in evs if e.get("kind") == "data" and e["crc_ok"]]
        assert any(e["aa"] == f"{CONN_AA:08x}" for e in data)
        plains = [e for e in data if "plain_hex" in e]
        assert plains and plains[0]["plain_hex"] == b"wideband-secret".hex()
        assert runner.decryptor.decrypted == 1

        jout = io.StringIO()
        jrunner = JRunner(JSniffer(JConfig(follow_connections=True)),
                          ndjson=JEmitter(jout), ltk=LTK)
        jrunner.run_capture(wi, wq)
        assert _without_ts(out.getvalue()) == _without_ts(jout.getvalue())

        # the text line carries plain:<hex>
        WidebandStreamRunner(
            WidebandSniffer(WidebandConfig(follow_connections=True), device="cpu"),
            text_fh=text, ltk=LTK).run_capture(wi, wq)
        lines = [ln for ln in text.getvalue().splitlines() if " plain:" in ln]
        assert len(lines) == 1 and lines[0].endswith(f"plain:{b'wideband-secret'.hex()}")
