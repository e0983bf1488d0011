"""LL encryption: AES-CCM session crypto for sniffed connections.

Port of btle_tpu/ll/crypto.py. The JAX module takes AES-128-ECB and
AES-CCM from the ``cryptography`` package; the port has its own, in
numpy on uint8 arrays (host-side, as in the JAX package: a 27-byte PDU is
six block encryptions):

* AES-128 (FIPS-197): the S-box built from the GF(2^8) inverse and the
  affine map, the 44-word key schedule, then 10 rounds of SubBytes,
  ShiftRows, MixColumns (not in the last round) and AddRoundKey over a
  batch of 16-byte states, the first three fused into one gather and one
  table lookup a round;
* CCM (RFC 3610) with M = 4 (the 4-byte MIC), L = 2 and the 13-byte
  nonce: CBC-MAC over B_0, the length-prefixed AAD and the zero-padded
  payload, then CTR with A_i = flags || nonce || i, the MIC encrypted
  with S_0.

The link-layer rules (Core Spec Vol 6 Part E), as in the JAX module:

* session key:  SK = AES-128-ECB_E(LTK, SKD),  SKD = SKDm || SKDs
* per-PDU AES-CCM, MIC 4 bytes, 13-byte nonce =
      packetCounter (39 bits, little-endian over 5 bytes, with the
      direction bit — 1 = central->peripheral — as the MSB of byte 4)
      || IV  (IVm || IVs, 8 bytes)
* additional authenticated data = the first header octet with the
  NESN/SN/MD bits masked to zero (header & 0xE3)
* the packet counter increments independently per direction, counting
  ENCRYPTED data PDUs only (empty PDUs are not encrypted and do not
  count)

Byte-order conventions: LTK/SKD/IV parameters here are the CONCATENATED
big-endian (display order) values; the LL_ENC_REQ/RSP fields arrive
little-endian on air and `from_enc_exchange` performs the reversal, with
SKD = SKDm || SKDs and IV = IVm || IVs in transmission-order
concatenation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

MIC_LEN = 4


# --------------------------------------------------------------------------
# AES-128 (FIPS-197)
# --------------------------------------------------------------------------


def _gf_mul(a: int, b: int) -> int:
    out = 0
    while b:
        if b & 1:
            out ^= a
        a = ((a << 1) ^ 0x11B) if a & 0x80 else a << 1
        b >>= 1
    return out


def _sbox() -> np.ndarray:
    inv = [0] * 256
    for a in range(1, 256):
        inv[a] = next(b for b in range(1, 256) if _gf_mul(a, b) == 1)
    box = np.zeros(256, np.uint8)
    for a in range(256):
        x = inv[a]
        s = x
        for k in range(1, 5):
            s ^= ((x << k) | (x >> (8 - k))) & 0xFF
        box[a] = s ^ 0x63
    return box


SBOX = _sbox()
# ShiftRows on the column-major state (byte r + 4c is row r, column c)
_SHIFT_ROWS = np.array([r + 4 * ((c + r) % 4) for c in range(4) for r in range(4)])
_RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)
# SubBytes, ShiftRows and MixColumns as one gather and one table lookup:
# output byte (r, c) = XOR over k of _ROUND_TAB[k][state[_ROUND_IDX[r + 4c, k]]],
# with _ROUND_TAB[k] = (2, 3, 1, 1)[k] * SBOX in GF(2^8) and the input byte
# the one ShiftRows moves to (r + k mod 4, c)
_ROUND_IDX = np.array([[_SHIFT_ROWS[(r + k) % 4 + 4 * c] for k in range(4)]
                       for c in range(4) for r in range(4)])
_ROUND_TAB = np.array([[_gf_mul(int(SBOX[x]), m) for x in range(256)]
                       for m in (2, 3, 1, 1)], np.uint8).reshape(-1)
_LANE = np.arange(4) * 256                # row k of _ROUND_TAB, flattened


@lru_cache(maxsize=64)
def _key_schedule(key: bytes) -> np.ndarray:
    """The 11 round keys of an AES-128 key: (11, 16) uint8 (cached: a
    session decrypts every PDU under one key)."""
    if len(key) != 16:
        raise ValueError("AES-128 needs a 16-byte key")
    w = [list(key[4 * k:4 * k + 4]) for k in range(4)]
    for k in range(4, 44):
        t = list(w[k - 1])
        if k % 4 == 0:
            t = [int(SBOX[b]) for b in t[1:] + t[:1]]
            t[0] ^= _RCON[k // 4 - 1]
        w.append([a ^ b for a, b in zip(w[k - 4], t)])
    keys = np.array(w, np.uint8).reshape(11, 16)
    keys.flags.writeable = False             # shared by every caller of the cache
    return keys


def _encrypt_blocks(round_keys: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """AES-128 of (n, 16) uint8 blocks under the schedule's round keys:
    rounds 1-9 SubBytes + ShiftRows + MixColumns (the fused lookup) then
    AddRoundKey; round 10 without MixColumns."""
    s = blocks ^ round_keys[0]
    for r in range(1, 10):
        terms = _ROUND_TAB.take(s[:, _ROUND_IDX] + _LANE)     # (n, 16, 4)
        s = np.bitwise_xor.reduce(terms, axis=-1) ^ round_keys[r]
    return SBOX[s[:, _SHIFT_ROWS]] ^ round_keys[10]


def aes_e(key: bytes, plaintext: bytes) -> bytes:
    """The spec's security function e: AES-128-ECB encryption of one (or
    several) 16-byte blocks."""
    data = np.frombuffer(bytes(plaintext), np.uint8)
    if data.size % 16:
        raise ValueError("AES-ECB input must be a multiple of 16 bytes")
    return _encrypt_blocks(_key_schedule(bytes(key)), data.reshape(-1, 16)).tobytes()


def session_key(ltk: bytes, skd: bytes) -> bytes:
    """SK = e(LTK, SKD); both 16 bytes, display (big-endian) order."""
    if len(ltk) != 16 or len(skd) != 16:
        raise ValueError("LTK and SKD must be 16 bytes")
    return aes_e(ltk, skd)


# --------------------------------------------------------------------------
# CCM (RFC 3610), M = 4, L = 2, 13-byte nonce
# --------------------------------------------------------------------------


def _ccm_mac(round_keys: np.ndarray, nonce: bytes, payload: bytes, aad: bytes,
             mic_len: int) -> np.ndarray:
    """The unencrypted tag T: CBC-MAC over B_0, the AAD blocks and the
    payload blocks."""
    b0 = bytes([0x40 * bool(aad) | 8 * ((mic_len - 2) // 2) | 1]) + nonce \
        + len(payload).to_bytes(2, "big")
    head = (len(aad).to_bytes(2, "big") + aad) if aad else b""
    stream = b0 + head + bytes(-len(head) % 16) + payload + bytes(-len(payload) % 16)
    x = np.zeros((1, 16), np.uint8)
    for b in np.frombuffer(stream, np.uint8).reshape(-1, 16):
        x = _encrypt_blocks(round_keys, x ^ b)
    return x[0, :mic_len]


def _ccm_keystream(round_keys: np.ndarray, nonce: bytes, n: int) -> np.ndarray:
    """S_0 .. S_(ceil(n/16)), flattened: S_0 masks the tag, the rest the
    payload."""
    counters = np.zeros((1 + -(-n // 16), 16), np.uint8)
    counters[:, 0] = 1                           # flags = L - 1
    counters[:, 1:14] = np.frombuffer(nonce, np.uint8)
    idx = np.arange(len(counters))
    counters[:, 14], counters[:, 15] = idx >> 8, idx & 0xFF
    return _encrypt_blocks(round_keys, counters).reshape(-1)


def _check_ccm(nonce: bytes, mic_len: int) -> None:
    if len(nonce) != 13:
        raise ValueError("the CCM nonce must be 13 bytes")
    if mic_len not in (4, 6, 8, 10, 12, 14, 16):
        raise ValueError("the CCM MIC is 4, 6, ..., 16 bytes")


def ccm_encrypt(key: bytes, nonce: bytes, payload: bytes, aad: bytes,
                mic_len: int = MIC_LEN) -> bytes:
    """payload -> ciphertext || MIC (AES-CCM with L = 2 and a 13-byte
    nonce; the link layer's MIC is 4 bytes, RFC 3610's vectors use 8 and
    10)."""
    _check_ccm(nonce, mic_len)
    rk = _key_schedule(bytes(key))
    p = np.frombuffer(bytes(payload), np.uint8)
    s = _ccm_keystream(rk, nonce, p.size)
    tag = _ccm_mac(rk, nonce, bytes(payload), bytes(aad), mic_len)
    return (p ^ s[16:16 + p.size]).tobytes() + (tag ^ s[:mic_len]).tobytes()


def ccm_decrypt(key: bytes, nonce: bytes, data: bytes, aad: bytes,
                mic_len: int = MIC_LEN) -> bytes | None:
    """ciphertext || MIC -> payload, or None when the MIC does not
    authenticate."""
    _check_ccm(nonce, mic_len)
    if len(data) < mic_len:
        return None
    rk = _key_schedule(bytes(key))
    c = np.frombuffer(bytes(data), np.uint8)
    n = c.size - mic_len
    s = _ccm_keystream(rk, nonce, n)
    plain = (c[:n] ^ s[16:16 + n]).tobytes()
    tag = _ccm_mac(rk, nonce, plain, bytes(aad), mic_len)
    return plain if np.array_equal(tag ^ s[:mic_len], c[n:]) else None


# --------------------------------------------------------------------------
# the link layer's use of them
# --------------------------------------------------------------------------


def _nonce(counter: int, direction: int, iv: bytes) -> bytes:
    if len(iv) != 8:
        raise ValueError("IV must be 8 bytes")
    if counter >= 1 << 39:
        raise ValueError("packet counter exceeds 39 bits")
    ctr = bytearray(counter.to_bytes(5, "little"))
    ctr[4] |= (direction & 1) << 7
    return bytes(ctr) + bytes(iv)


def _aad(header_byte: int) -> bytes:
    # NESN (bit 2), SN (bit 3), MD (bit 4) are masked from the
    # authenticated first octet (they may be retransmission-modified)
    return bytes([header_byte & 0xE3])


@dataclass
class LlSession:
    """One encrypted LL connection's receive-side crypto state.

    Tracks an independent 39-bit packet counter per direction; decrypt
    tries a small counter window so a missed (not captured) PDU does
    not desynchronize the sniffer — the MIC arbitrates.
    """

    sk: bytes
    iv: bytes
    counters: dict = field(default_factory=lambda: {0: 0, 1: 0})
    resync_window: int = 8

    @classmethod
    def from_enc_exchange(cls, ltk: bytes, skd_m: bytes, skd_s: bytes,
                          iv_m: bytes, iv_s: bytes) -> "LlSession":
        """Keys from the sniffed LL_ENC_REQ (SKDm, IVm) + LL_ENC_RSP
        (SKDs, IVs) fields, each given in on-air little-endian byte
        order as parsed; SKD/IV concatenate per the spec and are
        converted to the display-order convention internally."""
        skd = (bytes(skd_m) + bytes(skd_s))[::-1]
        iv = (bytes(iv_m) + bytes(iv_s))[::-1]
        return cls(sk=session_key(ltk, skd), iv=iv)

    @classmethod
    def from_parsed_exchange(cls, ltk: bytes, enc_req_fields: dict,
                             enc_rsp_fields: dict) -> "LlSession":
        """Directly from parse_ll_payload's ctrl.fields (which present
        skdm/ivm/skds/ivs in DISPLAY order): SKDm/IVm are the least-
        significant halves, so display-order SKD = SKDs || SKDm and
        IV = IVs || IVm."""
        skd = bytes(enc_rsp_fields["skds"]) + bytes(enc_req_fields["skdm"])
        iv = bytes(enc_rsp_fields["ivs"]) + bytes(enc_req_fields["ivm"])
        return cls(sk=session_key(bytes(ltk), skd), iv=iv)

    # ---------------- encrypt (TX-side / scene synthesis) -------------
    def encrypt(self, header_byte: int, payload: bytes,
                direction: int) -> bytes:
        """payload -> ciphertext||MIC; advances the direction counter."""
        n = _nonce(self.counters[direction], direction, self.iv)
        out = ccm_encrypt(self.sk, n, bytes(payload), _aad(header_byte))
        self.counters[direction] += 1
        return out

    # ---------------- decrypt (sniffer side) --------------------------
    def decrypt(self, header_byte: int, payload_mic: bytes,
                direction: int) -> bytes | None:
        """ciphertext||MIC -> payload, or None if no counter in the
        resync window authenticates. On success the counter jumps past
        the one that worked (tolerates un-captured PDUs)."""
        if len(payload_mic) < MIC_LEN + 1:
            return None
        base = self.counters[direction]
        for delta in range(self.resync_window):
            n = _nonce(base + delta, direction, self.iv)
            plain = ccm_decrypt(self.sk, n, bytes(payload_mic), _aad(header_byte))
            if plain is None:
                continue
            self.counters[direction] = base + delta + 1
            return plain
        return None


class SniffDecryptor:
    """Passive per-connection decryption for a sniffer stream.

    Feed every decoded packet (WidebandPacket-shaped: access_addr,
    header/payload attached by the sniffer's parse). The decryptor
    watches each connection's LL_ENC_REQ/LL_ENC_RSP fly by, derives the
    session once both halves are seen, and then opportunistically
    decrypts data PDUs (unknown direction: both are tried — the MIC
    arbitrates; plaintext PDUs simply fail authentication and pass
    through untouched).
    """

    def __init__(self, ltk: bytes):
        self.ltk = bytes(ltk)
        self._enc_req: dict[int, dict] = {}
        self.sessions: dict[int, LlSession] = {}
        self.decrypted = 0

    def observe_ctrl(self, aa: int, opcode: int, fields: dict) -> None:
        """Feed a decoded LL ctrl PDU (keys sessions from ENC_REQ/RSP)."""
        from .pdu import LlCtrlOpcode

        if opcode == int(LlCtrlOpcode.LL_ENC_REQ):
            self._enc_req[aa] = fields
        elif (opcode == int(LlCtrlOpcode.LL_ENC_RSP)
                and aa in self._enc_req):
            self.sessions[aa] = LlSession.from_parsed_exchange(
                self.ltk, self._enc_req[aa], fields)

    def try_decrypt(self, aa: int, header_byte: int,
                    payload_mic: bytes) -> bytes | None:
        """Attempt both directions against aa's session (if keyed)."""
        sess = self.sessions.get(aa)
        if sess is None or len(payload_mic) < MIC_LEN + 1:
            return None
        for direction in (0, 1):
            plain = sess.decrypt(header_byte, payload_mic, direction)
            if plain is not None:
                self.decrypted += 1
                return plain
        return None

    def on_packet(self, pkt) -> bytes | None:
        """Sniffer-packet convenience (WidebandPacket-shaped): returns
        the decrypted payload when authentication succeeds."""
        aa = getattr(pkt, "access_addr", None)
        if aa is None or not getattr(pkt, "crc_ok", False):
            return None
        ctrl = getattr(getattr(pkt, "payload", None), "ctrl", None)
        if ctrl is not None:
            self.observe_ctrl(aa, ctrl.opcode, ctrl.fields)
            return None
        raw = bytes(pkt.pdu_bytes)
        if len(raw) < 2:
            return None
        return self.try_decrypt(aa, raw[0], raw[2:])
