"""L2CAP reassembly + ATT/GATT parsing over sniffed data PDUs.

Beyond-reference: the C stack stops at LL PDU octets and its app layer
at advertising AD structures — connection CONTENT is opaque. With the
LL layer decoded (and decrypted where `wideband --ltk` applies), the
next layers up are mechanical:

* LL fragmentation: LLID=2 starts (or wholly contains) an L2CAP PDU,
  LLID=1 continues it — ``L2capReassembler`` tracks one partial SDU per
  (connection, direction-less) stream and emits complete
  ``L2capFrame``s (Core Vol 6 Part B 2.4; Vol 3 Part A 3.1: 2-byte
  little-endian length + 2-byte channel ID).
* ATT: opcode table + field parse for the common operations (reads,
  writes, notifications/indications, MTU exchange, discovery) — the
  GATT wire protocol (Vol 3 Part F 3.3/3.4).
* well-known CIDs: 0x0004 ATT, 0x0005 LE L2CAP signaling, 0x0006 SMP.
"""

from __future__ import annotations

from dataclasses import dataclass, field

CID_ATT = 0x0004
CID_LE_SIGNALING = 0x0005
CID_SMP = 0x0006

CID_NAMES = {CID_ATT: "ATT", CID_LE_SIGNALING: "LE-signaling",
             CID_SMP: "SMP"}

ATT_OPCODES = {
    0x01: "ATT_ERROR_RSP",
    0x02: "ATT_EXCHANGE_MTU_REQ",
    0x03: "ATT_EXCHANGE_MTU_RSP",
    0x04: "ATT_FIND_INFORMATION_REQ",
    0x05: "ATT_FIND_INFORMATION_RSP",
    0x06: "ATT_FIND_BY_TYPE_VALUE_REQ",
    0x07: "ATT_FIND_BY_TYPE_VALUE_RSP",
    0x08: "ATT_READ_BY_TYPE_REQ",
    0x09: "ATT_READ_BY_TYPE_RSP",
    0x0A: "ATT_READ_REQ",
    0x0B: "ATT_READ_RSP",
    0x0C: "ATT_READ_BLOB_REQ",
    0x0D: "ATT_READ_BLOB_RSP",
    0x0E: "ATT_READ_MULTIPLE_REQ",
    0x0F: "ATT_READ_MULTIPLE_RSP",
    0x10: "ATT_READ_BY_GROUP_TYPE_REQ",
    0x11: "ATT_READ_BY_GROUP_TYPE_RSP",
    0x12: "ATT_WRITE_REQ",
    0x13: "ATT_WRITE_RSP",
    0x16: "ATT_PREPARE_WRITE_REQ",
    0x17: "ATT_PREPARE_WRITE_RSP",
    0x18: "ATT_EXECUTE_WRITE_REQ",
    0x19: "ATT_EXECUTE_WRITE_RSP",
    0x1B: "ATT_HANDLE_VALUE_NTF",
    0x1D: "ATT_HANDLE_VALUE_IND",
    0x1E: "ATT_HANDLE_VALUE_CFM",
    0x52: "ATT_WRITE_CMD",
    0xD2: "ATT_SIGNED_WRITE_CMD",
}

SMP_OPCODES = {
    0x01: "SMP_PAIRING_REQ", 0x02: "SMP_PAIRING_RSP",
    0x03: "SMP_PAIRING_CONFIRM", 0x04: "SMP_PAIRING_RANDOM",
    0x05: "SMP_PAIRING_FAILED", 0x06: "SMP_ENCRYPTION_INFORMATION",
    0x07: "SMP_CENTRAL_IDENTIFICATION", 0x08: "SMP_IDENTITY_INFORMATION",
    0x09: "SMP_IDENTITY_ADDRESS_INFORMATION", 0x0A: "SMP_SIGNING_INFORMATION",
    0x0B: "SMP_SECURITY_REQUEST",
}


@dataclass
class L2capFrame:
    cid: int
    payload: bytes

    @property
    def cid_name(self) -> str:
        return CID_NAMES.get(self.cid, f"CID-{self.cid:#06x}")


@dataclass
class AttOp:
    opcode: int
    name: str
    handle: int | None = None
    value: bytes = b""
    mtu: int | None = None
    error: tuple | None = None       # (req_opcode, handle, code)


def parse_att(payload: bytes) -> AttOp | None:
    """One complete ATT PDU -> AttOp (None for an empty payload)."""
    p = bytes(payload)
    if not p:
        return None
    op = p[0]
    out = AttOp(op, ATT_OPCODES.get(op, f"ATT_OP_{op:#04x}"))
    body = p[1:]
    if op in (0x0A, 0x0C, 0x12, 0x16, 0x1B, 0x1D, 0x52, 0xD2) \
            and len(body) >= 2:
        out.handle = int.from_bytes(body[0:2], "little")
        out.value = body[2:] if op != 0x0A else b""
        if op == 0x0C and len(body) >= 4:       # READ_BLOB: handle+offset
            out.value = body[4:]
    elif op in (0x0B, 0x0D):
        out.value = body
    elif op in (0x02, 0x03) and len(body) >= 2:
        out.mtu = int.from_bytes(body[0:2], "little")
    elif op == 0x01 and len(body) >= 4:
        out.error = (body[0], int.from_bytes(body[1:3], "little"), body[3])
    else:
        out.value = body
    return out


@dataclass
class L2capReassembler:
    """Per-stream LL fragment -> L2CAP frame reassembly.

    Feed (llid, payload) of each CRC-OK data PDU in stream order;
    complete frames are returned (possibly none for a continuation
    fragment). A fresh LLID=2 start discards any stale partial SDU
    (the missed-packet case — counted, never fatal).
    """

    _buf: bytearray = field(default_factory=bytearray)
    _need: int | None = None
    discarded: int = 0

    def feed(self, llid: int, payload: bytes) -> list[L2capFrame]:
        payload = bytes(payload)
        if llid == 2:                            # start fragment
            if self._need is not None:
                self.discarded += 1
            self._buf = bytearray(payload)
            self._need = None
        elif llid == 1:                          # continuation
            if not payload:
                return []                        # empty PDU (keep-alive)
            if self._buf or self._need is not None:
                self._buf.extend(payload)
            else:
                self.discarded += 1              # continuation w/o start
                return []
        else:
            return []
        out = []
        while True:
            if len(self._buf) < 4:
                break
            length = int.from_bytes(self._buf[0:2], "little")
            if len(self._buf) < 4 + length:
                self._need = 4 + length          # waiting for more
                break
            frame = L2capFrame(int.from_bytes(self._buf[2:4], "little"),
                               bytes(self._buf[4 : 4 + length]))
            out.append(frame)
            del self._buf[: 4 + length]
            self._need = None
        return out


def att_stream(data_pdus) -> list[AttOp]:
    """Convenience: (llid, payload) iterable -> parsed ATT operations."""
    rs = L2capReassembler()
    ops = []
    for llid, payload in data_pdus:
        for frame in rs.feed(llid, payload):
            if frame.cid == CID_ATT:
                op = parse_att(frame.payload)
                if op is not None:
                    ops.append(op)
    return ops
