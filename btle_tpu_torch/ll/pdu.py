"""Link-layer PDU codecs: ADV and data-channel (LL) PDU parsing/building.

Typed Python equivalents of the reference's parser structs and routines:
  * ADV header/payloads — parse_adv_pdu_header_byte (btle_rx.c:1947-1963),
    parse_adv_pdu_payload_byte (btle_rx.c:1564-1712)
  * LL header/payloads — parse_ll_pdu_header_byte (btle_rx.c:1939-1945),
    parse_ll_pdu_payload_byte (btle_rx.c:1741-1937)

Multi-byte fields arrive LSByte-first on air; parsed values and addresses
are presented in display order exactly as the reference presents them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np


class AdvPduType(IntEnum):
    ADV_IND = 0
    ADV_DIRECT_IND = 1
    ADV_NONCONN_IND = 2
    SCAN_REQ = 3
    SCAN_RSP = 4
    CONNECT_REQ = 5
    ADV_SCAN_IND = 6
    # BLE 5 extended advertising (Core Vol 6 Part B 2.3.4): type 7 is
    # ADV_EXT_IND on a primary channel and AUX_ADV_IND / AUX_SYNC_IND /
    # AUX_CHAIN_IND etc. on secondary channels — one wire value, the
    # Common Extended Advertising Payload format either way. The
    # reference parses only legacy types 0-6.
    ADV_EXT_IND = 7
    RESERVED1 = 8
    RESERVED2 = 9
    RESERVED3 = 10
    RESERVED4 = 11
    RESERVED5 = 12
    RESERVED6 = 13
    RESERVED7 = 14
    RESERVED8 = 15

    @property
    def display_name(self) -> str:
        return self.name


class LlPduType(IntEnum):
    LL_RESERVED = 0
    LL_DATA1 = 1
    LL_DATA2 = 2
    LL_CTRL = 3

    @property
    def display_name(self) -> str:
        return self.name


class LlCtrlOpcode(IntEnum):
    LL_CONNECTION_UPDATE_REQ = 0x00
    LL_CHANNEL_MAP_REQ = 0x01
    LL_TERMINATE_IND = 0x02
    LL_ENC_REQ = 0x03
    LL_ENC_RSP = 0x04
    LL_START_ENC_REQ = 0x05
    LL_START_ENC_RSP = 0x06
    LL_UNKNOWN_RSP = 0x07
    LL_FEATURE_REQ = 0x08
    LL_FEATURE_RSP = 0x09
    LL_PAUSE_ENC_REQ = 0x0A
    LL_PAUSE_ENC_RSP = 0x0B
    LL_VERSION_IND = 0x0C
    LL_REJECT_IND = 0x0D


@dataclass
class AdvHeader:
    pdu_type: AdvPduType
    tx_add: int
    rx_add: int
    payload_len: int


def parse_adv_header(header_bytes) -> AdvHeader:
    b = _as_bytes(header_bytes)
    return AdvHeader(
        AdvPduType(int(b[0]) & 0x0F),
        int((int(b[0]) & 0x40) != 0),
        int((int(b[0]) & 0x80) != 0),
        int(b[1]) & 0x3F,
    )


@dataclass
class LlHeader:
    llid: LlPduType
    nesn: int
    sn: int
    md: int
    payload_len: int


def parse_ll_header(header_bytes) -> LlHeader:
    b = _as_bytes(header_bytes)
    h = int(b[0])
    return LlHeader(LlPduType(h & 0x03), (h >> 2) & 1, (h >> 3) & 1, (h >> 4) & 1, int(b[1]) & 0x1F)


def _as_bytes(x) -> bytes:
    if isinstance(x, (bytes, bytearray, memoryview)):
        return bytes(x)
    return bytes(bytearray(np.asarray(x, dtype=np.uint8)))


def _rev(b) -> bytes:
    return bytes(bytearray(b))[::-1]


@dataclass
class ExtAdvFields:
    """Common Extended Advertising Payload (Core Vol 6 Part B 2.3.4):
    [ExtHdrLen(6b) | AdvMode(2b)] [Flags(1)] [fields in flag order]
    [AdvData]. Field order when present: AdvA(6) TargetA(6) CTEInfo(1)
    ADI(2) AuxPtr(3) SyncInfo(18) TxPower(1) — beyond-reference (the C
    tool stops at legacy type 6, so every BLE 5 extended/coded
    advertiser is invisible to it)."""

    adv_mode: int = 0                # 0 non-conn/scan, 1 conn, 2 scan
    adv_a: bytes | None = None       # display order
    target_a: bytes | None = None
    cte_info: int | None = None
    adi_did: int | None = None       # 12-bit Advertising Data ID
    adi_sid: int | None = None       # 4-bit Advertising Set ID
    aux_chan: int | None = None      # AuxPtr: channel index
    aux_ca: int | None = None        #         clock accuracy bit
    aux_offset_us: int | None = None #         offset in microseconds
    aux_phy: int | None = None       #         0=1M 1=2M 2=coded
    sync_info: bytes | None = None   # 18 raw bytes (periodic adv)
    tx_power: int | None = None      # signed dBm


@dataclass
class AdvPayload:
    """Parsed ADV payload; populated fields depend on pdu_type."""

    adv_a: bytes | None = None       # display order (MSB first)
    init_a: bytes | None = None
    scan_a: bytes | None = None
    data: bytes = b""                # AdvData / ScanRspData / raw
    # CONNECT_REQ extras
    aa: int | None = None
    crc_init: int | None = None
    win_size: int | None = None
    win_offset: int | None = None
    interval: int | None = None
    latency: int | None = None
    timeout: int | None = None
    chm: bytes | None = None         # 5 bytes display order (0x1F first)
    hop: int | None = None
    sca: int | None = None
    # ADV_EXT_IND / AUX_* extras (BLE 5 extended advertising)
    ext: "ExtAdvFields | None" = None


def parse_adv_payload(payload, pdu_type: AdvPduType) -> AdvPayload:
    """Port of parse_adv_pdu_payload_byte (btle_rx.c:1564-1712).

    Raises ValueError on the same length conditions the reference rejects.
    """
    p = _as_bytes(payload)
    n = len(p)
    t = AdvPduType(pdu_type)
    # legacy PDUs start with a 6-byte MAC; extended payloads can be as
    # short as the 1-byte [len|AdvMode] header
    if n < 6 and t != AdvPduType.ADV_EXT_IND:
        raise ValueError(f"ADV payload too short ({n} bytes)")
    if n < 1:
        raise ValueError("ADV payload empty")
    out = AdvPayload()
    if t in (AdvPduType.ADV_IND, AdvPduType.ADV_NONCONN_IND, AdvPduType.SCAN_RSP, AdvPduType.ADV_SCAN_IND):
        out.adv_a = _rev(p[0:6])
        out.data = p[6:]
    elif t in (AdvPduType.ADV_DIRECT_IND, AdvPduType.SCAN_REQ):
        if n != 12:
            raise ValueError(f"payload length {n} != 12 for {t.display_name}")
        if t == AdvPduType.ADV_DIRECT_IND:
            out.adv_a = _rev(p[0:6])
            out.init_a = _rev(p[6:12])
        else:
            out.scan_a = _rev(p[0:6])
            out.adv_a = _rev(p[6:12])
    elif t == AdvPduType.CONNECT_REQ:
        if n != 34:
            raise ValueError(f"payload length {n} != 34 for CONNECT_REQ")
        out.init_a = _rev(p[0:6])
        out.adv_a = _rev(p[6:12])
        out.aa = int.from_bytes(p[12:16], "little")
        out.crc_init = (p[16] << 16) | (p[17] << 8) | p[18]
        out.win_size = p[19]
        out.win_offset = int.from_bytes(p[20:22], "little")
        out.interval = int.from_bytes(p[22:24], "little")
        out.latency = int.from_bytes(p[24:26], "little")
        out.timeout = int.from_bytes(p[26:28], "little")
        out.chm = _rev(p[28:33])
        out.hop = p[33] & 0x1F
        out.sca = (p[33] >> 5) & 0x07
    elif t == AdvPduType.ADV_EXT_IND:
        out.ext = parse_ext_adv_payload(p)
        out.adv_a = out.ext.adv_a
        out.data = p[1 + (p[0] & 0x3F):]         # AdvData after ext header
    else:
        out.data = p
    return out


def parse_ext_adv_payload(p: bytes) -> ExtAdvFields:
    """Common Extended Advertising Payload parser (Core 2.3.4.x)."""
    if len(p) < 1:
        raise ValueError("extended ADV payload empty")
    hdr_len = p[0] & 0x3F
    out = ExtAdvFields(adv_mode=(p[0] >> 6) & 0x3)
    if 1 + hdr_len > len(p):
        raise ValueError(f"extended header length {hdr_len} exceeds "
                         f"payload ({len(p)} bytes)")
    hdr = p[1 : 1 + hdr_len]
    off = 0
    flags = 0
    if hdr_len:
        flags = hdr[0]
        off = 1

    def take(n, what):
        nonlocal off
        if off + n > len(hdr):
            raise ValueError(f"extended header truncated in {what}")
        v = hdr[off : off + n]
        off += n
        return v

    if flags & 0x01:
        out.adv_a = _rev(take(6, "AdvA"))
    if flags & 0x02:
        out.target_a = _rev(take(6, "TargetA"))
    if flags & 0x04:
        out.cte_info = take(1, "CTEInfo")[0]
    if flags & 0x08:
        adi = int.from_bytes(take(2, "ADI"), "little")
        out.adi_did = adi & 0x0FFF
        out.adi_sid = (adi >> 12) & 0xF
    if flags & 0x10:
        aux = int.from_bytes(take(3, "AuxPtr"), "little")
        out.aux_chan = aux & 0x3F
        out.aux_ca = (aux >> 6) & 1
        units = 300 if (aux >> 7) & 1 else 30
        out.aux_offset_us = ((aux >> 8) & 0x1FFF) * units
        out.aux_phy = (aux >> 21) & 0x7
    if flags & 0x20:
        out.sync_info = bytes(take(18, "SyncInfo"))
    if flags & 0x40:
        tp = take(1, "TxPower")[0]
        out.tx_power = tp - 256 if tp >= 128 else tp
    return out


@dataclass
class SyncInfo:
    """Parsed SyncInfo field (periodic advertising, Core Vol 6 Part B
    2.3.4.6): where/when/how the periodic train transmits. The wideband
    sniffer needs no retune to observe it — the AA and CRC init here
    are the keys a follower would load."""

    sync_offset_us: int              # to the first AUX_SYNC_IND
    offset_adjust: bool
    interval_us: int                 # periodic interval (1.25 ms units)
    chm: bytes                       # 5 bytes, display order (0x1F first)
    sca: int
    access_addr: int
    crc_init: int                    # display-order value
    event_counter: int


def build_sync_info(sync_offset_us: int, interval_us: int, chm: bytes,
                    sca: int, access_addr: int, crc_init: int,
                    event_counter: int) -> bytes:
    """Inverse of parse_sync_info (18 bytes; display-order chm/crc)."""
    units_flag = 1 if sync_offset_us >= 30 * 0x1FFF else 0
    off = sync_offset_us // (300 if units_flag else 30)
    w = (off & 0x1FFF) | (units_flag << 13)
    chm_air = bytes(chm)[::-1]
    b8 = (chm_air[4] & 0x1F) | ((sca & 0x7) << 5)
    return (w.to_bytes(2, "little")
            + (interval_us // 1250).to_bytes(2, "little")
            + chm_air[:4] + bytes([b8])
            + (access_addr & 0xFFFFFFFF).to_bytes(4, "little")
            + bytes([(crc_init >> 16) & 0xFF, (crc_init >> 8) & 0xFF,
                     crc_init & 0xFF])
            + (event_counter & 0xFFFF).to_bytes(2, "little"))


def parse_sync_info(raw: bytes) -> SyncInfo:
    """18-byte SyncInfo -> fields (layout per Core 2.3.4.6:
    offset(13)|units(1)|adjust(1)|rfu(1), interval(16), chM(37)+sca(3),
    AA(4 LE), CRCInit(3), eventCounter(2 LE))."""
    raw = bytes(raw)
    if len(raw) != 18:
        raise ValueError(f"SyncInfo must be 18 bytes, got {len(raw)}")
    w = int.from_bytes(raw[0:2], "little")
    units = 300 if (w >> 13) & 1 else 30
    out = SyncInfo(
        sync_offset_us=(w & 0x1FFF) * units,
        offset_adjust=bool((w >> 14) & 1),
        interval_us=int.from_bytes(raw[2:4], "little") * 1250,
        chm=_rev(bytes(raw[4:9]) [:4] + bytes([raw[8] & 0x1F])),
        sca=(raw[8] >> 5) & 0x7,
        access_addr=int.from_bytes(raw[9:13], "little"),
        crc_init=(raw[13] << 16) | (raw[14] << 8) | raw[15],
        event_counter=int.from_bytes(raw[16:18], "little"),
    )
    return out


def build_ext_adv_payload(adv_mode: int = 0, adv_a: bytes | None = None,
                          target_a: bytes | None = None,
                          adi: tuple[int, int] | None = None,
                          aux_ptr: tuple[int, int, int, int] | None = None,
                          sync_info: bytes | None = None,
                          tx_power: int | None = None,
                          adv_data: bytes = b"") -> bytes:
    """Inverse of parse_ext_adv_payload (TX side; display-order MACs).

    adi = (did, sid); aux_ptr = (chan, ca, offset_us, phy);
    sync_info = 18 raw bytes (build with build_sync_info).
    """
    hdr = bytearray()
    flags = 0
    if adv_a is not None:
        flags |= 0x01
        hdr += bytes(adv_a)[::-1]
    if target_a is not None:
        flags |= 0x02
        hdr += bytes(target_a)[::-1]
    if adi is not None:
        flags |= 0x08
        did, sid = adi
        hdr += ((did & 0x0FFF) | ((sid & 0xF) << 12)).to_bytes(2, "little")
    if aux_ptr is not None:
        flags |= 0x10
        chan, ca, offset_us, phy = aux_ptr
        units_flag = 1 if offset_us >= 30 * 0x1FFF else 0
        off = offset_us // (300 if units_flag else 30)
        aux = ((chan & 0x3F) | ((ca & 1) << 6) | (units_flag << 7)
               | ((off & 0x1FFF) << 8) | ((phy & 0x7) << 21))
        hdr += aux.to_bytes(3, "little")
    if sync_info is not None:
        if len(sync_info) != 18:
            raise ValueError("SyncInfo must be 18 bytes")
        flags |= 0x20
        hdr += bytes(sync_info)
    if tx_power is not None:
        flags |= 0x40
        hdr += bytes([tx_power & 0xFF])
    body = (bytes([flags]) + bytes(hdr)) if (flags or hdr) else b""
    hdr_len = len(body)
    if hdr_len > 63:
        raise ValueError("extended header exceeds 63 bytes")
    return bytes([(hdr_len & 0x3F) | ((adv_mode & 0x3) << 6)]) \
        + body + bytes(adv_data)


def extract_adv_a(payload: AdvPayload, pdu_type: AdvPduType) -> bytes | None:
    """Advertiser address used for filtering (extract_adv_a, btle_rx.c:1714-1739).

    For ADV_DIRECT_IND/SCAN_REQ the reference filters on the FIRST address
    field (A0 = AdvA for ADV_DIRECT_IND, ScanA for SCAN_REQ)."""
    t = AdvPduType(pdu_type)
    if t == AdvPduType.SCAN_REQ:
        return payload.scan_a
    return payload.adv_a


@dataclass
class LlCtrlPayload:
    opcode: int
    fields: dict = field(default_factory=dict)


@dataclass
class LlPayload:
    data: bytes = b""
    ctrl: LlCtrlPayload | None = None


_CTRL_EXPECTED_LEN = {
    LlCtrlOpcode.LL_CONNECTION_UPDATE_REQ: 12,
    LlCtrlOpcode.LL_CHANNEL_MAP_REQ: 8,
    LlCtrlOpcode.LL_TERMINATE_IND: 2,
    LlCtrlOpcode.LL_ENC_REQ: 23,
    LlCtrlOpcode.LL_ENC_RSP: 13,
    LlCtrlOpcode.LL_START_ENC_REQ: 1,
    LlCtrlOpcode.LL_START_ENC_RSP: 1,
    LlCtrlOpcode.LL_UNKNOWN_RSP: 2,
    LlCtrlOpcode.LL_FEATURE_REQ: 9,
    LlCtrlOpcode.LL_FEATURE_RSP: 9,
    LlCtrlOpcode.LL_PAUSE_ENC_REQ: 1,
    LlCtrlOpcode.LL_PAUSE_ENC_RSP: 1,
    LlCtrlOpcode.LL_VERSION_IND: 6,
    LlCtrlOpcode.LL_REJECT_IND: 2,
}


def parse_ll_payload(payload, llid: LlPduType) -> LlPayload:
    """Port of parse_ll_pdu_payload_byte (btle_rx.c:1741-1937)."""
    p = _as_bytes(payload)
    n = len(p)
    t = LlPduType(llid)
    if n == 0:
        if t in (LlPduType.LL_DATA2, LlPduType.LL_CTRL):
            raise ValueError(f"{t.display_name} must not have empty payload")
        return LlPayload()
    if t != LlPduType.LL_CTRL:
        return LlPayload(data=p)

    op = p[0]
    f: dict = {}
    try:
        opcode = LlCtrlOpcode(op)
    except ValueError:
        return LlPayload(ctrl=LlCtrlPayload(op, {"raw": p[1:]}))
    exp = _CTRL_EXPECTED_LEN[opcode]
    if n != exp:
        raise ValueError(f"{opcode.name} payload length {n} != {exp}")
    if opcode == LlCtrlOpcode.LL_CONNECTION_UPDATE_REQ:
        f = {
            "win_size": p[1],
            "win_offset": int.from_bytes(p[2:4], "little"),
            "interval": int.from_bytes(p[4:6], "little"),
            "latency": int.from_bytes(p[6:8], "little"),
            "timeout": int.from_bytes(p[8:10], "little"),
            "instant": int.from_bytes(p[10:12], "little"),
        }
    elif opcode == LlCtrlOpcode.LL_CHANNEL_MAP_REQ:
        f = {"chm": _rev(p[1:6]), "instant": int.from_bytes(p[6:8], "little")}
    elif opcode in (LlCtrlOpcode.LL_TERMINATE_IND, LlCtrlOpcode.LL_UNKNOWN_RSP, LlCtrlOpcode.LL_REJECT_IND):
        f = {"error_code" if opcode != LlCtrlOpcode.LL_UNKNOWN_RSP else "unknown_type": p[1]}
    elif opcode == LlCtrlOpcode.LL_ENC_REQ:
        f = {"rand": _rev(p[1:9]), "ediv": _rev(p[9:11]), "skdm": _rev(p[11:19]), "ivm": _rev(p[19:23])}
    elif opcode == LlCtrlOpcode.LL_ENC_RSP:
        f = {"skds": _rev(p[1:9]), "ivs": _rev(p[9:13])}
    elif opcode in (LlCtrlOpcode.LL_FEATURE_REQ, LlCtrlOpcode.LL_FEATURE_RSP):
        f = {"feature_set": _rev(p[1:9])}
    elif opcode == LlCtrlOpcode.LL_VERSION_IND:
        f = {
            "vers_nr": p[1],
            "comp_id": int.from_bytes(p[2:4], "little"),
            "sub_vers_nr": int.from_bytes(p[4:6], "little"),
        }
    # START/PAUSE_ENC_* carry only the opcode
    return LlPayload(ctrl=LlCtrlPayload(int(opcode), f))
