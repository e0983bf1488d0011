"""The btle_tx packet-descriptor DSL: ``chan-TYPE-Field-Value-...`` lines.

Grammar-compatible parser for all 25 packet types of the reference
transmitter (PKT_TYPE enum btle_tx.c:710-739, field lexers :868-1351,
composers calculate_sample_for_* :1353-3806):

  RAW, DISCOVERY, IBEACON, ADV_IND, ADV_DIRECT_IND, ADV_NONCONN_IND,
  ADV_SCAN_IND, SCAN_REQ, SCAN_RSP, CONNECT_REQ, LL_DATA and the 14
  LL control PDUs.

Field-order conventions follow the reference exactly: multi-octet values
whose descriptor spelling is MSB-first are octet-reversed before hitting
the air (flip=1 lexer), CRCInit/UUID-style fields go through verbatim
(flip=0), SERVICE_DATA flips only its leading 2-octet UUID (part-flip),
and LOCAL_NAME takes ASCII characters. DISCOVERY composes AD structures
with a 31-octet budget; iBeacon injects the fixed 02011A1AFF4C000215
prefix. Each descriptor yields a PacketSpec with the assembled
preamble+AA+PDU info bits, the CRC init, and the inter-packet Space.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from ..spec import bits as B

DEFAULT_SPACE_MS = 200  # btle_tx.c:1352

ADV_PKT_TYPES = {
    "DISCOVERY": 2,       # transmitted as ADV_NONCONN_IND (btle_tx.c:1612)
    "ADV_IND": 0,
    "ADV_DIRECT_IND": 1,
    "ADV_NONCONN_IND": 2,
    "ADV_SCAN_IND": 6,
    "SCAN_REQ": 3,
    "SCAN_RSP": 4,
    "CONNECT_REQ": 5,
    "ADV_EXT_IND": 7,     # BLE 5 extended advertising (beyond-reference)
    "IBEACON": 0,         # uses the ADV_IND header type (btle_tx.c:2210)
}

LL_CTRL_OPCODES = {
    "LL_CONNECTION_UPDATE_REQ": 0x00,
    "LL_CHANNEL_MAP_REQ": 0x01,
    "LL_TERMINATE_IND": 0x02,
    "LL_ENC_REQ": 0x03,
    "LL_ENC_RSP": 0x04,
    "LL_START_ENC_REQ": 0x05,
    "LL_START_ENC_RSP": 0x06,
    "LL_UNKNOWN_RSP": 0x07,
    "LL_FEATURE_REQ": 0x08,
    "LL_FEATURE_RSP": 0x09,
    "LL_PAUSE_ENC_REQ": 0x0A,
    "LL_PAUSE_ENC_RSP": 0x0B,
    "LL_VERSION_IND": 0x0C,
    "LL_REJECT_IND": 0x0D,
}

# AD_TYPE table (btle_tx.c:741-797)
AD_TYPES = {
    "FLAGS": (0x01, "hex"),
    "LOCAL_NAME08": (0x08, "char"),
    "LOCAL_NAME09": (0x09, "char"),
    "TXPOWER": (0x0A, "hex"),
    "SERVICE02": (0x02, "hex_flip"),
    "SERVICE03": (0x03, "hex_flip"),
    "SERVICE04": (0x04, "hex_flip"),
    "SERVICE05": (0x05, "hex_flip"),
    "SERVICE06": (0x06, "hex_flip"),
    "SERVICE07": (0x07, "hex_flip"),
    "SERVICE_SOLI14": (0x14, "hex"),
    "SERVICE_SOLI15": (0x15, "hex"),
    "SERVICE_DATA": (0x16, "hex_part_flip"),
    "MANUF_DATA": (0xFF, "hex"),
    "CONN_INTERVAL": (0x12, "hex"),
}

ALL_PKT_TYPES = (
    ["RAW", "IBEACON", "DISCOVERY", "LL_DATA"]
    + [t for t in ADV_PKT_TYPES if t not in ("DISCOVERY", "IBEACON")]
    + list(LL_CTRL_OPCODES)
)


class DescriptorError(ValueError):
    pass


@dataclass
class PacketSpec:
    """One parsed packet: everything needed to synthesize its IQ burst."""

    channel: int
    pkt_type: str
    info_bits: np.ndarray          # preamble+AA+PDU bits (no CRC/whitening)
    crc_init_hex: str = "555555"
    space_ms: int = DEFAULT_SPACE_MS
    raw_phy_bits: np.ndarray | None = None  # RAW packets: final on-air bits
    fields: dict = field(default_factory=dict)
    phy: str = "1m"                # "1m" | "2m" (LE 2M: 16-bit preamble)

    @property
    def num_info_bits(self) -> int:
        return len(self.info_bits)

    @property
    def pdu_start(self) -> int:
        """Bit index of the PDU = preamble + AA span (40 on 1M, 48 on
        2M's 16-bit preamble); CRC/whitening cover info_bits[pdu_start:]."""
        return 48 if self.phy == "2m" else 40

    def to_2m(self) -> "PacketSpec":
        """The same packet framed for the LE 2M PHY (beyond-reference:
        the C tool is LE-1M only). The 16-symbol preamble is the 1M
        preamble byte's alternation extended, i.e. the byte repeated —
        everything after the preamble is identical."""
        if self.raw_phy_bits is not None and self.phy != "2m":
            # a RAW packet's bits are final on-air bits — there is no
            # preamble to extend; flipping phy alone would shift
            # pdu_start to 48 and mis-slice info_bits consumers. RAW 2M
            # packets must be constructed with phy="2m" and bits that
            # already carry the 16-bit preamble.
            raise ValueError(
                "cannot reframe a raw_phy_bits packet for 2M; construct "
                "it with phy='2m' (bits must include the 16-bit preamble)")
        if self.phy == "2m":
            return self
        return replace(self, phy="2m", info_bits=np.concatenate(
            [self.info_bits[:8], self.info_bits]))

    def phy_bits(self) -> np.ndarray:
        """info bits -> CRC24 -> whiten = final on-air bit stream."""
        if self.raw_phy_bits is not None:
            return self.raw_phy_bits
        from ..spec import crc24 as C
        from ..spec import whitening as W

        at = self.pdu_start
        info = self.info_bits
        crc = C.crc24_bits(info[at:], B.hex_to_bits(self.crc_init_hex))
        whole = np.concatenate([info, crc])
        out = whole.copy()
        out[at:] = W.whiten_bits(whole[at:], self.channel)
        return out


class _Fields:
    """Sequential '-'-separated field cursor (get_next_field semantics)."""

    def __init__(self, parts: list[str]):
        self.parts = parts
        self.idx = 0

    def done(self) -> bool:
        return self.idx >= len(self.parts)

    def next(self) -> str:
        if self.done():
            raise DescriptorError("unexpected end of descriptor")
        v = self.parts[self.idx]
        self.idx += 1
        return v

    def expect_name(self, name: str):
        got = self.next()
        if got.upper() != name.upper():
            raise DescriptorError(f"expected field {name}, got {got}")

    def name_value(self, name: str) -> int:
        self.expect_name(name)
        try:
            return int(self.next(), 10)
        except ValueError as e:
            raise DescriptorError(f"bad integer for {name}") from e

    def name_hex(self, name: str, flip: bool, octet_limit: int) -> bytes:
        self.expect_name(name)
        return self.hex_value(flip, octet_limit)

    def hex_value(self, flip: bool, octet_limit: int) -> bytes:
        s = "".join(c for c in self.next() if c in "0123456789abcdefABCDEF")
        if len(s) % 2:
            raise DescriptorError(f"half octet in hex field: {s}")
        if len(s) > octet_limit * 2:
            raise DescriptorError(f"too many octets (max {octet_limit}): {s}")
        data = bytes.fromhex(s)
        return data[::-1] if flip else data

    def name_chars(self, name: str, octet_limit: int) -> bytes:
        self.expect_name(name)
        s = self.next()
        if len(s) > octet_limit:
            raise DescriptorError(f"too many chars (max {octet_limit}): {s}")
        return s.encode("latin-1")

    def peek(self) -> str | None:
        return None if self.done() else self.parts[self.idx]


def _adv_header_bytes(pdu_type: int, txadd: int, rxadd: int, payload_len: int) -> bytes:
    """fill_adv_pdu_header_byte (btle_tx.c:1604-1650)."""
    return bytes([pdu_type | (txadd << 6) | (rxadd << 7), payload_len & 0x3F])


def _data_header_bytes(llid: int, nesn: int, sn: int, md: int, payload_len: int) -> bytes:
    """fill_data_pdu_header (btle_tx.c:1544-1567)."""
    return bytes([(llid & 3) | (nesn << 2) | (sn << 3) | (md << 4), payload_len & 0x1F])


def _frame(preamble: int, aa_bytes: bytes, pdu_bytes: bytes) -> np.ndarray:
    return B.bytes_to_bits(np.frombuffer(bytes([preamble]) + aa_bytes + pdu_bytes, np.uint8))


ADV_AA = bytes.fromhex("D6BE898E")


def _space(fs: _Fields) -> int:
    if fs.done():
        return DEFAULT_SPACE_MS
    space = fs.name_value("SPACE")
    if space <= 0:
        raise DescriptorError("invalid Space")
    return space


def parse_descriptor(desc: str) -> PacketSpec:
    """Parse one ``chan-TYPE-...`` descriptor into a PacketSpec."""
    parts = desc.strip().split("-")
    if len(parts) < 2:
        raise DescriptorError(f"not a packet descriptor: {desc!r}")
    try:
        channel = int(parts[0], 10)
    except ValueError as e:
        raise DescriptorError(f"bad channel: {parts[0]!r}") from e
    pkt_type = parts[1].upper()
    fs = _Fields(parts[2:])

    if pkt_type == "RAW":
        payload = fs.hex_value(False, 47)
        spec = PacketSpec(channel, pkt_type, np.zeros(0, np.int8))
        spec.raw_phy_bits = B.bytes_to_bits(np.frombuffer(payload, np.uint8))
        spec.space_ms = _space(fs)
        return spec

    if pkt_type in ("DISCOVERY", "ADV_IND", "ADV_NONCONN_IND", "ADV_SCAN_IND",
                    "ADV_DIRECT_IND", "SCAN_REQ", "SCAN_RSP", "CONNECT_REQ",
                    "ADV_EXT_IND"):
        return _parse_adv(channel, pkt_type, fs)
    if pkt_type == "IBEACON":
        return _parse_ibeacon(channel, fs)
    if pkt_type == "LL_DATA" or pkt_type in LL_CTRL_OPCODES:
        return _parse_ll(channel, pkt_type, fs)
    raise DescriptorError(f"unknown packet type {pkt_type}")


def _parse_adv(channel: int, pkt_type: str, fs: _Fields) -> PacketSpec:
    txadd = fs.name_value("TXADD")
    rxadd = fs.name_value("RXADD")
    f: dict = {"txadd": txadd, "rxadd": rxadd}

    if pkt_type in ("ADV_IND", "ADV_NONCONN_IND", "ADV_SCAN_IND"):
        adv_a = fs.name_hex("ADVA", True, 6)
        data = fs.name_hex("ADVDATA", False, 31)
        payload = adv_a + data
        f.update(adv_a=adv_a[::-1].hex(), data=data.hex())
    elif pkt_type == "ADV_DIRECT_IND":
        adv_a = fs.name_hex("ADVA", True, 6)
        init_a = fs.name_hex("INITA", True, 6)
        payload = adv_a + init_a
    elif pkt_type == "SCAN_REQ":
        scan_a = fs.name_hex("SCANA", True, 6)
        adv_a = fs.name_hex("ADVA", True, 6)
        payload = scan_a + adv_a
    elif pkt_type == "SCAN_RSP":
        adv_a = fs.name_hex("ADVA", True, 6)
        data = fs.name_hex("SCANRSPDATA", False, 31)
        payload = adv_a + data
    elif pkt_type == "CONNECT_REQ":
        init_a = fs.name_hex("INITA", True, 6)
        adv_a = fs.name_hex("ADVA", True, 6)
        aa = fs.name_hex("AA", True, 4)
        crcinit = fs.name_hex("CRCINIT", False, 3)
        winsize = fs.name_hex("WINSIZE", True, 1)
        winoffset = fs.name_hex("WINOFFSET", True, 2)
        interval = fs.name_hex("INTERVAL", True, 2)
        latency = fs.name_hex("LATENCY", True, 2)
        timeout = fs.name_hex("TIMEOUT", True, 2)
        chm = fs.name_hex("CHM", True, 5)
        hop = fs.name_value("HOP")
        sca = fs.name_value("SCA")
        payload = (init_a + adv_a + aa + crcinit + winsize + winoffset
                   + interval + latency + timeout + chm
                   + bytes([(hop & 0x1F) | ((sca & 0x7) << 5)]))
    elif pkt_type == "ADV_EXT_IND":
        # BLE 5 extended advertising (Core Vol 6 Part B 2.3.4; the
        # coded PHY's native ADV format) — beyond the reference's 25
        # types. Grammar: -AdvMode-N-AdvA-hex-AdvData-hex[-Space-ms]
        from ..ll.pdu import build_ext_adv_payload

        adv_mode = fs.name_value("ADVMODE")
        adv_a = fs.name_hex("ADVA", True, 6)       # on-air order
        data = fs.name_hex("ADVDATA", False, 31)
        payload = build_ext_adv_payload(
            adv_mode, adv_a=adv_a[::-1], adv_data=data)
        f.update(adv_mode=adv_mode, adv_a=adv_a[::-1].hex(),
                 data=data.hex())
    elif pkt_type == "DISCOVERY":
        adv_a = fs.name_hex("ADVA", True, 6)
        payload = adv_a + _parse_ad_structures(fs)
    else:  # pragma: no cover
        raise DescriptorError(pkt_type)

    hdr = _adv_header_bytes(ADV_PKT_TYPES[pkt_type], txadd, rxadd, len(payload))
    spec = PacketSpec(channel, pkt_type, _frame(0xAA, ADV_AA, hdr + bytes(payload)),
                      fields=f)
    spec.space_ms = _space(fs)
    return spec


def _parse_ad_structures(fs: _Fields) -> bytes:
    """DISCOVERY AdvData assembly (btle_tx.c:2003-2070): a sequence of
    [len, ad_type, data...] structures within a 31-octet budget."""
    out = b""
    room = 31
    while not fs.done():
        name = fs.peek().upper()
        if name == "SPACE":
            break
        if name not in AD_TYPES:
            raise DescriptorError(f"unknown AD type {name}")
        ad_val, kind = AD_TYPES[name]
        fs.next()  # consume name
        room -= 2
        if kind == "char":
            s = fs.next()
            data = s.encode("latin-1")
            if len(data) > room:
                raise DescriptorError(f"AD data too long for {name}")
        else:
            s = "".join(c for c in fs.next() if c in "0123456789abcdefABCDEF")
            if len(s) % 2:
                raise DescriptorError(f"half octet in {name}")
            data = bytes.fromhex(s)
            if len(data) > room:
                raise DescriptorError(f"AD data too long for {name}")
            if kind == "hex_flip":
                data = data[::-1]
            elif kind == "hex_part_flip" and len(data) >= 2:
                data = data[1::-1] + data[2:]
        out += bytes([len(data) + 1, ad_val]) + data
        room -= len(data)
    return out


IBEACON_PREFIX = bytes.fromhex("02011A1AFF4C000215")  # btle_tx.c:2227


def _parse_ibeacon(channel: int, fs: _Fields) -> PacketSpec:
    adv_a = fs.name_hex("ADVA", True, 6)
    uuid = fs.name_hex("UUID", False, 16)
    major = fs.name_hex("MAJOR", False, 2)
    minor = fs.name_hex("MINOR", False, 2)
    txpower = fs.name_hex("TXPOWER", True, 1)
    payload = adv_a + IBEACON_PREFIX + uuid + major + minor + txpower
    hdr = _adv_header_bytes(0, 1, 0, 36)  # fixed header (btle_tx.c:2208-2210)
    spec = PacketSpec(channel, "IBEACON", _frame(0xAA, ADV_AA, hdr + payload))
    spec.space_ms = _space(fs)
    return spec


def _parse_ll(channel: int, pkt_type: str, fs: _Fields) -> PacketSpec:
    aa = fs.name_hex("AA", True, 4)
    llid = fs.name_value("LLID")
    nesn = fs.name_value("NESN")
    sn = fs.name_value("SN")
    md = fs.name_value("MD")

    if pkt_type == "LL_DATA":
        body = fs.name_hex("DATA", False, 31)
    else:
        op = bytes([LL_CTRL_OPCODES[pkt_type]])
        if pkt_type == "LL_CONNECTION_UPDATE_REQ":
            body = op + (fs.name_hex("WINSIZE", False, 1)
                         + fs.name_hex("WINOFFSET", True, 2)
                         + fs.name_hex("INTERVAL", True, 2)
                         + fs.name_hex("LATENCY", True, 2)
                         + fs.name_hex("TIMEOUT", True, 2)
                         + fs.name_hex("INSTANT", True, 2))
        elif pkt_type == "LL_CHANNEL_MAP_REQ":
            body = op + fs.name_hex("CHM", True, 5) + fs.name_hex("INSTANT", True, 2)
        elif pkt_type == "LL_TERMINATE_IND" or pkt_type == "LL_REJECT_IND":
            body = op + fs.name_hex("ERRORCODE", False, 1)
        elif pkt_type == "LL_ENC_REQ":
            body = op + (fs.name_hex("RAND", True, 8) + fs.name_hex("EDIV", True, 2)
                         + fs.name_hex("SKDM", True, 8) + fs.name_hex("IVM", True, 4))
        elif pkt_type == "LL_ENC_RSP":
            body = op + fs.name_hex("SKDS", True, 8) + fs.name_hex("IVS", True, 4)
        elif pkt_type == "LL_UNKNOWN_RSP":
            body = op + fs.name_hex("UNKNOWNTYPE", False, 1)
        elif pkt_type in ("LL_FEATURE_REQ", "LL_FEATURE_RSP"):
            body = op + fs.name_hex("FEATURESET", True, 8)
        elif pkt_type == "LL_VERSION_IND":
            body = op + (fs.name_hex("VERSNR", False, 1)
                         + fs.name_hex("COMPID", True, 2)
                         + fs.name_hex("SUBVERSNR", True, 2))
        else:  # START/PAUSE_ENC_{REQ,RSP}: opcode only
            body = op

    hdr = _data_header_bytes(llid, nesn, sn, md, len(body))
    # data-channel preamble depends on the AA LSB (btle_tx.c:2695-2698)
    preamble = 0x55 if (aa[0] & 1) else 0xAA
    crc_init = fs.name_hex("CRCINIT", False, 3).hex()
    spec = PacketSpec(channel, pkt_type, _frame(preamble, aa, hdr + body),
                      crc_init_hex=crc_init)
    spec.space_ms = _space(fs)
    return spec


def parse_descriptor_sequence(items: list[str]) -> tuple[list[PacketSpec], int]:
    """Parse a cmdline/file item list, handling the trailing ``rN`` repeat
    (get_num_repeat, btle_tx.c:830-863). Returns (packets, num_repeat);
    num_repeat -1 means infinite."""
    items = [s for s in (x.strip() for x in items) if s]
    num_repeat = 1
    if items and items[-1][:1].lower() == "r":
        try:
            num_repeat = int(items[-1][1:])
        except ValueError:
            raise DescriptorError(f"invalid repeat spec {items[-1]!r}")
        if num_repeat < -1 or num_repeat == 0:
            num_repeat = 1
        items = items[:-1]
    return [parse_descriptor(x) for x in items], num_repeat


def read_packet_file(path: str) -> tuple[list[PacketSpec], int]:
    """Read a .txt descriptor file: ONE item per line, '#' comments, and
    only lines starting with a digit or 'r'/'R' are items — interior
    spaces stay inside fields like LOCAL_NAME
    (read_items_from_file, btle_tx.c:4106-4164)."""
    items: list[str] = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line or not (line[0].isdigit() or line[0] in "rR"):
                continue
            items.append(line.rstrip())
    return parse_descriptor_sequence(items)
