"""Load btle pcaps (DLT 256) back into parsed packet records.

Equivalent of btle_cli.pcap_loader: re-derives PDU headers and AdvA from
the stored de-whitened octets (the pcap stores header+payload, no CRC).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..ll.pdu import AdvPduType
from ..stream.pcap import read_pcap

ADV_AA = 0x8E89BED6


@dataclass
class PcapPkt:
    ts: float
    channel: int
    rssi_dbm: int
    access_addr: int
    packet: bytes

    @property
    def is_adv(self) -> bool:
        return self.access_addr == ADV_AA

    def pdu_header(self):
        """(pdu_type, tx_add, rx_add, payload_len, ok)."""
        if len(self.packet) < 2:
            return (0, 0, 0, 0, False)
        b0, b1 = self.packet[0], self.packet[1]
        if self.is_adv:
            return (b0 & 0x0F, (b0 >> 6) & 1, (b0 >> 7) & 1, b1 & 0x3F, True)
        return (b0 & 0x03, (b0 >> 2) & 1, (b0 >> 3) & 1, b1 & 0x1F, True)

    @property
    def pdu_type_name(self) -> str:
        t = self.pdu_header()[0]
        if self.is_adv:
            return AdvPduType(t).display_name
        return ("LL_RESERVED", "LL_DATA1", "LL_DATA2", "LL_CTRL")[t]

    @property
    def adv_a(self) -> Optional[str]:
        """Display-order AdvA when the PDU type carries one."""
        if not self.is_adv or len(self.packet) < 8:
            return None
        t = self.packet[0] & 0x0F
        if t in (0, 1, 2, 3, 4, 6):
            # first address field (AdvA, or ScanA for SCAN_REQ — the
            # reference filters on the first field, extract_adv_a)
            raw = self.packet[2:8]
        elif t == 5:
            raw = self.packet[8:14]        # CONNECT_REQ: AdvA after InitA
        else:
            return None
        if len(raw) < 6:
            return None
        return ":".join(f"{b:02x}" for b in raw[::-1])

    @property
    def payload_hex(self) -> str:
        return self.packet[2:].hex()


@dataclass
class CaptureFile:
    path: str
    packets: list[PcapPkt]

    @property
    def duration_s(self) -> float:
        if len(self.packets) < 2:
            return 0.0
        return self.packets[-1].ts - self.packets[0].ts


def load(path) -> CaptureFile:
    recs = read_pcap(str(path))
    return CaptureFile(
        str(path),
        [PcapPkt(r.ts, r.channel, r.rssi_dbm, r.access_addr, r.packet) for r in recs],
    )
