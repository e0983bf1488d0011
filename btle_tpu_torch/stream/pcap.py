"""pcap writer/reader for DLT_BLUETOOTH_LE_LL_WITH_PHDR (linktype 256).

Byte-compatible with the reference's pcap path (btle_rx.c:108-207): global
header written with the big-endian magic 0xA1B2C3D4, record headers in
network byte order, and a 10-byte BTLE pseudo-header
{RF_channel, signal_power, noise_power, AA_offenses, ref_AA[4], flags[2]}
followed by the 4-byte access address (host LE) and the de-whitened
header+payload octets (no CRC).
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass

PCAP_GLOBAL_HEADER = (
    b"\xA1\xB2\xC3\xD4\x00\x02\x00\x04\x00\x00\x00\x00"
    b"\x00\x00\x00\x00\x00\x00\x05\xDC\x00\x00\x01\x00"
)
BTLE_PHDR_LEN = 10
FLAG_DEWHITENED = 0x0001


@dataclass
class PcapRecord:
    ts: float
    channel: int
    rssi_dbm: int
    access_addr: int
    packet: bytes  # header + payload (de-whitened, no CRC)


class PcapWriter:
    def __init__(self, path_or_file):
        if hasattr(path_or_file, "write"):
            self._fh = path_or_file
            self._own = False
        else:
            self._fh = open(path_or_file, "wb")
            self._own = True
        self._fh.write(PCAP_GLOBAL_HEADER)

    def write_packet(self, packet: bytes, channel: int, access_addr: int,
                     rssi_dbm: int | None = None, ts: float | None = None):
        ts = time.time() if ts is None else ts
        sec = int(ts)
        usec = int((ts - sec) * 1e6)
        caplen = BTLE_PHDR_LEN + 4 + len(packet)
        self._fh.write(struct.pack(">IIII", sec, usec, caplen, caplen))
        if rssi_dbm is None:
            sig = -127
        else:
            sig = max(-126, min(20, int(rssi_dbm)))
        phdr = bytes([channel & 0xFF, sig & 0xFF, 0, 0, 0, 0, 0, 0, FLAG_DEWHITENED, 0])
        self._fh.write(phdr)
        self._fh.write(struct.pack("<I", access_addr & 0xFFFFFFFF))
        self._fh.write(bytes(packet))
        self._fh.flush()

    def close(self):
        if self._own:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_pcap(path) -> list[PcapRecord]:
    """Parse a pcap written by PcapWriter / the reference btle_rx."""
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < 24:
        raise ValueError("truncated pcap")
    magic = data[:4]
    if magic == b"\xA1\xB2\xC3\xD4":
        endian = ">"
    elif magic == b"\xD4\xC3\xB2\xA1":
        endian = "<"
    else:
        raise ValueError("not a pcap file")
    linktype = struct.unpack(endian + "I", data[20:24])[0]
    if linktype != 256:
        raise ValueError(f"unexpected linktype {linktype}")
    out = []
    off = 24
    while off + 16 <= len(data):
        sec, usec, caplen, _ = struct.unpack(endian + "IIII", data[off : off + 16])
        off += 16
        rec = data[off : off + caplen]
        off += caplen
        if len(rec) < BTLE_PHDR_LEN + 4:
            continue
        channel = rec[0]
        rssi = rec[1] - 256 if rec[1] > 127 else rec[1]
        aa = struct.unpack("<I", rec[10:14])[0]
        out.append(PcapRecord(sec + usec / 1e6, channel, rssi, aa, rec[14:]))
    return out
