"""Streaming scan aggregation: per-AdvA device records + hop state.

Covers the role of the reference's btle_cli aggregation layer
(host/python/btle_cli/src/btle_cli/aggregate.py): consume schema-v1
events, keep one DeviceRecord per advertiser (names/services/vendor from
the AD structures, CRC statistics, advert-interval history) plus a
singleton HopState fed by hop events.

Design here: AD structures are walked by a TLV generator and decoded by
a small registry of per-type decoder functions writing into ParsedAd;
merging across packets is policy-driven per field.
"""

from __future__ import annotations

import collections
import time
import uuid as _uuid
from dataclasses import dataclass, field, fields as _dc_fields
from typing import Callable, Iterable


def _fresh(factory):
    return field(default_factory=factory)

from .events import Event, HopEvent, PktEvent, StatusEvent
from .vendors import manufacturer_name, oui_lookup

# ADV PDU types whose payload carries AD structures after AdvA:
# ADV_IND / ADV_NONCONN_IND / SCAN_RSP / ADV_SCAN_IND.
_AD_BEARING_PDUS = frozenset((0, 2, 4, 6))


@dataclass
class ParsedAd:
    """The AD fields surfaced to the UI/recon layers."""

    flags: int | None = None
    local_name: str | None = None
    tx_power: int | None = None
    service_uuids_16: list[str] = _fresh(list)
    service_uuids_128: list[str] = _fresh(list)
    manufacturer_id: int | None = None
    manufacturer_data_hex: str | None = None

    def absorb(self, newer: "ParsedAd") -> None:
        """Merge a later advertisement into this record: scalars are
        last-writer-wins when present; UUID lists accumulate (a SCAN_RSP
        often carries services the ADV_IND lacks)."""
        for f in _dc_fields(self):
            incoming = getattr(newer, f.name)
            if isinstance(incoming, list):
                if incoming:
                    merged = set(getattr(self, f.name)) | set(incoming)
                    setattr(self, f.name, sorted(merged))
            elif incoming is not None:
                setattr(self, f.name, incoming)


def _iter_tlv(stream: bytes):
    """Yield (ad_type, body) for each well-formed AD structure; stop at
    the first zero length or truncated entry (reference tools do the
    same — trailing garbage is common in the air)."""
    at = 0
    while at < len(stream):
        ln = stream[at]
        end = at + 1 + ln
        if ln == 0 or end > len(stream):
            return
        yield stream[at + 1], stream[at + 2 : end]
        at = end


# Decoder registry: Bluetooth Assigned-Numbers AD type -> handler.
_AD_DECODERS: dict[int, Callable[[ParsedAd, bytes], None]] = {}


def _decodes(*ad_types: int):
    def register(fn):
        for t in ad_types:
            _AD_DECODERS[t] = fn
        return fn

    return register


@_decodes(0x01)  # Flags
def _d_flags(ad: ParsedAd, body: bytes) -> None:
    if body:
        ad.flags = body[0]


@_decodes(0x08, 0x09)  # Shortened / Complete Local Name
def _d_name(ad: ParsedAd, body: bytes) -> None:
    # a zero-body name AD carries no information — leaving local_name
    # None keeps absorb() from wiping a previously-learned name
    if body:
        ad.local_name = body.decode("utf-8", errors="replace")


@_decodes(0x0A)  # TX Power Level (signed)
def _d_txpower(ad: ParsedAd, body: bytes) -> None:
    if body:
        ad.tx_power = int.from_bytes(body[:1], "little", signed=True)


@_decodes(0x02, 0x03)  # 16-bit Service UUIDs (incomplete/complete)
def _d_uuid16(ad: ParsedAd, body: bytes) -> None:
    for k in range(0, len(body) // 2 * 2, 2):
        ad.service_uuids_16.append(
            format(int.from_bytes(body[k : k + 2], "little"), "04x")
        )


@_decodes(0x06, 0x07)  # 128-bit Service UUIDs
def _d_uuid128(ad: ParsedAd, body: bytes) -> None:
    for k in range(0, len(body) // 16 * 16, 16):
        ad.service_uuids_128.append(
            str(_uuid.UUID(bytes=body[k : k + 16][::-1]))
        )


@_decodes(0xFF)  # Manufacturer Specific Data
def _d_manuf(ad: ParsedAd, body: bytes) -> None:
    if len(body) >= 2:
        ad.manufacturer_id = int.from_bytes(body[:2], "little")
        ad.manufacturer_data_hex = body.hex()


def parse_ad_structures(payload_hex: str) -> ParsedAd:
    """Decode the AD stream after the 6-byte AdvA of an ADV payload.
    Tolerant: malformed hex / truncation yield a partial (or empty)
    ParsedAd, never an exception."""
    ad = ParsedAd()
    try:
        raw = bytes.fromhex(payload_hex)
    except ValueError:
        return ad
    for ad_type, body in _iter_tlv(raw[6:] if len(raw) > 6 else b""):
        handler = _AD_DECODERS.get(ad_type)
        if handler is not None:
            handler(ad, body)
    return ad


def _window(n: int) -> collections.deque:
    return collections.deque(maxlen=n)


@dataclass
class DeviceRecord:
    """Everything known about one advertiser (keyed by AdvA)."""

    adv_a: str
    pkt_count: int = 0
    crc_ok_count: int = 0
    first_seen: float = 0.0
    last_seen: float = 0.0
    last_rssi: int | None = None
    last_channel: int = 0
    pdu_types_seen: set[int] = _fresh(set)
    last_payload_hex: str = ""
    parsed_ad: ParsedAd = _fresh(ParsedAd)
    advert_intervals_ms: collections.deque = field(
        default_factory=lambda: _window(64))
    history: collections.deque = field(default_factory=lambda: _window(20))

    @property
    def name(self) -> str:
        return self.parsed_ad.local_name if self.parsed_ad.local_name else ""

    @property
    def vendor(self) -> str:
        """Company name: BLE manufacturer ID beats the MAC OUI."""
        by_mfg = (manufacturer_name(self.parsed_ad.manufacturer_id)
                  if self.parsed_ad.manufacturer_id is not None else None)
        return by_mfg or oui_lookup(self.adv_a) or ""

    def crc_ok_ratio(self) -> float:
        if not self.pkt_count:
            return 0.0
        return self.crc_ok_count / self.pkt_count

    def observe(self, evt: PktEvent) -> None:
        """Fold one adv packet event into this record."""
        if self.last_seen:
            gap_ms = (evt.ts - self.last_seen) * 1e3
            if 0 < gap_ms < 60_000:
                self.advert_intervals_ms.append(gap_ms)
        self.pkt_count += 1
        self.crc_ok_count += int(bool(evt.crc_ok))
        self.last_seen = evt.ts
        self.last_channel = evt.ch
        self.last_payload_hex = evt.payload_hex
        if evt.rssi_est is not None:  # keep previous RSSI when absent
            self.last_rssi = evt.rssi_est
        if evt.pdu_type is not None:  # set membership, first-seen order lost
            self.pdu_types_seen.add(evt.pdu_type)
        self.history.append(evt)
        if evt.pdu_type in _AD_BEARING_PDUS:
            self.parsed_ad.absorb(parse_ad_structures(evt.payload_hex))


@dataclass
class HopState:
    """Singleton view of the hop-follow FSM as reported by hop events."""

    following_aa: str | None = None
    current_ch: int = 0
    fsm_state: int = 0
    interval_us: int = 0
    hop_increment: int = 0
    crc_init: str = ""
    chm: str = ""
    last_change_ts: float = 0.0
    history: collections.deque = field(default_factory=lambda: _window(100))

    def observe(self, evt: HopEvent) -> None:
        self.history.append(evt)
        self.last_change_ts = evt.ts
        self.current_ch = evt.ch
        self.fsm_state = evt.state_to
        if evt.event == "track_start":
            self.following_aa = evt.aa
            self.interval_us = evt.interval_us
            self.hop_increment = evt.hop
            self.crc_init = evt.crc_init
            self.chm = evt.chm or self.chm
        elif evt.event == "track_drop":
            self.following_aa = None


_SNAPSHOT_ORDERS: dict[str, tuple[Callable[[DeviceRecord], object], bool]] = {
    "last_seen": (lambda r: r.last_seen, True),
    "pkts": (lambda r: r.pkt_count, True),
    "name": (lambda r: r.name or "~", False),
    "rssi": (lambda r: -200 if r.last_rssi is None else r.last_rssi, True),
}


class ScanAggregator:
    """Single-consumer streaming aggregator over schema-v1 events."""

    def __init__(self) -> None:
        self.devices: dict[str, DeviceRecord] = {}
        self.hop = HopState()
        self.total_pkts = 0
        self.crc_ok_pkts = 0
        self.last_status: StatusEvent | None = None
        self.started_at = time.time()

    def update(self, evt: Event) -> None:
        if isinstance(evt, PktEvent):
            self.total_pkts += 1
            self.crc_ok_pkts += int(bool(evt.crc_ok))
            if evt.kind == "adv" and evt.adv_a:
                rec = self.devices.get(evt.adv_a)
                if rec is None:
                    rec = self.devices.setdefault(
                        evt.adv_a, DeviceRecord(evt.adv_a, first_seen=evt.ts))
                rec.observe(evt)
        elif isinstance(evt, HopEvent):
            self.hop.observe(evt)
        elif isinstance(evt, StatusEvent):
            self.last_status = evt

    def feed(self, events: Iterable[Event]) -> None:
        for e in events:
            self.update(e)

    def snapshot(self, sort: str = "last_seen") -> list[DeviceRecord]:
        records = list(self.devices.values())
        order = _SNAPSHOT_ORDERS.get(sort)
        if order is not None:
            records.sort(key=order[0], reverse=order[1])
        return records
