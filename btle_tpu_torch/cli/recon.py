"""Recon/analysis over captures: fingerprints, profiles, diffs, entropy.

Capability parity with the reference's recon layer
(host/python/btle_cli/src/btle_cli/recon.py): compact reports sized for
LLM/MCP consumption — quickscan, per-device profile, capture
diff and manufacturer-data entropy. Input is anything `_load` accepts: a
pcap path, an iterable of schema-v1 events, or a ready ScanAggregator.

Structure here: one flat rule table drives all protocol fingerprinting,
and the per-byte payload analysis is vectorized with numpy.

Port of btle_tpu/cli/recon.py: the reports are dataclasses on the
events module's Model (lax validation, ``extra="forbid"``) instead of
pydantic models, and ``model_dump_json(indent=2, exclude_none=True)``
prints the bytes pydantic prints.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from .aggregate import DeviceRecord, ParsedAd, ScanAggregator, parse_ad_structures
from .events import Event, Model, PktEvent
from .pcap_loader import CaptureFile, load as load_pcap

# ---------------- protocol fingerprints ----------------
#
# One rule per row: (kind, match key, tag). Kinds:
#   mfg+prefix — manufacturer id AND mfg-data hex prefix
#   mfg        — manufacturer id alone
#   svc        — a 128-bit service UUID (16-bit UUIDs are promoted to
#                their Bluetooth-base 128-bit form before lookup)
# First matching row wins, so put the most specific rules on top.

_RULES: tuple[tuple[str, object, str], ...] = (
    ("mfg+prefix", (0x004C, "4c000215"), "ibeacon"),
    ("mfg", 0x004C, "apple_continuity"),
    ("mfg", 0x0006, "microsoft_swift_pair"),
    ("mfg", 0x0059, "nordic_proprietary"),
    ("mfg", 0x1337, "dev_or_hobby_0x1337"),
    ("svc", "00001523-1212-efde-1523-785feabcd123", "nordic_lbs"),
    ("svc", "6e400001-b5a3-f393-e0a9-e50e24dcca9e", "nordic_uart"),
    ("svc", "8d53dc1d-1db7-4cd3-868b-8a527460aa84", "mcumgr_smp"),
    ("svc", "0000feaa-0000-1000-8000-00805f9b34fb", "eddystone"),
    ("svc", "0000fd5a-0000-1000-8000-00805f9b34fb", "apple_findmy"),
    ("svc", "0000fe9f-0000-1000-8000-00805f9b34fb", "google_fast_pair"),
    ("svc", "0000fef3-0000-1000-8000-00805f9b34fb", "tile"),
)

_BT_BASE_SUFFIX = "-0000-1000-8000-00805f9b34fb"


def _all_uuids_128(parsed: ParsedAd) -> set[str]:
    full = {u.lower() for u in parsed.service_uuids_128}
    full.update(f"0000{u.lower()}{_BT_BASE_SUFFIX}" for u in parsed.service_uuids_16)
    return full


def fingerprint(parsed: ParsedAd) -> Optional[str]:
    """Short protocol tag for a device, or None if nothing matches."""
    uuids = _all_uuids_128(parsed)
    for kind, key, tag in _RULES:
        if kind == "mfg+prefix":
            mid, prefix = key
            if parsed.manufacturer_id == mid and (
                    parsed.manufacturer_data_hex or "").startswith(prefix):
                return tag
        elif kind == "mfg":
            if parsed.manufacturer_id == key:
                return tag
        elif kind == "svc" and key in uuids:
            return tag
    return None


# ---------------- report models (the MCP/LLM ABI) ----------------


@dataclass(init=False)
class DeviceBrief(Model):
    adv_a: str
    name: str | None = None
    vendor_hint: str | None = None
    fingerprint: str | None = None
    rssi_dbm: int | None = None
    n_pkts: int = 0


@dataclass(init=False)
class TargetProfile(Model):
    adv_a: str
    name: str | None = None
    vendor_hint: str | None = None
    mfg_id: int | None = None
    protocol_fingerprint: str | None = None
    primary_service_uuids: list[str] = field(default_factory=list)
    pdu_types_seen: list[str] = field(default_factory=list)
    is_connectable: bool = False
    is_scan_responsive: bool = False
    flags: int | None = None
    tx_power_dbm: int | None = None
    avg_interval_ms: float | None = None
    rssi_dbm: int | None = None
    n_packets: int = 0
    crc_ok_ratio: float = 0.0
    duration_s: float = 0.0
    mfg_data_sample: str | None = None
    notes: list[str] = field(default_factory=list)


@dataclass(init=False)
class ScanSummary(Model):
    duration_s: float
    n_devices: int
    n_packets: int
    crc_ok_ratio: float
    channels_scanned: list[int]
    devices_top: list[DeviceBrief]
    fingerprints_seen: dict[str, int]


@dataclass(init=False)
class DiffReport(Model):
    only_in_a: list[str]
    only_in_b: list[str]
    common: int
    rssi_shifts: dict[str, int]
    payload_changed: dict[str, str]
    notes: list[str] = field(default_factory=list)


@dataclass(init=False)
class PayloadEntropyReport(Model):
    adv_a: str
    n_samples: int
    payload_length: int
    static_prefix_bytes: int
    static_suffix_bytes: int
    changing_positions: list[int]
    likely_counter_positions: list[int]
    likely_random_positions: list[int]
    sample_hex_first: str | None = None
    sample_hex_last: str | None = None


# ---------------- capture ingestion ----------------


def _short_hex(b, max_bytes: int = 16) -> str:
    h = b.hex() if isinstance(b, (bytes, bytearray)) else b
    return h if len(h) <= max_bytes * 2 else h[: max_bytes * 2] + "…"


def aggregator_from_pcap(cap: CaptureFile) -> ScanAggregator:
    """Replay a pcap's adv packets as synthetic events."""
    agg = ScanAggregator()
    for p in cap.packets:
        t, tx_add, rx_add, plen, ok = p.pdu_header()
        if ok and p.is_adv:
            agg.update(PktEvent(
                v=1, t="pkt", ts=p.ts, pkt=0, ch=p.channel,
                aa=f"{p.access_addr:08x}", crc_ok=True, kind="adv",
                pdu_type=t, pdu_name=p.pdu_type_name, tx_add=tx_add,
                rx_add=rx_add, plen=plen, adv_a=p.adv_a,
                payload_hex=p.payload_hex,
                rssi_est=p.rssi_dbm if p.rssi_dbm > -127 else None,
            ))
    return agg


def aggregator_from_events(events: Iterable[Event]) -> ScanAggregator:
    agg = ScanAggregator()
    agg.feed(events)
    return agg


def _load(capture) -> ScanAggregator:
    if isinstance(capture, ScanAggregator):
        return capture
    if isinstance(capture, (str, Path)):
        return aggregator_from_pcap(load_pcap(capture))
    return aggregator_from_events(capture)


def _capture_span(recs: Iterable[DeviceRecord]) -> float:
    stamps = [t for r in recs for t in (r.first_seen, r.last_seen) if t]
    return max(stamps) - min(stamps) if len(stamps) >= 2 else 0.0


# ---------------- public operations ----------------


def _brief(rec: DeviceRecord) -> DeviceBrief:
    return DeviceBrief(
        adv_a=rec.adv_a, name=rec.name or None,
        vendor_hint=rec.vendor or None,
        fingerprint=fingerprint(rec.parsed_ad),
        rssi_dbm=rec.last_rssi, n_pkts=rec.pkt_count,
    )


def quickscan(capture, top: int = 15) -> ScanSummary:
    """Compact scan summary: top devices + fingerprint histogram."""
    agg = _load(capture)
    recs = agg.snapshot(sort="pkts")
    tags: dict[str, int] = {}
    for r in recs:
        tag = fingerprint(r.parsed_ad)
        if tag:
            tags[tag] = 1 + tags.get(tag, 0)
    ok_ratio = agg.crc_ok_pkts / agg.total_pkts if agg.total_pkts else 0.0
    return ScanSummary(
        duration_s=round(_capture_span(recs), 2),
        n_devices=len(recs),
        n_packets=agg.total_pkts,
        crc_ok_ratio=round(ok_ratio, 3),
        channels_scanned=sorted({r.last_channel for r in recs}),
        devices_top=[_brief(r) for r in recs[:top]],
        fingerprints_seen=tags,
    )


def profile(capture, adv_a: str) -> TargetProfile:
    """One-device deep profile from a capture."""
    from ..ll.pdu import AdvPduType

    agg = _load(capture)
    rec = agg.devices.get(adv_a.lower())
    if rec is None:
        return TargetProfile(adv_a=adv_a.lower(),
                             notes=["device not seen in capture"])
    pa = rec.parsed_ad
    seen = rec.pdu_types_seen
    notes = []
    if {0, 5} <= seen:
        notes.append("CONNECT_REQ observed — device was connected to during capture")
    return TargetProfile(
        adv_a=rec.adv_a, name=rec.name or None,
        vendor_hint=rec.vendor or None,
        mfg_id=pa.manufacturer_id,
        protocol_fingerprint=fingerprint(pa),
        primary_service_uuids=(pa.service_uuids_16 + pa.service_uuids_128)[:8],
        pdu_types_seen=sorted(AdvPduType(t).display_name for t in seen),
        is_connectable=0 in seen,        # ADV_IND
        is_scan_responsive=4 in seen,    # SCAN_RSP
        flags=pa.flags, tx_power_dbm=pa.tx_power,
        avg_interval_ms=(round(statistics.mean(rec.advert_intervals_ms), 1)
                         if rec.advert_intervals_ms else None),
        rssi_dbm=rec.last_rssi,
        n_packets=rec.pkt_count, crc_ok_ratio=round(rec.crc_ok_ratio(), 3),
        duration_s=round(_capture_span(agg.devices.values()), 2),
        mfg_data_sample=(_short_hex(pa.manufacturer_data_hex)
                         if pa.manufacturer_data_hex else None),
        notes=notes,
    )


def _payload_delta(hex_a: str, hex_b: str) -> Optional[str]:
    """Human-readable description of how a payload changed, or None."""
    if not hex_a or not hex_b or hex_a == hex_b:
        return None
    ba, bb = bytes.fromhex(hex_a), bytes.fromhex(hex_b)
    if len(ba) != len(bb):
        return f"length {len(ba)}→{len(bb)} bytes"
    changed = np.flatnonzero(np.frombuffer(ba, np.uint8)
                             != np.frombuffer(bb, np.uint8))
    return _ranges(changed) if changed.size else None


def _ranges(positions: np.ndarray) -> str:
    """Condense sorted byte positions into 'byte 3..5, 7' (max 5 runs)."""
    runs = np.split(positions, np.flatnonzero(np.diff(positions) > 1) + 1)
    parts = [str(r[0]) if len(r) == 1 else f"{r[0]}..{r[-1]}" for r in runs]
    shown = ", ".join(parts[:5])
    extra = f", … (+{len(parts) - 5} more)" if len(parts) > 5 else ""
    return f"byte {shown}{extra}"


def diff(capture_a, capture_b) -> DiffReport:
    """What changed between two captures."""
    dev_a = _load(capture_a).devices
    dev_b = _load(capture_b).devices
    shared = sorted(dev_a.keys() & dev_b.keys())
    rssi_shifts: dict[str, int] = {}
    payload_changed: dict[str, str] = {}
    for mac in shared:
        ra, rb = dev_a[mac], dev_b[mac]
        if None not in (ra.last_rssi, rb.last_rssi):
            shift = rb.last_rssi - ra.last_rssi
            if abs(shift) >= 5:
                rssi_shifts[mac] = shift
        delta = _payload_delta(ra.last_payload_hex, rb.last_payload_hex)
        if delta:
            payload_changed[mac] = delta
    gone = sorted(dev_a.keys() - dev_b.keys())
    new = sorted(dev_b.keys() - dev_a.keys())
    notes = [txt for cond, txt in (
        (gone, f"{len(gone)} device(s) disappeared"),
        (new, f"{len(new)} new device(s) appeared"),
        (rssi_shifts, f"{len(rssi_shifts)} device(s) shifted RSSI >=5 dB"),
    ) if cond]
    return DiffReport(
        only_in_a=gone[:20], only_in_b=new[:20], common=len(shared),
        rssi_shifts=dict(list(rssi_shifts.items())[:15]),
        payload_changed=dict(list(payload_changed.items())[:15]),
        notes=notes,
    )


def payload_entropy(capture, adv_a: str) -> PayloadEntropyReport:
    """Per-byte variability of a device's manufacturer data: which byte
    positions are static, counter-like (monotonic) or random-looking."""
    rec = _load(capture).devices.get(adv_a.lower())
    blobs = []
    for evt in (rec.history if rec is not None else ()):
        mfg_hex = parse_ad_structures(evt.payload_hex).manufacturer_data_hex
        if mfg_hex:
            blobs.append(np.frombuffer(bytes.fromhex(mfg_hex), np.uint8))
    if not blobs:
        return PayloadEntropyReport(
            adv_a=adv_a, n_samples=0, payload_length=0,
            static_prefix_bytes=0, static_suffix_bytes=0,
            changing_positions=[], likely_counter_positions=[],
            likely_random_positions=[],
        )
    width = min(map(len, blobs))
    mat = np.stack([b[:width] for b in blobs])          # (n_samples, width)
    varies = (mat != mat[0]).any(axis=0)
    changing = np.flatnonzero(varies)
    prefix = int(changing[0]) if changing.size else width
    suffix = int(width - 1 - changing[-1]) if changing.size else width
    counters, randoms = [], []
    for col in changing:
        vals = mat[:, col].astype(np.int32)
        distinct = len(np.unique(vals)) / len(vals)
        if (np.diff(vals) >= 0).all() and distinct > 0.5:
            counters.append(int(col))
        elif distinct > 0.7:
            randoms.append(int(col))
    return PayloadEntropyReport(
        adv_a=adv_a, n_samples=len(blobs), payload_length=int(width),
        static_prefix_bytes=prefix, static_suffix_bytes=suffix,
        changing_positions=[int(c) for c in changing[:24]],
        likely_counter_positions=counters[:8],
        likely_random_positions=randoms[:8],
        sample_hex_first=_short_hex(mat[0].tobytes()),
        sample_hex_last=(_short_hex(mat[-1].tobytes())
                         if len(blobs) > 1 else None),
    )


@dataclass(init=False)
class GattOp(Model):
    name: str
    handle: Optional[int] = None
    mtu: Optional[int] = None
    value_hex: Optional[str] = None
    decrypted: bool = False


@dataclass(init=False)
class GattReport(Model):
    """ATT/GATT operations reconstructed from a capture's data PDUs —
    L2CAP reassembly over the LL fragments (ll/l2cap.py), optionally
    through LL decryption given the LTK (ll/crypto.py). The reference's
    app layer stops at advertising AD structures; connection CONTENT is
    new capability."""

    n_data_pdus: int
    n_ctrl_pdus: int
    n_decrypted: int
    l2cap_discarded: int
    ops: list[GattOp]


def gatt(capture, ltk_hex: Optional[str] = None) -> GattReport:
    """Walk a pcap's connection traffic -> reassembled ATT operations.

    With ``ltk_hex`` the LL_ENC_REQ/RSP exchange in the same capture
    keys the session and encrypted PDUs are decrypted first (both
    directions tried per PDU — the sniffer cannot see direction)."""
    from ..ll.l2cap import CID_ATT, L2capReassembler, parse_att
    from ..ll.pdu import LlPduType, parse_ll_payload

    cap = capture if isinstance(capture, CaptureFile) else load_pcap(capture)
    decryptor = None
    if ltk_hex is not None:
        from ..ll.crypto import SniffDecryptor

        decryptor = SniffDecryptor(bytes.fromhex(ltk_hex))
    rs = L2capReassembler()
    ops: list[GattOp] = []
    n_data = n_ctrl = n_dec = 0
    for pkt in sorted(cap.packets, key=lambda p: p.ts):
        if pkt.is_adv or len(pkt.packet) < 2:
            continue
        llid = pkt.packet[0] & 0x03
        payload = pkt.packet[2:]
        if llid == 3:
            n_ctrl += 1
            if decryptor is not None:
                try:
                    ctrl = parse_ll_payload(payload, LlPduType.LL_CTRL).ctrl
                except ValueError:
                    continue
                if ctrl is not None:
                    decryptor.observe_ctrl(pkt.access_addr, ctrl.opcode,
                                           ctrl.fields)
            continue
        if llid not in (1, 2):
            continue
        n_data += 1
        plain = (decryptor.try_decrypt(pkt.access_addr, pkt.packet[0],
                                       payload)
                 if decryptor is not None else None)
        body = plain if plain is not None else payload
        if plain is not None:
            n_dec += 1
        for frame in rs.feed(llid, body):
            if frame.cid != CID_ATT:
                continue
            op = parse_att(frame.payload)
            if op is None:
                continue
            ops.append(GattOp(
                name=op.name, handle=op.handle, mtu=op.mtu,
                value_hex=op.value.hex() if op.value else None,
                decrypted=plain is not None))
    return GattReport(n_data_pdus=n_data, n_ctrl_pdus=n_ctrl,
                      n_decrypted=n_dec,
                      l2cap_discarded=rs.discarded, ops=ops)
