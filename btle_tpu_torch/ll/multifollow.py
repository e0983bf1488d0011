"""Multi-connection wideband following (host-side control logic).

The reference's receiver_controller (btle_rx.c:2403-2536) follows ONE
connection at a time because a single radio must physically retune to
the connection's current hop channel. The wideband receiver hears all
40 channels at once and the scan kernels re-key AA/CRC PER CHANNEL
(wideband.fused._aa_w4 / sniffer.wideband_scan aa_rows), so a tracked
connection only needs to own the single data channel it currently
occupies — up to 37 connections can be followed concurrently. This is
a capability the reference's architecture cannot express; the hop
bookkeeping per connection is the same 4-state FSM (ll.hop.HopTracker).

Control logic stays in Python on the host, exactly as the reference
keeps its controller outside the DSP; the only device-visible effect is
a new (40, 32) AA-row / (40,) CRC-init table between blocks.

Channel-collision semantics: two connections whose hop sequences land
on the same channel during the same block cannot both be decoded there
(one AA row per channel). The earlier-registered connection wins the
channel for that block; the other misses at most that dwell and
re-synchronises through its tracker's skip state (state 3), just as the
reference recovers from a missed dwell (btle_rx.c:2497-2527).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..spec import bits as B
from ..spec.crc24 import crc_init_reorder
from .hop import ConnectionInfo, HopEvent, HopTracker
from .pdu import AdvPduType, parse_adv_header, parse_adv_payload


@dataclass
class TrackedConnection:
    """One followed connection: its sniffed parameters + FSM state."""

    access_addr: int
    info: ConnectionInfo
    tracker: HopTracker
    aa_bits: np.ndarray          # (32,) on-air bit order
    crc_init_internal: int       # table-form init for the CRC kernels
    started_us: int
    last_crc_ok_us: int


class MultiConnectionFollower:
    """Track up to ``max_connections`` concurrent connections.

    Feed it decoded packets (``on_packet``) and the block clock
    (``on_tick``); read the per-channel receive tables from
    ``tables()`` whenever either call returns True (= the assignment
    changed). Unclaimed data channels keep the base (advertising) AA so
    new CONNECT_REQs and untracked traffic remain visible.
    """

    def __init__(self, base_aa_rows: np.ndarray, base_crc_inits: np.ndarray,
                 max_connections: int = 8,
                 drop_after_intervals: int | None = None,
                 on_event: Callable[[HopEvent], None] | None = None):
        self._base_aa = np.asarray(base_aa_rows).copy()
        self._base_crc = np.asarray(base_crc_inits).copy()
        self.max_connections = int(max_connections)
        # None = never drop (the reference's controller skips forever);
        # K = unregister after K connection intervals without a CRC-OK
        # packet, freeing the channel and a tracking slot
        self.drop_after_intervals = drop_after_intervals
        self.on_event = on_event
        self.connections: dict[int, TrackedConnection] = {}
        self._owners: dict[int, int] = {}    # channel bin -> access_addr
        self.events: list[HopEvent] = []

    # -- bookkeeping -------------------------------------------------

    def _emit(self, ev: HopEvent):
        self.events.append(ev)
        if self.on_event:
            self.on_event(ev)

    def _rebuild_owners(self) -> bool:
        """Channel-bin ownership from each tracker's current channel
        (registration order wins collisions). True when changed."""
        from ..wideband.channelizer import channel_to_bin

        owners: dict[int, int] = {}
        for aa, conn in self.connections.items():
            m = channel_to_bin(conn.tracker.channel)
            owners.setdefault(m, aa)
        changed = owners != self._owners
        self._owners = owners
        return changed

    def tables(self):
        """(aa_rows (40, 32) int8, crc_inits (40,) int32) numpy tables
        for the current block: base everywhere, each owned channel keyed
        to its connection."""
        aa_rows = self._base_aa.copy()
        crc = self._base_crc.copy()
        for m, aa in self._owners.items():
            conn = self.connections[aa]
            aa_rows[m] = conn.aa_bits
            crc[m] = conn.crc_init_internal
        return aa_rows, crc

    # -- inputs -------------------------------------------------------

    def on_packet(self, pkt, adv: bool, now_us: int) -> bool:
        """Consume one decoded packet. Returns True when the channel
        tables changed (new connection registered)."""
        if not pkt.crc_ok:
            return False
        if adv:
            return self._on_adv_packet(pkt, now_us)
        aa = self._owners.get(self._bin_of(pkt.channel))
        if aa is not None:
            conn = self.connections[aa]
            conn.tracker.on_crc_ok_packet(now_us)
            conn.last_crc_ok_us = now_us
            ctrl = getattr(getattr(pkt, "payload", None), "ctrl", None)
            if ctrl is not None:
                # route sniffed LL_CHANNEL_MAP_REQ/CONNECTION_UPDATE_REQ
                # to the owning tracker (ll.hop.on_ll_ctrl)
                conn.tracker.on_ll_ctrl(ctrl.opcode, ctrl.fields, now_us)
        return False

    @staticmethod
    def _bin_of(channel: int) -> int:
        from ..wideband.channelizer import channel_to_bin

        return channel_to_bin(channel)

    def _on_adv_packet(self, pkt, now_us: int) -> bool:
        try:
            hdr = parse_adv_header(pkt.pdu_bytes[:2])
            if hdr.pdu_type != AdvPduType.CONNECT_REQ:
                return False
            payload = parse_adv_payload(pkt.pdu_bytes[2:], hdr.pdu_type)
        except ValueError:
            return False
        aa = int(payload.aa)
        if aa in self.connections:
            return False                     # already tracked: ignore
        if len(self.connections) >= self.max_connections:
            self._emit(HopEvent("track_reject", 0, 0, pkt.channel, 0, aa,
                                payload.crc_init, payload.interval * 1250,
                                payload.hop, payload.chm, now_us))
            return False
        info = ConnectionInfo(aa, payload.crc_init, payload.hop,
                              payload.interval, payload.chm)
        tracker = HopTracker(on_event=self._emit)
        tracker.on_connect_req(info, now_us)
        if tracker.state == 0:
            return False   # rejected (<2-channel map, or full-map gate)
        self.connections[aa] = TrackedConnection(
            aa, info, tracker,
            B.hex_to_bits(aa.to_bytes(4, "little").hex()),
            crc_init_reorder(info.crc_init), now_us, now_us)
        self._rebuild_owners()
        return True

    def on_tick(self, now_us: int) -> bool:
        """Advance every tracker's dwell clock; drop stale connections;
        True when the channel assignment changed."""
        dropped = []
        for aa, conn in self.connections.items():
            conn.tracker.on_tick(now_us)
            if (self.drop_after_intervals is not None
                    and now_us - conn.last_crc_ok_us
                    > self.drop_after_intervals * conn.tracker.interval_us):
                dropped.append(aa)
        for aa in dropped:
            conn = self.connections.pop(aa)
            self._emit(HopEvent("track_drop", conn.tracker.state, 0,
                                conn.tracker.channel, 0, aa,
                                conn.info.crc_init, conn.tracker.interval_us,
                                conn.info.hop, conn.info.chm, now_us))
        return self._rebuild_owners()
