"""Connection-following hop state machine.

A pure, virtual-clock port of receiver_controller (btle_rx.c:2403-2536):
the 4-state FSM that, after sniffing a CONNECT_REQ on an advertising
channel, retunes along the hop sequence hop_chan = (hop_chan + hop) % 37
at connection-interval pacing with guard times, re-synchronising on the
first CRC-OK packet per dwell.

Control logic stays host-side Python (as the reference keeps it outside
the DSP); time is injected so the FSM is testable and can be driven by a
stream clock (sample counts) or the wall clock.

Beyond the reference: partial channel maps are followed via the spec's
channel-selection algorithm #1 remapping (Core 5.3 Vol 6 Part B
4.5.8.2) instead of refused — the reference's chm_is_full_map gate
(btle_rx.c:2417-2425) drops any connection that masked even one noisy
channel. ``require_full_map=True`` restores the reference-exact gate.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..spec.channels import (channel_to_freq_hz, chm_is_full_map,
                             chm_used_channels, csa1_channel)
from ..spec.crc24 import crc_init_reorder

GUARD_US = 7000    # btle_rx.c:2404
GUARD_US_SKIP = 4000  # btle_rx.c:2405


@dataclass
class ConnectionInfo:
    """Fields sniffed from CONNECT_REQ (receiver_status, btle_rx.c:1683-1698)."""

    access_addr: int
    crc_init: int          # display-order value as sniffed
    hop: int
    interval: int          # units of 1.25 ms
    chm: bytes             # display order, 0x1F first


@dataclass
class HopEvent:
    # "track_start" | "chan_change" | "track_drop" | "chm_update" |
    # "conn_update" — the last two are emitted when a live
    # LL_CHANNEL_MAP_REQ / LL_CONNECTION_UPDATE_REQ reaches its instant
    # (_apply_pending). The set is additive: NDJSON consumers must
    # ignore unknown values (cli/aggregate.py does).
    event: str
    state_from: int
    state_to: int
    channel: int
    freq_hz: int
    access_addr: int
    crc_init: int
    interval_us: int
    hop: int
    chm: bytes
    time_us: int


@dataclass
class HopTracker:
    """Carryable FSM state. Feed it packet events + time; it emits retune
    decisions through the ``on_event`` callback and exposes the current
    (channel, access_addr, crc_init_internal) receive configuration."""

    on_event: Callable[[HopEvent], None] | None = None
    state: int = 0
    hop_chan: int = 0
    hop: int = 0
    interval_us: int = 0
    target_us: int = 0
    target_us_skip: int = 0
    time_mark_us: int = 0
    conn: ConnectionInfo | None = None
    # live receive configuration
    channel: int = 37
    access_addr: int = 0x8E89BED6
    crc_init_internal: int = 0xAAAAAA
    retunes: int = 0
    events: list = field(default_factory=list)
    # CSA#1 remapping state (beyond-reference: btle_rx.c:2417-2425 drops
    # any non-full channel map; here partial maps follow via the spec's
    # own remap, Core 5.3 Vol 6 Part B 4.5.8.2). hop_chan stays the
    # UNMAPPED channel — the hop arithmetic never sees the map.
    used: tuple = tuple(range(37))
    require_full_map: bool = False  # True = reference-exact gating
    # live LL-control updates (beyond-reference: the reference parses
    # LL_CHANNEL_MAP_REQ / LL_CONNECTION_UPDATE_REQ but never applies
    # them — following silently breaks the moment a real connection
    # updates, btle_rx.c:1797-1827 vs :2403-2536). A sniffer cannot
    # observe the master's connEventCount directly, so the instant is
    # tracked best-effort: event_count advances one per dwell
    # (track_start = event 0, wrapping mod 2^16 like the real counter),
    # which is exact while the FSM paces at the connection interval and
    # EARLY-biased across skip-state re-syncs (state-3 retunes every
    # interval-4ms run ahead of the master's event clock) — a slightly
    # early or late application still recovers the follow, while the
    # reference's alternative is losing the connection entirely.
    event_count: int = 0
    pending_chm: tuple | None = None       # (instant, used, chm_bytes)
    pending_update: tuple | None = None    # (instant, interval_units)

    def _emit(self, ev: HopEvent):
        self.events.append(ev)
        if self.on_event:
            self.on_event(ev)

    def _instant_due(self, instant: int) -> bool:
        """connEventCount comparison mod 2^16 (Core 5.3 Vol 6 Part B
        5.1.1/5.1.2: an instant is in the past when it is within half the
        counter range behind) — event_count wraps like the real counter,
        so a plain >= would fire early after 65536 dwells."""
        return ((self.event_count - instant) & 0xFFFF) < 0x8000

    def _apply_pending(self, now_us: int):
        """Apply sniffed LL-control updates once their instant arrives."""
        if self.pending_chm and self._instant_due(self.pending_chm[0]):
            _, self.used, chm = self.pending_chm
            if self.conn is not None:
                self.conn = ConnectionInfo(
                    self.conn.access_addr, self.conn.crc_init, self.hop,
                    self.conn.interval, chm)
            self.pending_chm = None
            self._emit(HopEvent(
                "chm_update", self.state, self.state, self.channel,
                channel_to_freq_hz(self.channel), self.access_addr,
                self.conn.crc_init if self.conn else 0, self.interval_us,
                self.hop, chm, now_us))
        if self.pending_update and self._instant_due(self.pending_update[0]):
            _, interval = self.pending_update
            self.interval_us = interval * 1250
            self.target_us = self.interval_us - GUARD_US
            self.target_us_skip = self.interval_us - GUARD_US_SKIP
            if self.conn is not None:
                self.conn = ConnectionInfo(
                    self.conn.access_addr, self.conn.crc_init, self.hop,
                    interval, self.conn.chm)
            self.pending_update = None
            self._emit(HopEvent(
                "conn_update", self.state, self.state, self.channel,
                channel_to_freq_hz(self.channel), self.access_addr,
                self.conn.crc_init if self.conn else 0, self.interval_us,
                self.hop, self.conn.chm if self.conn else b"", now_us))

    def _retune(self, now_us: int, event: str, state_to: int):
        if event == "chan_change":
            self.event_count = (self.event_count + 1) & 0xFFFF
            self._apply_pending(now_us)
        self.hop_chan = (self.hop_chan + self.hop) % 37
        self.channel = csa1_channel(self.hop_chan, self.used)
        self.retunes += 1
        self._emit(
            HopEvent(
                event, self.state, state_to, self.channel,
                channel_to_freq_hz(self.channel),
                self.conn.access_addr, self.conn.crc_init,
                self.interval_us, self.hop, self.conn.chm, now_us,
            )
        )

    def on_connect_req(self, conn: ConnectionInfo, now_us: int):
        """Call when a CRC-OK CONNECT_REQ was parsed (state 0 trigger)."""
        if self.state != 0:
            return
        used = chm_used_channels(conn.chm)
        # the spec's own validity floor is two used channels (a 1-channel
        # map cannot hop); the reference-exact mode refuses ANY partial
        # map (chm_is_full_map gate, btle_rx.c:2417-2425)
        if len(used) < 2 or (self.require_full_map
                             and not chm_is_full_map(conn.chm)):
            self._emit(
                HopEvent("track_drop", 0, 0, self.channel, 0,
                         conn.access_addr, conn.crc_init, 0, conn.hop,
                         conn.chm, now_us)
            )
            return
        self.used = used
        self.event_count = 0
        self.pending_chm = None
        self.pending_update = None
        self.conn = conn
        self.hop = conn.hop
        self.interval_us = conn.interval * 1250
        self.target_us = self.interval_us - GUARD_US
        self.target_us_skip = self.interval_us - GUARD_US_SKIP
        self._retune(now_us, "track_start", 1)
        self.access_addr = conn.access_addr
        self.crc_init_internal = crc_init_reorder(conn.crc_init)
        self.state = 1

    def on_ll_ctrl(self, opcode: int, fields: dict, now_us: int):
        """Feed sniffed LL control PDUs (CRC-OK, this connection's AA).

        Applies LL_CHANNEL_MAP_REQ (0x01) and LL_CONNECTION_UPDATE_REQ
        (0x00) at their instant (best-effort event counting — see the
        class docstring); every other opcode is ignored here.
        """
        if self.state == 0:
            return
        if opcode == 0x01 and "chm" in fields and "instant" in fields:
            used = chm_used_channels(fields["chm"])
            if len(used) >= 2:
                self.pending_chm = (int(fields["instant"]), used,
                                    bytes(fields["chm"]))
                self._apply_pending(now_us)
        elif opcode == 0x00 and "interval" in fields and "instant" in fields:
            if fields["interval"] > 0:
                self.pending_update = (int(fields["instant"]),
                                       int(fields["interval"]))
                self._apply_pending(now_us)

    def on_crc_ok_packet(self, now_us: int):
        """Call for every CRC-OK packet on the current data channel."""
        if self.state == 1:
            self.time_mark_us = now_us
            self.state = 2
        elif self.state == 3:
            self.time_mark_us = now_us
            self.state = 2

    def on_tick(self, now_us: int):
        """Call periodically (the reference calls per half-buffer)."""
        if self.state == 2:
            if now_us - self.time_mark_us > self.target_us:
                self.time_mark_us = now_us
                self._retune(now_us, "chan_change", 3)
                self.state = 3
        elif self.state == 3:
            if now_us - self.time_mark_us > self.target_us_skip:
                self.time_mark_us = now_us
                self._retune(now_us, "chan_change", 3)
