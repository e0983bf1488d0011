"""Sniffer orchestration: the btle_rx tool as a library object (torch).

Port of btle_tpu/stream/sniffer.py. Wires together the overlap-save
block iterator, the device block scan (rx.decoder.stream_decode: the
narrowband scan and candidate decode kernels on a CUDA card), PDU
parsing, packet filters, the hop-follow FSM, and the three output paths
(text lines, NDJSON schema v1, pcap) — the same composition as the
reference main loop (btle_rx.c:2542-2676) with the DSP replaced by the
dense device pipeline.

Time is the sample clock (1 symbol == 1 us at LE-1M), so file replays and
live streams behave identically; a live front-end only needs to supply a
sample source.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

from .._device import resolve_device
from ..ll.hop import ConnectionInfo, HopTracker
from ..ll.pdu import (
    AdvPduType,
    extract_adv_a,
    parse_adv_header,
    parse_adv_payload,
    parse_ll_header,
    parse_ll_payload,
)
from ..rx.decoder import stream_decode
from ..spec import crc24 as C
from ..spec.constants import ADV_ACCESS_ADDRESS
from ..utils.profiling import span
from .blocks import DEFAULT_SCAN_LEN, OverlapBlockIterator
from .ndjson import NdjsonEmitter
from .pcap import PcapWriter


@dataclass
class SnifferConfig:
    channel: int = 37
    access_addr: int = ADV_ACCESS_ADDRESS
    crc_init: int = 0x555555          # display order, as the -c flag takes it
    sps: int = 4
    access_mask_hex: str | None = None
    filter_adva: bytes | None = None  # display order MAC
    filter_pdu_mask: int = 0xFFFF
    hop: bool = False
    raw: bool = False
    rssi: bool = False
    verbose: bool = False
    scan_len: int = DEFAULT_SCAN_LEN
    # ADV dwell rotation (the reference CLI scan's 37->38->39 rotate over
    # a live radio, btle_cli cli.py:115-178): retune through these
    # channels every dwell_ms of stream time. Mutually exclusive with hop.
    rotate_channels: tuple = ()
    dwell_ms: int = 200
    # LE PHY: "1m" (reference) or "2m" (BLE 5 LE 2M, beyond-reference).
    # The DSP is symbol-indexed so only wall-clock bookkeeping changes:
    # at 2M a symbol is 0.5 us, so timestamps/dwell/hop timing divide
    # sample counts by sps*2 instead of sps.
    phy: str = "1m"

    def __post_init__(self):
        if self.phy not in ("1m", "2m"):
            raise ValueError(f"unknown phy {self.phy!r} (want '1m'|'2m')")

    @property
    def samples_per_us(self) -> int:
        return self.sps * (2 if self.phy == "2m" else 1)


@dataclass
class PacketEvent:
    ts_us: int
    pkt_count: int
    channel: int
    access_addr: int
    crc_ok: bool
    is_adv: bool
    header: object
    payload: object | None
    payload_bytes: bytes
    rssi_dbm: int | None
    raw_bytes: bytes | None = None


class Sniffer:
    """One-channel receiver over a sample source, on ``device`` (cuda
    unless the caller passes another)."""

    def __init__(
        self,
        config: SnifferConfig,
        ndjson: NdjsonEmitter | None = None,
        pcap: PcapWriter | None = None,
        text_fh=None,
        quiet_text: bool = False,
        control=None,
        device=None,
    ):
        self.cfg = config
        self.device = resolve_device(device)
        self.ndjson = ndjson
        self.pcap = pcap
        self.text_fh = text_fh or sys.stdout
        self.quiet_text = quiet_text
        self.control = control          # stream.control.ControlServer
        self.pkt_count = 0
        self.packets: list[PacketEvent] = []
        self.channel = config.channel
        self.access_addr = config.access_addr
        self.crc_init_internal = C.crc_init_reorder(config.crc_init)
        self.hop_tracker = HopTracker() if config.hop else None
        self._last_pkt_us = 0
        if config.rotate_channels and config.hop:
            raise ValueError("rotate_channels and hop are mutually exclusive")
        self._rotate_idx = 0
        self._dwell_start_us = 0
        self.blocks = 0                 # blocks processed: a span's block
        if config.rotate_channels:
            self.channel = config.rotate_channels[0]

    # ------------------------------------------------------------------
    def run(self, source, offset: int = 0, skip: int = 0):
        """Consume a sample source to exhaustion, emitting events.

        ``offset`` is the absolute sample index of the source's first
        sample and ``skip`` the lattice positions of its first block that
        packets already consumed: both non-zero when this sniffer continues
        a stream another sniffer scanned so far (convert.sniffer_from_state).
        """
        from ..spec.channels import channel_to_freq_hz

        if self.ndjson:
            self.ndjson.status(time.time(), "start", "file", self.channel,
                               channel_to_freq_hz(self.channel))
        it = OverlapBlockIterator(source, self.cfg.sps, lag=1, scan_len=self.cfg.scan_len)
        it._offset, it._skip = int(offset), int(skip)
        try:
            for block in it:
                if self.control is not None:
                    # live retune between blocks (ble_send_cmd parity):
                    # the block boundary is this runtime's analog of the
                    # board's register-write instant
                    self.control.apply(self)
                self._process_block(block, it)
        finally:
            if self.ndjson:
                self.ndjson.status(time.time(), "stop", "file", self.channel,
                                   channel_to_freq_hz(self.channel))
        return self.packets

    # ------------------------------------------------------------------
    def _process_block(self, block, it):
        with span("sniffer.block", block=self.blocks):
            self.blocks += 1
            cfg = self.cfg
            res = stream_decode(
                block.i, block.q, self.channel,
                access_address=self.access_addr,
                crc_init_table=self.crc_init_internal,
                aa_mask_hex=cfg.access_mask_hex,
                sps=cfg.sps,
                scan_limit=block.scan_len,
                raw=cfg.raw,
                rssi=cfg.rssi,
                start=block.skip,
                device=self.device,
            )
            with span("sniffer.handle"):
                self._handle_block(block, it, res)

    def _handle_block(self, block, it, res):
        """A decoded block's packets, the iterator's consumed boundary,
        and the hop / rotate bookkeeping."""
        cfg = self.cfg
        # decode-time receive config: hop retunes apply from the NEXT
        # block (the whole block was decoded with one channel, matching
        # the C tool where receiver_controller runs after receiver())
        block_channel = self.channel
        block_aa = self.access_addr
        now_us = 0
        for pkt in res.packets:
            now_us = (block.offset + pkt.sample_pos) // cfg.samples_per_us
            self._handle_packet(pkt, now_us, block_channel, block_aa)
        if cfg.verbose and not self.quiet_text:
            for bad in res.bad_headers:
                print(
                    f"PktBAD Ch{block_channel} AA:{block_aa:08x} "
                    f"PloadL{bad.payload_len} (ADV length out of 6..37)",
                    file=self.text_fh,
                )
        it.consume_to(block.offset + res.consumed)
        end_us = (block.offset + block.scan_len) // cfg.samples_per_us
        if self.hop_tracker:
            self.hop_tracker.on_tick(end_us)
            self._sync_hop_state()
        elif cfg.rotate_channels:
            self._maybe_rotate(end_us)

    # ------------------------------------------------------------------
    def _maybe_rotate(self, now_us: int):
        """Dwell rotation on the sample clock: like the reference scan's
        rotating capture, but the retune instant is a block boundary."""
        if now_us - self._dwell_start_us < self.cfg.dwell_ms * 1000:
            return
        self._dwell_start_us = now_us
        self._rotate_idx = (self._rotate_idx + 1) % len(self.cfg.rotate_channels)
        self.channel = self.cfg.rotate_channels[self._rotate_idx]
        if self.ndjson:
            from ..spec.channels import channel_to_freq_hz

            self.ndjson.status(time.time(), "retune", "file", self.channel,
                               channel_to_freq_hz(self.channel))

    # ------------------------------------------------------------------
    def _handle_packet(self, pkt, now_us: int, channel: int | None = None,
                       access_addr: int | None = None):
        cfg = self.cfg
        channel = self.channel if channel is None else channel
        access_addr = self.access_addr if access_addr is None else access_addr
        self.pkt_count += 1
        adv = channel in (37, 38, 39)

        if cfg.raw:
            ev = PacketEvent(now_us, self.pkt_count, channel, access_addr,
                             False, adv, None, None, b"", pkt.rssi_dbm,
                             raw_bytes=bytes(pkt.pdu_bytes))
            self.packets.append(ev)
            if not self.quiet_text:
                self._print_raw(ev)
            return

        payload_bytes = bytes(pkt.pdu_bytes[2:])
        if adv:
            header = parse_adv_header(pkt.pdu_bytes[:2])
            try:
                payload = parse_adv_payload(payload_bytes, header.pdu_type)
            except ValueError:
                payload = None
            # hop bookkeeping happens BEFORE output filters, like the
            # reference fills receiver_status during parsing regardless of
            # what gets printed (btle_rx.c:1683-1698, 2304-2356)
            if (pkt.crc_ok and payload is not None and self.hop_tracker
                    and header.pdu_type == AdvPduType.CONNECT_REQ):
                self.hop_tracker.on_connect_req(
                    ConnectionInfo(payload.aa, payload.crc_init, payload.hop,
                                   payload.interval, payload.chm),
                    now_us,
                )
            if (cfg.filter_pdu_mask >> int(header.pdu_type)) & 1 == 0:
                return
            if payload is None:
                return
            adv_a = extract_adv_a(payload, header.pdu_type)
            if cfg.filter_adva is not None and adv_a is not None and adv_a != cfg.filter_adva:
                return
        else:
            header = parse_ll_header(pkt.pdu_bytes[:2])
            if pkt.crc_ok and self.hop_tracker:
                self.hop_tracker.on_crc_ok_packet(now_us)
            try:
                payload = parse_ll_payload(payload_bytes, header.llid)
            except ValueError:
                return
            if pkt.crc_ok and self.hop_tracker and payload.ctrl is not None:
                # live map/interval updates keep the follow alive past
                # LL_CHANNEL_MAP_REQ / LL_CONNECTION_UPDATE_REQ (the
                # reference parses these but never applies them)
                self.hop_tracker.on_ll_ctrl(payload.ctrl.opcode,
                                            payload.ctrl.fields, now_us)
            if cfg.filter_adva is not None:
                return  # data PDUs carry no AdvA (btle_rx.c:2353-2356)
            adv_a = None

        ev = PacketEvent(now_us, self.pkt_count, channel, access_addr,
                         pkt.crc_ok, adv, header, payload, payload_bytes,
                         pkt.rssi_dbm)
        self.packets.append(ev)

        if self.pcap:
            self.pcap.write_packet(bytes(pkt.pdu_bytes), channel,
                                   access_addr, pkt.rssi_dbm)
        if not self.quiet_text:
            self._print_packet(ev, adv_a)
        if self.ndjson:
            ts = time.time()
            if adv:
                self.ndjson.pkt_adv(ts, self.pkt_count, channel, access_addr,
                                    pkt.crc_ok, int(header.pdu_type),
                                    header.pdu_type.display_name,
                                    header.tx_add, header.rx_add, header.payload_len,
                                    adv_a, payload_bytes, pkt.rssi_dbm)
            else:
                self.ndjson.pkt_data(ts, self.pkt_count, channel, access_addr,
                                     pkt.crc_ok, int(header.llid),
                                     header.llid.display_name,
                                     header.nesn, header.sn, header.md,
                                     header.payload_len, payload_bytes, pkt.rssi_dbm)

    # ------------------------------------------------------------------
    def apply_control_registers(self, writes):
        """Register map of ble_send_cmd.c:340-363; unknown registers are
        ignored here (the ControlServer retains them)."""
        from .control import REG_ACCESS_ADDR, REG_CHANNEL, REG_CRC_INIT

        for idx, val in writes:
            if idx == REG_CHANNEL:
                self.channel = int(val)
            elif idx == REG_ACCESS_ADDR:
                self.access_addr = int(val)
            elif idx == REG_CRC_INIT:
                self.crc_init_internal = C.crc_init_reorder(int(val))

    # ------------------------------------------------------------------
    def _sync_hop_state(self):
        t = self.hop_tracker
        if t is None:
            return
        changed = t.channel != self.channel or t.access_addr != self.access_addr
        self.channel = t.channel
        self.access_addr = t.access_addr
        self.crc_init_internal = t.crc_init_internal
        if changed and self.ndjson and t.events:
            e = t.events[-1]
            self.ndjson.hop(time.time(), e.event, e.state_from, e.state_to,
                            e.channel, e.freq_hz // 1_000_000, e.access_addr,
                            e.crc_init, e.interval_us, e.hop, e.chm)

    # ------------------------------------------------------------------
    def _print_packet(self, ev: PacketEvent, adv_a):
        dt = ev.ts_us - self._last_pkt_us
        self._last_pkt_us = ev.ts_us
        h = ev.header
        if ev.is_adv:
            line = (
                f"{dt:07d}us Pkt{ev.pkt_count:03d} Ch{ev.channel} "
                f"AA:{ev.access_addr:08x} ADV_PDU_t{int(h.pdu_type)}:"
                f"{h.pdu_type.display_name} T{h.tx_add} R{h.rx_add} "
                f"PloadL{h.payload_len}"
            )
            if adv_a is not None:
                line += " AdvA:" + adv_a.hex()
        else:
            line = (
                f"{dt:07d}us Pkt{ev.pkt_count:03d} Ch{ev.channel} "
                f"AA:{ev.access_addr:08x} LL_PDU_t{int(h.llid)}:"
                f"{h.llid.display_name} NESN{h.nesn} SN{h.sn} MD{h.md} "
                f"PloadL{h.payload_len}"
            )
        line += " CRC" + ("0" if ev.crc_ok else "1")
        if ev.rssi_dbm is not None:
            line += f" RSSI{ev.rssi_dbm}"
        print(line, file=self.text_fh)

    def _print_raw(self, ev: PacketEvent):
        print(
            f"Pkt{ev.pkt_count} Ch{ev.channel} AA:{ev.access_addr:08x} "
            "Raw:" + ev.raw_bytes.hex(),
            file=self.text_fh,
        )


def sniff_file(path: str, fmt: str = "i16", device=None, **cfg_kwargs):
    """One-call file decode: returns the packet event list."""
    from .sources import iq_file_source

    cfg = SnifferConfig(**cfg_kwargs)
    sniffer = Sniffer(cfg, quiet_text=True, device=device)
    return sniffer.run(iq_file_source(path, fmt))
