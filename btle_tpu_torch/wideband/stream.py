"""Streaming runner for the wideband sniffer: NDJSON / pcap / live ingest.

Port of btle_tpu/wideband/stream.py. The reference's flagship mode is an
unbounded live loop — USB callback -> ring buffer -> half-buffer scan,
forever — with `--json` emitting the schema-v1 NDJSON events the whole
btle_cli application layer consumes (btle_rx.c:531-540, 2610-2676;
btle_json.h:5-40). This module gives the 40-channel sniffer the same two
properties:

  * WidebandStreamRunner emits schema-v1 ``pkt`` / ``hop`` / ``status``
    events per processed block (stream.ndjson is the shared emitter);
  * run_live() drives the sniffer from the native runtime's SPSC ring
    (runtime.IqRingBuffer + UdpIngest) indefinitely, with overlap-save
    block extraction and optional dispatch pipelining: block k is
    dispatched to the device while block k-1's results are fetched and
    consumed, hiding the host walk behind device compute
    (WidebandSniffer.scan_async / consume_scan), and block k+1 is read
    out of the ring on a reader thread meanwhile.

Candidate-slot exhaustion is not silent: every rescan the sniffer
performs surfaces as a ``status`` event (event="truncate") with the
running rescan count. With the LTK (``ltk``), ll/crypto.py's
SniffDecryptor keys each connection's session from its sniffed
LL_ENC_REQ/RSP and decrypts its data PDUs in-stream (host-side numpy
AES-CCM): ``plain:<hex>`` on the text line, ``plain_hex`` in NDJSON.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

import numpy as np

from ..ll.pdu import AdvHeader, extract_adv_a
from ..rx.pipeline import rssi_dbm_from_mag
from ..utils.profiling import count, span
from .channelizer import D
from .sniffer import WidebandPacket, WidebandSniffer


@dataclass
class StreamStats:
    blocks: int = 0
    packets: int = 0
    crc_ok: int = 0
    samples_wb: int = 0          # wideband samples consumed (territory)
    wall_s: float = 0.0
    dropped_pairs: int = 0       # ring overruns (live mode)
    truncate_rescans: int = 0

    @property
    def msps(self) -> float:
        return self.samples_wb / self.wall_s / 1e6 if self.wall_s else 0.0


class WidebandStreamRunner:
    """Per-block event emission around a WidebandSniffer.

    ndjson: stream.ndjson.NdjsonEmitter (or None)
    pcap:   stream.pcap.PcapWriter (or None) — CRC-OK packets only
    text_fh: file handle for the human-readable per-packet lines (None =
             no text)
    ltk:    long-term key (16 bytes) for passive decryption, or None
    """

    def __init__(self, sn: WidebandSniffer, ndjson=None, pcap=None,
                 text_fh=None, ltk: bytes | None = None):
        self.sn = sn
        self.ndjson = ndjson
        self.pcap = pcap
        self.text_fh = text_fh
        # optional passive decryption (ll.crypto.SniffDecryptor): with
        # the LTK, sessions key themselves from the sniffed
        # LL_ENC_REQ/RSP exchange and data PDUs decrypt in-stream
        self.decryptor = None
        if ltk is not None:
            from ..ll.crypto import SniffDecryptor

            self.decryptor = SniffDecryptor(ltk)
        self.pkt_count = 0
        self.mag_scale = 1.0        # RSSI calibration for integer inputs
        self.stats = StreamStats()
        self._hop_emitted = 0
        self._trunc_emitted = 0

    # ------------------------------------------------------------------
    def start(self, board: str = "wideband"):
        if self.ndjson:
            self.ndjson.status(time.time(), "start", board, -1, 0)

    def stop(self, board: str = "wideband", msg: str | None = None):
        if self.ndjson:
            self.ndjson.status(time.time(), "stop", board, -1, 0, msg=msg)

    # ------------------------------------------------------------------
    def process_block(self, i_wb, q_wb) -> list[WidebandPacket]:
        return self.consume(self.sn.scan_async(i_wb, q_wb))

    def consume(self, handle) -> list[WidebandPacket]:
        pkts = self.sn.consume_scan(handle)
        with span("consume.emit", block=handle.get("block", -1)):
            for p in pkts:
                self._emit_packet(p)
            self._emit_follow_events()
            self._emit_truncation()
            self.stats.blocks += 1
            self.stats.packets += len(pkts)
            self.stats.crc_ok += sum(1 for p in pkts if p.crc_ok)
            self.stats.samples_wb += self.sn.cfg.scan_len_ch * D
        return pkts

    # ------------------------------------------------------------------
    def _emit_packet(self, p: WidebandPacket):
        self.pkt_count += 1
        plain = (self.decryptor.on_packet(p)
                 if self.decryptor is not None else None)
        if self.text_fh is not None:
            line = (f"ch{p.channel:02d} pos{p.sample_pos} "
                    f"crc{'0' if p.crc_ok else '1'} "
                    f"plen{p.payload_len} " + bytes(p.pdu_bytes).hex())
            if plain is not None:
                line += f" plain:{plain.hex()}"
            print(line, file=self.text_fh)
        if self.pcap and p.crc_ok:
            # the PHDR carries the AA that keyed the channel at decode time
            # (under max_follow different data channels carry different
            # connections' AAs)
            self.pcap.write_packet(bytes(p.pdu_bytes), p.channel,
                                   p.access_addr)
        if not self.ndjson:
            return
        ts = time.time()
        rssi = rssi_dbm_from_mag(p.rssi_mag * self.mag_scale)
        payload_bytes = bytes(p.pdu_bytes[2:].astype(np.uint8))
        h = p.header
        if isinstance(h, AdvHeader):
            adv_a = (extract_adv_a(p.payload, h.pdu_type)
                     if p.payload is not None else None)
            self.ndjson.pkt_adv(
                ts, self.pkt_count, p.channel, p.access_addr, p.crc_ok,
                int(h.pdu_type), h.pdu_type.display_name, h.tx_add,
                h.rx_add, h.payload_len, adv_a, payload_bytes, rssi)
        elif h is not None:
            self.ndjson.pkt_data(
                ts, self.pkt_count, p.channel, p.access_addr, p.crc_ok,
                int(h.llid), h.llid.display_name, h.nesn, h.sn, h.md,
                h.payload_len, payload_bytes, rssi,
                plain_hex=plain.hex() if plain is not None else None)

    def follow_events(self) -> list:
        """The hop events of the sniffer's follower so far."""
        sn = self.sn
        return (sn.multi_follower.events if sn.multi_follower is not None
                else sn.hop_tracker.events if sn.hop_tracker is not None
                else [])

    def _emit_follow_events(self):
        events = self.follow_events()
        while self._hop_emitted < len(events):
            e = events[self._hop_emitted]
            self._hop_emitted += 1
            if self.ndjson:
                self.ndjson.hop(time.time(), e.event, e.state_from,
                                e.state_to, e.channel,
                                e.freq_hz // 1_000_000, e.access_addr,
                                e.crc_init, e.interval_us, e.hop, e.chm)

    def _emit_truncation(self):
        n = self.sn.truncated_channels
        if n > self._trunc_emitted:
            self.stats.truncate_rescans += n - self._trunc_emitted
            if self.ndjson:
                self.ndjson.status(
                    time.time(), "truncate", "wideband", -1, 0,
                    msg=f"candidate slots exhausted; {n} channel rescans "
                        f"total (packets recovered by rescan)")
            self._trunc_emitted = n

    # ------------------------------------------------------------------
    def run_capture(self, i_wb: np.ndarray, q_wb: np.ndarray
                    ) -> list[WidebandPacket]:
        """Scan a whole in-memory wideband capture block by block,
        emitting events per block (the finite-file analog of run_live)."""
        sn = self.sn
        step_wb = sn.cfg.scan_len_ch * D
        total = sn.wb_block_len
        packets = []
        t_start = time.perf_counter()
        for s in range(0, max(1, len(i_wb)), step_wb):
            blk_i = np.zeros(total, dtype=np.float32)
            blk_q = np.zeros(total, dtype=np.float32)
            seg_i = i_wb[s : s + total]
            blk_i[: len(seg_i)] = seg_i
            seg_q = q_wb[s : s + total]
            blk_q[: len(seg_q)] = seg_q
            packets.extend(self.process_block(blk_i, blk_q))
            if s + total >= len(i_wb):
                break
        self.stats.wall_s = time.perf_counter() - t_start
        return packets

    def run_live(self, ring, should_stop=None, pipeline: int = 2,
                 idle_sleep_s: float = 0.002, scale: float = 1.0,
                 control=None) -> StreamStats:
        """Unbounded live loop over a runtime.IqRingBuffer.

        The ring fills from any producer (runtime.UdpIngest, a file
        pump, an SDR callback); blocks of scan_len_ch*D wideband samples
        are consumed with halo_ch*D overlap-save context, the reference's
        half-buffer cadence scaled to 40 channels (btle_rx.c:223-238).
        ``pipeline`` > 1 keeps that many scans in flight
        (scan_async/consume_scan) so the host walk of one block overlaps
        the next block's device work; follow re-keying then lags by
        pipeline-1 blocks. should_stop() is polled before each read;
        control (stream.control.ControlServer) register writes are
        applied between blocks like the reference's live retune.
        ``scale`` converts the ring's int16 samples back to the
        producer's float range for RSSI (1/write-scale for f32
        producers).

        Block k+1 is copied out of the ring on a native reader thread
        (``ring.read_ahead``) while this thread dispatches block k and
        walks the blocks before it. Every block read is dispatched and
        consumed, a stop included, and the reader is joined before the
        call returns or raises.
        """
        sn = self.sn
        step = sn.cfg.scan_len_ch * D
        halo_wb = sn.halo_ch * D
        pending: deque = deque()
        reader = ring.read_ahead(step, halo_wb)

        def read_next() -> bool:
            """Start the next read unless should_stop(); its answer."""
            stop = should_stop() if should_stop is not None else False
            if not stop:
                # the block lands in the sniffer's staging slot, behind
                # the room its filter context takes
                reader.submit(sn.staging_views(np.int16))
            return stop

        t_start = time.perf_counter()
        try:
            stop = False
            while True:
                if not reader.busy:
                    stop = read_next()
                blk = None
                if reader.busy:
                    with span("run_live.read", block=sn.blocks_dispatched):
                        ready = reader.done()
                        blk = reader.take()
                    if ready and blk is not None:
                        count("read_ready")
                if blk is not None:
                    if control is not None:
                        writes = control.poll()
                        if writes:
                            sn.apply_control_registers(writes)
                    i16, q16 = blk
                    self.mag_scale = scale
                    pending.append(sn.scan_async(i16, q16))
                    # read block k+1 while block k-1 is walked
                    stop = read_next()
                    if len(pending) >= max(1, pipeline):
                        self.consume(pending.popleft())
                elif pending:
                    # no input ready: drain the in-flight backlog
                    self.consume(pending.popleft())
                elif stop:
                    break
                else:
                    with span("run_live.read", block=sn.blocks_dispatched):
                        time.sleep(idle_sleep_s)
        finally:
            reader.close()
        self.stats.wall_s = time.perf_counter() - t_start
        self.stats.dropped_pairs = ring.dropped
        return self.stats
