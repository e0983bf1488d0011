"""Wideband sniffer: channelize + decode all 40 BLE channels per block.

Port of btle_tpu/wideband/sniffer.py. One 80 Msps wideband IQ stream is
split by the polyphase channelizer and all 40 channels run the dense
receive pipeline per block on the device — the fused front end
(wideband.fused, hand-written CUDA kernels) or the plain torch path
that mirrors the JAX package's XLA path — and the host walks the tiny
candidate lists to apply per-channel span-eating and PDU parsing (the
walk ``wideband.walk`` shares with the sharded scan), and, with
``follow_connections``, re-keys data channels after a CONNECT_REQ
(one connection on every data channel, ``ll.hop``, or up to
``max_follow`` each on the channel its hop sequence occupies,
``ll.multifollow``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from ..rx.pipeline import (decode_block, pack_candidates, required_halo,
                           unpack_candidates)
from ..spec import bits as B
from ..spec import crc24 as C
from ..spec.constants import ADV_ACCESS_ADDRESS_HEX
from ..utils.profiling import count, span
from .channelizer import D, DEFAULT_TAPS, M, channelize
# the walk's names that callers import from this module stay importable here
from .walk import (ADV_CHANNELS, CH_LAG, CH_SPS, CUTOFF_MHZ_1M,  # noqa: F401
                   CUTOFF_MHZ_2M, CUTOFF_MHZ_2M_SENS, Rescan, ScanKeys,
                   WidebandPacket, ch_sps_for_phy, consume_row, cutoff_for_phy,
                   default_scan_tables, parse_packet, try_track_connection)

# control-register indices of the reference's command protocol
# (ble_send_cmd.c:340-363; btle_tpu.stream.control)
REG_ACCESS_ADDR = 10
REG_CRC_INIT = 12


def decode_channels(i_ch, q_ch, aa_rows, aa_mask, whiten_rows, crc_inits,
                    adv_flags, sps: int, lag: int, max_candidates: int = 8):
    """The dense block decoder over the (M, K) channel axis. aa_rows is
    (M, 32): each channel can search a different access address."""
    return decode_block(i_ch, q_ch, aa_rows, aa_mask, whiten_rows, crc_inits,
                        adv_flags, sps=sps, lag=lag,
                        max_candidates=max_candidates)


def wideband_scan(i_wb, q_wb, aa_rows, aa_mask, whiten_rows, crc_inits,
                  adv_flags, sps: int = CH_SPS, lag: int = CH_LAG,
                  max_candidates: int = 8, num_taps: int = DEFAULT_TAPS,
                  has_context: bool = False, cutoff_mhz: float = 1.0,
                  device=None):
    """80 Msps block -> 40-channel candidate arrays through the plain torch
    path (the JAX package's XLA path). aa_rows: (M, 32) per-channel
    access-address bits (or (32,), broadcast)."""
    dev = resolve_device(device)
    y_i, y_q = channelize(i_wb, q_wb, num_taps=num_taps,
                          has_context=has_context, cutoff_mhz=cutoff_mhz,
                          device=dev)
    aa_rows = as_tensor(aa_rows, dev)
    if aa_rows.ndim == 1:
        aa_rows = aa_rows.expand(M, 32)
    return decode_channels(y_i, y_q, aa_rows, as_tensor(aa_mask, dev),
                           as_tensor(whiten_rows, dev),
                           as_tensor(crc_inits, dev), as_tensor(adv_flags, dev),
                           sps, lag, max_candidates)


def rescan_channel(i_wb, q_wb, slot, aa_row, aa_mask, whiten_row, crc_init,
                   adv_flag, min_pos, sps: int = CH_SPS, lag: int = CH_LAG,
                   max_candidates: int = 8, num_taps: int = DEFAULT_TAPS,
                   has_context: bool = False, cutoff_mhz: float = 1.0,
                   device=None):
    """Continue the span-eating scan of ONE channel bin ``slot`` past
    ``min_pos``, for a block with more AA hits in a channel than candidate
    slots (the JAX package's sharded scan rescans its cells so;
    WidebandSniffer ``_rescan`` and the port's sharded scan batch a
    round's channels instead). Returns the candidate dict of that
    channel (no channel axis), as the JAX function does."""
    dev = resolve_device(device)
    # each table is the one row, broadcast over the bins: row ``slot`` is read
    tables = (as_tensor(aa_row, dev).expand(M, -1), as_tensor(aa_mask, dev),
              as_tensor(whiten_row, dev).expand(M, -1),
              as_tensor(crc_init, dev).reshape(1).expand(M),
              as_tensor(adv_flag, dev).reshape(1).expand(M))
    out = Rescan(i_wb, q_wb, tables, sps=sps, lag=lag,
                 max_candidates=max_candidates, num_taps=num_taps,
                 has_context=has_context, cutoff_mhz=cutoff_mhz,
                 device=dev).decode([int(slot)], [int(min_pos)])
    return {k: v[0] for k, v in out.items()}


# staging slots of one (dtype, length): the block just staged uploads from
# one while the ring fills another (run_live reads ahead), and a third
# frees the host from an upload that runs late; the handle keeps the
# device copy, not the slot, so three serve any pipeline depth
STAGING_SLOTS = 3


class _Slot:
    """A reused host buffer a block is staged in: row 0 I, row 1 Q, each
    the filter context, then the block. Pinned on a card, where ``done``
    is the CUDA event recorded after its last upload."""

    def __init__(self, host: torch.Tensor):
        self.host = host
        self.rows = host.numpy()
        self.done = torch.cuda.Event() if host.is_pinned() else None

    def free(self) -> bool:
        return self.done is None or self.done.query()

    def fits(self, dtype, n) -> bool:
        return self.rows.dtype == dtype and self.rows.shape[1] == n

    def holds(self, i_wb, q_wb, head: int) -> bool:
        """Whether (i_wb, q_wb) are this slot's rows past ``head``."""
        for row, a in zip(self.rows, (i_wb, q_wb)):
            want = row[head:]
            if not (isinstance(a, np.ndarray) and a.dtype == want.dtype
                    and a.shape == want.shape and a.strides == want.strides
                    and a.ctypes.data == want.ctypes.data):
                return False
        return True


@dataclass
class WidebandConfig:
    access_address_hex: str = ADV_ACCESS_ADDRESS_HEX
    crc_init_hex: str = "555555"
    follow_connections: bool = False  # sniff CONNECT_REQ -> listen on data channels
    # >1: follow up to N connections concurrently, each owning the data
    # channel its hop sequence currently occupies (ll.multifollow); 1 keeps
    # the reference's semantics: the first tracked connection keys every
    # data channel
    max_follow: int = 1
    # multi-follow only: unregister a connection after K intervals
    # without a CRC-OK packet (None = never, like the reference)
    drop_after_intervals: int | None = None
    max_candidates: int = 16
    scan_len_ch: int = 8192          # per-channel territory (samples @4 Msps)
    num_taps: int = DEFAULT_TAPS
    # CRC init (table form) of the data channels; None = crc_init_hex's
    data_crc_init_table: int | None = None
    # accepted for compatibility with the JAX config, which declares it
    # and reads it nowhere
    data_access_address_hex: str | None = None
    # fused front end (wideband.fused, the hand-written CUDA kernels); off
    # runs the plain torch path of the JAX package's XLA pipeline
    fused: bool = False
    # accepted for compatibility with the JAX config; the CUDA kernels
    # pick their own tiling and outputs do not depend on it
    fused_tile: int | None = None
    # "bf16x2w" (shipped default: bf16 hi/lo weight pair, bf16 operands) or
    # "f32" (the exact parity mode)
    fused_dtype: str = "bf16x2w"
    phy: str = "1m"
    # channel-filter passband (MHz); None = per-phy default
    cutoff_mhz: float | None = None

    def __post_init__(self):
        ch_sps_for_phy(self.phy)   # validates

    @property
    def resolved_cutoff_mhz(self) -> float:
        return (self.cutoff_mhz if self.cutoff_mhz is not None
                else cutoff_for_phy(self.phy))


class WidebandSniffer:
    """Streaming 40-channel sniffer over wideband blocks, on ``device``
    (cuda unless the caller passes another)."""

    def __init__(self, cfg: WidebandConfig | None = None, device=None):
        from ..ll.hop import HopTracker
        from ..ll.multifollow import MultiConnectionFollower

        self.cfg = cfg or WidebandConfig()
        cfg = self.cfg
        self.device = resolve_device(device)
        # the keys of the blocks dispatched from now on
        self.keys = ScanKeys.advertising(cfg.access_address_hex, cfg.crc_init_hex,
                                         self.device, cfg.data_crc_init_table)
        self._cursors = np.zeros(M, dtype=np.int64)   # per-channel span-eating
        self._offset_ch = 0                           # per-channel sample offset
        self._sps = ch_sps_for_phy(cfg.phy)
        self._lag = self._sps                         # symbol-lag decisions
        self.halo_ch = required_halo(self._sps, self._lag)
        # left context: real history samples fed to the channelizer so
        # packets starting right at a block boundary see no filter warm-up
        self._ctx_len = cfg.num_taps - 1
        self._ctx_i = np.zeros(self._ctx_len, np.float32)
        self._ctx_q = np.zeros(self._ctx_len, np.float32)
        self._slots: list[_Slot] = []   # least recently staged first
        self._lent: _Slot | None = None   # the slot staging_views handed out
        self.truncated_channels = 0   # candidate-capacity overflows seen
        self.blocks_dispatched = 0    # scan_async calls: a handle's "block"
        # connection following: the wideband receiver hears all 37 data
        # channels at once, so tracking a connection only swaps AA/CRC rows
        self.hop_tracker = None
        self.multi_follower = None
        if cfg.follow_connections:
            if cfg.max_follow > 1:
                self.multi_follower = MultiConnectionFollower(
                    self.keys.aa_host, self.keys.crc_host,
                    max_connections=cfg.max_follow,
                    drop_after_intervals=cfg.drop_after_intervals)
            else:
                self.hop_tracker = HopTracker()
        self.connection = None

    @property
    def wb_block_len(self) -> int:
        """Wideband samples to feed per process() call."""
        return (self.cfg.scan_len_ch + self.halo_ch) * D

    def load_state(self, cursors, offset_ch, ctx_i, ctx_q, aa_rows, crc_inits,
                   truncated_channels=0):
        """Continue a stream another sniffer (of this package or of the JAX
        package) has scanned so far: its span-eating cursors, channel-sample
        offset, filter context and AA / CRC-init rows, as numpy arrays."""
        ctx_i, ctx_q = np.asarray(ctx_i), np.asarray(ctx_q)
        if ctx_i.shape != (self._ctx_len,) or ctx_q.shape != (self._ctx_len,):
            raise ValueError(f"filter context must hold {self._ctx_len} samples")
        self._cursors = np.asarray(cursors, dtype=np.int64).copy()
        self._offset_ch = int(offset_ch)
        self._ctx_i, self._ctx_q = ctx_i.copy(), ctx_q.copy()
        self.keys = self.keys.rekey(aa_rows, crc_inits)
        self.truncated_channels = int(truncated_channels)

    def apply_control_registers(self, writes):
        """Live re-key from a control server: the AA / CRC registers
        (ble_send_cmd.c:340-363) re-key every DATA channel — the wideband
        receiver hears all 40 channels at once, so the reference's
        channel-retune register is a no-op here."""
        aa_rows = self.keys.aa_host.copy()
        crc_rows = self.keys.crc_host.copy()
        adv = self.keys.adv
        for idx, val in writes:
            if idx == REG_ACCESS_ADDR:
                aa_rows[~adv] = B.hex_to_bits(int(val).to_bytes(4, "little").hex())
            elif idx == REG_CRC_INIT:
                crc_rows[~adv] = C.crc_init_reorder(int(val))
        self.keys = self.keys.rekey(aa_rows, crc_rows)

    def selftest(self) -> dict:
        """Known-answer self-test of exactly this sniffer's pipeline and
        kernel configuration on its device (wideband.selftest). Raises
        WidebandSelfTestError on failure; returns the decoded
        {channel: position} map on success."""
        from .selftest import fused_selftest

        if self.cfg.fused:
            return fused_selftest(compute_dtype=self.cfg.fused_dtype,
                                  tile=self.cfg.fused_tile,
                                  phy=self.cfg.phy, device=self.device)
        return fused_selftest(pipeline="xla", phy=self.cfg.phy,
                              device=self.device)

    def _scan_kwargs(self) -> dict:
        return dict(sps=self._sps, lag=self._lag,
                    max_candidates=self.cfg.max_candidates,
                    num_taps=self.cfg.num_taps, has_context=True,
                    cutoff_mhz=self.cfg.resolved_cutoff_mhz,
                    device=self.device)

    def _fetch(self, packed):
        """Start the device-to-host copy of a packed vector: into pinned
        memory, non-blocking, with an event to wait on (CUDA); the tensor
        itself on the CPU."""
        if packed.device.type != "cuda":
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def process(self, i_wb, q_wb) -> list[WidebandPacket]:
        """Process one wideband block of wb_block_len samples. Successive
        calls must overlap by halo_ch*D wideband samples; filter history is
        carried internally."""
        return self.consume_scan(self.scan_async(i_wb, q_wb))

    def scan_async(self, i_wb, q_wb):
        """Dispatch the device scan of one block WITHOUT waiting for results.

        Returns an opaque handle for consume_scan(): the packed outputs'
        device-to-host copy is in flight behind a CUDA event, so a live
        loop can dispatch block k and consume block k-1 meanwhile. Handles
        MUST be consumed in dispatch order (the span-eating cursors advance
        per block). The handle's ``"block"`` is the block's dispatch
        sequence number, which the tracer's spans of the block carry."""
        k = self.blocks_dispatched
        self.blocks_dispatched += 1
        with span("scan_async", block=k):
            with span("scan_async.stage"):
                dxi, dxq = self._stage(i_wb, q_wb)
            with span("scan_async.launch"):
                args = (dxi, dxq, *self.keys.tables)
                if self.cfg.fused:
                    from .fused import wideband_scan_fused

                    out = wideband_scan_fused(*args, tile=self.cfg.fused_tile,
                                              compute_dtype=self.cfg.fused_dtype,
                                              **self._scan_kwargs())
                else:
                    out = wideband_scan(*args, **self._scan_kwargs())
                packed, layout = pack_candidates(out)
                host, done = self._fetch(packed)
        # the keys THIS scan used: a re-key makes new ones
        return {"host": host, "done": done, "layout": layout,
                "dxi": dxi, "dxq": dxq, "keys": self.keys, "block": k}

    def staging_views(self, dtype=np.int16):
        """Where a producer writes the next block: the I and Q rows, past
        the filter context, of a free staging slot, wb_block_len samples of
        ``dtype`` each. scan_async given exactly these views stages the
        block where it lies; until then they stay lent, and a later call
        returns them again."""
        dtype = np.dtype(dtype)
        head = len(self._ctx_i)
        lent = self._lent
        if lent is None or not lent.fits(dtype, head + self.wb_block_len):
            lent = self._lent = self._free_slot(dtype, head + self.wb_block_len)
        return lent.rows[0, head:], lent.rows[1, head:]

    def _free_slot(self, dtype, n) -> _Slot:
        """A staging slot of ``n`` samples of ``dtype`` whose last upload
        is done (not the lent one): a free one, a new one while there are
        fewer than STAGING_SLOTS, else the least recently staged once its
        upload ends."""
        fits = [s for s in self._slots if s is not self._lent and s.fits(dtype, n)]
        for s in fits:
            if s.free():
                return s
        if len(fits) < STAGING_SLOTS:
            # slots of another dtype or length are not reused once free
            self._slots = [s for s in self._slots
                           if s is self._lent or s.fits(dtype, n) or not s.free()]
            host = torch.empty((2, n), dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                               pin_memory=self.device.type == "cuda")
            self._slots.append(_Slot(host))
            return self._slots[-1]
        fits[0].done.synchronize()
        return fits[0]

    def _stage(self, i_wb, q_wb):
        """The block with the filter context before it, in a staging slot,
        uploaded in one copy; the context of the next block kept. A block
        in the lent slot's views is staged where it lies; any other input
        is copied into a slot once."""
        head = len(self._ctx_i)
        slot = self._lent
        if slot is not None and slot.holds(i_wb, q_wb, head):
            self._lent = None
        else:
            i_wb = np.asarray(i_wb)
            q_wb = np.asarray(q_wb)
            if i_wb.shape != q_wb.shape or i_wb.ndim != 1:
                raise ValueError("I and Q must be 1-D arrays of one length")
            # integer wire formats stay integer on the host->device link
            # (the cast runs on the device)
            dtype = i_wb.dtype if i_wb.dtype.kind in "iu" else np.dtype(np.float32)
            slot = self._free_slot(dtype, head + len(i_wb))
            count("stage_copies")
            slot.rows[0, head:] = i_wb
            slot.rows[1, head:] = q_wb
        self._slots.remove(slot)
        self._slots.append(slot)
        x = slot.rows
        if self._ctx_i.dtype != x.dtype:
            self._ctx_i = self._ctx_i.astype(x.dtype)
            self._ctx_q = self._ctx_q.astype(x.dtype)
        x[0, :head] = self._ctx_i
        x[1, :head] = self._ctx_q
        # the next block starts right after this block's territory
        step = self.cfg.scan_len_ch * D
        self._ctx_i = x[0, step : step + self._ctx_len].copy()
        self._ctx_q = x[1, step : step + self._ctx_len].copy()
        count("h2d_copies")
        if self.device.type != "cuda":
            dx = slot.host.clone()    # the slot is reused
        else:
            dx = slot.host.to(self.device, non_blocking=True)
            slot.done.record(torch.cuda.current_stream(self.device))
        return dx[0], dx[1]

    def _wait(self, host, done, layout):
        if done is not None:
            done.synchronize()
        return unpack_candidates(host.numpy(), layout)

    def consume_scan(self, handle) -> list[WidebandPacket]:
        """Wait for + walk one scan_async() handle (in dispatch order)."""
        with span("consume_scan", block=handle.get("block", -1)):
            with span("consume_scan.wait"):
                out = self._wait(handle["host"], handle["done"], handle["layout"])
            return self._walk(handle, out)

    def _walk(self, handle, out) -> list[WidebandPacket]:
        """The walk of one block's candidates: span-eating and parsing, a
        rescan of the channels whose slots overflowed, then following."""
        keys = handle["keys"]
        scan_limit = self.cfg.scan_len_ch
        found = [[] for _ in range(M)]     # each channel's packets, in order
        over = []
        for m in range(M):
            row = {k: v[m] for k, v in out.items()}
            # slot exhaustion: hits past the last slot were not decoded —
            # continue this channel's scan from the consumed cursor
            if (self._consume_channel(m, row, scan_limit, found[m], keys)
                    and self._cursors[m] - self._offset_ch < scan_limit):
                over.append(m)
        if over:
            self._rescan(handle, over, scan_limit, found)
        packets = [p for pkts in found for p in pkts]
        # the rescans read the handle's keys, so a re-key applies only to
        # later blocks and following may trail the walk
        for p in packets:
            self._maybe_follow(p, p.channel in ADV_CHANNELS)
        self._offset_ch += scan_limit
        if self.hop_tracker is not None:
            self.hop_tracker.on_tick(self._offset_ch // CH_SPS)
        if self.multi_follower is not None:
            # connections hop on their interval clocks: re-key each
            # connection's newly occupied channel for the next block
            if self.multi_follower.on_tick(self._offset_ch // CH_SPS):
                self._apply_follow_tables()
        return packets

    def _rescan(self, handle, over, scan_limit, found):
        """Continue the scan of each channel bin in ``over`` past its
        cursor, appending to ``found``: a round decodes the rows of every
        channel still pending in one call (``walk.Rescan``) and fetches
        them in one copy. A channel stays pending while its slots fill
        again and its cursor moves inside the territory."""
        rescan = Rescan(handle["dxi"], handle["dxq"], handle["keys"].tables,
                        **self._scan_kwargs())
        while over:
            self.truncated_channels += len(over)
            count("rescan_channels", len(over))
            before = [int(self._cursors[m]) for m in over]
            with span("consume_scan.rescan"):
                more = rescan.decode(over, [c - self._offset_ch for c in before])
                packed, layout = pack_candidates(more)
                more = self._wait(*self._fetch(packed), layout)
            pending = []
            for j, m in enumerate(over):
                row = {k: v[j] for k, v in more.items()}
                exhausted = self._consume_channel(m, row, scan_limit, found[m],
                                                  handle["keys"])
                # a cursor that did not move: the remaining hits are all in
                # the halo, which the next block's scan owns
                if (exhausted and self._cursors[m] != before[j]
                        and self._cursors[m] - self._offset_ch < scan_limit):
                    pending.append(m)
            over = pending

    def _consume_channel(self, m: int, row: dict, scan_limit: int,
                         packets: list[WidebandPacket], keys: ScanKeys) -> bool:
        """``consume_row`` over channel bin m's row from its cursor, each
        packet parsed (not yet followed); returns whether the row's slots
        overflowed."""
        n = len(packets)
        self._cursors[m], exhausted = consume_row(
            row, m, self._offset_ch, int(self._cursors[m]), scan_limit, self._sps,
            keys.aas[m], packets)
        for pkt in packets[n:]:
            parse_packet(pkt)
        return exhausted

    def _maybe_follow(self, pkt: WidebandPacket, adv: bool):
        """CONNECT_REQ handling + hop bookkeeping (follow_connections)."""
        now_us = pkt.sample_pos // CH_SPS
        if self.multi_follower is not None:
            if self.multi_follower.on_packet(pkt, adv, now_us):
                self._apply_follow_tables()
            return
        if self.hop_tracker is None:
            return
        if adv:
            res = try_track_connection(self.hop_tracker, pkt, now_us,
                                       self.keys.aa_host, self.keys.crc_host)
            if res is not None:
                self.connection = res[0]
                self.keys = self.keys.rekey(res[1], res[2])
        elif pkt.crc_ok:
            self.hop_tracker.on_crc_ok_packet(now_us)
            ctrl = getattr(pkt.payload, "ctrl", None)
            if ctrl is not None:
                # apply sniffed map/interval updates (ll.hop.on_ll_ctrl)
                self.hop_tracker.on_ll_ctrl(ctrl.opcode, ctrl.fields, now_us)

    def _apply_follow_tables(self):
        self.keys = self.keys.rekey(*self.multi_follower.tables())

    def run(self, i_wb: np.ndarray, q_wb: np.ndarray) -> list[WidebandPacket]:
        """Convenience: scan a whole in-memory wideband capture."""
        step_wb = self.cfg.scan_len_ch * D
        total = self.wb_block_len
        packets = []
        for s in range(0, max(1, len(i_wb)), step_wb):
            blk_i = np.zeros(total, dtype=np.float32)
            blk_q = np.zeros(total, dtype=np.float32)
            seg_i = i_wb[s : s + total]
            blk_i[: len(seg_i)] = seg_i
            seg_q = q_wb[s : s + total]
            blk_q[: len(seg_q)] = seg_q
            packets.extend(self.process(blk_i, blk_q))
            if s + total >= len(i_wb):
                break
        return packets
