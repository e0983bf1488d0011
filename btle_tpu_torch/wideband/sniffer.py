"""Wideband sniffer: channelize + decode all 40 BLE channels per block.

Port of btle_tpu/wideband/sniffer.py. One 80 Msps wideband IQ stream is
split by the polyphase channelizer and all 40 channels run the dense
receive pipeline per block on the device — the fused front end
(wideband.fused, hand-written CUDA kernels) or the plain torch path
that mirrors the JAX package's XLA path — and the host walks the tiny
candidate lists to apply per-channel span-eating and PDU parsing, and,
with ``follow_connections``, re-keys data channels after a CONNECT_REQ
(one connection on every data channel, ``ll.hop``, or up to
``max_follow`` each on the channel its hop sequence occupies,
``ll.multifollow``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from ..convert import scan_tables_from_numpy
from ..ll.pdu import parse_adv_header, parse_adv_payload, parse_ll_header, parse_ll_payload
from ..rx.pipeline import (decode_block, pack_candidates, required_halo,
                           unpack_candidates)
from ..spec import bits as B
from ..spec import crc24 as C
from ..spec import whitening as W
from ..spec.constants import ADV_ACCESS_ADDRESS_HEX
from ..utils.profiling import count, span
from .channelizer import D, DEFAULT_TAPS, M, bin_to_channel, channelize

CH_SPS = 4  # channelizer output is 4 Msps = 4 samples/symbol
# Symbol-lag phase-difference decisions (the golden model's demod,
# btlelib.py:395-400): after the channelizer's 1 MHz lowpass this reaches
# the reference BER anchors (~11 dB @ 0 ppm), ~2 dB better than the C
# tool's 1-sample lag.
CH_LAG = 4

# Per-phy channel-filter passband default (prototype_filter cutoff, MHz):
# the interference-robust 1.0 MHz at both PHYs; CUTOFF_MHZ_2M_SENS is the
# AWGN-sensitivity-optimized 2M option (see btle_tpu's sniffer and
# BER_CURVES.md for the measurements behind the choice).
CUTOFF_MHZ_1M = 1.0
CUTOFF_MHZ_2M = 1.0
CUTOFF_MHZ_2M_SENS = 1.2

# control-register indices of the reference's command protocol
# (ble_send_cmd.c:340-363; btle_tpu.stream.control)
REG_ACCESS_ADDR = 10
REG_CRC_INIT = 12


def cutoff_for_phy(phy: str) -> float:
    """Default channel-filter cutoff (MHz) for an LE PHY."""
    ch_sps_for_phy(phy)
    return CUTOFF_MHZ_2M if phy == "2m" else CUTOFF_MHZ_1M


def ch_sps_for_phy(phy: str) -> int:
    """Samples per SYMBOL in the 4 Msps channelizer output for an LE
    PHY — 4 at 1M, 2 at 2M (BLE 5 keeps the 2 MHz channel grid, so only
    the symbol rate changes)."""
    if phy not in ("1m", "2m"):
        raise ValueError(f"unknown phy {phy!r} (want '1m'|'2m')")
    return 2 if phy == "2m" else CH_SPS


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


def try_track_connection(hop_tracker, pkt, now_us, aa_rows, crc_inits):
    """CONNECT_REQ handling of the single-connection follower: book the
    connection with the hop tracker and, iff the tracker ACCEPTED it
    (state 0 -> tracking), return (conn, new_aa_rows, new_crc_inits) as
    numpy arrays with every data channel keyed to the connection;
    otherwise None. A later CONNECT_REQ while already tracking is
    ignored, like the reference's controller which only consumes
    receiver_status in state 0 (btle_rx.c:2414-2457)."""
    from ..ll.hop import ConnectionInfo
    from ..ll.pdu import AdvPduType

    if not (pkt.crc_ok and pkt.channel in (37, 38, 39)):
        return None
    try:
        hdr = parse_adv_header(pkt.pdu_bytes[:2])
        if hdr.pdu_type != AdvPduType.CONNECT_REQ:
            return None
        payload = parse_adv_payload(pkt.pdu_bytes[2:], hdr.pdu_type)
    except ValueError:
        return None
    conn = ConnectionInfo(payload.aa, payload.crc_init, payload.hop,
                          payload.interval, payload.chm)
    prev_state = hop_tracker.state
    hop_tracker.on_connect_req(conn, now_us)
    if not (prev_state == 0 and hop_tracker.state != 0):
        return None
    aa_bits = B.hex_to_bits(int(conn.access_addr).to_bytes(4, "little").hex())
    crc_tab = C.crc_init_reorder(conn.crc_init)
    new_aa = np.asarray(aa_rows).copy()
    new_crc = np.asarray(crc_inits).copy()
    for m in range(M):
        if bin_to_channel(m) not in (37, 38, 39):
            new_aa[m] = aa_bits
            new_crc[m] = crc_tab
    return conn, new_aa, new_crc


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
    y_i, y_q = channelize(i_wb, q_wb, num_taps=num_taps,
                          has_context=has_context, cutoff_mhz=cutoff_mhz,
                          device=dev)
    s = slice(int(slot), int(slot) + 1)
    out = decode_block(y_i[s], y_q[s], as_tensor(aa_row, dev)[None],
                       as_tensor(aa_mask, dev), as_tensor(whiten_row, dev)[None],
                       as_tensor(crc_init, dev).reshape(1),
                       as_tensor(adv_flag, dev).reshape(1), sps=sps, lag=lag,
                       max_candidates=max_candidates, min_pos=int(min_pos))
    return {k: v[0] for k, v in out.items()}


# staging slots of one (dtype, length): a block's upload reads its slot
# while the host stages the next ones, so two or three serve any pipeline
# depth (the handle keeps the device copy, not the slot)
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


def _rows(t, rows):
    """Rows ``rows`` of ``t`` as one tensor, stacked from row views (no
    index upload)."""
    return torch.stack([t[m] for m in rows])


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


@dataclass
class WidebandPacket:
    channel: int
    sample_pos: int                  # absolute per-channel sample index
    payload_len: int
    crc_ok: bool
    pdu_bytes: np.ndarray
    rssi_mag: float
    header: object | None = None
    payload: object | None = None
    # the access address whose correlator row decoded this packet
    access_addr: int = 0x8E89BED6


def _default_scan_arrays():
    aa_bits = B.hex_to_bits("d6be898e")
    aa_mask = np.ones(32, np.int8)
    whiten_rows = np.stack(
        [W.whitening_bits(bin_to_channel(m), 336) for m in range(M)])
    crc_inits = np.full(M, C.lfsr_init_to_table_init("555555"), np.int32)
    adv_flags = np.array([bin_to_channel(m) in (37, 38, 39) for m in range(M)])
    return aa_bits, aa_mask, whiten_rows, crc_inits, adv_flags


def default_scan_tables(device=None):
    """Standard advertising-scan tables for the 40-bin wideband scan, as
    tensors on ``device``: (aa_bits (32,), aa_mask (32,), whiten_rows
    (40, 336), crc_inits (40,), adv_flags (40,)) — ADV access address,
    all-care mask, per-channel whitening, 0x555555 CRC init, adv flags on
    37/38/39."""
    return scan_tables_from_numpy(*_default_scan_arrays(),
                                  device=resolve_device(device))


class WidebandSniffer:
    """Streaming 40-channel sniffer over wideband blocks, on ``device``
    (cuda unless the caller passes another)."""

    def __init__(self, cfg: WidebandConfig | None = None, device=None):
        from ..ll.hop import HopTracker
        from ..ll.multifollow import MultiConnectionFollower

        self.cfg = cfg or WidebandConfig()
        cfg = self.cfg
        self.device = resolve_device(device)
        _, mask, whiten, _, adv = _default_scan_arrays()
        aa = B.hex_to_bits(cfg.access_address_hex)
        crc_adv = C.lfsr_init_to_table_init(cfg.crc_init_hex)
        crc_data = (cfg.data_crc_init_table
                    if cfg.data_crc_init_table is not None else crc_adv)
        crc = np.where(adv, crc_adv, crc_data).astype(np.int32)
        (self.aa_rows, self.aa_mask, self.whiten_rows, self.crc_inits,
         self.adv_flags) = scan_tables_from_numpy(
            np.tile(aa, (M, 1)), mask, whiten, crc, adv, device=self.device)
        self._aa_host = np.tile(aa, (M, 1))           # host copy of aa_rows
        self._crc_host = crc                          # host copy of crc_inits
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
        self._aa_np = None            # per-block snapshot of aa_rows
        # connection following: the wideband receiver hears all 37 data
        # channels at once, so tracking a connection only swaps AA/CRC rows
        self.hop_tracker = None
        self.multi_follower = None
        if cfg.follow_connections:
            if cfg.max_follow > 1:
                self.multi_follower = MultiConnectionFollower(
                    self._aa_host, self._crc_host,
                    max_connections=cfg.max_follow,
                    drop_after_intervals=cfg.drop_after_intervals)
            else:
                self.hop_tracker = HopTracker()
        self.connection = None

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a new tensor on the device: on a card through
        pinned memory, non-blocking (no wait for the scans in flight,
        which keep the tensors they were given)."""
        count("h2d_copies")
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _set_tables(self, aa_rows, crc_inits):
        """Re-key: new AA-row / CRC-init tensors for the blocks dispatched
        from now on."""
        self._aa_host = np.asarray(aa_rows, np.int8).copy()
        self._crc_host = np.asarray(crc_inits, np.int32).copy()
        self.aa_rows = self._upload(self._aa_host)
        self.crc_inits = self._upload(self._crc_host)

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
        self._set_tables(aa_rows, crc_inits)
        self.truncated_channels = int(truncated_channels)

    def apply_control_registers(self, writes):
        """Live re-key from a control server: the AA / CRC registers
        (ble_send_cmd.c:340-363) re-key every DATA channel — the wideband
        receiver hears all 40 channels at once, so the reference's
        channel-retune register is a no-op here."""
        aa_rows = self._aa_host.copy()
        crc_rows = self._crc_host.copy()
        adv = _default_scan_arrays()[4]
        for idx, val in writes:
            if idx == REG_ACCESS_ADDR:
                aa_rows[~adv] = B.hex_to_bits(int(val).to_bytes(4, "little").hex())
            elif idx == REG_CRC_INIT:
                crc_rows[~adv] = C.crc_init_reorder(int(val))
        self._set_tables(aa_rows, crc_rows)

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
                args = (dxi, dxq, self.aa_rows, self.aa_mask, self.whiten_rows,
                        self.crc_inits, self.adv_flags)
                if self.cfg.fused:
                    from .fused import wideband_scan_fused

                    out = wideband_scan_fused(*args, tile=self.cfg.fused_tile,
                                              compute_dtype=self.cfg.fused_dtype,
                                              **self._scan_kwargs())
                else:
                    out = wideband_scan(*args, **self._scan_kwargs())
                packed, layout = pack_candidates(out)
                host, done = self._fetch(packed)
        # snapshot the keys THIS scan used
        return {"host": host, "done": done, "layout": layout,
                "dxi": dxi, "dxq": dxq,
                "aa_np": self._aa_host,
                "aa_rows": self.aa_rows, "crc_inits": self.crc_inits,
                "block": k}

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
        self._aa_np = handle["aa_np"]
        scan_limit = self.cfg.scan_len_ch
        found = [[] for _ in range(M)]     # each channel's packets, in order
        over = []
        for m in range(M):
            row = {k: v[m] for k, v in out.items()}
            # slot exhaustion: hits past the last slot were not decoded —
            # continue this channel's scan from the consumed cursor
            if (self._consume_channel(m, row, scan_limit, found[m])
                    and self._cursors[m] - self._offset_ch < scan_limit):
                over.append(m)
        if over:
            self._rescan(handle, over, scan_limit, found)
        packets = [p for pkts in found for p in pkts]
        # the rescans read the handle's tables, so a re-key applies only
        # to later blocks and following may trail the walk
        for p in packets:
            self._maybe_follow(p, p.channel in (37, 38, 39))
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
        cursor, appending to ``found``. The block is channelized once (the
        plain true-FP32 channelizer); each round decodes the rows of every
        channel still pending in one call and fetches them in one copy. A
        channel stays pending while its slots fill again and its cursor
        moves inside the territory."""
        y_i = y_q = None
        while over:
            self.truncated_channels += len(over)
            count("rescan_channels", len(over))
            before = [int(self._cursors[m]) for m in over]
            starts = [c - self._offset_ch for c in before]
            with span("consume_scan.rescan"):
                if y_i is None:
                    y_i, y_q = channelize(
                        handle["dxi"], handle["dxq"], num_taps=self.cfg.num_taps,
                        has_context=True, cutoff_mhz=self.cfg.resolved_cutoff_mhz,
                        device=self.device)
                # fill kernels take each value as an argument: no
                # host-to-device copy (an item assignment makes one)
                min_pos = torch.empty(len(over), dtype=torch.int32,
                                      device=self.device)
                for j, p in enumerate(starts):
                    min_pos[j].fill_(p)
                more = decode_block(
                    _rows(y_i, over), _rows(y_q, over),
                    _rows(handle["aa_rows"], over), self.aa_mask,
                    _rows(self.whiten_rows, over), _rows(handle["crc_inits"], over),
                    _rows(self.adv_flags, over), sps=self._sps, lag=self._lag,
                    max_candidates=self.cfg.max_candidates, min_pos=min_pos)
                packed, layout = pack_candidates(more)
                more = self._wait(*self._fetch(packed), layout)
            pending = []
            for j, m in enumerate(over):
                row = {k: v[j] for k, v in more.items()}
                exhausted = self._consume_channel(m, row, scan_limit, found[m])
                # a cursor that did not move: the remaining hits are all in
                # the halo, which the next block's scan owns
                if (exhausted and self._cursors[m] != before[j]
                        and self._cursors[m] - self._offset_ch < scan_limit):
                    pending.append(m)
            over = pending

    def _channel_aa(self, m: int) -> int:
        """The access address currently keying channel bin m."""
        if self._aa_np is None:
            self._aa_np = self._aa_host
        return int.from_bytes(
            B.bits_to_bytes(self._aa_np[m]).tobytes(), "little")

    def _consume_channel(self, m: int, row: dict, scan_limit: int,
                         packets: list[WidebandPacket]) -> bool:
        """Walk one channel's candidate slots in stream order, appending
        parsed packets (not yet followed) and advancing the span-eating
        cursor. Returns True when every slot was filled AND more hits exist
        past them (the caller should rescan from the cursor)."""
        ch = bin_to_channel(m)
        adv = ch in (37, 38, 39)
        pos, valid = row["pos"], row["valid"]
        for k in range(len(pos)):
            if not valid[k]:
                return False
            p = int(pos[k])
            abs_p = self._offset_ch + p
            if p >= scan_limit or abs_p < self._cursors[m]:
                continue
            if adv and not row["len_ok"][k]:
                self._cursors[m] = abs_p + (32 + 16) * self._sps
                continue
            pl = int(row["payload_len"][k])
            pkt = WidebandPacket(
                ch, abs_p, pl, bool(row["crc_ok"][k]),
                row["pdu_bytes"][k, : 2 + pl].astype(np.uint8),
                float(row["mag_mean"][k]),
                access_addr=self._channel_aa(m),
            )
            self._attach_parse(pkt, adv)
            packets.append(pkt)
            self._cursors[m] = abs_p + (32 + 16 + (pl + 3) * 8) * self._sps
        return int(row["num_hits"]) > len(pos)

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
                                       self._aa_host, self._crc_host)
            if res is not None:
                self.connection = res[0]
                self._set_tables(res[1], res[2])
        elif pkt.crc_ok:
            self.hop_tracker.on_crc_ok_packet(now_us)
            ctrl = getattr(pkt.payload, "ctrl", None)
            if ctrl is not None:
                # apply sniffed map/interval updates (ll.hop.on_ll_ctrl)
                self.hop_tracker.on_ll_ctrl(ctrl.opcode, ctrl.fields, now_us)

    def _apply_follow_tables(self):
        self._set_tables(*self.multi_follower.tables())

    def _attach_parse(self, pkt: WidebandPacket, adv: bool):
        try:
            if adv:
                pkt.header = parse_adv_header(pkt.pdu_bytes[:2])
                pkt.payload = parse_adv_payload(pkt.pdu_bytes[2:], pkt.header.pdu_type)
            else:
                pkt.header = parse_ll_header(pkt.pdu_bytes[:2])
                pkt.payload = parse_ll_payload(pkt.pdu_bytes[2:], pkt.header.llid)
        except ValueError:
            pkt.payload = None

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
