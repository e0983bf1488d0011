"""Multi-device sharding of the wideband pipeline over a (ch, time) mesh.

Port of btle_tpu/dist/shard.py (BASELINE config 5). The JAX program is
one ``shard_map`` over a ("ch", "time") device mesh driven from a single
controller; here each device is one process of a ``torch.distributed``
group (NCCL on cards, gloo on CPUs — the caller names the backend and the
device type, and nothing switches either on its own), and every rank runs
the same steps on its own shard:

* ``time`` axis — the IQ stream is split into contiguous time blocks.
  Each rank receives the head of its right neighbour's shard (packets
  crossing its right boundary) and the filter context from the tail of
  its left neighbour's shard (real history, so packets starting at its
  left boundary see no warm-up), by ``batch_isend_irecv`` inside the
  "time" group — the JAX program's four ``ppermute``s. The head is zero
  on the last time shard and the context zero on the first.

* ``ch`` axis — the polyphase channelizer is branch-split: each rank
  convolves only its group of polyphase branches (disjoint taps of the
  prototype filter) and contributes a partial 40-point DFT, completed by
  ``all_reduce`` over the "ch" group (the JAX ``psum``); each rank then
  decodes its own channel group through ``rx.pipeline.decode_block``
  (the scan kernel K7 and the candidate decode K4 on a card).

* ``fused=True`` (time-parallel only) — each rank runs the whole
  40-channel fused front end, ``wideband_scan_fused`` (K1 at "bf16x2w" or
  K3 at "f32", then K2 and K4 on a card), on its shard.

A step's per-rank candidate arrays are packed into one int32 vector and
gathered over "ch" and then over "time", so ``__call__`` returns the
global arrays, shaped (n_time, M, max_candidates, ...), on every rank;
``gather_packets`` runs the same host walk on every rank (span-eating
cursors, the slot-overflow rescan, connection following).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..rx.pipeline import decode_block, pack_candidates, required_halo
from ..spec import bits as B
from ..spec import crc24 as C
from ..spec import whitening as W
from ..wideband.channelizer import (DEFAULT_TAPS, D, M, _dft_matrix,
                                    _poly_kernel, bin_to_channel,
                                    branch_columns, true_fp32)


def _branch_split_plan(num_taps: int, cutoff_mhz: float = 1.0):
    """Per-rank polyphase conv plan for a contiguous branch group.

    Rank g owns branches p in [g*chunk, (g+1)*chunk). In the polyphase
    form (channelizer._poly_kernel) each branch reads ONE decimated
    column c(p); the group's conv is a groups=chunk conv over its
    gathered columns (duplicate gathers are fine) — M/n_ch x L/M MACs per
    output frame instead of the dense L-wide window. Returns flat (cols
    (M,), kernels (M, 1, width)) in branch order; a rank slices its
    contiguous chunk.
    """
    kern, row_of_p = _poly_kernel(num_taps, cutoff_mhz)
    cols = branch_columns()
    kernels = kern[row_of_p, 0][:, None, :].astype(np.float32)
    return cols, kernels


CH_SPS = 4
# Symbol-lag phase-difference decisions (the golden model's demod,
# btlelib.py:395-400): after the channelizer's 1 MHz lowpass this reaches
# the reference BER anchors (~11 dB @ 0 ppm), ~2 dB better than the C
# tool's 1-sample lag.
CH_LAG = 4
MESH_DIMS = ("ch", "time")


def make_mesh(n_ch: int, n_time: int, device_type: str = "cuda"):
    """The ("ch", "time") device mesh over the ranks of the default
    process group (``torch.distributed.init_process_group`` first, or
    ``init_distributed`` for several processes)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "torch.distributed.init_process_group first (world_size=1 "
                           "for one process)")
    world = dist.get_world_size()
    if world < n_ch * n_time:
        raise ValueError(f"need {n_ch * n_time} devices, have {world}")
    return init_device_mesh(device_type, (n_ch, n_time), mesh_dim_names=MESH_DIMS)


def mesh_device(mesh) -> torch.device:
    """This rank's device in ``mesh``: the current CUDA device of a
    "cuda" mesh, else the mesh's device type."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class ShardedWidebandScan:
    """Multi-device wideband scan; every rank of ``mesh`` constructs it and
    calls it with the same arguments.

    Call with (i_wb, q_wb) of shape (n_time * block_wb,); returns global
    candidate arrays of shape (n_time, M, max_candidates, ...) on every
    rank, as tensors on this rank's device.
    """

    def __init__(self, mesh, block_wb: int, num_taps: int = DEFAULT_TAPS,
                 max_candidates: int = 16,
                 access_address_hex: str = "D6BE898E",
                 crc_init_hex: str = "555555",
                 fused: bool = False, fused_tile: int | None = None,
                 fused_dtype: str = "bf16x2w",
                 phy: str = "1m", cutoff_mhz: float | None = None):
        # LE PHY ("1m" | "2m"): BLE 5 keeps the 2 MHz channel grid, so
        # 2M only changes the per-channel samples/symbol (2). Time
        # bookkeeping stays CH_SPS (channel samples per us at 4 Msps).
        from ..wideband.sniffer import ch_sps_for_phy, cutoff_for_phy

        self.phy = phy
        self._sps = ch_sps_for_phy(phy)
        self._lag = self._sps
        self.cutoff_mhz = (cutoff_mhz if cutoff_mhz is not None
                           else cutoff_for_phy(phy))
        self.n_ch = mesh.size(0)
        self.n_time = mesh.size(1)
        if M % self.n_ch:
            raise ValueError("channel-axis size must divide 40")
        if block_wb % D:
            raise ValueError("block_wb must be a multiple of the decimation")
        # the fused per-rank pipeline runs all 40 channels on its time
        # shard, so its mesh is pure time-parallel
        if fused and self.n_ch != 1:
            raise ValueError("fused sharding is time-parallel (n_ch must be 1)")
        self.fused = fused
        self.fused_tile = fused_tile
        # WidebandConfig.fused_dtype's knob: "bf16x2w" (the shipped
        # default) or "f32" (the exact parity mode)
        self.fused_dtype = fused_dtype
        self.block_wb = block_wb
        self.num_taps = num_taps
        self.max_candidates = max_candidates
        self.halo_ch = required_halo(self._sps, self._lag)
        self.halo_wb = self.halo_ch * D + num_taps
        # the arguments are checked above, before the group is touched
        self.mesh = mesh
        self.device = mesh_device(mesh)
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        self.c_idx, self.t_idx = coord

        dev = self.device
        aa_adv = B.hex_to_bits(access_address_hex)
        crc = C.lfsr_init_to_table_init(crc_init_hex)
        self._set_tables(np.tile(aa_adv, (M, 1)), np.full(M, crc, np.int32))
        self.aa_mask = torch.ones(32, dtype=torch.int8, device=dev)
        cols, kernels = _branch_split_plan(num_taps, self.cutoff_mhz)
        self.branch_cols = torch.as_tensor(cols, dtype=torch.long, device=dev)
        self.kernel = torch.as_tensor(kernels, device=dev)               # (M, 1, W)
        self.dft_r, self.dft_i = (torch.as_tensor(a, device=dev) for a in _dft_matrix())
        self.whiten_rows = torch.as_tensor(np.stack(
            [W.whitening_bits(bin_to_channel(m), 336) for m in range(M)]), device=dev)
        self.adv_flags = torch.as_tensor(
            np.array([bin_to_channel(m) in (37, 38, 39) for m in range(M)]), device=dev)

        # optional connection following (hop-pattern tracking across
        # shards): a CONNECT_REQ seen in gather_packets re-keys the
        # data-channel AA/CRC rows for subsequent steps
        self.follow_connections = False
        self.hop_tracker = None
        self.multi_follower = None
        self._follow_dirty = False
        self.connection = None
        self._stream_offset_ch = 0  # per-channel samples consumed so far
        # (time, channel) cells whose AA hits exceeded the candidate
        # slots; gather_packets RECOVERS them by rescanning the retained
        # wideband input from the consumed cursor (single-device sniffer
        # semantics) — the counter records rescans performed, and
        # on_truncate (if set) is called per overflow event
        self.truncated_cells = 0
        self.on_truncate = None      # callable(t, m, num_hits) | None
        ctx = num_taps - 1
        self._ctx_tail = (torch.zeros(ctx, device=dev), torch.zeros(ctx, device=dev))
        self._rescan_src = None

    def _set_tables(self, aa_rows, crc_inits):
        """The AA rows and CRC inits the next steps decode with: host
        copies and tensors on this rank's device."""
        self._aa_host = np.asarray(aa_rows, np.int8).copy()
        self._crc_host = np.asarray(crc_inits, np.int32).copy()
        self.aa_rows = torch.as_tensor(self._aa_host, device=self.device)
        self.crc_inits = torch.as_tensor(self._crc_host, device=self.device)

    # ------------------------------------------------------------------
    def _neighbour(self, dt: int) -> int:
        """Global rank of the time neighbour ``dt`` away on this ch row."""
        return int(self.mesh.mesh[self.c_idx, self.t_idx + dt])

    def _exchange(self, xi, xq):
        """The halo exchange along "time": (ctx_i, ctx_q, head_i, head_q),
        the left neighbour's last num_taps-1 samples and the right
        neighbour's first halo_wb samples (as much of them as a shard
        holds), zero at the stream's ends."""
        ctx, halo = min(self.num_taps - 1, xi.shape[0]), min(self.halo_wb, xi.shape[0])
        ctx_i, ctx_q = (torch.zeros(ctx, device=xi.device) for _ in range(2))
        head_i, head_q = (torch.zeros(halo, device=xi.device) for _ in range(2))
        group = self.mesh.get_group("time")
        ops = []
        if self.t_idx > 0:
            left = self._neighbour(-1)
            ops += [dist.P2POp(dist.isend, xi[:halo].contiguous(), left, group),
                    dist.P2POp(dist.isend, xq[:halo].contiguous(), left, group),
                    dist.P2POp(dist.irecv, ctx_i, left, group),
                    dist.P2POp(dist.irecv, ctx_q, left, group)]
        if self.t_idx < self.n_time - 1:
            right = self._neighbour(1)
            ops += [dist.P2POp(dist.irecv, head_i, right, group),
                    dist.P2POp(dist.irecv, head_q, right, group),
                    dist.P2POp(dist.isend, xi[-ctx:].contiguous(), right, group),
                    dist.P2POp(dist.isend, xq[-ctx:].contiguous(), right, group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return ctx_i, ctx_q, head_i, head_q

    def _branch_split(self, xi_h, xq_h) -> dict:
        """This rank's branch group: its polyphase conv and partial DFT,
        completed over "ch", then the decode of its channel group."""
        chunk = M // self.n_ch
        grp = slice(self.c_idx * chunk, (self.c_idx + 1) * chunk)
        # frame the padded stream into the D decimated columns (one extra
        # never-read left zero makes the length frame-aligned); the left
        # context supplies the real num_taps-1 history samples, so output
        # k aligns with xi[k*D]
        x = torch.nn.functional.pad(torch.stack([xi_h, xq_h]), (1, 0))
        frames = x.reshape(2, x.shape[1] // D, D)
        lhs = frames[:, :, self.branch_cols[grp]].transpose(1, 2)     # (2, chunk, J)
        with true_fp32():
            u = torch.nn.functional.conv1d(lhs.contiguous(), self.kernel[grp],
                                           groups=chunk)                 # (2, chunk, K)
            e_r, e_i = self.dft_r[:, grp], self.dft_i[:, grp]
            u_i, u_q = u[0], u[1]
            y = torch.stack([e_r @ u_i - e_i @ u_q, e_r @ u_q + e_i @ u_i])
        if self.n_ch > 1:
            dist.all_reduce(y, group=self.mesh.get_group("ch"))        # (2, M, K)
        k_idx = torch.arange(y.shape[2], device=y.device)
        m_idx = torch.arange(M, device=y.device)[:, None]
        sign = 1.0 - 2.0 * ((m_idx * k_idx) % 2).to(torch.float32)
        y = y * sign
        return decode_block(y[0, grp], y[1, grp], self.aa_rows[grp], self.aa_mask,
                            self.whiten_rows[grp], self.crc_inits[grp],
                            self.adv_flags[grp], sps=self._sps, lag=self._lag,
                            max_candidates=self.max_candidates)

    def _gather(self, out: dict) -> dict:
        """Every rank's (chunk, ...) candidate arrays -> the global
        (n_time, M, ...) arrays on every rank: one packed int32 vector
        gathered over "ch", then over "time"."""
        packed, layout = pack_candidates(out)
        for dim in ("ch", "time"):
            group = self.mesh.get_group(dim)
            parts = [torch.empty_like(packed)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, packed, group=group)
            packed = torch.stack(parts)
        # packed: (n_time, n_ch, L)
        full, off = {}, 0
        for k, (shape, dtype) in layout.items():
            n = int(np.prod(shape))
            seg = packed[..., off: off + n].reshape(self.n_time, self.n_ch, *shape)
            if dtype == np.float32:
                seg = seg.view(torch.float32)
            elif dtype == np.bool_:
                seg = seg.to(torch.bool)
            full[k] = seg.reshape(self.n_time, self.n_ch * shape[0], *shape[1:])
            off += n
        return full

    def run_placed(self, xi, xq) -> dict:
        """Run one step on this rank's time shard (block_wb float32
        samples on its device): the halo exchange, the scan, the gather —
        the benchmarking / per-host-ingest entry point."""
        ctx_i, ctx_q, head_i, head_q = self._exchange(xi, xq)
        xi_h = torch.cat([ctx_i, xi, head_i])
        xq_h = torch.cat([ctx_q, xq, head_q])
        if self.fused:
            from ..wideband.fused import wideband_scan_fused

            out = wideband_scan_fused(
                xi_h, xq_h, self.aa_rows, self.aa_mask, self.whiten_rows,
                self.crc_inits, self.adv_flags, sps=self._sps, lag=self._lag,
                max_candidates=self.max_candidates, num_taps=self.num_taps,
                has_context=True, tile=self.fused_tile,
                compute_dtype=self.fused_dtype, cutoff_mhz=self.cutoff_mhz,
                device=self.device)
        else:
            out = self._branch_split(xi_h, xq_h)
        return self._gather(out)

    def __call__(self, i_wb, q_wb) -> dict:
        n = self.n_time * self.block_wb
        if len(i_wb) != n:
            raise ValueError(f"expected {n} samples, got {len(i_wb)}")
        dev = self.device
        x = [torch.as_tensor(np.asarray(v, np.float32), device=dev)
             for v in (i_wb, q_wb)]
        # retain the super-block (plus the tail of the previous one as
        # left filter context) so gather_packets can rescan a channel
        # whose AA hits exceeded the candidate slots — the sharded analog
        # of the single-device sniffer's slot-exhaustion rescan
        ctx = self.num_taps - 1
        self._rescan_src = tuple(torch.cat([p, v]) for p, v in zip(self._ctx_tail, x))
        self._ctx_tail = tuple(v[-ctx:] for v in x)
        own = slice(self.t_idx * self.block_wb, (self.t_idx + 1) * self.block_wb)
        return self.run_placed(x[0][own], x[1][own])

    # ------------------------------------------------------------------
    def enable_connection_following(self, max_follow: int = 1,
                                    drop_after_intervals: int | None = None):
        """max_follow=1: reference-parity semantics (the first tracked
        connection keys EVERY data channel). max_follow>1: concurrent
        multi-connection following (ll.multifollow) — each connection
        owns the channel its hop sequence occupies. Re-keys take effect
        at the NEXT __call__ (super-block granularity); a connection that
        hops mid-super-block misses at most that dwell and re-syncs
        through its tracker's skip state."""
        self.follow_connections = True
        if max_follow > 1:
            from ..ll.multifollow import MultiConnectionFollower

            self.multi_follower = MultiConnectionFollower(
                self._aa_host, self._crc_host, max_connections=max_follow,
                drop_after_intervals=drop_after_intervals)
        else:
            from ..ll.hop import HopTracker

            self.hop_tracker = HopTracker()

    def _maybe_follow(self, pkt):
        """CONNECT_REQ -> re-key all data channels (wideband hears every
        data channel; the hop tracker only books the expected pattern)."""
        from ..wideband.sniffer import try_track_connection

        if not self.follow_connections:
            return
        # stream-absolute sample clock across successive __call__s
        now_us = (self._stream_offset_ch + pkt.sample_pos) // CH_SPS
        if self.multi_follower is not None:
            adv = pkt.channel in (37, 38, 39)
            if not adv and pkt.crc_ok and pkt.payload is None:
                # parse data PDUs so sniffed LL map/interval updates reach
                # the owning tracker (ll.hop.on_ll_ctrl), like the
                # single-device wideband sniffer's _attach_parse path
                from ..ll.pdu import parse_ll_header, parse_ll_payload

                try:
                    pkt.header = parse_ll_header(pkt.pdu_bytes[:2])
                    pkt.payload = parse_ll_payload(pkt.pdu_bytes[2:],
                                                   pkt.header.llid)
                except ValueError:
                    pass
            self._follow_dirty |= self.multi_follower.on_packet(pkt, adv, now_us)
            return
        res = try_track_connection(self.hop_tracker, pkt, now_us,
                                   self._aa_host, self._crc_host)
        if res is not None:
            self.connection = res[0]
            self._set_tables(res[1], res[2])

    def _rescan_cell(self, t: int, m: int, min_pos: int) -> dict:
        """Continue channel m's scan of time block t past ``min_pos``
        (per-channel samples relative to the block): one single-channel
        rescan (the plain channelizer, then K7 and K4 on a card) over the
        retained super-block slice, with the previous block's tail as
        left filter context — wideband.sniffer.rescan_channel's
        slot-exhaustion path."""
        from ..wideband.sniffer import rescan_channel

        ci, cq = self._rescan_src            # ctx + super-block samples
        ctx = self.num_taps - 1
        start = t * self.block_wb            # ctx-shifted == block - ctx
        need = ctx + self.block_wb + self.halo_wb
        si, sq = (torch.nn.functional.pad(v[start: start + need],
                                          (0, max(0, need - (v.shape[0] - start))))
                  for v in (ci, cq))
        out = rescan_channel(
            si, sq, m, self._gather_aa[m], self.aa_mask, self.whiten_rows[m],
            self._gather_crc[m], self.adv_flags[m], min_pos, sps=self._sps,
            lag=self._lag, max_candidates=self.max_candidates,
            num_taps=self.num_taps, has_context=True, cutoff_mhz=self.cutoff_mhz,
            device=self.device)
        return {k: _host(v) for k, v in out.items()}

    def gather_packets(self, out) -> list:
        """Host-side assembly: global packet list with per-channel
        span-eating across time blocks (same semantics as the
        single-device wideband sniffer). Candidate-slot overflow in a
        (time, channel) cell triggers a rescan of that cell (never a
        silent drop)."""
        from ..wideband.sniffer import WidebandPacket

        # snapshot the keys this walk decodes with (follow handling may
        # re-key the AA rows mid-walk for subsequent super-blocks)
        self._gather_aa = self.aa_rows
        self._gather_crc = self.crc_inits
        aa_np = self._aa_host

        pos = _host(out["pos"])               # (T, M, K)
        valid = _host(out["valid"])
        plen = _host(out["payload_len"])
        len_ok = _host(out["len_ok"])
        crc_ok = _host(out["crc_ok"])
        pdu = _host(out["pdu_bytes"])
        mag = _host(out["mag_mean"])
        num_hits = _host(out["num_hits"])
        k_per_block = self.block_wb // D

        # the keys THIS scan used (pcap PHDR AA per channel)
        chan_aa = [int.from_bytes(B.bits_to_bytes(aa_np[m]).tobytes(), "little")
                   for m in range(M)]

        packets = []
        cursors = np.zeros(M, dtype=np.int64)

        def consume_cell(t, m, row) -> bool:
            """Walk one (time, channel) cell's slots in stream order;
            True iff every slot filled AND more hits exist past them."""
            ch = bin_to_channel(m)
            adv = ch in (37, 38, 39)
            n_slots = len(row["pos"])
            for k in range(n_slots):
                if not row["valid"][k]:
                    return False
                p = int(row["pos"][k])
                if p >= k_per_block:
                    continue  # halo territory: owned by the next block
                abs_p = t * k_per_block + p
                if abs_p < cursors[m]:
                    continue
                if adv and not row["len_ok"][k]:
                    cursors[m] = abs_p + (32 + 16) * self._sps
                    continue
                pl = int(row["payload_len"][k])
                pkt = WidebandPacket(
                    ch, abs_p, pl, bool(row["crc_ok"][k]),
                    row["pdu_bytes"][k, : 2 + pl].astype(np.uint8),
                    float(row["mag_mean"][k]),
                    access_addr=chan_aa[m],
                )
                self._maybe_follow(pkt)
                packets.append(pkt)
                cursors[m] = abs_p + (32 + 16 + (pl + 3) * 8) * self._sps
            return int(row["num_hits"]) > n_slots

        for t in range(pos.shape[0]):
            for m in range(M):
                row = {"pos": pos[t, m], "valid": valid[t, m],
                       "payload_len": plen[t, m], "len_ok": len_ok[t, m],
                       "crc_ok": crc_ok[t, m], "pdu_bytes": pdu[t, m],
                       "mag_mean": mag[t, m], "num_hits": num_hits[t, m]}
                exhausted = consume_cell(t, m, row)
                # slot exhaustion: hits past the last slot were not
                # decoded — rescan this channel's time block from the
                # consumed cursor until the cell's territory is clean
                if exhausted and self.on_truncate is not None:
                    self.on_truncate(t, m, int(num_hits[t, m]))
                if exhausted and self._rescan_src is None:
                    # run_placed() without __call__ keeps no input to
                    # rescan from — count it loudly instead of dropping
                    # silently (bench paths checksum outputs only)
                    self.truncated_cells += 1
                    exhausted = False
                while exhausted and cursors[m] - t * k_per_block < k_per_block:
                    before = cursors[m]
                    self.truncated_cells += 1
                    more = self._rescan_cell(t, m, int(cursors[m] - t * k_per_block))
                    exhausted = consume_cell(t, m, more)
                    if cursors[m] == before:
                        break  # remaining hits are all in the halo
        self._stream_offset_ch += pos.shape[0] * k_per_block
        if self.multi_follower is not None:
            changed = self.multi_follower.on_tick(self._stream_offset_ch // CH_SPS)
            if changed or self._follow_dirty:
                self._set_tables(*self.multi_follower.tables())
                self._follow_dirty = False
        return packets
