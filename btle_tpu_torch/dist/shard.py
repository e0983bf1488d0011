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
gathered over "ch" and then over "time", so a step returns the global
arrays, shaped (n_time, M, max_candidates, ...), on every rank;
``gather_packets`` runs the same host walk on every rank (span-eating
cursors, the slot-overflow rescan, connection following), so every rank
hands on the same packets in the same order.

Two ways in:

* ``__call__`` takes a whole capture (every rank the same n_time blocks),
  the JAX program's semantics: the stream's ends are zero, positions are
  relative to the capture, cursors start afresh each call.
* ``run_placed`` is one step of the per-process stream, each rank fed
  only its own block (``multihost.MultiHostWidebandScan``): step k of
  rank (c, t) holds stream samples [(k * n_time + t) * block_wb, ...).
  It decodes as one unsharded stream at block_wb-sample blocks: the
  first time shard's context is the previous step's last num_taps-1
  samples (a wrap-around send from the last time shard), the last time
  shard's head is the lookahead its own ingest read (as ``run_live``'s
  ring read takes territory plus halo), cursors carry from step to step
  and ``sample_pos`` is the stream-absolute per-channel index.

A (time, channel) cell whose AA hits outnumber its slots is rescanned,
never dropped: the walk asks for every rescan it needs, the rank that
holds the cell's time block (and channel group) channelizes its shard
window once a step with the plain channelizer and decodes all of a
round's cells in one call, and one gather a round gives every rank the
results (``WidebandSniffer._rescan``'s rounds, over the mesh).

Spans and counters (``utils.profiling``; idle unless a tracer is on),
each span carrying its step: ``shard.ingest`` (multihost), ``shard.
exchange``, ``shard.scan``, ``shard.gather``, ``shard.walk`` (whose self
time is the walk) and, inside it, ``shard.rescan`` a round; the counters
``rescan_cells`` (equal to ``truncated_cells``), ``halo_bytes`` (sent in
the exchange), ``gather_bytes`` (received by the gathers) and
``h2d_copies``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..rx.pipeline import (PACK_KEYS, decode_block, pack_candidates,
                           required_halo, unpack_candidates)
from ..spec import bits as B
from ..spec import crc24 as C
from ..spec import whitening as W
from ..utils.profiling import count, span
from ..wideband.channelizer import (DEFAULT_TAPS, D, M, _dft_matrix,
                                    _poly_kernel, bin_to_channel,
                                    branch_columns, channelize, true_fp32)
from ..wideband.sniffer import (WidebandPacket, _rows, ch_sps_for_phy,
                                cutoff_for_phy, try_track_connection)


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
        # slots; gather_packets RECOVERS them by rescanning the cell's
        # shard window from the consumed cursor (single-device sniffer
        # semantics) — the counter records rescans performed, and
        # on_truncate (if set) is called per overflow event
        self.truncated_cells = 0
        self.on_truncate = None      # callable(t, m, num_hits) | None
        self.steps = 0               # steps run: the spans' step number
        self._stream = False         # the last step came through run_placed
        self._cursors = np.zeros(M, dtype=np.int64)  # the stream's, across steps
        self._wrap_ctx = None        # time shard 0's context for the next step
        self._last = None            # (the step's output, its host copy)
        self._window = None          # this rank's shard window (ctx + block + head)
        self._plain = None           # its plain channelization, once a step
        self._row_layout = None      # one (time, channel) cell of packed candidates

    def _set_tables(self, aa_rows, crc_inits):
        """The AA rows and CRC inits the next steps decode with: host
        copies and tensors on this rank's device."""
        self._aa_host = np.asarray(aa_rows, np.int8).copy()
        self._crc_host = np.asarray(crc_inits, np.int32).copy()
        self.aa_rows = torch.as_tensor(self._aa_host, device=self.device)
        self.crc_inits = torch.as_tensor(self._crc_host, device=self.device)

    # ------------------------------------------------------------------
    def _neighbour(self, dt: int) -> int:
        """Global rank of the time shard ``dt`` away on this ch row."""
        return int(self.mesh.mesh[self.c_idx, self.t_idx + dt])

    def _exchange(self, xi, xq, head=None, stream: bool = False):
        """The halo exchange along "time": (ctx_i, ctx_q, head_i, head_q),
        the left neighbour's last num_taps-1 samples and the right
        neighbour's first halo_wb samples (as much of them as a shard
        holds). At the stream's ends they are zero, except on the
        per-process stream (``stream``): there time shard 0's context is
        the previous step's last samples, which the last time shard sent
        it one step earlier, and the last time shard's head is ``head``
        (the lookahead its ingest read; zeros past what it holds)."""
        ctx, halo = min(self.num_taps - 1, xi.shape[0]), min(self.halo_wb, xi.shape[0])
        ctx_i, ctx_q = (torch.zeros(ctx, device=xi.device) for _ in range(2))
        head_i, head_q = (torch.zeros(halo, device=xi.device) for _ in range(2))
        first, last = self.t_idx == 0, self.t_idx == self.n_time - 1
        if stream and last and head is not None:
            for dst, src in zip((head_i, head_q), head):
                n = min(halo, src.shape[0])
                dst[:n] = src[:n]
        if stream and first and self._wrap_ctx is not None:
            ctx_i, ctx_q = self._wrap_ctx
        group = self.mesh.get_group("time")
        ops = []
        if not first:
            left = self._neighbour(-1)
            ops += [dist.P2POp(dist.isend, xi[:halo].contiguous(), left, group),
                    dist.P2POp(dist.isend, xq[:halo].contiguous(), left, group),
                    dist.P2POp(dist.irecv, ctx_i, left, group),
                    dist.P2POp(dist.irecv, ctx_q, left, group)]
        if not last:
            right = self._neighbour(1)
            ops += [dist.P2POp(dist.irecv, head_i, right, group),
                    dist.P2POp(dist.irecv, head_q, right, group),
                    dist.P2POp(dist.isend, xi[-ctx:].contiguous(), right, group),
                    dist.P2POp(dist.isend, xq[-ctx:].contiguous(), right, group)]
        if stream:
            # the last time shard's tail is time shard 0's next context
            # (posted after the neighbours' pair, in the same order on
            # both sides, so two shards that are both neighbours and wrap
            # partners match their messages)
            if self.n_time == 1:
                self._wrap_ctx = (xi[-ctx:].clone(), xq[-ctx:].clone())
            elif last:
                wrap = self._neighbour(-self.t_idx)
                ops += [dist.P2POp(dist.isend, xi[-ctx:].contiguous(), wrap, group),
                        dist.P2POp(dist.isend, xq[-ctx:].contiguous(), wrap, group)]
            elif first:
                self._wrap_ctx = tuple(torch.empty(ctx, device=xi.device) for _ in range(2))
                wrap = self._neighbour(self.n_time - 1)
                ops += [dist.P2POp(dist.irecv, v, wrap, group) for v in self._wrap_ctx]
        if ops:
            count("halo_bytes", sum(op.tensor.numel() * op.tensor.element_size()
                                    for op in ops if op.op is dist.isend))
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

    def _mesh_gather(self, x):
        """Every rank's ``x`` -> (n_time, n_ch, *x.shape) on every rank:
        all_gather over "ch", then over "time" (a size-1 axis costs no
        collective)."""
        for dim in ("ch", "time"):
            group = self.mesh.get_group(dim)
            n = dist.get_world_size(group)
            if n == 1:
                x = x[None]
                continue
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=group)
            count("gather_bytes", n * x.numel() * x.element_size())
            x = torch.stack(parts)
        return x

    def _split(self, packed, layout: dict, host: bool) -> dict:
        """The global (n_time, n_ch * chunk, ...) arrays of gathered
        packed vectors (n_time, n_ch, L): device tensors, or numpy arrays
        of the host copy."""
        full, off = {}, 0
        for k, (shape, dtype) in layout.items():
            n = int(np.prod(shape))
            seg = packed[..., off: off + n].reshape(self.n_time, self.n_ch, *shape)
            if dtype == np.float32:
                seg = seg.view(np.float32) if host else seg.view(torch.float32)
            elif dtype == np.bool_:
                seg = seg.astype(bool) if host else seg.to(torch.bool)
            full[k] = seg.reshape(self.n_time, self.n_ch * shape[0], *shape[1:])
            off += n
        return full

    def _gather(self, out: dict) -> dict:
        """Every rank's (chunk, ...) candidate arrays -> the global
        (n_time, M, ...) arrays on every rank: one packed int32 vector
        gathered over "ch", then over "time", and one host copy of it
        (so this waits for the slowest rank), which the walk reads."""
        packed, layout = pack_candidates(out)
        packed = self._mesh_gather(packed)                  # (n_time, n_ch, L)
        self._row_layout = {k: (shape[1:], dtype) for k, (shape, dtype) in layout.items()}
        full = self._split(packed, layout, host=False)
        self._last = (full, self._split(packed.cpu().numpy(), layout, host=True))
        return full

    def _step(self, xi, xq, head, stream: bool) -> dict:
        """One step on this rank's time block: the exchange, the scan,
        the gather."""
        k = self.steps
        self.steps += 1
        self._stream = stream
        with span("shard.exchange", block=k):
            ctx_i, ctx_q, head_i, head_q = self._exchange(xi, xq, head, stream)
        with span("shard.scan", block=k):
            xi_h = torch.cat([ctx_i, xi, head_i])
            xq_h = torch.cat([ctx_q, xq, head_q])
            # kept for the rescans of this rank's cells
            self._window, self._plain = (xi_h, xq_h), None
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
        with span("shard.gather", block=k):
            return self._gather(out)

    def run_placed(self, xi, xq, head=None) -> dict:
        """One step of the per-process stream on this rank's time block
        (block_wb float32 samples on its device; on the last time shard
        ``head`` may hold the (i, q) lookahead that follows the block,
        up to halo_wb samples): the exchange, the scan, the gather.
        Successive calls are successive steps of one stream."""
        return self._step(xi, xq, head, stream=True)

    def __call__(self, i_wb, q_wb) -> dict:
        n = self.n_time * self.block_wb
        if len(i_wb) != n:
            raise ValueError(f"expected {n} samples, got {len(i_wb)}")
        dev = self.device
        x = [torch.as_tensor(np.asarray(v, np.float32), device=dev)
             for v in (i_wb, q_wb)]
        own = slice(self.t_idx * self.block_wb, (self.t_idx + 1) * self.block_wb)
        return self._step(x[0][own], x[1][own], None, stream=False)

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
        if not self.follow_connections:
            return
        # stream-absolute sample clock across successive steps (the
        # per-process stream's positions already are)
        now_us = ((0 if self._stream else self._stream_offset_ch)
                  + pkt.sample_pos) // CH_SPS
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

    def _rescan_round(self, need: list) -> dict:
        """One round of rescans: ``need`` [(t, m, min_pos)], the same on
        every rank. The rank that holds cell (t, m) continues channel m's
        scan of its block past min_pos (per-channel samples relative to
        the block): its shard window's plain channelization (once a
        step), then one ``decode_block`` over the rows of all its cells
        (K7 and K4 on a card). One gather gives every rank every result:
        {(t, m, min_pos): the cell's candidate row (host arrays)}."""
        chunk = M // self.n_ch
        owned: dict = {}
        for key in need:
            owned.setdefault((key[1] // chunk, key[0]), []).append(key)
        width = max(len(v) for v in owned.values())
        row_len = sum(int(np.prod(s)) for s, _ in self._row_layout.values())
        rows = torch.zeros((width, row_len), dtype=torch.int32, device=self.device)
        mine = owned.get((self.c_idx, self.t_idx), [])
        if mine:
            if self._plain is None:
                self._plain = channelize(*self._window, num_taps=self.num_taps,
                                         has_context=True, cutoff_mhz=self.cutoff_mhz,
                                         device=self.device)
            y_i, y_q = self._plain
            ms = [m for _, m, _ in mine]
            # fill kernels take each value as an argument: no
            # host-to-device copy (an item assignment makes one)
            min_pos = torch.empty(len(mine), dtype=torch.int32, device=self.device)
            for j, (_, _, p) in enumerate(mine):
                min_pos[j].fill_(p)
            more = decode_block(
                _rows(y_i, ms), _rows(y_q, ms), _rows(self._gather_aa, ms),
                self.aa_mask, _rows(self.whiten_rows, ms), _rows(self._gather_crc, ms),
                _rows(self.adv_flags, ms), sps=self._sps, lag=self._lag,
                max_candidates=self.max_candidates, min_pos=min_pos)
            rows[: len(mine)] = torch.cat(
                [(more[k].view(torch.int32) if more[k].dtype == torch.float32
                  else more[k].to(torch.int32)).reshape(len(mine), -1)
                 for k in PACK_KEYS], dim=1)
        host = self._mesh_gather(rows).cpu().numpy()       # (n_time, n_ch, width, L)
        return {key: unpack_candidates(host[t, c, j], self._row_layout)
                for (c, t), keys in owned.items() for j, key in enumerate(keys)}

    def _consume(self, m: int, row: dict, lo: int, cursor: int, packets: list,
                 aa: int) -> tuple[int, bool]:
        """Walk one (time, channel) cell's slots in stream order from
        ``cursor`` (``lo``: the block's first per-channel sample), appending
        packets; returns (the cursor after them, whether every slot filled
        AND more hits exist past them)."""
        ch = bin_to_channel(m)
        adv = ch in (37, 38, 39)
        k_per_block = self.block_wb // D
        for k in range(len(row["pos"])):
            if not row["valid"][k]:
                return cursor, False
            p = int(row["pos"][k])
            if p >= k_per_block:
                continue  # halo territory: owned by the next block
            abs_p = lo + p
            if abs_p < cursor:
                continue
            if adv and not row["len_ok"][k]:
                cursor = abs_p + (32 + 16) * self._sps
                continue
            pl = int(row["payload_len"][k])
            packets.append(WidebandPacket(
                ch, abs_p, pl, bool(row["crc_ok"][k]),
                row["pdu_bytes"][k, : 2 + pl].astype(np.uint8),
                float(row["mag_mean"][k]), access_addr=aa))
            cursor = abs_p + (32 + 16 + (pl + 3) * 8) * self._sps
        return cursor, int(row["num_hits"]) > len(row["pos"])

    def _walk_channel(self, m: int, host: dict, cache: dict, cursor: int,
                      base: int, aa: int, need: set) -> dict:
        """Channel m's walk over the step's time blocks, its rescans read
        from ``cache``. A rescan not there is added to ``need`` and the
        walk goes on from the cursor it has, so the next blocks' rescans
        are asked for in the same round (a guess of their start that the
        next round's walk checks: a cached result is keyed by it)."""
        k_per_block = self.block_wb // D
        found, events, used, done = [], [], 0, True
        for t in range(host["pos"].shape[0]):
            found.append([])
            if not host["valid"][t, m, 0]:
                continue
            row = {k: v[t, m] for k, v in host.items()}
            lo = base + t * k_per_block
            cursor, exhausted = self._consume(m, row, lo, cursor, found[t], aa)
            if exhausted:
                events.append((t, m, int(row["num_hits"])))
            # slot exhaustion: hits past the last slot were not decoded —
            # rescan this channel's time block from the consumed cursor
            # until the cell's territory is clean
            while exhausted and cursor - lo < k_per_block:
                key = (t, m, int(cursor - lo))
                if key not in cache:
                    need.add(key)
                    done = False
                    break
                before = cursor
                used += 1
                cursor, exhausted = self._consume(m, cache[key], lo, cursor, found[t], aa)
                if cursor == before:
                    break  # remaining hits are all in the halo
        return {"found": found, "events": events, "rescans": used,
                "cursor": cursor, "done": done}

    def gather_packets(self, out) -> list:
        """Host-side assembly of the last step's output: the global packet
        list with per-channel span-eating across time blocks (same
        semantics as the single-device wideband sniffer), in (time block,
        channel, position) order, the same on every rank. Candidate-slot
        overflow in a (time, channel) cell triggers a rescan of that cell
        (never a silent drop)."""
        if self._last is None or self._last[0] is not out:
            raise ValueError("gather_packets walks the output of the last step")
        with span("shard.walk", block=self.steps - 1):
            return self._walk(self._last[1])

    def _walk(self, host: dict) -> list:
        # snapshot the keys this walk decodes with (follow handling may
        # re-key the AA rows for subsequent steps)
        self._gather_aa = self.aa_rows
        self._gather_crc = self.crc_inits
        aa_np = self._aa_host
        n_t = host["pos"].shape[0]
        k_per_block = self.block_wb // D
        base = self._stream_offset_ch if self._stream else 0
        start = self._cursors if self._stream else np.zeros(M, dtype=np.int64)

        # the keys THIS scan used (pcap PHDR AA per channel)
        chan_aa = [int.from_bytes(B.bits_to_bytes(aa_np[m]).tobytes(), "little")
                   for m in range(M)]
        cache: dict = {}
        walks: dict = {}
        pending = range(M)
        while True:
            need: set = set()
            for m in pending:
                walks[m] = self._walk_channel(m, host, cache, int(start[m]), base,
                                              chan_aa[m], need)
            pending = [m for m in pending if not walks[m]["done"]]
            if not pending:
                break
            with span("shard.rescan"):
                cache.update(self._rescan_round(sorted(need)))

        packets = [p for t in range(n_t) for m in range(M) for p in walks[m]["found"][t]]
        if self.on_truncate is not None:
            for t, m, hits in sorted(e for w in walks.values() for e in w["events"]):
                self.on_truncate(t, m, hits)
        rescans = sum(w["rescans"] for w in walks.values())
        self.truncated_cells += rescans
        count("rescan_cells", rescans)
        for pkt in packets:
            self._maybe_follow(pkt)
        if self._stream:
            self._cursors = np.array([walks[m]["cursor"] for m in range(M)], np.int64)
        self._stream_offset_ch += n_t * k_per_block
        if self.multi_follower is not None:
            changed = self.multi_follower.on_tick(self._stream_offset_ch // CH_SPS)
            if changed or self._follow_dirty:
                self._set_tables(*self.multi_follower.tables())
                self._follow_dirty = False
        return packets
