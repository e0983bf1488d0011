"""Carry tables and stream state from the JAX package into the port.

The JAX package keeps its scan tables (the LE Coded scan's too), filter
weights and sniffer state as arrays; handed over as numpy arrays
(``np.asarray`` of each), these helpers turn them into the port's
tensors with the port's dtypes, so a deployment can move a stream from
one package to the other mid-capture (``WidebandSniffer.load_state``;
``sniffer_state`` + ``sniffer_from_state`` for the narrowband
``Sniffer``) or check that both packages hold the same tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def scan_tables_from_numpy(aa_rows, aa_mask, whiten_rows, crc_inits,
                           adv_flags, device):
    """(aa_rows (M, 32) or (32,), aa_mask (32,), whiten_rows (M, 336),
    crc_inits (M,), adv_flags (M,)) numpy -> tensors on ``device``:
    int8 AA bits, int8 care mask, int8 whitening bits, int32 table-form
    CRC inits, bool advertising flags."""
    dev = torch.device(device)
    return (torch.tensor(np.asarray(aa_rows, np.int8), device=dev),
            torch.tensor(np.asarray(aa_mask, np.int8), device=dev),
            torch.tensor(np.asarray(whiten_rows, np.int8), device=dev),
            torch.tensor(np.asarray(crc_inits, np.int32), device=dev),
            torch.tensor(np.asarray(adv_flags, bool), device=dev))


def coded_tables_from_numpy(aa_pm, ci_pm, whiten_rows, crc_init, device):
    """The JAX package's ``wideband.coded.coded_scan_tables()`` as numpy
    arrays — (aa_pm (256,), ci_pm (2, 40), whiten_rows (40, 360),
    crc_init) — -> the port's LE Coded scan tables on ``device``: float32
    +-1 patterns, int8 whitening bits and an int32 table-form CRC init, as
    the port's ``wideband.coded.coded_scan_tables`` makes them."""
    dev = torch.device(device)
    return (torch.tensor(np.asarray(aa_pm, np.float32), device=dev),
            torch.tensor(np.asarray(ci_pm, np.float32), device=dev),
            torch.tensor(np.asarray(whiten_rows, np.int8), device=dev),
            torch.tensor(np.asarray(crc_init, np.int32), device=dev))


# K rows of the tensor-core B tables come in multiples of the kernel's
# pipeline stage (csrc/filterbank_hilo_mma.cu kKS)
HILO_K_ALIGN = 64


def _b_operand(gk: torch.Tensor) -> torch.Tensor:
    """(n_chunks, rows, chunk*40) bf16 im2col weights -> the (K_pad, rows)
    B operand: B[s*40 + i, o] = G[s][o, i] for s < n_chunks*chunk, zero
    rows up to K_pad, the next multiple of HILO_K_ALIGN."""
    n_chunks, rows, cols = gk.shape
    k = n_chunks * cols
    b = torch.zeros((-(-k // HILO_K_ALIGN) * HILO_K_ALIGN, rows), dtype=torch.bfloat16,
                    device=gk.device)
    # gk[c, o, j*40 + i] is shift s = c*chunk + j: row s*40 + i of B
    b[:k] = gk.reshape(n_chunks, rows, cols // 40, 40).permute(0, 2, 3, 1).reshape(k, rows)
    return b


def hilo_weights(g_chunks_hilo) -> torch.Tensor:
    """The (n_chunks, 160, chunk*40) stacked hi/lo im2col pair (rows 0..79
    hi, 80..159 lo) -> the (K_pad, 160) bf16 B operand of the tensor-core
    filterbank: B[s*40 + i, o] = Ghi[s][o, i], B[s*40 + i, 80 + o] =
    Glo[s][o, i] for s < n_chunks*chunk, zero rows up to K_pad, the next
    multiple of HILO_K_ALIGN. Raises unless every entry is
    bf16-representable (the bf16 table then holds it exactly)."""
    gk = torch.as_tensor(np.asarray(g_chunks_hilo, np.float32))
    n_chunks, rows, cols = gk.shape
    if rows != 160 or cols % 40:
        raise ValueError(f"not a stacked hi/lo im2col table: {tuple(gk.shape)}")
    out = gk.to(torch.bfloat16)
    if not torch.equal(out.to(torch.float32), gk):
        raise ValueError("hi/lo weights are not bf16-representable")
    return _b_operand(out)


def bf16_weights(g_chunks) -> torch.Tensor:
    """The (n_chunks, 80, chunk*40) im2col weights -> the (K_pad, 80) bf16
    B operand of the tensor-core filterbank at "bf16": B[s*40 + i, o] =
    bf16(G[s][o, i]) (float32 -> bf16, round to nearest even, as the JAX
    package casts them), zero rows up to K_pad, the next multiple of
    HILO_K_ALIGN. Takes a numpy array or a tensor (kept on its device)."""
    gk = torch.as_tensor(g_chunks)
    n_chunks, rows, cols = gk.shape
    if rows != 80 or cols % 40:
        raise ValueError(f"not an im2col weight table: {tuple(gk.shape)}")
    return _b_operand(gk.to(torch.float32).to(torch.bfloat16))


def sgemm_weights(g_chunks) -> torch.Tensor:
    """The (n_chunks, 80, chunk*40) im2col weights -> the (40, S, 80)
    float32 table of the CUDA-core FP32 filterbank (csrc/filterbank_sgemm_f32.cu),
    S = n_chunks*chunk shifts: T[i, s, o] = G[s // chunk][o, (s % chunk)*40
    + i], the weights of every shift of one input row contiguous, o
    fastest. Takes a numpy array or a tensor (kept on its device)."""
    gk = torch.as_tensor(g_chunks)
    if gk.dtype != torch.float32:
        gk = gk.to(torch.float32)
    n_chunks, rows, cols = gk.shape
    if rows != 80 or cols % 40:
        raise ValueError(f"not an im2col weight table: {tuple(gk.shape)}")
    # gk[c, o, j*40 + i] is shift s = c*chunk + j: T[i, s, o]
    return (gk.reshape(n_chunks, rows, cols // 40, 40).permute(3, 0, 2, 1)
            .reshape(40, n_chunks * (cols // 40), rows).contiguous())


def filter_tables_from_numpy(kind: str, tables, device):
    """The fused front end's weight tables for one filterbank kind
    (``wideband.fused.filterbank_kind``), numpy -> tensors:

      "bf16x2w":    (g_chunks_hilo,) — the (n_chunks, 160, chunk*40)
                    stacked hi/lo pair -> (hilo_weights(g_chunks_hilo),);
      "f32x2":      (g_chunks_x2,) — the (n_chunks, 160, chunk*80) hi/lo
                    pair whose weight columns are duplicated over the
                    [xhi; xlo] frame rows (a Mosaic layout): the copies are
                    checked equal and dropped, leaving the bf16x2w pair ->
                    the same (K_pad, 160) B operand;
      "bf16":       (g_chunks,) — rounded to bf16 (round to nearest even),
                    as the JAX package casts it, in the (K_pad, 80) B
                    layout -> (bf16_weights(g_chunks),);
      "f32_im2col": (g_chunks,) -> (sgemm_weights(g_chunks),), float32;
      "f32", "bf16_poly": (perm, kcoefx, w4x[, n_slices]) of _polyx_tables
                    — the frame-row gather as int64, the stacked taps and
                    the DFT as float32.
    """
    dev = torch.device(device)
    if kind == "bf16x2w":
        (gk,) = tables
        return (hilo_weights(gk).to(dev),)
    if kind == "f32x2":
        gk = np.asarray(tables[0], np.float32)
        n, rows, cols = gk.shape
        if cols % 80:
            raise ValueError(f"not an f32x2 weight table: {gk.shape}")
        pairs = gk.reshape(n, rows, cols // 80, 2, 40)
        if not np.array_equal(pairs[:, :, :, 0], pairs[:, :, :, 1]):
            raise ValueError("f32x2 weights: the xhi and xlo copies of a "
                             "weight column differ")
        return (hilo_weights(pairs[:, :, :, 0].reshape(n, rows, cols // 2)).to(dev),)
    if kind == "bf16":
        (gk,) = tables
        return (bf16_weights(np.asarray(gk, np.float32)).to(dev),)
    if kind == "f32_im2col":
        (gk,) = tables
        return (sgemm_weights(np.asarray(gk, np.float32)).to(dev),)
    if kind in ("f32", "bf16_poly"):
        perm, kcoefx, w4x = tables[:3]
        return (torch.as_tensor(np.asarray(perm), dtype=torch.long, device=dev),
                torch.as_tensor(np.asarray(kcoefx, np.float32), device=dev).contiguous(),
                torch.as_tensor(np.asarray(w4x, np.float32), device=dev).contiguous())
    raise ValueError(f"no filter tables for filterbank kind {kind!r}")


def sniffer_state(sniffer, next_offset: int, skip: int) -> dict:
    """The carried state of a narrowband Sniffer of either package, as
    plain Python values, taken between two blocks: the receive
    configuration (channel, access address, CRC init), the packet count
    and text clock, the dwell-rotation position, the hop tracker's fields
    (its callback left out) and the block iterator's cursor —
    ``next_offset``, the absolute sample index where the next block
    starts, and ``skip``, the lattice positions of that block the last
    packets consumed (the iterator's ``_skip`` after ``consume_to``)."""
    t = sniffer.hop_tracker
    hop = None
    if t is not None:
        hop = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)
               if f.name != "on_event"}
        hop["conn"] = None if t.conn is None else dataclasses.asdict(t.conn)
        hop["events"] = [dataclasses.asdict(e) for e in t.events]
    return {
        "config": dataclasses.asdict(sniffer.cfg),
        "channel": int(sniffer.channel),
        "access_addr": int(sniffer.access_addr),
        "crc_init_internal": int(sniffer.crc_init_internal),
        "pkt_count": int(sniffer.pkt_count),
        "last_pkt_us": int(sniffer._last_pkt_us),
        "rotate_idx": int(sniffer._rotate_idx),
        "dwell_start_us": int(sniffer._dwell_start_us),
        "hop": hop,
        "next_offset": int(next_offset),
        "skip": int(skip),
    }


def sniffer_from_state(state: dict, device=None, **outputs):
    """A port ``Sniffer`` that continues the stream ``state``
    (``sniffer_state``) describes. ``outputs`` are the Sniffer's other
    arguments (ndjson, pcap, text_fh, quiet_text, control). Run it with
    ``sn.run(rest, offset=state["next_offset"], skip=state["skip"])``,
    where ``rest`` yields the samples from ``next_offset`` on."""
    from .ll.hop import ConnectionInfo, HopEvent, HopTracker
    from .stream.sniffer import Sniffer, SnifferConfig

    cfg = dict(state["config"])
    cfg["rotate_channels"] = tuple(cfg["rotate_channels"])
    sn = Sniffer(SnifferConfig(**cfg), device=device, **outputs)
    sn.channel = state["channel"]
    sn.access_addr = state["access_addr"]
    sn.crc_init_internal = state["crc_init_internal"]
    sn.pkt_count = state["pkt_count"]
    sn._last_pkt_us = state["last_pkt_us"]
    sn._rotate_idx = state["rotate_idx"]
    sn._dwell_start_us = state["dwell_start_us"]
    hop = state["hop"]
    if (hop is None) != (sn.hop_tracker is None):
        raise ValueError("hop state and the config's hop flag disagree")
    if hop is not None:
        hop = dict(hop)
        if hop["conn"] is not None:
            hop["conn"] = ConnectionInfo(**hop["conn"])
        hop["events"] = [HopEvent(**e) for e in hop["events"]]
        hop["used"] = tuple(hop["used"])
        sn.hop_tracker = HopTracker(**hop)
    return sn
