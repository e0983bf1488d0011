"""Plain reference of the 40-channel wideband sniffer, in float64.

What it computes, and where the program's semantics come from:

- the channelizer's DFT-folded polyphase filterbank (btle_tpu_torch
  wideband/channelizer.py: ``prototype_filter``, ``_poly_kernel``,
  ``_fused_kernel``, ``frame_rows``), here in float64 from the float64
  prototype, with the frames rounded to the operand type the
  configuration states ("bf16" or exact);
- the demod tail (wideband/fused.py ``demod_tail_reference``):
  symbol-lag phase-difference decisions, the 32-tap access-address test,
  and RSSI window sums of |y_i| + |y_q| over 32 symbols;
- the candidate decode (rx/decode_kernel.py, the fused scan's
  zero-padded window) and the host walk of wideband/sniffer.py
  (``_consume_channel``: span-eating cursors per channel, advertising
  length checks, the rescan when a channel's hits outnumber its slots);
- the rescan's own lattice (wideband/sniffer.py ``rescan_channel``): the
  plain channelizer on exact frames, and rx/pipeline.py
  ``block_candidates``' RSSI over the channel samples truncated toward
  zero, as btle_rx.c:2234-2252 takes it over integer samples.

It runs on any torch device; the comparison on a card runs it there.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import ble

M = 40                  # channels, DFT size
D = 20                  # decimation: 80 Msps in, 4 Msps a channel out
AA_BITS = 32


@lru_cache(maxsize=4)
def prototype(num_taps: int, cutoff_mhz: float, beta: float = 10.0) -> np.ndarray:
    """The Kaiser lowpass of the channelizer, unit DC gain, float64."""
    from scipy import signal

    h = signal.firwin(num_taps, cutoff_mhz, window=("kaiser", beta), fs=80)
    return h / h.sum()


@lru_cache(maxsize=4)
def folded_weights(num_taps: int, cutoff_mhz: float) -> np.ndarray:
    """(80, 40, width) float64: y[o, k] = sum_{i,s} W[o, i, s] F[i, k+s]
    with F the (40, J) frames; rows 0..39 of y are the bins' I, 40..79
    their Q. Branch p of the polyphase filter reads frame column c(p) at
    shifts base(p) - 2r with tap h[p + 40r]; the 40-point DFT is folded
    into the weights."""
    h = prototype(num_taps, cutoff_mhz)
    width = num_taps // D + 1
    kp = np.zeros((M, D, width))
    for p in range(M):
        c = 0 if p % D == 0 else (D - p if p < D else 2 * D - p)
        base = width - 1 if p == 0 else (width - 2 if p <= D else width - 3)
        for r in range(num_taps // M):
            kp[p, c, base - 2 * r] = h[p + M * r]
    ang = 2 * np.pi * np.outer(np.arange(M), np.arange(M)) / M
    g_r = np.einsum("mp,pcs->mcs", np.cos(ang), kp)
    g_i = np.einsum("mp,pcs->mcs", np.sin(ang), kp)
    w = np.zeros((2 * M, 2 * D, width))
    w[:M, :D], w[:M, D:] = g_r, -g_i
    w[M:, :D], w[M:, D:] = g_i, g_r
    return w


def frames(xi: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """(N,) I/Q whose first num_taps-1 samples are history -> (40, J)
    float64 frames: one sample of left pad, zeros up to whole frames;
    rows 0..19 the I streams, 20..39 the Q streams."""
    x = torch.stack([xi.to(torch.float64), xq.to(torch.float64)])
    right = (-(1 + x.shape[1])) % D
    x = torch.nn.functional.pad(x, (1, right))
    return x.reshape(2, -1, D).transpose(1, 2).reshape(2 * D, -1)


def round_operand(f: torch.Tensor, operand: str) -> torch.Tensor:
    """The frames as the configuration's operand type holds them."""
    if operand == "bf16":
        return f.to(torch.float32).to(torch.bfloat16).to(torch.float64)
    if operand == "exact":
        return f
    raise ValueError(f"unknown operand type {operand!r}")


def filterbank(f: torch.Tensor, w: np.ndarray) -> torch.Tensor:
    """(80, J - width + 1) float64 baseband of (40, J) frames."""
    wt = torch.as_tensor(w, dtype=torch.float64, device=f.device)
    width = wt.shape[2]
    k = f.shape[1] - width + 1
    y = torch.zeros((2 * M, k), dtype=torch.float64, device=f.device)
    for s in range(width):
        y += wt[:, :, s] @ f[:, s: s + k]
    return y


def demod(y: torch.Tensor, aa_rows: torch.Tensor, sps: int, lag: int,
          int_mag: bool = False):
    """bits (40, K-lag) bool, hit (40, K-lag-31*sps) bool and the RSSI
    window means mag (same shape, float64) of the (80, K) baseband;
    aa_rows (40, 32) 0/1, every bit cared for. ``int_mag``: the means
    over the samples truncated toward zero."""
    yi, yq = y[:M], y[M:]
    nb = y.shape[1] - lag
    bits = (yi[:, :nb] * yq[:, lag:] - yi[:, lag:] * yq[:, :nb]) > 0
    n_hit = nb - (AA_BITS - 1) * sps
    s = bits.to(torch.int32) * 2 - 1
    t = aa_rows.to(device=y.device, dtype=torch.int32) * 2 - 1
    acc = torch.zeros((M, n_hit), dtype=torch.int32, device=y.device)
    for j in range(AA_BITS):
        acc += s[:, j * sps: j * sps + n_hit] * t[:, j: j + 1]
    win = AA_BITS * sps
    a = torch.trunc(yi).abs() + torch.trunc(yq).abs() if int_mag else yi.abs() + yq.abs()
    c = torch.nn.functional.pad(torch.cumsum(a, 1), (1, 0))
    mag = (c[:, win: win + n_hit] - c[:, :n_hit]) / win
    return bits, acc == AA_BITS, mag


def block_lattice(xi, xq, num_taps: int, cutoff_mhz: float, operand: str,
                  aa: int, sps: int, lag: int, device, int_mag: bool = False):
    """The scan program's lattices of one block: ``xi``/``xq`` are the
    block's num_taps-1 samples of history then its samples."""
    f = frames(torch.as_tensor(np.asarray(xi), device=device),
               torch.as_tensor(np.asarray(xq), device=device))
    y = filterbank(round_operand(f, operand), folded_weights(num_taps, cutoff_mhz))
    aa_rows = torch.as_tensor(np.tile(ble.aa_bits(aa), (M, 1)), device=device)
    return demod(y, aa_rows, sps, lag, int_mag)


@dataclass
class Candidate:
    pos: int
    payload_len: int
    len_ok: bool
    crc_ok: bool
    pdu: np.ndarray       # 42 decoded octets


def decode_candidate(bits_row: np.ndarray, pos: int, channel: int,
                     crc_init: int, sps: int) -> Candidate:
    """Dewhiten, pack and CRC-check one hit; window bits past the end of
    the lattice read as zero (the fused scan's decode)."""
    kb = len(bits_row)
    idx = pos + AA_BITS * sps + sps * np.arange(ble.MAX_PDU_CRC_BITS)
    raw = np.where(idx < kb, bits_row[np.minimum(idx, kb - 1)], 0).astype(np.int8)
    dew = raw ^ ble.whitening_bits(channel)
    octets = ble.bits_to_bytes(dew)
    adv = ble.is_adv(channel)
    nlen = 6 if adv else 5
    plen = int(sum(int(dew[8 + b]) << b for b in range(nlen)))
    len_ok = 6 <= plen <= 37 if adv else plen <= 31
    pc = min(plen, 37)
    crc = ble.crc24(octets[: pc + 2].tobytes(), crc_init)
    rcv = int(octets[pc + 2]) | int(octets[pc + 3]) << 8 | int(octets[pc + 4]) << 16
    return Candidate(pos, plen, len_ok, (crc == rcv) and len_ok, octets)


@dataclass
class RefPacket:
    channel: int
    sample_pos: int
    payload_len: int
    crc_ok: bool
    pdu: bytes
    rssi_mag: float
    access_addr: int


class Walker:
    """The wideband sniffer's host walk over reference lattices, block
    after block (wideband/sniffer.py ``consume_scan``)."""

    def __init__(self, scan_len: int, sps: int, slots: int, aa: int,
                 crc_init: int, offset: int = 0):
        self.scan_len, self.sps, self.slots = scan_len, sps, slots
        self.aa, self.crc_init = aa, crc_init
        self.offset = offset
        self.cursors = np.full(M, offset, np.int64)
        self.rescans = 0

    def _earliest(self, hits: np.ndarray, min_pos: int):
        live = hits[hits >= min_pos]
        return live[: self.slots], len(live)

    def _consume(self, m, ch, cands, n_hits, bits_row, mag_row, out) -> bool:
        sps, adv = self.sps, ble.is_adv(ch)
        for c in cands:
            abs_p = self.offset + c.pos
            if c.pos >= self.scan_len or abs_p < self.cursors[m]:
                continue
            if adv and not c.len_ok:
                self.cursors[m] = abs_p + (AA_BITS + 16) * sps
                continue
            pl = c.payload_len
            out.append(RefPacket(ch, int(abs_p), pl, c.crc_ok,
                                 c.pdu[: 2 + pl].tobytes(),
                                 float(mag_row[min(c.pos, len(mag_row) - 1)]),
                                 self.aa))
            self.cursors[m] = abs_p + (AA_BITS + 16 + (pl + 3) * 8) * sps
        # a slot left empty ends the walk; all slots full and more hits
        # past them ask for a rescan from the cursor
        return len(cands) == self.slots and n_hits > self.slots

    def block(self, bits: np.ndarray, hit: np.ndarray, mag: np.ndarray,
              rescan_lattice=None) -> list:
        """Packets of the next block from its (40, .) lattices (host
        arrays); advances the cursors and the offset. ``rescan_lattice()``
        gives the rescans' (bits, hit, mag) of the block (host arrays),
        computed once a rescan asks; without it rescans read the first
        lattices."""
        out: list = []
        plain: list = []

        def lattice(first: bool):
            if first or rescan_lattice is None:
                return bits, hit, mag
            if not plain:
                plain.extend(rescan_lattice())
            return plain

        for m in range(M):
            ch = ble.bin_to_channel(m)

            def consume(min_pos, first):
                b, h, g = lattice(first)
                pos, n_hits = self._earliest(np.flatnonzero(h[m]), min_pos)
                cands = [decode_candidate(b[m], int(p), ch, self.crc_init,
                                          self.sps) for p in pos]
                return self._consume(m, ch, cands, n_hits, b[m], g[m], out)

            more = consume(0, True)
            while more and self.cursors[m] - self.offset < self.scan_len:
                before = self.cursors[m]
                self.rescans += 1
                more = consume(int(self.cursors[m] - self.offset), False)
                if self.cursors[m] == before:
                    break
        self.offset += self.scan_len
        return out
