"""LE Coded PHY receiver: coded-AA sync, soft pattern demap, Viterbi.

Port of btle_tpu/rx/coded.py with the channel axis written out: every
(N,) lattice of the JAX function is a (C, N) tensor here (a 1-D input is
one channel), and the JAX package's vmap over candidate sync positions
is a (C, K) candidate batch. The Coded PHY keeps 1 Msym/s GFSK, so the
front end is the 1M path's phase-difference lattice at sps samples per
symbol; everything Coded happens on the symbol stream:

  1. SYNC on FEC block 1: the access address's coded symbol pattern (256
     symbols for the 32 AA bits at S=8) is correlated as a hard
     sign-agreement count over the dense lattice — a symbol-dilated
     256-tap convolution split by phase, exact in float32 (+-1 operands,
     sums <= 256) — then peak-gated and thresholded (THR_FRAC).
  2. CI detection: both CI hypotheses' coded CI+TERM1 patterns (40
     symbols) are agreement-scored after the AA; the better one selects S
     for FEC block 2.
  3. FEC2 decode: soft phase differences are pattern-demapped into
     per-FEC-bit metrics (both S windows built, the detected one
     selected) and every candidate's trellis goes through ONE batched
     radix-2 Viterbi call (phy.viterbi: the V1 kernel on a card).
  4. Length from the dewhitened header; CRC24 over the true span by the
     GF(2) prefix matmuls of the JAX code.

Numerics: the S=8 demap is ``soft.reshape(-1, 4) @ p1`` in the JAX code
with p1 = (+1, +1, -1, -1); here it is written out as
``((s0 + s1) - s2) - s3``, the sequential order of that dot, so no BLAS
(and no TF32) chooses the order of its rounding on any device. The CRC
runs its float GF(2) matmul inside ``true_fp32()`` (parity counts <= 360
are exact in FP32; TF32 would round the 0/1 products exactly too, but
the guard costs nothing); byte packing and state assembly are integer.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .._device import as_tensor, resolve_device
from ..phy.demodulator import phase_diff
from ..phy.viterbi import viterbi_decode_r2
from ..spec import bits as B
from ..spec import coded as K
from ..spec import crc24 as C
from ..spec import whitening as W
from ..wideband.channelizer import true_fp32
from .pipeline import earliest_hits

MAX_PDU_BYTES = 42                    # 2 header + 1..39 payload + margin
MAX_PDU_BITS = MAX_PDU_BYTES * 8
MAX_FEC2_IN = MAX_PDU_BITS + 24 + K.N_TERM
# trellis length actually decoded: rounded up to even for the radix-2
# Viterbi (two steps per iteration); the extra step consumes one more
# REAL symbol pair from the stream, and only the first MAX_PDU_BITS+24
# decoded bits are consumed
DEC_STEPS = MAX_FEC2_IN + (MAX_FEC2_IN % 2)
THR_FRAC = 0.78                       # AA sync agreement threshold
N_AA_SYM = 256                        # coded AA symbols (32 bits x 2 x 4)
N_CI_SYM = 40                         # coded CI + TERM1 symbols
# GF(2)-matmul prefix CRC over the 45-byte body window (42 PDU + 3 CRC)
_CRC_V45, _CRC_MINIT45 = C.linear_crc_matrices(MAX_PDU_BYTES + 3)


def _aa_pattern_pm(access_address_hex: str) -> np.ndarray:
    """(256,) +-1 coded-AA symbol pattern (S=8, AA bits only)."""
    aa_bits = B.hex_to_bits(access_address_hex)
    sym = K.pattern_map(K.fec_encode(aa_bits), 8)
    return sym.astype(np.float32) * 2 - 1


def _ci_patterns_pm(access_address_hex: str) -> np.ndarray:
    """(2, 40) +-1 coded CI+TERM1 symbol patterns for CI in {S8, S2}.

    The FEC encoder state after the AA bits carries into CI coding, so
    the pattern is the FULL FEC1 stream's tail, not an isolated encode.
    """
    out = []
    for s2 in (8, 2):
        full = K.coded_aa_symbols(access_address_hex, s2=s2)
        out.append(full[N_AA_SYM:].astype(np.float32) * 2 - 1)
    return np.stack(out)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (C, n) at idx (C, ...) clipped to [0, n-1] -> (C, ...)."""
    flat = idx.clamp(0, x.shape[1] - 1).reshape(idx.shape[0], -1)
    return x.gather(1, flat).reshape(idx.shape)


@lru_cache(maxsize=None)
def _crc_matrices(device: torch.device):
    """(_CRC_V45, _CRC_MINIT45) as float32 tensors on ``device``, made once
    per device (1.6 MB; never written)."""
    return (torch.as_tensor(_CRC_V45, dtype=torch.float32, device=device),
            torch.as_tensor(_CRC_MINIT45, dtype=torch.float32, device=device))


def _crc_check(body: torch.Tensor, crc_init_table, plen: torch.Tensor):
    """CRC verdict of dewhitened (..., 360) body windows at payload length
    plen (...): the CRC state after 2 header + plen bytes against the
    three bytes that follow. The prefix states are the GF(2) matmuls of
    the JAX code (exact: parity counts <= 360)."""
    dev = body.device
    n_bytes = MAX_PDU_BYTES + 3
    init = torch.as_tensor(crc_init_table, device=dev).to(torch.int64)
    init_bits = ((init[..., None] >> torch.arange(24, device=dev)) & 1
                 ).to(torch.float32)
    v45, minit45 = _crc_matrices(dev)
    with true_fp32():
        contrib = body.to(torch.float32) @ v45 + init_bits @ minit45
    state_bits = contrib.to(torch.int64) & 1
    weights24 = 1 << torch.arange(24, device=dev)
    states = (state_bits.reshape(*body.shape[:-1], n_bytes, 24)
              * weights24).sum(-1)                     # states[k]: after byte k
    body_bytes = (body.to(torch.int64).reshape(*body.shape[:-1], n_bytes, 8)
                  * (1 << torch.arange(8, device=dev))).sum(-1)
    at = plen.to(torch.int64)[..., None]
    crc_state = states.gather(-1, at + 1)[..., 0]
    crc_rcv = (body_bytes.gather(-1, at + 2)[..., 0]
               + body_bytes.gather(-1, at + 3)[..., 0] * 256
               + body_bytes.gather(-1, at + 4)[..., 0] * 65536)
    return crc_state == crc_rcv


def coded_sync_and_decode(i, q, aa_pm, ci_pm, whiten_bits, crc_init_table,
                          sps: int, max_candidates: int = 4):
    """One block -> coded candidate arrays, on the device of ``i``.

    i, q: (N,) or (C, N) float samples; aa_pm (256,), ci_pm (2, 40): +-1
    patterns from the helpers above; whiten_bits (MAX_PDU_BITS+24,) or
    (C, MAX_PDU_BITS+24); crc_init_table: table-order init int
    (spec.crc24.lfsr_init_to_table_init), scalar or (C,).
    Returns a dict of (max_candidates, ...) arrays, (C, max_candidates,
    ...) for a (C, N) input: pos (symbol-lattice sample index of the AA
    start, -1 where invalid), valid, ci_s2 (detected S), crc_ok,
    payload_len, pdu_bits (MAX_PDU_BITS,), agree.
    """
    one = i.ndim == 1
    if one:
        i, q = i[None], q[None]
    dev = i.device
    n_ch = i.shape[0]
    d = phase_diff(i.to(torch.float32), q.to(torch.float32), sps)  # (C, n)
    n = d.shape[1]
    sgn = torch.where(d > 0, 1.0, -1.0)
    aa_pm = as_tensor(aa_pm, dev, torch.float32)
    ci_pm = as_tensor(ci_pm, dev, torch.float32)

    # coded-AA agreement: positions == p (mod sps) form an undilated
    # 256-tap correlation over the phase-p symbol subsequence; the sps
    # phases ride the batch axis beside the channels
    span_aa = N_AA_SYM * sps
    n_corr = max(n - span_aa, 1)
    m = (n_corr + sps - 1) // sps + N_AA_SYM
    pad_to = m * sps
    sgp = F.pad(sgn, (0, max(0, pad_to - n)))[:, :pad_to]
    lhs = sgp.reshape(n_ch, m, sps).transpose(1, 2).reshape(n_ch * sps, 1, m)
    with true_fp32():
        corr_p = F.conv1d(lhs, aa_pm.reshape(1, 1, -1))         # (C*sps, 1, m-255)
    corr = corr_p.reshape(n_ch, sps, -1).transpose(1, 2).reshape(n_ch, -1)
    agree = (corr[:, :n_corr] + float(N_AA_SYM)) * 0.5

    # peak gate: a hit must also be the agreement maximum within its
    # +-(sps-1) neighbourhood ("SAME" window, -inf outside)
    thr = float(int(N_AA_SYM * THR_FRAC))
    win = F.max_pool1d(agree[:, None], 2 * sps - 1, stride=1,
                       padding=sps - 1)[:, 0]
    hit = (agree >= thr) & (agree >= win)
    pos_sel, valid, _ = earliest_hits(hit, max_candidates, 0)
    pos = pos_sel.to(torch.int64).clamp(0, n_corr - 1)          # (C, K)

    # CI detection: agreement of the 40 CI/TERM1 symbols
    base = pos + span_aa
    sym = torch.arange(N_CI_SYM, device=dev) * sps
    ci_sgn = _gather(sgn, base[..., None] + sym)                # (C, K, 40)
    score8 = (ci_sgn * ci_pm[0] > 0).sum(-1)
    score2 = (ci_sgn * ci_pm[1] > 0).sum(-1)
    use_s2 = score2 > score8

    # FEC2 soft metrics at both S. The S=8 window is the superset: the
    # S=2 window is its first DEC_STEPS*2 symbols
    fec2_base = base + N_CI_SYM * sps
    soft = _gather(d, fec2_base[..., None]
                   + torch.arange(DEC_STEPS * 8, device=dev) * sps)
    g = soft.reshape(*soft.shape[:-1], -1, 4)
    m8 = ((g[..., 0] + g[..., 1]) - g[..., 2]) - g[..., 3]     # (C, K, 728)
    mm = torch.where(use_s2[..., None], soft[..., : DEC_STEPS * 2], m8)
    la = mm[..., 0::2].reshape(-1, DEC_STEPS)
    lb = mm[..., 1::2].reshape(-1, DEC_STEPS)
    bits, _ = viterbi_decode_r2(la, lb, DEC_STEPS)              # one launch
    bits = bits.reshape(n_ch, max_candidates, DEC_STEPS)

    whiten = as_tensor(whiten_bits, dev, torch.int8)
    whiten = whiten.reshape(-1, MAX_PDU_BITS + 24).expand(n_ch, -1)
    body = bits[..., : MAX_PDU_BITS + 24] ^ whiten[:, None, :]
    pdu_bits = body[..., :MAX_PDU_BITS]
    plen = (pdu_bits[..., 8:16].to(torch.int64)
            << torch.arange(8, device=dev)).sum(-1).clamp(0, MAX_PDU_BYTES - 2)
    crc_init = torch.as_tensor(crc_init_table, device=dev).reshape(-1)
    crc_ok = _crc_check(body, crc_init.expand(n_ch)[:, None], plen)

    out = {
        "pos": torch.where(valid, pos_sel, -1).to(torch.int32),
        "valid": valid,
        "ci_s2": torch.where(use_s2, 2, 8).to(torch.int32),
        "payload_len": plen.to(torch.int32),
        "crc_ok": crc_ok & valid,
        "pdu_bits": pdu_bits,
        "agree": agree.gather(1, pos),
    }
    if one:
        out = {k: v[0] for k, v in out.items()}
    return out


def packets_from(out: dict, k_slots: int) -> list:
    """Host walk over one channel's candidate arrays (numpy): the valid
    candidates in slot order, as decoded packet dicts."""
    pkts = []
    for k in range(k_slots):
        if not out["valid"][k]:
            break
        plen = int(out["payload_len"][k])
        pkts.append({
            "pos": int(out["pos"][k]),
            "s": int(out["ci_s2"][k]),
            "crc_ok": bool(out["crc_ok"][k]),
            "payload_len": plen,
            "pdu_bytes": B.bits_to_bytes(out["pdu_bits"][k][: (2 + plen) * 8]),
            "aa_agree": int(out["agree"][k]),
        })
    return pkts


def decode_coded(i, q, channel: int, sps: int = 4,
                 access_address_hex: str = "d6be898e",
                 crc_init_hex: str = "555555", max_candidates: int = 4,
                 device=None):
    """Host wrapper: IQ block -> list of decoded coded packets. Runs on
    ``device`` (cuda unless the caller passes another)."""
    dev = resolve_device(device)
    out = coded_sync_and_decode(
        as_tensor(i, dev, torch.float32), as_tensor(q, dev, torch.float32),
        _aa_pattern_pm(access_address_hex),
        _ci_patterns_pm(access_address_hex),
        np.array(W.whitening_bits(channel, MAX_PDU_BITS + 24)),
        C.lfsr_init_to_table_init(crc_init_hex), sps=sps,
        max_candidates=max_candidates)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    return packets_from(out, max_candidates)
