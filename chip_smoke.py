#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (btle_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit: ``python3 chip_smoke.py``. It builds every hand-written kernel
from ``btle_tpu_torch/csrc`` (into ``build/``), then runs, printing one
JSON line per phase:

  0. device: torch version, card name and power limit, clocks (nvidia-smi);
  1. build: seconds to compile the kernels (one nvcc per source, in
     parallel) and each kernel's ptxas register / shared-memory report;
     the tensor-core hi/lo filterbank (K1, K5 f32x2), the FP32 SGEMM
     filterbank (K5 f32) and shift_fma (K10) must not spill; the launch
     shapes (dynamic shared memory, resident CTAs per SM, grid) of K5 f32
     at bench geometry and of K10 at its three (R, N, STEP);
  2. kernels: each kernel against its plain PyTorch twin on the card, on
     one bench-geometry block with packets in it (131072 + 1476 channel
     samples, 1280-tap prototype, 16 candidate slots), the filterbank in
     every numerics class (K1 bf16x2w and K5 f32x2 on the tensor cores,
     K3 f32 polyx, K5 bf16 / f32 im2col) and each against one cuDNN
     convolution computing the same y (timed later as its yardstick); the
     narrowband
     scan on a 131072 + 1473-sample int16 block at sps 4 / lag 1, at
     sps 8 / lag 8, with an all-zero care mask and on the 40 float
     channel rows of the wideband block with per-row access addresses;
     the candidate decode with clamped tails on candidates at the
     lattice's end;
  3. self-test: the known-answer self-test in both fused modes, then the
     knob matrix (wideband.knobmatrix: every shipped and supported
     compute_dtype / inner / decode / PHY row; every "pass" row must);
  4. main path: WidebandSniffer(fused=True).run() over a 4-block
     (131 ms) scene with ADV and LL data packets, a packet across a block
     boundary and a channel with more packets than candidate slots, in
     "bf16x2w" and in "f32"; every injected packet must decode CRC-OK and
     byte-exact on its channel, no other CRC-OK packet may appear, and
     every kernel of the mode must have launched (the slot-overflow
     rescans run the narrowband scan and the candidate decode);
  5. narrowband main path: Sniffer(channel 37, sps 4, hop, rssi, NDJSON
     and pcap) over 1 s of air at 4 Msps (ADV traffic, a CONNECT_REQ,
     then data packets on the hop sequence) at the file block size
     (131072) and the live one (8192): every scheduled packet CRC-OK and
     byte-exact, no other, hop events track_start then chan_change, the
     same events at both sizes, the narrowband scan and the candidate
     decode launched; golden_decode at sps 8 on one packet;
  6. CLI: ``python -m btle_tpu_torch.cli decode --json`` on the scene
     written as an i16 file; its NDJSON must equal the library run's;
  6b. wideband CLI: 0.2 s of 80 Msps air (ADV traffic on 37/38/39, two
     CONNECT_REQs, LL data packets on each connection's hop channels),
     written as i8 for "bf16" and as f32 for "bf16x2w" and "f32"; per
     mode the library WidebandStreamRunner (scan_len_ch 8192, follow, 2
     connections, NDJSON, pcap), then ``python -m btle_tpu_torch.cli
     wideband --fused --fused-dtype MODE --follow --max-follow 2 --json
     --pcap`` in a child process: every injected packet CRC-OK and
     byte-exact on its channel, no other, track_start for both access
     addresses, the same hop events in every mode, the CLI's NDJSON equal
     to the library's, the pcap holding the CRC-OK packets; then run_live
     (pipeline 2) over the native ring preloaded with the scene: the same
     packets as the file run, its real-time factor, its host/device split
     and a profile;
  6c. tx: ``python -m btle_tpu_torch.cli tx`` in child processes on the
     descriptors of examples/packets/*.txt (Space 1 ms) plus one packet
     on each of ten channels across the band, --out f32 with
     --wideband-out, then --out i8: the files equal the library's
     (plan_to_stream / plan_to_wideband); the 4 Msps stream through the
     narrowband Sniffer once per (channel, access address, CRC init) and
     through the decode CLI on channel 37, the 80 Msps capture through
     WidebandSniffer(fused=True) in "bf16x2w" and "f32" once per (access
     address, CRC init): every packet CRC-OK and byte-exact on its
     channel, no other; the modulator's time per packet;
  6d. probes: aa_corr and shift_stack against their twins exactly at
     several (sps, n_out, grp), shift_fma at the three (R, N, STEP) of K10
     within 1e-5 of max |out|; then each TPU probe's Hopper counterpart
     (btle_tpu_torch.tools: K8 dev_aagrp_bisect, K9 dev_aagrp_repro, K10
     dev_rollscale per R, K11 dev_roll_experiment in f32 and bf16) with
     few trials: every exact variant an exact match, every checksum pair
     MATCH, the launches of each probe's kernels counted;
  7. timing: wideband_scan_fused over 8 distinct device-resident noise
     blocks (as bench.py), median Msps per CLI mode, the clocks right
     after; per-kernel time, its
     twin's time, the bound, and for each filterbank one cuDNN
     convolution computing the same y as yardstick (K5 f32 and K10 also
     with their CUDA-event trials and launch shapes); K1 also at the live
     block's shape (8192 + halo columns: its twin, ms, CTAs, bound,
     yardstick); the narrowband
     real-time factor (air seconds per wall second, median of 3 runs)
     at both block sizes; then a torch.profiler trace of 8 scan steps
     per mode: device time by kernel and the device's idle share; each
     probe kernel at its probe's shape (K8-K11 on aa_corr, shift_stack,
     shift_fma, K2, K3 and K5);
  8. the {"kernels": [...]} summary, K1-K11 (``k`` names the PERF.md
     rows each entry carries).

The last two lines are the card's name and power limit as nvidia-smi
reports them, then {"ok": true, "device": {...}}. Without a CUDA device
it exits non-zero before printing anything. Any failed check raises.
"""

from __future__ import annotations

import io
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# the card's peak rates (integer operations counted at the FP32 rate) and
# the least time for a function's bytes and operations, shared with the
# probes
from btle_tpu_torch.tools._measure import BF16_FLOPS, FP32_FLOPS, bound_ms

ROOT = Path(__file__).resolve().parent
SCAN_LEN = 131072
MAX_CANDIDATES = 16
NUM_TAPS = 1280
# the filterbank kernels: (compute_dtype, inner) -> the kernel's name
FILTERBANK_MODES = (("bf16x2w", None, "filterbank_bf16x2w"),
                    ("f32", None, "filterbank_polyx_f32"),
                    ("bf16", None, "filterbank_im2col_bf16"),
                    ("f32x2", None, "filterbank_im2col_f32x2"),
                    ("f32", "im2col", "filterbank_im2col_f32"))

# narrowband scene: 1 s of air at 4 Msps on channel 37, int16 at a
# realistic receiver amplitude (full scale 32767) plus Gaussian noise
NB_SPS = 4
NB_SAMPLES = 4_000_000
NB_LIVE_SCAN_LEN = 8192         # the CLI's stdin default; SCAN_LEN is its file default
NB_AMPLITUDE = 2000.0
NB_NOISE_STD = 40.0
ADV_AA = 0x8E89BED6
CONN_AA = 0x60850A1B
CONN_CRC_HEX = "a77b22"
CONN_HOP = 9
# 40 x 1.25 ms = 50 ms: the hop tracker ticks once per block, and at the
# file block size (32.768 ms) it can follow only intervals of about 40 ms
# and more at every block size alike
CONN_INTERVAL = 40
HOP_GUARD_US = 7000             # ll.hop.GUARD_US

# wideband CLI scene: 0.2 s of 80 Msps air at int8 amplitude, scanned in
# the CLI's 8192-sample blocks (2.048 ms of air); two connections whose
# intervals (20 and 25 ms) the per-block hop tick follows
WB_AIR_S = 0.2
WB_SCAN_LEN = 8192
WB_BLOCK_US = WB_SCAN_LEN // 4
WB_AMPLITUDE = 40.0
WB_NOISE_STD = 2.0
WB_CONNS = ((0x60850A1B, "a77b22", 7, 16, 37, 1000),    # AA, CRC, hop,
            (0x50A1B2C4, "55aa11", 11, 20, 38, 3500))   # interval, channel, t_us
CLI_MODES = (("bf16", "i8"), ("bf16x2w", "f32"), ("f32", "f32"))


# the PERF.md kernel-table rows each kernel of the main paths carries: K6
# (the Mosaic inner variants) is mapped onto K1, K3 and K5
TPU_KERNEL_OF = {"filterbank_bf16x2w": ["K1", "K6"], "filterbank_polyx_f32": ["K3", "K6"],
                 "filterbank_im2col_bf16": ["K5", "K6"], "filterbank_im2col_f32x2": ["K5"],
                 "filterbank_im2col_f32": ["K5", "K6"], "demod_tail": ["K2"],
                 "decode_candidates": ["K4"], "scan_block": ["K7"]}


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


# what nvidia-smi reads beside the timings: compute-bound kernels scale
# with the SM clock, which a card may hold below its maximum
CLOCKS_QUERY = "clocks.sm,clocks.max.sm,clocks.mem,power.draw,temperature.gpu"


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# scenes
# --------------------------------------------------------------------------


def packet(rng, ch: int, plen: int):
    """One packet on BLE channel ch with a random payload of plen bytes:
    ADV_NONCONN_IND on advertising channels, an LL data PDU (LLID 1)
    elsewhere, all on the advertising AA and CRC init. Returns (pdu bytes,
    i80, q80) at 80 samples per symbol."""
    from btle_tpu_torch.golden import assemble_phy_bits, gfsk_modulate_float
    from btle_tpu_torch.spec.bits import bytes_to_bits

    payload = rng.integers(0, 256, plen, dtype=np.uint8)
    header = 0x02 if ch in (37, 38, 39) else 0x01
    pdu = np.concatenate([[header, plen], payload]).astype(np.uint8)
    i80, q80 = gfsk_modulate_float(assemble_phy_bits(bytes_to_bits(pdu), ch), 80)
    return pdu, i80.astype(np.float32), q80.astype(np.float32)


def scene(plan, n_samples: int, seed: int, noise_std: float = 2.0):
    """plan: [(channel, wideband offset)] -> (wi, wq, [(channel, pdu)])."""
    from btle_tpu_torch.wideband import compose_wideband

    rng = np.random.default_rng(seed)
    placements, injected = [], []
    for ch, off in plan:
        pdu, ci, cq = packet(rng, ch, int(rng.integers(10, 31)))
        placements.append((ch, off, ci, cq))
        injected.append((ch, pdu))
    wi, wq = compose_wideband(placements, n_samples)
    wi += rng.normal(0, noise_std, n_samples).astype(np.float32)
    wq += rng.normal(0, noise_std, n_samples).astype(np.float32)
    return wi, wq, injected


def block_samples() -> int:
    from btle_tpu_torch.rx.pipeline import required_halo

    return (SCAN_LEN + required_halo(4, 4)) * 20


def main_path_plan():
    """A 4-block scene: ADV packets on 37/38/39, LL data packets on four
    data channels, one packet across the block-0/1 boundary and 22 packets
    on channel 25 inside block 1 (more than the 16 candidate slots)."""
    step = SCAN_LEN * 20
    plan = [(37, 500_000), (38, 3_000_000), (39, 5_800_000), (37, 8_000_000),
            (3, 1_200_000), (17, 4_400_000), (30, 7_100_000), (10, 9_500_000),
            (12, step - 8_000)]
    plan += [(25, step + 60_000 + 110_000 * k) for k in range(22)]
    return plan, 3 * step + block_samples()


def nb_burst(pdu, ch: int, aa: int = ADV_AA, crc_hex: str = "555555",
             sps: int = NB_SPS, amplitude: float = NB_AMPLITUDE):
    """A narrowband burst of the PDU bytes on channel ch: (i, q) float."""
    from btle_tpu_torch.golden import assemble_phy_bits, gfsk_modulate_float
    from btle_tpu_torch.spec.bits import bytes_to_bits

    bits = assemble_phy_bits(bytes_to_bits(np.asarray(pdu, np.uint8)), ch,
                             crc_init_hex=crc_hex,
                             access_address_hex=aa.to_bytes(4, "little").hex())
    return gfsk_modulate_float(bits, sps, amplitude)


def connect_req_pdu(aa: int = CONN_AA, crc_hex: str = CONN_CRC_HEX,
                    hop: int = CONN_HOP, interval: int = CONN_INTERVAL) -> np.ndarray:
    """CONNECT_REQ to access address aa, CRC init crc_hex, hop increment
    hop, interval in 1.25 ms units, all 37 data channels used
    (tests/test_hop.py's, by default CONN_*)."""
    payload = (bytes.fromhex("001830EA965F")[::-1] + bytes.fromhex("90D7EBB19299")[::-1]
               + aa.to_bytes(4, "little") + bytes.fromhex(crc_hex)
               + bytes([0x02]) + (0x000F).to_bytes(2, "little")
               + interval.to_bytes(2, "little") + (0).to_bytes(2, "little")
               + (0x07D0).to_bytes(2, "little") + bytes.fromhex("1FFFFFFFFF")[::-1]
               + bytes([hop | (5 << 5)]))
    return np.frombuffer(bytes([0x05, len(payload)]) + payload, np.uint8)


def narrowband_scene(seed: int = 7):
    """1 s of air at 4 Msps on channel 37: ADV_NONCONN_IND packets of 6-37
    payload bytes every 10 ms for 450 ms (one across the third
    131072-sample block boundary), a CONNECT_REQ, then LL data packets on
    the connection's hop sequence (9, 18, 27, ...). Each data packet lies
    just after the first 131072-sample boundary at which the hop tracker
    retunes (more than interval - 7 ms after the previous packet): that
    boundary is also an 8192-sample one, so the packet is in reach at
    both block sizes. Returns (i, q int16, [(channel, access address,
    pdu bytes)] in air order)."""
    rng = np.random.default_rng(seed)
    plan = []
    for k in range(45):
        payload = rng.integers(0, 256, 6 + (7 * k) % 32, dtype=np.uint8)
        plan.append((2000 + 40_000 * k, 37, ADV_AA, "555555",
                     np.concatenate([[0x02, len(payload)], payload])))
    payload = rng.integers(0, 256, 37, dtype=np.uint8)
    plan.append((3 * SCAN_LEN - 600, 37, ADV_AA, "555555",
                 np.concatenate([[0x02, 37], payload])))
    conn_pos = 1_802_000
    plan.append((conn_pos, 37, ADV_AA, "555555", connect_req_pdu()))
    interval_samples = (CONN_INTERVAL * 1250 - HOP_GUARD_US + 1000) * NB_SPS
    pos, hop_chan, wait = conn_pos, 0, 0
    while True:
        boundary = ((pos + wait) // SCAN_LEN + 1) * SCAN_LEN
        pos = boundary + 2000 + int(rng.integers(0, 4000))
        if pos > NB_SAMPLES - 2 * SCAN_LEN:
            break
        hop_chan = (hop_chan + CONN_HOP) % 37
        payload = rng.integers(0, 256, int(rng.integers(2, 28)), dtype=np.uint8)
        plan.append((pos, hop_chan, CONN_AA, CONN_CRC_HEX,
                     np.concatenate([[0x01, len(payload)], payload])))
        wait = interval_samples
    i = rng.normal(0, NB_NOISE_STD, NB_SAMPLES)
    q = rng.normal(0, NB_NOISE_STD, NB_SAMPLES)
    want = []
    for pos, ch, aa, crc_hex, pdu in sorted(plan, key=lambda p: p[0]):
        ci, cq = nb_burst(pdu, ch, aa, crc_hex)
        i[pos:pos + len(ci)] += ci
        q[pos:pos + len(cq)] += cq
        want.append((ch, aa, pdu.astype(np.uint8).tobytes()))
    clip = lambda x: np.clip(np.round(x), -32768, 32767).astype(np.int16)
    return clip(i), clip(q), want


def wideband_cli_scene(air_s: float = WB_AIR_S, seed: int = 21):
    """air_s seconds of 80 Msps air at int8 amplitude: ADV_NONCONN_IND of
    6-30 payload bytes every 4 ms rotating over 37/38/39, the two
    CONNECT_REQs of WB_CONNS, and per connection LL data packets (LLID 1,
    2-27 payload bytes) on its hop channels: the first two blocks after
    its CONNECT_REQ's block, each later one in the second block after the
    hop tick that moves the connection on (the first tick more than
    interval - 7 ms after the previous packet). One block of slack on
    each side of a retune keeps every packet keyed alike whether the
    re-keyed tables reach the next block (file run) or the one after
    (run_live at pipeline 2). Returns (i, q int8, [(channel, access
    address, pdu bytes)])."""
    from btle_tpu_torch.wideband import compose_wideband

    rng = np.random.default_rng(seed)
    n = int(air_s * 80e6)
    end_us = int(air_s * 1e6) - 4000
    plan = [(t, ch, ADV_AA, "555555", connect_req_pdu(aa, crc, hop, interval))
            for aa, crc, hop, interval, ch, t in WB_CONNS]
    for k, t in enumerate(range(2200, end_us, 4000)):
        payload = rng.integers(0, 256, int(rng.integers(6, 31)), dtype=np.uint8)
        plan.append((t, (37, 38, 39)[k % 3], ADV_AA, "555555",
                     np.concatenate([[0x02, len(payload)], payload])))
    owned = {}                       # aa -> [(from_us, channel)]
    for aa, crc, hop, interval, _, t_cr in WB_CONNS:
        block = t_cr // WB_BLOCK_US + 2
        chan, owned[aa] = hop % 37, [(t_cr, hop % 37)]
        while True:
            t = block * WB_BLOCK_US + 300 + int(rng.integers(0, 1200))
            # the tracker marks the packet ~20 us after t (preamble and
            # filter delay): keep t + interval - guard clear of a tick
            due = t + interval * 1250 - HOP_GUARD_US
            if (due + 250) // WB_BLOCK_US != due // WB_BLOCK_US:
                t += 300
                due += 300
            if t > end_us:
                break
            payload = rng.integers(0, 256, int(rng.integers(2, 28)), dtype=np.uint8)
            plan.append((t, chan, aa, crc,
                         np.concatenate([[0x01, len(payload)], payload])))
            tick = due // WB_BLOCK_US + 1
            chan = (chan + hop) % 37
            owned[aa].append((tick * WB_BLOCK_US, chan))
            block = tick + 1
        # no packet after the last retune: the tracker skips on every
        # interval - 4 ms
        t_hop = owned[aa][-1][0]
        while t_hop < end_us:
            t_hop = ((t_hop + interval * 1250 - 4000) // WB_BLOCK_US + 1) * WB_BLOCK_US
            chan = (chan + hop) % 37
            owned[aa].append((t_hop, chan))
    # a data packet must not fall where the other connection owns its
    # channel, now or one block before (the earlier-registered connection
    # would key it)
    for t, ch, aa, _, _ in plan:
        for other, spans in owned.items():
            held = {c for k, (start, c) in enumerate(spans)
                    if start <= t and (k + 1 == len(spans)
                                       or spans[k + 1][0] > t - WB_BLOCK_US)}
            if other != aa and ch not in (37, 38, 39) and ch in held:
                raise AssertionError(f"scene: channel {ch} collides at {t} us")
    placements, want = [], []
    for t, ch, aa, crc_hex, pdu in sorted(plan, key=lambda p: p[0]):
        ci, cq = nb_burst(pdu, ch, aa, crc_hex, sps=80, amplitude=WB_AMPLITUDE)
        placements.append((ch, t * 80, ci.astype(np.float32), cq.astype(np.float32)))
        want.append((ch, aa, pdu.astype(np.uint8).tobytes()))
    wi, wq = compose_wideband(placements, n)
    wi += rng.normal(0, WB_NOISE_STD, n).astype(np.float32)
    wq += rng.normal(0, WB_NOISE_STD, n).astype(np.float32)
    clip = lambda x: np.clip(np.round(x), -127, 127).astype(np.int8)
    return clip(wi), clip(wq), want


def pcap_records(raw: bytes):
    """[(channel, access address, pdu bytes)] of a PcapWriter stream."""
    import struct

    out, off = [], 24
    while off + 16 <= len(raw):
        caplen = struct.unpack(">IIII", raw[off:off + 16])[2]
        rec = raw[off + 16:off + 16 + caplen]
        off += 16 + caplen
        out.append((rec[0], struct.unpack("<I", rec[10:14])[0], bytes(rec[14:])))
    return out


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def cuda_time_ms(fn, reps: int, warm: int = 2) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def check_kernels(dev):
    """Phase 2: each kernel against its twin on one bench-geometry block."""
    import torch

    from btle_tpu_torch.rx.decode_kernel import decode_candidates, decode_candidates_reference
    from btle_tpu_torch.rx.pipeline import earliest_hits
    from btle_tpu_torch.wideband import fused
    from btle_tpu_torch.wideband.sniffer import default_scan_tables

    n = block_samples() + NUM_TAPS - 1
    plan = [(37, 40_000), (5, 400_000), (21, 900_000), (38, 1_500_000),
            (33, 2_100_000), (39, 2_600_000)]
    wi, wq, _ = scene(plan, n, seed=1)
    xi, xq = torch.as_tensor(wi, device=dev), torch.as_tensor(wq, device=dev)
    aa, mask, whiten, crc, adv = default_scan_tables(dev)
    operands, report = {}, {}
    # every filterbank kernel forms the same exact products as its twin
    # (bf16 x bf16, hi+lo sums and f32 x f32 are exact in float32) and
    # sums them in another order: max |dy| within 1e-5 of max |y|
    for mode, inner, name in FILTERBANK_MODES:
        fb_args, tail_args = fused.frontend_operands(
            xi, xq, aa, mask, NUM_TAPS, True, 4, 4, mode, 1.0, dev, inner)
        kern, twin = fused.FILTERBANKS[fused.filterbank_kind(mode, inner)]
        y, y_ref = kern(*fb_args), twin(*fb_args)
        torch.cuda.synchronize()
        diff = (y - y_ref).abs()
        worst = divmod(int(diff.argmax()), diff.shape[1])
        err = float(diff[worst])
        scale = float(y_ref.abs().max())
        ok = err <= 1e-5 * scale and bool(torch.isfinite(y).all())
        # where the largest error lies: its (row, column) and y there
        report[name] = {"max_abs_err": err, "max_abs_y": scale, "ok": ok,
                        "worst_at": list(worst), "y_at_worst": float(y_ref[worst])}
        operands[name] = (fb_args, tail_args, y_ref)
        if not ok:
            raise AssertionError(f"{name} disagrees with its twin: {report[name]}")

    library = filterbank_library_calls(operands)
    for name, tol in (("filterbank_bf16x2w", 1e-2), ("filterbank_polyx_f32", 1e-5),
                      ("filterbank_im2col_bf16", 1e-2),
                      ("filterbank_im2col_f32x2", 1e-2),
                      ("filterbank_im2col_f32", 1e-5)):
        y_ref = operands[name][2]
        err = float((library[name]() - y_ref).abs().max())
        report[name]["library_max_abs_err"] = err
        if not err <= tol * float(y_ref.abs().max()):
            raise AssertionError(f"the library yardstick of {name} computes "
                                 f"another function: max |dy| {err}")

    tail_err, n_hits = 0.0, 0
    for mode in ("filterbank_bf16x2w", "filterbank_polyx_f32"):
        _, tail_args, y_ref = operands[mode]
        got = fused.demod_tail(y_ref, *tail_args)
        want = fused.demod_tail_reference(y_ref, *tail_args)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(
                f"demod_tail ({mode}): bits differ at "
                f"{int((got[0] != want[0]).sum())}, hits at "
                f"{int((got[1] != want[1]).sum())} positions")
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
        tail_err = max(tail_err, float((got[2] - want[2]).abs().max()))
        n_hits += int(want[1].sum())
    report["demod_tail"] = {"max_abs_err": tail_err, "hits": n_hits, "ok": True}
    if n_hits < len(plan):
        raise AssertionError(f"only {n_hits} AA hits for {len(plan)} packets")

    _, tail_args, y_ref = operands["filterbank_bf16x2w"]
    bits, hit, _ = fused.demod_tail(y_ref, *tail_args)
    pos, _, _ = earliest_hits(hit, MAX_CANDIDATES)
    gen = torch.Generator(device=dev).manual_seed(5)
    rand_pos = torch.randint(0, bits.shape[1] + 64, pos.shape, generator=gen,
                             device=dev, dtype=torch.int32)
    dec_err = 0
    for p in (pos, rand_pos):
        got = decode_candidates(bits, p, whiten, crc, adv, sps=4)
        want = decode_candidates_reference(bits, p, whiten, crc, adv, sps=4)
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError("decode_candidates disagrees with its twin")
            dec_err = max(dec_err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    report["decode_candidates"] = {"max_abs_err": dec_err, "ok": True}
    return report, operands, (bits, pos, whiten, crc, adv), library, (xi, xq, aa, mask)


def filterbank_library_calls(operands) -> dict:
    """One cuDNN convolution per filterbank kernel computing the same y,
    timed as a yardstick only (the port never calls them): the kernel's
    own frames with its im2col weight table unfolded to (rows, frame
    rows, width) —
      filterbank_bf16x2w, filterbank_im2col_f32x2 (hilo_library_call):
        bf16 on tensor cores,
        the (160, ., width) hi/lo rows, then the hi and lo halves summed
        in f32 (at f32x2 over the 80 [xhi; xlo] frame rows);
      filterbank_im2col_bf16: bf16, the (80, 40, width) hi weights;
      filterbank_im2col_f32, filterbank_polyx_f32 (the same function):
        float32 frames and the folded (80, 40, width) weights in true FP32.
    cuDNN writes bf16 outputs, so the bf16 yardsticks round y (or each
    half) to 8 mantissa bits, which the kernels do not (checked to 1e-2
    of max|y|)."""
    import torch

    from btle_tpu_torch.wideband.channelizer import true_fp32

    calls = {name: hilo_library_call(operands[name][0])
             for name in ("filterbank_bf16x2w", "filterbank_im2col_f32x2")}
    for name in ("filterbank_im2col_bf16", "filterbank_im2col_f32"):
        frames, gk, width = operands[name][0][:3]
        if name == "filterbank_im2col_f32":      # the (40, S, 80) table
            w = gk.permute(2, 0, 1)[:, :, :width].contiguous()
        else:
            n_chunks, rows, cols = gk.shape
            fb_rows = frames.shape[0]
            w = (gk.reshape(n_chunks, rows, cols // fb_rows, fb_rows).permute(1, 3, 0, 2)
                 .reshape(rows, fb_rows, -1)[:, :, :width].contiguous())

        def call(x=frames[None], w=w):
            with true_fp32():
                return torch.nn.functional.conv1d(x, w)[0].to(torch.float32)
        calls[name] = call
    calls["filterbank_polyx_f32"] = calls["filterbank_im2col_f32"]
    return calls


def hilo_library_call(fb_args):
    """The cuDNN yardstick of the tensor-core hi/lo filterbank: the
    frames as (40, J) bf16 rows ([xhi; xlo], 80 rows, at f32x2), the
    (K_pad, 160) table unfolded to (160, rows, width) bf16 conv weights
    (each column over both halves at f32x2), one convolution, the hi and
    lo halves summed in f32."""
    import torch

    from btle_tpu_torch.wideband import fused
    from btle_tpu_torch.wideband.channelizer import true_fp32

    frames, b, width = fb_args[:3]
    w = fused._hilo_conv_weights(b, width).to(torch.bfloat16)
    if frames.ndim == 3:
        x = frames.permute(0, 2, 1).reshape(2 * frames.shape[2], -1)
        w = torch.cat([w, w], dim=1)
    else:
        x = frames.t()
    x, w = x.contiguous()[None], w.contiguous()

    def call():
        with true_fp32():
            y = torch.nn.functional.conv1d(x, w)[0].to(torch.float32)
        return y[:80] + y[80:]
    return call


def hilo_grid(dev, ky: int) -> dict:
    """The tensor-core filterbank's column tile and grid at ky columns."""
    import torch

    from btle_tpu_torch.wideband import fused

    warps = fused.hilo_warps_m(ky, torch.cuda.get_device_properties(dev).multi_processor_count)
    return {"columns": ky, "tile_columns": 64 * warps, "ctas": -(-ky // (64 * warps))}


def hilo_bound(fb_args, products: int):
    """bound_ms of the hi/lo filterbank: frames, weights and y moved once;
    ``products`` bf16 products (2 FLOP each) per weight term and column."""
    frames, b, width, ky = fb_args[:4]
    return dict(zip(("bound_ms", "bound_by"), bound_ms(
        frames.numel() * 2 + b.numel() * 2 + 80 * ky * 4,
        products * 2 * 80 * 40 * width * ky, BF16_FLOPS)))


def time_live_k1(dev) -> dict:
    """K1 at the live block's shape (the CLI's 8192-sample blocks, 1279
    samples of filter context, noise of std 30): within 1e-5 of max |y|
    of its twin, its device time, grid, bound and cuDNN yardstick."""
    import torch

    from btle_tpu_torch.rx.pipeline import required_halo
    from btle_tpu_torch.wideband import fused
    from btle_tpu_torch.wideband.sniffer import default_scan_tables

    n = (WB_SCAN_LEN + required_halo(4, 4)) * 20 + NUM_TAPS - 1
    gen = torch.Generator(device=dev).manual_seed(9)
    xi, xq = (30.0 * torch.randn(n, generator=gen, device=dev) for _ in range(2))
    aa, mask = default_scan_tables(dev)[:2]
    fb, _ = fused.frontend_operands(xi, xq, aa, mask, NUM_TAPS, True, 4, 4,
                                    "bf16x2w", 1.0, dev)
    y, y_ref = fused.filterbank_bf16x2w(*fb), fused.filterbank_bf16x2w_reference(*fb)
    torch.cuda.synchronize()
    err, scale = float((y - y_ref).abs().max()), float(y_ref.abs().max())
    if not (err <= 1e-5 * scale and bool(torch.isfinite(y).all())):
        raise AssertionError(f"filterbank_bf16x2w at the live shape: max |dy| "
                             f"{err} at max |y| {scale}")
    return {**hilo_grid(dev, fb[3]), "max_abs_err": err, "max_abs_y": scale,
            **kernel_times(fused.FILTERBANK_BF16X2W, lambda: fused.filterbank_bf16x2w(*fb),
                           lambda: fused.filterbank_bf16x2w_reference(*fb), 50,
                           library=hilo_library_call(fb)),
            **hilo_bound(fb, 2)}


# the sources whose ptxas report must show no spills: the tensor-core
# filterbank (K1, K5 f32x2), the FP32 SGEMM filterbank (K5 f32) and K10
NO_SPILL_SOURCES = ("filterbank_hilo_mma", "filterbank_sgemm_f32", "shift_fma")


def launch_plans(dev) -> dict:
    """The launch shapes of the redesigned CUDA-core kernels at the shapes
    the timing phase gives them: dynamic shared memory, resident CTAs per
    SM, grid, threads and columns per CTA (their sources' _plan entry)."""
    import torch

    from btle_tpu_torch.rx.pipeline import required_halo
    from btle_tpu_torch.tools import _kernels as K
    from btle_tpu_torch.tools import dev_rollscale
    from btle_tpu_torch.wideband import fused

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ky = SCAN_LEN + required_halo(4, 4)     # the bench block's y columns
    out = {"filterbank_im2col_f32": fused.FILTERBANK_IM2COL["f32_im2col"].plan(
        ky, 65, fused.sgemm_warps(ky, sms))}
    n_cols = dev_rollscale.N_TILES * dev_rollscale.T
    for rows, n, step, _ in dev_rollscale.CONFIGS[:3]:
        out[f"shift_fma R{rows}"] = K.SHIFT_FMA.plan(rows, n, step, n_cols, 1)
    return out


def event_trials(fn, reps: int, trials: int = 5) -> list:
    """ms per call of ``fn``, CUDA events around ``reps`` calls, for each
    of ``trials`` runs (the spread beside the profiler's device time)."""
    return [cuda_time_ms(fn, reps, warm=1 if t else 2) for t in range(trials)]


def zero_launches(kernels) -> None:
    for k in kernels:
        k.launches = 0


def read_launches(kernels) -> dict:
    return {k.name: k.launches for k in kernels}


def run_main_path(dev, mode: str, wi, wq, injected, kernels):
    from btle_tpu_torch.wideband import WidebandConfig, WidebandSniffer

    sn = WidebandSniffer(WidebandConfig(fused=True, fused_dtype=mode,
                                        scan_len_ch=SCAN_LEN,
                                        max_candidates=MAX_CANDIDATES),
                         device=dev)
    zero_launches(kernels)
    t0 = time.perf_counter()
    pkts = sn.run(wi, wq)
    seconds = time.perf_counter() - t0
    launches = read_launches(kernels)
    got = sorted((p.channel, p.pdu_bytes.tobytes()) for p in pkts if p.crc_ok)
    want = sorted((ch, pdu.tobytes()) for ch, pdu in injected)
    missing = [w for w in want if w not in got]
    extra = [g for g in got if g not in want]
    line = {"phase": "main_path", "mode": mode, "blocks": 4,
            "seconds": seconds, "injected": len(want), "crc_ok": len(got),
            "missing": len(missing), "extra": len(extra),
            "truncated_channels": sn.truncated_channels, "launches": launches}
    log(line)
    if missing or extra or len(got) != len(want):
        raise AssertionError(f"main path ({mode}): missing {missing[:3]}, "
                             f"extra {extra[:3]}")
    if sn.truncated_channels < 1:
        raise AssertionError("slot overflow never forced a rescan")
    needed = {"bf16x2w": "filterbank_bf16x2w", "f32": "filterbank_polyx_f32"}
    for name in (needed[mode], "demod_tail", "decode_candidates", "scan_block"):
        if launches[name] <= 0:
            raise AssertionError(f"main path ({mode}) never launched {name}")
    return launches


def sniff_narrowband(dev, i, q, scan_len: int):
    """One Sniffer run over the narrowband scene with NDJSON and pcap to
    memory: (sniffer, events, ndjson text, pcap bytes, wall seconds)."""
    import torch

    from btle_tpu_torch.stream import (NdjsonEmitter, PcapWriter, Sniffer,
                                       SnifferConfig, array_source)

    buf, pc = io.StringIO(), io.BytesIO()
    sn = Sniffer(SnifferConfig(channel=37, sps=NB_SPS, hop=True, rssi=True,
                               scan_len=scan_len),
                 ndjson=NdjsonEmitter(buf), pcap=PcapWriter(pc),
                 quiet_text=True, device=dev)
    t0 = time.perf_counter()
    events = sn.run(array_source(i, q))
    torch.cuda.synchronize()
    return sn, events, buf.getvalue(), pc.getvalue(), time.perf_counter() - t0


def ndjson_without_ts(text: str) -> list:
    out = []
    for line in text.splitlines():
        obj = json.loads(line)
        obj.pop("ts")
        out.append(obj)
    return out


def run_narrowband(dev, i, q, want, kernels) -> dict:
    """Phase 5: the narrowband Sniffer at both block sizes, each with the
    launch counts zeroed just before and read just after."""
    runs = {}
    for scan_len in (SCAN_LEN, NB_LIVE_SCAN_LEN):
        zero_launches(kernels)
        sn, events, ndjson, pcap, seconds = sniff_narrowband(dev, i, q, scan_len)
        launches = read_launches(kernels)
        recs = pcap_records(pcap)
        if len(recs) != len(events):
            raise AssertionError("pcap records and packet events differ in number")
        got = [r for e, r in zip(events, recs) if e.crc_ok]
        hop = [e.event for e in sn.hop_tracker.events]
        missing = [w for w in want if w not in got]
        extra = [g for g in got if g not in want]
        line = {"phase": "narrowband_main_path", "scan_len": scan_len,
                "air_s": NB_SAMPLES / (NB_SPS * 1e6), "seconds": seconds,
                "scheduled": len(want), "events": len(events),
                "crc_ok": len(got), "missing": len(missing),
                "extra": len(extra), "hop_events": hop[:4],
                "n_hop_events": len(hop), "launches": launches}
        log(line)
        if got != want:
            raise AssertionError(f"narrowband ({scan_len}): missing {missing[:3]}, "
                                 f"extra {extra[:3]}")
        if hop[:2] != ["track_start", "chan_change"]:
            raise AssertionError(f"narrowband ({scan_len}): hop events {hop[:4]}")
        for name in ("scan_block", "decode_candidates"):
            if launches[name] <= 0:
                raise AssertionError(f"narrowband ({scan_len}) never launched {name}")
        runs[scan_len] = {
            "events": [(e.ts_us, e.pkt_count, e.channel, e.access_addr, e.crc_ok,
                        e.payload_bytes, e.rssi_dbm) for e in events],
            "ndjson": ndjson, "launches": launches}
    pkt_lines = [[o for o in ndjson_without_ts(r["ndjson"]) if o["t"] == "pkt"]
                 for r in runs.values()]
    if runs[SCAN_LEN]["events"] != runs[NB_LIVE_SCAN_LEN]["events"] \
            or pkt_lines[0] != pkt_lines[1]:
        raise AssertionError("the narrowband event lists differ between block sizes")

    return runs


def run_golden(dev, scan_block_kernel) -> dict:
    """golden_decode (lag = sps = 8) on one ADV_IND: CRC-OK, byte-exact,
    through the scan kernel."""
    from btle_tpu_torch.rx.decoder import golden_decode
    from btle_tpu_torch.spec.bits import bits_to_bytes

    rng = np.random.default_rng(8)
    pdu = np.concatenate([[0x00, 20], rng.integers(0, 256, 20)]).astype(np.uint8)
    ci, cq = nb_burst(pdu, 37, sps=8, amplitude=127.0)
    gi, gq = (np.round(np.concatenate([np.zeros(900), c, np.zeros(900)])
                       + rng.normal(0, 3, len(c) + 1800)).astype(np.int16)
              for c in (ci, cq))
    scan_block_kernel.launches = 0
    res = golden_decode(gi, gq, 37, sps=8, device=dev)
    golden = {"crc_ok": res.crc_ok, "payload_len": res.payload_len,
              "best_phase": res.best_phase,
              "byte_exact": bits_to_bytes(res.pdu_bits).tobytes() == pdu.tobytes(),
              "scan_block_launches": scan_block_kernel.launches}
    log({"phase": "golden_decode", "sps": 8, **golden})
    if not (res.crc_ok and golden["byte_exact"] and golden["scan_block_launches"]):
        raise AssertionError(f"golden_decode at sps 8: {golden}")
    return golden


def run_cli(i, q, library_ndjson: str) -> dict:
    """Phase 6: the decode CLI on the scene as an i16 file, in a child
    process on the card; its NDJSON must equal the library run's at the
    file block size (timestamps aside)."""
    path = ROOT / "build" / "chip_smoke" / "narrowband.i16"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.stack([i, q], axis=1).reshape(-1).tofile(path)
    cmd = [sys.executable, "-m", "btle_tpu_torch.cli", "decode", "--bin",
           str(path), "--format", "i16", "--channel", "37", "--sps", "4",
           "--hop", "--rssi", "--json"]
    try:
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        seconds = time.perf_counter() - t0
    finally:
        path.unlink()
    lines = ndjson_without_ts(proc.stdout) if proc.returncode == 0 else []
    want = ndjson_without_ts(library_ndjson)
    line = {"phase": "cli", "rc": proc.returncode, "seconds": seconds,
            "lines": len(lines), "pkt_lines": sum(o["t"] == "pkt" for o in lines),
            "equal_to_library": lines == want,
            "summary": proc.stderr.strip().splitlines()[-1:]}
    log(line)
    if proc.returncode != 0 or lines != want:
        raise AssertionError(f"decode CLI: rc {proc.returncode}, stderr "
                             f"{proc.stderr[-2000:]}")
    return line


def run_knob_matrix(dev, kernels) -> dict:
    """Phase 3b: every knob-matrix row's self-test on the card."""
    from btle_tpu_torch.wideband import knobmatrix

    zero_launches(kernels)
    rows = knobmatrix.run(dev)
    launches = read_launches(kernels)
    failed = [r for r in rows if r["expected"] == "pass" and r["status"] != "pass"]
    log({"phase": "knob_matrix", "rows": rows, "failed": len(failed),
         "launches": launches})
    if failed:
        raise AssertionError(f"knob matrix: {len(failed)} rows failed: {failed[:2]}")
    return launches


def wideband_runner(dev, mode: str, ndjson_buf, pcap_buf):
    """The CLI's WidebandStreamRunner for ``wideband --fused --fused-dtype
    MODE --follow --max-follow 2 --json --pcap``, writing to memory."""
    from btle_tpu_torch.stream import NdjsonEmitter, PcapWriter
    from btle_tpu_torch.wideband import WidebandConfig, WidebandSniffer
    from btle_tpu_torch.wideband.stream import WidebandStreamRunner

    sn = WidebandSniffer(WidebandConfig(follow_connections=True, max_follow=2,
                                        fused=True, fused_dtype=mode,
                                        scan_len_ch=WB_SCAN_LEN), device=dev)
    return WidebandStreamRunner(sn, ndjson=NdjsonEmitter(ndjson_buf),
                                pcap=PcapWriter(pcap_buf))


def packet_keys(pkts) -> list:
    return [(p.channel, p.sample_pos, p.crc_ok, p.access_addr,
             p.pdu_bytes.tobytes()) for p in pkts]


def hop_keys(runner) -> list:
    return [(e.event, e.channel, e.access_addr, e.time_us)
            for e in runner.follow_events()]


def check_wideband_packets(label: str, pkts, want) -> dict:
    got = sorted((p.channel, p.access_addr, p.pdu_bytes.tobytes())
                 for p in pkts if p.crc_ok)
    missing = [w for w in sorted(want) if w not in got]
    extra = [g for g in got if g not in want]
    if missing or extra or len(got) != len(want):
        raise AssertionError(f"{label}: missing {missing[:3]}, extra {extra[:3]}")
    return {"crc_ok": len(got), "missing": 0, "extra": 0}


def timed_sniffer(sn) -> dict:
    """Wrap a sniffer's dispatch, result wait and consume in host timers:
    {"dispatch_s", "wait_s", "consume_s"} (consume includes the wait)."""
    acc = {"dispatch_s": 0.0, "wait_s": 0.0, "consume_s": 0.0}

    def timed(fn, key):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[key] += time.perf_counter() - t0
        return call
    sn.scan_async = timed(sn.scan_async, "dispatch_s")
    sn._wait = timed(sn._wait, "wait_s")
    sn.consume_scan = timed(sn.consume_scan, "consume_s")
    return acc


def run_live_ring(dev, mode: str, wi, wq, pipeline: int = 2, timers: bool = False):
    """run_live over the native ring preloaded with the scene (int8 pairs)
    and one block of quiet air, NDJSON and pcap to memory:
    (runner, packets, stats, host timers or None)."""
    from btle_tpu_torch import runtime

    if not runtime.available():
        raise AssertionError("the native runtime did not build")
    runner = wideband_runner(dev, mode, io.StringIO(), io.BytesIO())
    sn = runner.sn
    inter = np.zeros(2 * (len(wi) + sn.wb_block_len), np.int8)
    inter[0:2 * len(wi):2], inter[1:2 * len(wi):2] = wi, wq
    ring = runtime.IqRingBuffer(1 << (len(inter) // 2).bit_length())
    if ring.write(inter, "i8") != len(inter) // 2:
        raise AssertionError("the ring dropped samples while preloading")
    pkts = []

    def consume(handle, inner=runner.consume):
        got = inner(handle)
        pkts.extend(got)
        return got
    runner.consume = consume
    acc = timed_sniffer(sn) if timers else None
    step, halo = WB_SCAN_LEN * 20, sn.halo_ch * 20
    runner.start()
    stats = runner.run_live(ring, should_stop=lambda: ring.available_pairs < step + halo,
                            pipeline=pipeline)
    runner.stop()
    ring.close()
    return runner, pkts, stats, acc


def run_wideband_cli(dev, kernels) -> tuple[dict, dict]:
    """Phase 6b: the wideband CLI scene through the library runner, the
    CLI in a child process and run_live, in every CLI mode."""
    import torch

    t0 = time.perf_counter()
    wi, wq, want = wideband_cli_scene()
    scene_s = time.perf_counter() - t0
    air_s = len(wi) / 80e6
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    files = {"i8": out_dir / "wideband.i8", "f32": out_dir / "wideband.f32"}
    for fmt, path in files.items():
        inter = np.empty(2 * len(wi), np.int8 if fmt == "i8" else np.float32)
        inter[0::2], inter[1::2] = wi, wq
        inter.tofile(path)
        del inter
    fi, fq = wi.astype(np.float32), wq.astype(np.float32)
    launches = {k.name: 0 for k in kernels}
    report, hops = {}, {}
    try:
        for mode, fmt in CLI_MODES:
            # the library run of the CLI's command
            buf, pc = io.StringIO(), io.BytesIO()
            runner = wideband_runner(dev, mode, buf, pc)
            zero_launches(kernels)
            t1 = time.perf_counter()
            runner.start()
            pkts = runner.run_capture(fi, fq)
            runner.stop()
            torch.cuda.synchronize()
            lib_s = time.perf_counter() - t1
            got = read_launches(kernels)
            line = {"mode": mode, "format": fmt, "blocks": runner.stats.blocks,
                    "library_s": lib_s, "scheduled": len(want),
                    **check_wideband_packets(f"wideband library ({mode})", pkts, want)}
            hops[mode] = hop_keys(runner)
            started = {e[2] for e in hops[mode] if e[0] == "track_start"}
            if started != {c[0] for c in WB_CONNS}:
                raise AssertionError(f"wideband ({mode}): track_start for {started}")
            recs = pcap_records(pc.getvalue())
            if sorted(recs) != sorted((p.channel, p.access_addr, p.pdu_bytes.tobytes())
                                      for p in pkts if p.crc_ok):
                raise AssertionError(f"wideband ({mode}): pcap differs from the packets")
            for name, n in got.items():
                launches[name] += n
            # the CLI in a child process on the same file
            pcap_path = out_dir / f"wideband-{mode}.pcap"
            cmd = [sys.executable, "-m", "btle_tpu_torch.cli", "wideband", "--bin",
                   str(files[fmt]), "--format", fmt, "--fused", "--fused-dtype", mode,
                   "--follow", "--max-follow", "2", "--json", "--pcap", str(pcap_path)]
            t1 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                                  timeout=300)
            cli_s = time.perf_counter() - t1
            lines = ndjson_without_ts(proc.stdout) if proc.returncode == 0 else []
            cli_pcap = pcap_path.read_bytes() if pcap_path.exists() else b""
            line.update({"cli_rc": proc.returncode, "cli_s": cli_s,
                         "ndjson_lines": len(lines),
                         "cli_equal_to_library": lines == ndjson_without_ts(buf.getvalue()),
                         "cli_pcap_records": len(pcap_records(cli_pcap)),
                         "cli_summary": proc.stderr.strip().splitlines()[-3:]})
            if proc.returncode != 0 or not line["cli_equal_to_library"] \
                    or pcap_records(cli_pcap) != recs:
                raise AssertionError(f"wideband CLI ({mode}): rc {proc.returncode}, "
                                     f"stderr {proc.stderr[-2000:]}")
            # run_live over the ring: the same packets as the file run
            zero_launches(kernels)
            _, live_pkts, stats, acc = run_live_ring(dev, mode, wi, wq, timers=True)
            for name, n in read_launches(kernels).items():
                launches[name] += n
            if packet_keys(live_pkts) != packet_keys(pkts):
                raise AssertionError(f"wideband run_live ({mode}) differs from the file run")
            live_air = stats.blocks * WB_BLOCK_US * 1e-6
            line["live"] = {"pipeline": 2, "blocks": stats.blocks,
                            "wall_s": stats.wall_s, "air_s": live_air,
                            "realtime_factor": live_air / stats.wall_s,
                            "ms_per_block": 1e3 * stats.wall_s / stats.blocks,
                            "dropped_pairs": stats.dropped_pairs,
                            "host_ms_per_block": {k: 1e3 * v / stats.blocks
                                                  for k, v in acc.items()},
                            "equal_to_file_run": True}
            line["launches"] = got
            report[mode] = line
            log({"phase": "wideband_cli", **line})
    finally:
        for path in [*files.values(), *out_dir.glob("wideband-*.pcap")]:
            path.unlink(missing_ok=True)
    first = hops[CLI_MODES[0][0]]
    if any(h != first for h in hops.values()):
        raise AssertionError("the hop events differ between modes")
    log({"phase": "wideband_cli_hops", "air_s": air_s, "scene_s": scene_s,
         "events": len(first), "first": first[:4], "equal_across_modes": True})
    profiles = {mode: device_profile(lambda m=mode: run_live_ring(dev, m, wi, wq),
                                     report[mode]["live"]["blocks"])
                for mode, _ in CLI_MODES}
    log({"phase": "profile_wideband_live", "pipeline": 2, **profiles})
    return report, launches


# --------------------------------------------------------------------------
# TX: the tx CLI on the card, looped back through decode and wideband
# --------------------------------------------------------------------------


# one packet on each of several channels across the band, on the
# advertising access address (the wideband sniffer's default keys)
TX_BAND_CHANNELS = (0, 5, 10, 16, 22, 28, 33, 36, 38, 39)
TX_WIDEBAND_NOISE = 2.0


def tx_descriptors(seed: int = 44) -> list:
    """Every descriptor line of examples/packets/*.txt (its Space set to
    1 ms, so the 80 Msps file stays small) and one packet per channel of
    TX_BAND_CHANNELS: ADV_NONCONN_IND on 38/39, LL data (LLID 1) on the
    advertising access address elsewhere."""
    import re

    out = []
    for path in sorted((ROOT / "examples" / "packets").glob("*.txt")):
        for line in path.read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#") or re.fullmatch(r"r-?\d+", line):
                continue
            spaced = re.sub(r"-Space-\d+", "-Space-1", line, flags=re.IGNORECASE)
            out.append(spaced if spaced != line else line + "-Space-1")
    rng = np.random.default_rng(seed)
    for ch in TX_BAND_CHANNELS:
        data = bytes(rng.integers(0, 256, int(rng.integers(4, 26)), dtype=np.uint8)).hex()
        if ch in (37, 38, 39):
            adva = bytes(rng.integers(0, 256, 6, dtype=np.uint8)).hex()
            out.append(f"{ch}-ADV_NONCONN_IND-TxAdd-0-RxAdd-0-AdvA-{adva}"
                       f"-AdvData-{data}-Space-1")
        else:
            out.append(f"{ch}-LL_DATA-AA-8E89BED6-LLID-1-NESN-0-SN-0-MD-0"
                       f"-DATA-{data}-CRCInit-555555-Space-1")
    return out


def spec_keys(spec):
    """(on-air access address hex, its display value, CRC init hex, PDU
    bytes) of a parsed packet."""
    from btle_tpu_torch.spec import bits as B

    aa = bytes(B.bits_to_bytes(spec.info_bits[spec.pdu_start - 32: spec.pdu_start]))
    pdu = bytes(B.bits_to_bytes(spec.info_bits[spec.pdu_start:]))
    return aa.hex(), int.from_bytes(aa, "little"), spec.crc_init_hex, pdu


def run_tx(dev, kernels) -> dict:
    """The "tx" phase: the tx CLI in child processes on the card (--out
    f32 with --wideband-out, then --out i8), its files equal to the
    library's; the 4 Msps stream through the narrowband Sniffer (the
    decode CLI's engine) once per (channel, access address, CRC init) of
    the plan and through the decode CLI on channel 37; the 80 Msps
    capture through WidebandSniffer(fused=True) in "bf16x2w" and "f32",
    once per (access address, CRC init). Every packet must come back
    CRC-OK and byte-exact on its channel, with no other CRC-OK packet;
    and the modulator's time per packet on the card."""
    import torch

    from btle_tpu_torch.phy.modulator import modulate_batch
    from btle_tpu_torch.stream import PcapWriter, Sniffer, SnifferConfig, iq_file_source
    from btle_tpu_torch.tx import parse_descriptor_sequence, synthesize
    from btle_tpu_torch.tx.synth import plan_to_stream, plan_to_wideband
    from btle_tpu_torch.wideband import WidebandConfig, WidebandSniffer

    descs = tx_descriptors()
    specs, _ = parse_descriptor_sequence(descs)
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    files = {k: out_dir / f"tx.{k}" for k in ("f32", "i8", "wb")}
    report = {"packets": len(specs), "channels": sorted({s.channel for s in specs})}
    try:
        # the CLI in child processes on the card
        cli_s = []
        for extra in (["--out", str(files["f32"]), "--wideband-out", str(files["wb"]),
                       "--wideband-noise", str(TX_WIDEBAND_NOISE)],
                      ["--out", str(files["i8"]), "--out-format", "i8"]):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "btle_tpu_torch.cli", "tx",
                                   *descs, *extra], cwd=ROOT, capture_output=True,
                                  text=True, timeout=300)
            cli_s.append(time.perf_counter() - t0)
            if proc.returncode != 0:
                raise AssertionError(f"tx CLI: rc {proc.returncode}, stderr "
                                     f"{proc.stderr[-2000:]}")
        report["cli_s"] = cli_s
        # the same files from the library
        packets = synthesize(specs, flavor="c", sps=4, device=dev)
        i, q = plan_to_stream(packets, sps=4)
        want = {"f32": np.empty(2 * len(i), np.float32), "i8": np.empty(2 * len(i), np.int8)}
        want["f32"][0::2], want["f32"][1::2] = i / 256.0, q / 256.0
        want["i8"][0::2], want["i8"][1::2] = np.clip(i, -128, 127), np.clip(q, -128, 127)
        wi, wq = plan_to_wideband(specs, noise_std=TX_WIDEBAND_NOISE)
        want["wb"] = np.empty(2 * len(wi), np.float32)
        want["wb"][0::2], want["wb"][1::2] = wi, wq
        for k, path in files.items():
            if path.read_bytes() != want[k].tobytes():
                raise AssertionError(f"tx CLI file {path.name} differs from the library's")
        report["files_equal_to_library"] = True
        report["samples"] = {"stream": len(i), "wideband": len(wi)}

        # every (channel, AA, CRC) of the plan through the narrowband Sniffer
        groups = {}
        for s in specs:
            aa_hex, aa, crc, pdu = spec_keys(s)
            groups.setdefault((s.channel, aa, crc), []).append(pdu)
        nb = {}
        zero_launches(kernels)
        for fmt in ("f32", "i8"):
            ok = 0
            for (ch, aa, crc), pdus in groups.items():
                pc = io.BytesIO()
                sn = Sniffer(SnifferConfig(channel=ch, access_addr=aa, crc_init=int(crc, 16),
                                           sps=4), pcap=PcapWriter(pc), quiet_text=True,
                             device=dev)
                events = sn.run(iq_file_source(str(files[fmt]), fmt))
                recs = pcap_records(pc.getvalue())
                got = sorted(r[2] for e, r in zip(events, recs) if e.crc_ok)
                if got != sorted(pdus) or any(r[0] != ch for r in recs):
                    raise AssertionError(f"tx -> decode ({fmt}, channel {ch}, AA "
                                         f"{aa:08x}): got {len(got)} CRC-OK packets "
                                         f"for {len(pdus)}")
                ok += len(got)
            nb[fmt] = {"groups": len(groups), "crc_ok": ok, "missing": 0, "extra": 0}
        nb["launches"] = read_launches(kernels)
        if nb["launches"]["scan_block"] <= 0 or nb["launches"]["decode_candidates"] <= 0:
            raise AssertionError("tx -> decode never launched the narrowband kernels")
        # the decode CLI on channel 37 (the advertising group), both formats
        for fmt in ("f32", "i8"):
            proc = subprocess.run(
                [sys.executable, "-m", "btle_tpu_torch.cli", "decode", "--bin",
                 str(files[fmt]), "--format", fmt, "--channel", "37", "--sps", "4",
                 "--json"], cwd=ROOT, capture_output=True, text=True, timeout=300)
            pkts = [o for o in ndjson_without_ts(proc.stdout) if o["t"] == "pkt"] \
                if proc.returncode == 0 else []
            n_ok = sum(bool(o.get("crc_ok")) for o in pkts)
            want_ok = len(groups[(37, ADV_AA, "555555")])
            nb[f"cli_{fmt}"] = {"rc": proc.returncode, "crc_ok": n_ok}
            if proc.returncode != 0 or n_ok != want_ok:
                raise AssertionError(f"decode CLI on the tx {fmt} file: rc "
                                     f"{proc.returncode}, {n_ok} CRC-OK for {want_ok}; "
                                     f"stderr {proc.stderr[-2000:]}")
        report["decode"] = nb

        # every (AA, CRC) of the plan through the fused wideband sniffer
        data = np.fromfile(files["wb"], np.float32)
        fi, fq = data[0::2], data[1::2]
        wb_groups = {}
        for s in specs:
            aa_hex, aa, crc, pdu = spec_keys(s)
            wb_groups.setdefault((aa_hex, aa, crc), []).append((s.channel, aa, pdu))
        wb = {}
        for mode in ("bf16x2w", "f32"):
            zero_launches(kernels)
            ok = 0
            for (aa_hex, aa, crc), want_pkts in wb_groups.items():
                sn = WidebandSniffer(WidebandConfig(access_address_hex=aa_hex,
                                                    crc_init_hex=crc, fused=True,
                                                    fused_dtype=mode), device=dev)
                ok += check_wideband_packets(f"tx -> wideband ({mode}, AA {aa:08x})",
                                             sn.run(fi, fq), want_pkts)["crc_ok"]
            torch.cuda.synchronize()
            wb[mode] = {"groups": len(wb_groups), "crc_ok": ok, "missing": 0,
                        "extra": 0, "launches": read_launches(kernels)}
        report["wideband"] = wb
    finally:
        for path in files.values():
            path.unlink(missing_ok=True)

    # the modulator on the card: one batched call over the plan
    phy = [s.phy_bits() for s in specs]
    batch = np.zeros((len(phy), max(len(b) for b in phy)), np.int8)
    for k, b in enumerate(phy):
        batch[k, :len(b)] = b
    bits = torch.as_tensor(batch, device=dev)
    ms = cuda_time_ms(lambda: modulate_batch(bits, "c", 4), 20)
    report["modulator"] = {"flavor": "c", "packets": len(phy), "bits": batch.shape[1],
                           "ms_per_call": ms, "ms_per_packet": ms / len(phy)}
    log({"phase": "tx", **report})
    return report


# --------------------------------------------------------------------------
# probes: the TPU development probes K8-K11 as Hopper probes
# --------------------------------------------------------------------------


def check_probe_kernels(dev) -> dict:
    """Each probe kernel against its twin on the card: aa_corr (float
    and int8 lattices) and shift_stack exactly at several (sps, n_out,
    grp), shift_fma at the three (R, N, STEP) of K10 at full size within
    1e-5 of max |out| (the same products summed in another order)."""
    import torch

    from btle_tpu_torch.tools import _kernels as K
    from btle_tpu_torch.tools import dev_rollscale

    gen = torch.Generator(device=dev).manual_seed(11)
    report = {}
    for sps, n_out, grp in ((4, 2048, 8), (4, 131072, 1), (2, 5000, 4), (8, 3001, 16)):
        cols = n_out + 31 * sps + 3
        lat = torch.randint(0, 2, (40, cols), generator=gen, device=dev)
        w = torch.randint(-1, 2, (40, 32), generator=gen, device=dev).to(torch.float32)
        for s in (lat.to(torch.int8), (lat * 2 - 1).to(torch.float32)):
            got = K.aa_corr(s, w, sps, n_out, grp=grp, n_mask=int(w.abs()[0].sum()))
            want = K.aa_corr_reference(s, w, sps, n_out, n_mask=int(w.abs()[0].sum()))
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"aa_corr ({s.dtype}, sps {sps}, grp {grp}) "
                                     "disagrees with its twin")
        x = (lat * 2 - 1).to(torch.float32)
        for k0 in (0, sps * grp):
            if not torch.equal(K.shift_stack(x, grp, sps, k0),
                               K.shift_stack_reference(x, grp, sps, k0)):
                raise AssertionError(f"shift_stack (grp {grp}, k0 {k0}) disagrees")
    report["aa_corr"] = {"max_abs_err": 0.0, "ok": True}
    report["shift_stack"] = {"max_abs_err": 0.0, "ok": True}
    errs = {}
    for rows, n, step, grp in dev_rollscale.CONFIGS[:3]:
        kc, frames = dev_rollscale.make_inputs(rows, n, step, dev_rollscale.N_TILES, dev)
        n_cols = dev_rollscale.N_TILES * dev_rollscale.T
        got = K.shift_fma(frames[0], kc, n_cols, step, grp)
        want = K.shift_fma_reference(frames[0], kc, n_cols, step, grp)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        errs[f"R{rows}"] = {"max_abs_err": err, "max_abs_out": scale}
        if not err <= dev_rollscale.TOLERANCE * scale:
            raise AssertionError(f"shift_fma (R {rows}) disagrees with its twin: {err}")
    report["shift_fma"] = {"max_abs_err": max(e["max_abs_err"] for e in errs.values()),
                           "ok": True, **errs}
    log({"phase": "probe_kernels_vs_twins", **report})
    return report


PROBE_TRIALS = {"iters": 16, "trials": 3}   # full trials from the probes' CLIs


def run_probes(dev, kernels) -> dict:
    """The "probes" phase: each probe's run() on the card with the launch
    counts zeroed just before and read just after; every exact variant
    must be an exact match and every checksum pair MATCH. Returns
    {probe: (result, launches)}."""
    from btle_tpu_torch.tools import (dev_aagrp_bisect, dev_aagrp_repro,
                                      dev_roll_experiment, dev_rollscale)

    runs = {
        "K8": lambda: dev_aagrp_bisect.run(dev),
        "K9": lambda: dev_aagrp_repro.run(dev),
        **{f"K10 R{c[0]}": (lambda c=c: dev_rollscale.run(dev, configs=[c], **PROBE_TRIALS))
           for c in dev_rollscale.CONFIGS[:3]},
        "K11 f32": lambda: dev_roll_experiment.run(dev, dtype="f32", **PROBE_TRIALS),
        "K11 bf16": lambda: dev_roll_experiment.run(dev, which="im2col", dtype="bf16",
                                                    **PROBE_TRIALS),
    }
    out = {}
    for name, fn in runs.items():
        zero_launches(kernels)
        t0 = time.perf_counter()
        res = fn()
        seconds = time.perf_counter() - t0
        launches = {k: n for k, n in read_launches(kernels).items() if n}
        log({"phase": "probe", "probe": name, "seconds": seconds,
             "failures": res["failures"], "launches": launches,
             **{k: res[k] for k in ("variants", "configs", "pairs") if k in res}})
        if res["failures"]:
            raise AssertionError(f"probe {name}: {res['failures']} failures")
        out[name] = (res, launches)
    return out


def check_narrowband_kernels(dev, nb_block, wb_operands) -> dict:
    """Phase 2, narrowband part: the scan kernel against its twin (exact)
    on the int16 narrowband block at sps 4 / lag 1, on it with an all-zero
    care mask, at sps 8 / lag 8, and on the wideband block's 40 float
    channel rows with per-row access addresses; the candidate decode with
    clamped tails against its twin on candidates at the lattice's end."""
    import torch

    from btle_tpu_torch.phy.scan_kernel import scan_block_kernel, scan_block_reference
    from btle_tpu_torch.rx.decode_kernel import decode_candidates, decode_candidates_reference
    from btle_tpu_torch.rx.pipeline import earliest_hits
    from btle_tpu_torch.spec.bits import hex_to_bits
    from btle_tpu_torch.spec.crc24 import lfsr_init_to_table_init
    from btle_tpu_torch.spec.whitening import whitening_bits
    from btle_tpu_torch.wideband.channelizer import channelize

    ni, nq = (torch.as_tensor(a, device=dev) for a in nb_block)
    adv_aa = torch.as_tensor(hex_to_bits("d6be898e"), device=dev)
    ones = torch.ones(32, dtype=torch.int8, device=dev)
    rng = np.random.default_rng(3)
    gi = np.round(rng.normal(0, 3, 60_000)).astype(np.int16)
    gq = np.round(rng.normal(0, 3, 60_000)).astype(np.int16)
    for pos in (4000, 30_000):
        payload = rng.integers(0, 256, 18, dtype=np.uint8)
        ci, cq = nb_burst(np.concatenate([[0x02, 18], payload]), 37, sps=8,
                          amplitude=127.0)
        gi[pos:pos + len(ci)] += np.round(ci).astype(np.int16)
        gq[pos:pos + len(cq)] += np.round(cq).astype(np.int16)
    wi, wq, aa_rows, mask = wb_operands
    yi, yq = channelize(wi, wq, num_taps=NUM_TAPS, has_context=True, device=dev)
    aa_rows = aa_rows.expand(yi.shape[0], 32).clone()
    aa_rows[::4] = torch.as_tensor(rng.integers(0, 2, (10, 32)), device=dev)
    cases = {
        "int16_sps4_lag1": (ni, nq, adv_aa, ones, 4, 1),
        "int16_zero_mask": (ni, nq, adv_aa, torch.zeros_like(ones), 4, 1),
        "int16_sps8_lag8": (torch.as_tensor(gi, device=dev),
                            torch.as_tensor(gq, device=dev), adv_aa, ones, 8, 8),
        "float_rows_40": (yi, yq, aa_rows, mask, 4, 4),
    }
    report = {}
    for name, args in cases.items():
        hit, bits = scan_block_kernel(*args)
        want = scan_block_reference(*args)
        torch.cuda.synchronize()
        n_bad = int((hit != want[0]).sum()) + int((bits != want[1]).sum())
        report[name] = {"shape": list(args[0].shape), "hits": int(want[0].sum()),
                        "mismatches": n_bad}
        if n_bad:
            raise AssertionError(f"scan_block ({name}) disagrees with its twin "
                                 f"at {n_bad} positions")
        if name == "int16_zero_mask" and not bool(hit.all()):
            raise AssertionError("an all-zero care mask must hit everywhere")
    if report["int16_sps4_lag1"]["hits"] < 3 or report["int16_sps8_lag8"]["hits"] < 2 \
            or report["float_rows_40"]["hits"] < 4:
        raise AssertionError(f"too few access-address hits: {report}")

    hit, bits = scan_block_kernel(*cases["int16_sps4_lag1"])
    pos, _, _ = earliest_hits(hit[None], 24)
    kb = bits.shape[-1]
    pos[0, -8:] = torch.as_tensor(kb - 1 - rng.integers(0, 1500, 8), device=dev)
    pos[0, -1] = kb + 7
    whiten = torch.tensor(whitening_bits(37, 336)[None], device=dev)
    crc = torch.tensor([lfsr_init_to_table_init("555555")], dtype=torch.int32,
                       device=dev)
    adv = torch.tensor([True], device=dev)
    dec_args = (bits[None], pos, whiten, crc, adv)
    got = decode_candidates(*dec_args, sps=4, clamp_tail=True)
    want = decode_candidates_reference(*dec_args, sps=4, clamp_tail=True)
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError("decode_candidates (clamp_tail) disagrees with its twin")
    n_ok = int((got[2] & got[3]).sum())
    report["decode_candidates_clamp_tail"] = {"candidates": int(pos.numel()),
                                              "crc_ok": n_ok, "mismatches": 0}
    if n_ok < 3:
        raise AssertionError(f"only {n_ok} CRC-OK candidates in the narrowband block")
    return report, cases["int16_sps4_lag1"]


def time_scan_kernel(args) -> dict:
    """K7 at the narrowband block: device time, twin time and its bound
    (i and q read once, bits and hits written once; per decision two
    products and a difference, per hit position 32 gathered bits, an xor,
    an and and a compare)."""
    from btle_tpu_torch.phy.scan_kernel import SCAN_BLOCK, scan_block_kernel, scan_block_reference

    i = args[0]
    sps, lag = args[4], args[5]
    n = i.shape[-1]
    n_bits, n_hit = n - lag, n - lag - 31 * sps
    return {**kernel_times(SCAN_BLOCK, lambda: scan_block_kernel(*args),
                           lambda: scan_block_reference(*args), 50),
            **dict(zip(("bound_ms", "bound_by"), bound_ms(
                2 * n * i.element_size() + 64 + n_bits + n_hit,
                4 * n_bits + (2 * 32 + 3) * n_hit, FP32_FLOPS)))}


def narrowband_rtf(dev, i, q) -> dict:
    """Air seconds per wall second of the narrowband Sniffer (outputs to
    memory), median of 3 runs at each block size."""
    air = NB_SAMPLES / (NB_SPS * 1e6)
    out = {}
    for scan_len in (SCAN_LEN, NB_LIVE_SCAN_LEN):
        secs = [sniff_narrowband(dev, i, q, scan_len)[4] for _ in range(3)]
        med = statistics.median(secs)
        out[str(scan_len)] = {"seconds": secs, "median_s": med,
                              "realtime_factor": air / med,
                              "ms_per_block": 1e3 * med / -(-NB_SAMPLES // scan_len)}
    return out


def scan_step(dev, mode: str, tables):
    """One bench step: wideband_scan_fused on a device-resident block,
    reduced to a checksum of every output."""
    import torch

    from btle_tpu_torch.wideband.fused import wideband_scan_fused

    def step(i, q):
        out = wideband_scan_fused(i, q, *tables, sps=4, lag=4,
                                  max_candidates=MAX_CANDIDATES,
                                  num_taps=NUM_TAPS, has_context=True,
                                  compute_dtype=mode, device=dev)
        return sum(v.to(torch.float32).sum() for v in out.values())
    return step


def time_scan(dev, mode: str, blocks, tables) -> dict:
    """Median ms per block over 5 trials of 16 blocks, CUDA events."""
    import torch

    step = scan_step(dev, mode, tables)
    checksum = torch.zeros((), device=dev)
    for b in blocks[:2]:
        checksum += step(*b)
    torch.cuda.synchronize()
    iters, per_block = 16, []
    for _ in range(5):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for k in range(iters):
            checksum += step(*blocks[k % len(blocks)])
        t1.record()
        t1.synchronize()
        per_block.append(t0.elapsed_time(t1) / iters)
    ms = statistics.median(per_block)
    return {"mode": mode, "ms_per_block": ms, "ms_trials": per_block,
            "msps": SCAN_LEN * 20 / ms / 1e3,
            "checksum": float(checksum)}


def device_profile(run, n: int) -> dict:
    """torch.profiler over run() (n blocks): device time per block by
    kernel name, and the device's idle share of the window between the
    first and the last device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if "CUDA" in str(getattr(e, "device_type", "")))
    if not spans:
        return {"device_time": "not measured"}
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    top = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0.0)
        if t > 0:
            top.append({"name": ev.key[:90], "ms_per_block": t / 1e3 / n,
                        "calls_per_block": ev.count / n})
    top.sort(key=lambda r: -r["ms_per_block"])
    return {"blocks": n, "device_busy_ms_per_block": busy / 1e3 / n,
            "window_ms_per_block": window / 1e3 / n,
            "idle_share": 1.0 - busy / window, "top": top[:12]}


def profile_scan(dev, mode: str, blocks, tables) -> dict:
    """device_profile of 8 wideband scan steps."""
    import torch

    step = scan_step(dev, mode, tables)
    for b in blocks[:2]:
        step(*b)
    torch.cuda.synchronize()
    return {"mode": mode, **device_profile(
        lambda: [step(*b) for b in blocks], len(blocks))}


def profile_narrowband(dev, i, q) -> dict:
    """device_profile of the narrowband Sniffer over the first 0.25 s of
    the scene (ADV traffic) at each block size."""
    n = NB_SAMPLES // 4
    return {str(scan_len): device_profile(
        lambda s=scan_len: sniff_narrowband(dev, i[:n], q[:n], s),
        -(-n // scan_len)) for scan_len in (SCAN_LEN, NB_LIVE_SCAN_LEN)}


def kernel_device_ms(fn, kernel_name: str, reps: int, tries: int = 3):
    """Device time per launch of the CUDA kernel named ``kernel_name``, from
    torch.profiler over ``reps`` calls of ``fn`` — the kernel alone,
    without the wrapper's host work: (ms, launches the profiler recorded).
    A profile on the H100 has come back without the record of one of the
    launches, and once without any, so the time is the recorded device
    time over the recorded launches, and a profile with none is reported
    on stderr and the calls profiled again. Raises if ``tries`` profiles
    in a row recorded no launch of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        stats = prof.key_averages()
        found = [e for e in stats if kernel_name in e.key]
        launches = sum(e.count for e in found)
        total = sum(getattr(e, "self_device_time_total", 0.0) for e in found)
        if launches and total > 0:
            return total / 1e3 / launches, launches
        print(f"chip_smoke: a profile recorded no launch of "
              f"{kernel_name}; keys seen: {[e.key[:60] for e in stats][:8]}",
              file=sys.stderr, flush=True)
    raise AssertionError(f"the profiler recorded no launch of "
                         f"{kernel_name} in {tries} profiles")


def kernel_times(kernel, fn, twin, reps: int, library=None) -> dict:
    """ms: the kernel's device time (profiler; profiled: the launches it
    recorded of ``reps``); wrapper_ms: CUDA events around the wrapper
    call, host work included; plain_ms: the twin and library_ms the
    library yardstick, CUDA events."""
    ms, recorded = kernel_device_ms(fn, f"{kernel.name}_kernel", reps)
    return {"ms": ms, "profiled": [recorded, reps],
            "wrapper_ms": cuda_time_ms(fn, reps),
            "plain_ms": cuda_time_ms(twin, 3, 1),
            "library_ms": None if library is None else cuda_time_ms(library, reps)}


def time_kernels(operands, decode_args, library) -> dict:
    """Per-kernel time, twin time, bound and yardstick at bench geometry."""
    from btle_tpu_torch.rx.decode_kernel import (DECODE_CANDIDATES, decode_candidates,
                                                 decode_candidates_reference)
    from btle_tpu_torch.wideband import fused

    out = {}
    # the hi/lo pair: two bf16 products per term at bf16x2w, four at f32x2
    for name, kernel, fn, twin, products in (
            ("filterbank_bf16x2w", fused.FILTERBANK_BF16X2W, fused.filterbank_bf16x2w,
             fused.filterbank_bf16x2w_reference, 2),
            ("filterbank_im2col_f32x2", fused.FILTERBANK_IM2COL["f32x2"],
             fused.filterbank_im2col, fused.filterbank_im2col_reference, 4)):
        fb, _, _ = operands[name]
        out[name] = {
            **kernel_times(kernel, lambda fn=fn, fb=fb: fn(*fb),
                           lambda twin=twin, fb=fb: twin(*fb), 10, library=library[name]),
            **hilo_bound(fb, products), **hilo_grid(fb[0].device, fb[3]),
        }
    for name, rate in (("filterbank_im2col_bf16", BF16_FLOPS),
                       ("filterbank_im2col_f32", FP32_FLOPS)):
        fb, _, _ = operands[name]
        frames, gk, width, ky, kind = fb
        out[name] = {
            **kernel_times(fused.FILTERBANK_IM2COL[kind],
                           lambda fb=fb: fused.filterbank_im2col(*fb),
                           lambda fb=fb: fused.filterbank_im2col_reference(*fb), 10,
                           library=library[name]),
            **dict(zip(("bound_ms", "bound_by"), bound_ms(
                frames.numel() * frames.element_size()
                + gk.numel() * gk.element_size() + 80 * ky * 4,
                2 * 80 * 40 * width * ky, rate))),
        }
        if kind == "f32_im2col":
            out[name]["ms_trials"] = event_trials(lambda fb=fb: fused.filterbank_im2col(*fb), 10)
            out[name]["plan"] = fused.FILTERBANK_IM2COL[kind].plan(
                ky, width, fused.sgemm_warps(ky, fused._sm_count(frames.device)))
    fb, _, _ = operands["filterbank_polyx_f32"]
    f4, kcoefx, w4x, ky, _ = fb
    rows, n_slices = kcoefx.shape
    out["filterbank_polyx_f32"] = {
        **kernel_times(fused.FILTERBANK_POLYX_F32,
                       lambda: fused.filterbank_polyx_f32(*fb),
                       lambda: fused.filterbank_polyx_f32_reference(*fb), 10,
                       library=library["filterbank_polyx_f32"]),
        **dict(zip(("bound_ms", "bound_by"), bound_ms(
            (f4.numel() + kcoefx.numel() + w4x.numel() + 80 * ky) * 4,
            2 * rows * n_slices * ky + 2 * 80 * rows * ky, FP32_FLOPS))),
    }
    _, tail, y = operands["filterbank_bf16x2w"]
    n_bits, n_hit = tail[4], tail[5]
    out["demod_tail"] = {
        **kernel_times(fused.DEMOD_TAIL, lambda: fused.demod_tail(y, *tail),
                       lambda: fused.demod_tail_reference(y, *tail), 20),
        # decisions 3 flops per bit; |y_i|+|y_q|, 7 tree adds and a scale
        # per RSSI position; 2 integer ops per AA tap
        **dict(zip(("bound_ms", "bound_by"), bound_ms(
            y.numel() * 4 + 40 * 33 + 40 * n_bits + 40 * n_hit * 5,
            40 * (3 * n_bits + (10 + 64) * n_hit), FP32_FLOPS))),
    }
    bits, pos, whiten, crc, adv = decode_args
    m, c = pos.shape
    out["decode_candidates"] = {
        **kernel_times(DECODE_CANDIDATES,
                       lambda: decode_candidates(bits, pos, whiten, crc, adv, 4),
                       lambda: decode_candidates_reference(bits, pos, whiten, crc,
                                                           adv, 4), 50),
        # window bits read + tables + outputs; per candidate 336 xor/or and
        # 42 x 8 three-op CRC steps
        **dict(zip(("bound_ms", "bound_by"), bound_ms(
            m * c * 336 + m * c * 4 + m * 336 + m * 5 + m * c * (42 * 4 + 6),
            m * c * (2 * 336 + 3 * 336), FP32_FLOPS))),
    }
    return out


def probe_kernel_entries(dev, probes) -> list:
    """One entry of the kernels line per TPU probe kernel (K8-K11), each
    at the shape its probe gives it: the Hopper kernel it runs on, its
    device time, its twin's (plain) time, the library yardstick's where
    one PyTorch call computes the same function, its bound, its max
    |kernel - twin| there, and its launches in that probe's run."""
    import torch

    from btle_tpu_torch.convert import sgemm_weights
    from btle_tpu_torch.tools import _kernels as K
    from btle_tpu_torch.tools import (dev_aagrp_bisect, dev_aagrp_repro,
                                      dev_roll_experiment, dev_rollscale)
    from btle_tpu_torch.wideband import fused
    from btle_tpu_torch.wideband.channelizer import true_fp32

    entries = []

    def entry(k, label, kernel, replaces, probe, fn, twin, reps, nbytes, ops,
              rate=FP32_FLOPS, library=None):
        got, want = fn(), twin()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        torch.cuda.synchronize()
        err = max(float((g.to(torch.float32) - w.to(torch.float32)).abs().max())
                  for g, w in zip(got, want))
        entries.append({
            "k": [k], "name": f"{kernel.name} ({label})", "route": "cuda",
            "source": kernel.source, "replaces": replaces,
            "launches": probes[probe][1].get(kernel.name, 0), "max_abs_err": err,
            **kernel_times(kernel, fn, twin, reps, library),
            **dict(zip(("bound_ms", "bound_by"), bound_ms(nbytes, ops, rate)))})

    def grouped_conv(s, w, sps, n_out):
        def call():
            with true_fp32():
                return torch.nn.functional.conv1d(s[None], w[:, None, :], groups=w.shape[0],
                                                  dilation=sps)[0, :, :n_out]
        return call

    # K8: K2 on the GFSK lattices, K3 at 80 rows, the AA stage on decisions
    aa_rows, tsign, y_i, y_q = dev_aagrp_bisect.make_inputs()
    rows = torch.as_tensor(aa_rows.astype(np.int8), device=dev)
    mask = torch.ones(32, dtype=torch.int8, device=dev)
    signs = torch.as_tensor(tsign, device=dev)
    y = torch.as_tensor(np.concatenate([y_i, y_q]), device=dev)
    n_hit, nb = dev_aagrp_bisect.T, dev_aagrp_bisect.NB
    tail = (rows, mask, 4, 4, nb, n_hit)
    entry("K8", "tail", fused.DEMOD_TAIL, "tools/dev_aagrp_bisect.py:118", "K8",
          lambda: fused.demod_tail(y, *tail), lambda: fused.demod_tail_reference(y, *tail),
          50, y.numel() * 4 + 40 * 33 + 40 * nb + 40 * n_hit * 5,
          40 * (3 * nb + 74 * n_hit))
    frames = torch.as_tensor(dev_aagrp_bisect.dma_frames(y_i, y_q), device=dev)
    ones = torch.ones((80, 1), device=dev)
    eye = torch.eye(80, device=dev)
    ky = frames.shape[1]
    mm = (frames, ones, eye, ky, 1)

    def matmul():
        with true_fp32():
            return eye @ frames
    entry("K8", "dma-mm", fused.FILTERBANK_POLYX_F32, "tools/dev_aagrp_bisect.py:184",
          "K8", lambda: fused.filterbank_polyx_f32(*mm),
          lambda: fused.filterbank_polyx_f32_reference(*mm), 50,
          (frames.numel() + 80 + 80 * 80 + 80 * ky) * 4, 2 * 80 * ky + 2 * 80 * 80 * ky,
          library=matmul)
    d = (y_i[:, :nb] * y_q[:, 4: nb + 4] - y_i[:, 4: nb + 4] * y_q[:, :nb]) > 0
    dec = torch.as_tensor(d.astype(np.int8), device=dev)
    # its yardstick: the grouped dilated convolution on the decisions as +-1
    lat8 = torch.where(dec > 0, 1.0, -1.0)
    entry("K8", "aa-only", K.AA_CORR, "tools/dev_aagrp_bisect.py:265", "K8",
          lambda: K.aa_corr(dec, signs, 4, n_hit), lambda: K.aa_corr_reference(dec, signs, 4, n_hit),
          50, dec.numel() + 40 * 32 * 4 + 40 * n_hit * 5, 2 * 40 * 32 * n_hit,
          library=grouped_conv(lat8, signs, 4, n_hit))

    # K9: the correlation and the stack
    s9, w4, _ = dev_aagrp_repro.make_inputs(8)
    s9 = torch.as_tensor(s9, device=dev)
    w9 = torch.as_tensor(dev_aagrp_repro.signs_of_w4(w4, 8), device=dev)
    t9 = dev_aagrp_repro.T
    entry("K9", "corr", K.AA_CORR, "tools/dev_aagrp_repro.py:118", "K9",
          lambda: K.aa_corr(s9, w9, 4, t9), lambda: K.aa_corr_reference(s9, w9, 4, t9), 50,
          s9.numel() * 4 + 40 * 32 * 4 + 40 * t9 * 5, 2 * 40 * 32 * t9,
          library=grouped_conv(s9, w9, 4, t9))
    entry("K9", "roll", K.SHIFT_STACK, "tools/dev_aagrp_repro.py:118", "K9",
          lambda: K.shift_stack(s9, 8, 4), lambda: K.shift_stack_reference(s9, 8, 4), 50,
          s9.numel() * 4 * (1 + 8), 0)

    # K10: the three stacking factors at one 131072-sample block
    n_cols = dev_rollscale.N_TILES * dev_rollscale.T
    for r, n, step, grp in dev_rollscale.CONFIGS[:3]:
        kc, fr = dev_rollscale.make_inputs(r, n, step, dev_rollscale.N_TILES, dev)
        f0 = fr[0]
        entry("K10", f"R{r}-N{n}", K.SHIFT_FMA, "tools/dev_rollscale.py:75", f"K10 R{r}",
              lambda f0=f0, kc=kc, step=step, grp=grp: K.shift_fma(f0, kc, n_cols, step, grp),
              lambda f0=f0, kc=kc, step=step, grp=grp: K.shift_fma_reference(
                  f0, kc, n_cols, step, grp), 20,
              4 * (f0.numel() + kc.numel() + 40 * n_cols), 2 * r * n * n_cols,
              library=lambda f0=f0, kc=kc, step=step: dev_rollscale.library_call(
                  f0, kc, n_cols, step))
        entries[-1]["ms_trials"] = event_trials(
            lambda f0=f0, kc=kc, step=step, grp=grp: K.shift_fma(f0, kc, n_cols, step, grp), 20)
        entries[-1]["plan"] = K.shift_fma_plan(f0, kc, n_cols, step)
        del kc, fr, f0

    # K11: K5 on the tool's frames and G (f32 and bf16), the AA stage
    g, frames_np, tsign11, lat = dev_roll_experiment.make_inputs()
    for dtype, kind, rate, probe in ((torch.float32, "f32_im2col", FP32_FLOPS, "K11 f32"),
                                     (torch.bfloat16, "bf16", BF16_FLOPS, "K11 bf16")):
        f11 = torch.as_tensor(frames_np[0], device=dev).to(dtype)
        gk = torch.as_tensor(g, device=dev).to(dtype)
        w11 = dev_roll_experiment.im2col_weights(gk)
        if kind == "f32_im2col":       # the FP32 kernel's (40, 65, 80) table
            gk = sgemm_weights(gk)
        args = (f11, gk, 65, n_cols, kind)

        def conv(f11=f11, w11=w11):
            with true_fp32():
                return torch.nn.functional.conv1d(f11[None], w11)[0, :, :n_cols]
        entry("K11", f"im2col {kind}", fused.FILTERBANK_IM2COL[kind],
              "tools/dev_roll_experiment.py:109", probe,
              lambda args=args: fused.filterbank_im2col(*args),
              lambda args=args: fused.filterbank_im2col_reference(*args), 10,
              f11.numel() * f11.element_size() + gk.numel() * gk.element_size()
              + 80 * n_cols * 4, 2 * 80 * 40 * 65 * n_cols, rate, library=conv)
        if kind == "f32_im2col":
            entries[-1]["ms_trials"] = event_trials(
                lambda args=args: fused.filterbank_im2col(*args), 10)
            entries[-1]["plan"] = fused.FILTERBANK_IM2COL[kind].plan(
                n_cols, 65, fused.sgemm_warps(n_cols, fused._sm_count(f11.device)))
    l11 = torch.as_tensor(lat[0], device=dev)
    w11 = torch.as_tensor(tsign11, device=dev)
    entry("K11", "aa", K.AA_CORR, "tools/dev_roll_experiment.py:197", "K11 f32",
          lambda: K.aa_corr(l11, w11, 4, n_cols), lambda: K.aa_corr_reference(l11, w11, 4, n_cols),
          20, l11.numel() * 4 + 40 * 32 * 4 + 40 * n_cols * 5, 2 * 40 * 32 * n_cols,
          library=grouped_conv(l11, w11, 4, n_cols))
    return entries


def main() -> int:
    import torch

    from btle_tpu_torch import _build
    from btle_tpu_torch.phy import scan_kernel
    from btle_tpu_torch.rx import decode_kernel
    from btle_tpu_torch.tools import _kernels as probe_kernels
    from btle_tpu_torch.wideband import fused

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from btle_tpu_torch.rx.pipeline import required_halo
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    log({"phase": "device", "torch": torch.__version__,
         "cuda": torch.version.cuda, "nvidia_smi": smi,
         "clocks": nvidia_smi(CLOCKS_QUERY),
         "name": torch.cuda.get_device_name(0),
         "count": torch.cuda.device_count()})

    path_kernels = [fused.FILTERBANK_BF16X2W, fused.FILTERBANK_POLYX_F32,
                    *fused.FILTERBANK_IM2COL.values(), fused.DEMOD_TAIL,
                    decode_kernel.DECODE_CANDIDATES, scan_kernel.SCAN_BLOCK]
    kernels = [*path_kernels, *probe_kernels.KERNELS]
    t0 = time.perf_counter()
    logs = _build.build([k.name for k in kernels])
    seconds = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, text in logs.items()}
    log({"phase": "build", "seconds": seconds, "ptxas": ptxas,
         "launch_plans": launch_plans(dev)})
    spills = [f"{n}: {ln}" for n in NO_SPILL_SOURCES for ln in ptxas.get(n, [])
              if re.search(r"[1-9]\d* bytes spill", ln)]
    if spills:
        raise AssertionError(f"the redesigned kernels spill: {spills}")

    report, operands, decode_args, library, wb_operands = check_kernels(dev)
    nb_i, nb_q, nb_want = narrowband_scene()
    nb_block = (nb_i[:SCAN_LEN + required_halo(NB_SPS, 1)],
                nb_q[:SCAN_LEN + required_halo(NB_SPS, 1)])
    nb_report, nb_scan_args = check_narrowband_kernels(dev, nb_block, wb_operands)
    report["scan_block"] = {"max_abs_err": 0, "ok": True, **nb_report}
    log({"phase": "kernels_vs_twins", **report})

    from btle_tpu_torch.wideband import fused_selftest

    st = {mode: fused_selftest(compute_dtype=mode, device=dev)
          for mode in ("bf16x2w", "f32")}
    st["xla"] = fused_selftest(pipeline="xla", device=dev)
    log({"phase": "selftest", **{k: {str(c): p for c, p in v.items()}
                                  for k, v in st.items()}})
    launches = run_knob_matrix(dev, kernels)

    plan, n_total = main_path_plan()
    wi, wq, injected = scene(plan, n_total, seed=4)
    for mode in ("bf16x2w", "f32"):
        got = run_main_path(dev, mode, wi, wq, injected, kernels)
        for name, n in got.items():
            launches[name] += n
    del wi, wq

    nb_runs = run_narrowband(dev, nb_i, nb_q, nb_want, kernels)
    for run in nb_runs.values():
        for name, n in run["launches"].items():
            launches[name] += n
    run_golden(dev, scan_kernel.SCAN_BLOCK)
    run_cli(nb_i, nb_q, nb_runs[SCAN_LEN]["ndjson"])
    wb_report, wb_launches = run_wideband_cli(dev, kernels)
    for name, n in wb_launches.items():
        launches[name] += n
    tx = run_tx(dev, kernels)
    for got in (tx["decode"]["launches"], *(m["launches"] for m in tx["wideband"].values())):
        for name, n in got.items():
            launches[name] += n
    check_probe_kernels(dev)
    probes = run_probes(dev, kernels)
    for _, got in probes.values():
        for name, n in got.items():
            launches[name] += n

    from btle_tpu_torch.wideband.sniffer import default_scan_tables

    tables = default_scan_tables(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    n_wb = block_samples() + NUM_TAPS - 1
    blocks = [tuple(30.0 * torch.randn(n_wb, generator=gen, device=dev)
                    for _ in range(2)) for _ in range(8)]
    scans = {mode: time_scan(dev, mode, blocks, tables)
             for mode, _ in CLI_MODES}
    clocks_after_scan = nvidia_smi(CLOCKS_QUERY)
    per_kernel = time_kernels(operands, decode_args, library)
    per_kernel["scan_block"] = time_scan_kernel(nb_scan_args)
    per_kernel["filterbank_bf16x2w"]["live"] = time_live_k1(dev)
    probe_entries = probe_kernel_entries(dev, probes)
    rtf = narrowband_rtf(dev, nb_i, nb_q)
    log({"phase": "timing", "scan": scans, "clocks_after_scan": clocks_after_scan,
         "kernels": per_kernel, "probe_kernels": probe_entries, "narrowband": rtf,
         "wideband_live": {mode: r["live"] for mode, r in wb_report.items()}})
    for mode, _ in CLI_MODES:
        log({"phase": "profile", **profile_scan(dev, mode, blocks, tables)})
    del blocks
    log({"phase": "profile_narrowband", **profile_narrowband(dev, nb_i, nb_q)})

    idle = [name for name, n in launches.items() if n <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main paths: {idle}")
    log({"kernels": [{
        "k": TPU_KERNEL_OF[k.name], "name": k.name, "route": "cuda", "source": k.source,
        "replaces": k.replaces, "launches": launches[k.name],
        "max_abs_err": report[k.name]["max_abs_err"],
        **per_kernel[k.name]} for k in path_kernels] + probe_entries})
    print(smi, flush=True)
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
