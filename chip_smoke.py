#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (btle_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit: ``python3 chip_smoke.py``. It builds every hand-written kernel
from ``btle_tpu_torch/csrc`` (into ``build/``), then runs, printing one
JSON line per phase:

  0. device: torch version, card name and power limit, clocks (nvidia-smi);
  1. build: seconds to compile the kernels (one nvcc per source, in
     parallel) and each kernel's ptxas register / shared-memory report;
     the tensor-core filterbank (K1, K5 f32x2 and bf16), the FP32 SGEMM
     filterbank (K5 f32), the polyphase filterbank (K3), the demod tail
     (K2), the candidate decode (K4), shift_fma (K10), the AA
     correlation (aa_corr: K8, K9, K11) and the narrowband scan (K7) must
     not spill;
     the launch shapes (dynamic shared memory, resident CTAs per SM, grid)
     of K5 f32 and K3 at bench geometry, K3 at the live block, K4 at 40 x
     16 and 1 x 16 and of K10 at its three (R, N, STEP);
  2. kernels: each kernel against its plain PyTorch twin on the card, on
     one bench-geometry block with packets in it (131072 + 1476 channel
     samples, 1280-tap prototype, 16 candidate slots), the filterbank in
     every numerics class (K1 bf16x2w, K5 f32x2 and K5 bf16 on the tensor
     cores, K3 f32 polyx, K5 f32 im2col) and each against one cuDNN
     convolution computing the same y (timed later as its yardstick), the
     demod tail bit for bit on two of those y; the narrowband
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
  6e. card gates and benches (btle_tpu_torch.tools, btle_tpu_torch.bench),
     each with the launch counts zeroed just before and read just after:
     "soak" (soak_fused: 150 packets over 0.25 s of air plus 12 followed
     connections with channel-map updates, at 1M and 2M in "bf16x2w" and
     "f32": every one of the 198 packets byte-exact, every connection
     registered, stale-dropped and map-updated, no ghost CRC-OK packet);
     "validate" (validate_fused: "f32" slot-exact against the plain scan,
     "bf16x2w" the same CRC-OK packet set; PASS); "bench" (``python -m
     btle_tpu_torch.bench`` in a child process, its JSON line printed as
     it came: the fused paths, finite checksums); "live_bench"
     (bench_live: run_live against a producer paced at 80 Msps for 5 s,
     at 131072 and 8192 in "bf16x2w" and at 8192 in "f32": drops, Msps,
     the producer's Msps and the verdict, which is a measurement; a CRC-OK
     packet not in the scene fails); "latency" (bench_latency at 8192,
     32768 and 131072);
  6f. LE Coded, V1 and the BER simulation: "viterbi" (right after phase
     2: V1, csrc/viterbi.cu, bit for bit with its twin in bits and pm_end
     at 160 x 364 — the wideband scan's 40 channels x 4 slots — and 4 x
     364, on random soft inputs and on hard +-1 inputs with ties; its
     profiler time, twin time, bounds, launch shape and ptxas report);
     "coded" (``python -m btle_tpu_torch tx`` then ``decode`` at coded8
     and coded2 in child processes, byte-exact, and decode_coded on the
     same file; the 40-channel coded scan of one 8.192 ms capture with
     S8 and S2 packets on five channels, two of them advertising: every
     packet CRC-OK and byte-exact at its S, no other; V1 must have
     launched; ms a block, real-time factor and a profile); "ber" (the
     full-depth sweep of BASELINE config 3, 3600 packets at sps 8: every
     anchor at or below the reference's 0.1%, the waterfall shape, its
     seconds and packets per second; a 2M anchor pair within 0.5%);
     "sensitivity" (tests/test_wideband_sensitivity.py's 11 dB scene in
     every shipped fused mode and the plain scan: at least 23 of 25,
     within 1 packet of "f32");
  6g. the recon chain and passive decryption, "recon" (after "ber"): the
     card's name and power limit; AES-128 (FIPS-197 C.1), an LlSession
     loopback both ways and a tampered MIC refused, on the port's numpy
     AES-CCM, with microseconds a block and a 27-byte PDU; ``scan`` over
     the narrowband scene written as i16, in this process on the card
     (K7 and K4 counted) and in child processes on the card and with
     --device cpu, --json and the table, all byte-equal, every
     advertiser listed with its packet count, wall seconds and real-time
     factor; the wideband CLI scene with its first connection's traffic
     replaced by an LL_ENC_REQ/RSP exchange and ATT traffic encrypted
     with LlSession.encrypt, through the library runner without and with
     the LTK in "bf16x2w" and "f32" (the real-time factors; every
     encrypted PDU's plain_hex its plaintext, no other plain_hex, no
     other CRC-OK packet) and ``wideband --fused --follow --max-follow 2
     --json --pcap --ltk`` in a child process equal to it; on its pcap
     ``recon gatt --ltk`` (exactly the scene's ATT operations),
     quickscan, profile, diff (against the run without the LTK) and
     entropy, ``analyze`` and ``analyze --plot`` (its "skipped (no
     matplotlib)" line where matplotlib is missing), each in a child
     process and byte-equal to the in-process call; ``iq-show`` on the
     wideband capture (its occupancy rows);
  7. timing: wideband_scan_fused over 8 distinct device-resident noise
     blocks (as bench.py), median Msps per CLI mode beside the bench
     phase's, the clocks right after; per-kernel time, its
     twin's time, the bound, and for each filterbank one cuDNN
     convolution computing the same y as yardstick (K5 f32, K3, K4 and K10
     also with their CUDA-event trials and launch shapes, K1, K5 bf16,
     K3, K2 and K4 with their ptxas reports; K4 also at the narrowband 1 x
     16, beside an empty kernel's device time, the launch floor); K1, K5
     bf16, K3, K2 and K4 also at the live block's shape (8192 + halo
     columns: the twin, ms, CTAs, bound, yardstick); K7 bit for bit and
     timed at the narrowband file block, the live 8192-sample block and
     the 40 float channel rows of the wideband block, with its launch
     shape and ptxas report; the narrowband
     real-time factor (air seconds per wall second, median of 3 runs)
     at both block sizes; then a torch.profiler trace of 8 scan steps
     per mode: device time by kernel and the device's idle share; each
     probe kernel at its probe's shape (K8-K11 on aa_corr, shift_stack,
     shift_fma, K2, K3 and K5; aa_corr and shift_stack with their launch
     shapes and ptxas reports);
  8. the {"kernels": [...]} summary, K1-K11 and V1 (``k`` names the
     PERF.md rows each entry carries).

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


def wideband_cli_scene(air_s: float = WB_AIR_S, seed: int = 21, data_pdus=None):
    """air_s seconds of 80 Msps air at int8 amplitude: ADV_NONCONN_IND of
    6-30 payload bytes every 4 ms rotating over 37/38/39, the two
    CONNECT_REQs of WB_CONNS, and per connection LL data packets (LLID 1,
    2-27 payload bytes) on its hop channels: the first two blocks after
    its CONNECT_REQ's block, each later one in the second block after the
    hop tick that moves the connection on (the first tick more than
    interval - 7 ms after the previous packet). One block of slack on
    each side of a retune keeps every packet keyed alike whether the
    re-keyed tables reach the next block (file run) or the one after
    (run_live at pipeline 2). data_pdus ({access address: [pdu bytes]})
    replaces a connection's random data packets with the given PDUs, in
    order, until they run out (the random draws stay the same). Returns
    (i, q int8, [(channel, access address, pdu bytes)])."""
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
            pdu = np.concatenate([[0x01, len(payload)], payload])
            if data_pdus is not None and aa in data_pdus:
                if not data_pdus[aa]:
                    break
                pdu = np.frombuffer(data_pdus[aa].pop(0), np.uint8)
            plan.append((t, chan, aa, crc, pdu))
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
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(
                f"demod_tail ({mode}): bits differ at "
                f"{int((got[0] != want[0]).sum())}, hits at "
                f"{int((got[1] != want[1]).sum())}, mag at "
                f"{int((got[2] != want[2]).sum())} positions")
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
      filterbank_im2col_bf16 (hilo_library_call): bf16, the (80, 40,
        width) bf16 weights;
      filterbank_im2col_f32, filterbank_polyx_f32 (the same function):
        float32 frames and the folded (80, 40, width) weights in true FP32.
    cuDNN writes bf16 outputs, so the bf16 yardsticks round y (or each
    half) to 8 mantissa bits, which the kernels do not (checked to 1e-2
    of max|y|)."""
    import torch

    from btle_tpu_torch.wideband.channelizer import true_fp32

    calls = {name: hilo_library_call(operands[name][0])
             for name in ("filterbank_bf16x2w", "filterbank_im2col_f32x2",
                          "filterbank_im2col_bf16")}
    call = f32_library_call(operands["filterbank_im2col_f32"][0])
    calls["filterbank_im2col_f32"] = calls["filterbank_polyx_f32"] = call
    return calls


def f32_library_call(fb_args):
    """The cuDNN yardstick of the true-FP32 filterbanks (K5 "f32", K3): the
    (40, J) float32 frames of the "f32" im2col operands convolved with the
    (40, S, 80) table unfolded to (80, 40, width) weights."""
    import torch

    from btle_tpu_torch.wideband.channelizer import true_fp32

    frames, gk, width = fb_args[:3]
    w = gk.permute(2, 0, 1)[:, :, :width].contiguous()

    def call(x=frames[None], w=w):
        with true_fp32():
            return torch.nn.functional.conv1d(x, w)[0]
    return call


def hilo_library_call(fb_args):
    """The cuDNN yardstick of the tensor-core filterbank: the frames as
    (40, J) bf16 rows ([xhi; xlo], 80 rows, at f32x2), the (K_pad, N)
    table unfolded to (N, rows, width) bf16 conv weights (each column
    over both halves at f32x2), one convolution, and with the hi/lo pair
    (N = 160) the two halves summed in f32."""
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
        return y[:80] + y[80:] if y.shape[0] == 160 else y
    return call


def hilo_grid(dev, ky: int) -> dict:
    """The tensor-core filterbank's column tile and grid at ky columns
    (every instance of the template)."""
    import torch

    from btle_tpu_torch.wideband import fused

    warps = fused.hilo_warps_m(ky, torch.cuda.get_device_properties(dev).multi_processor_count)
    return {"columns": ky, "tile_columns": 64 * warps, "ctas": -(-ky // (64 * warps))}


def hilo_bound(fb_args, products: int):
    """bound_ms of the tensor-core filterbank: frames, weights and y moved
    once; ``products`` bf16 products (2 FLOP each) per weight term and
    column (1 at bf16, 2 at bf16x2w, 4 at f32x2)."""
    frames, b, width, ky = fb_args[:4]
    return dict(zip(("bound_ms", "bound_by"), bound_ms(
        frames.numel() * 2 + b.numel() * 2 + 80 * ky * 4,
        products * 2 * 80 * 40 * width * ky, BF16_FLOPS)))


def tail_bound(y, n_bits: int, n_hit: int) -> dict:
    """bound_ms of the demod tail: y, the AA tables and the three outputs
    moved once; 3 operations per decision, |y_i|+|y_q|, the window tree
    and a scale per RSSI position (10) and 2 integer ones per AA tap
    (64)."""
    return dict(zip(("bound_ms", "bound_by"), bound_ms(
        y.numel() * 4 + 40 * 33 + 40 * n_bits + 40 * n_hit * 5,
        40 * (3 * n_bits + (10 + 64) * n_hit), FP32_FLOPS)))


def time_live(dev) -> dict:
    """K1, K5 at "bf16", K3, K2 and K4 at the live block's shape (the CLI's
    8192-sample blocks, 1279 samples of filter context, noise of std 30):
    each filterbank within 1e-5 of max |y| of its twin, K2 and K4 bit for
    bit on K1's y; device time, grid, bound and yardstick of each."""
    import torch

    from btle_tpu_torch.rx.decode_kernel import decode_candidates, decode_candidates_reference
    from btle_tpu_torch.rx.pipeline import earliest_hits, required_halo
    from btle_tpu_torch.wideband import fused
    from btle_tpu_torch.wideband.sniffer import default_scan_tables

    n = (WB_SCAN_LEN + required_halo(4, 4)) * 20 + NUM_TAPS - 1
    gen = torch.Generator(device=dev).manual_seed(9)
    xi, xq = (30.0 * torch.randn(n, generator=gen, device=dev) for _ in range(2))
    aa, mask, whiten, crc, adv = default_scan_tables(dev)
    out = {}
    for name, mode, kernel, products in (
            ("filterbank_bf16x2w", "bf16x2w", fused.FILTERBANK_BF16X2W, 2),
            ("filterbank_im2col_bf16", "bf16", fused.FILTERBANK_IM2COL["bf16"], 1)):
        fb, tail = fused.frontend_operands(xi, xq, aa, mask, NUM_TAPS, True, 4, 4,
                                           mode, 1.0, dev)
        fn, twin = fused.FILTERBANKS[fused.filterbank_kind(mode)]
        y, y_ref = fn(*fb), twin(*fb)
        torch.cuda.synchronize()
        err, scale = float((y - y_ref).abs().max()), float(y_ref.abs().max())
        if not (err <= 1e-5 * scale and bool(torch.isfinite(y).all())):
            raise AssertionError(f"{name} at the live shape: max |dy| {err} at "
                                 f"max |y| {scale}")
        out[name] = {**hilo_grid(dev, fb[3]), "max_abs_err": err, "max_abs_y": scale,
                     **kernel_times(kernel, lambda fn=fn, fb=fb: fn(*fb),
                                    lambda twin=twin, fb=fb: twin(*fb), 50,
                                    library=hilo_library_call(fb)),
                     **hilo_bound(fb, products)}
        if mode == "bf16x2w":
            y_tail = y_ref
            tail_args = tail
    got = fused.demod_tail(y_tail, *tail_args)
    want = fused.demod_tail_reference(y_tail, *tail_args)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("demod_tail at the live shape disagrees with its twin")
    n_bits, n_hit = tail_args[4], tail_args[5]
    out["demod_tail"] = {
        "columns": y_tail.shape[1], "n_bits": n_bits, "n_hit": n_hit,
        "ctas": 40 * -(-n_bits // 2048), "max_abs_err": 0.0,
        **kernel_times(fused.DEMOD_TAIL, lambda: fused.demod_tail(y_tail, *tail_args),
                       lambda: fused.demod_tail_reference(y_tail, *tail_args), 50),
        **tail_bound(y_tail, n_bits, n_hit)}

    fb, _ = fused.frontend_operands(xi, xq, aa, mask, NUM_TAPS, True, 4, 4, "f32", 1.0, dev)
    fb_im2col, _ = fused.frontend_operands(xi, xq, aa, mask, NUM_TAPS, True, 4, 4, "f32",
                                           1.0, dev, "im2col")
    y, y_ref = fused.filterbank_polyx_f32(*fb), fused.filterbank_polyx_f32_reference(*fb)
    torch.cuda.synchronize()
    err, scale = float((y - y_ref).abs().max()), float(y_ref.abs().max())
    if not (err <= 1e-5 * scale and bool(torch.isfinite(y).all())):
        raise AssertionError(f"filterbank_polyx_f32 at the live shape: max |dy| {err} "
                             f"at max |y| {scale}")
    out["filterbank_polyx_f32"] = {
        "columns": fb[3], "plan": fused.polyx_plan(fb[3], fb[1].shape[1], fb[4], dev),
        "max_abs_err": err, "max_abs_y": scale,
        **kernel_times(fused.FILTERBANK_POLYX_F32, lambda: fused.filterbank_polyx_f32(*fb),
                       lambda: fused.filterbank_polyx_f32_reference(*fb), 50,
                       library=f32_library_call(fb_im2col)),
        "ms_trials": event_trials(lambda: fused.filterbank_polyx_f32(*fb), 50),
        **polyx_bound(fb)}

    bits = got[0]                          # K2's lattice at the live shape
    dec = (bits, earliest_hits(got[1], MAX_CANDIDATES)[0], whiten, crc, adv)
    if not all(torch.equal(g, w) for g, w in zip(decode_candidates(*dec, 4),
                                                 decode_candidates_reference(*dec, 4))):
        raise AssertionError("decode_candidates at the live shape disagrees with its twin")
    out["decode_candidates"] = {"columns": bits.shape[1], **decode_times(dec)}
    return out


# the sources whose ptxas report must show no spills: the tensor-core
# filterbank (K1, K5 f32x2 and bf16), the FP32 SGEMM filterbank (K5 f32),
# the polyphase filterbank (K3), the demod tail (K2), the candidate decode
# (K4), K10, the AA correlation (K8, K9, K11), the narrowband scan (K7)
# and the coded Viterbi (V1)
NO_SPILL_SOURCES = ("filterbank_hilo_mma", "filterbank_sgemm_f32", "filterbank_polyx_f32",
                    "demod_tail", "decode_candidates", "shift_fma", "aa_corr", "scan_block",
                    "viterbi")
# the Itanium-mangled names of the template type arguments
MANGLED_TYPES = {"f": "float", "a": "int8", "s": "int16"}


def ptxas_kernels(logs: dict) -> dict:
    """{source: {entry function: {"registers", "spill_stores",
    "spill_loads"}}} from nvcc's -Xptxas=-v reports."""
    out = {}
    for source, text in logs.items():
        entries, name = {}, None
        for ln in text.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                name = m.group(1)
                entries[name] = {}
            elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                                          r"stores, (\d+) bytes spill loads", ln)):
                entries[name]["stack_frame"] = int(m.group(1))
                entries[name]["spill_stores"] = int(m.group(2))
                entries[name]["spill_loads"] = int(m.group(3))
            elif name and (m := re.search(r"Used (\d+) registers", ln)):
                entries[name]["registers"] = int(m.group(1))
                if (m := re.search(r"(\d+) bytes smem", ln)):
                    entries[name]["smem_bytes"] = int(m.group(1))
        out[source] = entries
    return out


def ptxas_of(ptx: dict, kernel, params=("warps_m",)) -> dict:
    """The ptxas entries of one kernel's instances (its ``<name>_kernel``
    template), keyed by the instance's template arguments named
    ``params`` (e.g. "warps_m=4", "stack=2,warps=8", "clamp_tail=1",
    "lattice=int8,grp=8,sps=4")."""
    found = {}
    for fn, info in ptx.get(kernel.source_name, {}).items():
        m = re.search(rf"{kernel.name}_kernel(?:I((?:[fas]|L[ib]\d+E)+)E)?", fn)
        if m:
            args = [num or MANGLED_TYPES[t]
                    for num, t in re.findall(r"L[ib](\d+)E|([fas])", m.group(1) or "")]
            found[",".join(f"{p}={a}" for p, a in zip(params, args))
                  if args else kernel.name] = info
    return found


def launch_plans(dev) -> dict:
    """The launch shapes of the redesigned CUDA-core kernels at the shapes
    the timing phase gives them: dynamic shared memory, resident CTAs per
    SM, grid, threads and columns (K4: candidates) per CTA (their sources'
    _plan entry): K5 f32 and K3 at bench geometry, K3 also at the live
    block, K4 at the wideband 40 x 16 and the narrowband 1 x 16, K10."""
    import torch

    from btle_tpu_torch.rx.pipeline import required_halo
    from btle_tpu_torch.tools import _kernels as K
    from btle_tpu_torch.tools import dev_rollscale
    from btle_tpu_torch.wideband import fused

    from btle_tpu_torch.rx.decode_kernel import DECODE_CANDIDATES

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ky = SCAN_LEN + required_halo(4, 4)     # the bench block's y columns
    ky_live = WB_SCAN_LEN + required_halo(4, 4)
    out = {"filterbank_im2col_f32": fused.FILTERBANK_IM2COL["f32_im2col"].plan(
        ky, 65, fused.sgemm_warps(ky, sms)),
        "filterbank_polyx_f32": fused.polyx_plan(ky, 33, 2, dev),
        "filterbank_polyx_f32 live": fused.polyx_plan(ky_live, 33, 2, dev),
        "decode_candidates 40x16": DECODE_CANDIDATES.plan(40, MAX_CANDIDATES),
        "decode_candidates 1x16": DECODE_CANDIDATES.plan(1, MAX_CANDIDATES)}
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


def wideband_runner(dev, mode: str, ndjson_buf, pcap_buf, ltk: bytes | None = None):
    """The CLI's WidebandStreamRunner for ``wideband --fused --fused-dtype
    MODE --follow --max-follow 2 --json --pcap [--ltk]``, writing to
    memory."""
    from btle_tpu_torch.stream import NdjsonEmitter, PcapWriter
    from btle_tpu_torch.wideband import WidebandConfig, WidebandSniffer
    from btle_tpu_torch.wideband.stream import WidebandStreamRunner

    sn = WidebandSniffer(WidebandConfig(follow_connections=True, max_follow=2,
                                        fused=True, fused_dtype=mode,
                                        scan_len_ch=WB_SCAN_LEN), device=dev)
    return WidebandStreamRunner(sn, ndjson=NdjsonEmitter(ndjson_buf),
                                pcap=PcapWriter(pcap_buf), ltk=ltk)


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
# V1, the LE Coded PHY, the BER simulation and the anchor-SNR sensitivity
# --------------------------------------------------------------------------

# the coded wideband scan at the CLI's geometry: one 80 Msps capture of
# 8.192 ms (32768 channel samples), the 1280-tap prototype, 40 channels,
# 4 candidate slots; S8 and S2 packets on five channels (two advertising)
CODED_BLOCK = 655_360
CODED_CANDIDATES = 4
CODED_PLAN = ((37, 8, 30_000), (9, 2, 160_000), (25, 8, 240_000),
              (2, 2, 380_000), (38, 2, 470_000))     # (channel, S, offset)
CODED_NOISE_STD = 3.0
CODED_TX = "37-ADV_IND-TxAdd-0-RxAdd-0-AdvA-0A0B0C0D0E0F-AdvData-0011-Space-1"
V1_STEPS = 364                                     # rx.coded.DEC_STEPS
BER_2M_ANCHORS = ((0.0, 11.0), (50.0, 26.0))       # (ppm, SNR dB), 300 packets


def v1_bound(rows: int, n: int, max_sm_mhz: float) -> dict:
    """V1's least time two ways. The contract's bound: bytes (2 float32
    inputs and one int8 output a step, one float32 a trellis) over the
    memory rate, or operations (4 products, 3 branch adds, 1 metric add
    and 1 compare per (state, predecessor) per iteration) over the FP32
    rate, whichever is larger. The chain: 182 add-compare-select
    iterations and 182 traceback steps, each waiting on the last, at no
    less than one dependent 4-cycle operation a step at the card's
    maximum SM clock."""
    nbytes = rows * (n * (4 + 4 + 1) + 4)
    ops = rows * (n // 2) * 8 * 4 * 9
    ms, by = bound_ms(nbytes, ops, FP32_FLOPS)
    chain_ms = n * 4 / (max_sm_mhz * 1e3)
    return {"bound_ms": ms, "bound_by": by, "chain_bound_ms": chain_ms,
            "binds": "chain" if chain_ms > ms else by}


def check_viterbi(dev, ptx: dict) -> dict:
    """The "viterbi" phase: V1 against its twin at the wideband scan's
    shape (160 trellises: 40 channels x 4 candidate slots) and the
    narrowband decode's (4), on random soft inputs and on hard +-1 inputs
    with exact zeros (ties): bits and pm_end equal. Then its profiler
    time at 160 x 364, the twin's, the bounds, the launch shape and the
    ptxas report."""
    import torch

    from btle_tpu_torch.phy.viterbi import (VITERBI_R2, viterbi_r2_kernel,
                                            viterbi_decode_r2_reference)

    gen = torch.Generator(device=dev).manual_seed(364)
    cases, operands = {}, {}
    for rows in (40 * CODED_CANDIDATES, CODED_CANDIDATES):
        for kind in ("soft", "hard"):
            la = torch.randn((rows, V1_STEPS), generator=gen, device=dev)
            lb = torch.randn((rows, V1_STEPS), generator=gen, device=dev)
            if kind == "hard":
                la, lb = la.sign(), lb.sign()
                la[:, ::7] = 0.0
            got = viterbi_r2_kernel(la, lb)
            want = viterbi_decode_r2_reference(la, lb)
            torch.cuda.synchronize()
            same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            cases[f"{rows}x{V1_STEPS} {kind}"] = {
                "equal": same, "bits_differ": int((got[0] != want[0]).sum()),
                "max_abs_err": float((got[1] - want[1]).abs().max())}
            if not same:
                raise AssertionError(f"V1 disagrees with its twin: {cases}")
            operands[(rows, kind)] = (la, lb)
    la, lb = operands[(40 * CODED_CANDIDATES, "soft")]
    max_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    timing = {**kernel_times(VITERBI_R2, lambda: viterbi_r2_kernel(la, lb),
                             lambda: viterbi_decode_r2_reference(la, lb), 50),
              **v1_bound(la.shape[0], V1_STEPS, max_mhz), "max_sm_mhz": max_mhz,
              "plan": VITERBI_R2.plan(la.shape[0], V1_STEPS),
              "ptxas": ptxas_of(ptx, VITERBI_R2, ())}
    la4, lb4 = operands[(CODED_CANDIDATES, "soft")]
    timing["narrowband"] = {
        "ms": kernel_device_ms(lambda: viterbi_r2_kernel(la4, lb4),
                               "viterbi_r2_kernel", 50)[0],
        **v1_bound(la4.shape[0], V1_STEPS, max_mhz)}
    log({"phase": "viterbi", "cases": cases, **timing})
    return {"max_abs_err": 0.0, **timing}


def coded_capture(seed: int = 31):
    """CODED_PLAN's packets (12-byte payloads, header 0x42) composed into
    one CODED_BLOCK capture with noise: (wi, wq, {channel: (pdu, S)})."""
    from btle_tpu_torch.golden import gfsk_modulate_float
    from btle_tpu_torch.spec import coded as K
    from btle_tpu_torch.spec.bits import bytes_to_bits
    from btle_tpu_torch.wideband import compose_wideband

    rng = np.random.default_rng(seed)
    placements, injected = [], {}
    for ch, s, off in CODED_PLAN:
        pdu = np.concatenate([[0x42, 12], rng.integers(0, 256, 12)]).astype(np.uint8)
        ci, cq = gfsk_modulate_float(
            K.assemble_coded_phy(bytes_to_bits(pdu), ch, s=s), 80)
        placements.append((ch, off, ci.astype(np.float32), cq.astype(np.float32)))
        injected[ch] = (pdu, s)
    wi, wq = compose_wideband(placements, CODED_BLOCK)
    wi += rng.normal(0, CODED_NOISE_STD, CODED_BLOCK).astype(np.float32)
    wq += rng.normal(0, CODED_NOISE_STD, CODED_BLOCK).astype(np.float32)
    return wi, wq, injected


def check_coded_packets(label: str, pkts, injected: dict) -> dict:
    """Every injected (channel, PDU) CRC-OK, byte-exact and at its S; no
    other CRC-OK packet (adjacent sync positions of one packet are one
    packet)."""
    ok = {(p["channel"], bytes(p["pdu_bytes"]), p["s"]) for p in pkts if p["crc_ok"]}
    want = {(ch, bytes(pdu), s) for ch, (pdu, s) in injected.items()}
    if ok != want:
        raise AssertionError(f"coded {label}: missing {sorted(want - ok)}, "
                             f"other CRC-OK {sorted(ok - want)}")
    return {"injected": len(want), "crc_ok_candidates": sum(p["crc_ok"] for p in pkts),
            "candidates": len(pkts)}


def run_coded(dev, kernels, launches) -> dict:
    """The "coded" phase. The tx CLI then the decode CLI in child
    processes on the card at coded8 and coded2 (narrowband loopback,
    byte-exact), and decode_coded on the same file in this process; then
    the wideband coded scan of CODED_PLAN's capture (every injected
    packet CRC-OK and byte-exact at its S, no other); V1 must have
    launched. Then ms a block of the scan program (CUDA events, the
    capture on the card) and a profile: device busy and idle share, time
    by kernel."""
    from collections import Counter

    import torch

    from btle_tpu_torch.rx.coded import decode_coded
    from btle_tpu_torch.tx import parse_descriptor
    from btle_tpu_torch.wideband.coded import (coded_scan_tables, scan_coded_capture,
                                               wideband_scan_coded)

    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    spec = parse_descriptor(CODED_TX)
    want_hex = bytes(np.packbits(spec.info_bits[40:].astype(np.uint8),
                                 bitorder="little")).hex()
    report = {"narrowband": {}}
    total = Counter()
    for phy in ("coded8", "coded2"):
        path = out_dir / f"coded.{phy}.f32"
        lines = []
        for args in (["tx", CODED_TX, "--phy", phy, "--out", str(path)],
                     ["decode", "--bin", str(path), "--format", "f32", "--phy", phy,
                      "--channel", "37"]):
            proc = subprocess.run([sys.executable, "-m", "btle_tpu_torch", *args],
                                  cwd=ROOT, capture_output=True, text=True, timeout=300)
            if proc.returncode:
                raise AssertionError(f"{args[0]} --phy {phy} exited "
                                     f"{proc.returncode}: {proc.stderr[-2000:]}")
            lines = proc.stdout.splitlines()
        ok = [ln for ln in lines if " crc0 " in ln]
        if not ok or any(not ln.endswith(want_hex) or f"S={phy[-1]}" not in ln
                         for ln in ok):
            raise AssertionError(f"decode --phy {phy}: {lines[:4]} (want {want_hex})")
        data = np.fromfile(path, np.float32)
        pkts, got = counted(kernels, lambda d=data: decode_coded(
            d[0::2], d[1::2], 37, device=dev, max_candidates=8))
        if not pkts or not all(p["crc_ok"] and bytes(p["pdu_bytes"]).hex() == want_hex
                               for p in pkts):
            raise AssertionError(f"decode_coded ({phy}): {pkts[:2]}")
        report["narrowband"][phy] = {"cli_crc_ok_lines": len(ok),
                                     "library_candidates": len(pkts), "launches": got}
        add_launches(total, got)

    wi, wq, injected = coded_capture()
    pkts, got = counted(kernels, lambda: scan_coded_capture(
        wi, wq, max_candidates=CODED_CANDIDATES, device=dev))
    report["wideband"] = {**check_coded_packets("wideband scan", pkts, injected),
                          "channels": sorted(injected), "launches": got}
    add_launches(total, got)
    if total.get("viterbi_r2", 0) <= 0:
        raise AssertionError(f"the coded paths never launched V1: {total}")
    add_launches(launches, total)

    tables = coded_scan_tables(device=dev)
    xi, xq = torch.as_tensor(wi, device=dev), torch.as_tensor(wq, device=dev)

    def step():
        return wideband_scan_coded(xi, xq, *tables, max_candidates=CODED_CANDIDATES,
                                   device=dev)["crc_ok"]

    ms = [cuda_time_ms(step, 10, warm=2 if t == 0 else 1) for t in range(5)]
    air_ms = CODED_BLOCK / 80e3
    report["scan"] = {"block_samples": CODED_BLOCK, "air_ms": air_ms,
                      "ms_per_block": statistics.median(ms), "trials_ms": ms,
                      "x_real_time": air_ms / statistics.median(ms),
                      "profile": device_profile(lambda: [step() for _ in range(8)], 8)}
    log({"phase": "coded", **report})
    return report


def run_ber(dev) -> dict:
    """The "ber" phase: BASELINE config 3 on the card. The full-depth
    sweep (btle_tpu_torch.tools.ber_sweep: 4 ppms x 4 points, 3600
    packets, sps 8, seed 11): every anchor at or below the reference's
    0.1%, ~93,600 bits an anchor, and each ppm's lowest point markedly
    worse (tests/test_ber_full.py's criteria); its seconds and packets
    per second. Then a 2M harness anchor pair (300 packets each) within
    tests/test_sim.py's 0.5% bound."""
    from btle_tpu_torch.sim import BerHarness
    from btle_tpu_torch.tools import ber_sweep

    out = ber_sweep.run(dev, seed=11)
    pts = out["points"]
    bad = [p for p in pts if p["is_anchor"] and (p["ber"] > 1e-3 or p["bits"] < 90_000)]
    curves = {}
    for p in pts:
        curves.setdefault(p["ppm"], []).append(p)
    flat = [ppm for ppm, c in curves.items()
            if not c[0]["ber"] > 10 * max(c[-1]["ber"], 1e-6)]
    h2 = BerHarness(phy="2m", device=dev)
    two_m = []
    for ppm, snr in BER_2M_ANCHORS:
        ber, ok, nbits = h2.ber_point(snr, ppm, 300, seed=11)
        two_m.append({"ppm": ppm, "snr_db": snr, "ber": ber, "pkts_ok": ok, "bits": nbits})
    report = {"seconds": out["seconds"], "packets": out["packets"],
              "packets_per_s": out["packets"] / out["seconds"],
              "anchors_pass": out["anchors_pass"], "points": pts, "2m_anchors": two_m}
    log({"phase": "ber", **report})
    print(out["markdown"], flush=True)
    if bad or flat or not out["anchors_pass"] or out["packets"] != 3600:
        raise AssertionError(f"ber: anchors {bad}, no waterfall at ppm {flat}")
    if any(r["ber"] > 5e-3 for r in two_m):
        raise AssertionError(f"ber: 2M anchors {two_m}")
    return report


# --------------------------------------------------------------------------
# the recon chain and passive decryption: scan, wideband --ltk, recon,
# analyze and iq-show
# --------------------------------------------------------------------------

# tests/test_llcrypto.py's key and LL_ENC_REQ / LL_ENC_RSP fields (on-air
# byte order)
RECON_LTK = bytes.fromhex("4C68384139F574D836BCF34E9DFB01BF")
RECON_SKD_M, RECON_SKD_S = bytes.fromhex("13024212ACDEAF99"), bytes.fromhex("7907E2021B24D379")
RECON_IV_M, RECON_IV_S = bytes.fromhex("BADCAB24"), bytes.fromhex("DEAFBABE")
RECON_MODES = ("bf16x2w", "f32")
# the CONNECT_REQs' AdvA (connect_req_pdu), in display order
RECON_ADV_A = "90:d7:eb:b1:92:99"


def l2cap_att(att: bytes) -> bytes:
    """One ATT PDU as an L2CAP frame on the ATT channel (CID 4)."""
    return len(att).to_bytes(2, "little") + (4).to_bytes(2, "little") + att


def encrypted_connection_pdus() -> tuple[list, dict]:
    """The followed connection's data PDUs, in air order: LL_ENC_REQ and
    LL_ENC_RSP in the clear, then ATT traffic encrypted under the session
    they key (the port's LlSession.encrypt, both directions): an MTU
    exchange, a write request and response, a notification, a read
    request and response, each ATT PDU whole in one LL PDU (``recon
    gatt``, in both packages, reassembles the capture's data PDUs as one
    stream, so the other connection's fragments would land inside a
    fragmented one). Returns (PDU bytes, {PDU: (LLID, plaintext)} of the
    encrypted ones)."""
    from btle_tpu_torch.ll.crypto import LlSession

    tx = LlSession.from_enc_exchange(RECON_LTK, RECON_SKD_M, RECON_SKD_S,
                                     RECON_IV_M, RECON_IV_S)
    plan = [(2, 1, l2cap_att(bytes([0x02, 0xF7, 0x00]))),
            (2, 0, l2cap_att(bytes([0x03, 0xF7, 0x00]))),
            (2, 1, l2cap_att(bytes([0x12, 0x33, 0x00, 0x07, 0x08]))),
            (2, 0, l2cap_att(bytes([0x13]))),
            (2, 0, l2cap_att(bytes([0x1B, 0x2A, 0x00]) + b"heart-rate=72 bpm")),
            (2, 1, l2cap_att(bytes([0x0A, 0x03, 0x00]))),
            (2, 0, l2cap_att(bytes([0x0B]) + b"btle-tpu"))]
    pdus = [bytes([0x03, 23, 0x03]) + bytes(range(8)) + b"\x11\x22" + RECON_SKD_M + RECON_IV_M,
            bytes([0x03, 13, 0x04]) + RECON_SKD_S + RECON_IV_S]
    plain = {}
    for llid, direction, body in plan:
        ct = tx.encrypt(llid, body, direction)
        pdus.append(bytes([llid, len(ct)]) + ct)
        plain[pdus[-1]] = (llid, body)
    return pdus, plain


def cli_child(args, timeout: int = 300) -> tuple[str, str, float]:
    """``python -m btle_tpu_torch ARGS`` in a child process: (stdout,
    stderr, wall seconds); a non-zero exit raises."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "btle_tpu_torch", *map(str, args)],
                          cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"{' '.join(map(str, args[:2]))} exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    return proc.stdout, proc.stderr, seconds


def cli_in_process(args) -> str:
    """The port's CLI main() in this process: its standard output."""
    import contextlib

    from btle_tpu_torch.cli.app import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = main([str(a) for a in args])
    if rc:
        raise AssertionError(f"{args[0]} (in process) returned {rc}")
    return out.getvalue()


def check_aes() -> dict:
    """AES-128 and AES-CCM of the port (numpy, host-side; the port uses
    no cryptography package) against the standard's constants: FIPS-197
    C.1, an LlSession loopback in both directions, a tampered MIC
    refused; then microseconds a 16-byte block, a 27-byte PDU encrypted
    and decrypted, and a plaintext PDU refused by a keyed session (every
    counter of the window in both directions)."""
    from btle_tpu_torch.ll import crypto

    key = bytes(range(16))
    block = bytes.fromhex("00112233445566778899aabbccddeeff")
    if crypto.aes_e(key, block).hex() != "69c4e0d86a7b0430d8cdb78070b4c55a":
        raise AssertionError("AES-128 misses FIPS-197 C.1")
    exchange = (RECON_LTK, RECON_SKD_M, RECON_SKD_S, RECON_IV_M, RECON_IV_S)
    tx, rx = (crypto.LlSession.from_enc_exchange(*exchange) for _ in range(2))
    for direction in (0, 1):
        for k in range(4):
            payload = bytes([direction, k]) * 13 + b"!"
            if rx.decrypt(0x02, tx.encrypt(0x02, payload, direction), direction) != payload:
                raise AssertionError(f"LlSession loopback failed (direction {direction})")
    bad = bytearray(tx.encrypt(0x02, b"tamper-me", 0))
    bad[-1] ^= 1
    if rx.decrypt(0x02, bytes(bad), 0) is not None:
        raise AssertionError("a tampered MIC was accepted")
    reps = 300
    t0 = time.perf_counter()
    for _ in range(reps):
        crypto.aes_e(key, block)
    us_block = 1e6 * (time.perf_counter() - t0) / reps
    payload = bytes(range(27))
    sess, recv = crypto.LlSession(sk=key, iv=bytes(8)), crypto.LlSession(sk=key, iv=bytes(8))
    t0 = time.perf_counter()
    cts = [sess.encrypt(0x02, payload, 0) for _ in range(reps)]
    us_enc = 1e6 * (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    if any(recv.decrypt(0x02, ct, 0) != payload for ct in cts):
        raise AssertionError("a 27-byte PDU did not decrypt")
    us_dec = 1e6 * (time.perf_counter() - t0) / reps
    dec = crypto.SniffDecryptor(key)
    dec.sessions[1] = crypto.LlSession(sk=key, iv=bytes(8))
    t0 = time.perf_counter()
    for _ in range(20):
        if dec.try_decrypt(1, 0x02, payload) is not None:
            raise AssertionError("a plaintext PDU authenticated")
    us_reject = 1e6 * (time.perf_counter() - t0) / 20
    return {"fips197_c1": True, "loopback": True, "tamper_refused": True,
            "us_per_block": us_block, "us_per_pdu27_encrypt": us_enc,
            "us_per_pdu27_decrypt": us_dec, "us_per_plaintext_pdu_refused": us_reject}


def scan_advertisers(nb_want) -> dict:
    """{AdvA: packets} of the narrowband scene's advertising packets."""
    from collections import Counter

    counts = Counter()
    for _, aa, pdu in nb_want:
        kind = pdu[0] & 0x0F
        if aa != ADV_AA:
            continue
        raw = pdu[2:8] if kind in (0, 1, 2, 3, 4, 6) else pdu[8:14] if kind == 5 else b""
        if len(raw) == 6:
            counts[":".join(f"{b:02x}" for b in raw[::-1])] += 1
    return dict(counts)


def run_recon_scan(kernels, nb_i, nb_q, nb_want, out_dir) -> tuple[dict, dict]:
    """``scan`` over the narrowband scene written as i16: in this process
    on the card (K7 and K4 counted), then in child processes on the card
    and with --device cpu (the twins), --json and the table: all four
    byte-equal pairwise, the quickscan listing every advertiser of the
    scene with its packet count."""
    path = out_dir / "recon_nb.i16"
    np.stack([nb_i, nb_q], axis=1).reshape(-1).tofile(path)
    air_s = NB_SAMPLES / (NB_SPS * 1e6)
    argv = ["scan", "--bin", path, "--format", "i16"]
    try:
        walls, outs = [], []
        for extra in (["--json"], [], ["--json"]):
            t0 = time.perf_counter()
            out, got = counted(kernels, lambda e=extra: cli_in_process([*argv, *e]))
            walls.append(time.perf_counter() - t0)
            outs.append((out, got))
        (text_json, got), (table, got_table) = outs[:2]
        if outs[2][0] != text_json:
            raise AssertionError("scan --json differs between two runs")
        for name in ("scan_block", "decode_candidates"):
            if got.get(name, 0) <= 0:
                raise AssertionError(f"scan never launched {name}: {got}")
        # the first run pays the process's first launches of K7 and K4
        report = {"air_s": air_s, "in_process_s": walls, "x_real_time": air_s / walls[-1],
                  "launches": got}
        for label, extra, want in (("json", ["--json"], text_json), ("table", [], table)):
            card, _, card_s = cli_child([*argv, *extra])
            cpu, _, cpu_s = cli_child([*argv, *extra, "--device", "cpu"])
            if not (card == cpu == want):
                raise AssertionError(f"scan ({label}): the card's output differs from "
                                     f"--device cpu or the in-process run")
            report[label] = {"card_s": card_s, "cpu_s": cpu_s, "bytes": len(card),
                             "equal": True}
    finally:
        path.unlink(missing_ok=True)
    summary = json.loads(text_json)
    counts = scan_advertisers(nb_want)
    listed = {d["adv_a"]: d["n_pkts"] for d in summary["devices_top"]}
    if summary["n_devices"] != len(counts) or any(counts.get(a) != n for a, n in listed.items()):
        raise AssertionError(f"scan: {summary['n_devices']} devices {listed}, "
                             f"the scene has {len(counts)}")
    if len(table.splitlines()) != 1 + len(counts):
        raise AssertionError("scan: the table does not list every advertiser")
    report.update({"n_devices": summary["n_devices"], "n_packets": summary["n_packets"],
                   "devices_listed": len(listed)})
    return report, {k: got.get(k, 0) + got_table.get(k, 0) for k in {*got, *got_table}}


def ndjson_pdu(e: dict) -> bytes:
    """The PDU bytes of an NDJSON data event (header from its fields)."""
    h0 = e["ll_pdu_type"] | e["nesn"] << 2 | e["sn"] << 3 | e["md"] << 4
    return bytes([h0, e["plen"]]) + bytes.fromhex(e["payload_hex"])


def check_plaintexts(label: str, ndjson_text: str, plain: dict) -> int:
    """Every encrypted PDU of the scene carries its plaintext as
    plain_hex, once; no other event carries one."""
    seen = 0
    for e in ndjson_without_ts(ndjson_text):
        if e["t"] != "pkt" or e.get("kind") != "data" or not e["crc_ok"]:
            if "plain_hex" in e:
                raise AssertionError(f"{label}: plain_hex on {e}")
            continue
        pdu = ndjson_pdu(e)
        want = plain.get(pdu)
        if want is None:
            if "plain_hex" in e:
                raise AssertionError(f"{label}: plain_hex on a PDU sent in the clear")
        elif e.get("plain_hex") != want[1].hex():
            raise AssertionError(f"{label}: {e.get('plain_hex')} for {want[1].hex()}")
        else:
            seen += 1
    if seen != len(plain):
        raise AssertionError(f"{label}: {seen} of {len(plain)} PDUs decrypted")
    return seen


def run_recon_wideband(dev, kernels, out_dir) -> tuple[dict, dict, dict]:
    """``wideband --fused --ltk`` on the card over the 0.2 s CLI scene whose
    first connection carries an LL_ENC_REQ/RSP exchange and encrypted ATT
    traffic: per mode the library runner without and with the LTK (the
    real-time factors; the difference is the host's decryption), then the
    CLI with --follow --max-follow 2 --json --pcap --ltk in a child
    process, equal to the library run. Returns (report, launches, files)."""
    import torch

    pdus, plain = encrypted_connection_pdus()
    left = list(pdus)
    wi, wq, want = wideband_cli_scene(data_pdus={WB_CONNS[0][0]: left})
    placed = pdus[:len(pdus) - len(left)]
    plain = {p: plain[p] for p in placed if p in plain}
    if len(plain) < 4:
        raise AssertionError(f"the scene holds only {len(plain)} encrypted PDUs")
    air_s = len(wi) / 80e6
    files = {"f32": out_dir / "recon_wideband.f32", "i8": out_dir / "recon_wideband.i8"}
    for fmt, path in files.items():
        inter = np.empty(2 * len(wi), np.int8 if fmt == "i8" else np.float32)
        inter[0::2], inter[1::2] = wi, wq
        inter.tofile(path)
    fi, fq = wi.astype(np.float32), wq.astype(np.float32)
    launches = {k.name: 0 for k in kernels}
    report = {"air_s": air_s, "data_pdus_placed": len(placed), "encrypted": len(plain)}

    def library(mode, ltk):
        buf, pc = io.StringIO(), io.BytesIO()
        runner = wideband_runner(dev, mode, buf, pc, ltk=ltk)
        runner.start()
        pkts = runner.run_capture(fi, fq)
        runner.stop()
        torch.cuda.synchronize()
        return runner, pkts, buf.getvalue(), pc.getvalue()

    for mode in RECON_MODES:
        trials = {"plain": [], "ltk": []}
        got_ltk = {}
        # in turns, so that drift and the first run's warm-up fall on both
        for label in ("plain", "ltk", "ltk", "plain", "plain", "ltk"):
            ltk = RECON_LTK if label == "ltk" else None
            (runner, pkts, ndjson, pcap), got = counted(kernels, lambda m=mode, k=ltk: library(m, k))
            check_wideband_packets(f"wideband --ltk scene ({mode}, {label})", pkts, want)
            add_launches(launches, got)
            trials[label].append(runner.stats.wall_s)
            if ltk is None:
                (out_dir / f"recon-{mode}-plain.pcap").write_bytes(pcap)
                continue
            decrypted = check_plaintexts(f"library ({mode})", ndjson, plain)
            if runner.decryptor.decrypted != len(plain):
                raise AssertionError(f"library ({mode}): {runner.decryptor.decrypted} decrypted")
            got_ltk = got
        line = {label: {"wall_s": statistics.median(t), "trials_s": t,
                        "x_real_time": air_s / statistics.median(t)}
                for label, t in trials.items()}
        line["ltk"].update({"decrypted": decrypted, "blocks": runner.stats.blocks,
                            "launches": got_ltk})
        line["decrypt_ms_per_block"] = 1e3 * (line["ltk"]["wall_s"] - line["plain"]["wall_s"]) \
            / runner.stats.blocks
        pcap_path = out_dir / f"recon-{mode}.pcap"
        stdout, stderr, cli_s = cli_child([
            "wideband", "--bin", files["f32"], "--format", "f32", "--fused",
            "--fused-dtype", mode, "--follow", "--max-follow", "2", "--json",
            "--pcap", pcap_path, "--ltk", RECON_LTK.hex()])
        if ndjson_without_ts(stdout) != ndjson_without_ts(ndjson):
            raise AssertionError(f"wideband --ltk CLI ({mode}) differs from the library run")
        if pcap_records(pcap_path.read_bytes()) != pcap_records(pcap):
            raise AssertionError(f"wideband --ltk CLI ({mode}): the pcap differs")
        line["cli"] = {"wall_s": cli_s, "x_real_time_with_start": air_s / cli_s,
                       "summary": stderr.strip().splitlines()[-2:]}
        report[mode] = line
    return report, launches, {"plain": plain, "placed": placed, **files}


def run_recon(dev, kernels, launches, nb_i, nb_q, nb_want) -> dict:
    """The "recon" phase: the AES known answers, ``scan`` on the card,
    ``wideband --fused --ltk`` on the card, then ``recon gatt --ltk``,
    quickscan, profile, diff and entropy and ``analyze`` on its pcap, and
    ``iq-show`` on the wideband capture, each in a child process and equal
    to the port's in-process call of the same function."""
    import importlib.util

    from btle_tpu_torch.cli import analyze, recon
    from btle_tpu_torch.ll.l2cap import att_stream

    log({"phase": "recon_device", "nvidia_smi": nvidia_smi()})
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    report = {"aes": check_aes()}
    report["scan"], got = run_recon_scan(kernels, nb_i, nb_q, nb_want, out_dir)
    add_launches(launches, got)
    wb, got, files = run_recon_wideband(dev, kernels, out_dir)
    add_launches(launches, got)
    report["wideband_ltk"] = wb
    try:
        pcap = out_dir / "recon-bf16x2w.pcap"
        plain_pcap = out_dir / "recon-bf16x2w-plain.pcap"
        ltk_hex = RECON_LTK.hex()
        ops = {"gatt": (["recon", "gatt", pcap, "--ltk", ltk_hex],
                        lambda: recon.gatt(str(pcap), ltk_hex=ltk_hex)),
               "quickscan": (["recon", "quickscan", pcap], lambda: recon.quickscan(str(pcap))),
               "profile": (["recon", "profile", pcap, "--adv-a", RECON_ADV_A],
                           lambda: recon.profile(str(pcap), RECON_ADV_A)),
               "diff": (["recon", "diff", plain_pcap, pcap],
                        lambda: recon.diff(str(plain_pcap), str(pcap))),
               "entropy": (["recon", "entropy", pcap, "--adv-a", RECON_ADV_A],
                           lambda: recon.payload_entropy(str(pcap), RECON_ADV_A))}
        recon_report, outs = {}, {}
        for name, (args, fn) in ops.items():
            outs[name], _, seconds = cli_child(args)
            if outs[name] != fn().model_dump_json(indent=2, exclude_none=True) + "\n":
                raise AssertionError(f"recon {name}: the CLI differs from the in-process call")
            recon_report[name] = {"wall_s": seconds, "bytes": len(outs[name])}
        gatt = json.loads(outs["gatt"])
        want_ops = [{"name": o.name, **({"handle": o.handle} if o.handle is not None else {}),
                     **({"mtu": o.mtu} if o.mtu is not None else {}),
                     **({"value_hex": o.value.hex()} if o.value else {}), "decrypted": True}
                    for o in att_stream(files["plain"][p] for p in files["placed"]
                                        if p in files["plain"])]
        if gatt["ops"] != want_ops or gatt["n_decrypted"] != len(files["plain"]):
            raise AssertionError(f"recon gatt --ltk: {gatt['ops']} for {want_ops}")
        recon_report["gatt"].update({"ops": [o["name"] for o in gatt["ops"]],
                                     "n_decrypted": gatt["n_decrypted"],
                                     "n_data_pdus": gatt["n_data_pdus"]})
        out, _, seconds = cli_child(["analyze", pcap])
        if out != "\n".join(analyze.analyze_pcap(str(pcap)).summary_lines()) + "\n":
            raise AssertionError("analyze: the CLI differs from the in-process call")
        _, err, plot_s = cli_child(["analyze", pcap, "--plot", out_dir / "recon-plot.png"])
        no_mpl = importlib.util.find_spec("matplotlib") is None
        want_line = "# plots skipped (no matplotlib)" if no_mpl else "# plots written: "
        if not err.strip().splitlines()[-1].startswith(want_line):
            raise AssertionError(f"analyze --plot: {err[-500:]}")
        recon_report["analyze"] = {"wall_s": seconds, "lines": out.count("\n"),
                                   "plot_wall_s": plot_s, "matplotlib": not no_mpl,
                                   "plot_line": err.strip().splitlines()[-1]}
        report["recon"] = recon_report
        args = ["iq-show", files["i8"], "--format", "i8", "--rate", "80e6",
                "--center", "2.442e9", "--fft", "1024", "--max-samples", "16000000"]
        out, _, seconds = cli_child(args)
        if out != cli_in_process(args):
            raise AssertionError("iq-show: the CLI differs from the in-process call")
        rows = [ln for ln in out.splitlines() if ln.startswith("offset")]
        if not rows:
            raise AssertionError(f"iq-show: no occupied bins in {out[:300]}")
        report["iq_show"] = {"wall_s": seconds, "rows": len(rows), "first_rows": rows[:3],
                             "header": out.splitlines()[0]}
    finally:
        for path in (files["f32"], files["i8"], *out_dir.glob("recon-*")):
            path.unlink(missing_ok=True)
    log({"phase": "recon", **report})
    return report


def run_sensitivity(dev, kernels, launches) -> dict:
    """The sensitivity check: tests/test_wideband_sensitivity.py's 1M
    scene at 11 dB through every shipped fused mode and the plain scan
    (btle_tpu_torch.tools.sensitivity): each at least 23 of 25 and within
    1 packet of "f32"."""
    from btle_tpu_torch.tools import sensitivity

    res, got = counted(kernels, lambda: sensitivity.run(dev))
    bad = sensitivity.check(res)
    log({"phase": "sensitivity", **res, "failures": bad, "launches": got})
    if bad:
        raise AssertionError(f"sensitivity at 11 dB: {bad}")
    add_launches(launches, got)
    return res


# --------------------------------------------------------------------------
# the card gates and benches: btle_tpu_torch.bench and btle_tpu_torch.tools
# --------------------------------------------------------------------------

# the soak at the TPU gate's size: 150 packets over 0.25 s of air on all 40
# channels plus 12 followed connections with channel-map updates (4 packets
# each), at 1M and 2M, in the shipped mode and the exact one
SOAK_RUNS = (("1m", "bf16x2w"), ("1m", "f32"), ("2m", "bf16x2w"), ("2m", "f32"))
SOAK_PACKETS, SOAK_SECONDS, SOAK_CONNECTIONS = 150, 0.25, 12
# the live loop against a producer paced at the 80 Msps wire rate
LIVE_RUNS = ((131072, "bf16x2w"), (8192, "bf16x2w"), (8192, "f32"))
LIVE_SECONDS, LIVE_RATE = 5.0, 80.0


def counted(kernels, fn):
    """fn() with the launch counts zeroed just before and read just after:
    (its result, {kernel: launches} of the kernels it launched)."""
    zero_launches(kernels)
    out = fn()
    return out, {k: n for k, n in read_launches(kernels).items() if n}


def add_launches(total: dict, got: dict) -> None:
    for name, n in got.items():
        total[name] += n


def run_soak(dev, kernels, launches) -> None:
    """The "soak" phase: soak_fused.run per SOAK_RUNS; each must decode
    every injected packet byte-exact, register, stale-drop and map-update
    every connection, and decode no ghost."""
    from btle_tpu_torch.tools import soak_fused

    want = SOAK_PACKETS + 4 * SOAK_CONNECTIONS
    for phy, mode in SOAK_RUNS:
        res, got = counted(kernels, lambda phy=phy, mode=mode: soak_fused.run(
            dev, seconds=SOAK_SECONDS, packets=SOAK_PACKETS, phy=phy, dtype=mode,
            connections=SOAK_CONNECTIONS, map_updates=True))
        log({"phase": "soak", "phy": phy, "mode": mode, "launches": got,
             **{k: res[k] for k in ("seconds_air", "background_packets", "injected",
                                    "decoded", "missing", "ghosts", "duplicates",
                                    "connections", "truncate_rescans", "synth_s",
                                    "sniff_s", "ok")}})
        conn = res["connections"]
        if not (res["ok"] and res["injected"] == res["decoded"] == want and not res["ghosts"]
                and conn["track_start"] == conn["track_drop"] == conn["chm_update"]
                == SOAK_CONNECTIONS):
            raise AssertionError(f"soak ({phy}, {mode}): {res['decoded']}/{res['injected']} "
                                 f"decoded, {len(res['ghosts'])} ghosts, connections {conn}")
        add_launches(launches, got)


def run_validate(dev, kernels, launches) -> None:
    """The "validate" phase: validate_fused.run must PASS."""
    from btle_tpu_torch.tools import validate_fused

    res, got = counted(kernels, lambda: validate_fused.run(dev))
    log({"phase": "validate", "launches": got, **res})
    if res["result"] != "PASS":
        raise AssertionError(f"validate: {res['checks']}")
    add_launches(launches, got)


def run_bench() -> dict:
    """The "bench" phase: ``python -m btle_tpu_torch.bench`` in a child
    process; its JSON line is printed as it came and parsed. The paths
    must name the fused kernels and the checksums be finite."""
    proc = subprocess.run([sys.executable, "-m", "btle_tpu_torch.bench"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"bench exited {proc.returncode}: {proc.stderr[-2000:]}")
    raw = proc.stdout.strip().splitlines()[-1]
    print(raw, flush=True)
    line = json.loads(raw)
    if (line["path"], line["parity_path"]) != ("fused-bf16x2w", "fused-f32-polyx") or not (
            np.isfinite(line["checksum"]) and np.isfinite(line["parity_checksum"])):
        raise AssertionError(f"bench: unexpected line {line}")
    return line


def run_live_bench(dev, kernels, launches) -> None:
    """The "live_bench" phase: bench_live.run per LIVE_RUNS against a
    producer paced at 80 Msps. BELOW WIRE RATE is a measurement (the live
    factor is unmet, PERF.md section 2); a CRC-OK packet not in the scene
    is a fault."""
    from btle_tpu_torch.tools import bench_live

    for block, mode in LIVE_RUNS:
        res, got = counted(kernels, lambda block=block, mode=mode: bench_live.run(
            dev, rate=LIVE_RATE, seconds=LIVE_SECONDS, block=block, dtype=mode))
        log({"phase": "live_bench", "launches": got, **res})
        if res["ghosts"] or res["blocks"] < 1 or res["scene_packets_decoded"] < 1:
            raise AssertionError(f"live bench ({block}, {mode}): {res['blocks']} blocks, "
                                 f"{res['scene_packets_decoded']} scene packets, "
                                 f"ghosts {res['ghosts'][:3]}")
        add_launches(launches, got)


def run_latency(dev, kernels, launches) -> None:
    """The "latency" phase: bench_latency.run at its three block sizes."""
    from btle_tpu_torch.tools import bench_latency

    lines, got = counted(kernels, lambda: bench_latency.run(dev))
    for line in lines:
        log({"phase": "latency", **line})
    add_launches(launches, got)


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
    clamped tails against its twin on candidates at the lattice's end.
    Returns (report, the four cases' arguments)."""
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
    return report, cases


def time_scan_kernel(args) -> dict:
    """K7 on ``args`` (i, q, AA rows, care mask, sps, lag): bit for bit
    against its twin, then its device time, twin time, launch shape and
    bound (i and q read once, bits and hits written once; per decision two
    products and a difference, per hit position 32 window bits, an xor, an
    and and a compare)."""
    import torch

    from btle_tpu_torch.phy.scan_kernel import (SCAN_BLOCK, scan_block_kernel,
                                                scan_block_plan, scan_block_reference)

    i = args[0]
    rows = i.shape[0] if i.ndim == 2 else 1
    sps, lag = args[4], args[5]
    n = i.shape[-1]
    n_bits, n_hit = n - lag, n - lag - 31 * sps
    got, want = scan_block_kernel(*args), scan_block_reference(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"scan_block at {rows} x {n} disagrees with its twin")
    return {"shape": [rows, n], "sps": sps, "lag": lag, "max_abs_err": 0,
            "plan": scan_block_plan(rows, n, sps, lag, i.is_floating_point()),
            **kernel_times(SCAN_BLOCK, lambda: scan_block_kernel(*args),
                           lambda: scan_block_reference(*args), 50),
            **dict(zip(("bound_ms", "bound_by"), bound_ms(
                rows * (2 * n * i.element_size() + 32 + n_bits + n_hit) + 32,
                rows * (4 * n_bits + (2 * 32 + 3) * n_hit), FP32_FLOPS)))}


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
    from btle_tpu_torch.wideband import fused

    out = {}
    # the tensor-core template: bf16 products per term 2 at bf16x2w, 4 at
    # f32x2 (the hi/lo pair), 1 at bf16
    for name, kernel, fn, twin, products in (
            ("filterbank_bf16x2w", fused.FILTERBANK_BF16X2W, fused.filterbank_bf16x2w,
             fused.filterbank_bf16x2w_reference, 2),
            ("filterbank_im2col_f32x2", fused.FILTERBANK_IM2COL["f32x2"],
             fused.filterbank_im2col, fused.filterbank_im2col_reference, 4),
            ("filterbank_im2col_bf16", fused.FILTERBANK_IM2COL["bf16"],
             fused.filterbank_im2col, fused.filterbank_im2col_reference, 1)):
        fb, _, _ = operands[name]
        out[name] = {
            **kernel_times(kernel, lambda fn=fn, fb=fb: fn(*fb),
                           lambda twin=twin, fb=fb: twin(*fb), 10, library=library[name]),
            **hilo_bound(fb, products), **hilo_grid(fb[0].device, fb[3]),
        }
    fb, _, _ = operands["filterbank_im2col_f32"]
    frames, gk, width, ky, kind = fb
    out["filterbank_im2col_f32"] = {
        **kernel_times(fused.FILTERBANK_IM2COL[kind],
                       lambda: fused.filterbank_im2col(*fb),
                       lambda: fused.filterbank_im2col_reference(*fb), 10,
                       library=library["filterbank_im2col_f32"]),
        **dict(zip(("bound_ms", "bound_by"), bound_ms(
            (frames.numel() + gk.numel() + 80 * ky) * 4,
            2 * 80 * 40 * width * ky, FP32_FLOPS))),
        "ms_trials": event_trials(lambda: fused.filterbank_im2col(*fb), 10),
        "plan": fused.FILTERBANK_IM2COL[kind].plan(
            ky, width, fused.sgemm_warps(ky, fused._sm_count(frames.device))),
    }
    fb, _, _ = operands["filterbank_polyx_f32"]
    out["filterbank_polyx_f32"] = {
        **kernel_times(fused.FILTERBANK_POLYX_F32,
                       lambda: fused.filterbank_polyx_f32(*fb),
                       lambda: fused.filterbank_polyx_f32_reference(*fb), 10,
                       library=library["filterbank_polyx_f32"]),
        **polyx_bound(fb),
        "ms_trials": event_trials(lambda: fused.filterbank_polyx_f32(*fb), 10),
        "plan": fused.polyx_plan(fb[3], fb[1].shape[1], fb[4], fb[0].device),
    }
    _, tail, y = operands["filterbank_bf16x2w"]
    n_bits, n_hit = tail[4], tail[5]
    out["demod_tail"] = {
        **kernel_times(fused.DEMOD_TAIL, lambda: fused.demod_tail(y, *tail),
                       lambda: fused.demod_tail_reference(y, *tail), 20),
        "ms_trials": event_trials(lambda: fused.demod_tail(y, *tail), 20),
        "ctas": 40 * -(-n_bits // 2048), **tail_bound(y, n_bits, n_hit),
    }
    out["decode_candidates"] = decode_times(decode_args)
    # the narrowband path's shape: one channel's lattice, 16 slots
    bits, pos, whiten, crc, adv = decode_args
    out["decode_candidates"]["narrowband_1x16"] = decode_times(
        (bits[:1].contiguous(), pos[:1].contiguous(), whiten[:1], crc[:1], adv[:1]))
    out["decode_candidates"]["launch_floor_ms"] = launch_floor_ms()
    return out


def polyx_bound(fb) -> dict:
    """bound_ms of K3: the stacked frames, the taps, the DFT and y moved
    once; 2 FLOP per stacked FMA and per DFT term."""
    f4, kcoefx, w4x, ky = fb[:4]
    rows, n_slices = kcoefx.shape
    return dict(zip(("bound_ms", "bound_by"), bound_ms(
        (f4.numel() + kcoefx.numel() + w4x.numel() + 80 * ky) * 4,
        2 * rows * n_slices * ky + 2 * 80 * rows * ky, FP32_FLOPS)))


def decode_times(decode_args, reps: int = 50) -> dict:
    """K4 on (bits, pos, whiten, crc, adv): profiler device time, CUDA-event
    trials, its twin's time, its launch shape and its bound (window bits
    read + tables + outputs; per candidate 336 xor/or and 42 x 8 three-op
    CRC steps)."""
    from btle_tpu_torch.rx.decode_kernel import (DECODE_CANDIDATES, decode_candidates,
                                                 decode_candidates_reference)

    bits, pos, whiten, crc, adv = decode_args
    m, c = pos.shape
    return {
        "shape": [m, c],
        **kernel_times(DECODE_CANDIDATES,
                       lambda: decode_candidates(bits, pos, whiten, crc, adv, 4),
                       lambda: decode_candidates_reference(bits, pos, whiten, crc,
                                                           adv, 4), reps),
        "ms_trials": event_trials(
            lambda: decode_candidates(bits, pos, whiten, crc, adv, 4), reps),
        "plan": DECODE_CANDIDATES.plan(m, c),
        **dict(zip(("bound_ms", "bound_by"), bound_ms(
            m * c * 336 + m * c * 4 + m * 336 + m * 5 + m * c * (42 * 4 + 6),
            m * c * (2 * 336 + 3 * 336), FP32_FLOPS))),
    }


def launch_floor_ms() -> float:
    """The profiler's device time of one empty kernel: the floor below
    which no kernel's time can go, recorded beside K4."""
    from btle_tpu_torch.tools._measure import launch_floor

    return kernel_device_ms(launch_floor, "launch_floor_kernel", 50)[0]


def probe_kernel_entries(dev, probes) -> list:
    """One entry of the kernels line per TPU probe kernel (K8-K11), each
    at the shape its probe gives it: the Hopper kernel it runs on, its
    device time, its twin's (plain) time, the library yardstick's where
    one PyTorch call computes the same function, its bound, its max
    |kernel - twin| there, and its launches in that probe's run."""
    import torch

    from btle_tpu_torch.convert import bf16_weights, sgemm_weights
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
    got, want = fused.demod_tail(y, *tail), fused.demod_tail_reference(y, *tail)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("K8 tail: demod_tail disagrees with its twin")
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
    entries[-1]["plan"] = K.aa_corr_plan(dec, 4, n_hit)

    # K9: the correlation and the stack
    s9, w4, _ = dev_aagrp_repro.make_inputs(8)
    s9 = torch.as_tensor(s9, device=dev)
    w9 = torch.as_tensor(dev_aagrp_repro.signs_of_w4(w4, 8), device=dev)
    t9 = dev_aagrp_repro.T
    entry("K9", "corr", K.AA_CORR, "tools/dev_aagrp_repro.py:118", "K9",
          lambda: K.aa_corr(s9, w9, 4, t9), lambda: K.aa_corr_reference(s9, w9, 4, t9), 50,
          s9.numel() * 4 + 40 * 32 * 4 + 40 * t9 * 5, 2 * 40 * 32 * t9,
          library=grouped_conv(s9, w9, 4, t9))
    entries[-1]["plan"] = K.aa_corr_plan(s9, 4, t9)
    entry("K9", "roll", K.SHIFT_STACK, "tools/dev_aagrp_repro.py:118", "K9",
          lambda: K.shift_stack(s9, 8, 4), lambda: K.shift_stack_reference(s9, 8, 4), 50,
          s9.numel() * 4 * (1 + 8), 0)
    entries[-1]["plan"] = K.shift_stack_plan(s9, 8)

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
        # the FP32 kernel's (40, 65, 80) table and (40, J) frames, or the
        # tensor cores' (K_pad, 80) table and time-major (J, 40) frames
        if kind == "f32_im2col":
            args = (f11, sgemm_weights(gk), 65, n_cols, kind)
        else:
            args = (fused.hilo_frames(torch.as_tensor(frames_np[0], device=dev),
                                      f11.shape[1], False), bf16_weights(gk), 65, n_cols, kind)

        def conv(f11=f11, w11=w11):
            with true_fp32():
                return torch.nn.functional.conv1d(f11[None], w11)[0, :, :n_cols]
        entry("K11", f"im2col {kind}", fused.FILTERBANK_IM2COL[kind],
              "tools/dev_roll_experiment.py:109", probe,
              lambda args=args: fused.filterbank_im2col(*args),
              lambda args=args: fused.filterbank_im2col_reference(*args), 10,
              f11.numel() * f11.element_size() + args[1].numel() * args[1].element_size()
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
    entries[-1]["plan"] = K.aa_corr_plan(l11, 4, n_cols)
    return entries


def main() -> int:
    import torch

    from btle_tpu_torch import _build
    from btle_tpu_torch.phy import scan_kernel, viterbi
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
    kernels = [*path_kernels, viterbi.VITERBI_R2, *probe_kernels.KERNELS]
    t0 = time.perf_counter()
    logs = _build.build([k.name for k in kernels], force=True)
    seconds = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, text in logs.items()}
    ptx = ptxas_kernels(logs)
    log({"phase": "build", "seconds": seconds, "ptxas": ptxas,
         "launch_plans": launch_plans(dev)})
    spills = [f"{n}: {ln}" for n in NO_SPILL_SOURCES for ln in ptxas.get(n, [])
              if re.search(r"[1-9]\d* bytes spill", ln)]
    if spills:
        raise AssertionError(f"the redesigned kernels spill: {spills}")
    missing = [n for n in NO_SPILL_SOURCES if not ptx.get(n)]
    if missing:
        raise AssertionError(f"no ptxas report for {missing}")

    report, operands, decode_args, library, wb_operands = check_kernels(dev)
    nb_i, nb_q, nb_want = narrowband_scene()
    nb_block = (nb_i[:SCAN_LEN + required_halo(NB_SPS, 1)],
                nb_q[:SCAN_LEN + required_halo(NB_SPS, 1)])
    nb_report, nb_scan_cases = check_narrowband_kernels(dev, nb_block, wb_operands)
    report["scan_block"] = {"max_abs_err": 0, "ok": True, **nb_report}
    log({"phase": "kernels_vs_twins", **report})
    v1 = check_viterbi(dev, ptx)

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
    run_soak(dev, kernels, launches)
    run_validate(dev, kernels, launches)
    bench_line = run_bench()
    run_live_bench(dev, kernels, launches)
    run_latency(dev, kernels, launches)
    run_coded(dev, kernels, launches)
    run_ber(dev)
    run_recon(dev, kernels, launches, nb_i, nb_q, nb_want)
    run_sensitivity(dev, kernels, launches)

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
    # K7 at the narrowband file block, the live block and 40 float rows
    nb_args = nb_scan_cases["int16_sps4_lag1"]
    live_n = NB_LIVE_SCAN_LEN + required_halo(NB_SPS, 1)
    per_kernel["scan_block"] = time_scan_kernel(nb_args)
    per_kernel["scan_block"]["live"] = time_scan_kernel(
        (nb_args[0][:live_n], nb_args[1][:live_n], *nb_args[2:]))
    per_kernel["scan_block"]["float_rows_40"] = time_scan_kernel(
        nb_scan_cases["float_rows_40"])
    for name, live in time_live(dev).items():
        per_kernel[name]["live"] = live
    for k in (fused.FILTERBANK_BF16X2W, fused.FILTERBANK_IM2COL["bf16"], fused.DEMOD_TAIL):
        per_kernel[k.name]["ptxas"] = ptxas_of(ptx, k)
    per_kernel["filterbank_polyx_f32"]["ptxas"] = ptxas_of(
        ptx, fused.FILTERBANK_POLYX_F32, ("stack", "warps"))
    per_kernel["decode_candidates"]["ptxas"] = ptxas_of(
        ptx, decode_kernel.DECODE_CANDIDATES, ("clamp_tail",))
    per_kernel["scan_block"]["ptxas"] = ptxas_of(ptx, scan_kernel.SCAN_BLOCK, ("iq",))
    probe_entries = probe_kernel_entries(dev, probes)
    # sps=0: the narrow tile (any sps); 1, 2, 4, 8: the wide tile's instances
    aa_ptxas = ptxas_of(ptx, probe_kernels.AA_CORR, ("lattice", "grp", "sps"))
    stack_ptxas = ptxas_of(ptx, probe_kernels.SHIFT_STACK, ())
    for e in probe_entries:
        if e["name"].startswith(probe_kernels.AA_CORR.name):
            e["ptxas"] = aa_ptxas
        elif e["name"].startswith(probe_kernels.SHIFT_STACK.name):
            e["ptxas"] = stack_ptxas
    rtf = narrowband_rtf(dev, nb_i, nb_q)
    log({"phase": "timing", "scan": scans, "clocks_after_scan": clocks_after_scan,
         "bench_msps": {k: bench_line[k] for k in (
             "value", "msps_min", "msps_max", "parity_msps", "parity_msps_min",
             "parity_msps_max")},
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
        **per_kernel[k.name]} for k in path_kernels] + probe_entries + [{
        "k": ["V1"], "name": viterbi.VITERBI_R2.name, "route": "cuda",
        "source": viterbi.VITERBI_R2.source, "replaces": viterbi.VITERBI_R2.replaces,
        "launches": launches[viterbi.VITERBI_R2.name], **v1}]})
    print(smi, flush=True)
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
