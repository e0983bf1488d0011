#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (btle_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit: ``python3 chip_smoke.py``. It builds every hand-written kernel
from ``btle_tpu_torch/csrc`` (into ``build/``), then runs, printing one
JSON line per phase:

  0. device: torch version, card name and power limit (nvidia-smi);
  1. build: seconds to compile the kernels (one nvcc per source, in
     parallel) and each kernel's ptxas register / shared-memory report;
  2. kernels: each kernel against its plain PyTorch twin on the card, on
     one bench-geometry block with packets in it (131072 + 1476 channel
     samples, 1280-tap prototype, 16 candidate slots);
  3. self-test: the known-answer self-test in both fused modes;
  4. main path: WidebandSniffer(fused=True).run() over a 4-block
     (131 ms) scene with ADV and LL data packets, a packet across a block
     boundary and a channel with more packets than candidate slots, in
     "bf16x2w" and in "f32"; every injected packet must decode CRC-OK and
     byte-exact on its channel, no other CRC-OK packet may appear, and
     every kernel of the mode must have launched;
  5. timing: wideband_scan_fused over 8 distinct device-resident noise
     blocks (as bench.py), median Msps per mode; per-kernel time, its
     twin's time, the bound, and for each filterbank one cuDNN
     convolution computing the same y as yardstick;
     then a torch.profiler trace of 8 scan steps per mode: device time
     by kernel and the device's idle share;
  6. the {"kernels": [...]} summary.

The last two lines are the card's name and power limit as nvidia-smi
reports them, then {"ok": true, "device": {...}}. Without a CUDA device
it exits non-zero before printing anything. Any failed check raises.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SCAN_LEN = 131072
MAX_CANDIDATES = 16
NUM_TAPS = 1280
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS = 989e12             # dense tensor-core bf16
FP32_FLOPS = 67e12              # CUDA-core fp32 (also counted for int ops)


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
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
    for mode, name in (("bf16x2w", "filterbank_bf16x2w"),
                       ("f32", "filterbank_polyx_f32")):
        fb_args, tail_args = fused.frontend_operands(
            xi, xq, aa, mask, NUM_TAPS, True, 4, 4, mode, 1.0, dev)
        kern, twin = fused.FILTERBANKS[mode]
        y, y_ref = kern(*fb_args), twin(*fb_args)
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max())
        scale = float(y_ref.abs().max())
        ok = err <= 1e-5 * scale and bool(torch.isfinite(y).all())
        report[name] = {"max_abs_err": err, "max_abs_y": scale, "ok": ok}
        operands[mode] = (fb_args, tail_args, y_ref)
        if not ok:
            raise AssertionError(f"{name} disagrees with its twin: {report[name]}")

    library = filterbank_library_calls(xi, xq, operands)
    for name, mode, tol in (("filterbank_bf16x2w", "bf16x2w", 1e-2),
                            ("filterbank_polyx_f32", "f32", 1e-5)):
        y_ref = operands[mode][2]
        err = float((library[name]() - y_ref).abs().max())
        report[name]["library_max_abs_err"] = err
        if not err <= tol * float(y_ref.abs().max()):
            raise AssertionError(f"the library yardstick of {name} computes "
                                 f"another function: max |dy| {err}")

    tail_err, n_hits = 0.0, 0
    for mode in ("bf16x2w", "f32"):
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

    _, tail_args, y_ref = operands["bf16x2w"]
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
    return report, operands, (bits, pos, whiten, crc, adv), library


def filterbank_library_calls(xi, xq, operands) -> dict:
    """One cuDNN convolution per filterbank computing the same y, timed as
    a yardstick only (the port never calls them):
      filterbank_bf16x2w: the bf16 frames with the (160, 40, width) hi/lo
        weights on tensor cores, then the hi and lo halves summed in f32.
        cuDNN writes the halves in bf16, so the yardstick rounds each half
        to 8 mantissa bits, which K1 does not (checked to 1e-2 of max|y|);
      filterbank_polyx_f32: the f32 frames with the folded (80, 40, width)
        f32 weights (channelizer._fused_kernel) in true FP32."""
    import torch

    from btle_tpu_torch.wideband.channelizer import _fused_kernel, frame_rows, true_fp32

    frames, gk, width, ky = operands["bf16x2w"][0]
    n_chunks, rows, cols = gk.shape
    w_hilo = (gk.reshape(n_chunks, rows, cols // 40, 40).permute(1, 3, 0, 2)
              .reshape(rows, 40, -1)[:, :, :width].contiguous())
    x_bf16 = frames[None]

    def bf16x2w():
        y2 = torch.nn.functional.conv1d(x_bf16, w_hilo)[0]
        return y2[:80].to(torch.float32) + y2[80:].to(torch.float32)

    f_t = frame_rows(xi, xq, NUM_TAPS, True)
    x_f32 = torch.nn.functional.pad(f_t, (0, ky + width - 1 - f_t.shape[1]))[None]
    w_f32 = torch.as_tensor(_fused_kernel(NUM_TAPS, 1.0), device=xi.device)

    def polyx_f32():
        with true_fp32():
            return torch.nn.functional.conv1d(x_f32, w_f32)[0]

    return {"filterbank_bf16x2w": bf16x2w, "filterbank_polyx_f32": polyx_f32}


def run_main_path(dev, mode: str, wi, wq, injected, kernels):
    from btle_tpu_torch.wideband import WidebandConfig, WidebandSniffer

    sn = WidebandSniffer(WidebandConfig(fused=True, fused_dtype=mode,
                                        scan_len_ch=SCAN_LEN,
                                        max_candidates=MAX_CANDIDATES),
                         device=dev)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    pkts = sn.run(wi, wq)
    seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
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
    for name in (needed[mode], "demod_tail", "decode_candidates"):
        if launches[name] <= 0:
            raise AssertionError(f"main path ({mode}) never launched {name}")
    return launches


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


def profile_scan(dev, mode: str, blocks, tables) -> dict:
    """torch.profiler over 8 scan steps: device time per block by kernel
    name, and the device's idle share of the window between the first
    and the last device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step = scan_step(dev, mode, tables)
    for b in blocks[:2]:
        step(*b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in blocks:
            step(*b)
        torch.cuda.synchronize()
    n = len(blocks)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if "CUDA" in str(getattr(e, "device_type", "")))
    if not spans:
        return {"mode": mode, "device_time": "not measured"}
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
    return {"mode": mode, "blocks": n, "device_busy_ms_per_block": busy / 1e3 / n,
            "window_ms_per_block": window / 1e3 / n,
            "idle_share": 1.0 - busy / window, "top": top[:12]}


def bound(nbytes: float, ops: float, rate: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def kernel_device_ms(fn, kernel_name: str, reps: int) -> float:
    """Device time per call of the CUDA kernel named ``kernel_name``, from
    torch.profiler over ``reps`` calls of ``fn`` — the kernel alone,
    without the wrapper's host work. Raises if the profiler saw no device
    time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0.0)
                for e in prof.key_averages() if kernel_name in e.key)
    if total <= 0:
        raise AssertionError(f"the profiler recorded no device time for "
                             f"{kernel_name}")
    return total / 1e3 / reps


def kernel_times(kernel, fn, twin, reps: int, library=None) -> dict:
    """ms: the kernel's device time (profiler); wrapper_ms: CUDA events
    around the wrapper call, host work included; plain_ms: the twin and
    library_ms the library yardstick, CUDA events."""
    return {"ms": kernel_device_ms(fn, f"{kernel.name}_kernel", reps),
            "wrapper_ms": cuda_time_ms(fn, reps),
            "plain_ms": cuda_time_ms(twin, 3, 1),
            "library_ms": None if library is None else cuda_time_ms(library, reps)}


def time_kernels(operands, decode_args, library) -> dict:
    """Per-kernel time, twin time, bound and yardstick at bench geometry."""
    from btle_tpu_torch.rx.decode_kernel import (DECODE_CANDIDATES, decode_candidates,
                                                 decode_candidates_reference)
    from btle_tpu_torch.wideband import fused

    out = {}
    fb, _, _ = operands["bf16x2w"]
    frames, gk, width, ky = fb
    rows = gk.shape[1]
    out["filterbank_bf16x2w"] = {
        **kernel_times(fused.FILTERBANK_BF16X2W,
                       lambda: fused.filterbank_bf16x2w(*fb),
                       lambda: fused.filterbank_bf16x2w_reference(*fb), 10,
                       library=library["filterbank_bf16x2w"]),
        **dict(zip(("bound_ms", "bound_by"), bound(
            frames.numel() * 2 + gk.numel() * 2 + 80 * ky * 4,
            2 * rows * 40 * width * ky, BF16_FLOPS))),
    }
    fb, _, _ = operands["f32"]
    f4, kcoefx, w4x, ky, _ = fb
    rows, n_slices = kcoefx.shape
    out["filterbank_polyx_f32"] = {
        **kernel_times(fused.FILTERBANK_POLYX_F32,
                       lambda: fused.filterbank_polyx_f32(*fb),
                       lambda: fused.filterbank_polyx_f32_reference(*fb), 10,
                       library=library["filterbank_polyx_f32"]),
        **dict(zip(("bound_ms", "bound_by"), bound(
            (f4.numel() + kcoefx.numel() + w4x.numel() + 80 * ky) * 4,
            2 * rows * n_slices * ky + 2 * 80 * rows * ky, FP32_FLOPS))),
    }
    _, tail, y = operands["bf16x2w"]
    n_bits, n_hit = tail[4], tail[5]
    out["demod_tail"] = {
        **kernel_times(fused.DEMOD_TAIL, lambda: fused.demod_tail(y, *tail),
                       lambda: fused.demod_tail_reference(y, *tail), 20),
        # decisions 3 flops per bit; |y_i|+|y_q|, 7 tree adds and a scale
        # per RSSI position; 2 integer ops per AA tap
        **dict(zip(("bound_ms", "bound_by"), bound(
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
        **dict(zip(("bound_ms", "bound_by"), bound(
            m * c * 336 + m * c * 4 + m * 336 + m * 5 + m * c * (42 * 4 + 6),
            m * c * (2 * 336 + 3 * 336), FP32_FLOPS))),
    }
    return out


def main() -> int:
    import torch

    from btle_tpu_torch import _build
    from btle_tpu_torch.rx import decode_kernel
    from btle_tpu_torch.wideband import fused

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    log({"phase": "device", "torch": torch.__version__,
         "cuda": torch.version.cuda, "nvidia_smi": smi,
         "name": torch.cuda.get_device_name(0),
         "count": torch.cuda.device_count()})

    kernels = [fused.FILTERBANK_BF16X2W, fused.FILTERBANK_POLYX_F32,
               fused.DEMOD_TAIL, decode_kernel.DECODE_CANDIDATES]
    t0 = time.perf_counter()
    logs = _build.build([k.name for k in kernels])
    seconds = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, text in logs.items()}
    log({"phase": "build", "seconds": seconds, "ptxas": ptxas})

    report, operands, decode_args, library = check_kernels(dev)
    log({"phase": "kernels_vs_twins", **report})

    from btle_tpu_torch.wideband import fused_selftest

    st = {mode: fused_selftest(compute_dtype=mode, device=dev)
          for mode in ("bf16x2w", "f32")}
    st["xla"] = fused_selftest(pipeline="xla", device=dev)
    log({"phase": "selftest", **{k: {str(c): p for c, p in v.items()}
                                  for k, v in st.items()}})

    plan, n_total = main_path_plan()
    wi, wq, injected = scene(plan, n_total, seed=4)
    launches = {k.name: 0 for k in kernels}
    for mode in ("bf16x2w", "f32"):
        got = run_main_path(dev, mode, wi, wq, injected, kernels)
        for name, n in got.items():
            launches[name] += n
    del wi, wq

    from btle_tpu_torch.wideband.sniffer import default_scan_tables

    tables = default_scan_tables(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    n_wb = block_samples() + NUM_TAPS - 1
    blocks = [tuple(30.0 * torch.randn(n_wb, generator=gen, device=dev)
                    for _ in range(2)) for _ in range(8)]
    scans = {mode: time_scan(dev, mode, blocks, tables)
             for mode in ("bf16x2w", "f32")}
    per_kernel = time_kernels(operands, decode_args, library)
    log({"phase": "timing", "scan": scans, "kernels": per_kernel})
    for mode in ("bf16x2w", "f32"):
        log({"phase": "profile", **profile_scan(dev, mode, blocks, tables)})
    del blocks

    log({"kernels": [{
        "name": k.name, "route": "cuda", "source": k.source,
        "replaces": k.replaces, "launches": launches[k.name],
        "max_abs_err": report[k.name]["max_abs_err"],
        **per_kernel[k.name]} for k in kernels]})
    print(smi, flush=True)
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
