"""Live-chain benchmark: paced wire ingest -> ring -> pipelined scans.

Port of tools/bench_live_tpu.py. It measures the deployed live loop
(``runtime.IqRingBuffer`` + ``WidebandStreamRunner.run_live``) on the
card: a producer thread writes int16 IQ into the native ring at
``rate`` Msps (0: unpaced, as fast as the ring takes it) while the live
loop consumes, scans and walks the blocks. The producer cycles through a
scene of 8 blocks of territory with 24 packets (ADV_NONCONN_IND on
37/38/39, LL data elsewhere, 12-byte payloads), built as the JAX tool
builds it and cached per (block size, PHY) within a process.

It reports the consumer's sustained Msps, the producer's achieved Msps
(so a drop can be put on the side that fell behind), ring drops, blocks,
packets, CRC-OK packets, truncate-rescans, the wall and air ms per block,
CRC-OK packets that are not in the scene (``ghosts``; there must be
none) and the JAX tool's verdict: "PASS (keeps up live)" when the ring
dropped nothing and the loop sustained 99% of min(rate or 80, 80) Msps,
else "BELOW WIRE RATE".

Usage: python -m btle_tpu_torch.tools.bench_live [--rate 80] [--seconds 20]
       [--phy 1m|2m] [--pipeline 2] [--block 131072] [--dtype bf16x2w]
       [--xla] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import threading
import time
from functools import lru_cache

import numpy as np

from ..wideband.stream import WidebandStreamRunner

N_SCENE_BLOCKS = 8
N_PACKETS = 24
RING_PAIRS = 1 << 25
CHUNK_PAIRS = 1 << 20


@lru_cache(maxsize=2)
def scene(block: int, phy: str = "1m"):
    """The producer's scene for ``block`` channel samples a block:
    (interleaved int16 IQ of 8 blocks of territory, read-only, and the
    frozenset of its (channel, PDU bytes))."""
    from ..spec import bits as B
    from ..tx import parse_descriptor
    from ..tx.synth import scene_to_wideband

    n_scene = N_SCENE_BLOCKS * block * 20
    rng = np.random.default_rng(5)
    placed, packets = [], set()
    step = n_scene // N_PACKETS
    for k in range(N_PACKETS):
        ch = int(rng.integers(0, 40))
        payload = rng.integers(0, 256, 12, dtype=np.uint8)
        if ch in (37, 38, 39):
            d = (f"{ch}-ADV_NONCONN_IND-TxAdd-0-RxAdd-0"
                 f"-AdvA-{bytes(payload[:6]).hex()}"
                 f"-AdvData-{bytes(payload[6:]).hex()}-Space-1")
        else:
            d = (f"{ch}-LL_DATA-AA-8E89BED6-LLID-1-NESN-0-SN-0-MD-0"
                 f"-DATA-{bytes(payload).hex()}-CRCInit-555555-Space-1")
        spec = parse_descriptor(d)
        if phy == "2m":
            spec = spec.to_2m()
        placed.append((spec, 20_000 + step * k))
        packets.add((ch, bytes(B.bits_to_bytes(spec.info_bits[spec.pdu_start:]))))
    wi, wq = scene_to_wideband(placed, n_scene, noise_std=2.0, seed=5)
    inter = np.empty(2 * n_scene, np.int16)
    inter[0::2] = np.clip(np.round(wi), -32768, 32767)
    inter[1::2] = np.clip(np.round(wq), -32768, 32767)
    inter.flags.writeable = False
    return inter, frozenset(packets)


class _Producer(threading.Thread):
    """Cycles the scene into the ring in CHUNK_PAIRS writes, paced at
    ``rate`` Msps (0: unpaced) until stopped."""

    def __init__(self, ring, inter: np.ndarray, rate: float):
        super().__init__(daemon=True)
        self.ring, self.inter, self.rate = ring, inter, rate
        self.pairs, self.seconds = 0, 0.0
        self.stop_event = threading.Event()

    def run(self):
        n_scene = len(self.inter) // 2
        t0 = time.perf_counter()
        off = 0
        while not self.stop_event.is_set():
            if self.rate > 0 and self.pairs > (time.perf_counter() - t0) * self.rate * 1e6:
                time.sleep(0.002)
                continue
            end = min(off + CHUNK_PAIRS, n_scene)
            self.ring.write(self.inter[2 * off: 2 * end], "i16")
            self.pairs += end - off
            off = end % n_scene
        self.seconds = time.perf_counter() - t0


class RecordingRunner(WidebandStreamRunner):
    """The live runner, keeping each CRC-OK packet's (channel, PDU)."""

    def __init__(self, sn):
        super().__init__(sn)
        self.crc_ok_packets = []

    def consume(self, handle):
        pkts = super().consume(handle)
        self.crc_ok_packets += [(p.channel, bytes(p.pdu_bytes)) for p in pkts if p.crc_ok]
        return pkts


def run(device=None, rate: float = 80.0, seconds: float = 20.0, phy: str = "1m",
        pipeline: int = 2, block: int = 131072, dtype: str = "bf16x2w",
        xla: bool = False) -> dict:
    """Self-test, warm, then ``seconds`` of the live loop against the
    producer (see the module docstring). Returns the measurements."""
    from .. import runtime
    from ..wideband import WidebandConfig, WidebandSniffer

    if not runtime.available():
        raise RuntimeError("bench_live: the native runtime (g++) is required")
    cfg = WidebandConfig(scan_len_ch=block, fused=not xla, fused_dtype=dtype, phy=phy)
    sn = WidebandSniffer(cfg, device=device)
    selftest = sn.selftest()
    t0 = time.perf_counter()
    inter, want = scene(block, phy)
    scene_s = time.perf_counter() - t0
    # warm the scan with the dtype the ring path dispatches (int16)
    warm = np.zeros(sn.wb_block_len, np.int16)
    sn.process(warm, warm)
    ring = runtime.IqRingBuffer(RING_PAIRS)
    runner = RecordingRunner(sn)
    producer = _Producer(ring, inter, rate)
    deadline = time.monotonic() + seconds
    try:
        producer.start()
        stats = runner.run_live(ring, should_stop=lambda: time.monotonic() >= deadline,
                                pipeline=pipeline, scale=1.0)
    finally:
        producer.stop_event.set()
        producer.join(timeout=10)
        ring.close()
    if producer.is_alive():
        raise RuntimeError("bench_live: the producer thread did not stop")
    ghosts = sorted({(ch, pdu.hex()) for ch, pdu in runner.crc_ok_packets
                     if (ch, pdu) not in want})
    verdict = (stats.dropped_pairs == 0
               and stats.msps >= min(rate if rate > 0 else 80, 80) * 0.99)
    res = {"phy": phy, "dtype": "xla" if xla else dtype, "block": block,
           "pipeline": pipeline, "rate_msps": rate, "seconds": seconds,
           "selftest": {str(k): v for k, v in selftest.items()},
           "scene_s": scene_s, "blocks": stats.blocks, "packets": stats.packets,
           "crc_ok": stats.crc_ok, "scene_packets_decoded": len(
               {k for k in runner.crc_ok_packets if k in want}),
           "ghosts": ghosts, "truncate_rescans": stats.truncate_rescans,
           "consumed_msamples": stats.samples_wb / 1e6, "wall_s": stats.wall_s,
           "msps": stats.msps, "x_wire_rate": stats.msps / 80,
           "producer_msps": producer.pairs / producer.seconds / 1e6
           if producer.seconds else 0.0,
           "ms_per_block": 1e3 * stats.wall_s / max(1, stats.blocks),
           "air_ms_per_block": block / 4000.0, "ring_drops": stats.dropped_pairs,
           "verdict": "PASS (keeps up live)" if verdict else "BELOW WIRE RATE"}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rate", type=float, default=80.0,
                    help="producer wire rate in Msps (0 = unpaced)")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--phy", default="1m", choices=["1m", "2m"])
    ap.add_argument("--pipeline", type=int, default=2)
    ap.add_argument("--block", type=int, default=131072,
                    help="scan_len_ch (channel samples per block)")
    ap.add_argument("--dtype", default="bf16x2w")
    ap.add_argument("--xla", action="store_true",
                    help="the plain path instead of the fused kernels")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = run(args.device, args.rate, args.seconds, args.phy, args.pipeline,
              args.block, args.dtype, args.xla)
    print(f"phy={res['phy']} dtype={res['dtype']} block={res['block']} "
          f"pipeline={res['pipeline']} rate={res['rate_msps']}Msps", flush=True)
    print(f"blocks={res['blocks']} packets={res['packets']} (crc_ok={res['crc_ok']}) "
          f"truncate_rescans={res['truncate_rescans']} ghosts={len(res['ghosts'])}",
          flush=True)
    print(f"consumed {res['consumed_msamples']:.1f} Ms in {res['wall_s']:.2f} s = "
          f"{res['msps']:.1f} Msps sustained ({res['x_wire_rate']:.2f}x the 80 Msps "
          f"wire rate); producer {res['producer_msps']:.1f} Msps", flush=True)
    print(f"per-block wall {res['ms_per_block']:.3f} ms vs "
          f"{res['air_ms_per_block']:.3f} ms air; ring drops {res['ring_drops']}",
          flush=True)
    print("RESULT:", res["verdict"], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
