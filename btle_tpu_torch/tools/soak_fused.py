"""Dense-traffic soak of the fused wideband pipeline on the card.

Port of tools/soak_fused_tpu.py. It synthesizes a sustained airspace —
packets with known payloads spread over all 40 channels and the whole
capture, optionally with up to 12 followed connections (CONNECT_REQs,
data before and after a simultaneous hop, LL_CHANNEL_MAP_REQs) — through
the shipped TX composition (``tx.synth.scene_to_wideband``), streams it
block by block through ``WidebandSniffer`` and checks, as the tool does:

  * every injected packet decodes CRC-OK and byte-exact on its channel;
  * with connections, every connection registers and stale-drops;
  * with map updates, every connection applies its channel map.

It also counts ghosts: CRC-OK (channel, PDU) pairs never injected (the
tool's "+N extra" also counts an injected packet decoded twice; those are
``duplicates`` here). The scene is built line for line as the tool builds
it, on the port's own descriptor parser, synthesizer and CSA#1.

Usage: python -m btle_tpu_torch.tools.soak_fused [--seconds 0.25]
       [--packets 150] [--phy 1m|2m] [--dtype bf16x2w|f32|xla] [--seed 0]
       [--cutoff MHZ] [--connections N [--map-updates]] [--device cuda|cpu]
Exit code 0 and "RESULT: PASS" when every packet decoded byte-exact and
every connection did what the flags ask.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

CONN_QUIET_WB = 70_000 * 80   # all connections dropped by ~65 ms of air


def make_scene(seconds: float = 0.25, packets: int = 150, phy: str = "1m",
               seed: int = 0, connections: int = 0, map_updates: bool = False):
    """The tool's airspace: (wi, wq, injected [(channel, offset_wb, pdu
    bytes)], placed background packets, n_wb)."""
    from ..spec import bits as B
    from ..spec.channels import csa1_channel
    from ..tx import parse_descriptor_sequence
    from ..tx.synth import burst_num_samples, scene_to_wideband

    if not 0 <= connections <= 12:
        raise ValueError("connections must be 0..12 (distinct hop values)")
    if map_updates and not connections:
        raise ValueError("map_updates needs connections")
    rng = np.random.default_rng(seed)
    n_wb = int(seconds * 80_000_000)
    if connections and n_wb < 29000 * 80:
        n_wb = 29000 * 80   # the connection schedule spans ~26 ms of air

    placed_specs = []    # (PacketSpec, offset_wb)
    injected = []        # (channel, offset_wb, pdu_bytes)
    per_ch_next = {}
    # connection phase: CONNECT_REQs in the first block, a sync packet per
    # connection on its first hop channel at ~8.3 ms, then — after every
    # connection hops at the 22528 us block tick — a second packet on its
    # new channel; background traffic stays off the channels a live
    # connection can own (its first four dwells, and their CSA#1 remaps
    # under a map update) until every connection has dropped
    hops = [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16][:connections]
    conn_channels = {(k * h) % 37 for h in hops for k in (1, 2, 3, 4)}
    if map_updates:
        for h in hops:
            masked = (2 * h) % 37
            used = tuple(c for c in range(37) if c != masked)
            conn_channels |= {csa1_channel((k * h) % 37, used) for k in (2, 3, 4)}
    if connections:
        for ch in (37, 38, 39):
            per_ch_next[ch] = (200 + (connections // 3 + 1) * 450 + 600) * 80
        for j, hop in enumerate(hops):
            aa = 0x53A00000 + j * 0x01103
            crc = f"{0x111111 + j * 0x030201:06x}"
            adv_ch = [37, 38, 39][j % 3]
            cr = (f"{adv_ch}-CONNECT_REQ-TxAdd-0-RxAdd-0"
                  f"-InitA-001830EA965F-AdvA-90D7EBB192{j:02X}"
                  f"-AA-{aa:08X}-CRCInit-{crc.upper()}-WinSize-02"
                  f"-WinOffset-000F-Interval-0010-Latency-0000"
                  f"-Timeout-07D0-ChM-1FFFFFFFFF-Hop-{hop}-SCA-5-Space-1")
            descs = [cr]
            times_us = [200 + (j // 3) * 450]
            dwell2_ch = (2 * hop) % 37
            if map_updates:
                # mask the dwell-2 channel at instant 1: the hop at ~22.5
                # ms applies the map, so dwell 2 lands on its CSA#1 remap
                masked = dwell2_ch
                onair = ((1 << 37) - 1) & ~(1 << masked)
                chm_disp = onair.to_bytes(5, "little")[::-1].hex().upper()
                used = tuple(c for c in range(37) if c != masked)
                dwell2_ch = csa1_channel((2 * hop) % 37, used)
                descs.append(
                    f"{hop % 37}-LL_CHANNEL_MAP_REQ-AA-{aa:08X}-LLID-3"
                    f"-NESN-0-SN-0-MD-0-ChM-{chm_disp}-Instant-0001"
                    f"-CRCInit-{crc.upper()}-Space-1")
                times_us.append(15000 + j * 50)
            for ch, t_us in ((hop % 37, 8300 + j * 50), (dwell2_ch, 24700 + j * 50)):
                payload = rng.integers(0, 256, 6 + j, dtype=np.uint8)
                descs.append(
                    f"{ch}-LL_DATA-AA-{aa:08X}-LLID-1-NESN-0-SN-0-MD-0"
                    f"-DATA-{bytes(payload).hex()}-CRCInit-{crc.upper()}"
                    f"-Space-1")
                times_us.append(t_us)
            specs, _ = parse_descriptor_sequence(descs)
            if phy == "2m":
                specs = [s.to_2m() for s in specs]
            for spec, t_us in zip(specs, times_us):
                placed_specs.append((spec, t_us * 80))
                injected.append((spec.channel, t_us * 80, bytes(
                    B.bits_to_bytes(spec.info_bits[spec.pdu_start:]))))

    placed = attempts = 0
    while placed < packets and attempts < packets * 40:
        attempts += 1
        ch = int(rng.integers(0, 40))
        if ch in (37, 38, 39):
            n_payload = int(rng.integers(6, 38))
            payload = rng.integers(0, 256, n_payload, dtype=np.uint8)
            desc = (f"{ch}-ADV_NONCONN_IND-TxAdd-0-RxAdd-0"
                    f"-AdvA-{bytes(payload[:6]).hex()}"
                    f"-AdvData-{bytes(payload[6:]).hex()}-Space-1")
        else:
            n_payload = int(rng.integers(1, 32))
            payload = rng.integers(0, 256, n_payload, dtype=np.uint8)
            desc = (f"{ch}-LL_DATA-AA-8E89BED6-LLID-1-NESN-0-SN-0-MD-0"
                    f"-DATA-{bytes(payload).hex()}-CRCInit-555555-Space-1")
        (spec,), _ = parse_descriptor_sequence([desc])
        if phy == "2m":
            spec = spec.to_2m()
        span_wb = burst_num_samples(spec) + 80_000
        off = int(rng.integers(0, max(1, n_wb - span_wb)))
        lo = per_ch_next.get(ch, 0)
        if ch in conn_channels and off < CONN_QUIET_WB:
            lo = max(lo, CONN_QUIET_WB)   # wait out the live connections
        if off < lo:
            off = lo
        if off + span_wb >= n_wb:
            continue
        per_ch_next[ch] = off + span_wb
        placed_specs.append((spec, off))
        injected.append((ch, off, bytes(
            B.bits_to_bytes(spec.info_bits[spec.pdu_start:]))))
        placed += 1
    # light noise floor so ties are not degenerate zeros
    wi, wq = scene_to_wideband(placed_specs, n_wb, noise_std=0.01, seed=seed)
    return wi, wq, injected, placed, n_wb


def sniffer_config(phy: str = "1m", dtype: str = "bf16x2w", cutoff=None,
                   connections: int = 0):
    """The tool's WidebandConfig ("xla" is the plain path)."""
    from ..wideband import WidebandConfig

    return WidebandConfig(phy=phy, fused=dtype != "xla", cutoff_mhz=cutoff,
                          fused_dtype=dtype if dtype != "xla" else "f32",
                          follow_connections=connections > 0,
                          max_follow=max(1, connections),
                          # bounded wander: stale connections unregister ~2
                          # intervals after their last packet
                          drop_after_intervals=2 if connections else None)


def run(device=None, seconds: float = 0.25, packets: int = 150, phy: str = "1m",
        dtype: str = "bf16x2w", seed: int = 0, cutoff=None, connections: int = 0,
        map_updates: bool = False) -> dict:
    """Synthesize, sniff and check (see the module docstring). Returns the
    counts, the missing packets, the connection tallies, the sniffer's
    packets and follower events, and "ok"."""
    from ..wideband import WidebandSniffer

    if dtype not in ("bf16x2w", "f32", "xla"):
        raise ValueError(f"dtype must be bf16x2w, f32 or xla, not {dtype!r}")
    t0 = time.perf_counter()
    wi, wq, injected, placed, n_wb = make_scene(seconds, packets, phy, seed,
                                                connections, map_updates)
    synth_s = time.perf_counter() - t0
    sn = WidebandSniffer(sniffer_config(phy, dtype, cutoff, connections), device=device)
    t0 = time.perf_counter()
    pkts = sn.run(wi, wq)
    sniff_s = time.perf_counter() - t0
    got = {}
    for p in pkts:
        if p.crc_ok:
            got.setdefault((p.channel, bytes(p.pdu_bytes)), []).append(p.sample_pos)
    want = {(ch, pdu) for ch, _, pdu in injected}
    missing = [(ch, off, pdu.hex()) for ch, off, pdu in injected if (ch, pdu) not in got]
    ghosts = sorted((ch, pdu.hex()) for ch, pdu in got if (ch, pdu) not in want)
    duplicates = sum(len(v) - 1 for k, v in got.items() if k in want)
    conn, conn_ok = {}, True
    if connections:
        evts = sn.multi_follower.events
        conn = {kind: len({e.access_addr for e in evts if e.event == kind})
                for kind in ("track_start", "track_drop", "chm_update")}
        conn["still_tracked"] = len(sn.multi_follower.connections)
        conn_ok = conn["track_start"] == conn["track_drop"] == connections
        if map_updates:
            conn_ok &= conn["chm_update"] == connections
    res = {"phy": phy, "dtype": dtype, "seconds_air": n_wb / 80e6,
           "background_packets": placed, "injected": len(injected),
           "decoded": len(injected) - len(missing), "missing": missing,
           "ghosts": ghosts, "duplicates": duplicates, "connections": conn,
           "truncate_rescans": sn.truncated_channels, "synth_s": synth_s,
           "sniff_s": sniff_s, "connections_ok": conn_ok,
           "ok": not missing and conn_ok, "packets": pkts,
           "events": sn.multi_follower.events if sn.multi_follower else []}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=0.25,
                    help="airspace duration (80 Msps wideband)")
    ap.add_argument("--packets", type=int, default=150)
    ap.add_argument("--phy", default="1m", choices=["1m", "2m"])
    ap.add_argument("--dtype", default="bf16x2w", choices=["bf16x2w", "f32", "xla"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cutoff", type=float, default=None,
                    help="channel-filter cutoff MHz (default: per phy)")
    ap.add_argument("--connections", type=int, default=0,
                    help="also follow N concurrent connections (<= 12)")
    ap.add_argument("--map-updates", action="store_true",
                    help="with --connections: each connection also airs an "
                         "LL_CHANNEL_MAP_REQ masking its dwell-2 channel")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not 0 <= args.connections <= 12:
        ap.error("--connections must be 0..12 (distinct hop values)")
    if args.map_updates and not args.connections:
        ap.error("--map-updates needs --connections")
    res = run(args.device, args.seconds, args.packets, args.phy, args.dtype,
              args.seed, args.cutoff, args.connections, args.map_updates)
    n_inj, conn = res["injected"], res["connections"]
    print(f"synthesized {res['background_packets']} background packets + "
          f"{n_inj - res['background_packets']} connection packets over "
          f"{res['seconds_air']:.3f}s of air ({res['synth_s']:.1f}s)", flush=True)
    if args.connections:
        print(f"connections: {conn['track_start']}/{args.connections} registered, "
              f"{conn['track_drop']} stale-dropped, {conn['still_tracked']} still "
              f"tracked, {conn['chm_update']} map-updated", flush=True)
    print(f"decoded {res['decoded']}/{n_inj} injected packets, {len(res['ghosts'])} "
          f"ghosts, {res['duplicates']} duplicates in {res['sniff_s']:.1f}s host "
          f"wall-clock", flush=True)
    if res["truncate_rescans"]:
        print(f"note: {res['truncate_rescans']} slot-exhaustion rescans", flush=True)
    for m in res["missing"][:10]:
        print("MISSING", m, flush=True)
    for g in res["ghosts"][:10]:
        print("GHOST", g, flush=True)
    print("RESULT:", "PASS" if res["ok"] else
          f"FAIL ({len(res['missing'])} missing"
          + ("" if res["connections_ok"] else ", connection tracking incomplete") + ")",
          flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
