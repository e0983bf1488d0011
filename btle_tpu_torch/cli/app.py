"""btle_tpu_torch command-line interface.

The port's tool-layer surface, wired to IQ capture files, stdin streams
and live UDP ingest (the ``btle_tpu`` CLI's counterpart; its tui,
send-cmd and mcp subcommands are not ported yet):

  decode    sniff one channel from an IQ file/stdin (btle_rx equivalent;
            --phy coded8|coded2 decodes LE Coded captures)
  wideband  40-channel wideband sniff of an 80 Msps capture or live stream
            (--phy coded8|coded2: LE Coded airspace, finite captures;
            --ltk decrypts followed connections)
  tx        synthesize packet descriptors to IQ files / UDP (btle_tx
            equivalent; the fixed-point modulator runs on the device)
  scan      decode + aggregate into a device table
  analyze   summarize / plot a pcap
  iq-show   waterfall spectrogram + occupancy summary of an IQ capture
  recon     quickscan | profile | diff | entropy | gatt on a pcap
  ber       BER sweep (test_btle_ber equivalent)

The scans run on the CUDA card unless ``--device`` names another device
(``--device cpu`` runs the plain PyTorch path); analyze, iq-show, recon
and the decryption are host-side, as in the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _add_rx_args(p):
    p.add_argument("--bin", required=True, help="IQ capture file")
    p.add_argument("--format", default="i16", choices=["i8", "i16", "f32", "csv"],
                   help="sample format (i8=HackRF, i16=firmware, f32=usrp, csv=Vivado ILA)")
    p.add_argument("--channel", type=int, default=37)
    p.add_argument("--sps", type=int, default=4, help="samples per symbol")
    p.add_argument("--phy", default="1m",
                   choices=["1m", "2m", "coded8", "coded2"],
                   help="LE PHY of the capture (2m = BLE 5 LE 2M: a "
                        "--sps 4 capture is then 8 Msps; coded8/coded2 "
                        "= BLE 5 LE Coded S=8/S=2 at 1 Msym/s — "
                        "coded-AA sync + soft Viterbi, rx/coded.py)")
    p.add_argument("--access-addr", default=None, help="hex access address (display order)")
    p.add_argument("--crc-init", default="555555", help="hex CRC init (display order)")
    p.add_argument("--access-mask", default=None, help="hex care-mask for AA bits")
    p.add_argument("--filter-adva", default=None, help="AdvA MAC filter")
    p.add_argument("--filter-pdu", default=None, help="CSV of allowed ADV PDU types")
    p.add_argument("--hop", action="store_true", help="follow CONNECT_REQ hops")
    p.add_argument("--raw", action="store_true", help="raw 42-byte dumps per AA hit")
    p.add_argument("--rssi", action="store_true", help="estimate RSSI")
    p.add_argument("--verbose", "-v", action="store_true",
                   help="also report rejected/bad-header hits")
    p.add_argument("--json", action="store_true", help="NDJSON events on stdout")
    p.add_argument("--quiet-text", action="store_true")
    p.add_argument("--pcap", default=None, help="write packets to pcap ('-' = stdout for wireshark)")
    p.add_argument("--scan-len", type=int, default=None,
                   help="block territory in samples (default 8192 live / 131072 file)")
    p.add_argument("--control-port", type=int, default=None,
                   help="UDP port for live retune commands (0 = pick a free port)")
    p.add_argument("--rotate", default=None, metavar="CH,CH,...",
                   help="dwell-rotate through these ADV channels "
                        "(reference scan's 37,38,39 rotation)")
    p.add_argument("--dwell-ms", type=int, default=200,
                   help="dwell per channel when rotating (stream time)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the scan (default cuda; cpu runs "
                        "the plain PyTorch path)")


def _build_sniffer(args):
    from ..spec.bits import mac_str_to_bytes
    from ..stream import NdjsonEmitter, PcapWriter, Sniffer, SnifferConfig

    pdu_mask = 0xFFFF
    if args.filter_pdu:
        pdu_mask = 0
        for v in args.filter_pdu.split(","):
            pdu_mask |= 1 << int(v)
    aa = int(args.access_addr, 16) if args.access_addr else 0x8E89BED6
    if args.scan_len is not None:
        scan_len = args.scan_len
    else:
        # files benefit from large blocks (fewer dispatches); stdin streams
        # keep the reference's ~2 ms granularity for latency
        scan_len = 8192 if args.bin == "-" else 131072
    cfg = SnifferConfig(
        scan_len=scan_len,
        channel=args.channel,
        access_addr=aa,
        crc_init=int(args.crc_init, 16),
        sps=args.sps,
        access_mask_hex=args.access_mask,
        filter_adva=bytes(mac_str_to_bytes(args.filter_adva)) if args.filter_adva else None,
        filter_pdu_mask=pdu_mask,
        hop=args.hop,
        raw=args.raw,
        rssi=args.rssi,
        verbose=args.verbose,
        rotate_channels=(tuple(int(c) for c in args.rotate.split(","))
                         if args.rotate else ()),
        dwell_ms=args.dwell_ms,
        phy=args.phy,
    )
    if args.pcap == "-" and args.json:
        raise SystemExit("decode: --json and --pcap - both write stdout; "
                         "pick one (or write the pcap to a file)")
    pcap = None
    if args.pcap:
        # "-" streams pcap to stdout for `wireshark -k -i -` (the
        # reference's ble_fpga_ctl live-wireshark pattern)
        pcap = PcapWriter(sys.stdout.buffer if args.pcap == "-" else args.pcap)
    control = None
    if args.control_port is not None:
        from ..stream.control import ControlServer

        control = ControlServer(args.control_port)
        print(f"# control channel listening on udp:{control.port}",
              file=sys.stderr)
    return Sniffer(
        cfg,
        ndjson=NdjsonEmitter() if args.json else None,
        pcap=pcap,
        quiet_text=args.quiet_text or args.json or args.pcap == "-",
        control=control,
        device=args.device,
    )


def cmd_decode(args):
    from ..stream import iq_file_source, stdin_source

    if args.phy in ("coded8", "coded2"):
        return _cmd_decode_coded(args)
    sniffer = _build_sniffer(args)
    if args.bin == "-":
        if args.format == "csv":
            raise SystemExit("decode: --format csv cannot read from stdin")
        src = stdin_source(args.format)
    elif args.format == "csv":
        from ..stream.sources import ila_csv_source

        src = ila_csv_source(args.bin)
    else:
        src = iq_file_source(args.bin, args.format)
    try:
        events = sniffer.run(src)
    except KeyboardInterrupt:
        # flush outputs on ctrl-C like the reference's signal handlers
        events = sniffer.packets
    finally:
        if sniffer.pcap:
            sniffer.pcap.close()
    ok = sum(1 for e in events if e.crc_ok)
    print(f"# {len(events)} packets ({ok} CRC OK)", file=sys.stderr)
    return 0


def _read_iq(path: str, fmt: str):
    """A whole interleaved-IQ file -> (i, q) float32."""
    if fmt not in ("i8", "i16", "f32"):
        raise SystemExit(f"--format {fmt} is not supported for a coded PHY")
    data = np.fromfile(path, dtype={"i8": np.int8, "i16": np.int16,
                                    "f32": np.float32}[fmt])
    return data[0::2].astype(np.float32), data[1::2].astype(np.float32)


def _cmd_decode_coded(args):
    """LE Coded capture decode: coded-AA sync + soft Viterbi over the
    whole capture (beyond-reference; rx/coded.py)."""
    from ..rx.coded import decode_coded
    from ..stream.pcap import PcapWriter

    if args.bin == "-":
        raise SystemExit("decode: coded PHY needs a seekable --bin file")
    i, q = _read_iq(args.bin, args.format)
    aa_hex = args.access_addr or "d6be898e"
    pkts = decode_coded(i, q, args.channel, sps=args.sps,
                        access_address_hex=aa_hex,
                        crc_init_hex=args.crc_init, max_candidates=8,
                        device=args.device)
    pcap = PcapWriter(args.pcap) if args.pcap else None
    emitter = None
    if args.json:
        from ..stream import NdjsonEmitter

        emitter = NdjsonEmitter()
    for k, p in enumerate(pkts):
        if emitter is None:
            print(f"ch{args.channel:02d} pos{p['pos']} "
                  f"crc{'0' if p['crc_ok'] else '1'} S={p['s']} "
                  f"plen{p['payload_len']} aa_agree{p['aa_agree']} "
                  + bytes(p["pdu_bytes"]).hex())
        else:
            _emit_coded(emitter, k + 1, args.channel, int(aa_hex, 16), p)
        if pcap and p["crc_ok"]:
            pcap.write_packet(bytes(p["pdu_bytes"]), args.channel,
                              int(aa_hex, 16))
    if pcap:
        pcap.close()
    ok = sum(1 for p in pkts if p["crc_ok"])
    print(f"# {len(pkts)} coded candidates ({ok} CRC OK)", file=sys.stderr)
    return 0


def _emit_coded(emitter, pkt: int, channel: int, aa: int, p: dict) -> None:
    """One coded packet as an NDJSON pkt event (the schema every decode
    surface speaks); a header that does not parse emits nothing."""
    from ..ll.pdu import (extract_adv_a, parse_adv_header, parse_adv_payload,
                          parse_ll_header)

    pdu = bytes(p["pdu_bytes"])
    ts = time.time()
    try:
        if channel in (37, 38, 39):
            hdr = parse_adv_header(pdu[:2])
            try:
                adv_a = extract_adv_a(parse_adv_payload(pdu[2:], hdr.pdu_type),
                                      hdr.pdu_type)
            except ValueError:
                adv_a = None
            emitter.pkt_adv(ts, pkt, channel, aa, p["crc_ok"],
                            int(hdr.pdu_type), hdr.pdu_type.display_name,
                            hdr.tx_add, hdr.rx_add, hdr.payload_len, adv_a,
                            pdu[2:], None)
        else:
            hdr = parse_ll_header(pdu[:2])
            emitter.pkt_data(ts, pkt, channel, aa, p["crc_ok"],
                             int(hdr.llid), hdr.llid.display_name, hdr.nesn,
                             hdr.sn, hdr.md, hdr.payload_len, pdu[2:], None)
    except ValueError:
        pass


def cmd_wideband(args):
    from ..stream import NdjsonEmitter
    from ..stream.pcap import PcapWriter
    from ..wideband import WidebandConfig, WidebandSniffer
    from ..wideband.stream import WidebandStreamRunner

    if args.phy in ("coded8", "coded2"):
        return _cmd_wideband_coded(args)
    cfg = WidebandConfig(follow_connections=args.follow or args.max_follow > 1,
                         max_follow=args.max_follow, fused=args.fused,
                         fused_dtype=args.fused_dtype, phy=args.phy)
    sn = WidebandSniffer(cfg, device=args.device)
    selftest = args.selftest
    if selftest is None:
        # the fused kernels on a card are gated by the known-answer test by
        # default; --no-selftest skips it
        selftest = cfg.fused and sn.device.type == "cuda"
    if selftest:
        # known-answer test on this device of exactly the pipeline and
        # kernel configuration the scan below deploys (a kernel can build,
        # run and decode nothing)
        positions = sn.selftest()
        mode = (f"fused {cfg.fused_dtype}" if cfg.fused else "xla") + (
            "" if cfg.phy == "1m" else f" {cfg.phy}")
        print(f"# self-test OK ({mode}): decoded "
              f"{sorted(positions)} at {positions}", file=sys.stderr)

    # --json owns stdout (schema v1, the ABI decode --json speaks too); the
    # text lines move behind it. pcap composes with either.
    ndjson = NdjsonEmitter() if args.json else None
    pcap = PcapWriter(args.pcap) if args.pcap else None
    runner = WidebandStreamRunner(sn, ndjson=ndjson, pcap=pcap,
                                  text_fh=None if args.json else sys.stdout,
                                  ltk=bytes.fromhex(args.ltk) if args.ltk else None)
    runner.start()
    if args.live:
        _wideband_live(args, runner)
    else:
        if not args.bin:
            raise SystemExit("wideband: --bin FILE or --live --udp PORT")
        data = np.fromfile(args.bin, dtype={"i8": np.int8, "i16": np.int16,
                                            "f32": np.float32}[args.format])
        runner.run_capture(data[0::2].astype(np.float32),
                           data[1::2].astype(np.float32))
    runner.stop()
    if pcap:
        pcap.close()
    st = runner.stats
    print(f"# {st.packets} packets ({st.crc_ok} CRC OK) in {st.blocks} "
          f"blocks; {st.samples_wb/1e6:.1f} Ms consumed in {st.wall_s:.2f} s "
          f"({st.msps:.0f} Msps)"
          + (f"; {st.dropped_pairs} ring drops" if args.live else ""),
          file=sys.stderr)
    for ev in runner.follow_events():
        print(f"# {ev.event} aa=0x{ev.access_addr:08x} ch={ev.channel} "
              f"interval={ev.interval_us}us hop={ev.hop} t={ev.time_us}us",
              file=sys.stderr)
    if args.follow and sn.connection is not None:
        c = sn.connection
        print(f"# followed connection AA {c.access_addr:08x} "
              f"crcInit {c.crc_init:06x} hop {c.hop} interval {c.interval}",
              file=sys.stderr)
    return 0


def _wideband_live(args, runner):
    """Unbounded live ingest: UDP datagrams -> native SPSC ring ->
    overlap-save wideband blocks, the reference's main receive loop
    (btle_rx.c:2610-2676) scaled to all 40 channels at once."""
    import signal

    from .. import runtime

    if not runtime.available():
        raise SystemExit("wideband --live needs the native runtime "
                         "(g++ build failed?)")
    sn = runner.sn
    # ring capacity: >= 8 blocks of territory+halo so a slow consumer
    # degrades to drops (counted + reported), never to blocking the
    # producer thread
    need = 8 * sn.wb_block_len
    ring = runtime.IqRingBuffer(1 << max(22, (need - 1).bit_length()))
    ingest = runtime.UdpIngest(ring, args.udp, fmt=args.format)
    control = None
    if args.control_port:
        from ..stream.control import ControlServer

        control = ControlServer(args.control_port)
    stop_flag = {"stop": False}

    def on_sigint(sig, frame):
        stop_flag["stop"] = True

    prev = signal.signal(signal.SIGINT, on_sigint)
    deadline = (time.monotonic() + args.seconds) if args.seconds else None

    def should_stop():
        return stop_flag["stop"] or (
            deadline is not None and time.monotonic() >= deadline)

    print(f"# live: UDP port {args.udp} fmt {args.format} "
          f"block {sn.cfg.scan_len_ch} ch-samples "
          f"(~{sn.cfg.scan_len_ch/4000:.1f} ms air) pipeline depth "
          f"{args.pipeline}", file=sys.stderr)
    try:
        runner.run_live(ring, should_stop=should_stop,
                        pipeline=args.pipeline, control=control)
    finally:
        signal.signal(signal.SIGINT, prev)
        ingest.stop()
        if control is not None:
            control.close()
        ring.close()


def _cmd_wideband_coded(args):
    """All 40 channels of LE Coded airspace from one 80 Msps capture
    (wideband/coded.py; beyond-reference). Finite captures only —
    follow/live semantics are uncoded-PHY features."""
    from ..stream.pcap import PcapWriter
    from ..wideband.coded import scan_coded_capture

    if args.live or args.follow or args.max_follow > 1:
        raise SystemExit("wideband: coded PHY supports finite captures "
                         "(no --live/--follow yet)")
    if not args.bin:
        raise SystemExit("wideband: --bin FILE required")
    i, q = _read_iq(args.bin, args.format)
    pkts = scan_coded_capture(i, q, device=args.device)
    pcap = PcapWriter(args.pcap) if args.pcap else None
    for p in pkts:
        print(f"ch{p['channel']:02d} pos{p['pos']} "
              f"crc{'0' if p['crc_ok'] else '1'} S={p['s']} "
              f"plen{p['payload_len']} " + bytes(p["pdu_bytes"]).hex())
        if pcap and p["crc_ok"]:
            pcap.write_packet(bytes(p["pdu_bytes"]), p["channel"],
                              0x8E89BED6)
    if pcap:
        pcap.close()
    ok = sum(1 for p in pkts if p["crc_ok"])
    print(f"# {len(pkts)} coded candidates ({ok} CRC OK) across "
          f"{len({p['channel'] for p in pkts})} channels", file=sys.stderr)
    return 0


def cmd_tx(args):
    from ..tx import parse_descriptor_sequence, read_packet_file, synthesize
    from ..tx.synth import plan_to_stream

    if args.file:
        specs, repeat = read_packet_file(args.file)
    else:
        specs, repeat = parse_descriptor_sequence(args.descriptor)
    if args.repeat is not None:
        repeat = args.repeat
    sym_rate = 1
    if args.phy in ("coded8", "coded2"):
        # LE Coded framing (beyond-reference): each spec's PDU rides the
        # coded packet structure (preamble/FEC1/FEC2, spec/coded.py); the
        # symbol stream synthesizes through the SAME raw-bits TX path at
        # 1 Msym/s, so Space gaps and output formats work unchanged
        from dataclasses import replace

        from ..spec import bits as B
        from ..spec import coded as K

        s_coded = 8 if args.phy == "coded8" else 2
        new_specs = []
        for sp in specs:
            if sp.raw_phy_bits is not None:
                raise SystemExit("tx: RAW packets cannot be re-framed "
                                 "for the coded PHY")
            aa_hex = bytes(B.bits_to_bytes(sp.info_bits[8:40])).hex()
            sym = K.assemble_coded_phy(
                sp.info_bits[sp.pdu_start:], sp.channel, s=s_coded,
                access_address_hex=aa_hex, crc_init_hex=sp.crc_init_hex)
            new_specs.append(replace(sp, raw_phy_bits=sym))
        specs = new_specs
    elif args.phy == "2m":
        # plan_to_wideband synthesizes per-spec (2M bursts at 40
        # samples/symbol), so --wideband-out composes 2M scenes too —
        # decode them back with `wideband --phy 2m`
        specs = [s.to_2m() for s in specs]
        sym_rate = 2
    packets = synthesize(specs, flavor="c", sps=4, device=args.device)
    for spec, pkt in zip(specs, packets):
        print(f"# ch{spec.channel} {spec.pkt_type} {len(pkt.i)} samples "
              f"space {spec.space_ms}ms", file=sys.stderr)
    if args.dump_dir and not specs:
        raise SystemExit("tx: --dump-dir needs at least one packet")
    if args.dump_dir:
        # per-stage trace files like the reference tool writes on every
        # parse (info_bit/phy_bit/phy_sample/IQ_sample_for_matlab,
        # btle_tx.c:4094-4100) — for the last packet of the plan
        import os

        os.makedirs(args.dump_dir, exist_ok=True)
        spec, pkt = specs[-1], packets[-1]
        phy = spec.phy_bits()
        np.savetxt(os.path.join(args.dump_dir, "info_bit.txt"),
                   spec.info_bits if spec.raw_phy_bits is None else phy, fmt="%d")
        np.savetxt(os.path.join(args.dump_dir, "phy_bit.txt"), phy, fmt="%d")
        inter = np.empty(2 * len(pkt.i), np.int16)
        inter[0::2] = pkt.i
        inter[1::2] = pkt.q
        np.savetxt(os.path.join(args.dump_dir, "phy_sample.txt"), inter, fmt="%d")
        with open(os.path.join(args.dump_dir, "IQ_sample_for_matlab.txt"), "w") as fh:
            # exact reference layout (save_phy_sample_for_matlab,
            # btle_tx.c:4037-4056): "...\n" before every 24-value group,
            # space-terminated values, trailing newline
            for k, v in enumerate(inter):
                if k % 24 == 0:
                    fh.write("...\n")
                fh.write(f"{int(v)} ")
            fh.write("\n")
        print(f"# trace files in {args.dump_dir}", file=sys.stderr)
    if args.out:
        i, q = plan_to_stream(packets, sps=4, num_repeat=max(1, repeat),
                              sym_rate_msym=sym_rate)
        if args.out_format == "i8":
            arr = np.empty(2 * len(i), dtype=np.int8)
            arr[0::2] = np.clip(i, -128, 127)
            arr[1::2] = np.clip(q, -128, 127)
            arr.tofile(args.out)
        else:
            iq = np.empty(2 * len(i), dtype=np.float32)
            iq[0::2] = i / 256.0
            iq[1::2] = q / 256.0
            iq.tofile(args.out)
        print(f"# wrote {args.out} ({len(i)} IQ pairs)", file=sys.stderr)
    if args.wideband_out:
        from ..tx.synth import plan_to_wideband

        wi, wq = plan_to_wideband(specs, num_repeat=max(1, repeat),
                                  noise_std=args.wideband_noise)
        iq = np.empty(2 * len(wi), dtype=np.float32)
        iq[0::2] = wi
        iq[1::2] = wq
        iq.tofile(args.wideband_out)
        print(f"# wrote {args.wideband_out} ({len(wi)} IQ pairs @80 Msps, "
              f"channels {sorted({s.channel for s in specs})}) — decode "
              f"with: wideband --bin {args.wideband_out}", file=sys.stderr)
    if args.udp:
        from ..tx.playback import udp_transmit

        host, _, port = args.udp.rpartition(":")
        # udp_transmit's sps is samples-per-us (rate + Space pacing):
        # 4 at LE 1M, 8 for a 2M plan synthesized at 4 samples/symbol
        sent = udp_transmit(packets, int(port), host or "127.0.0.1",
                            sps=4 * sym_rate, num_repeat=repeat,
                            realtime=args.realtime)
        print(f"# transmitted {sent} IQ pairs to udp://{args.udp}"
              f"{' (realtime-paced)' if args.realtime else ''}",
              file=sys.stderr)
    return 0


def _add_tx_args(p):
    p.add_argument("descriptor", nargs="*", help="packet descriptors (chan-TYPE-...)")
    p.add_argument("--file", default=None, help="packets.txt descriptor file")
    p.add_argument("--out", default=None, help="output IQ file")
    p.add_argument("--out-format", default="f32", choices=["i8", "f32"])
    p.add_argument("--repeat", type=int, default=None)
    p.add_argument("--phy", default="1m",
                   choices=["1m", "2m", "coded8", "coded2"],
                   help="frame the plan for this LE PHY (2m = BLE 5 LE "
                        "2M: 16-bit preamble; the output is then an "
                        "8 Msps stream; coded8/coded2 = BLE 5 LE Coded "
                        "S=8/S=2 at 1 Msym/s; decode back with `decode "
                        "--phy 2m|coded8|coded2`)")
    p.add_argument("--dump-dir", default=None,
                   help="write reference-style per-stage trace files")
    p.add_argument("--wideband-out", default=None, metavar="FILE",
                   help="compose the plan into ONE 80 Msps f32 capture with "
                        "each packet on its descriptor's channel carrier "
                        "(the wideband sniffer's input format)")
    p.add_argument("--wideband-noise", type=float, default=0.0,
                   help="AWGN std dev (int8 units) added to --wideband-out")
    p.add_argument("--udp", default=None, metavar="HOST:PORT",
                   help="play the plan as timed bursts to a UDP receiver "
                        "(wire format of the runtime's ingest)")
    p.add_argument("--realtime", action="store_true",
                   help="pace --udp playback at the 4 Msps air rate")
    p.add_argument("--device", default="cuda",
                   help="torch device of the modulator (default cuda; cpu "
                        "runs it on the CPU)")


def _add_wideband_args(p):
    p.add_argument("--bin", default=None,
                   help="interleaved-IQ capture file (finite mode)")
    p.add_argument("--format", default="f32", choices=["i8", "i16", "f32"])
    p.add_argument("--pcap", default=None)
    p.add_argument("--json", action="store_true",
                   help="emit NDJSON schema-v1 pkt/hop/status events on "
                        "stdout (follow events become hop events, "
                        "candidate-slot rescans status events)")
    p.add_argument("--live", action="store_true",
                   help="unbounded live mode: ingest UDP datagrams into "
                        "the native SPSC ring and scan until Ctrl-C or "
                        "--seconds")
    p.add_argument("--udp", type=int, default=9999, metavar="PORT",
                   help="UDP port for --live sample ingest")
    p.add_argument("--seconds", type=float, default=None,
                   help="stop --live after this many seconds")
    p.add_argument("--pipeline", type=int, default=2, metavar="DEPTH",
                   help="scans kept in flight in --live mode (follow "
                        "re-keying lags DEPTH-1 blocks)")
    p.add_argument("--control-port", type=int, default=None, metavar="PORT",
                   help="listen for send-cmd register writes and apply "
                        "them between blocks (--live)")
    p.add_argument("--ltk", default=None, metavar="HEX32",
                   help="long-term key (16 bytes hex): sessions derive "
                        "from sniffed LL_ENC_REQ/RSP exchanges and "
                        "encrypted data PDUs decrypt in-stream "
                        "(plain:... in text, plain_hex in NDJSON)")
    p.add_argument("--follow", action="store_true",
                   help="follow CONNECT_REQs onto the data channels")
    p.add_argument("--max-follow", type=int, default=1, metavar="N",
                   help="follow up to N connections concurrently, each "
                        "owning the data channel its hop sequence occupies "
                        "(implies --follow)")
    p.add_argument("--fused", action="store_true",
                   help="use the fused front end (the hand-written CUDA "
                        "kernels on a card)")
    p.add_argument("--fused-dtype", default="bf16x2w",
                   choices=["bf16x2w", "f32", "bf16"],
                   help="fused front-end numerics: bf16x2w = shipped "
                        "default (bf16 frames, exact hi/lo weight pair), "
                        "f32 = exact-filterbank parity mode, bf16 = "
                        "8-bit-ADC-class stopband")
    p.add_argument("--phy", default="1m",
                   choices=["1m", "2m", "coded8", "coded2"],
                   help="LE PHY of the airspace (2m: 2 samples/symbol per "
                        "channel on the same grid; coded8/coded2 scan LE "
                        "Coded airspace, finite captures)")
    p.add_argument("--selftest", default=None, action="store_true",
                   help="run the known-answer self-test on the device "
                        "before scanning; runs automatically when the "
                        "fused pipeline runs on a card")
    p.add_argument("--no-selftest", dest="selftest", action="store_false",
                   help="skip the automatic fused-pipeline self-test")
    p.add_argument("--device", default="cuda",
                   help="torch device of the scan (default cuda; cpu runs "
                        "the plain PyTorch path)")


def cmd_scan(args):
    from ..stream import iq_file_source
    from .aggregate import ScanAggregator
    from .events import packet_event_to_model

    want_json = args.json
    args.json = False           # suppress per-packet NDJSON; summary only
    args.quiet_text = True
    sniffer = _build_sniffer(args)
    args.json = want_json
    events = sniffer.run(iq_file_source(args.bin, args.format))
    agg = ScanAggregator()
    for ev in events:
        if ev.header is not None:
            agg.update(packet_event_to_model(ev))
    rows = agg.snapshot(sort="pkts")
    if args.json:
        from .recon import quickscan

        print(quickscan(agg).model_dump_json(indent=2, exclude_none=True))
        return 0
    print(f"{'AdvA':18} {'Name':24} {'Vendor':20} {'Pkts':>5} {'CRC%':>5} {'RSSI':>5}")
    for r in rows:
        rssi = str(r.last_rssi) if r.last_rssi is not None else "-"
        print(f"{r.adv_a:18} {r.name[:24]:24} {r.vendor[:20]:20} "
              f"{r.pkt_count:5d} {100*r.crc_ok_ratio():5.1f} {rssi:>5}")
    return 0


def cmd_analyze(args):
    from .analyze import analyze_pcap, plot_capture, save_figures

    a = analyze_pcap(args.pcap)
    for line in a.summary_lines():
        print(line)
    if args.plot:
        ok = plot_capture(args.pcap, args.plot)
        written = save_figures(args.pcap, args.plot) if ok else []
        names = [args.plot, *written] if ok else []
        print(f"# plots {'written: ' + ', '.join(names) if ok else 'skipped (no matplotlib)'}",
              file=sys.stderr)
    return 0


def cmd_iq_show(args):
    """Capture inspection without decoding — the reference's
    test_rx_iq_show.py / water_fall.m workflow for every wire format the
    CLI reads (host-side numpy, as in the JAX package)."""
    from ..stream.sources import load_iq_capped
    from ..utils.spectrum import occupancy, waterfall

    try:
        i, q = load_iq_capped(args.bin, args.format, args.max_samples)
    except ValueError as e:
        raise SystemExit(f"iq-show: {e}")
    win = args.win or args.fft
    hop = args.hop or win
    power = waterfall(i, q, fft_size=args.fft, win_len=win, hop=hop)
    print(f"# {args.bin}: {len(i)} IQ pairs @ {args.rate/1e6:g} Msps = "
          f"{len(i)/args.rate*1e3:.3f} ms, waterfall {power.shape[0]}x"
          f"{power.shape[1]} (fft {args.fft}, win {win}, hop {hop})")
    occ = occupancy(power, args.rate, threshold_db=args.threshold_db)
    if not occ:
        print(f"# no bins above the noise floor + {args.threshold_db:g} dB")
    for row in occ[:16]:
        f_abs = (f", {(args.center + row['freq_offset_hz'])/1e6:.1f} MHz"
                 if args.center is not None else "")
        print(f"offset {row['freq_offset_hz']/1e3:+9.1f} kHz{f_abs}  "
              f"peak {row['peak_db']:5.1f} dB  duty {row['duty']:.3f}")
    if len(occ) > 16:
        print(f"# ... and {len(occ) - 16} more occupied bins")
    if args.out:
        from .analyze import waterfall_figure

        fig = waterfall_figure(i, q, args.rate, center_hz=args.center,
                               fft_size=args.fft, win_len=win, hop=hop,
                               power=power)
        if fig is None:
            print("# waterfall PNG skipped (no matplotlib)", file=sys.stderr)
        else:
            fig.savefig(args.out, dpi=120)
            print(f"# waterfall written: {args.out}", file=sys.stderr)
    return 0


def cmd_recon(args):
    from . import recon

    if args.op == "gatt":
        out = recon.gatt(args.pcap, ltk_hex=args.ltk)
    elif args.op == "quickscan":
        out = recon.quickscan(args.pcap)
    elif args.op == "profile":
        out = recon.profile(args.pcap, args.adv_a)
    elif args.op == "diff":
        out = recon.diff(args.pcap, args.pcap_b)
    elif args.op == "entropy":
        out = recon.payload_entropy(args.pcap, args.adv_a)
    else:
        raise SystemExit(f"unknown recon op {args.op}")
    print(out.model_dump_json(indent=2, exclude_none=True))
    return 0


def cmd_ber(args):
    from ..sim import BerHarness, reference_max_snr

    h = BerHarness(device=args.device)
    anchor = reference_max_snr(args.ppm)
    snrs = [anchor - 4, anchor - 2.5, anchor - 1, anchor]
    results = h.sweep(snrs, args.ppm, args.packets)
    for snr, (ber, ok, nbits) in zip(snrs, results):
        print(json.dumps({"ppm": args.ppm, "snr_db": round(snr, 2),
                          "ber": ber, "pkt_ok": ok, "bits": nbits}))
    if args.plot:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("# plot skipped (no matplotlib)", file=sys.stderr)
            return 0
        bers = [max(r[0], 1e-7) for r in results]
        plt.semilogy(snrs, bers, "b+-")
        plt.title(f"BER with ppm {args.ppm}")
        plt.xlabel("SNR(dB)")
        plt.ylabel("BER")
        plt.grid(True)
        plt.savefig(args.plot, dpi=120)
        print(f"# plot written to {args.plot}", file=sys.stderr)
    return 0


def build_parser():
    ap = argparse.ArgumentParser(prog="btle_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("decode", help="sniff one channel from an IQ capture")
    _add_rx_args(p)
    p.set_defaults(fn=cmd_decode)
    p = sub.add_parser("wideband", help="40-channel wideband sniff (80 Msps capture)")
    _add_wideband_args(p)
    p.set_defaults(fn=cmd_wideband)
    p = sub.add_parser("tx", help="synthesize packets to an IQ file")
    _add_tx_args(p)
    p.set_defaults(fn=cmd_tx)
    p = sub.add_parser("scan", help="decode + aggregate device table")
    _add_rx_args(p)
    p.set_defaults(fn=cmd_scan)
    p = sub.add_parser("analyze", help="summarize a pcap capture")
    p.add_argument("pcap")
    p.add_argument("--plot", default=None, help="write timeline plot PNG")
    p.set_defaults(fn=cmd_analyze)
    p = sub.add_parser("iq-show", help="inspect an IQ capture "
                       "(waterfall spectrogram + occupancy summary)")
    p.add_argument("bin", help="IQ capture file")
    p.add_argument("--format", default="i16", choices=["i8", "i16", "f32", "csv"],
                   help="sample format (i8=HackRF, i16=firmware, "
                        "f32=usrp/wideband, csv=Vivado ILA)")
    p.add_argument("--rate", type=float, default=8e6,
                   help="sample rate in Hz (default 8e6; wideband "
                        "captures are 80e6)")
    p.add_argument("--center", type=float, default=None,
                   help="RF center frequency in Hz for absolute axis "
                        "labels (wideband captures are centred at "
                        "2.442e9, channelizer.CENTER_FREQ_HZ)")
    p.add_argument("--fft", type=int, default=256, help="FFT size")
    p.add_argument("--win", type=int, default=None,
                   help="samples fed to each FFT (default --fft)")
    p.add_argument("--hop", type=int, default=None,
                   help="window advance per column (default --win)")
    p.add_argument("--max-samples", type=int, default=4_000_000,
                   help="cap on samples read from the capture")
    p.add_argument("--threshold-db", type=float, default=12.0,
                   help="occupancy threshold above the noise floor")
    p.add_argument("--out", default=None, help="write waterfall PNG")
    p.set_defaults(fn=cmd_iq_show)
    p = sub.add_parser("recon", help="recon operations on a pcap")
    p.add_argument("op", choices=["quickscan", "profile", "diff", "entropy", "gatt"])
    p.add_argument("pcap")
    p.add_argument("pcap_b", nargs="?", default=None)
    p.add_argument("--adv-a", default=None)
    p.add_argument("--ltk", default=None, metavar="HEX32",
                   help="gatt: decrypt connection traffic with this LTK "
                        "(sessions key from the capture's LL_ENC_REQ/RSP)")
    p.set_defaults(fn=cmd_recon)
    p = sub.add_parser("ber", help="BER sweep at a given ppm")
    p.add_argument("--ppm", type=float, default=0.0)
    p.add_argument("--packets", type=int, default=100)
    p.add_argument("--plot", default=None, help="write semilogy BER curve PNG")
    p.add_argument("--device", default="cuda",
                   help="torch device of the harness (default cuda; cpu "
                        "runs the plain PyTorch path)")
    p.set_defaults(fn=cmd_ber)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
