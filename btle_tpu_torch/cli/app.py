"""btle_tpu_torch command-line interface.

The port's tool-layer surface, wired to IQ capture files and stdin
streams (the ``btle_tpu`` CLI's counterpart; the other subcommands are
not ported yet):

  decode    sniff one channel from an IQ file/stdin (btle_rx equivalent)

Runs on the CUDA card unless ``--device`` names another device
(``--device cpu`` runs the plain PyTorch path).
"""

from __future__ import annotations

import argparse
import sys


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
                        "= BLE 5 LE Coded, not ported yet)")
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
        raise SystemExit(f"decode: --phy {args.phy} (LE Coded) is not ported "
                         "yet (ROADMAP Queue 1 item 13)")
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


def build_parser():
    ap = argparse.ArgumentParser(prog="btle_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("decode", help="sniff one channel from an IQ capture")
    _add_rx_args(p)
    p.set_defaults(fn=cmd_decode)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
