"""Generate per-stage golden test vectors for downstream implementations.

The file-exchange equivalent of the reference's SAVE_FOR_VERILOG workflow
(test_vector_for_btle_verilog.py): synthesize a packet through the golden
chain (optionally with SNR/ppm impairments), decode it back, and write
every stage's input/reference-output as text files plus a config manifest.

Port of tools/gen_test_vectors.py on the port's copies of the golden
chain and the vector export (host-side numpy; the same arguments and the
same files, byte for byte).

Usage:
  python -m btle_tpu_torch.tools.gen_test_vectors --out DIR \
      --pdu 422506050403020119095344... --channel 37 --sps 8 \
      [--snr 20] [--ppm 10] [--modules]
"""

import argparse
import json
import os

import numpy as np

from ..golden import model as G
from ..spec import bits as B
from ..utils import dump_rx_vectors, dump_tx_vectors
from ..utils.vectors import dump_module_vectors


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--pdu", default="422506050403020119095344522f426c7565746f6f74682f4c6f772f456e657267791234567890")
    ap.add_argument("--channel", type=int, default=37)
    ap.add_argument("--sps", type=int, default=8)
    ap.add_argument("--crc-init", default="555555")
    ap.add_argument("--access-addr", default="D6BE898E")
    ap.add_argument("--snr", type=float, default=None)
    ap.add_argument("--ppm", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--modules", action="store_true",
                    help="also emit one vector set per reference testbench "
                         "(all 11 verilog/*_tb.v consumers; docs/FORMATS.md)")
    args = ap.parse_args(argv)

    pdu_bits = B.hex_to_bits(args.pdu)
    tx_files = dump_tx_vectors(
        pdu_bits, args.out, channel=args.channel, sps=args.sps,
        crc_init_hex=args.crc_init, access_address_hex=args.access_addr,
    )
    i, q, _ = G.btle_tx(pdu_bits, args.channel, args.crc_init,
                        args.access_addr, sps=args.sps)
    i = i.astype(np.double)
    q = q.astype(np.double)
    if args.ppm:
        i, q, _ = G.add_freq_sampling_error(i, q, args.ppm, sps=args.sps)
    if args.snr is not None:
        i, q = G.add_noise(i, q, args.snr, np.random.default_rng(args.seed))
    i = np.int16(np.round(i))
    q = np.int16(np.round(q))
    np.savetxt(os.path.join(args.out, "btle_rx_test_input_i.txt"), i, fmt="%d")
    np.savetxt(os.path.join(args.out, "btle_rx_test_input_q.txt"), q, fmt="%d")
    rx_files = dump_rx_vectors(
        i, q, args.out, channel=args.channel, sps=args.sps,
        crc_init_hex=args.crc_init, access_address_hex=args.access_addr,
    )
    manifest = {
        "pdu_hex": args.pdu, "channel": args.channel, "sps": args.sps,
        "crc_init": args.crc_init, "access_addr": args.access_addr,
        "snr_db": args.snr, "ppm": args.ppm,
        "tx_files": tx_files, "rx_files": rx_files,
    }
    if args.modules:
        module_files = dump_module_vectors(
            pdu_bits, args.out, channel=args.channel, sps=args.sps,
            crc_init_hex=args.crc_init, access_address_hex=args.access_addr)
        manifest["module_files"] = {
            mod: files for mod, files in module_files.items()}
    with open(os.path.join(args.out, "btle_config.json"), "w") as fh:
        json.dump(manifest, fh, indent=2)
    print(f"wrote {len(tx_files) + len(rx_files) + 3} vector files to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
