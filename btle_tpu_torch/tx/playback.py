"""Timed transmission playback: the reference's burst scheduler over UDP.

The reference's btle_tx pushes each packet to the radio as a timed USB
burst — warm-up zeros + samples + zero fill per burst (tx_callback,
btle_tx.c:165-177), a busy-poll Space wait between packets
(btle_tx.c:4326-4329) and an rN plan repeat (btle_tx.c:4307-4331). In
this runtime the air interface is the sample stream itself, so the
scheduler plays the same burst structure onto a UDP socket in the
runtime's wire format (interleaved int16 IQ — what runtime.UdpIngest
feeds into the C++ ring buffer on the receive side).

Both modes materialize the Space gaps as zero samples (exactly
``plan_to_stream``'s layout) — the receive side's clock is the sample
offset, so the gap must exist in the sample timeline. ``realtime=True``
additionally paces the socket at the sample rate (1 Msym/s x sps),
making the stream air-faithful in wall-clock time; ``False`` blasts at
full speed, which is what loopback tests want.
"""

from __future__ import annotations

import socket
import time

import numpy as np

NUM_PRE_SEND_ZEROS = 256   # per-burst warm-up, btle_tx.c:117


def _interleave(i: np.ndarray, q: np.ndarray) -> np.ndarray:
    out = np.empty(2 * len(i), np.int16)
    out[0::2] = i
    out[1::2] = q
    return out


def udp_transmit(packets, port: int, host: str = "127.0.0.1", *,
                 sps: int = 4, num_repeat: int = 1, realtime: bool = False,
                 datagram_pairs: int = 1024) -> int:
    """Play a synthesized plan (list of tx.synth.SynthesizedPacket) as
    timed bursts to udp://host:port. Returns IQ pairs sent.

    num_repeat=-1 is the reference's infinite repeat; here it must be
    interrupted (KeyboardInterrupt) like the C tool.
    """
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    addr = (host, port)
    pairs_sent = 0
    sample_rate = sps * 1e6

    def send_stream(i: np.ndarray, q: np.ndarray):
        nonlocal pairs_sent
        wire = _interleave(i.astype(np.int16), q.astype(np.int16))
        for off in range(0, len(wire), 2 * datagram_pairs):
            chunk = wire[off : off + 2 * datagram_pairs]
            sock.sendto(chunk.tobytes(), addr)
            pairs_sent += len(chunk) // 2
            if realtime:
                time.sleep(len(chunk) / 2 / sample_rate)

    try:
        rep = 0
        zeros = np.zeros(NUM_PRE_SEND_ZEROS, np.int16)
        while num_repeat < 0 or rep < num_repeat:
            rep += 1
            for p in packets:
                send_stream(zeros, zeros)            # burst warm-up
                send_stream(p.i, p.q)
                # the Space gap is part of the sample timeline: the
                # receiver's clock is the sample offset (now_us =
                # offset/sps), so the silence must be materialized as
                # zero samples in BOTH modes — send_stream itself paces
                # them at the sample rate when realtime (the C tool's
                # busy-wait holds the radio silent; skipping samples
                # here would compress advert intervals and hop timing)
                gap = int(p.space_ms * 1000 * sps)
                if gap:
                    g = np.zeros(gap, np.int16)
                    send_stream(g, g)
    finally:
        sock.close()
    return pairs_sent
