"""BLE air from a seed: the one scene generator of every traffic mix.

A frozen NumPy rewrite of what the port's tx/synth.py and the scene of
tools/bench_live.py do (float GFSK at the capture's samples per symbol,
each burst heterodyned onto its channel's carrier, AWGN, rounding to the
wire's integer format); it shares no code with the program's TX path.

Parameters (a traffic file's ``scene`` object):

- ``sample_rate_msps``: 80 for a 40-channel capture centred at 2442
  MHz, 4 for one channel at baseband.
- ``center_channel``: the channel at 0 Hz (narrowband), or null for the
  wideband centre of 2442 MHz.
- ``channels``: the channels the capture holds.
- ``air_s``: seconds of air; the feed loops it.
- ``advertisers``, ``adv_interval_ms``, ``adv_delay_ms``: advertising
  events (Core Specification v5.4, Vol 6, Part B, 4.4.2.2: an event
  every advInterval plus a pseudo-random advDelay of 0-10 ms, each event
  one PDU on 37, 38 and 39 in turn). The advertisers' events, at
  ``advertisers / (adv_interval_ms + adv_delay_ms / 2)`` a second, start
  at gaps drawn uniformly from [1 - spread, 1 + spread] times their mean
  (``gap_spread``), never closer than the longest advertising PDU, so no
  two bursts overlap on a channel and a scene is about the same size for
  every seed. ``adv_pdu_gap_us``: from the end of one PDU of an event to
  the start of the next. Each PDU is an ADV_NONCONN_IND on the
  advertising AA and CRC init.
- ``connections``, ``conn_interval_ms`` [lo, hi]: data connections on
  the data channels, each with an access address and CRC init of its
  own, an interval drawn in 1.25 ms steps, channel selection #1 (a hop
  increment of 5-16), and at each connection event a central PDU and
  the peripheral's answer 150 us (T_IFS) after it. A sniffer that
  follows no connection filters them out; they occupy its channels.
- ``adv_payload``, ``data_payload``: [lo, hi] payload octets, uniform.
- ``amplitude``: [lo, hi] peak of each burst in wire units, uniform;
  ``noise_std``: AWGN per component; ``format``: "i16" or "i8".
- ``margin_ms``: quiet air at both ends, so no burst crosses the loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..reference import ble

WIDEBAND_CENTER_HZ = 2_442_000_000


@dataclass
class Packet:
    channel: int
    start: int          # first sample of the burst (preamble), in the scene
    aa_start: int       # first sample of the access address's first symbol
    pdu: bytes          # header + payload, without CRC
    amplitude: float
    aa: int = ble.ADV_AA
    crc_init: int = ble.ADV_CRC_INIT_TABLE     # table form


@dataclass
class Scene:
    iq: np.ndarray      # interleaved I/Q of the wire format, read-only
    packets: list       # Packet, by start
    sps: int            # samples per symbol at the scene's rate
    sample_rate_msps: float

    @property
    def n_pairs(self) -> int:
        return len(self.iq) // 2

    def packets_on(self, aa: int) -> list:
        """The packets a sniffer keyed on ``aa`` is to hand on."""
        return [p for p in self.packets if p.aa == aa]


ADV_CHANNELS = (37, 38, 39)
T_IFS_US = 150


def _adv_pdu(rng, params: dict) -> bytes:
    lo, hi = params["adv_payload"]
    n = int(rng.integers(lo, hi + 1))
    tx_add = int(rng.integers(0, 2))
    head = bytes([0x02 | (tx_add << 6), n])     # ADV_NONCONN_IND
    return head + rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _data_pdu(rng, params: dict) -> bytes:
    lo, hi = params["data_payload"]
    n = int(rng.integers(lo, hi + 1))
    llid = 1 if n == 0 else int(rng.integers(1, 3))
    nesn, sn, md = (int(b) for b in rng.integers(0, 2, 3))
    head = bytes([llid | (nesn << 2) | (sn << 3) | (md << 4), n])
    return head + rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _air_samples(pdu: bytes, sps: int) -> int:
    """Samples a burst occupies: preamble, AA, PDU, CRC."""
    return (8 + 32 + 8 * (len(pdu) + 3)) * sps


def connection_aa(rng) -> int:
    """A data connection's access address: random, not the advertising
    one nor one bit from it, no run of more than six equal bits, its
    four octets not all equal (after Vol 6, Part B, 2.1.2)."""
    while True:
        aa = int(rng.integers(0, 1 << 32, dtype=np.uint64))
        bits = format(aa, "032b")
        if (bin(aa ^ ble.ADV_AA).count("1") > 1 and "0000000" not in bits
                and "1111111" not in bits and len(set(aa.to_bytes(4, "little"))) > 1):
            return aa


def _adv_events(rng, params, fs, sps, t0, t_end, out):
    chans = [c for c in ADV_CHANNELS if c in params["channels"]]
    if not chans or not params.get("advertisers"):
        return
    rate = params["advertisers"] / (
        1e-3 * (params["adv_interval_ms"] + params["adv_delay_ms"] / 2))
    mean_gap = fs / rate
    spread = params.get("gap_spread", 0.5)
    a_lo, a_hi = params["amplitude"]
    pdu_gap = int(params["adv_pdu_gap_us"] * sps)
    longest = _air_samples(bytes(2 + params["adv_payload"][1]), sps) + 8 * sps
    t = t0 + int(rng.uniform(0, mean_gap))
    while True:
        pdu = _adv_pdu(rng, params)
        dur = _air_samples(pdu, sps)
        if t + len(chans) * (dur + pdu_gap) > t_end:
            break
        at = t
        for ch in chans:
            out.append(Packet(ch, at, at + 8 * sps, pdu, float(rng.uniform(a_lo, a_hi))))
            at += dur + pdu_gap
        t += max(longest, int(mean_gap * rng.uniform(1 - spread, 1 + spread)))


def _connections(rng, params, fs, sps, t0, t_end, out):
    data = [c for c in params["channels"] if c not in ADV_CHANNELS]
    if not data:
        return
    lo, hi = params["conn_interval_ms"]
    a_lo, a_hi = params["amplitude"]
    for _ in range(params.get("connections", 0)):
        aa = connection_aa(rng)
        crc_init = int(rng.integers(0, 1 << 24))
        steps = int(rng.integers(int(round(lo / 1.25)), int(round(hi / 1.25)) + 1))
        interval = int(steps * 1.25e-3 * fs)
        hop = int(rng.integers(5, 17))
        unmapped = int(rng.integers(0, 37))
        t = t0 + int(rng.uniform(0, interval))
        while True:
            central, peripheral = _data_pdu(rng, params), _data_pdu(rng, params)
            answer = t + _air_samples(central, sps) + T_IFS_US * sps
            if answer + _air_samples(peripheral, sps) > t_end:
                break
            unmapped = (unmapped + hop) % 37
            if unmapped in data:
                for at, pdu in ((t, central), (answer, peripheral)):
                    out.append(Packet(unmapped, at, at + 8 * sps, pdu,
                                      float(rng.uniform(a_lo, a_hi)), aa, crc_init))
            t += interval


def schedule(rng, params: dict, n_samples: int, sps: int) -> list:
    """Every packet of the scene: the advertisers' events and the
    connections' exchanges (see the module docstring)."""
    fs = params["sample_rate_msps"] * 1e6
    margin = int(params["margin_ms"] * 1e-3 * fs)
    out: list = []
    _adv_events(rng, params, fs, sps, margin, n_samples - margin, out)
    _connections(rng, params, fs, sps, margin, n_samples - margin, out)
    out.sort(key=lambda p: (p.start, p.channel))
    return out


def generate(params: dict, seed: int, salt: int = 0) -> Scene:
    """The scene of ``params`` for ``seed`` (and a cell's ``salt``): the
    same arguments give the same samples and packets."""
    rng = np.random.default_rng([int(salt), int(seed)])
    fs = params["sample_rate_msps"] * 1e6
    sps = int(round(fs / 1e6))
    n = int(round(params["air_s"] * fs))
    center = (WIDEBAND_CENTER_HZ if params.get("center_channel") is None
              else ble.channel_freq_hz(params["center_channel"]))
    packets = schedule(rng, params, n, sps)
    x = np.empty(n, np.complex64)
    std = params["noise_std"]
    x.real = rng.standard_normal(n, dtype=np.float32) * std
    x.imag = rng.standard_normal(n, dtype=np.float32) * std
    for p in packets:
        bi, bq = ble.gfsk_modulate(ble.phy_bits(p.pdu, p.channel, p.aa, p.crc_init),
                                   sps, p.amplitude)
        idx = p.start + np.arange(len(bi))
        f = (ble.channel_freq_hz(p.channel) - center) / fs
        carrier = np.exp(1j * (2 * np.pi * f * idx + rng.uniform(0, 2 * np.pi)))
        x[p.start: p.start + len(bi)] += ((bi + 1j * bq) * carrier).astype(np.complex64)
    fmt = params["format"]
    dtype, top = {"i16": (np.int16, 32767), "i8": (np.int8, 127)}[fmt]
    iq = np.empty(2 * n, dtype)
    iq[0::2] = np.clip(np.rint(x.real), -top - 1, top)
    iq[1::2] = np.clip(np.rint(x.imag), -top - 1, top)
    iq.flags.writeable = False
    return Scene(iq, packets, sps, params["sample_rate_msps"])
