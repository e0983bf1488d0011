"""BLE framing, CRC, whitening and GFSK in NumPy: frozen copies.

Copied, as the port has them, from btle_tpu_torch/spec/bits.py
(LSB-first octets), spec/crc24.py (the reflected table CRC of
btle_rx.c:1211-1222), spec/whitening.py (the x^7 + x^4 + 1 LFSR of
btle_tx.c:1502-1530), spec/channels.py (the 2-MHz grid), tx/descriptor.py
(preamble by the AA's first bit, btle_tx.c:2695-2698) and
golden/model.py (``gauss_fir``, ``gfsk_modulate_float``: btlelib.py's
float modulator). The modulator is rewritten as three shifted copies of
one symbol's frequency pulse instead of ``np.convolve``; the result is
the same to rounding.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

ADV_AA = 0x8E89BED6
# CRC init 0x555555 as the LFSR takes it, in the table form the decoder
# uses (the bit reversal of its LSB-first expansion)
ADV_CRC_INIT_TABLE = 0xAAAAAA
AA_BITS = 32
MAX_PDU_CRC_BYTES = 42          # 2 header + 37 payload + 3 CRC
MAX_PDU_CRC_BITS = 8 * MAX_PDU_CRC_BYTES
N_CHANNELS = 40
MODULATION_INDEX = 0.5
BT = 0.5


def bytes_to_bits(data) -> np.ndarray:
    """Octets -> on-air bits, each octet LSB first (int8 0/1)."""
    return np.unpackbits(np.frombuffer(bytes(data), np.uint8),
                         bitorder="little").astype(np.int8)


def bits_to_bytes(bits) -> np.ndarray:
    """On-air bits (a multiple of 8) -> octets, LSB first."""
    return np.packbits(np.asarray(bits, np.uint8), bitorder="little")


def aa_bits(aa: int) -> np.ndarray:
    """The 32 on-air bits of an access address (little-endian octets)."""
    return bytes_to_bits(int(aa).to_bytes(4, "little"))


def _crc_table() -> np.ndarray:
    table = np.zeros(256, np.int64)
    for b in range(256):
        crc = b
        for _ in range(8):
            crc = (crc >> 1) ^ 0xDA6000 if crc & 1 else crc >> 1
        table[b] = crc
    return table


CRC24_TABLE = _crc_table()


def crc24(data, init_table: int) -> int:
    """Reflected table CRC-24 over octets from a table-form init."""
    crc = init_table & 0xFFFFFF
    for byte in bytes(data):
        crc = int(CRC24_TABLE[(crc ^ byte) & 0xFF]) ^ (crc >> 8)
    return crc


def crc_octets(crc: int) -> bytes:
    """A table-form CRC as the three octets sent after the PDU."""
    return bytes([crc & 0xFF, (crc >> 8) & 0xFF, (crc >> 16) & 0xFF])


@lru_cache(maxsize=64)
def whitening_bits(channel: int, n: int = MAX_PDU_CRC_BITS) -> np.ndarray:
    """The whitening sequence of ``channel``: the 7-bit LFSR seeded with
    1 | channel[5:0], one output bit a step (read-only int8 0/1)."""
    s = [1] + [(channel >> (5 - k)) & 1 for k in range(6)]
    out = np.empty(n, np.int8)
    for k in range(n):
        out[k] = s[6]
        s = [s[6], s[0], s[1], s[2], s[3] ^ s[6], s[4], s[5]]
    out.setflags(write=False)
    return out


def channel_freq_hz(channel: int) -> int:
    """Centre frequency of a BLE channel (btle_rx.c:1006-1022)."""
    if channel == 37:
        return 2_402_000_000
    if channel == 38:
        return 2_426_000_000
    if channel == 39:
        return 2_480_000_000
    if 0 <= channel <= 10:
        return 2_404_000_000 + 2_000_000 * channel
    if 11 <= channel <= 36:
        return 2_428_000_000 + 2_000_000 * (channel - 11)
    raise ValueError(f"no BLE channel {channel}")


def grid_index(channel: int) -> int:
    """Position of a channel on the 2402 + 2k MHz grid."""
    return (channel_freq_hz(channel) - 2_402_000_000) // 2_000_000


GRID_TO_CHANNEL = np.empty(N_CHANNELS, np.int64)
for _ch in range(N_CHANNELS):
    GRID_TO_CHANNEL[grid_index(_ch)] = _ch


def bin_to_channel(m: int) -> int:
    """The BLE channel of the wideband channelizer's output bin m (an 80
    Msps capture centred at 2442 MHz puts grid index g in bin g+20 mod
    40)."""
    return int(GRID_TO_CHANNEL[(m - N_CHANNELS // 2) % N_CHANNELS])


def is_adv(channel: int) -> bool:
    return channel in (37, 38, 39)


def phy_bits(pdu: bytes, channel: int, aa: int = ADV_AA,
             crc_init_table: int = ADV_CRC_INIT_TABLE) -> np.ndarray:
    """LE 1M on-air bits of one packet: the preamble (0x55 when the AA's
    first bit is 1, else 0xAA), the AA, then the PDU and its CRC,
    whitened for ``channel``."""
    body = bytes_to_bits(bytes(pdu) + crc_octets(crc24(pdu, crc_init_table)))
    preamble = 0x55 if aa & 1 else 0xAA
    return np.concatenate([bytes_to_bits(bytes([preamble])), aa_bits(aa),
                           body ^ whitening_bits(channel, len(body))])


def gauss_fir(sps: int, bt: float = BT, span: int = 2) -> np.ndarray:
    """Gaussian taps, length span*sps + 1, normalised so NRZ input peaks
    at +-1 (btlelib.gauss_fir_gen, btlelib.py:38-48)."""
    sigma = np.sqrt(np.log(2)) / (2 * np.pi * bt)
    t = np.arange(-(span / 2), (span / 2) + 1 / sps, 1 / sps)
    h = np.exp(-t * t / (2 * sigma * sigma)) / (sigma * np.sqrt(2 * np.pi))
    return h / sps


@lru_cache(maxsize=8)
def _pulse_parts(sps: int) -> np.ndarray:
    """One symbol's frequency pulse (a run of sps ones through the
    Gaussian filter), cut into rows of sps samples: (3, sps) at span 2."""
    g = np.convolve(np.ones(sps), gauss_fir(sps))          # 3*sps
    return g.reshape(-1, sps)


def gfsk_modulate(bits, sps: int, amplitude: float = 1.0):
    """Float GFSK (btlelib.gfsk_modulation): NRZ symbols through the
    Gaussian filter, integrated to a phase at modulation index 0.5.
    Returns (i, q) float64 of len(bits)*sps + 2*sps samples, equal to
    the reference's np.convolve form to rounding."""
    nrz = np.asarray(bits, np.float64) * 2 - 1
    parts = _pulse_parts(sps)
    n = len(nrz)
    y = np.zeros((n + len(parts) - 1, sps))
    for j, part in enumerate(parts):
        y[j: j + n] += nrz[:, None] * part[None, :]
    phase = np.cumsum(y.ravel()) * (np.pi * MODULATION_INDEX / sps)
    return amplitude * np.cos(phase), amplitude * np.sin(phase)


def rssi_dbm_from_mag(mag_mean: float) -> int:
    """The reference's RSSI mapping (btle_rx.c:2246-2251)."""
    v = int(20.0 * np.log10(max(float(mag_mean), 1.0) / 256.0) - 50.0)
    return max(-127, min(20, v))
