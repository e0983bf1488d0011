"""Bit/byte/hex order utilities (host-side, NumPy).

BLE transmits every octet LSB-first. The reference encodes hex strings with a
nibble swap so that reading the string left-to-right yields the over-the-air
bit order (btlelib.py:270-332 ``hex_string_to_bit``/``bit_to_hex_string``).
That transform is equivalent to: parse the hex string as bytes, then unpack
each byte LSB-first — which is how we implement it here.
"""

from __future__ import annotations

import numpy as np


def hex_to_bits(hex_string: str) -> np.ndarray:
    """Hex string -> over-the-air bit array (int8 of 0/1).

    Matches btlelib.hex_string_to_bit (btlelib.py:270-294): each octet is
    emitted LSB-first.
    """
    s = hex_string.strip()
    if len(s) % 2 != 0:
        raise ValueError("hex string must contain whole octets")
    data = bytes.fromhex(s)
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8), bitorder="little").astype(np.int8)


def bits_to_hex(bits: np.ndarray) -> str:
    """Bit array -> hex string, zero-padding to whole octets.

    Matches btlelib.bit_to_hex_string (btlelib.py:296-332) including its
    nibble ordering and zero padding.
    """
    bits = np.asarray(bits, dtype=np.uint8).ravel()
    pad = (-len(bits)) % 8
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, dtype=np.uint8)])
    data = np.packbits(bits, bitorder="little")
    # Reference emits an odd number of nibbles when the input bit count fits
    # in them, but since we always pad to octets the hex length is even.
    return data.tobytes().hex()


def bytes_to_bits(byte_arr) -> np.ndarray:
    """uint8 array -> LSB-first bit array (byte_array_to_bit_array of btle_rx.c)."""
    b = np.asarray(byte_arr, dtype=np.uint8).ravel()
    return np.unpackbits(b, bitorder="little").astype(np.int8)


def bits_to_bytes(bits) -> np.ndarray:
    """LSB-first bit array -> uint8 array. Length must be a multiple of 8."""
    bits = np.asarray(bits, dtype=np.uint8).ravel()
    if len(bits) % 8 != 0:
        raise ValueError("bit count must be a multiple of 8")
    return np.packbits(bits, bitorder="little")


def uint_to_bits(value: int, num_bits: int) -> np.ndarray:
    """Integer -> LSB-first bits (int_to_bit of btle_tx.c:937-946, generalized)."""
    return np.array([(value >> i) & 1 for i in range(num_bits)], dtype=np.int8)


def bits_to_uint(bits) -> int:
    """LSB-first bits -> integer."""
    bits = np.asarray(bits).ravel()
    return int(sum(int(b) << i for i, b in enumerate(bits)))


def reverse_bits24(value: int) -> int:
    """Reverse the 24 bits of ``value`` (used by CRC init conversions)."""
    out = 0
    for _ in range(24):
        out = (out << 1) | (value & 1)
        value >>= 1
    return out


def swap_bytes24(value: int) -> int:
    """0xAABBCC -> 0xCCBBAA."""
    return ((value & 0xFF) << 16) | (value & 0xFF00) | ((value >> 16) & 0xFF)


def mac_bytes_to_str(mac: np.ndarray | bytes) -> str:
    """6 display-order bytes -> 'aa:bb:cc:dd:ee:ff'."""
    b = bytes(bytearray(np.asarray(mac, dtype=np.uint8)))
    return ":".join(f"{x:02x}" for x in b)


def mac_str_to_bytes(s: str) -> np.ndarray:
    """'AA:BB:CC:DD:EE:FF' or 12 hex chars -> 6 display-order bytes.

    Mirrors parse_mac_string (btle_rx.c:127-146).
    """
    s = s.strip().replace(":", "")
    if len(s) != 12:
        raise ValueError("MAC must have 6 octets")
    return np.frombuffer(bytes.fromhex(s), dtype=np.uint8).copy()
