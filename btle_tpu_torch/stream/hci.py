"""Serial/UART HCI transport: the byte-stream control path of the chip.

The reference chip exposes a second host interface besides raw Ethernet:
a byte-level UART HCI into the link-layer register file
(verilog/btle_ll.v:50-60 — uart_frame_tx/rx serialize one byte with
start/stop bits and optional parity; the host writes TX bytes through
slv_reg47 and polls RX bytes + frame_error through slv_reg63). This
module is the TPU framework's capability equivalent, in two layers:

* ``UartFramer`` — the bit-level 8N1/8E1/8O1 serializer itself
  (uart_frame_tx.v / uart_frame_rx.v semantics: LSB-first data bits
  between a 0 start bit and a 1 stop bit, optional parity bit, per-frame
  parity error detection). It runs over level streams so the Verilog
  testbench vectors and property tests exercise the same waveform
  contract the RTL implements.

* ``HciFrameCodec`` + ``SerialControlServer`` — a minimal message frame
  over any byte pipe (a real serial device, a pty, a socketpair):
  ``0xB7 0xE5 | len u16le | payload | crc8`` where the payload carries
  the SAME little-endian [cmd, reg_idx, reg_val] u32 triplets as the
  UDP control channel (stream/control.py, ble_send_cmd.c:143-176) — one
  register protocol, two transports, like the chip's AXI-vs-UART pair.
  Bad sync/len/crc bytes are skipped byte-by-byte (resync), mirroring
  the UART's frame_error recovery.

A running sniffer polls ``SerialControlServer.poll()`` between blocks
exactly like the UDP ControlServer — the two are drop-in alternates.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .control import decode_reg_writes, encode_reg_writes

SYNC = b"\xb7\xe5"


def crc8(data: bytes, poly: int = 0x07, init: int = 0x00) -> int:
    """CRC-8 (ATM/CCITT polynomial x^8+x^2+x+1), MSB-first."""
    state = init
    for b in data:
        state ^= b
        for _ in range(8):
            state = ((state << 1) ^ poly) & 0xFF if state & 0x80 \
                else (state << 1) & 0xFF
    return state


# ---------------------------------------------------------------------------
# bit-level UART serializer (uart_frame_tx.v / uart_frame_rx.v semantics)
# ---------------------------------------------------------------------------

@dataclass
class UartFramer:
    """8N1/8E1/8O1 byte <-> line-level serializer.

    Levels are int8 arrays of 0/1 at one sample per bit time (the RTL
    oversamples each bit and votes on the middle samples,
    uart_frame_rx.v:2322-2400; at one sample/bit the vote is the
    sample). The line idles high; a frame is [start=0][8 data bits,
    LSB first][parity?][stop=1].
    """

    parity: str = "none"            # "none" | "even" | "odd"

    @property
    def frame_bits(self) -> int:
        return 10 + (self.parity != "none")

    def _parity_bit(self, byte: int) -> int:
        ones = bin(byte & 0xFF).count("1")
        return (ones % 2) ^ (0 if self.parity == "even" else 1)

    def encode(self, data: bytes, idle_bits: int = 2) -> np.ndarray:
        """bytes -> line levels (int8 0/1), idle_bits of 1 between frames."""
        out = [np.ones(idle_bits, np.int8)]
        for b in data:
            bits = [0] + [(b >> k) & 1 for k in range(8)]
            if self.parity != "none":
                bits.append(self._parity_bit(b))
            bits.append(1)
            out.append(np.asarray(bits, np.int8))
            out.append(np.ones(idle_bits, np.int8))
        return np.concatenate(out)

    def decode(self, levels: np.ndarray) -> tuple[bytes, int]:
        """line levels -> (bytes, frame_errors).

        A frame starts at every 1->0 transition from idle; a parity
        mismatch or a low stop bit counts as a frame error and the
        byte is dropped (btle_ll.v surfaces the same through
        slv_reg63's frame_error flag)."""
        levels = np.asarray(levels).astype(np.int8)
        out = bytearray()
        errors = 0
        i = 0
        n = len(levels)
        fb = self.frame_bits
        while i < n - 1:
            if not (levels[i] == 1 and levels[i + 1] == 0):
                i += 1
                continue
            start = i + 1
            if start + fb > n:
                break
            frame = levels[start : start + fb]
            byte = 0
            for k in range(8):
                byte |= int(frame[1 + k]) << k
            ok = frame[-1] == 1
            if self.parity != "none":
                ok = ok and int(frame[9]) == self._parity_bit(byte)
            if ok:
                out.append(byte)
            else:
                errors += 1
            i = start + fb - 1   # stop bit doubles as the next idle level
        return bytes(out), errors


# ---------------------------------------------------------------------------
# message framing over a byte pipe
# ---------------------------------------------------------------------------

class HciFrameCodec:
    """``SYNC | len u16le | payload | crc8(payload)`` with byte-resync."""

    def __init__(self):
        self._buf = bytearray()
        self.frame_errors = 0

    @staticmethod
    def encode(payload: bytes) -> bytes:
        if len(payload) > 0xFFFF:
            raise ValueError("payload too long")
        return (SYNC + len(payload).to_bytes(2, "little") + payload
                + bytes([crc8(payload)]))

    def feed(self, data: bytes) -> list[bytes]:
        """Append received bytes; return every complete valid payload."""
        self._buf.extend(data)
        out = []
        while True:
            i = self._buf.find(SYNC)
            if i < 0:
                # keep a possible split sync byte
                del self._buf[: max(0, len(self._buf) - 1)]
                return out
            if i:
                del self._buf[:i]
                self.frame_errors += 1   # garbage before sync
            if len(self._buf) < 4:
                return out
            ln = int.from_bytes(self._buf[2:4], "little")
            if len(self._buf) < 4 + ln + 1:
                return out
            payload = bytes(self._buf[4 : 4 + ln])
            ok = self._buf[4 + ln] == crc8(payload)
            if ok:
                out.append(payload)
                del self._buf[: 4 + ln + 1]
            else:
                self.frame_errors += 1
                del self._buf[:2]        # resync past this sync marker
        return out


class SerialControlServer:
    """Drop-in alternate for stream.control.ControlServer over a byte fd.

    ``fd`` is any readable file descriptor delivering the framed stream
    (a serial device, a pty master, one end of a socketpair). poll() is
    non-blocking and returns [(reg_idx, reg_val), ...] like the UDP
    server; unknown registers accumulate in ``registers``.
    """

    def __init__(self, fd: int):
        self.fd = fd
        os.set_blocking(fd, False)
        self.codec = HciFrameCodec()
        self.registers: dict[int, int] = {}
        self.writes_seen = 0

    def poll(self) -> list[tuple[int, int]]:
        chunks = []
        while True:
            try:
                data = os.read(self.fd, 65536)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                break
            if not data:
                break
            chunks.append(data)
        writes = []
        for payload in self.codec.feed(b"".join(chunks)):
            writes.extend(decode_reg_writes(payload))
        for idx, val in writes:
            self.registers[idx] = val
        self.writes_seen += len(writes)
        return writes

    def apply(self, target) -> int:
        writes = self.poll()
        if writes:
            target.apply_control_registers(writes)
        return len(writes)

    @property
    def frame_errors(self) -> int:
        return self.codec.frame_errors


def send_command_serial(fd: int, *, channel: int | None = None,
                        crc_init: int | None = None,
                        access_addr: int | None = None,
                        regs=None) -> int:
    """Client side over a byte fd (the serial ble_send_cmd)."""
    from .control import REG_ACCESS_ADDR, REG_CHANNEL, REG_CRC_INIT

    writes = list(regs or [])
    if access_addr is not None:
        writes.append((REG_ACCESS_ADDR, access_addr))
    if channel is not None:
        writes.append((REG_CHANNEL, channel))
    if crc_init is not None:
        writes.append((REG_CRC_INIT, crc_init))
    if not writes:
        return 0
    os.write(fd, HciFrameCodec.encode(encode_reg_writes(writes)))
    return len(writes)
