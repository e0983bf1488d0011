"""Live runtime control channel: retune a RUNNING sniffer from outside.

Capability parity with the reference's host->board control path
(host/ble_fpga_ctl/ble_send_cmd.c:1-438, usage fpga/README.md:69-77):
an external process changes the receiver's channel, CRC init and access
address — and arbitrary registers from a register file — while the
receive loop keeps running. The reference ships 3x u32 words
[cmd=0, reg_idx, reg_val] per write over raw Ethernet (ethertype 0x88B5,
reg_write ble_send_cmd.c:143-176); here the same little-endian word
triplets ride UDP datagrams (the transport this runtime already uses for
IQ ingest) so no raw-socket privileges are needed.

Register map (ble_send_cmd.c:340-363):
  10  access address
  11  channel number
  12  CRC init (LFSR/display order, as the -c flag takes it)

A datagram may carry several triplets back to back; unknown registers
are kept in ``ControlServer.registers`` for application-defined use.
"""

from __future__ import annotations

import socket
import struct

CMD_REG_WRITE = 0
REG_ACCESS_ADDR = 10
REG_CHANNEL = 11
REG_CRC_INIT = 12

_WORDS = struct.Struct("<3I")


def encode_reg_writes(writes) -> bytes:
    """[(reg_idx, reg_val), ...] -> one datagram payload."""
    return b"".join(
        _WORDS.pack(CMD_REG_WRITE, idx & 0xFFFFFFFF, val & 0xFFFFFFFF)
        for idx, val in writes
    )


def decode_reg_writes(payload: bytes):
    """Datagram payload -> [(reg_idx, reg_val), ...]; trailing garbage and
    non-write commands are ignored (forward compatibility)."""
    out = []
    for off in range(0, len(payload) - _WORDS.size + 1, _WORDS.size):
        cmd, idx, val = _WORDS.unpack_from(payload, off)
        if cmd == CMD_REG_WRITE:
            out.append((idx, val))
    return out


def parse_register_file(path) -> list[tuple[int, int]]:
    """reg_idx/reg_val pairs, one per line; decimal or 0x-hex; ``#``
    comments (ble_send_cmd.c parse_register_file:200-301)."""
    writes = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            body = line.split("#", 1)[0].strip()
            if not body:
                continue
            parts = body.split()
            if len(parts) != 2:
                raise ValueError(f"{path}:{lineno}: expected 'reg_idx reg_val'")
            writes.append((int(parts[0], 0), int(parts[1], 0)))
    return writes


def send_command(port: int, host: str = "127.0.0.1", *,
                 channel: int | None = None, crc_init: int | None = None,
                 access_addr: int | None = None,
                 regs=None) -> int:
    """Client side (the ble_send_cmd tool as a function). Returns the
    number of register writes sent."""
    writes = list(regs or [])
    if access_addr is not None:
        writes.append((REG_ACCESS_ADDR, access_addr))
    if channel is not None:
        writes.append((REG_CHANNEL, channel))
    if crc_init is not None:
        writes.append((REG_CRC_INIT, crc_init))
    if not writes:
        return 0
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.sendto(encode_reg_writes(writes), (host, port))
    finally:
        s.close()
    return len(writes)


class ControlServer:
    """Non-blocking UDP command sink polled by a running receive loop.

    The sniffer calls ``apply(target)`` between blocks: pending register
    writes are drained and pushed onto the target via its
    ``apply_control_registers`` method. Unknown registers accumulate in
    ``self.registers`` (the FPGA register file analog)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host, port))
        self.sock.setblocking(False)
        self.port = self.sock.getsockname()[1]
        self.registers: dict[int, int] = {}
        self.writes_seen = 0

    def poll(self) -> list[tuple[int, int]]:
        writes = []
        while True:
            try:
                payload, _ = self.sock.recvfrom(65536)
            except BlockingIOError:
                break
            writes.extend(decode_reg_writes(payload))
        for idx, val in writes:
            self.registers[idx] = val
        self.writes_seen += len(writes)
        return writes

    def apply(self, target) -> int:
        """Drain pending writes into ``target``; returns count applied."""
        writes = self.poll()
        if writes:
            target.apply_control_registers(writes)
        return len(writes)

    def close(self):
        self.sock.close()
