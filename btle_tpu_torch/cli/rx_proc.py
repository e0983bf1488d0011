"""Async subprocess wrapper around an NDJSON-emitting receiver.

Mirror of btle_cli.rx_proc: spawn a receiver process (by default this
package's own CLI decoding a capture; any program emitting schema-v1
NDJSON works — including the reference btle_rx), parse its stdout into
events. The executable is discoverable via $BTLE_RX, preserving the
reference's fake-receiver test pattern (tests/test_rx_proc.py of btle_cli:
a shell script that cats a fixture).

Port of btle_tpu.cli.rx_proc: the default receiver and transmitter are
``python -m btle_tpu_torch.cli``, whose scans run on the CUDA card;
``RxOptions.device`` / ``TxOptions.device`` add ``--device`` to the argv
(with None the argv is the JAX package's word for word).
"""

from __future__ import annotations

import asyncio
import os
import shlex
import sys
from dataclasses import dataclass, field
from typing import AsyncIterator, Optional

from .events import Event, parse_line


@dataclass
class RxOptions:
    """Receiver options; maps to this package's `decode` subcommand."""

    bin_path: str = "-"
    fmt: str = "i16"
    channel: int = 37
    sps: int = 4
    access_addr: Optional[str] = None
    crc_init: Optional[str] = None
    filter_adva: Optional[str] = None
    hop: bool = False
    rssi: bool = True
    pcap: Optional[str] = None
    extra_args: list[str] = field(default_factory=list)
    device: Optional[str] = None

    def to_argv(self) -> list[str]:
        argv = ["decode", "--bin", self.bin_path, "--format", self.fmt,
                "--channel", str(self.channel), "--sps", str(self.sps),
                "--json", "--quiet-text"]
        if self.access_addr:
            argv += ["--access-addr", self.access_addr]
        if self.crc_init:
            argv += ["--crc-init", self.crc_init]
        if self.filter_adva:
            argv += ["--filter-adva", self.filter_adva]
        if self.hop:
            argv.append("--hop")
        if self.rssi:
            argv.append("--rssi")
        if self.pcap:
            argv += ["--pcap", self.pcap]
        if self.device:
            argv += ["--device", self.device]
        return argv + self.extra_args


def receiver_command(options: RxOptions) -> list[str]:
    """Build the receiver argv. $BTLE_RX overrides the executable (it
    receives the decode argv verbatim — a fake for tests, or a wrapper
    around other receivers)."""
    override = os.environ.get("BTLE_RX")
    if override:
        return shlex.split(override) + options.to_argv()
    return [sys.executable, "-m", "btle_tpu_torch.cli"] + options.to_argv()


class RxProcess:
    """Async receiver subprocess with an event stream."""

    def __init__(self, options: RxOptions):
        self.options = options
        self.proc: Optional[asyncio.subprocess.Process] = None

    async def start(self):
        cmd = receiver_command(self.options)
        self.proc = await asyncio.create_subprocess_exec(
            *cmd,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.DEVNULL,
        )
        return self

    async def stream(self) -> AsyncIterator[Event]:
        """Yield parsed events until the process's stdout closes."""
        assert self.proc is not None, "call start() first"
        assert self.proc.stdout is not None
        while True:
            line = await self.proc.stdout.readline()
            if not line:
                break
            evt = parse_line(line.decode("utf-8", errors="replace"))
            if evt is not None:
                yield evt

    async def stop(self):
        if self.proc and self.proc.returncode is None:
            self.proc.terminate()
            try:
                await asyncio.wait_for(self.proc.wait(), timeout=5)
            except asyncio.TimeoutError:
                self.proc.kill()
                await self.proc.wait()

    async def wait(self) -> int:
        assert self.proc is not None
        return await self.proc.wait()


async def collect_events(options: RxOptions, limit: int | None = None) -> list[Event]:
    """Run a receiver to completion and return its events."""
    proc = await RxProcess(options).start()
    out: list[Event] = []
    try:
        async for evt in proc.stream():
            out.append(evt)
            if limit is not None and len(out) >= limit:
                break
    finally:
        await proc.stop()
    return out


@dataclass
class TxOptions:
    """Transmitter options; maps to the `tx` subcommand (tx_proc parity)."""

    descriptors: list[str] = field(default_factory=list)
    file: Optional[str] = None
    out: str = "/tmp/btle_tx.bin"
    out_format: str = "f32"
    repeat: Optional[int] = None
    device: Optional[str] = None

    def to_argv(self) -> list[str]:
        argv = ["tx", *self.descriptors, "--out", self.out,
                "--out-format", self.out_format]
        if self.file:
            argv += ["--file", self.file]
        if self.repeat is not None:
            argv += ["--repeat", str(self.repeat)]
        if self.device:
            argv += ["--device", self.device]
        return argv


async def run_tx(options: TxOptions) -> int:
    """Run the transmitter subprocess to completion ($BTLE_TX overrides
    the executable, mirroring the receiver pattern)."""
    override = os.environ.get("BTLE_TX")
    if override:
        cmd = shlex.split(override) + options.to_argv()
    else:
        cmd = [sys.executable, "-m", "btle_tpu_torch.cli"] + options.to_argv()
    proc = await asyncio.create_subprocess_exec(
        *cmd, stdout=asyncio.subprocess.DEVNULL,
        stderr=asyncio.subprocess.DEVNULL)
    return await proc.wait()
