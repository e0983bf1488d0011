"""``send-cmd`` of both packages in child processes: ``-n``, ``-c``,
``-a`` and ``-w`` to the port's UDP ControlServer on an ephemeral port
(no fixed port), then the same over ``--serial`` on a pseudo-terminal
pair read by the port's SerialControlServer. The register writes the
servers receive must be the ones sent, and the same from both
packages."""

import os
import pty
import subprocess
import sys
import time

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from btle_tpu_torch.stream.control import (REG_ACCESS_ADDR, REG_CHANNEL, REG_CRC_INIT,
                                           ControlServer)
from btle_tpu_torch.stream.hci import SerialControlServer

ARGS = ["-n", "12", "-c", "0xa77b22", "-a", "0x60850A1B"]


def _send(pkg, extra, tmp_path):
    regs = tmp_path / "regs.txt"
    regs.write_text("# register file\n3 7\n21 0x1234\n")
    r = subprocess.run([sys.executable, "-m", pkg, "send-cmd", *ARGS, "-w", str(regs),
                        *extra], capture_output=True, text=True, timeout=120,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    return r.stderr


def _drain(server, want: int, seconds: float = 10.0) -> list:
    got, deadline = [], time.time() + seconds
    while len(got) < want and time.time() < deadline:
        got += server.poll()
        time.sleep(0.01)
    return got


WANT = [(3, 7), (21, 0x1234), (REG_ACCESS_ADDR, 0x60850A1B), (REG_CHANNEL, 12),
        (REG_CRC_INIT, 0xA77B22)]


@pytest.mark.parametrize("pkg", ["btle_tpu", "btle_tpu_torch"])
def test_send_cmd_udp(pkg, tmp_path):
    server = ControlServer(0)
    try:
        err = _send(pkg, ["--port", str(server.port)], tmp_path)
        got = _drain(server, len(WANT))
    finally:
        server.close()
    assert f"sent 5 register write(s) to 127.0.0.1:{server.port}" in err
    assert sorted(got) == sorted(WANT)


@pytest.mark.parametrize("pkg", ["btle_tpu", "btle_tpu_torch"])
def test_send_cmd_serial(pkg, tmp_path):
    master, slave = pty.openpty()
    try:
        import tty

        tty.setraw(slave)
        server = SerialControlServer(master)
        err = _send(pkg, ["--serial", os.ttyname(slave)], tmp_path)
        got = _drain(server, len(WANT))
    finally:
        os.close(slave)
        os.close(master)
    assert "sent 5 register write(s) over serial" in err
    assert sorted(got) == sorted(WANT) and server.frame_errors == 0
