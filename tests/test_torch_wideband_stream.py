"""The port's wideband streaming (WidebandStreamRunner, the native ring of
btle_tpu_torch.runtime, the ``wideband`` CLI) against the JAX package:
NDJSON line for line and pcap records equal apart from timestamps,
run_live over both packages' rings, both CLIs on one capture, and the
port's CLI over live UDP ingest against its file run.
"""

import io
import json
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from btle_tpu import runtime as jruntime
from btle_tpu.stream.ndjson import NdjsonEmitter as JNdjson
from btle_tpu.stream.pcap import PcapWriter as JPcap
from btle_tpu.wideband import WidebandConfig as JConfig
from btle_tpu.wideband import WidebandSniffer as JSniffer
from btle_tpu.wideband import synthesize_wideband
from btle_tpu.wideband.stream import WidebandStreamRunner as JRunner

from btle_tpu_torch import runtime
from btle_tpu_torch.cli.app import main as cli_main
from btle_tpu_torch.stream import NdjsonEmitter, PcapWriter
from btle_tpu_torch.wideband import WidebandConfig, WidebandSniffer
from btle_tpu_torch.wideband.stream import WidebandStreamRunner
from test_wideband_stream import _scene

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
BLOCK = 8192 * 20


def _lines(text):
    out = []
    for line in text.splitlines():
        obj = json.loads(line)
        obj.pop("ts")
        out.append(obj)
    return out


def _pcap_records(raw):
    """Record bodies of a pcap stream, the per-record timestamps dropped."""
    out, off = [], 24
    assert raw[:24] and len(raw) >= 24
    while off + 16 <= len(raw):
        caplen = int.from_bytes(raw[off + 8: off + 12], "big")
        out.append(raw[off + 8: off + 16 + caplen])
        off += 16 + caplen
    return raw[:24], out


def _runners(cfg_kw, mode="plain"):
    jbuf, jpc, buf, pc = io.StringIO(), io.BytesIO(), io.StringIO(), io.BytesIO()
    port_kw = dict(cfg_kw) if mode == "plain" else dict(cfg_kw, fused=True,
                                                         fused_dtype=mode)
    jr = JRunner(JSniffer(JConfig(**cfg_kw)), ndjson=JNdjson(jbuf), pcap=JPcap(jpc))
    tr = WidebandStreamRunner(WidebandSniffer(WidebandConfig(**port_kw), device="cpu"),
                              ndjson=NdjsonEmitter(buf), pcap=PcapWriter(pc))
    return (jr, jbuf, jpc), (tr, buf, pc)


@pytest.fixture(scope="module")
def follow_scene():
    return _scene(np.random.default_rng(3), 2 * BLOCK)


@pytest.mark.parametrize("mode", ["plain", "f32"])
def test_ndjson_and_pcap_equal_jax(follow_scene, mode):
    wi, wq = follow_scene
    outs = []
    for runner, buf, pc in _runners(dict(follow_connections=True), mode):
        runner.start()
        pkts = runner.run_capture(wi, wq)
        runner.stop()
        outs.append((_lines(buf.getvalue()), _pcap_records(pc.getvalue()),
                     runner.stats.crc_ok))
        assert any(p.crc_ok and p.channel == 9 for p in pkts)
    assert outs[0] == outs[1]
    kinds = {(o["t"], o.get("event")) for o in outs[1][0]}
    assert ("hop", "track_start") in kinds and ("status", "stop") in kinds


def test_truncation_status_equal_jax():
    from test_wideband import make_channel_burst

    rng = np.random.default_rng(5)
    bursts, gap = [], np.zeros(6000, np.float32)
    for _ in range(8):
        (bi, bq), _ = make_channel_burst(rng, 9, n_payload=6)
        bursts.append((bi, bq))
    sig_i = np.concatenate([x for b in bursts for x in (b[0], gap)])
    sig_q = np.concatenate([x for b in bursts for x in (b[1], gap)])
    wi, wq = synthesize_wideband({9: (sig_i, sig_q)}, len(sig_i) + 120000, {9: 4000})
    outs = []
    for runner, buf, _ in _runners(dict(max_candidates=2), "f32"):
        pkts = runner.run_capture(wi, wq)
        assert sum(p.crc_ok for p in pkts) == 8
        outs.append((_lines(buf.getvalue()), runner.stats.truncate_rescans))
    assert outs[0] == outs[1] and outs[1][1] > 0
    assert any(o.get("event") == "truncate" for o in outs[1][0])


def _int16_pairs(wi, wq, pad):
    inter = np.zeros(2 * (len(wi) + pad), np.int16)
    inter[0: 2 * len(wi): 2] = np.clip(np.round(wi * 256), -32768, 32767)
    inter[1: 2 * len(wi): 2] = np.clip(np.round(wq * 256), -32768, 32767)
    return inter


@pytest.mark.parametrize("pipeline", [1, 2, 3])
def test_run_live_equal_jax(follow_scene, pipeline):
    if not (runtime.available() and jruntime.available()):
        pytest.skip("the native runtime did not build (no g++)")
    wi, wq = follow_scene
    inter = _int16_pairs(wi, wq, BLOCK)
    outs = []
    for (runner, buf, _), mod in zip(_runners(dict(follow_connections=True)),
                                     (jruntime, runtime)):
        ring = mod.IqRingBuffer(1 << 22)
        assert ring.write(inter, "i16") == len(inter) // 2
        halo = runner.sn.halo_ch * 20
        stats = runner.run_live(ring, pipeline=pipeline, scale=1.0 / 256,
                                should_stop=lambda: ring.available_pairs < BLOCK + halo)
        ring.close()
        assert stats.dropped_pairs == 0 and stats.blocks == 2
        outs.append(_lines(buf.getvalue()))
    assert outs[0] == outs[1]
    # the re-keyed data channels reach the block after the CONNECT_REQ's
    # only without pipelining (re-keying lags pipeline - 1 blocks)
    data = [o for o in outs[1] if o["t"] == "pkt" and o["ch"] == 9 and o["crc_ok"]]
    assert len(data) == (1 if pipeline == 1 else 0)


def _cli(module, *args):
    proc = subprocess.run([sys.executable, "-m", module, "wideband", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def test_cli_json_follow_equal_jax(follow_scene, tmp_path):
    wi, wq = follow_scene
    inter = np.empty(2 * len(wi), np.float32)
    inter[0::2], inter[1::2] = wi, wq
    capture = tmp_path / "air.f32"
    inter.tofile(capture)
    outs = []
    for module, extra in (("btle_tpu.cli", []), ("btle_tpu_torch.cli", ["--device", "cpu"])):
        pcap = tmp_path / f"{module}.pcap"
        proc = _cli(module, "--bin", str(capture), "--json", "--follow",
                    "--pcap", str(pcap), *extra)
        outs.append((_lines(proc.stdout), _pcap_records(pcap.read_bytes())))
        assert "followed connection AA 60850a1b" in proc.stderr
    assert outs[0] == outs[1]
    assert any(o["t"] == "hop" for o in outs[1][0])


def _free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_live_udp_equals_file_run(follow_scene, tmp_path):
    """UDP datagrams -> the port's native ring -> run_live -> NDJSON, via
    the CLI: the same packet and hop lines as the CLI's file run of the
    same int16 samples."""
    if not runtime.available():
        pytest.skip("the native runtime did not build (no g++)")
    wi, wq = follow_scene
    inter = _int16_pairs(wi, wq, BLOCK)
    capture = tmp_path / "air.i16"
    inter.tofile(capture)
    common = ["--format", "i16", "--json", "--follow", "--device", "cpu"]
    file_run = _cli("btle_tpu_torch.cli", "--bin", str(capture), *common)

    port = _free_udp_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "btle_tpu_torch.cli", "wideband", "--live",
         "--udp", str(port), "--seconds", "10", "--pipeline", "1", *common],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        while True:
            line = proc.stderr.readline()
            assert line, "the live CLI exited before listening"
            if line.startswith("# live:"):
                break
        raw = inter.tobytes()
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
            for off in range(0, len(raw), 32768):
                sock.sendto(raw[off: off + 32768], ("127.0.0.1", port))
                time.sleep(0.002)
        out, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 0, err
    assert "0 ring drops" in err

    def events(text):
        return [o for o in _lines(text) if o["t"] in ("pkt", "hop")]
    live = events(out)
    assert live == events(file_run.stdout)
    assert any(o["t"] == "pkt" and o["ch"] == 9 and o["crc_ok"] for o in live)


def test_cli_refuses_unported_options(tmp_path):
    """Following on the coded PHY is refused; --ltk, refused until the
    port had ll/crypto.py, now runs (tests/test_torch_llcrypto.py holds
    its decryption against btle_tpu's)."""
    capture = tmp_path / "air.f32"
    np.zeros(2 * BLOCK, np.float32).tofile(capture)
    with pytest.raises(SystemExit, match="finite captures"):
        cli_main(["wideband", "--bin", str(capture), "--device", "cpu",
                  "--phy", "coded8", "--follow"])
    assert cli_main(["wideband", "--bin", str(capture), "--device", "cpu",
                     "--json", "--ltk", "00" * 16]) == 0
