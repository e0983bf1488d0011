"""The port's receiver/transmitter subprocess wrappers
(btle_tpu_torch.cli.rx_proc) beside the JAX package's:
tests/test_rx_proc.py case for case. The fake-receiver pattern ($BTLE_RX
naming a script that cats a fixture) gives both packages' parsers the
same events; the real receiver is each package's own ``decode`` CLI in a
child process (the port's with ``--device cpu``) over a capture the
port's ``tx`` synthesizes, since the JAX test's USRP capture is not in
the repository; the transmitter writes the JAX package's file byte for
byte."""

import asyncio
import io
import json
import pathlib
import stat
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from btle_tpu.cli import rx_proc as jrx
from btle_tpu.cli import tui as jtui

from btle_tpu_torch.cli import rx_proc as trx
from btle_tpu_torch.cli import tui as ttui

ROOT = str(pathlib.Path(__file__).resolve().parent.parent)

FIXTURE_LINES = [
    {"v": 1, "t": "pkt", "ts": 1.0, "pkt": 1, "ch": 37, "aa": "8e89bed6",
     "crc_ok": True, "kind": "adv", "pdu_type": 0, "pdu_name": "ADV_IND",
     "tx_add": 0, "rx_add": 0, "plen": 9,
     "adv_a": "aa:bb:cc:dd:ee:ff",
     "payload_hex": "ffeeddccbbaa020106", "rssi_est": -55},
    {"v": 1, "t": "status", "ts": 1.1, "event": "stop", "board": "file",
     "ch": 37, "freq_hz": 2402000000, "gain": 0, "lna": 0, "amp": 0},
]


@pytest.fixture
def fake_rx(tmp_path, monkeypatch):
    fixture = tmp_path / "sample.ndjson"
    fixture.write_text("\n".join(json.dumps(x) for x in FIXTURE_LINES) + "\n")
    script = tmp_path / "fake_btle_rx"
    script.write_text(f"#!/bin/sh\ncat {fixture}\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("BTLE_RX", str(script))
    return script


@pytest.fixture
def real_cli(monkeypatch):
    monkeypatch.delenv("BTLE_RX", raising=False)
    monkeypatch.delenv("BTLE_TX", raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("PYTHONPATH", ROOT)


def _dumps(events):
    return [e.model_dump_json() for e in events]


class TestRxProcess:
    def test_command_override(self, fake_rx):
        opts = dict(bin_path="x.bin")
        cmd = trx.receiver_command(trx.RxOptions(**opts))
        assert cmd[0] == str(fake_rx)
        assert "--json" in cmd
        assert cmd == jrx.receiver_command(jrx.RxOptions(**opts))

    def test_default_command_is_the_ports_cli(self, monkeypatch):
        """Without $BTLE_RX: the JAX package's argv with the module name
        swapped; ``device`` adds --device and nothing else."""
        monkeypatch.delenv("BTLE_RX", raising=False)
        opts = dict(bin_path="x.i16", fmt="i16", channel=38, sps=4, access_addr="8e89bed6",
                    crc_init="555555", filter_adva="0a:0b:0c:0d:0e:0f", hop=True,
                    pcap="o.pcap", extra_args=["--verbose"])
        want = jrx.receiver_command(jrx.RxOptions(**opts))
        want[want.index("btle_tpu.cli")] = "btle_tpu_torch.cli"
        assert trx.receiver_command(trx.RxOptions(**opts)) == want
        got = trx.receiver_command(trx.RxOptions(**opts, device="cpu"))
        assert got == want[:-1] + ["--device", "cpu", "--verbose"]
        assert want[:2] == [sys.executable, "-m"]

    def test_stream_fake_receiver(self, fake_rx):
        from btle_tpu_torch.cli.events import PktEvent

        events = asyncio.run(trx.collect_events(trx.RxOptions(bin_path="ignored")))
        want = asyncio.run(jrx.collect_events(jrx.RxOptions(bin_path="ignored")))
        assert len(events) == 2
        assert isinstance(events[0], PktEvent)
        assert events[0].adv_a == "aa:bb:cc:dd:ee:ff"
        assert events[1].t == "status"
        assert _dumps(events) == _dumps(want)

    def test_stream_real_cli(self, real_cli, tmp_path):
        """Each package's decode CLI in a child process over the same
        capture: the same events, timestamps aside."""
        from btle_tpu_torch.golden import btle_tx
        from btle_tpu_torch.spec import bits as B

        pdu = bytes.fromhex("420f" + "060504030201" + "020106" + "05094c616d70")
        i, q, _ = btle_tx(B.bytes_to_bits(np.frombuffer(pdu, np.uint8)), 37, sps=4,
                          flavor="c")
        pad = np.zeros(4000, np.int16)
        ii = np.concatenate([pad, i.astype(np.int16) * 32, pad])
        qq = np.concatenate([pad, q.astype(np.int16) * 32, pad])
        path = tmp_path / "cap.i16"
        np.stack([ii, qq], axis=1).reshape(-1).tofile(path)
        opts = dict(bin_path=str(path), fmt="i16", channel=37, sps=4)
        events = asyncio.run(trx.collect_events(trx.RxOptions(**opts, device="cpu")))
        want = asyncio.run(jrx.collect_events(jrx.RxOptions(**opts)))

        def no_ts(evts):
            return [{k: v for k, v in e.model_dump().items() if k != "ts"} for e in evts]
        assert no_ts(events) == no_ts(want)
        pkts = [e for e in events if e.t == "pkt"]
        assert any(e.crc_ok for e in pkts)
        assert pkts[0].adv_a == "01:02:03:04:05:06"


class TestTui:
    def test_headless_aggregation(self, fake_rx):
        aggs = [mod_tui.run_headless(asyncio.run(mod_rx.collect_events(
            mod_rx.RxOptions(bin_path="ignored"))))
            for mod_rx, mod_tui in ((jrx, jtui), (trx, ttui))]
        for agg in aggs:
            assert len(agg.devices) == 1
            assert agg.devices["aa:bb:cc:dd:ee:ff"].last_rssi == -55
        assert aggs[1].devices["aa:bb:cc:dd:ee:ff"].pkt_count == \
            aggs[0].devices["aa:bb:cc:dd:ee:ff"].pkt_count


class TestTxProcess:
    def test_tx_subprocess(self, real_cli, tmp_path):
        desc = ["37-ADV_IND-TxAdd-1-RxAdd-0-AdvA-0A0B0C0D0E0F-AdvData-02010610"]
        outs = []
        for mod, extra in ((jrx, {}), (trx, {"device": "cpu"})):
            out = tmp_path / f"{mod.__name__.split('.')[0]}.bin"
            rc = asyncio.run(mod.run_tx(mod.TxOptions(descriptors=desc, out=str(out),
                                                      **extra)))
            assert rc == 0
            outs.append(out.read_bytes())
        assert len(outs[1]) > 0 and outs[1] == outs[0]


class TestStatusEvents:
    def test_start_stop_emitted(self):
        from btle_tpu.stream import NdjsonEmitter as JEmitter
        from btle_tpu.stream import Sniffer as JSniffer
        from btle_tpu.stream import SnifferConfig as JConfig
        from btle_tpu.stream import array_source as jsource

        from btle_tpu_torch.cli.events import parse_line
        from btle_tpu_torch.stream import NdjsonEmitter, Sniffer, SnifferConfig, array_source

        buf, jbuf = io.StringIO(), io.StringIO()
        zeros = np.zeros(100, np.int16)
        Sniffer(SnifferConfig(channel=37, sps=4), ndjson=NdjsonEmitter(buf), quiet_text=True,
                device="cpu").run(array_source(zeros, zeros))
        JSniffer(JConfig(channel=37, sps=4), ndjson=JEmitter(jbuf),
                 quiet_text=True).run(jsource(zeros, zeros))
        evs = [parse_line(line) for line in buf.getvalue().splitlines()]
        kinds = [e.event for e in evs if e is not None and e.t == "status"]
        assert kinds == ["start", "stop"]

        def no_ts(text):
            return [{k: v for k, v in json.loads(line).items() if k != "ts"}
                    for line in text.splitlines()]
        assert no_ts(buf.getvalue()) == no_ts(jbuf.getvalue())


def test_no_receiver_runs_on_the_cpu_unasked():
    """With device None the child gets no --device: the port's CLI then
    runs its scan on cuda (and refuses without a card)."""
    assert "--device" not in trx.RxOptions(bin_path="x").to_argv()
    assert "--device" not in trx.TxOptions(descriptors=["x"]).to_argv()
