"""The port's MCP tool bodies (btle_tpu_torch.cli.mcp_server), called
directly as tests/test_mcp_tools.py calls the JAX package's, case for
case: every tool's dict must equal btle_tpu's on the same inputs (the
decoding tools with ``device="cpu"``, the plain twins of K7 and K4), and
the JAX test's assertions then hold on the port's dict."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from btle_tpu.cli import mcp_server as J

from btle_tpu_torch.cli import mcp_server as T

ADV_A = "0a:0b:0c:0d:0e:0f"


def _capture(tmp_path, name, mfg_counter=0):
    """A two-packet ch37 capture through the descriptor DSL (i16)."""
    from btle_tpu.tx import parse_descriptor_sequence, synthesize

    mfg = f"ffff{mfg_counter:02x}42"
    desc = (f"37-DISCOVERY-TxAdd-0-RxAdd-0-AdvA-0a0b0c0d0e0f"
            f"-LOCAL_NAME09-Lamp-MANUF_DATA-{mfg}")
    specs, _ = parse_descriptor_sequence([desc, desc])
    pkts = synthesize(specs, flavor="c", sps=4)
    gap = np.zeros(4000, np.int16)
    i = np.concatenate([np.concatenate([p.i.astype(np.int16) * 32, gap]) for p in pkts])
    q = np.concatenate([np.concatenate([p.q.astype(np.int16) * 32, gap]) for p in pkts])
    inter = np.empty(2 * len(i), np.int16)
    inter[0::2] = i
    inter[1::2] = q
    path = tmp_path / name
    inter.tofile(path)
    return str(path)


class _Ticks:
    """A stand-in for the time module: time() steps 0.2 ms a call."""

    def __init__(self):
        self.t = 1715680000.0

    def time(self):
        self.t += 0.0002
        return self.t


@pytest.fixture(scope="module")
def iq_file(tmp_path_factory):
    return _capture(tmp_path_factory.mktemp("mcp"), "cap.bin")


def _pair(tool, *args, **kwargs):
    """The tool's dict from each package (the port's on the CPU), held
    equal; returns the port's."""
    want = getattr(J, tool)(*args, **kwargs)
    got = getattr(T, tool)(*args, **kwargs, device="cpu") if tool in DECODERS \
        else getattr(T, tool)(*args, **kwargs)
    assert got == want
    return got


DECODERS = {"ble_quickscan", "ble_profile", "ble_capture_to_pcap"}


class TestToolBodies:
    def test_quickscan(self, iq_file):
        out = _pair("ble_quickscan", iq_file, fmt="i16", channel=37, sps=4)
        assert out["n_devices"] == 1
        assert out["devices_top"][0]["adv_a"] == ADV_A
        assert out["devices_top"][0]["name"] == "Lamp"
        assert out["n_packets"] >= 2

    def test_profile(self, iq_file):
        out = _pair("ble_profile", ADV_A, iq_file=iq_file, fmt="i16", channel=37)
        assert out["adv_a"] == ADV_A
        assert out["name"] == "Lamp"
        assert out["mfg_id"] == 0xFFFF
        assert out["n_packets"] >= 2

    def test_capture_to_pcap_and_profile_from_pcap(self, iq_file, tmp_path, monkeypatch):
        import btle_tpu.stream.pcap as jpcap
        import btle_tpu_torch.stream.pcap as tpcap

        outs = []
        for mod, tag, extra, pcap_mod in ((J, "jax", {}, jpcap),
                                          (T, "port", {"device": "cpu"}, tpcap)):
            # both captures stamp their records from the same clock, so
            # the profiles' intervals compare whole
            monkeypatch.setattr(pcap_mod, "time", _Ticks())
            pcap = tmp_path / tag / "cap.pcap"
            out = mod.ble_capture_to_pcap(iq_file, str(pcap), fmt="i16", channel=37, **extra)
            out["pcap"] = out["pcap"].replace(tag, "")
            outs.append((out, mod.ble_profile(ADV_A, pcap=str(pcap)), pcap.exists()))
        assert outs[1] == outs[0]
        out, prof, exists = outs[1]
        assert out["n_crc_ok"] >= 2 and exists
        assert prof["name"] == "Lamp" and prof["avg_interval_ms"] > 0

    def test_diff_pcaps(self, iq_file, tmp_path):
        a = tmp_path / "a.pcap"
        b = tmp_path / "b.pcap"
        T.ble_capture_to_pcap(iq_file, str(a), fmt="i16", channel=37, device="cpu")
        other = _capture(tmp_path, "cap2.bin", mfg_counter=9)
        T.ble_capture_to_pcap(other, str(b), fmt="i16", channel=37, device="cpu")
        out = _pair("ble_diff_pcaps", str(a), str(b))
        assert out["common"] == 1
        assert ADV_A in out.get("payload_changed", {})

    def test_payload_entropy(self, tmp_path):
        from btle_tpu_torch.stream.pcap import PcapWriter

        pcap = tmp_path / "ctr.pcap"
        w = PcapWriter(pcap)
        adva_air = bytes.fromhex(ADV_A.replace(":", ""))[::-1]
        for k in range(4):
            mfg = bytes([0xFF, 0xFF, k, 0x42])
            ad = bytes([len(mfg) + 1, 0xFF]) + mfg
            payload = adva_air + ad
            w.write_packet(bytes([0x40, len(payload)]) + payload, 37, 0x8E89BED6, -50)
        w.close()
        out = _pair("ble_payload_entropy", str(pcap), ADV_A)
        assert out["n_samples"] == 4
        assert out["likely_counter_positions"] == [2]
        assert out["static_prefix_bytes"] == 2

    def test_iq_occupancy(self, tmp_path):
        fs, n = 8e6, 65536
        t = np.arange(n) / fs
        z = 80 * np.exp(1j * 2 * np.pi * 1e6 * t)
        iq = np.empty(2 * n, np.int16)
        iq[0::2], iq[1::2] = z.real, z.imag
        path = tmp_path / "tone.bin"
        iq.tofile(path)
        out = _pair("ble_iq_occupancy", str(path), "i16", center_hz=2.402e9)
        assert out["n_samples"] == n and out["n_occupied"] >= 1
        top = out["occupied_bins"][0]
        assert abs(top["freq_offset_hz"] - 1e6) < fs / 256
        assert abs(top["freq_hz"] - 2.403e9) < fs / 256
        assert top["duty"] > 0.9

    def test_gatt_report(self, tmp_path):
        from btle_tpu_torch.stream.pcap import PcapWriter

        att = bytes([0x1B, 0x2A, 0x00]) + b"\x45"
        frame = len(att).to_bytes(2, "little") + (4).to_bytes(2, "little") + att
        pdu = bytes([0x02, len(frame)]) + frame
        path = tmp_path / "g.pcap"
        w = PcapWriter(str(path))
        w.write_packet(pdu, 9, 0x60850A1B)
        w.close()
        out = _pair("ble_gatt_report", str(path))
        assert out["n_data_pdus"] == 1
        assert out["ops"][0]["name"] == "ATT_HANDLE_VALUE_NTF"
        assert out["ops"][0]["handle"] == 0x2A

    def test_tool_registry_complete(self):
        names = [t.__name__ for t in T.TOOLS]
        assert names == [t.__name__ for t in J.TOOLS]
        assert set(names) == {"ble_quickscan", "ble_profile", "ble_capture_to_pcap",
                              "ble_diff_pcaps", "ble_payload_entropy",
                              "ble_iq_occupancy", "ble_gatt_report"}


def test_decoding_tools_refuse_the_cpu_unasked(iq_file, monkeypatch):
    """Without ``device`` a decoding tool runs on cuda, and without a card
    it raises rather than dropping to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.ble_quickscan(iq_file)


def test_server_needs_the_mcp_package(monkeypatch, capsys):
    """``main`` prints the JAX package's line and returns 1 where the
    optional ``mcp`` package is missing (it is imported only in
    build_server)."""
    import sys

    monkeypatch.setitem(sys.modules, "mcp", None)
    codes = [J.main(), T.main()]
    err = capsys.readouterr().err.splitlines()
    assert codes == [1, 1]
    assert err[0] == err[1] == ("mcp package not installed; `pip install mcp` to use "
                                "the server")
