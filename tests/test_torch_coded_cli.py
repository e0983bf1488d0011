"""The port's narrowband LE Coded CLI path, in child processes on the
CPU, beside the JAX package's CLI on the same files: ``tx --phy
coded8|coded2`` writes the JAX package's bytes, and ``decode --phy ...``
on them prints the JAX package's lines (text and NDJSON, ``ts`` aside).
tests/test_coded.py's TestCli scene; the wideband coded CLI and the
package entry point are in test_torch_entry_cli.py.
"""

import json
import subprocess
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")


def _run(*args, timeout=180):
    r = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                       text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr
    return r.stdout


def _ndjson(text):
    out = []
    for ln in text.splitlines():
        ev = json.loads(ln)
        ev.pop("ts", None)
        out.append(ev)
    return out


@pytest.mark.parametrize("phy", ["coded8", "coded2"])
def test_tx_decode_loopback_equals_jax(tmp_path, phy):
    desc = "37-ADV_IND-TxAdd-0-RxAdd-0-AdvA-0A0B0C0D0E0F-AdvData-0011-Space-1"
    port, ref = tmp_path / "t.bin", tmp_path / "j.bin"
    _run("btle_tpu_torch", "tx", desc, "--phy", phy, "--out", str(port),
         "--device", "cpu")
    _run("btle_tpu", "tx", desc, "--phy", phy, "--out", str(ref))
    assert port.read_bytes() == ref.read_bytes()
    dec = ("decode", "--bin", str(port), "--format", "f32", "--phy", phy,
           "--channel", "37")
    text = _run("btle_tpu_torch", *dec, "--device", "cpu")
    assert text == _run("btle_tpu", *dec)
    assert " crc0 " in text and f"S={phy[-1]}" in text
    assert "0f0e0d0c0b0a0011" in text
    evs = _ndjson(_run("btle_tpu_torch", *dec, "--json", "--device", "cpu"))
    assert evs == _ndjson(_run("btle_tpu", *dec, "--json"))
    assert evs[0]["kind"] == "adv" and evs[0]["crc_ok"]
    assert evs[0]["adv_a"] == "0a:0b:0c:0d:0e:0f"
