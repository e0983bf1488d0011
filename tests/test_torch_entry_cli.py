"""The port's package entry point and its wideband LE Coded CLI, in child
processes on the CPU, beside the JAX package's CLI.

``python -m btle_tpu_torch`` runs the CLI as ``python -m btle_tpu`` does
(the shim ``btle_tpu_torch/__main__.py``); ``wideband --phy coded8`` on a
coded 80 Msps capture (tests/test_coded.py's TestCli scene, with
wideband noise) prints the JAX package's lines.
"""

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


@pytest.mark.parametrize("pkg", ["btle_tpu", "btle_tpu_torch"])
def test_package_entry_point(pkg):
    top = _run(pkg, "--help")
    for cmd in ("decode", "wideband", "tx", "ber"):
        assert cmd in top
    sub = _run(pkg, "decode", "--help")
    assert "--phy" in sub and "coded8" in sub


def test_wideband_coded_roundtrip_equals_jax(tmp_path):
    out = tmp_path / "wbc.bin"
    _run("btle_tpu_torch", "tx",
         "17-LL_DATA-AA-8E89BED6-LLID-1-NESN-0-SN-0-MD-0-DATA-CAFE"
         "-CRCInit-555555-Space-1", "--phy", "coded8", "--wideband-out",
         str(out), "--wideband-noise", "2", "--device", "cpu")
    scan = ("wideband", "--bin", str(out), "--phy", "coded8")
    got = _run("btle_tpu_torch", *scan, "--device", "cpu").splitlines()
    assert got == _run("btle_tpu", *scan).splitlines()
    ok = [ln for ln in got if " crc0 " in ln]
    assert ok and all(ln.startswith("ch17") for ln in ok)
    assert ok[0].endswith("0102cafe")
