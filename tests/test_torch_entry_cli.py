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


SUBCOMMANDS = ("decode", "scan", "wideband", "tx", "analyze", "iq-show", "recon", "ber",
               "tui", "send-cmd", "mcp")


def _app(pkg):
    import importlib

    return importlib.import_module(f"{pkg}.cli.app")


@pytest.mark.parametrize("pkg", ["btle_tpu", "btle_tpu_torch"])
def test_app_layer_subcommands(pkg, capsys, monkeypatch):
    """Both CLIs have the same eleven subcommands; ``tui --help`` and
    ``send-cmd --help`` print their options, and ``mcp`` prints the
    not-installed line and returns 1 where the mcp package is missing
    (in this process: the parser and main of each package)."""
    import sys

    app = _app(pkg)
    choices = app.build_parser()._subparsers._group_actions[0].choices
    assert set(choices) == set(SUBCOMMANDS)
    for cmd, flags in (("tui", ("--seconds", "--bin", "--channel")),
                       ("send-cmd", ("--serial", "--port", "--register-file"))):
        with pytest.raises(SystemExit) as exit_:
            app.main([cmd, "--help"])
        assert exit_.value.code == 0
        out = capsys.readouterr().out
        assert all(f in out for f in flags), (cmd, out)
        if pkg == "btle_tpu_torch" and cmd == "tui":
            assert "--device" in out
    monkeypatch.setitem(sys.modules, "mcp", None)
    assert app.main(["mcp"]) == 1
    assert "mcp package not installed" in capsys.readouterr().err
