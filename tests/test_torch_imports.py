"""The PyTorch port imports no JAX and nothing of the JAX package, and
none of the JAX package's other dependencies (pydantic, cryptography;
matplotlib, curses and mcp only inside the functions that need them).

tests/conftest.py imports jax into this process, so the import check
runs every port module (and chip_smoke.py) in a fresh subprocess; a
static scan of the sources backs it up.
"""

import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_MODULES = [
    "btle_tpu_torch",
    "btle_tpu_torch._build",
    "btle_tpu_torch._device",
    "btle_tpu_torch.convert",
    "btle_tpu_torch.dist",
    "btle_tpu_torch.dist.dryrun",
    "btle_tpu_torch.dist.multihost",
    "btle_tpu_torch.dist.shard",
    "btle_tpu_torch.spec",
    "btle_tpu_torch.spec.coded",
    "btle_tpu_torch.golden",
    "btle_tpu_torch.ll",
    "btle_tpu_torch.ll.crypto",
    "btle_tpu_torch.ll.extchain",
    "btle_tpu_torch.ll.hop",
    "btle_tpu_torch.ll.l2cap",
    "btle_tpu_torch.ll.multifollow",
    "btle_tpu_torch.phy",
    "btle_tpu_torch.phy.modulator",
    "btle_tpu_torch.phy.scan_kernel",
    "btle_tpu_torch.phy.tables",
    "btle_tpu_torch.phy.viterbi",
    "btle_tpu_torch.rx",
    "btle_tpu_torch.rx.decode_kernel",
    "btle_tpu_torch.rx.decoder",
    "btle_tpu_torch.rx.coded",
    "btle_tpu_torch.rx.pipeline",
    "btle_tpu_torch.runtime",
    "btle_tpu_torch.sim",
    "btle_tpu_torch.sim.ber",
    "btle_tpu_torch.sim.channel",
    "btle_tpu_torch.sim.sweep",
    "btle_tpu_torch.stream",
    "btle_tpu_torch.stream.blocks",
    "btle_tpu_torch.stream.control",
    "btle_tpu_torch.stream.hci",
    "btle_tpu_torch.stream.ndjson",
    "btle_tpu_torch.stream.pcap",
    "btle_tpu_torch.stream.sniffer",
    "btle_tpu_torch.stream.sources",
    "btle_tpu_torch.tools",
    "btle_tpu_torch.tools._kernels",
    "btle_tpu_torch.tools._measure",
    "btle_tpu_torch.tools.bench_multichip",
    "btle_tpu_torch.tools.bench_narrowband",
    "btle_tpu_torch.tools.ber_2m_wideband",
    "btle_tpu_torch.tools.ber_sweep",
    "btle_tpu_torch.tools.dev_2m_cutoff",
    "btle_tpu_torch.tools.dev_aagrp_bisect",
    "btle_tpu_torch.tools.dev_aagrp_repro",
    "btle_tpu_torch.tools.dev_roll_experiment",
    "btle_tpu_torch.tools.dev_rollscale",
    "btle_tpu_torch.tools.gen_test_vectors",
    "btle_tpu_torch.tools.kernel_ab",
    "btle_tpu_torch.tools.sensitivity",
    "btle_tpu_torch.tx",
    "btle_tpu_torch.tx.descriptor",
    "btle_tpu_torch.tx.playback",
    "btle_tpu_torch.tx.synth",
    "btle_tpu_torch.cli",
    "btle_tpu_torch.cli.aggregate",
    "btle_tpu_torch.cli.analyze",
    "btle_tpu_torch.cli.app",
    "btle_tpu_torch.cli.events",
    "btle_tpu_torch.cli.mcp_server",
    "btle_tpu_torch.cli.pcap_loader",
    "btle_tpu_torch.cli.recon",
    "btle_tpu_torch.cli.rx_proc",
    "btle_tpu_torch.cli.tui",
    "btle_tpu_torch.cli.tx_builder",
    "btle_tpu_torch.cli.vendors",
    "btle_tpu_torch.utils",
    "btle_tpu_torch.utils.profiling",
    "btle_tpu_torch.utils.spectrum",
    "btle_tpu_torch.utils.vectors",
    "btle_tpu_torch.wideband",
    "btle_tpu_torch.wideband.channelizer",
    "btle_tpu_torch.wideband.coded",
    "btle_tpu_torch.wideband.fused",
    "btle_tpu_torch.wideband.knobmatrix",
    "btle_tpu_torch.wideband.selftest",
    "btle_tpu_torch.wideband.sniffer",
    "btle_tpu_torch.wideband.stream",
    "chip_smoke",
]

_CHECK = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "btle_tpu", "pydantic",
                                    "pydantic_core", "cryptography", "matplotlib",
                                    "curses", "_curses", "mcp"))
print(" ".join(bad))
sys.exit(1 if bad else 0)
"""


def test_port_modules_load_no_jax():
    proc = subprocess.run([sys.executable, "-c", _CHECK, *PORT_MODULES],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|btle_tpu|pydantic|pydantic_core|cryptography)(\.|\s|$)",
    re.MULTILINE)
# matplotlib, curses and mcp only inside a function (analyze.py's _plt,
# the ber plot, tui.run_curses, mcp_server.build_server)
_TOP_LEVEL_MPL = re.compile(r"^(import|from)\s+(matplotlib|curses|mcp)(\.|\s|$)",
                            re.MULTILINE)


@pytest.mark.parametrize(
    "path", sorted(p.relative_to(ROOT).as_posix()
                   for p in [*(ROOT / "btle_tpu_torch").rglob("*.py"),
                             ROOT / "chip_smoke.py"]))
def test_port_sources_name_no_jax(path):
    src = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(src), _FORBIDDEN.search(src).group(0)
    assert not _TOP_LEVEL_MPL.search(src), _TOP_LEVEL_MPL.search(src).group(0)
