"""What the command loads: never jax, jaxlib, flax or btle_tpu (top-level
names compared whole); the reference and the scenes load nothing of the
program; and a run without a card, or without the program, prints no
result."""

import json
import shutil
import subprocess
import sys

from portbench import core

RUN = """
import sys, json
sys.path.insert(0, {root!r})
sys.path.insert(0, {root!r} + "/portbench/tests")
import smallrun
from portbench import core
rec = smallrun.run({workload!r})
print(json.dumps({{"modules": sorted(sys.modules), "correct": rec.correct}}))
"""


def _child(code: str, cwd=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=cwd)


def test_forbidden_names_compare_whole():
    assert core.forbidden_modules(["btle_tpu_torch.rx", "numpy", "torch"]) == []
    assert core.forbidden_modules(["btle_tpu.rx", "jax._src"]) == ["btle_tpu", "jax"]


def test_a_run_loads_no_jax():
    for workload in ("wb1m_8k_replay", "nb37_8k_live"):
        out = _child(RUN.format(root=str(core.REPO), workload=workload))
        assert out.returncode == 0, out.stderr[-2000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"]
        assert core.forbidden_modules(res["modules"]) == []


def test_reference_and_scenes_load_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n" % str(core.REPO)
            + "import portbench.reference.ble, portbench.reference.wideband, "
              "portbench.reference.narrowband, portbench.scenes.ble_air, "
              "portbench.roofline, portbench.devtrace, portbench.core\n"
              "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = _child(code)
    assert out.returncode == 0, out.stderr
    top = out.stdout
    assert "btle_tpu" not in top and "jax" not in top


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "wb1m_8k_replay", "--seed", "2147483648", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=core.REPO)
    import torch

    if not torch.cuda.is_available():
        assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(core.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(core.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "nb37_8k_live", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
