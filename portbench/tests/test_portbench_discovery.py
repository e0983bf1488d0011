"""A configuration, a traffic mix, a cell and a metric added as new files
(and entries in BENCHMARK.json) are found by name, with no edit to a file
that is there."""

import json
import shutil
import sys

from portbench import core


def test_new_files_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(core.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = core.benchmark()
    here = root / "portbench"
    # a throwaway configuration, traffic mix, cell and metric, each a file
    cfg = json.loads((here / "configs" / "wideband_1m.json").read_text())
    cfg.update(name="wideband_f32", sniffer={**cfg["sniffer"], "fused_dtype": "f32",
                                             "operand": "exact"})
    (here / "configs" / "wideband_f32.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "replay_8k.json").read_text())
    traffic["block"] = 32768
    (here / "traffic" / "replay_32k.json").write_text(json.dumps(traffic))
    cell = json.loads((here / "workloads" / "wb1m_8k_replay.json").read_text())
    (here / "workloads" / "wbf32_32k_replay.json").write_text(json.dumps(cell))
    (here / "metrics" / "blocks_done.py").write_text(
        "def read(rec):\n    return rec.blocks or None\n")
    bench["configs"].append({"name": "wideband_f32", "source": "x",
                             "file": "portbench/configs/wideband_f32.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "wbf32_32k_replay", "config": "wideband_f32",
                               "traffic": "replay_32k", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "blocks_done", "unit": "blocks",
                               "better": "higher", "source": "host_clock",
                               "layer": "live loop", "moves": "wb_scan_msps",
                               "workloads": ["wbf32_32k_replay"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in core.HERE.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}

    sys.path.insert(0, str(root))
    saved = {k: v for k, v in sys.modules.items() if k.split(".")[0] == "portbench"}
    for k in saved:
        del sys.modules[k]
    try:
        import portbench.core as fresh

        assert fresh.HERE == here
        b = fresh.benchmark(root)
        entry, config, traffic, settings = fresh.cell(b, "wbf32_32k_replay")
        assert config["sniffer"]["fused_dtype"] == "f32"
        assert traffic["block"] == 32768 and settings == cell
        names = [m["name"] for m in fresh.metrics_for(b, "wbf32_32k_replay", True)]
        assert names == ["blocks_done"]
        assert fresh.reader("blocks_done")(fresh.RunRecord(blocks=7)) == 7
        assert fresh.system(config["system"]).__file__.startswith(str(here))
        assert fresh.scene_generator(traffic["scene"]["generator"]).__file__.startswith(
            str(here))
    finally:
        sys.path.remove(str(root))
        for k in [k for k in sys.modules if k.split(".")[0] == "portbench"]:
            del sys.modules[k]
        sys.modules.update(saved)
    after = {p: p.read_bytes() for p in core.HERE.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert before == after


def test_a_kept_cell_runs_from_its_own_file():
    """A cell left out of BENCHMARK.json (PERF.md keeps it for later)
    is found by the ``"cell"`` entry of its workload file; a listed one
    by BENCHMARK.json's entry."""
    bench = core.benchmark()
    listed = {w["name"] for w in bench["workloads"]}
    kept = [p.stem for p in (core.HERE / "workloads").glob("*.json")
            if "cell" in json.loads(p.read_text())]
    assert kept
    for name in kept:
        entry, config, traffic, settings = core.cell(bench, name)
        assert entry["name"] == name and entry["chips"] == 1
        assert config["name"] == settings["cell"]["config"]
        if name not in listed:
            assert traffic == core.load_json("traffic", settings["cell"]["traffic"])
    try:
        core.cell(bench, "no_such_cell")
    except KeyError:
        pass
    else:
        raise AssertionError("an unknown cell was found")
