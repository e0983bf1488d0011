"""Cells cut to a size the CPU runs in seconds, for the tests: the
port's plain twins in place of its kernels, a short dense scene, small
blocks. The card's run of a cell is run.py's."""

from __future__ import annotations

import time

from portbench import core

SMALL = {
    "wideband_live": dict(
        scene={"air_s": 0.02, "advertisers": 100},
        traffic={"block": 2048, "feed": {"write_pairs": 65536, "rate_msps": None}},
        config={"selftest": False},
        check={"blocks": 2, "blocks_per_s": 1}),
    "narrowband_stream": dict(
        scene={"air_s": 0.2},
        traffic={},
        config={},
        check={"blocks": 3, "blocks_per_s": 20}),
}


SECONDS = {"wideband_live": 4.0, "narrowband_stream": 0.5}


def context(workload: str, seed: int = 5, seconds: float | None = None, root=None,
            **overrides) -> core.Context:
    bench = core.benchmark() if root is None else core.benchmark(root)
    entry, config, traffic, settings = core.cell(bench, workload)
    small = SMALL[config["system"]]
    seconds = SECONDS[config["system"]] if seconds is None else seconds
    settings = {**settings, "check": small["check"]}
    if "account_air_s" in settings:
        # a closed-loop cell's fixed span of air, cut to twice the scene
        settings["account_air_s"] = 2 * small["scene"]["air_s"]
    return core.Context(
        workload, config, traffic, settings, seed=seed, seconds=seconds,
        trace=False, device="cpu", t_process0=time.perf_counter(),
        config_overrides={**small["config"], **overrides.get("config", {})},
        scene_overrides={**small["scene"], **overrides.get("scene", {})},
        traffic_overrides={**small["traffic"], **overrides.get("traffic", {})})


def run(workload: str, **kw) -> core.RunRecord:
    ctx = context(workload, **kw)
    return core.system(ctx.config["system"]).run(ctx)
