"""The sharded-stream system (systems/sharded_stream.py) on 4 gloo ranks
of this machine's CPU, the port's plain twins in place of its kernels,
at a small size of its own: a short dense scene, 2048-sample blocks and
two candidate slots, so cells overflow and rescan every step. A run is
correct; one whose rank 0 scans its shard one sample late, or drops a
rescan, is not."""

import contextlib
import time

import numpy as np
import pytest

from portbench import core

WORKLOAD = "dist4_128k_replay"


def _context(seed: int = 7) -> core.Context:
    entry, config, traffic, settings = core.cell(core.benchmark(), WORKLOAD)
    settings = {**settings, "check": {"steps": 2, "steps_per_s": 1}, "account_air_s": 0.04}
    return core.Context(
        WORKLOAD, config, traffic, settings, seed=seed, seconds=4.0, trace=False,
        device="cpu", t_process0=time.perf_counter(),
        config_overrides={"selftest": False, "max_candidates": 2},
        scene_overrides={"air_s": 0.02, "advertisers": 100},
        traffic_overrides={"block": 2048})


def _run(**kw) -> core.RunRecord:
    return core.system("sharded_stream").run(_context(**kw))


@contextlib.contextmanager
def patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def test_cell_is_four_chips_on_its_own_configuration():
    bench = core.benchmark()
    entry, config, _, _ = core.cell(bench, WORKLOAD)
    assert entry["chips"] == 4 and config["system"] == "sharded_stream"
    assert config["mesh"] == [1, 4]


def test_small_run_is_correct():
    rec = _run()
    assert rec.correct, rec.checks
    assert rec.blocks > 0 and rec.territory_samples == rec.blocks * 4 * 2048 * 20
    assert rec.checks["rank_diff"].value == 0
    assert rec.attempted > 0
    assert any("reference rescans" in n and "reference rescans 0" not in n for n in rec.notes)


def test_a_lattice_one_sample_late_fails():
    """Rank 0 (this process) scans its shard window one sample late."""
    from btle_tpu_torch.wideband import fused

    def late(orig):
        def f(i_wb, q_wb, *a, **k):
            import torch

            pad = torch.zeros(1, dtype=i_wb.dtype, device=i_wb.device)
            return orig(torch.cat([pad, i_wb[:-1]]), torch.cat([pad, q_wb[:-1]]), *a, **k)
        return f

    with patched(fused, "fused_frontend", late):
        rec = _run(seed=8)
    assert not rec.correct
    assert rec.checks["flip_ppm"].value > rec.checks["flip_ppm"].limit


class _Rescanned(dict):
    """A rescan's candidate row (the walk reads it as any row)."""


def test_a_dropped_rescan_fails():
    """Rank 0 (this process) leaves out the packets of the first rescan of
    each step that found any; its walk, and so the group's rounds, run
    as they would."""
    from btle_tpu_torch.dist.shard import ShardedWidebandScan

    dropped, done = set(), []

    def rounds(orig):
        def f(self, need):
            return {k: _Rescanned(v) for k, v in orig(self, need).items()}
        return f

    def consume(orig):
        def f(self, m, row, lo, cursor, packets, aa):
            n = len(packets)
            out = orig(self, m, row, lo, cursor, packets, aa)
            if type(row) is _Rescanned and not done and len(packets) > n:
                dropped.update(id(p) for p in packets[n:])
                done.append(True)
            return out
        return f

    def gather(orig):
        def f(self, out):
            done.clear()
            return [p for p in orig(self, out) if id(p) not in dropped]
        return f

    with patched(ShardedWidebandScan, "_rescan_round", rounds), \
            patched(ShardedWidebandScan, "_consume", consume), \
            patched(ShardedWidebandScan, "gather_packets", gather):
        rec = _run(seed=9)
    assert dropped
    assert not rec.correct
    assert rec.checks["rank_diff"].value > 0
