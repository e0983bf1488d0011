"""On the card, at each cell's own size: a short window of the program
is correct, and one of its control (the nearest lower precision) is not.
Marked ``cuda``: it skips without a card. Run on the card with
``python -m pytest portbench/tests -m cuda``."""

import time

import pytest

from portbench import controls, core

WORKLOADS = ["wb1m_8k_replay", "nb37_8k_live", "wb1m_128k_replay", "wb1m_128k_live80"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run(workload, seed, overrides):
    bench = core.benchmark()
    entry, config, traffic, settings = core.cell(bench, workload)
    ctx = core.Context(workload, config, traffic, settings, seed=seed, seconds=3.0,
                       trace=False, device="cuda", t_process0=time.perf_counter(),
                       config_overrides=overrides)
    return core.system(config["system"]).run(ctx)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_passes_control_fails(card, workload):
    settings = core.load_json("workloads", workload)
    assert _run(workload, 2**31 + 101, {}).correct
    with controls.applied(settings["control"]) as overrides:
        rec = _run(workload, 2**31 + 102, {**overrides, "selftest": False})
    assert not rec.correct, rec.checks
