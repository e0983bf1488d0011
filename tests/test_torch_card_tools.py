"""The port's card gates and benches on the CPU, at small sizes, against
the JAX package: ``btle_tpu_torch.bench`` (the counterpart of
``bench.py``) and the ``btle_tpu_torch.tools`` modules ``soak_fused``,
``validate_fused``, ``bench_latency`` and ``bench_live`` (the counterparts
of tools/soak_fused_tpu.py, validate_fused_tpu.py, bench_latency.py and
bench_live_tpu.py). On the CPU each runs the plain PyTorch twins, so the
times are the host's; what is held here is what each computes and
reports."""

import ast
import dataclasses
import pathlib
import statistics

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from btle_tpu.wideband import WidebandConfig as JConfig
from btle_tpu.wideband import WidebandSniffer as JSniffer
from btle_tpu.wideband.sniffer import default_scan_tables as j_default_scan_tables
from btle_tpu.wideband.sniffer import wideband_scan as j_wideband_scan

from btle_tpu_torch import bench
from btle_tpu_torch.tools import bench_latency, bench_live, soak_fused, validate_fused

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _printed_keys(path: pathlib.Path) -> set:
    """The string keys of every dict literal in a script: the keys of the
    JSON lines ``bench.py`` and tools/bench_latency.py print."""
    tree = ast.parse(path.read_text())
    return {k.value for node in ast.walk(tree) if isinstance(node, ast.Dict)
            for k in node.keys if isinstance(k, ast.Constant) and isinstance(k.value, str)}


# --------------------------------------------------------------------------
# soak
# --------------------------------------------------------------------------


def _packets(pkts):
    return [(p.channel, bytes(p.pdu_bytes), p.sample_pos) for p in pkts]


def test_soak_matches_jax_and_passes():
    """The soak's scene at 6 background packets and 2 connections with map
    updates over 0.1 s of air: the port's plain sniffer and the JAX
    package's give the same (channel, PDU, position) list and the same
    follower events, and the soak passes with no ghost."""
    kw = dict(seconds=0.1, packets=6, phy="1m", seed=3, connections=2, map_updates=True)
    res = soak_fused.run("cpu", dtype="xla", **kw)
    wi, wq, injected, placed, _ = soak_fused.make_scene(
        kw["seconds"], kw["packets"], kw["phy"], kw["seed"], 2, True)
    jcfg = dataclasses.asdict(soak_fused.sniffer_config("1m", "xla", None, 2))
    jsn = JSniffer(JConfig(**jcfg))
    want = _packets(jsn.run(wi, wq))
    assert _packets(res["packets"]) == want
    assert [dataclasses.astuple(e) for e in res["events"]] == \
        [dataclasses.astuple(e) for e in jsn.multi_follower.events]
    assert res["ok"] and res["connections_ok"] and not res["ghosts"]
    assert res["decoded"] == res["injected"] == len(injected) == placed + 2 * 4
    assert res["connections"] == {"track_start": 2, "track_drop": 2, "chm_update": 2,
                                  "still_tracked": 0}


def test_soak_refuses_bad_flags():
    with pytest.raises(ValueError):
        soak_fused.make_scene(connections=13)
    with pytest.raises(ValueError):
        soak_fused.make_scene(map_updates=True)
    with pytest.raises(SystemExit):
        soak_fused.main(["--map-updates"])


# --------------------------------------------------------------------------
# validate
# --------------------------------------------------------------------------


def test_validate_reference_scan_matches_jax():
    """The tool's 8-channel scene through the port's plain scan is
    slot-exact against btle_tpu's XLA scan (every slot key, the PDU octets
    of the CRC-OK slots, mag_mean within the tool's rtol 0.02)."""
    wi, wq = validate_fused.make_scene()
    tables = validate_fused.scan_tables()
    got = validate_fused.scans("cpu")["reference"]
    want = {k: np.asarray(v) for k, v in j_wideband_scan(
        jnp.asarray(wi), jnp.asarray(wq), *map(jnp.asarray, tables),
        sps=4, lag=4, max_candidates=16).items()}
    for key in validate_fused.SLOT_KEYS:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert validate_fused.packet_set(got) == validate_fused.packet_set(want)
    assert len(validate_fused.packet_set(got)) >= len(validate_fused.CHANNELS)
    np.testing.assert_allclose(got["mag_mean"][got["valid"]], want["mag_mean"][want["valid"]],
                               rtol=validate_fused.MAG_RTOL)


def test_validate_passes_on_the_twins():
    res = validate_fused.run("cpu")
    assert res["result"] == "PASS" and all(res["checks"].values())
    assert res["crc_ok"] >= len(validate_fused.CHANNELS)


# --------------------------------------------------------------------------
# bench and latency
# --------------------------------------------------------------------------


def _jax_checksum(out) -> float:
    """bench.py's fold of one block: every leaf as float32, summed in tree
    order."""
    return float(sum(leaf.astype(jnp.float32).sum()
                     for leaf in jax.tree_util.tree_leaves(out)))


def test_bench_checksum_matches_jax():
    """The bench's per-block checksum at a 512-sample block equals the one
    bench.py folds on the same numpy block: ``block_checksum`` of the
    port's plain scan against the JAX XLA scan's, and the bench's parity
    step ("f32", the fused path) against the JAX fused "f32" scan in
    interpret mode (the two paths differ in the junk mag_mean of empty
    slots, so each is held against its own counterpart). rtol 1e-5: the
    float32 sums' order."""
    from jax.experimental.pallas import tpu as pltpu

    from btle_tpu.wideband.fused import wideband_scan_fused as j_wideband_scan_fused

    from btle_tpu_torch.wideband.sniffer import default_scan_tables, wideband_scan

    cpu = torch.device("cpu")
    (i, q), = bench.make_blocks(cpu, 512, count=1)
    args = (jnp.asarray(i.numpy()), jnp.asarray(q.numpy()), *j_default_scan_tables())
    kw = dict(sps=4, lag=4, max_candidates=bench.MAX_CANDIDATES)
    plain = float(bench.block_checksum(wideband_scan(
        i, q, *default_scan_tables(cpu), device=cpu, **kw)))
    assert plain == pytest.approx(_jax_checksum(j_wideband_scan(*args, **kw)), rel=1e-5)
    fused = float(bench.scan_step(cpu, "f32")(i, q))
    with pltpu.force_tpu_interpret_mode():
        want = _jax_checksum(j_wideband_scan_fused(*args, compute_dtype="f32", **kw))
    assert fused == pytest.approx(want, rel=1e-5)


def test_bench_line_keys():
    line = bench.run("cpu", scan_len_ch=256, iters=2, trials=2)
    assert _printed_keys(ROOT / "bench.py") <= set(line)
    assert line["path"] == "fused-bf16x2w" and line["parity_path"] == "fused-f32-polyx"
    # value is bench.py's rounding (0.1 Msps) of the trials' median
    assert line["value"] == round(statistics.median(line["msps_trials"]), 1)
    assert line["msps_min"] == min(line["msps_trials"]) <= max(line["msps_trials"]) \
        == line["msps_max"]
    assert len(line["msps_trials"]) == len(line["parity_msps_trials"]) == 2
    assert np.isfinite(line["checksum"]) and line["device"] == "cpu"


def test_latency_keys_match_jax_tool():
    lines = bench_latency.run("cpu", sizes=(256,), iters=2, trials=1)
    assert set(lines[0]) == _printed_keys(ROOT / "tools" / "bench_latency.py")
    assert lines[0]["scan_len_ch"] == 256 and lines[0]["air_ms"] == 256 * 20 / 80e3
    assert lines[0]["steady_state_verdict_latency_ms"] == pytest.approx(
        lines[0]["air_ms"] + lines[0]["pipelined_ms_per_block"])


# --------------------------------------------------------------------------
# live
# --------------------------------------------------------------------------


def test_live_unpaced_decodes_only_its_scene(monkeypatch):
    """Unpaced producer (rate 0) into a ring of 1M pairs (the tool's 32M
    pairs cost the CPU page faults on every first write), the plain path
    at 1024-sample blocks: the live loop decodes packets, and every CRC-OK
    packet is one of the scene's."""
    monkeypatch.setattr(bench_live, "RING_PAIRS", 1 << 20)
    res = bench_live.run("cpu", rate=0, seconds=3.0, block=1024, xla=True)
    assert res["blocks"] > 0 and res["crc_ok"] > 0
    assert res["scene_packets_decoded"] > 0 and res["ghosts"] == []
    assert res["verdict"] in ("PASS (keeps up live)", "BELOW WIRE RATE")
    inter, want = bench_live.scene(1024)
    assert len(inter) == 2 * bench_live.N_SCENE_BLOCKS * 1024 * 20
    assert len(want) <= bench_live.N_PACKETS and not inter.flags.writeable
