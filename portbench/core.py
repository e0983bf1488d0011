"""Finding a cell's parts by name, and the record one run leaves.

A cell (an entry of ``workloads`` in BENCHMARK.json) names a
configuration and a traffic mix. Each is a file found by its name:
``configs/<config>.json`` (which names its system, ``systems/<system>.py``),
``traffic/<traffic>.json`` (which names its scene generator,
``scenes/<generator>.py``), ``workloads/<cell>.json`` (the cell's own
settings: the scene's salt, how many blocks the check reads, the
limits), and ``metrics/<metric>.py`` for every metric (or
``metrics/<base>.py`` for ``<base>.<qualifier>``), each with a
``read(rec)`` that returns a number or None.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "btle_tpu")


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def benchmark(root: Path = REPO) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str):
    """(entry, config, traffic, settings) of a cell, found by name. A
    cell that BENCHMARK.json does not list (one kept for later, see
    PERF.md) runs from the ``"cell"`` entry of its own workload file."""
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    path = HERE / "workloads" / f"{workload}.json"
    if not entries and not path.exists():
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    settings = json.loads(path.read_text())
    entry = entries[0] if entries else {"name": workload, **settings["cell"]}
    return (entry, load_json("configs", entry["config"]),
            load_json("traffic", entry["traffic"]), settings)


def metrics_for(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of ``workload`` reports: the end-to-end
    ones with ``trace`` off, the per-layer ones with it on; an entry
    without ``workloads`` counts for every cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``. A name with a
    qualifier, ``<base>.<qualifier>`` (one quantity reported in cells
    whose end-to-end metrics differ), falls back to ``metrics/<base>.py``
    when it has no file of its own."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = HERE / "metrics" / f"{name.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def system(name: str):
    return importlib.import_module(f"portbench.systems.{name}")


def scene_generator(name: str):
    return importlib.import_module(f"portbench.scenes.{name}")


def cache_dirs(root: Path = REPO) -> None:
    """Fixed kernel-cache directories inside the checkout, for whatever
    in the process would otherwise pick its own (the port builds its
    kernels into build/btle_tpu_torch/ by itself)."""
    base = root / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_jit")):
        os.environ[var] = str(base / sub)


def few_threads() -> None:
    """One process with few threads: the math libraries' pools at one
    thread (before they load), so no idle pool spins on the cores the
    sniffer's loop and the feed need."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def settle_heap() -> None:
    """Collect, then move what set-up made (the imports' objects, the
    scene) out of the collector's reach, as long-running services do:
    a full collection in the window then scans only what the window
    made (tens of ms, not the ~200 ms a full scan of the imports costs
    on the card's host)."""
    gc.collect()
    gc.freeze()


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc), or 0."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (btle_tpu_torch is not btle_tpu)."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def p95(values) -> float | None:
    """The 95th percentile by nearest rank: the smallest value with at
    least 95% of the values at or below it."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, -(-95 * len(v) // 100) - 1)]


class GcWatch:
    """The interpreter's garbage collections while it is on: count, total
    and longest pause (a collection stalls every thread of the loop)."""

    def __init__(self):
        self.pauses: list = []
        self._t = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses.append((info.get("generation"), time.perf_counter() - self._t))

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)
        return False

    def note(self) -> str:
        full = [p for g, p in self.pauses if g == 2]
        total = sum(p for _, p in self.pauses)
        return (f"gc in the window: {len(self.pauses)} collections ({len(full)} full), "
                f"{total * 1e3:.3f} ms in all, longest "
                f"{max((p for _, p in self.pauses), default=0) * 1e3:.3f} ms")


def spread_note(name: str, values) -> str:
    """p50 / p95 / max of a list of seconds, in ms."""
    v = sorted(values)
    if not v:
        return f"{name}: none"
    return (f"{name} ms: p50 {v[len(v) // 2] * 1e3:.4f} p95 {p95(v) * 1e3:.4f} "
            f"max {v[-1] * 1e3:.4f} ({len(v)})")


def slice_note(name: str, times, values, t0: float, seconds: float, stat,
               slice_s: float = 5.0) -> str:
    """``stat`` of the values whose time falls in each ``slice_s`` of the
    window: whether a run's own halves agree, against how runs differ.
    For earlier lines only; the metrics are taken over the whole window."""
    out = []
    for j in range(max(1, int(seconds // slice_s))):
        lo, hi = t0 + j * slice_s, t0 + (j + 1) * slice_s
        v = [x for t, x in zip(times, values) if lo <= t < hi]
        out.append("none" if not v else f"{stat(v):.4f}")
    return f"{name} by {slice_s:g} s slice: " + " ".join(out)


class NullSink:
    """A text sink that keeps nothing: NDJSON is formatted and written
    as under --json, and stdout stays the harness's."""

    def write(self, s: str) -> int:
        return len(s)

    def flush(self) -> None:
        pass


@dataclass
class Check:
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Context:
    """What a system gets: the cell's files, the run's arguments, and
    overrides for tests and the calibration (never set by run.py)."""
    workload: str
    config: dict
    traffic: dict
    settings: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_process0: float = 0.0            # process start on perf_counter
    config_overrides: dict = field(default_factory=dict)
    scene_overrides: dict = field(default_factory=dict)
    traffic_overrides: dict = field(default_factory=dict)


@dataclass
class RunRecord:
    """Everything a metric reader may read; systems fill what they have."""
    setup_s: float = 0.0
    window_s: float = 0.0
    blocks: int = 0                    # completed inside the window
    territory_samples: int = 0         # wideband / narrowband samples
    latencies_s: list = field(default_factory=list)
    spans: dict = field(default_factory=dict)     # name -> [seconds, count]
    trace: dict | None = None
    geometry: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    checks: dict = field(default_factory=dict)    # name -> Check
    notes: list = field(default_factory=list)     # lines for stderr
    memory_peak_bytes: int = 0
    phases: list = field(default_factory=list)    # (set-up phase, perf_counter)

    def mark(self, phase: str):
        """Stamp the end of a set-up phase."""
        self.phases.append((phase, time.perf_counter()))

    def phase_note(self, t0: float) -> str:
        out, prev = [], t0
        for name, t in self.phases:
            out.append(f"{name} {t - prev:.3f}")
            prev = t
        return "set-up s: " + ", ".join(out)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks.values())
