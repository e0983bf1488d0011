"""dist_scan_ms: host ms a step on rank 0 in the program's ``shard.scan``
span (the shard window's assembly and the fused scan's launches), before
the profiler starts, in a ``--trace 1`` run."""


def read(rec):
    total, n = rec.spans.get("shard.scan", (0.0, 0))
    return total / n * 1e3 if n else None
