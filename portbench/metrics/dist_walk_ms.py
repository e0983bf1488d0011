"""dist_walk_ms: host ms a step on rank 0 in the self time of the
program's ``shard.walk`` span (``gather_packets`` less its rescan rounds:
the walk over every (time block, channel) cell of the step), before the
profiler starts, in a ``--trace 1`` run."""


def read(rec):
    total, n = rec.spans.get("shard.walk.self", (0.0, 0))
    return total / n * 1e3 if n else None
