"""dist_gather_ms: host ms a step on rank 0 in the program's
``shard.gather`` span (pack, the all_gathers of every rank's candidates,
the host copy and unpack: it holds the wait for the slowest rank),
before the profiler starts, in a ``--trace 1`` run."""


def read(rec):
    total, n = rec.spans.get("shard.gather", (0.0, 0))
    return total / n * 1e3 if n else None
