"""dist_ingest_ms: host ms a step on rank 0 in the program's
``shard.ingest`` span (the slice onto the card: pinned staging and the
uploads), before the profiler starts, in a ``--trace 1`` run."""


def read(rec):
    total, n = rec.spans.get("shard.ingest", (0.0, 0))
    return total / n * 1e3 if n else None
