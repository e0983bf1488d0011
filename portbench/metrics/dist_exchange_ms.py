"""dist_exchange_ms: host ms a step on rank 0 in the program's
``shard.exchange`` span (the halo p2p with the time neighbours, the
wrap-around context, and the wait on them), before the profiler starts,
in a ``--trace 1`` run."""


def read(rec):
    total, n = rec.spans.get("shard.exchange", (0.0, 0))
    return total / n * 1e3 if n else None
