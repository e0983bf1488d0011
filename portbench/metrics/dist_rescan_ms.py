"""dist_rescan_ms: host ms a step on rank 0 in the program's
``shard.rescan`` spans (one a round: the owning ranks' plain
channelization and decode, the gather of the results, the host copy),
before the profiler starts, in a ``--trace 1`` run; 0 when the walk ran
and no round did."""


def read(rec):
    if not rec.spans.get("shard.walk"):
        return None
    total, n = rec.spans.get("shard.rescan", (0.0, rec.spans["shard.walk"][1]))
    return total / n * 1e3 if n else None
