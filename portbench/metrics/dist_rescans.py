"""dist_rescans: (time block, channel) cell rescans a step on rank 0 (the
program's ``rescan_cells`` counter, equal to its ``truncated_cells``),
before the profiler starts, in a ``--trace 1`` run; 0 when the walk ran
and nothing overflowed."""


def read(rec):
    if not rec.spans.get("shard.walk"):
        return None
    total, n = rec.spans.get("rescan_cells", (0, rec.spans["shard.walk"][1]))
    return total / n if n else None
