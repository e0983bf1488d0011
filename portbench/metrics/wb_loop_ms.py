"""wb_loop_ms: host ms a block in run_live outside the sniffer's two
calls (ring reads, block assembly, NDJSON emission, idle polls): the
window outside the traced span less the two calls' totals, over the
blocks dispatched there."""


def read(rec):
    total, n = rec.spans.get("loop", (0.0, 0))
    return total / n * 1e3 if n else None
