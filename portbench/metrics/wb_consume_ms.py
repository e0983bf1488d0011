"""wb_consume_ms: host ms in WidebandSniffer.consume_scan a block (the
wait on the copy's event, the walk, PDU parsing, rescans), summed outside
the traced span over the blocks consumed there."""


def read(rec):
    total, n = rec.spans.get("consume_scan", (0.0, 0))
    return total / n * 1e3 if n else None
