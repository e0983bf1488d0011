"""Host ms in WidebandSniffer.scan_async a block (context carry, the
pinned uploads, the launches), summed outside the traced span over the
blocks dispatched there."""


def read(rec):
    total, n = rec.spans.get("scan_async", (0.0, 0))
    return total / n * 1e3 if n else None
