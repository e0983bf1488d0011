"""The device's idle share of rank 0's traced span, in percent: 1 -
(merged device operation spans) / (span length), from torch.profiler on
rank 0's card (a collective waiting for a slower card counts as busy)."""


def read(rec):
    t = rec.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
