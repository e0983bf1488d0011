"""wb_block_p95_ms: the 95th percentile, over every block of the window,
of the time from the feed's due time for the last sample a block needs
(territory and halo) to the return of the runner's consume of it."""

from portbench.core import p95


def read(rec):
    v = p95(rec.latencies_s)
    return None if v is None else v * 1e3
