"""nb_block_p95_ms: the 95th percentile, over every block of the window,
of the time from the due time of the read that holds a block's last
sample (territory and halo) to the end of the sniffer's work on it."""

from portbench.core import p95


def read(rec):
    v = p95(rec.latencies_s)
    return None if v is None else v * 1e3
