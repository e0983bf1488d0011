"""dist_scan_roofline: the least time of one block's scan (portbench/
roofline.py, as scan_roofline counts it: the filterbank's products at
the numerics' tensor-core peak, the demod and AA test at the float32
peak, or the block's input and outputs at the memory's rate, the larger)
over rank 0's device busy time a step in its traced span (a step is one
block a card), in percent."""

from portbench import roofline


def read(rec):
    t = rec.trace
    if not t or not t["blocks"] or t["busy_s"] <= 0:
        return None
    least_ms, _ = roofline.scan_least_ms(rec.geometry, rec.geometry["numerics"])
    return 100.0 * least_ms / (t["busy_s"] * 1e3 / t["blocks"])
