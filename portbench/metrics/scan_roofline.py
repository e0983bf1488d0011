"""scan_roofline: the least time of one block's scan (portbench/
roofline.py: the filterbank's products at the numerics' tensor-core
peak, the demod and AA test at the float32 peak, or the block's input
and outputs at the memory's rate, the larger) over the device's busy
time a block in the traced span, in percent. Kernel names play no part."""

from portbench import roofline


def read(rec):
    t = rec.trace
    if not t or not t["blocks"] or t["busy_s"] <= 0:
        return None
    least_ms, _ = roofline.scan_least_ms(rec.geometry, rec.geometry["numerics"])
    return 100.0 * least_ms / (t["busy_s"] * 1e3 / t["blocks"])
