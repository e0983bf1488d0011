"""The scan's counting functions against the per-kernel bounds that
chip_smoke.py prints at bench geometry."""

import pytest

from portbench import roofline


def test_kernel_bounds_at_bench_geometry():
    g = roofline.geometry(131072)
    k1, by1 = roofline.k1_bound_ms(g, "bf16x2w")
    k2, by2 = roofline.k2_bound_ms(g)
    assert by1 == "operations" and k1 == pytest.approx(0.1115, abs=5e-5)
    assert by2 == "bytes" and k2 == pytest.approx(0.02215, abs=5e-6)


def test_scan_least_time():
    g = roofline.geometry(131072)
    least, by = roofline.scan_least_ms(g, "bf16x2w")
    assert by == "operations"
    # the filterbank bound plus the demod tail's float32 work
    assert roofline.k1_bound_ms(g)[0] < least < 1.1 * roofline.k1_bound_ms(g)[0]
    small, _ = roofline.scan_least_ms(roofline.geometry(8192), "bf16x2w")
    assert small == pytest.approx(0.0086, abs=2e-4)
    assert roofline.scan_least_ms(g, "bf16")[0] < least
