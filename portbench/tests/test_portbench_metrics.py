"""The metric arithmetic on synthetic records: rates are totals over
the window, tails are taken over all blocks, idle shares come from
merged device spans."""

import pytest

from portbench import core, devtrace


def read(name, rec):
    return core.reader(name)(rec)


def test_rate_is_window_total():
    rec = core.RunRecord(window_s=10.0, blocks=3000, territory_samples=3000 * 163840)
    assert read("wb_scan_msps", rec) == pytest.approx(3000 * 163840 / 10.0 / 1e6)
    assert read("wb_scan_msps", core.RunRecord(window_s=10.0)) is None


def test_tail_over_all_blocks():
    lat = [i / 1000 for i in range(1, 101)]          # 1..100 ms
    rec = core.RunRecord(latencies_s=lat)
    assert read("wb_block_p95_ms", rec) == pytest.approx(95.0)
    assert read("nb_block_p95_ms", core.RunRecord(latencies_s=lat + [1.0])) == \
        pytest.approx(96.0)
    assert core.p95([]) is None


def test_host_spans_per_block():
    rec = core.RunRecord(spans={"scan_async": [3.0, 1000], "consume_scan": [2.0, 1000],
                                "loop": [0.5, 1000], "process": [1.2, 1000]})
    assert read("wb_dispatch_ms", rec) == pytest.approx(3.0)
    # a qualified name without a file of its own reads its base's file
    assert read("wb_dispatch_ms.live", rec) == pytest.approx(3.0)
    assert not (core.HERE / "metrics" / "wb_dispatch_ms.live.py").exists()
    assert read("wb_consume_ms", rec) == pytest.approx(2.0)
    assert read("wb_loop_ms", rec) == pytest.approx(0.5)
    assert read("nb_process_ms", rec) == pytest.approx(1.2)


def test_idle_share_from_merged_spans():
    spans = [(0, 10), (5, 20), (30, 40), (35, 36), (90, 120)]
    busy, gaps = devtrace.busy_and_gaps(spans, 0, 100)
    assert busy == 40                       # [0,20] + [30,40] + [90,100]
    assert gaps == [(20, 30), (40, 90)]
    rec = core.RunRecord(trace={"busy_s": busy / 1e6, "window_s": 100 / 1e6,
                                "blocks": 4})
    for name in ("wb_idle_share", "wb_idle_share.live", "nb_idle_share"):
        assert read(name, rec) == pytest.approx(60.0)


def test_roofline_share():
    from portbench import roofline

    g = {**roofline.geometry(131072), "numerics": "bf16x2w"}
    least, _ = roofline.scan_least_ms(g, "bf16x2w")
    rec = core.RunRecord(geometry=g, trace={"busy_s": 4 * 0.6e-3, "window_s": 1.0,
                                            "blocks": 4})
    assert read("scan_roofline", rec) == pytest.approx(100 * least / 0.6)
    assert read("scan_roofline", core.RunRecord(geometry=g)) is None
