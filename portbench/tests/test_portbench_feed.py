"""The wideband feed: a native thread on the clock of time.perf_counter,
writing the looped scene into the program's ring on schedule."""

import time

import numpy as np

from portbench.feed import NativeFeed, _library


def test_feed_clock_is_perf_counter():
    lib = _library()
    assert abs(lib.feed_now() - time.perf_counter()) < 1e-3


def test_paced_and_closed_feeds_write_the_looped_scene():
    from btle_tpu_torch import runtime

    scene = np.arange(2 * 5000, dtype=np.int16)          # 5000 pairs
    for rate in (0.2, None):
        ring = runtime.IqRingBuffer(1 << 16)
        feed = NativeFeed(ring, scene, 1024, rate, 1 << 16, max_writes=100)
        t0 = time.perf_counter()
        feed.start(t0)
        time.sleep(0.1)
        feed.stop()
        gen, start, took, due = feed.delivered()
        assert len(gen) >= 10 and (took == 1024).all()
        assert (gen == 1024 * np.arange(len(gen))).all()
        if rate:
            assert np.allclose(due, t0 + (gen + 1024) / 0.2e6)
            assert all(w >= d for _, _, _, d, w in feed.writes)
        i, q = ring.drain()
        n = len(i)
        idx = np.arange(n) % 5000
        assert np.array_equal(i, scene[2 * idx]) and np.array_equal(q, scene[2 * idx + 1])
        ring.close()
