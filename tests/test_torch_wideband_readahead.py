"""run_live's read-ahead: block k+1 is read out of the native ring on a
native reader thread (runtime.ReadAhead) while the main thread
dispatches block k and walks the blocks before it. The sniffer is the
port's own, on the CPU, at a small block; the ring is the native one.
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from btle_tpu_torch import runtime
from btle_tpu_torch.utils import profiling as P
from btle_tpu_torch.wideband import WidebandConfig, WidebandSniffer
from btle_tpu_torch.wideband.stream import WidebandStreamRunner

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(not runtime.available(),
                                reason="the native runtime did not build (no g++)")


def _runner():
    cfg = WidebandConfig(scan_len_ch=256, num_taps=320)
    return WidebandStreamRunner(WidebandSniffer(cfg, device="cpu"))


def _geometry(runner):
    sn = runner.sn
    return sn.cfg.scan_len_ch * 20, sn.halo_ch * 20


def _ring(n_pairs):
    """A native ring holding a known stream of n_pairs: I counts up,
    Q counts the wraps of I."""
    k = np.arange(n_pairs)
    i, q = (k % 30011).astype(np.int16), (k // 30011).astype(np.int16)
    inter = np.empty(2 * n_pairs, np.int16)
    inter[0::2], inter[1::2] = i, q
    ring = runtime.IqRingBuffer(1 << 20)
    assert ring.write(inter, "i16") == n_pairs
    return ring, i, q


def _consumed(ring):
    return ring.total_written - ring.available_pairs


def _readers(ring):
    """Keep every reader run_live opens on ``ring``, so that only
    run_live's own close can have joined its thread."""
    kept = []
    read_ahead = ring.read_ahead

    def keep(*args):
        kept.append(read_ahead(*args))
        return kept[-1]

    ring.read_ahead = keep
    return kept


def _dispatched(runner):
    """Wrap scan_async: the (I, Q) first samples of each block it is
    given."""
    sn = runner.sn
    firsts = []
    scan_async = sn.scan_async

    def wrapped(i16, q16):
        firsts.append((int(i16[0]), int(q16[0])))
        return scan_async(i16, q16)

    sn.scan_async = wrapped
    return firsts


def _want_firsts(i, q, blocks, step):
    return [(int(i[k * step]), int(q[k * step])) for k in range(blocks)]


@pytest.mark.parametrize("pipeline", [1, 2, 3])
def test_read_ahead_dispatches_each_block_once_in_order(pipeline):
    """Each block is read once and dispatched in the ring's order; the
    ring gives up exactly the blocks read, and the thread is joined."""
    runner = _runner()
    step, halo = _geometry(runner)
    firsts = _dispatched(runner)
    ring, i, q = _ring(6 * step + halo)
    readers = _readers(ring)
    stats = runner.run_live(ring, pipeline=pipeline,
                            should_stop=lambda: ring.available_pairs < step + halo)
    assert stats.blocks == runner.sn.blocks_dispatched == 6
    assert firsts == _want_firsts(i, q, 6, step)
    assert _consumed(ring) == 6 * step
    assert len(runner.sn._slots) <= 3
    assert len(readers) == 1 and runtime.read_ahead_open_count() == 0
    ring.close()


@pytest.mark.parametrize("pipeline", [1, 2])
def test_stop_during_a_read_dispatches_its_block(pipeline):
    """The stop comes in the first consume, while the read of the next
    block is in flight: that block is still dispatched and consumed, no
    later read is made, and the ring gives up exactly the blocks
    consumed."""
    runner = _runner()
    step, halo = _geometry(runner)
    ring, _, _ = _ring(8 * step + halo)
    flag, consumed = [], []
    consume = runner.consume

    def stopping(h):
        consumed.append(h["block"])
        flag.append(True)
        return consume(h)

    runner.consume = stopping
    stats = runner.run_live(ring, pipeline=pipeline, should_stop=lambda: bool(flag))
    blocks = pipeline + 1
    assert stats.blocks == runner.sn.blocks_dispatched == blocks
    assert consumed == list(range(blocks))
    assert _consumed(ring) == blocks * step
    assert stats.dropped_pairs == 0
    assert runtime.read_ahead_open_count() == 0
    ring.close()


def test_consume_error_joins_the_reader():
    runner = _runner()
    step, halo = _geometry(runner)
    ring, _, _ = _ring(8 * step + halo)
    calls = []
    consume = runner.consume

    def failing(h):
        calls.append(h["block"])
        if len(calls) == 2:
            raise RuntimeError("consumer failed")
        return consume(h)

    runner.consume = failing
    readers = _readers(ring)
    with pytest.raises(RuntimeError, match="consumer failed"):
        runner.run_live(ring, pipeline=2)
    # blocks 0-2 were dispatched and the read of block 3 was in flight:
    # the close let it end before joining the thread
    assert runner.sn.blocks_dispatched == 3
    assert _consumed(ring) == 4 * step
    assert len(readers) == 1 and runtime.read_ahead_open_count() == 0
    ring.close()


def test_read_spans_and_ready_counter():
    """Each block's take is one run_live.read span; read_ready counts the
    takes whose read had ended (here the reader says so of the last
    three), and a short read (the stop's) counts nothing."""
    runner = _runner()
    step, halo = _geometry(runner)
    ring, _, _ = _ring(5 * step + halo)
    readers = _readers(ring)
    read_ahead = ring.read_ahead

    def scripted(*args):
        reader = read_ahead(*args)
        said = iter([False, False, True, True, True])
        reader.done = lambda: next(said)
        return reader

    ring.read_ahead = scripted
    tr = P.Tracer(4096)
    with P.tracing(tr):
        stats = runner.run_live(ring, pipeline=2,
                                should_stop=lambda: ring.available_pairs < step + halo)
    ring.close()
    tot = tr.totals()
    assert stats.blocks == 5 and len(readers) == 1
    assert tot["spans"]["run_live.read"]["count"] == 5
    assert tot["counters"]["read_ready"] == 3
    assert {"scan_async", "consume_scan", "consume.emit"} <= set(tot["spans"])


def test_read_ahead_under_fast_switching():
    """Forty blocks at pipeline 3 with the interpreter switching threads
    every microsecond and another Python thread busy: each block is read
    once, in order, and dispatched and consumed, and the reader is
    joined."""
    runner = _runner()
    step, halo = _geometry(runner)
    firsts = _dispatched(runner)
    ring, i, q = _ring(40 * step + halo)
    done, quit_ = {}, threading.Event()

    def run():
        done["stats"] = runner.run_live(
            ring, pipeline=3, should_stop=lambda: ring.available_pairs < step + halo)

    def busy():
        while not quit_.is_set():
            sum(range(100))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    other = threading.Thread(target=busy)
    try:
        other.start()
        th = threading.Thread(target=run)
        th.start()
        th.join(timeout=120)
    finally:
        quit_.set()
        other.join()
        sys.setswitchinterval(interval)
    assert not th.is_alive()
    assert done["stats"].blocks == runner.sn.blocks_dispatched == 40
    assert firsts == _want_firsts(i, q, 40, step)
    assert _consumed(ring) == 40 * step
    assert runtime.read_ahead_open_count() == 0
    ring.close()


def test_native_reader_matches_read_block():
    """ReadAhead against the ring's own read_block: a short ring gives
    None and is left as it was; a block comes back as read_block gives
    it, into the views submitted; bad views are refused."""
    halo, step = 64, 1000
    ring, i, q = _ring(step + halo - 1)
    reader = ring.read_ahead(step, halo)
    try:
        out = (np.zeros(step + halo, np.int16), np.zeros(step + halo, np.int16))
        with pytest.raises(ValueError):
            reader.submit((out[0][:-1], out[1][:-1]))
        reader.submit(out)
        assert reader.busy
        with pytest.raises(RuntimeError):
            reader.submit(out)
        assert reader.take() is None and not reader.busy
        with pytest.raises(RuntimeError):
            reader.take()
        assert ring.available_pairs == step + halo - 1
        assert ring.write(np.array([7, 9], np.int16), "i16") == 1
        reader.submit(out)
        for _ in range(5000):         # the reader ends the copy on its own
            if reader.done():
                break
            threading.Event().wait(0.001)
        assert reader.done() and reader.busy
        got = reader.take()
        assert got[0] is out[0] and got[1] is out[1]
        assert np.array_equal(out[0][:-1], i) and np.array_equal(out[1][:-1], q)
        assert (out[0][-1], out[1][-1]) == (7, 9)
        assert ring.available_pairs == halo
        assert runtime.read_ahead_open_count() == 1
    finally:
        reader.close()
        ring.close()
    assert runtime.read_ahead_open_count() == 0
