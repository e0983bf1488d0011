"""The wideband sniffer's staging slots (WidebandSniffer.staging_views,
_stage) and the ring's read into them (IqRingBuffer.read_block's
``out``): a block staged where the ring wrote it, or copied once from
any other array, reaches the device as the filter context followed by
the block, bit for bit what concatenating the two gave, and a handle's
device copy outlives the slot it came from."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from btle_tpu_torch import runtime
from btle_tpu_torch.utils import profiling as P
from btle_tpu_torch.wideband import WidebandConfig, WidebandSniffer
from btle_tpu_torch.wideband.sniffer import STAGING_SLOTS

SCAN_LEN = 64


def _sniffer(**kw):
    return WidebandSniffer(WidebandConfig(scan_len_ch=SCAN_LEN, **kw), device="cpu")


def _blocks(sn, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(-2000, 2000, (2, sn.wb_block_len)).astype(np.int16)
            for _ in range(n)]


class _Concatenation:
    """The staging rule as concatenation: integer blocks keep their
    dtype, others become float32, the context follows the block's dtype
    and is the concatenation's [step, step + ctx_len)."""

    def __init__(self, sn):
        self.ctx = np.zeros((2, sn.cfg.num_taps - 1), np.float32)
        self.step = sn.cfg.scan_len_ch * 20

    def __call__(self, i, q):
        x = np.stack([i, q])
        if x.dtype.kind not in "iu":
            x = x.astype(np.float32)
        x = np.concatenate([self.ctx.astype(x.dtype), x], axis=1)
        self.ctx = x[:, self.step: self.step + self.ctx.shape[1]].copy()
        return x


def _feed(sn, blk, how):
    """Block ``blk`` (2, n) int16 as scan_async's caller hands it over."""
    if how == "lent":
        i, q = sn.staging_views(np.int16)
        i[:], q[:] = blk
        return i, q
    if how == "float32":
        return blk[0].astype(np.float32), blk[1].astype(np.float32)
    if how == "float64":
        return blk[0].astype(np.float64) / 3, blk[1].astype(np.float64) / 3
    return blk[0].copy(), blk[1].copy()


@pytest.mark.parametrize("hows", [["lent"] * 5, ["int16"] * 5, ["float32"] * 5,
                                  ["float64"] * 5,
                                  ["lent", "int16", "lent", "float32", "lent"]])
def test_stage_equals_concatenation(hows):
    """Five blocks staged from the lent slot's views, from foreign int16 or
    float arrays, or a mix: each upload is the concatenation of the
    carried context and the block, dtype and all, and only foreign blocks
    are copied on the host."""
    sn = _sniffer()
    ref = _Concatenation(sn)
    tr = P.Tracer(256)
    with P.tracing(tr):
        for blk, how in zip(_blocks(sn, 5, 1), hows):
            i, q = _feed(sn, blk, how)
            want = ref(i, q)
            dxi, dxq = sn._stage(i, q)
            assert dxi.is_contiguous() and dxq.is_contiguous()
            assert dxi.dtype == torch.from_numpy(want[:1]).dtype
            assert np.array_equal(dxi.numpy(), want[0])
            assert np.array_equal(dxq.numpy(), want[1])
    counters = tr.totals()["counters"]
    assert counters["h2d_copies"] == 5
    assert counters.get("stage_copies", 0) == sum(h != "lent" for h in hows)
    assert len(sn._slots) <= STAGING_SLOTS + 1


def test_lent_slot_survives_foreign_blocks():
    """A block staged from a foreign array while a slot is lent goes to
    another slot: the lent views, filled afterwards, stage as they are."""
    sn = _sniffer()
    ref = _Concatenation(sn)
    a, b, c = _blocks(sn, 3, 2)
    i, q = sn.staging_views(np.int16)
    assert sn.staging_views(np.int16)[0].ctypes.data == i.ctypes.data
    for blk in (a, b):
        for _ in range(STAGING_SLOTS):
            want = ref(*blk)
            assert np.array_equal(torch.stack(sn._stage(*blk)).numpy(), want)
    i[:], q[:] = c
    want = ref(i, q)
    assert np.array_equal(torch.stack(sn._stage(i, q)).numpy(), want)
    assert sn._lent is None


def test_stage_refuses_unequal_rows():
    sn = _sniffer()
    with pytest.raises(ValueError):
        sn._stage(np.zeros(10, np.int16), np.zeros(11, np.int16))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_handles_keep_their_blocks(depth):
    """With ``depth`` scans in flight and every slot reused meanwhile, each
    handle's device copy is still its own block when it is consumed."""
    sn = _sniffer(fused=True, fused_dtype="f32")
    ref = _Concatenation(sn)
    pending = []
    for blk in _blocks(sn, STAGING_SLOTS + depth + 1, 3):
        i, q = _feed(sn, blk, "lent")
        pending.append((sn.scan_async(i, q), ref(i, q)))
        if len(pending) >= depth:
            h, want = pending.pop(0)
            assert np.array_equal(h["dxi"].numpy(), want[0])
            assert np.array_equal(h["dxq"].numpy(), want[1])
            sn.consume_scan(h)
    assert len(sn._slots) <= STAGING_SLOTS


def _ring_with(n_pairs, seed):
    rng = np.random.default_rng(seed)
    inter = rng.integers(-30000, 30000, 2 * n_pairs).astype(np.int16)
    ring = runtime.IqRingBuffer(1 << 16)
    assert ring.write(inter, "i16") == n_pairs
    return ring, inter


def test_read_block_into_out():
    """read_block(out=...) writes the samples read_block returns, and
    refuses a wrong dtype, length, layout or a read-only array without
    consuming the ring."""
    if not runtime.available():
        pytest.skip("the native runtime did not build (no g++)")
    scan, halo = 1000, 200
    plain, inter = _ring_with(5000, 4)
    into, _ = _ring_with(5000, 4)
    out = (np.full(scan + halo, 7, np.int16), np.full(scan + halo, 7, np.int16))
    for k in range(3):
        want = plain.read_block(scan, halo)
        got = into.read_block(scan, halo, out=out)
        assert got[0] is out[0] and got[1] is out[1]
        for w, g in zip(want, got):
            assert np.array_equal(w, g)
        assert np.array_equal(got[0], inter[2 * k * scan: 2 * (k * scan + scan + halo): 2])
    bad = [(np.zeros(scan + halo, np.int32), out[1]),
           (out[0], np.zeros(scan + halo + 1, np.int16)),
           (np.zeros(2 * (scan + halo), np.int16)[::2], out[1]),
           (list(out[0]), out[1])]
    ro = np.zeros(scan + halo, np.int16)
    ro.flags.writeable = False
    bad.append((out[0], ro))
    left = into.available_pairs
    for b in bad:
        with pytest.raises(ValueError):
            into.read_block(scan, halo, out=b)
    assert into.available_pairs == left
    assert into.read_block(10_000, 0, out=(np.zeros(10_000, np.int16),) * 2) is None
    plain.close()
    into.close()
