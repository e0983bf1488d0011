"""The CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside
the fixture). chip_smoke.py checks the kernels at bench geometry; these
cover the other shapes the kernels take — lag 1 (odd-bin decision
flip), sps 2 (LE 2M), the 640-tap prototype, a ragged block length,
per-channel AA rows with care-mask holes, an all-zero care mask, float
channel rows in the narrowband scan, candidate windows past the lattice
end in both tail modes, every (compute_dtype, inner) pair of the fused
front end (K1, K3, K5), the tensor-core filterbank (K1, K5 at "f32x2"
and "bf16") at the live block's shape, each column tile, a ragged ky and
frames shorter than ky + width - 1, the demod tail (K2) bit for bit at
sps 1-8, odd lag, ragged tiles and the live and K8 shapes, K3 at each
column tile, the live and K8 dma_mm shapes and against float64 at 33
slices, K4 bit for bit at (40, 16) and (1, 16), sps 1-8, in both tail
modes, the narrowband scan at the edges of its 512-position tiles
(n_hit = 0, n_bits one past a tile, lag 8 at sps 1 and 2, AA windows
across a tile's end, the live block), the probes' AA correlation on its
wide (sps 1, 2, 4, 8; n_out one below, at and above a tile's end) and
narrow tiles, with scalar-load row strides and at the K11 shape — every
knob-matrix row's self-test, and the
port's device path against its CPU path (wideband sniffer with and
without connection following, its live ring loop and its pinned
staging slots at pipeline depths 1-3, the loop's read-ahead against a
writing feed at 131072 samples a block, the narrowband
sniffer); then V1, the coded Viterbi, bit for bit on soft and tied hard
inputs (one warp a CTA above 48 KB of shared memory), the narrowband and
40-channel LE Coded receivers against the CPU with V1's launch count,
the BER harness against the CPU with injected draws and at its anchors,
and every shipped fused mode at the 11 dB anchor SNR. They import no JAX, so they
run where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from btle_tpu_torch import stream as S
from btle_tpu_torch.golden import assemble_phy_bits, gfsk_modulate_float
from btle_tpu_torch.phy.scan_kernel import SCAN_BLOCK, scan_block_kernel, scan_block_reference
from btle_tpu_torch.rx.decode_kernel import (DECODE_CANDIDATES, decode_candidates,
                                             decode_candidates_reference)
from btle_tpu_torch.spec import bits as B
from btle_tpu_torch.spec import whitening as W
from btle_tpu_torch.wideband import WidebandConfig, WidebandSniffer, fused_selftest
from btle_tpu_torch.wideband import fused, knobmatrix
from btle_tpu_torch.wideband.channelizer import bin_to_channel, channel_to_bin, compose_wideband
from btle_tpu_torch.wideband.sniffer import default_scan_tables

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py")
    return torch.device("cuda")


def _scene(seed, phy="1m", chans=(37, 4, 22, 39), n=120_000, spacing=25_000):
    """One packet per entry of ``chans`` (channels may repeat), spacing
    wideband samples apart, plus noise."""
    rng = np.random.default_rng(seed)
    placements = []
    for k, ch in enumerate(chans):
        hdr = 0x02 if ch in (37, 38, 39) else 0x01
        pdu = np.concatenate([[hdr, 12], rng.integers(0, 256, 12)]).astype(np.uint8)
        bits = assemble_phy_bits(B.bytes_to_bits(pdu), ch, phy=phy)
        ci, cq = gfsk_modulate_float(bits, 40 if phy == "2m" else 80)
        placements.append((ch, 3000 + spacing * k, ci, cq))
    wi, wq = compose_wideband(placements, n)
    wi += rng.normal(0, 0.5, n).astype(np.float32)
    wq += rng.normal(0, 0.5, n).astype(np.float32)
    return wi, wq


CONFIGS = [
    # num_taps, cutoff, sps, lag, has_context, phy, n
    (1280, 1.0, 4, 4, True, "1m", 131_279),
    (1280, 1.0, 4, 1, False, "1m", 120_017),
    (640, 1.0, 4, 4, False, "1m", 100_003),
    (1280, 1.2, 2, 2, False, "2m", 110_000),
]


@pytest.mark.parametrize("num_taps,cutoff,sps,lag,ctx,phy,n", CONFIGS)
def test_kernels_match_twins(dev, num_taps, cutoff, sps, lag, ctx, phy, n):
    wi, wq = _scene(num_taps + lag, phy=phy, n=n)
    rng = np.random.default_rng(sps)
    aa_rows = torch.as_tensor(rng.integers(0, 2, (40, 32)), dtype=torch.int8)
    aa_rows[[channel_to_bin(ch) for ch in (37, 4, 22, 39)]] = \
        torch.as_tensor(B.hex_to_bits("d6be898e"))
    mask = torch.ones(32, dtype=torch.int8)
    mask[[5, 17]] = 0
    xi, xq = torch.as_tensor(wi, device=dev), torch.as_tensor(wq, device=dev)
    for mode in ("bf16x2w", "f32"):
        fb_args, tail = fused.frontend_operands(
            xi, xq, aa_rows.to(dev), mask.to(dev), num_taps, ctx, sps, lag,
            mode, cutoff, dev)
        kern, twin = fused.FILTERBANKS[mode]
        y, y_ref = kern(*fb_args), twin(*fb_args)
        assert (y - y_ref).abs().max() <= 1e-5 * y_ref.abs().max()
        got = fused.demod_tail(y_ref, *tail)
        want = fused.demod_tail_reference(y_ref, *tail)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[2], want[2])
        assert int(want[1].sum()) >= 4
    bits = got[0]
    pos = torch.randint(0, bits.shape[1] + 50, (40, 16), device=dev,
                        dtype=torch.int32)
    whiten = torch.randint(0, 2, (40, 336), device=dev, dtype=torch.int8)
    crc = torch.randint(0, 1 << 24, (40,), device=dev, dtype=torch.int32)
    adv = torch.arange(40, device=dev) % 3 == 0
    before = DECODE_CANDIDATES.launches
    for g, w in zip(decode_candidates(bits, pos, whiten, crc, adv, sps),
                    decode_candidates_reference(bits, pos, whiten, crc, adv, sps)):
        assert torch.equal(g, w)
    assert DECODE_CANDIDATES.launches == before + 1


@pytest.mark.parametrize("num_taps,cutoff,sps,lag,ctx,phy,n", CONFIGS)
@pytest.mark.parametrize("dtype,inner", sorted(fused.FILTERBANK_KIND))
def test_every_mode_matches_twin(dev, dtype, inner, num_taps, cutoff, sps, lag,
                                 ctx, phy, n):
    """Each (compute_dtype, inner) pair's filterbank kernel (K1, K3 or K5)
    against its twin on the pair's operands: max |dy| within 1e-5 of max
    |y| (the same exact products summed in another order), one launch."""
    wi, wq = _scene(num_taps + lag, phy=phy, n=n)
    xi, xq = torch.as_tensor(wi, device=dev), torch.as_tensor(wq, device=dev)
    aa = torch.as_tensor(B.hex_to_bits("d6be898e"), device=dev)
    mask = torch.ones(32, dtype=torch.int8, device=dev)
    kind = fused.filterbank_kind(dtype, inner)
    fb_args, _ = fused.frontend_operands(xi, xq, aa, mask, num_taps, ctx, sps,
                                         lag, dtype, cutoff, dev, inner)
    kern, twin = fused.FILTERBANKS[kind]
    counters = {"bf16x2w": fused.FILTERBANK_BF16X2W, "f32": fused.FILTERBANK_POLYX_F32,
                "bf16_poly": fused.FILTERBANK_POLYX_F32, **fused.FILTERBANK_IM2COL}
    before = counters[kind].launches
    y, y_ref = kern(*fb_args), twin(*fb_args)
    assert counters[kind].launches == before + 1
    assert y.shape == (80, fb_args[3]) and bool(torch.isfinite(y).all())
    assert (y - y_ref).abs().max() <= 1e-5 * y_ref.abs().max()


# the filterbanks the redesigns gave register tiles and column tiles that
# follow the grid — K1 and K5 at "f32x2" and "bf16" on the tensor cores, K5
# at "f32" (im2col) as a CUDA-core SGEMM — at the shapes the main paths
# give them:
# label, num_taps, sps, lag, has_context, wideband samples
HILO_CASES = [
    ("live", 1280, 4, 4, True, (8192 + 1476) * 20 + 1279),    # ~9668 columns
    ("tile128", 1280, 4, 4, True, 24_000 * 20 + 1279),
    ("tile256", 1280, 4, 4, True, 40_000 * 20 + 1279),
    ("ragged", 1280, 4, 4, False, 100_003),
    ("sps2_lag1", 1280, 2, 1, False, 110_000),
    ("lag1_context", 1280, 4, 1, True, 60_000 + 1279),
    ("taps640", 640, 4, 4, True, 70_001),
]
# filterbank kind -> (compute_dtype, inner, its column tile at ky on sms SMs)
TILED_KINDS = {
    "bf16x2w": ("bf16x2w", None, lambda ky, sms: 64 * fused.hilo_warps_m(ky, sms)),
    "f32x2": ("f32x2", None, lambda ky, sms: 64 * fused.hilo_warps_m(ky, sms)),
    "bf16": ("bf16", None, lambda ky, sms: 64 * fused.hilo_warps_m(ky, sms)),
    "f32_im2col": ("f32", "im2col", lambda ky, sms: 32 * fused.sgemm_warps(ky, sms)),
}


def _tiled_operands(dev, kind, num_taps, sps, lag, ctx, n, seed):
    wi, wq = _scene(seed, phy="2m" if sps == 2 else "1m", n=n)
    xi, xq = torch.as_tensor(wi, device=dev), torch.as_tensor(wq, device=dev)
    aa = torch.as_tensor(B.hex_to_bits("d6be898e"), device=dev)
    mask = torch.ones(32, dtype=torch.int8, device=dev)
    dtype, inner, _ = TILED_KINDS[kind]
    fb_args, _ = fused.frontend_operands(xi, xq, aa, mask, num_taps, ctx, sps,
                                         lag, dtype, 1.0, dev, inner)
    return fb_args


@pytest.mark.parametrize("label,num_taps,sps,lag,ctx,n", HILO_CASES)
@pytest.mark.parametrize("dtype", sorted(TILED_KINDS))
def test_hilo_kernels_match_twin(dev, dtype, label, num_taps, sps, lag, ctx, n):
    """K1 and K5 at "f32x2" and "bf16" on the tensor cores, and K5 at
    "f32" on the CUDA cores, against their twins: max |dy| within 1e-5 of
    max |y|, one
    launch, at the live block's shape, at each column tile (64, 128, 256
    columns), at a ky no tile divides, at sps 2 / lag 1, with filter
    context and at 640 taps."""
    fb_args = _tiled_operands(dev, dtype, num_taps, sps, lag, ctx, n, n % 1000)
    ky = fb_args[3]
    counter = (fused.FILTERBANK_BF16X2W if dtype == "bf16x2w"
               else fused.FILTERBANK_IM2COL[dtype])
    kern, twin = fused.FILTERBANKS[dtype]
    before = counter.launches
    y, y_ref = kern(*fb_args), twin(*fb_args)
    assert counter.launches == before + 1
    assert y.shape == (80, ky) and bool(torch.isfinite(y).all())
    assert (y - y_ref).abs().max() <= 1e-5 * y_ref.abs().max()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile = TILED_KINDS[dtype][2](ky, sms)
    assert tile == {"live": 64, "tile128": 128, "tile256": 256}.get(label, tile)
    if label == "ragged":
        assert ky % tile


@pytest.mark.parametrize("dtype", sorted(TILED_KINDS))
def test_hilo_kernels_zero_frames_past_j(dev, dtype):
    """Frames shorter than ky + width - 1 columns: the kernel reads zeros
    past J, as the twin does on the zero-padded frames."""
    fb_args = _tiled_operands(dev, dtype, 1280, 4, 4, False, 40_000, 5)
    frames, rest = fb_args[0], fb_args[1:]
    axis = frames.ndim - (1 if dtype == "f32_im2col" else 2)   # the column axis
    cut = frames.shape[axis] - 700
    short = frames.narrow(axis, 0, cut).contiguous()
    padded = torch.zeros_like(frames)
    padded.narrow(axis, 0, cut).copy_(short)
    kern, twin = fused.FILTERBANKS[dtype]
    y, y_ref = kern(short, *rest), twin(padded, *rest)
    assert (y - y_ref).abs().max() <= 1e-5 * y_ref.abs().max()


def test_f32_sgemm_plan_keeps_16_warps(dev):
    """K5 at "f32" at bench geometry: 256-column CTAs of 8 warps, two
    resident per SM."""
    ky = 131_072 + 1476          # the bench block's y columns
    warps = fused.sgemm_warps(ky, torch.cuda.get_device_properties(dev).multi_processor_count)
    plan = fused.FILTERBANK_IM2COL["f32_im2col"].plan(ky, 65, warps)
    assert plan["tile_columns"] == 256 and plan["threads"] == 256
    assert plan["ctas_per_sm"] * plan["threads"] >= 16 * 32


# K3 (the exact "f32" polyphase filterbank and "bf16"/poly on it)
POLYX_KINDS = {"f32": ("f32", None), "bf16_poly": ("bf16", "poly")}


@pytest.mark.parametrize("label,num_taps,sps,lag,ctx,n", HILO_CASES)
@pytest.mark.parametrize("kind", sorted(POLYX_KINDS))
def test_polyx_matches_twin(dev, kind, label, num_taps, sps, lag, ctx, n):
    """K3 against its twin at stack 2: max |dy| within 1e-5 of max |y|,
    one launch, at the live block's shape, at each column tile (64, 128,
    256 columns, as K5 at "f32" picks them), at a ky no tile divides, at
    sps 2 / lag 1, with filter context and at 640 taps (17 slices)."""
    wi, wq = _scene(n % 1000, phy="2m" if sps == 2 else "1m", n=n)
    xi, xq = torch.as_tensor(wi, device=dev), torch.as_tensor(wq, device=dev)
    aa = torch.as_tensor(B.hex_to_bits("d6be898e"), device=dev)
    mask = torch.ones(32, dtype=torch.int8, device=dev)
    dtype, inner = POLYX_KINDS[kind]
    fb_args, _ = fused.frontend_operands(xi, xq, aa, mask, num_taps, ctx, sps, lag,
                                         dtype, 1.0, dev, inner)
    ky = fb_args[3]
    before = fused.FILTERBANK_POLYX_F32.launches
    y = fused.filterbank_polyx_f32(*fb_args)
    y_ref = fused.filterbank_polyx_f32_reference(*fb_args)
    torch.cuda.synchronize()
    assert fused.FILTERBANK_POLYX_F32.launches == before + 1
    assert y.shape == (80, ky) and bool(torch.isfinite(y).all())
    assert (y - y_ref).abs().max() <= 1e-5 * y_ref.abs().max()
    plan = fused.polyx_plan(ky, fb_args[1].shape[1], 2, dev)
    tile = plan["tile_columns"]
    assert tile == {"live": 64, "tile128": 128, "tile256": 256}.get(label, tile)
    assert plan["ctas"] == min(-(-ky // tile), plan["ctas_per_sm"] *
                               torch.cuda.get_device_properties(dev).multi_processor_count)
    if label == "ragged":
        assert ky % 64


def test_polyx_plan_keeps_16_warps(dev):
    """K3 at bench geometry: 256-column tiles in CTAs of 8 warps, two
    resident per SM, a persistent grid of two CTAs per SM; at the live
    block 64-column tiles, one CTA per tile."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bench = fused.polyx_plan(131_072 + 1476, 33, 2, dev)
    assert bench["tile_columns"] == 256 and bench["threads"] == 256
    assert bench["ctas_per_sm"] * bench["threads"] >= 16 * 32
    assert bench["ctas"] == bench["ctas_per_sm"] * sms
    live = fused.polyx_plan(8192 + 1476, 33, 2, dev)
    assert live["tile_columns"] == 64 and live["ctas"] == -(-(8192 + 1476) // 64)


def test_polyx_dma_mm_probe_shape(dev):
    """K3 at the K8 dma_mm probe's operands (80 rows, stack 1, one slice,
    W = I): y equals the frames' first ky columns exactly."""
    from btle_tpu_torch.tools import dev_aagrp_bisect

    _, _, y_i, y_q = dev_aagrp_bisect.make_inputs()
    frames = torch.as_tensor(dev_aagrp_bisect.dma_frames(y_i, y_q), device=dev)
    ones = torch.ones((80, 1), device=dev)
    eye = torch.eye(80, device=dev)
    ky = frames.shape[1]
    y = fused.filterbank_polyx_f32(frames, ones, eye, ky, stack=1)
    y_ref = fused.filterbank_polyx_f32_reference(frames, ones, eye, ky, stack=1)
    torch.cuda.synchronize()
    assert torch.equal(y, frames) and torch.equal(y_ref, frames)


def test_polyx_stacked_slices_are_a_true_fp32_product(dev):
    """K3 at stack 2 with 33 slices and random taps, against the two sums
    in float64: within 1e-5 of max |want| (true FP32 throughout; a TF32
    or bf16 pass would miss by ~1e-3)."""
    rng = np.random.default_rng(33)
    ky, n_slices = 5000, 33
    f = rng.normal(size=(80, ky + 2 * (n_slices - 1))).astype(np.float32)
    kc = rng.normal(size=(80, n_slices)).astype(np.float32)
    w = rng.normal(size=(80, 80)).astype(np.float32)
    y = fused.filterbank_polyx_f32(*(torch.as_tensor(a, device=dev) for a in (f, kc, w)),
                                   ky, stack=2)
    torch.cuda.synchronize()
    f64 = f.astype(np.float64)
    acc = sum(f64[:, 2 * j: 2 * j + ky] * kc[:, j: j + 1].astype(np.float64)
              for j in range(n_slices))
    want = w.astype(np.float64) @ acc
    assert np.abs(y.cpu().numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_polyx_rejects_unsupported_operands(dev):
    f = torch.zeros((80, 5000), device=dev)
    kc = torch.ones((80, 33), device=dev)
    w = torch.eye(80, device=dev)
    for bad in (dict(stack=3), dict(stack=4)):
        with pytest.raises(ValueError):
            fused.filterbank_polyx_f32(f, kc, w, 4000, **bad)
    with pytest.raises(ValueError):          # 40 stacked rows
        fused.filterbank_polyx_f32(f[:40].contiguous(), kc[:40].contiguous(),
                                   w[:, :40].contiguous(), 4000, stack=1)
    with pytest.raises(ValueError):          # J too short for the slices
        fused.filterbank_polyx_f32(f, kc, w, 4970, stack=2)


# K4: (M, C) shapes of the wideband and narrowband paths
DECODE_SHAPES = [(40, 16), (1, 16)]


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("sps", [1, 2, 4, 8])
@pytest.mark.parametrize("m,c", DECODE_SHAPES)
def test_decode_candidates_bit_exact(dev, m, c, sps, clamp):
    """K4 torch.equal to its twin in both tail modes: random lattices with
    real packets at some positions, positions at the lattice's last bit
    and past it, negative positions, windows running off the end, and
    advertising and data channels; one launch."""
    from btle_tpu_torch.spec.crc24 import lfsr_init_to_table_init

    rng = np.random.default_rng(100 * sps + m + clamp)
    kb = 6000 + 37 * sps
    lattice = rng.integers(0, 2, (m, kb)).astype(np.int8)
    chans = [(37, 3, 38, 9, 20)[k % 5] for k in range(m)]
    whiten = np.stack([W.whitening_bits(ch, 336) for ch in chans]).astype(np.int8)
    crc = np.array([lfsr_init_to_table_init("555555")] * m, np.int32)
    adv = np.array([ch in (37, 38, 39) for ch in chans])
    pos = rng.integers(0, kb, (m, c)).astype(np.int32)
    for r in range(m):       # a CRC-OK packet at slot 0: its dewhitened bits
        pdu = _adv_pdu(rng, 9) if adv[r] else np.concatenate(
            [[0x01, 9], rng.integers(0, 256, 9)]).astype(np.uint8)
        phy = assemble_phy_bits(B.bytes_to_bits(pdu), chans[r], phy="1m")
        body = phy[8 + 32:]                   # past the preamble and the AA
        p0 = 200
        idx = p0 + 32 * sps + np.arange(len(body)) * sps
        lattice[r, idx] = body
        pos[r, 0] = p0
    pos[:, 1] = kb - 1
    pos[:, 2] = kb
    pos[:, 3] = kb + 100
    pos[:, 4] = -5
    pos[:, 5] = -32 * sps - 40
    pos[:, 6] = kb - 150 * sps
    args = [torch.as_tensor(a, device=dev) for a in (lattice, pos, whiten, crc, adv)]
    before = DECODE_CANDIDATES.launches
    got = decode_candidates(*args, sps=sps, clamp_tail=clamp)
    want = decode_candidates_reference(*args, sps, clamp)
    torch.cuda.synchronize()
    assert DECODE_CANDIDATES.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
    assert bool((got[2] & got[3])[:, 0].all())          # the packets CRC-OK


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("m,c", DECODE_SHAPES)
def test_decode_candidates_all_slots_invalid(dev, m, c, clamp):
    """No hit anywhere: earliest_hits gives every slot position 0 and
    valid False; K4 decodes those windows exactly as its twin does."""
    from btle_tpu_torch.rx.pipeline import earliest_hits

    gen = torch.Generator(device=dev).manual_seed(m)
    bits = torch.randint(0, 2, (m, 3000), generator=gen, device=dev, dtype=torch.int8)
    pos, valid, _ = earliest_hits(torch.zeros((m, 2800), dtype=torch.bool, device=dev), c)
    assert not bool(valid.any()) and not bool(pos.any())
    whiten = torch.randint(0, 2, (m, 336), generator=gen, device=dev, dtype=torch.int8)
    crc = torch.randint(0, 1 << 24, (m,), generator=gen, device=dev, dtype=torch.int32)
    adv = torch.arange(m, device=dev) % 2 == 0
    got = decode_candidates(bits, pos, whiten, crc, adv, 4, clamp)
    want = decode_candidates_reference(bits, pos, whiten, crc, adv, 4, clamp)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("label,cfg,expected", knobmatrix.config_matrix())
def test_knob_matrix_row_on_card(dev, label, cfg, expected):
    assert fused_selftest(device=dev, **cfg) == fused_selftest(device="cpu", **cfg)


def _host(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


@pytest.mark.parametrize("sps,lag,phy", [(4, 4, "1m"), (4, 1, "1m"), (2, 2, "2m")])
def test_scan_on_card_matches_cpu_path(dev, sps, lag, phy):
    wi, wq = _scene(7, phy=phy)
    tables = default_scan_tables("cpu")
    for mode in ("f32", "bf16x2w"):
        kw = dict(sps=sps, lag=lag, max_candidates=8, compute_dtype=mode)
        ref = _host(fused.wideband_scan_fused(wi, wq, *tables, device="cpu", **kw))
        got = _host(fused.wideband_scan_fused(wi, wq, *tables, device=dev, **kw))
        for key in ("pos", "valid", "crc_ok", "payload_len", "len_ok", "num_hits"):
            np.testing.assert_array_equal(ref[key], got[key], err_msg=key)
        for m, k in np.argwhere(ref["crc_ok"]):
            span = 2 + int(ref["payload_len"][m, k]) + 3
            np.testing.assert_array_equal(ref["pdu_bytes"][m, k, :span],
                                          got["pdu_bytes"][m, k, :span])
        assert {bin_to_channel(int(m)) for m, _ in np.argwhere(got["crc_ok"])} \
            == {37, 4, 22, 39}


def test_sniffer_on_card_matches_cpu_path(dev):
    """Streamed blocks with a channel overflowing its two candidate slots
    (the rescan runs the plain path's channelizer on the card)."""
    chans = (37, 9, 9, 9, 38, 21, 9, 39)
    wi, wq = _scene(3, chans=chans, n=4 * 163_840, spacing=30_000)
    cfg = dict(scan_len_ch=8192, max_candidates=2, fused=True)
    for mode in ("f32", "bf16x2w"):
        ref = WidebandSniffer(WidebandConfig(fused_dtype=mode, **cfg),
                              device="cpu")
        got = WidebandSniffer(WidebandConfig(fused_dtype=mode, **cfg), device=dev)
        a, b = ref.run(wi, wq), got.run(wi, wq)
        key = [(p.channel, p.sample_pos, p.crc_ok, p.pdu_bytes.tobytes())
               for p in a if p.crc_ok]
        assert key == [(p.channel, p.sample_pos, p.crc_ok, p.pdu_bytes.tobytes())
                       for p in b if p.crc_ok]
        assert len(key) == len(chans)
        assert got.truncated_channels == ref.truncated_channels >= 1


def test_batched_rescans_on_card(dev):
    """37, 38 and 39 overflowing two slots in one block: one decode_block
    over their rows with a (C,) min_pos (the walk's batched rescan) equals
    one call a row on the card, key by key, and the sniffer's rescan rounds
    give the CPU path's packets."""
    from btle_tpu_torch.rx.pipeline import decode_block
    from btle_tpu_torch.utils import profiling as P
    from btle_tpu_torch.wideband import channelize

    wi, wq = _scene(5, chans=(37, 38, 39) * 4, n=2 * 163_840, spacing=12_000)
    cfg = dict(scan_len_ch=8192, max_candidates=2, fused=True, fused_dtype="bf16x2w")
    ref = WidebandSniffer(WidebandConfig(**cfg), device="cpu")
    got = WidebandSniffer(WidebandConfig(**cfg), device=dev)
    tr = P.Tracer(4096)
    a = ref.run(wi, wq)
    with P.tracing(tr):
        b = got.run(wi, wq)
    key = [(p.channel, p.sample_pos, p.crc_ok, p.pdu_bytes.tobytes()) for p in a]
    assert key == [(p.channel, p.sample_pos, p.crc_ok, p.pdu_bytes.tobytes()) for p in b]
    assert sum(p.crc_ok for p in b) == 12
    assert got.truncated_channels == ref.truncated_channels == tr.counters["rescan_channels"]
    assert [c.n for c in tr.counts() if c.name == "rescan_channels"][0] == 3

    n = got.wb_block_len + got._ctx_len
    x = [np.concatenate([np.zeros(got._ctx_len, np.float32), v])[:n] for v in (wi, wq)]
    y_i, y_q = channelize(*x, has_context=True, device=dev)
    aa, mask, whiten, crc, adv = default_scan_tables(dev)
    rows, starts = [19, 20, 32], [0, 2000, 1500]
    idx = torch.tensor(rows, device=dev)
    kw = dict(sps=4, lag=4, max_candidates=2)
    many = decode_block(y_i[idx], y_q[idx], aa.expand(3, 32), mask, whiten[idx],
                        crc[idx], adv[idx],
                        min_pos=torch.tensor(starts, dtype=torch.int32, device=dev), **kw)
    for j, (m, p) in enumerate(zip(rows, starts)):
        one = decode_block(y_i[m: m + 1], y_q[m: m + 1], aa[None], mask,
                           whiten[m: m + 1], crc[m: m + 1], adv[m: m + 1], min_pos=p, **kw)
        for k in one:
            assert torch.equal(many[k][j], one[k][0]), (m, k)
    assert int(many["num_hits"][0]) > 2


def _follow_scene():
    """Two CONNECT_REQs (37, 38) in block 0, then a data packet of each
    connection on its first hop channel (9, 7) in block 2."""
    rng = np.random.default_rng(12)
    placements = []
    for ch, aa, crc, hop, pos in ((37, 0x60850A1B, "a77b22", 9, 30_000),
                                  (38, 0x50A1B2C4, "55aa11", 7, 80_000)):
        pdu = np.frombuffer(bytes([0x05, 34]) + bytes.fromhex("001830EA965F")[::-1]
                            + bytes.fromhex("90D7EBB19299")[::-1] + aa.to_bytes(4, "little")
                            + bytes.fromhex(crc) + bytes([0x02, 0x0F, 0]) + (16).to_bytes(2, "little")
                            + bytes(2) + (0x07D0).to_bytes(2, "little")
                            + bytes.fromhex("1FFFFFFFFF")[::-1] + bytes([hop | (5 << 5)]),
                            np.uint8)
        ci, cq = gfsk_modulate_float(assemble_phy_bits(B.bytes_to_bits(pdu), ch), 80)
        placements.append((ch, pos, ci, cq))
        data = np.concatenate([[0x01, 9], rng.integers(0, 256, 9)]).astype(np.uint8)
        di, dq = gfsk_modulate_float(assemble_phy_bits(
            B.bytes_to_bits(data), hop, crc_init_hex=crc,
            access_address_hex=aa.to_bytes(4, "little").hex()), 80)
        placements.append((hop, 2 * 163_840 + pos, di, dq))
    n = 4 * 163_840
    wi, wq = compose_wideband(placements, n)
    wi += rng.normal(0, 0.3, n).astype(np.float32)
    wq += rng.normal(0, 0.3, n).astype(np.float32)
    return wi, wq


@pytest.mark.parametrize("max_follow", [1, 2])
@pytest.mark.parametrize("mode", ["bf16", "bf16x2w", "f32"])
def test_follow_sniffer_on_card_matches_cpu(dev, mode, max_follow):
    """Connection following on the card: the packets, their access
    addresses and the hop events equal the CPU path's, file and ring."""
    from btle_tpu_torch import runtime
    from btle_tpu_torch.wideband.stream import WidebandStreamRunner

    wi, wq = _follow_scene()
    cfg = dict(follow_connections=True, max_follow=max_follow, fused=True,
               fused_dtype=mode)
    out = []
    for device in ("cpu", dev):
        sn = WidebandSniffer(WidebandConfig(**cfg), device=device)
        pkts = sn.run(wi, wq)
        follower = sn.multi_follower or sn.hop_tracker
        out.append(([(p.channel, p.sample_pos, p.access_addr, p.pdu_bytes.tobytes())
                     for p in pkts if p.crc_ok],
                    [(e.event, e.channel, e.access_addr, e.time_us)
                     for e in follower.events]))
    assert out[0] == out[1]
    assert {p[0] for p in out[1][0]} == ({37, 38, 9, 7} if max_follow == 2
                                         else {37, 38, 9})
    if runtime.available():
        runner = WidebandStreamRunner(WidebandSniffer(WidebandConfig(**cfg), device=dev))
        inter = np.zeros(2 * (len(wi) + 200_000), np.int16)
        inter[0:2 * len(wi):2] = np.round(wi * 64)
        inter[1:2 * len(wi):2] = np.round(wq * 64)
        ring = runtime.IqRingBuffer(1 << 22)
        ring.write(inter, "i16")
        got = []
        consume = runner.consume
        runner.consume = lambda h: got.extend(consume(h)) or got
        runner.run_live(ring, pipeline=1, should_stop=lambda: ring.available_pairs
                        < runner.sn.wb_block_len)
        ring.close()
        assert {p.channel for p in got if p.crc_ok} == {p[0] for p in out[1][0]}


@pytest.mark.parametrize("pipeline", [1, 2, 3])
def test_run_live_staging_on_card_matches_file_run(dev, pipeline):
    """run_live over the native ring, each block read into a pinned
    staging slot and uploaded from there, gives run_capture's packets of
    the same int16 IQ; no slot is lent or written while its last upload
    is still pending."""
    from btle_tpu_torch import runtime
    from btle_tpu_torch.wideband.stream import WidebandStreamRunner

    if not runtime.available():
        pytest.skip("the native runtime did not build (no g++)")
    wi, wq = _follow_scene()
    i16, q16 = np.round(wi * 64).astype(np.int16), np.round(wq * 64).astype(np.int16)
    cfg = WidebandConfig(fused=True, fused_dtype="bf16x2w")
    live = WidebandStreamRunner(WidebandSniffer(cfg, device=dev))
    sn = live.sn
    halo_wb = sn.halo_ch * 20
    inter = np.zeros(2 * (len(i16) + halo_wb), np.int16)
    inter[0:2 * len(i16):2], inter[1:2 * len(i16):2] = i16, q16
    pending_writes = []
    free_slot, views = sn._free_slot, sn.staging_views

    def checked_free_slot(*a):
        s = free_slot(*a)
        pending_writes.append(not s.free())
        return s

    def checked_views(*a):
        out = views(*a)
        pending_writes.append(not sn._lent.free())
        return out

    sn._free_slot, sn.staging_views = checked_free_slot, checked_views
    ring = runtime.IqRingBuffer(1 << 22)
    assert ring.write(inter, "i16") == len(inter) // 2
    got = []
    consume = live.consume
    live.consume = lambda h: got.extend(consume(h)) or got
    live.run_live(ring, pipeline=pipeline,
                  should_stop=lambda: ring.available_pairs < sn.wb_block_len)
    ring.close()
    file_run = WidebandStreamRunner(WidebandSniffer(cfg, device=dev))
    want = file_run.run_capture(np.append(i16, np.zeros(halo_wb, np.int16)),
                                np.append(q16, np.zeros(halo_wb, np.int16)))

    def key(pkts):
        return [(p.channel, p.sample_pos, p.crc_ok, p.pdu_bytes.tobytes(), p.rssi_mag)
                for p in pkts]

    assert sn.blocks_dispatched == file_run.sn.blocks_dispatched == 4
    assert key(got) == key(want) and sum(p.crc_ok for p in got) >= 2
    assert pending_writes and not any(pending_writes)
    assert len(sn._slots) <= 3 and all(s.host.is_pinned() for s in sn._slots)


def test_run_live_reads_ahead_on_card(dev):
    """run_live at pipeline 2 over the native ring while a feed thread
    writes it, at 131072 samples a block on the benchmark's air (dense
    enough to rescan): the file run's packets, and some blocks already
    read when the loop comes to take them (how many depends on the host's
    timing, so the share is reported, not held to a bound)."""
    import json
    import threading
    import time
    from pathlib import Path

    from btle_tpu_torch import runtime
    from btle_tpu_torch.utils import profiling as P
    from btle_tpu_torch.wideband.stream import WidebandStreamRunner
    from portbench.scenes import ble_air

    if not runtime.available():
        pytest.skip("the native runtime did not build (no g++)")
    traffic = Path(__file__).resolve().parent.parent / "portbench/traffic/replay_128k.json"
    scene = ble_air.generate(json.loads(traffic.read_text())["scene"], 7, 3)
    cfg = WidebandConfig(scan_len_ch=131072, fused=True, fused_dtype="bf16x2w")
    live = WidebandStreamRunner(WidebandSniffer(cfg, device=dev),
                                ndjson=S.NdjsonEmitter(io.StringIO()))
    sn = live.sn
    step, blocks = 131072 * 20, 52
    n = blocks * step + sn.halo_ch * 20
    i16 = np.resize(scene.iq[0::2], n)
    q16 = np.resize(scene.iq[1::2], n)
    inter = np.empty(2 * n, np.int16)
    inter[0::2], inter[1::2] = i16, q16
    cap = 1 << 25
    ring = runtime.IqRingBuffer(cap)
    fed = threading.Event()

    def feed():
        off = 0
        while off < n:
            k = min(1 << 20, n - off)
            if cap - ring.available_pairs < k:
                time.sleep(0.0002)
                continue
            assert ring.write(inter[2 * off: 2 * (off + k)], "i16") == k
            off += k
        fed.set()

    got = []
    consume = live.consume
    live.consume = lambda h: got.extend(consume(h)) or got
    feeder = threading.Thread(target=feed)
    tr = P.Tracer(1 << 14)
    feeder.start()
    try:
        with P.tracing(tr):
            live.run_live(ring, pipeline=2, should_stop=lambda: fed.is_set() and
                          ring.available_pairs < sn.wb_block_len)
    finally:
        feeder.join(timeout=60)
        ring.close()
    assert not feeder.is_alive()
    file_run = WidebandStreamRunner(WidebandSniffer(cfg, device=dev))
    want = file_run.run_capture(i16, q16)

    def key(pkts):
        return [(p.channel, p.sample_pos, p.crc_ok, p.pdu_bytes.tobytes(), p.rssi_mag)
                for p in pkts]

    assert sn.blocks_dispatched == file_run.sn.blocks_dispatched == blocks
    assert key(got) == key(want) and sum(p.crc_ok for p in got) >= blocks
    assert sn.truncated_channels > 0
    ready = tr.totals()["counters"].get("read_ready", 0)
    print(f"read_ready {ready} of {blocks} blocks")
    assert ready > 0


@pytest.mark.parametrize("kw", [dict(compute_dtype="bf16x2w"),
                                dict(compute_dtype="f32"),
                                dict(compute_dtype="bf16x2w", phy="2m"),
                                dict(compute_dtype="f32", phy="2m"),
                                dict(pipeline="xla")])
def test_selftest_on_card(dev, kw):
    assert fused_selftest(device=dev, **kw) == fused_selftest(device="cpu", **kw)


def test_wrappers_reject_bad_operands(dev):
    y = torch.zeros((80, 4000), device=dev)
    aa = torch.zeros((40, 32), dtype=torch.int8, device=dev)
    mask = torch.ones(32, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        fused.demod_tail(y, aa.to(torch.int32), mask, 4, 4, 3000, 2800)
    with pytest.raises(ValueError):
        fused.demod_tail(y, aa, mask.cpu(), 4, 4, 3000, 2800)
    with pytest.raises(ValueError):
        fused.filterbank_bf16x2w(y[:40].to(torch.float32),
                                 torch.zeros((5, 160, 520), dtype=torch.bfloat16,
                                             device=dev), 65, 3000)
    frames = torch.zeros((3064, 40), dtype=torch.bfloat16, device=dev)
    b = torch.zeros((2624, 160), dtype=torch.bfloat16, device=dev)
    for bad in ((frames, b[:2600]), (frames.t().contiguous(), b), (frames, b[:, :80])):
        with pytest.raises(ValueError):
            fused.filterbank_bf16x2w(*bad, 65, 3000)
    with pytest.raises(ValueError):       # f32x2 takes the (2, J, 40) pair
        fused.filterbank_im2col(frames, b, 65, 3000, "f32x2")
    with pytest.raises(ValueError):       # bf16 takes the (K_pad, 80) table
        fused.filterbank_im2col(frames, b, 65, 3000, "bf16")


# the demod tail (K2): label, sps, lag, Ky, n_bits short of its largest,
# care mask
TAIL_CASES = [
    ("sps4_lag4", 4, 4, 6000, 3, "holes"),
    ("sps1_lag1", 1, 1, 5003, 0, "holes"),
    ("sps2_lag1", 2, 1, 4500, 1, "holes"),
    ("sps8_lag8", 8, 8, 7001, 0, "holes"),
    ("sps4_lag1", 4, 1, 4801, 0, "holes"),
    ("sps8_lag1", 8, 1, 3000, 0, "holes"),
    ("zero_mask", 4, 4, 4099, 0, "zero"),
    ("live", 4, 4, 9668, 0, "ones"),        # the CLI's 8192-sample blocks
    ("k8_probe", 4, 4, 2176, 0, "ones"),    # K8 tail: (80, 2176), 2172 decisions
]


@pytest.mark.parametrize("label,sps,lag,ky,cut,mask_kind", TAIL_CASES)
def test_demod_tail_bit_exact(dev, label, sps, lag, ky, cut, mask_kind):
    """K2 against its twin, torch.equal on bits, hit and mag: n_bits no
    2048-position tile divides, sps 1, 2, 4 and 8, lag 1 (odd bins flip),
    4 and 8, per-channel AA rows, a care mask with holes and an all-zero
    one, zero columns (d == 0 ties) and a wide dynamic range (the RSSI
    tree's order shows in mag's last bits), at the live block's and K8's
    probe shapes. One launch."""
    rng = np.random.default_rng(ky + sps)
    y = rng.normal(size=(80, ky)) * np.exp(2.0 * rng.normal(size=(80, ky)))
    y[:, 700:760] = 0.0
    y = torch.as_tensor(y.astype(np.float32), device=dev)
    n_bits = min(ky - lag, ky - sps + 1) - cut
    n_hit = n_bits - 31 * sps
    assert n_bits % 2048
    mask = torch.ones(32, dtype=torch.int8)
    if mask_kind == "holes":
        mask[[0, 9, 31]] = 0
    elif mask_kind == "zero":
        mask[:] = 0
    mask = mask.to(dev)
    # each channel's AA row: its own decisions from a random position
    zero_rows = torch.zeros((40, 32), dtype=torch.int8, device=dev)
    bits = fused.demod_tail_reference(y, zero_rows, mask, sps, lag, n_bits, n_hit)[0]
    idx = torch.as_tensor(rng.integers(0, n_hit, (40, 1)) + sps * np.arange(32)[None],
                          device=dev)
    aa_rows = bits.gather(1, idx).contiguous()
    before = fused.DEMOD_TAIL.launches
    got = fused.demod_tail(y, aa_rows, mask, sps, lag, n_bits, n_hit)
    want = fused.demod_tail_reference(y, aa_rows, mask, sps, lag, n_bits, n_hit)
    torch.cuda.synchronize()
    assert fused.DEMOD_TAIL.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    hits = int(want[1].sum())
    assert hits == 40 * n_hit if mask_kind == "zero" else hits >= 40


# --------------------------------------------------------------------------
# the narrowband scan (K7), K4's clamped tail, the narrowband Sniffer
# --------------------------------------------------------------------------


ADV_AA_HEX = "d6be898e"
CONN_AA = 0x60850A1B
CONN_AA_HEX = "1b0a8560"          # on-air order of CONN_AA
CONN_CRC_HEX = "a77b22"


def _nb_burst(pdu, ch, sps=4, amplitude=2000.0, aa_hex=ADV_AA_HEX,
              crc_hex="555555"):
    bits = assemble_phy_bits(B.bytes_to_bits(np.asarray(pdu, np.uint8)), ch,
                             crc_init_hex=crc_hex, access_address_hex=aa_hex)
    return gfsk_modulate_float(bits, sps, amplitude)


def _nb_scene(seed, n, bursts, noise=40.0):
    """int16 (i, q): Gaussian noise plus each (pos, (ci, cq)) burst."""
    rng = np.random.default_rng(seed)
    i, q = rng.normal(0, noise, (2, n))
    for pos, (ci, cq) in bursts:
        m = min(len(ci), n - pos)
        i[pos:pos + m] += ci[:m]
        q[pos:pos + m] += cq[:m]
    clip = lambda x: np.clip(np.round(x), -32768, 32767).astype(np.int16)
    return clip(i), clip(q)


def _adv_pdu(rng, n):
    return np.concatenate([[0x02, n], rng.integers(0, 256, n)]).astype(np.uint8)


SCAN_CASES = [
    # rows, n, sps, lag, mask_hex, float rows, amplitude, burst positions
    # (None: three at random)
    (1, 131_072 + 1473, 4, 1, "ffffffff", False, 2000.0, None),
    (1, 50_003, 2, 1, "ffffffff", False, 2000.0, None),
    (1, 60_011, 8, 8, "ffffffff", False, 127.0, None),
    (1, 20_000 + 1, 4, 1, "00000000", False, 2000.0, None),
    (3, 30_007, 4, 1, "ffff0fff", False, 32000.0, None),
    (40, 9_001, 4, 4, "f7fffffe", True, 1.0, None),
    # the edges of the kernel's 512-position tiles: the live 8192-sample
    # block; n_hit = 0; n_bits one past a tile (odd row lengths: byte
    # stores); lag 8 at sps 1 and 2; AA windows that run across a tile's
    # end into the next tile's positions
    (1, 8192 + 1473, 4, 1, "ffffffff", False, 2000.0, (1000, 4000, 7000)),
    (2, 1 + 31 * 4, 4, 1, "ffffffff", False, 2000.0, ()),
    (2, 20 * 512 + 1 + 1, 4, 1, "ffffffff", False, 2000.0, (1000, 5000, 9000)),
    (1, 30_001, 1, 8, "ffffffff", False, 2000.0, None),
    (1, 30_003, 2, 8, "ffffffff", False, 2000.0, None),
    (1, 20_000, 4, 1, "ffffffff", False, 2000.0,
     (8 * 512 - 60, 16 * 512 - 90, 24 * 512 - 120, 32 * 512 - 150)),
]


@pytest.mark.parametrize("rows,n,sps,lag,mask_hex,floats,amp,at", SCAN_CASES)
def test_scan_kernel_matches_twin(dev, rows, n, sps, lag, mask_hex, floats, amp, at):
    rng = np.random.default_rng(n)
    ii, qq = [], []
    for r in range(rows):
        starts = rng.integers(0, n - 2000, 3) if at is None else at
        bursts = [(int(p), _nb_burst(_adv_pdu(rng, 12), 37, sps, amp)) for p in starts]
        i, q = _nb_scene(r + n, n, bursts, noise=max(2.0, amp / 50))
        ii.append(i)
        qq.append(q)
    i, q = np.stack(ii), np.stack(qq)
    if floats:
        i = i.astype(np.float32) * np.float32(0.37)
        q = q.astype(np.float32) * np.float32(0.37) + rng.normal(
            0, 0.3, q.shape).astype(np.float32)
    aa = np.tile(B.hex_to_bits(ADV_AA_HEX), (rows, 1))
    aa[1::2] = rng.integers(0, 2, (len(aa[1::2]), 32))
    mask = B.hex_to_bits(mask_hex)
    args = [torch.as_tensor(a, device=dev) for a in (i, q, aa, mask)]
    before = SCAN_BLOCK.launches
    hit, bits = scan_block_kernel(*args, sps, lag)
    want = scan_block_reference(*args, sps, lag)
    assert SCAN_BLOCK.launches == before + 1
    assert torch.equal(bits, want[1]) and torch.equal(hit, want[0])
    assert hit.shape == (rows, n - lag - 31 * sps) and bits.dtype == torch.int8
    if mask_hex == "00000000":
        assert bool(hit.all())
    elif not floats and lag <= sps and (at is None or len(at) >= 3):
        assert int(hit[0].sum()) >= 3
    if at is not None and len(at) == 4:
        # a window from the last 31*sps positions of a tile reads the next's
        starts = torch.nonzero(hit[0]).flatten() % 512
        assert bool((starts + 31 * sps >= 512).any())
    cpu = scan_block_reference(*[a.cpu() for a in args], sps, lag)
    assert torch.equal(cpu[0], hit.cpu()) and torch.equal(cpu[1], bits.cpu())


def test_scan_kernel_1d_and_rejects(dev):
    i, q = _nb_scene(1, 5000, [(700, _nb_burst(_adv_pdu(np.random.default_rng(1), 9), 37))])
    ti, tq = torch.as_tensor(i, device=dev), torch.as_tensor(q, device=dev)
    aa = torch.as_tensor(B.hex_to_bits(ADV_AA_HEX), device=dev)
    mask = torch.ones(32, dtype=torch.int8, device=dev)
    hit, bits = scan_block_kernel(ti, tq, aa, mask, 4, 1)
    want = scan_block_reference(ti, tq, aa, mask, 4, 1)
    assert hit.ndim == 1 and torch.equal(hit, want[0]) and torch.equal(bits, want[1])
    with pytest.raises(ValueError):
        scan_block_kernel(ti.to(torch.int32), tq.to(torch.int32), aa, mask, 4, 1)
    with pytest.raises(ValueError):
        scan_block_kernel(ti[:100], tq[:100], aa, mask, 4, 1)


@pytest.mark.parametrize("sps", [4, 2, 8])
def test_decode_clamp_tail_on_card(dev, sps):
    """Candidates whose 336-bit window runs past the lattice, and
    positions past it: clamp_tail=True equals the clamped twin (the XLA
    decode's gathers) on the card and on the CPU."""
    rng = np.random.default_rng(sps)
    m, kb, c = 5, 4001, 12
    bits = torch.as_tensor(rng.integers(0, 2, (m, kb)), dtype=torch.int8)
    pos = torch.as_tensor(rng.integers(0, kb, (m, c)), dtype=torch.int32)
    pos[:, -4:] = torch.as_tensor(kb - 1 - rng.integers(0, 1500, (m, 4)))
    pos[0, 0] = kb + 30
    whiten = torch.as_tensor(np.stack([W.whitening_bits(ch, 336)
                                       for ch in (37, 3, 38, 9, 20)]))
    crc = torch.as_tensor(rng.integers(0, 1 << 24, m), dtype=torch.int32)
    adv = torch.tensor([True, False, True, False, False])
    cpu = decode_candidates_reference(bits, pos, whiten, crc, adv, sps, True)
    args = [t.to(dev) for t in (bits, pos, whiten, crc, adv)]
    before = DECODE_CANDIDATES.launches
    got = decode_candidates(*args, sps=sps, clamp_tail=True)
    twin = decode_candidates_reference(*args, sps, True)
    assert DECODE_CANDIDATES.launches == before + 1
    for g, t, x in zip(got, twin, cpu):
        assert torch.equal(g, t) and torch.equal(g.cpu(), x)
    zero = decode_candidates(*args, sps=sps, clamp_tail=False)
    assert not torch.equal(zero[0], got[0])


def _connect_req(hop=9, interval=16):
    payload = (bytes.fromhex("001830EA965F")[::-1] + bytes.fromhex("90D7EBB19299")[::-1]
               + CONN_AA.to_bytes(4, "little") + bytes.fromhex(CONN_CRC_HEX)
               + bytes([0x02]) + (0x000F).to_bytes(2, "little")
               + interval.to_bytes(2, "little") + (0).to_bytes(2, "little")
               + (0x07D0).to_bytes(2, "little") + bytes.fromhex("1FFFFFFFFF")[::-1]
               + bytes([hop | (5 << 5)]))
    return np.frombuffer(bytes([0x05, len(payload)]) + payload, np.uint8)


def _data_burst(rng, ch, n=8):
    pdu = np.concatenate([[0x01, n], rng.integers(0, 256, n)]).astype(np.uint8)
    return _nb_burst(pdu, ch, aa_hex=CONN_AA_HEX, crc_hex=CONN_CRC_HEX)


def test_narrowband_sniffer_on_card_matches_cpu(dev, monkeypatch):
    """tests/test_hop.py's two-hop scene (CONNECT_REQ on 37, data on 9
    then 18) plus ADV traffic: events, NDJSON, pcap and hop events of the
    Sniffer on the card equal those on the CPU, at two block sizes."""
    import time

    rng = np.random.default_rng(0)
    bursts = [(1000, _nb_burst(_adv_pdu(rng, 20), 37)),
              (6000, _nb_burst(_adv_pdu(rng, 37), 37)),
              (10_000, _nb_burst(_connect_req(), 37)),
              (36_000, _data_burst(rng, 9)),
              (96_000, _data_burst(rng, 18, 21))]
    i, q = _nb_scene(5, 120_000, bursts)
    monkeypatch.setattr(time, "time", lambda: 1715680000.5)
    for scan_len in (8192, 16384):
        out = []
        for device in ("cpu", dev):
            buf, pc = io.StringIO(), io.BytesIO()
            sn = S.Sniffer(S.SnifferConfig(channel=37, sps=4, hop=True, rssi=True,
                                           scan_len=scan_len),
                           ndjson=S.NdjsonEmitter(buf), pcap=S.PcapWriter(pc),
                           quiet_text=True, device=device)
            events = sn.run(S.array_source(i, q))
            out.append(([(e.ts_us, e.channel, e.access_addr, e.crc_ok,
                          e.payload_bytes, e.rssi_dbm) for e in events],
                        buf.getvalue(), pc.getvalue(),
                        [(e.event, e.channel) for e in sn.hop_tracker.events]))
        assert out[0] == out[1]
        assert sum(e[3] for e in out[1][0]) == (5 if scan_len == 8192 else 4)
        assert [e[0] for e in out[1][3]][:2] == ["track_start", "chan_change"]


# --------------------------------------------------------------------------
# the probes' kernels (aa_corr, shift_stack, shift_fma), K3 at rows 80 and
# the TX modulator
# --------------------------------------------------------------------------


AA_CASES = [
    # sps, lattice form, grp, n_out, lattice columns, columns per CTA (None:
    # not checked); 40 rows each
    *[(sps, form, grp, 5000 + 37 * sps, 5000 + 68 * sps + 11, None)
      for sps in (2, 4, 8) for form in ("f32", "int8") for grp in (1, 4, 8, 32)],
    # wide 2048-column tiles (40 rows x 7 or 8 tiles): n_out one below, at
    # and one above a tile's end, 16-byte (f32) and 4-byte (int8) loads
    (4, "f32", 8, 7 * 2048 - 1, 7 * 2048 + 128, 2048),
    (4, "int8", 1, 7 * 2048, 7 * 2048 + 128, 2048),
    (4, "f32", 2, 7 * 2048 + 1, 7 * 2048 + 132, 2048),
    # sps 1, 2 and 8 on wide tiles (4096 columns at sps 8)
    (1, "f32", 16, 6 * 2048 + 5, 6 * 2048 + 40, 2048),
    (1, "int8", 4, 6 * 2048 + 5, 6 * 2048 + 40, 2048),
    (2, "f32", 2, 7 * 2048 + 3, 7 * 2048 + 68, 2048),
    (8, "int8", 32, 7 * 4096 - 3, 7 * 4096 + 248, 4096),
    # few columns: the narrow tile (the K8 and K9 probes' 40 x 2048)
    (4, "int8", 8, 2048, 2048 + 124, 256),
    (4, "f32", 8, 2048, 2048 + 124 + 8, 256),
    # sps 3 takes the narrow tile at any size
    (3, "f32", 4, 7 * 2048, 7 * 2048 + 100, 256),
    # row strides that are not a multiple of 16 (f32) or 4 (int8) bytes:
    # scalar loads
    (4, "f32", 8, 7 * 2048, 7 * 2048 + 125, 2048),
    (4, "int8", 4, 7 * 2048, 7 * 2048 + 127, 2048),
    # the K11 probe's shape
    (4, "f32", 1, 131_072, 131_072 + 128, 2048),
]


@pytest.mark.parametrize("sps,form,grp,n_out,cols,tile", AA_CASES)
def test_aa_corr_matches_twin(dev, sps, form, grp, n_out, cols, tile):
    """Exact against the twin on +-1/0 lattices (int8: any decision,
    0 maps to -1), with masked signs (0 weights), ragged n_out, the wide
    (persistent) and the narrow tile, vector and scalar loads."""
    from btle_tpu_torch.tools._kernels import AA_CORR, aa_corr, aa_corr_plan, aa_corr_reference

    rng = np.random.default_rng(sps * 10 + grp)
    if form == "int8":
        s = torch.as_tensor(rng.integers(-1, 2, (40, cols)), dtype=torch.int8)
    else:
        s = torch.as_tensor(rng.choice([-1.0, 0.0, 1.0], (40, cols)), dtype=torch.float32)
    w = torch.as_tensor(rng.choice([-1.0, 0.0, 1.0], (40, 32)), dtype=torch.float32)
    s[:5, 100:100 + 32 * sps:sps] = (w[:5] if form == "f32" else w[:5].to(torch.int8))
    at = n_out - 1 - 31 * sps          # a window whose last tap is the last column
    s[5:8, at:at + 32 * sps:sps] = (w[5:8] if form == "f32" else w[5:8].to(torch.int8))
    want = aa_corr_reference(s, w, sps, n_out, n_mask=30)
    sd = s.to(dev)
    before = AA_CORR.launches
    got = aa_corr(sd, w.to(dev), sps, n_out, grp=grp, n_mask=30)
    torch.cuda.synchronize()
    assert AA_CORR.launches == before + 1
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    if tile is not None:
        assert aa_corr_plan(sd, sps, n_out, grp)["tile_columns"] == tile


# (rows, nbp, grp, sps, k0): every grp and sps, k0 zero, negative, past
# nbp and unaligned, nbp not a multiple of 4 (rows of unaligned bases:
# scalar heads, tails and seam groups), one row and 40, K9's shape, and
# rows long enough for several segments a row
STACK_CASES = [
    (40, 2176, 4, 4, 0), (40, 2176, 8, 4, 64), (40, 2176, 16, 2, 0), (40, 2176, 8, 8, -8),
    (40, 2176, 1, 4, 0), (40, 2176, 8, 1, 3), (40, 2176, 8, 2, -5), (40, 2176, 16, 8, 5000),
    (40, 2175, 8, 4, 0), (40, 2177, 4, 1, 7), (40, 2178, 16, 2, -2179), (40, 2179, 1, 8, 2181),
    (1, 2176, 8, 4, 0), (1, 131, 16, 8, -1), (1, 3, 4, 1, 2), (1, 1, 1, 1, -7),
    (3, 9001, 4, 4, 1), (40, 3 * 4096 + 6, 8, 4, -13), (2, 5, 16, 1, 0),
]


@pytest.mark.parametrize("rows,nbp,grp,sps,k0", STACK_CASES)
def test_shift_stack_matches_twin(dev, rows, nbp, grp, sps, k0):
    from btle_tpu_torch.tools._kernels import (SHIFT_STACK, shift_stack, shift_stack_plan,
                                               shift_stack_reference)

    rng = np.random.default_rng(grp * 131 + nbp)
    s = torch.as_tensor(rng.normal(size=(rows, nbp)), dtype=torch.float32)
    sd = s.to(dev)
    before = SHIFT_STACK.launches
    got = shift_stack(sd, grp, sps, k0)
    torch.cuda.synchronize()
    assert SHIFT_STACK.launches == before + 1
    assert torch.equal(got.cpu(), shift_stack_reference(s, grp, sps, k0))
    plan = shift_stack_plan(sd, grp)
    assert plan["threads"] == 256 and plan["tile_columns"] <= 4 * 1024
    assert plan["ctas"] <= plan["ctas_per_sm"] * torch.cuda.get_device_properties(
        dev).multi_processor_count


def test_shift_stack_refuses(dev):
    from btle_tpu_torch.tools._kernels import shift_stack

    s = torch.zeros((4, 64), device=dev)
    with pytest.raises(ValueError):
        shift_stack(s, 65, 4)
    with pytest.raises(ValueError):
        shift_stack(s.to(torch.float64), 8, 4)


@pytest.mark.parametrize("n_cols,pad,copy_bytes", [
    (4 * 2048 + 77, 5, 4),       # ragged tile, row stride not a multiple of 4 floats
    (4 * 2048 + 76, 4, 16),      # row stride 16-byte aligned: 16-byte copies
    (1000, 0, 16),               # one partial tile, the frames just long enough
])
@pytest.mark.parametrize("rows,n,step,grp", [(40, 65, 2, 8), (80, 33, 4, 8),
                                             (160, 17, 8, 4)])
def test_shift_fma_matches_twin(dev, rows, n, step, grp, n_cols, pad, copy_bytes):
    """Within 1e-5 of max |out|: the same products summed in another
    order (the kernel one FMA per tap in j order, the twin the tool's
    groups), at an n_cols no 512-column tile divides, with 4- and
    16-byte row copies; 16 resident warps per SM."""
    from btle_tpu_torch.tools._kernels import (SHIFT_FMA, shift_fma, shift_fma_plan,
                                               shift_fma_reference)

    gen = torch.Generator(device=dev).manual_seed(rows)
    f = torch.randn((rows, n_cols + step * (n - 1) + pad), generator=gen, device=dev)
    kc = torch.randn((rows, n), generator=gen, device=dev)
    plan = shift_fma_plan(f, kc, n_cols, step)
    assert plan["copy_bytes"] == copy_bytes and plan["tile_columns"] == 512
    assert plan["ctas_per_sm"] * plan["threads"] >= 16 * 32
    before = SHIFT_FMA.launches
    got = shift_fma(f, kc, n_cols, step, grp)
    want = shift_fma_reference(f, kc, n_cols, step, grp)
    torch.cuda.synchronize()
    assert SHIFT_FMA.launches == before + 1
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    with pytest.raises(ValueError):
        shift_fma(f, kc, n_cols, 3, grp)


def test_polyx_at_80_rows_is_a_true_fp32_product(dev):
    """K3 at rows 80, one slice, all-ones coefficients: y = W @ F, held
    against the product in float64 (true FP32 sums of 80 terms)."""
    rng = np.random.default_rng(80)
    f = rng.normal(size=(80, 4096)).astype(np.float32)
    w = rng.normal(size=(80, 80)).astype(np.float32)
    ones = torch.ones((80, 1), device=dev)
    y = fused.filterbank_polyx_f32(torch.as_tensor(f, device=dev), ones,
                                   torch.as_tensor(w, device=dev), 4000, stack=1)
    torch.cuda.synchronize()
    want = w.astype(np.float64) @ f[:, :4000].astype(np.float64)
    assert np.abs(y.cpu().numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("flavor,sps", [("c", 4), ("python", 8), ("python", 4)])
def test_modulator_on_card_matches_cpu(dev, flavor, sps):
    from btle_tpu_torch.phy.modulator import modulate_batch

    rng = np.random.default_rng(sps)
    bits = torch.as_tensor(rng.integers(0, 2, (6, 2000)), dtype=torch.int8)
    got = modulate_batch(bits.to(dev), flavor, sps)
    want = modulate_batch(bits, flavor, sps)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)


def test_probes_run_on_card(dev):
    """Every probe's run() on the card at 2 tiles: each exact variant an
    exact match, each checksum pair MATCH."""
    from btle_tpu_torch.tools import (dev_aagrp_bisect, dev_aagrp_repro,
                                      dev_roll_experiment, dev_rollscale)

    assert dev_aagrp_repro.run(dev)["failures"] == 0
    assert dev_aagrp_bisect.run(dev)["failures"] == 0
    assert dev_rollscale.run(dev, n_tiles=2, iters=4, trials=1)["failures"] == 0
    for dtype in ("f32", "bf16"):
        res = dev_roll_experiment.run(dev, dtype=dtype, n_tiles=2, iters=4, trials=1)
        assert res["failures"] == 0 and set(res["pairs"].values()) == {"MATCH"}


# --------------------------------------------------------------------------
# V1 (csrc/viterbi.cu), the LE Coded receivers, the BER harness and the
# fused modes at the anchor SNR
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rows,n", [(160, 364), (4, 364), (3, 8), (37, 130),
                                    (2, 2), (5, 4000)])
@pytest.mark.parametrize("hard", [False, True])
def test_viterbi_r2_matches_twin(dev, rows, n, hard):
    """V1 bit for bit (bits and pm_end) with its twin: random soft inputs,
    and hard +-1 inputs with exact zeros (ties everywhere); n = 4000 runs
    one warp a CTA above 48 KB of shared memory."""
    from btle_tpu_torch.phy.viterbi import (VITERBI_R2, viterbi_decode_r2,
                                            viterbi_decode_r2_reference)

    gen = torch.Generator(device=dev).manual_seed(rows * n)
    la = torch.randn((rows, n), generator=gen, device=dev)
    lb = torch.randn((rows, n), generator=gen, device=dev)
    if hard:
        la, lb = la.sign(), lb.sign()
        la[:, ::7] = 0.0
    before = VITERBI_R2.launches
    bits, pm = viterbi_decode_r2(la, lb, n)
    torch.cuda.synchronize()
    assert VITERBI_R2.launches == before + 1
    want = viterbi_decode_r2_reference(la, lb)
    assert torch.equal(bits, want[0]) and torch.equal(pm, want[1])
    with pytest.raises(ValueError):
        viterbi_decode_r2(la[:, :3], lb[:, :3], 3)


def _coded_capture(seed, s, sigma):
    from btle_tpu_torch.spec import coded as K

    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, 12, dtype=np.uint8)
    pdu = np.concatenate([[0x42, 12], payload]).astype(np.uint8)
    sym = K.assemble_coded_phy(B.bytes_to_bits(pdu), 37, s=s)
    ci, cq = gfsk_modulate_float(sym, 4)
    n = len(ci) + 4000
    wi = rng.normal(0, sigma, n).astype(np.float32)
    wq = rng.normal(0, sigma, n).astype(np.float32)
    wi[1000: 1000 + len(ci)] += ci
    wq[1000: 1000 + len(cq)] += cq
    return wi, wq, pdu


@pytest.mark.parametrize("s,sigma", [(8, 20.0), (2, 20.0), (8, 60.0)])
def test_decode_coded_on_card_matches_cpu(dev, s, sigma):
    from btle_tpu_torch.phy.viterbi import VITERBI_R2
    from btle_tpu_torch.rx.coded import decode_coded

    wi, wq, pdu = _coded_capture(s, s, sigma)
    before = VITERBI_R2.launches
    got = decode_coded(wi, wq, 37, device=dev, max_candidates=8)
    assert VITERBI_R2.launches == before + 1
    want = decode_coded(wi, wq, 37, device="cpu", max_candidates=8)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert all(np.array_equal(g[k], w[k]) for k in w)
    assert got[0]["crc_ok"] and got[0]["s"] == s
    assert np.array_equal(got[0]["pdu_bytes"][: len(pdu)], pdu)


def test_scan_coded_capture_on_card_matches_cpu(dev):
    """The 40-channel coded scan: one V1 launch for all 40 x 4 trellises,
    the CPU's packets."""
    from btle_tpu_torch.phy.viterbi import VITERBI_R2
    from btle_tpu_torch.spec import coded as K
    from btle_tpu_torch.wideband.coded import scan_coded_capture

    rng = np.random.default_rng(0)
    n = 160_000
    placements, exp = [], {}
    for k, (ch, s) in enumerate([(37, 8), (9, 2), (25, 8)]):
        pdu = np.concatenate([[0x42, 8], rng.integers(0, 256, 8)]).astype(np.uint8)
        ci, cq = gfsk_modulate_float(
            K.assemble_coded_phy(B.bytes_to_bits(pdu), ch, s=s), 80)
        placements.append((ch, 8000 + 9000 * k, ci, cq))
        exp[ch] = (pdu, s)
    wi, wq = compose_wideband(placements, n)
    wi += rng.normal(0, 3, n).astype(np.float32)
    wq += rng.normal(0, 3, n).astype(np.float32)
    before = VITERBI_R2.launches
    got = scan_coded_capture(wi, wq, device=dev)
    assert VITERBI_R2.launches == before + 1
    want = scan_coded_capture(wi, wq, device="cpu")
    key = [(p["channel"], p["pos"], p["s"], p["crc_ok"], bytes(p["pdu_bytes"]))
           for p in got]
    assert key == [(p["channel"], p["pos"], p["s"], p["crc_ok"],
                    bytes(p["pdu_bytes"])) for p in want]
    ok = {p["channel"]: p for p in got if p["crc_ok"]}
    assert set(ok) == set(exp)
    for ch, (pdu, s) in exp.items():
        assert ok[ch]["s"] == s and np.array_equal(ok[ch]["pdu_bytes"], pdu)


def test_ber_harness_on_card(dev):
    """One batch on the card with injected draws equals the CPU's; the
    anchor and clean-channel statistics of tests/test_sim.py hold."""
    from btle_tpu_torch.sim import BerHarness, reference_max_snr

    h, hc = BerHarness(device=dev), BerHarness(device="cpu")
    rng = np.random.default_rng(5)
    phys, pdus = hc.make_packets(hc.BATCH, rng)
    n = phys.shape[1] * hc.sps + 2 * hc.sps
    noise = rng.standard_normal((2, hc.BATCH, n)).astype(np.float32)
    got = h.run_batch(phys, pdus, 14.0, 30.0, noise=noise)
    want = hc.run_batch(phys, pdus, 14.0, 30.0, noise=noise)
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))
    for ppm in (0.0, 50.0):
        ber, ok, _ = h.ber_point(reference_max_snr(ppm), ppm, 60, seed=11)
        assert ber <= 5e-3 and ok >= 55
    assert h.ber_point(40.0, 0.0, 20, seed=6)[0] == 0.0


def test_fused_modes_at_anchor_snr(dev):
    """Every shipped fused mode on the card at 11 dB (the JAX package's
    sensitivity scene): at least 23 of 25, within 1 packet of "f32"."""
    from btle_tpu_torch.tools import sensitivity

    res = sensitivity.run(dev)
    assert sensitivity.check(res) == [], res


# --------------------------------------------------------------------------
# the recon chain and passive decryption on the card
# --------------------------------------------------------------------------


def _cli(argv) -> str:
    import contextlib

    from btle_tpu_torch.cli.app import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert main([str(a) for a in argv]) == 0
    return out.getvalue()


def test_scan_cli_on_card_matches_cpu(dev, tmp_path):
    """``scan`` (--json and the table) on the card equals --device cpu
    byte for byte (exact integer paths, no RSSI asked), through K7 and
    K4."""
    rng = np.random.default_rng(21)
    n = 600_000
    i, q = rng.normal(0, 40, n), rng.normal(0, 40, n)
    for k in range(12):
        mac = bytes([k, 1, 2, 3, 4, 5])
        payload = mac + bytes([6, 0x09]) + b"tag-%d" % (k % 4) + bytes([4, 0xFF, 0x59, 0, k])
        pdu = np.frombuffer(bytes([0x02, len(payload)]) + payload, np.uint8)
        ci, cq = gfsk_modulate_float(assemble_phy_bits(B.bytes_to_bits(pdu), 37), 4, 2000.0)
        at = 2000 + 45_000 * k
        i[at:at + len(ci)] += ci
        q[at:at + len(cq)] += cq
    inter = np.empty(2 * n, np.int16)
    inter[0::2], inter[1::2] = np.round(i), np.round(q)
    path = tmp_path / "adv.i16"
    inter.tofile(path)
    for extra in (["--json"], []):
        argv = ["scan", "--bin", path, "--format", "i16", *extra]
        before = (SCAN_BLOCK.launches, DECODE_CANDIDATES.launches)
        card = _cli(argv)
        assert SCAN_BLOCK.launches > before[0] and DECODE_CANDIDATES.launches > before[1]
        assert card == _cli([*argv, "--device", "cpu"])
    assert len(card.splitlines()) == 1 + 12


def test_wideband_ltk_on_card_matches_cpu(dev, tmp_path):
    """``wideband --ltk`` through the fused front end on the card: a
    followed connection keyed by its LL_ENC_REQ/RSP, an encrypted ATT
    write decrypted in-stream; the CRC-OK events and plaintexts equal the
    CPU path's, and ``recon gatt --ltk`` on the card's pcap lists the
    write."""
    import json

    from btle_tpu_torch.cli import recon
    from btle_tpu_torch.ll.crypto import LlSession
    from btle_tpu_torch.stream import NdjsonEmitter, PcapWriter
    from btle_tpu_torch.wideband.stream import WidebandStreamRunner

    ltk = bytes.fromhex("4C68384139F574D836BCF34E9DFB01BF")
    skd_m, skd_s = bytes.fromhex("13024212ACDEAF99"), bytes.fromhex("7907E2021B24D379")
    iv_m, iv_s = bytes.fromhex("BADCAB24"), bytes.fromhex("DEAFBABE")
    att = bytes([5, 0, 4, 0, 0x12, 0x33, 0x00, 0x07, 0x08])
    enc = LlSession.from_enc_exchange(ltk, skd_m, skd_s, iv_m, iv_s).encrypt(0x02, att, 0)
    aa, crc = 0x60850A1B, "a77b22"
    cr = np.frombuffer(bytes([0x05, 34]) + bytes.fromhex("001830EA965F")[::-1]
                       + bytes.fromhex("90D7EBB19299")[::-1] + aa.to_bytes(4, "little")
                       + bytes.fromhex(crc) + bytes([0x02, 0x0F, 0]) + (80).to_bytes(2, "little")
                       + bytes(2) + (0x07D0).to_bytes(2, "little")
                       + bytes.fromhex("1FFFFFFFFF")[::-1] + bytes([9 | (5 << 5)]), np.uint8)
    block = 163_840
    placements = [(37, 20_000, cr, "555555", "d6be898e")]
    for pos, octets in ((block + 20_000, bytes([0x03, 23, 0x03]) + bytes(range(8))
                         + b"\x11\x22" + skd_m + iv_m),
                        (block + 60_000, bytes([0x03, 13, 0x04]) + skd_s + iv_s),
                        (block + 100_000, bytes([0x02, len(enc)]) + enc)):
        placements.append((9, pos, np.frombuffer(octets, np.uint8), crc,
                           aa.to_bytes(4, "little").hex()))
    comp = []
    for ch, pos, pdu, crc_hex, aa_hex in placements:
        ci, cq = gfsk_modulate_float(assemble_phy_bits(
            B.bytes_to_bits(pdu), ch, crc_init_hex=crc_hex, access_address_hex=aa_hex), 80)
        comp.append((ch, pos, ci, cq))
    wi, wq = compose_wideband(comp, 2 * block)
    for mode in ("bf16x2w", "f32"):
        out = []
        for device in ("cpu", dev):
            buf = io.StringIO()
            pcap = tmp_path / f"{mode}-{device}.pcap"
            runner = WidebandStreamRunner(
                WidebandSniffer(WidebandConfig(follow_connections=True, fused=True,
                                               fused_dtype=mode), device=device),
                ndjson=NdjsonEmitter(buf), pcap=PcapWriter(str(pcap)), ltk=ltk)
            runner.run_capture(wi, wq)
            runner.pcap.close()
            evs = [json.loads(ln) for ln in buf.getvalue().splitlines()]
            out.append([(e["ch"], e["aa"], e["payload_hex"], e.get("plain_hex"))
                        for e in evs if e["t"] == "pkt" and e["crc_ok"]])
        assert out[0] == out[1]
        assert [e[3] for e in out[1] if e[3]] == [att.hex()]
        rep = recon.gatt(str(pcap), ltk_hex=ltk.hex())
        assert [(o.name, o.handle, o.value_hex, o.decrypted) for o in rep.ops] == \
            [("ATT_WRITE_REQ", 0x33, "0708", True)]


def _nb_capture(path):
    """Three ADV_NONCONN_IND packets on channel 37 (the port's TX, CPU),
    int16 at amplitude 32 with gaps: the MCP tools' capture."""
    from btle_tpu_torch.tx import parse_descriptor_sequence, synthesize

    descs = [f"37-ADV_NONCONN_IND-TxAdd-0-RxAdd-0-AdvA-0a0b0c0d0e{k:02x}-AdvData-0201{k:02x}"
             for k in range(3)]
    specs, _ = parse_descriptor_sequence(descs)
    pkts = synthesize(specs, flavor="c", sps=4, device="cpu")
    gap = np.zeros(4000, np.int16)
    i = np.concatenate([np.concatenate([p.i.astype(np.int16) * 32, gap]) for p in pkts])
    q = np.concatenate([np.concatenate([p.q.astype(np.int16) * 32, gap]) for p in pkts])
    np.stack([i, q], axis=1).reshape(-1).tofile(path)
    return str(path)


def test_mcp_tools_on_card_match_cpu(dev, tmp_path):
    """The decoding MCP tools on the card (K7 and K4 launched) give the
    dicts they give with device="cpu"."""
    from btle_tpu_torch.cli import mcp_server as T

    cap = _nb_capture(tmp_path / "cap.i16")
    before = (SCAN_BLOCK.launches, DECODE_CANDIDATES.launches)
    assert T.ble_quickscan(cap) == T.ble_quickscan(cap, device="cpu")
    assert (SCAN_BLOCK.launches, DECODE_CANDIDATES.launches) > before
    adv = "0a:0b:0c:0d:0e:01"
    assert T.ble_profile(adv, iq_file=cap) == T.ble_profile(adv, iq_file=cap, device="cpu")
    got = [T.ble_capture_to_pcap(cap, str(tmp_path / f"{d}.pcap"), device=d)
           for d in ("cuda", "cpu")]
    assert got[0]["n_crc_ok"] == got[1]["n_crc_ok"] == 3
    assert _pcap_packets(tmp_path / "cuda.pcap") == _pcap_packets(tmp_path / "cpu.pcap")


def _pcap_packets(path):
    from btle_tpu_torch.stream.pcap import read_pcap

    return [(r.channel, r.access_addr, bytes(r.packet)) for r in read_pcap(str(path))]


def test_bench_narrowband_on_card_matches_twins(dev):
    """bench_narrowband on the card: the kernels' checksum equals the plain
    twins' over the same blocks, and the profiler window reads device
    time."""
    from btle_tpu_torch.tools import bench_narrowband as bn

    n = 1 << 17
    before = (SCAN_BLOCK.launches, DECODE_CANDIDATES.launches)
    res = bn.run(dev, n=n, iters=8, trials=2)
    assert SCAN_BLOCK.launches > before[0] and DECODE_CANDIDATES.launches > before[1]
    plain = bn.checksum(bn.scan_step(dev, plain=True), bn.make_blocks(dev, n))
    assert res["checksum"] == plain
    assert res["ms_per_block"] > 0 and 0.0 <= res["idle_share"] < 1.0
    assert res["host_events_per_block"] > 0 and res["host_event_ms_per_block"] > 0


def test_sharded_scan_nccl_world_one(dev):
    """The sharded scan over NCCL at world size 1, mesh (1, 1): the
    branch-split path and the fused path give the single-device
    sniffer's CRC-OK packets of a two-block scene."""
    import torch.distributed as dist

    from btle_tpu_torch.dist import ShardedWidebandScan, make_mesh
    from btle_tpu_torch.dist.dryrun import free_port

    wi, wq = _scene(13, chans=(37, 4, 22, 39, 12, 30), n=240_000, spacing=35_000)
    want = sorted((p.channel, p.pdu_bytes.tobytes()) for p in WidebandSniffer(
        WidebandConfig(fused=True), device=dev).run(wi, wq) if p.crc_ok)
    assert len(want) == 6
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1, "cuda")
        for kw in ({}, {"fused": True, "fused_dtype": "bf16x2w"},
                   {"fused": True, "fused_dtype": "f32"}):
            scan = ShardedWidebandScan(mesh, block_wb=len(wi), **kw)
            got = sorted((p.channel, p.pdu_bytes.tobytes())
                         for p in scan.gather_packets(scan(wi, wq)) if p.crc_ok)
            assert got == want, kw
    finally:
        dist.destroy_process_group()
