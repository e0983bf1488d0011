"""The CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside
the fixture). chip_smoke.py checks the kernels at bench geometry; these
cover the other shapes the kernels take — lag 1 (odd-bin decision
flip), sps 2 (LE 2M), the 640-tap prototype, a ragged block length,
per-channel AA rows with care-mask holes, an all-zero care mask, float
channel rows in the narrowband scan, candidate windows past the lattice
end in both tail modes, every (compute_dtype, inner) pair of the fused
front end (K1, K3, K5), the tensor-core hi/lo filterbank (K1, K5 f32x2)
at the live block's shape, each column tile, a ragged ky and frames
shorter than ky + width - 1 — every knob-matrix row's self-test, and the
port's device path against its CPU path (wideband sniffer with and
without connection following, its live ring loop, the narrowband
sniffer). They import no JAX, so they
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
# follow the grid — K1 and K5 at "f32x2" on the tensor cores, K5 at "f32"
# (im2col) as a CUDA-core SGEMM — at the shapes the main paths give them:
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
    """K1 and K5 at "f32x2" on the tensor cores, and K5 at "f32" on the
    CUDA cores, against their twins: max |dy| within 1e-5 of max |y|, one
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
    # rows, n, sps, lag, mask_hex, float rows, amplitude
    (1, 131_072 + 1473, 4, 1, "ffffffff", False, 2000.0),
    (1, 50_003, 2, 1, "ffffffff", False, 2000.0),
    (1, 60_011, 8, 8, "ffffffff", False, 127.0),
    (1, 20_000 + 1, 4, 1, "00000000", False, 2000.0),
    (3, 30_007, 4, 1, "ffff0fff", False, 32000.0),
    (40, 9_001, 4, 4, "f7fffffe", True, 1.0),
]


@pytest.mark.parametrize("rows,n,sps,lag,mask_hex,floats,amp", SCAN_CASES)
def test_scan_kernel_matches_twin(dev, rows, n, sps, lag, mask_hex, floats, amp):
    rng = np.random.default_rng(n)
    ii, qq = [], []
    for r in range(rows):
        bursts = [(int(p), _nb_burst(_adv_pdu(rng, 12), 37, sps, amp))
                  for p in rng.integers(0, n - 2000, 3)]
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
    elif not floats:
        assert int(hit[0].sum()) >= 3
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


@pytest.mark.parametrize("sps", [2, 4, 8])
@pytest.mark.parametrize("form", ["f32", "int8"])
@pytest.mark.parametrize("grp", [1, 4, 8, 32])
def test_aa_corr_matches_twin(dev, sps, form, grp):
    """Exact against the twin on +-1/0 lattices (int8: any decision,
    0 maps to -1), with masked signs (0 weights) and a ragged n_out."""
    from btle_tpu_torch.tools._kernels import aa_corr, aa_corr_reference

    rng = np.random.default_rng(sps * 10 + grp)
    n_out = 5000 + 37 * sps
    cols = n_out + 31 * sps + 11
    if form == "int8":
        s = torch.as_tensor(rng.integers(-1, 2, (40, cols)), dtype=torch.int8)
    else:
        s = torch.as_tensor(rng.choice([-1.0, 0.0, 1.0], (40, cols)), dtype=torch.float32)
    w = torch.as_tensor(rng.choice([-1.0, 0.0, 1.0], (40, 32)), dtype=torch.float32)
    s[:5, 100:100 + 32 * sps:sps] = (w[:5] if form == "f32" else w[:5].to(torch.int8))
    want = aa_corr_reference(s, w, sps, n_out, n_mask=30)
    got = aa_corr(s.to(dev), w.to(dev), sps, n_out, grp=grp, n_mask=30)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("grp,sps,k0", [(4, 4, 0), (8, 4, 64), (16, 2, 0), (8, 8, -8)])
def test_shift_stack_matches_twin(dev, grp, sps, k0):
    from btle_tpu_torch.tools._kernels import shift_stack, shift_stack_reference

    rng = np.random.default_rng(grp)
    s = torch.as_tensor(rng.normal(size=(40, 2176)), dtype=torch.float32)
    got = shift_stack(s.to(dev), grp, sps, k0)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), shift_stack_reference(s, grp, sps, k0))


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
