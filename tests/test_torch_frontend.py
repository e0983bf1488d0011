"""The port's fused front end and wideband scan (plain PyTorch twins of
the CUDA kernels, on the CPU) against the JAX package: the Pallas
front end in interpret mode and the XLA wideband scan.

Bars (those btle_tpu holds its own Pallas kernels to,
tests/test_wideband_fused.py): hit lattice identical, < 1e-3 of decision
bits different (float ties in pure noise: the filterbank sums in another
order), mag rtol 1e-4 inside a burst; the "f32" scan slot-exact against
the XLA path with PDU bytes equal over header + payload + CRC and
mag_mean within rtol 0.02 (windowed sums vs the XLA path's block-wide
integer cumsum); "bf16x2w" the same CRC-OK packet set.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from btle_tpu.golden import model as G
from btle_tpu.spec import bits as B
from btle_tpu.spec import crc24 as C
from btle_tpu.spec import whitening as W
from btle_tpu.wideband import synthesize_wideband
from btle_tpu.wideband.channelizer import bin_to_channel
from btle_tpu.wideband.channelizer import channelize as jchannelize
from btle_tpu.wideband.fused import fused_frontend as jfrontend
from btle_tpu.wideband.sniffer import wideband_scan as jscan

from btle_tpu_torch.wideband.channelizer import channelize
from btle_tpu_torch.wideband.fused import fused_frontend, wideband_scan_fused
from btle_tpu_torch.wideband.sniffer import wideband_scan

torch.set_num_threads(2)

ADV_AA = "d6be898e"
CONN_AA = int(0x50655535).to_bytes(4, "little").hex()
CONN_CRC = "a1b2c3"


def _burst(rng, ch, phy, n_payload=12):
    adv = ch in (37, 38, 39)
    payload = rng.integers(0, 256, n_payload, dtype=np.uint8)
    pdu = B.bytes_to_bits(np.concatenate(
        [[0x40 if adv else 0x01, n_payload], payload]).astype(np.uint8))
    bits = G.assemble_phy_bits(
        pdu, ch, crc_init_hex="555555" if adv else CONN_CRC,
        access_address_hex=ADV_AA if adv else CONN_AA, phy=phy)
    return G.gfsk_modulate_float(bits, 40 if phy == "2m" else 80)


def _scene(seed, phy="1m", chans=(37, 4, 22, 39), n=80000):
    """ADV packets on the advertising channels, LL data packets with a
    connection AA / CRC init on the data channels, light noise."""
    rng = np.random.default_rng(seed)
    signals = {ch: _burst(rng, ch, phy) for ch in chans}
    offsets = {ch: 3000 + 17000 * k for k, ch in enumerate(chans)}
    wi, wq = synthesize_wideband(signals, n, offsets)
    wi += rng.normal(0, 0.01, wi.shape).astype(np.float32)
    wq += rng.normal(0, 0.01, wq.shape).astype(np.float32)
    return wi, wq


def _tables(mask_holes=()):
    """Per-channel AA rows and CRC inits (advertising bins keyed to the
    ADV AA, data bins to the connection), whitening, adv flags."""
    adv = np.array([bin_to_channel(m) in (37, 38, 39) for m in range(40)])
    aa_rows = np.where(adv[:, None], B.hex_to_bits(ADV_AA)[None],
                       B.hex_to_bits(CONN_AA)[None]).astype(np.int8)
    crc = np.where(adv, C.lfsr_init_to_table_init("555555"),
                   C.lfsr_init_to_table_init(CONN_CRC)).astype(np.int32)
    mask = np.ones(32, np.int8)
    mask[list(mask_holes)] = 0
    whiten = np.stack([W.whitening_bits(bin_to_channel(m), 336)
                       for m in range(40)])
    return aa_rows, mask, whiten, crc, adv


CASES = [("bf16x2w", 4, 4), ("bf16x2w", 4, 1), ("bf16x2w", 2, 2),
         ("f32", 4, 4), ("f32", 4, 1), ("f32", 2, 2)]


@pytest.mark.parametrize("dtype,sps,lag", CASES)
def test_frontend_matches_pallas_interpret(dtype, sps, lag):
    wi, wq = _scene(1, phy="2m" if sps == 2 else "1m", n=60000)
    aa_rows, mask, *_ = _tables(mask_holes=(5, 17))
    with pltpu.force_tpu_interpret_mode():
        ref = jfrontend(jnp.asarray(wi), jnp.asarray(wq), jnp.asarray(aa_rows),
                        jnp.asarray(mask), sps=sps, lag=lag, tile=512,
                        compute_dtype=dtype, interpret=True)
    bits_r, hit_r, mag_r = (np.asarray(a) for a in ref)
    bits, hit, mag = (a.numpy() for a in fused_frontend(
        wi, wq, aa_rows, mask, sps=sps, lag=lag, compute_dtype=dtype,
        device="cpu"))
    assert bits.shape == bits_r.shape and hit.shape == hit_r.shape
    assert hit.dtype == np.bool_ and bits.dtype == np.int8
    np.testing.assert_array_equal(hit, hit_r)
    assert hit.sum() >= 4                      # every packet's AA found
    assert (bits != bits_r).mean() < 1e-3       # only noise-tie flips
    m, n = np.nonzero(hit)                      # inside the bursts
    np.testing.assert_allclose(mag[m, n], mag_r[m, n], rtol=1e-4)


def _slot_exact(ref, out, mag_rtol):
    for key in ("pos", "valid", "crc_ok", "payload_len", "len_ok", "num_hits"):
        np.testing.assert_array_equal(ref[key], out[key], err_msg=key)
    for m, k in np.argwhere(ref["crc_ok"]):
        span = 2 + int(ref["payload_len"][m, k]) + 3
        np.testing.assert_array_equal(ref["pdu_bytes"][m, k, :span],
                                      out["pdu_bytes"][m, k, :span])
        np.testing.assert_allclose(ref["mag_mean"][m, k], out["mag_mean"][m, k],
                                   rtol=mag_rtol)


def _jax_scan(wi, wq, tables, sps, lag):
    aa_rows, mask, whiten, crc, adv = (jnp.asarray(t) for t in tables)
    ref = jscan(jnp.asarray(wi), jnp.asarray(wq), aa_rows, mask, whiten, crc,
                adv, sps=sps, lag=lag, max_candidates=8)
    return {k: np.asarray(v) for k, v in ref.items()}


def _crc_ok_set(o):
    return {(int(m), bytes(o["pdu_bytes"][m, k, : 2 + int(o["payload_len"][m, k]) + 3]
                           .astype(np.uint8)))
            for m, k in np.argwhere(o["crc_ok"])}


@pytest.mark.parametrize("decode,sps,lag", [("pallas", 4, 4), ("pallas", 4, 1),
                                            ("xla", 4, 4), ("pallas", 2, 2)])
def test_scan_f32_slot_exact_vs_xla(decode, sps, lag):
    wi, wq = _scene(2, phy="2m" if sps == 2 else "1m")
    tables = _tables()
    ref = _jax_scan(wi, wq, tables, sps, lag)
    out = wideband_scan_fused(wi, wq, *tables, sps=sps, lag=lag,
                              max_candidates=8, compute_dtype="f32",
                              decode=decode, device="cpu")
    out = {k: v.numpy() for k, v in out.items()}
    _slot_exact(ref, out, mag_rtol=0.02)
    got = {bin_to_channel(int(m)) for m, k in np.argwhere(out["crc_ok"])}
    assert got == {37, 4, 22, 39}


@pytest.mark.parametrize("sps,lag", [(4, 4), (2, 2)])
def test_scan_bf16x2w_packet_set_vs_xla(sps, lag):
    wi, wq = _scene(3, phy="2m" if sps == 2 else "1m")
    tables = _tables()
    ref = _jax_scan(wi, wq, tables, sps, lag)
    out = wideband_scan_fused(wi, wq, *tables, sps=sps, lag=lag,
                              max_candidates=8, compute_dtype="bf16x2w",
                              device="cpu")
    out = {k: v.numpy() for k, v in out.items()}
    assert _crc_ok_set(out) == _crc_ok_set(ref)
    assert len(_crc_ok_set(out)) == 4


@pytest.mark.parametrize("has_context", [False, True])
def test_plain_scan_matches_xla(has_context):
    """The port's plain torch path (the twin of the XLA path the sniffer's
    slot-overflow rescan runs) against btle_tpu's, slot-exact."""
    wi, wq = _scene(4)
    if has_context:
        ctx = np.zeros(1279, np.float32)
        wi, wq = np.concatenate([ctx, wi]), np.concatenate([ctx, wq])
    yi_r, yq_r = (np.asarray(a) for a in jchannelize(
        jnp.asarray(wi), jnp.asarray(wq), has_context=has_context))
    yi, yq = (a.numpy() for a in channelize(wi, wq, has_context=has_context,
                                             device="cpu"))
    scale = np.abs(yi_r).max()
    np.testing.assert_allclose(yi, yi_r, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(yq, yq_r, rtol=0, atol=1e-5 * scale)
    tables = _tables()
    aa_rows, mask, whiten, crc, adv = (jnp.asarray(t) for t in tables)
    ref = jscan(jnp.asarray(wi), jnp.asarray(wq), aa_rows, mask, whiten, crc,
                adv, sps=4, lag=4, max_candidates=8, has_context=has_context)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = wideband_scan(wi, wq, *tables, sps=4, lag=4, max_candidates=8,
                        has_context=has_context, device="cpu")
    out = {k: v.numpy() for k, v in out.items()}
    _slot_exact(ref, out, mag_rtol=1e-3)
    assert {bin_to_channel(int(m)) for m, k in np.argwhere(out["crc_ok"])} \
        == {37, 4, 22, 39}


def test_unported_modes_raise():
    """Every mode and inner of the JAX package is ported now; what still
    raises are the (compute_dtype, inner) pairs the JAX package asserts
    against, and names it does not know."""
    wi, wq = np.zeros(20000, np.float32), np.zeros(20000, np.float32)
    aa_rows, mask, *_ = _tables()
    for dtype, inner in (("bf16x2w", "dots"), ("f32x2", "poly"),
                         ("bf16", "polyroll"), ("f16", None), ("f32", "roll")):
        with pytest.raises(ValueError):
            fused_frontend(wi, wq, aa_rows, mask, compute_dtype=dtype,
                           inner=inner, device="cpu")


@pytest.mark.parametrize("dtype,has_context", [("bf16x2w", False), ("bf16x2w", True),
                                               ("f32x2", False), ("f32x2", True),
                                               ("bf16", False), ("bf16", True)])
def test_time_major_frames_match_frame_rows(dtype, has_context):
    """The tensor-core filterbank's frames (fused.hilo_frames) are
    frame_rows transposed to (J, 40) and rounded to bf16 ("f32x2": the
    exact hi/lo split, xhi + xlo within bf16 rounding of the lo half),
    zero past J up to ky + width - 1 rows."""
    from btle_tpu_torch.wideband.channelizer import frame_rows
    from btle_tpu_torch.wideband.fused import _g_stack, frontend_operands

    wi, wq = _scene(6, n=30011)
    aa_rows, mask, *_ = _tables()
    fb_args, _ = frontend_operands(wi, wq, aa_rows, mask, 640, has_context, 4, 4,
                                   dtype, 1.0, torch.device("cpu"))
    frames, width, ky = fb_args[0], fb_args[2], fb_args[3]
    f_t = frame_rows(torch.as_tensor(wi), torch.as_tensor(wq), 640, has_context)
    j = f_t.shape[1]
    assert width == _g_stack(640).shape[0]
    x = f_t.t().contiguous()
    hi = x.to(torch.bfloat16)
    if dtype == "f32x2":
        assert tuple(frames.shape) == (2, ky + width - 1, 40)
        lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
        assert torch.equal(frames[0, :j], hi) and torch.equal(frames[1, :j], lo)
        sum_err = (frames[0, :j].float() + frames[1, :j].float() - x).abs()
        assert bool((sum_err <= x.abs() * 2.0 ** -16).all())
        tail = frames[:, j:]
    else:
        assert tuple(frames.shape) == (ky + width - 1, 40) and frames.is_contiguous()
        assert torch.equal(frames[:j], hi)
        tail = frames[j:]
    assert frames.dtype == torch.bfloat16 and not bool(tail.any())


@pytest.mark.parametrize("ky,sms,warps", [(131_075, 132, 8), (9668, 132, 2),
                                          (25_000, 132, 4), (40_000, 132, 8),
                                          (33_000, 132, 4), (100, 132, 2), (5000, 8, 8)])
def test_sgemm_tile_follows_the_grid(ky, sms, warps):
    """K5 at "f32" takes the widest column tile (8, 4 or 2 warps of 32
    columns) whose grid still gives every SM a CTA, and 2 warps at
    least."""
    from btle_tpu_torch.wideband.fused import sgemm_warps

    got = sgemm_warps(ky, sms)
    assert got == warps
    assert got == 2 or -(-ky // (32 * got)) >= sms
    assert got == 8 or -(-ky // (64 * got)) < sms


@pytest.mark.parametrize("blocks,warps", [(131_072, 8), (8192, 2), (24_000, 4)])
def test_polyx_operands_fit_the_kernel_and_tile(blocks, warps):
    """K3's operands from frontend_operands at "f32" (the bench block, the
    CLI's live block, a mid size): 80 stacked rows at stack 2, the
    contiguous float32 frames long enough for every slice, and the column
    tile the wrapper launches (sgemm_warps on 132 SMs) — 256 columns at
    bench geometry, 64 at the live block, where the grid still gives every
    SM a tile."""
    from btle_tpu_torch.rx.pipeline import required_halo
    from btle_tpu_torch.wideband.fused import frontend_operands, sgemm_warps

    n = (blocks + required_halo(4, 4)) * 20 + 1279
    rng = np.random.default_rng(blocks)
    wi, wq = (torch.as_tensor(rng.normal(0, 30, n).astype(np.float32)) for _ in range(2))
    (f4, kcoefx, w4x, ky, stack), _ = frontend_operands(
        wi, wq, torch.zeros(32, dtype=torch.int8), torch.ones(32, dtype=torch.int8),
        1280, True, 4, 4, "f32", 1.0, torch.device("cpu"))
    rows, n_slices = kcoefx.shape
    assert (rows, n_slices, stack) == (80, 33, 2) and tuple(w4x.shape) == (80, 80)
    assert f4.dtype == torch.float32 and f4.is_contiguous()
    assert f4.shape == (80, ky + stack * (n_slices - 1))
    assert ky == blocks + required_halo(4, 4)
    got = sgemm_warps(ky, 132)
    assert got == warps and -(-ky // (32 * got)) >= 132


@pytest.mark.parametrize("inner", ["im2col", "im2colp", "dots"])
def test_f32_im2col_operands_are_the_sgemm_table(inner):
    """frontend_operands at "f32" with an im2col-form inner hands K5 the
    (40, ky + width - 1) float32 frames, zero past J, and the (40, S, 80)
    table of convert.sgemm_weights; the twin on them gives the chunked
    true-FP32 sums of the JAX package's _g_chunks."""
    from btle_tpu.wideband.fused import _g_chunks as jg_chunks

    from btle_tpu_torch.convert import sgemm_weights
    from btle_tpu_torch.wideband.channelizer import frame_rows
    from btle_tpu_torch.wideband.fused import filterbank_im2col, frontend_operands

    wi, wq = _scene(8, n=30011)
    aa_rows, mask, *_ = _tables()
    fb_args, _ = frontend_operands(wi, wq, aa_rows, mask, 640, True, 4, 4, "f32",
                                   1.0, torch.device("cpu"), inner)
    frames, table, width, ky, kind = fb_args
    assert kind == "f32_im2col" and frames.dtype == torch.float32
    assert tuple(frames.shape) == (40, ky + width - 1) and frames.is_contiguous()
    f_t = frame_rows(torch.as_tensor(wi), torch.as_tensor(wq), 640, True)
    assert torch.equal(frames[:, : f_t.shape[1]], f_t)
    assert not bool(frames[:, f_t.shape[1]:].any())
    assert torch.equal(table, sgemm_weights(jg_chunks(640)))
    g = jg_chunks(640).astype(np.float64)
    chunk = g.shape[2] // 40
    want = np.zeros((80, ky))
    f64 = frames.numpy().astype(np.float64)
    for s in range(width):
        c, j = divmod(s, chunk)
        want += g[c][:, j * 40:(j + 1) * 40] @ f64[:, s: s + ky]
    y = filterbank_im2col(*fb_args).numpy()
    assert np.abs(y - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("inner", ["im2col", "im2colp", "dots"])
def test_bf16_operands_are_the_tensor_core_table(inner):
    """frontend_operands at "bf16" with an im2col-form inner hands K5 the
    time-major (ky + width - 1, 40) bf16 frames, zero past J, and the
    (K_pad, 80) table of convert.bf16_weights; the twin on them gives the
    sums of the JAX package's _g_chunks rounded to bf16 times the bf16
    frames (within 1e-5 of max |y|: float32 chunk sums)."""
    import jax.numpy as jnp

    from btle_tpu.wideband.fused import _g_chunks as jg_chunks

    from btle_tpu_torch.convert import bf16_weights
    from btle_tpu_torch.wideband.channelizer import frame_rows
    from btle_tpu_torch.wideband.fused import filterbank_im2col, frontend_operands

    wi, wq = _scene(9, n=30011)
    aa_rows, mask, *_ = _tables()
    fb_args, _ = frontend_operands(wi, wq, aa_rows, mask, 640, True, 4, 4, "bf16",
                                   1.0, torch.device("cpu"), inner)
    frames, table, width, ky, kind = fb_args
    assert kind == "bf16" and frames.dtype == torch.bfloat16
    assert tuple(frames.shape) == (ky + width - 1, 40) and frames.is_contiguous()
    f_t = frame_rows(torch.as_tensor(wi), torch.as_tensor(wq), 640, True)
    assert torch.equal(frames[: f_t.shape[1]], f_t.t().to(torch.bfloat16))
    assert not bool(frames[f_t.shape[1]:].any())
    assert torch.equal(table, bf16_weights(jg_chunks(640)))
    g = np.asarray(jnp.asarray(jg_chunks(640), jnp.bfloat16), np.float64)
    chunk = g.shape[2] // 40
    want = np.zeros((80, ky))
    f64 = frames.to(torch.float32).numpy().astype(np.float64).T
    for s in range(width):
        c, j = divmod(s, chunk)
        want += g[c][:, j * 40:(j + 1) * 40] @ f64[:, s: s + ky]
    y = filterbank_im2col(*fb_args).numpy()
    assert np.abs(y - want).max() <= 1e-5 * np.abs(want).max()


def test_demod_tail_rejects_bad_geometry():
    """The demod tail refuses a negative lag and AA windows that run past
    the decision lattice (on the CPU as on the card)."""
    from btle_tpu_torch.wideband.fused import demod_tail

    y = torch.zeros((80, 4000))
    aa = torch.zeros((40, 32), dtype=torch.int8)
    mask = torch.ones(32, dtype=torch.int8)
    bits, hit, mag = demod_tail(y, aa, mask, 4, 4, 3000, 2876)
    assert bits.shape == (40, 3000) and hit.shape == mag.shape == (40, 2876)
    for sps, lag, n_bits, n_hit in ((4, -1, 3000, 2876), (4, 4, 3000, 2877),
                                    (4, 4, 3997, 3870)):
        with pytest.raises(ValueError):
            demod_tail(y, aa, mask, sps, lag, n_bits, n_hit)
