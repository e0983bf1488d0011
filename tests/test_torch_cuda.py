"""The CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside
the fixture). chip_smoke.py checks the kernels at bench geometry; these
cover the other shapes the kernels take — lag 1 (odd-bin decision
flip), sps 2 (LE 2M), the 640-tap prototype, a ragged block length,
per-channel AA rows with care-mask holes, candidate windows past the
lattice end — and the port's device path against its CPU path. They
import no JAX, so they run where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from btle_tpu_torch.golden import assemble_phy_bits, gfsk_modulate_float
from btle_tpu_torch.rx.decode_kernel import (DECODE_CANDIDATES, decode_candidates,
                                             decode_candidates_reference)
from btle_tpu_torch.spec import bits as B
from btle_tpu_torch.wideband import WidebandConfig, WidebandSniffer, fused_selftest
from btle_tpu_torch.wideband import fused
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
