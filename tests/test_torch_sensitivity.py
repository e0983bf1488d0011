"""Channelizer fidelity of the port at the anchor SNR: the three tests of
tests/test_wideband_sensitivity.py on the port's plain path (CPU), with
the JAX package's thresholds, then the port's 2M sensitivity tools
(btle_tpu_torch.tools.dev_2m_cutoff and ber_2m_wideband) against the JAX
package's scan on the same noisy captures.

The wideband path must not degrade BER against the single-channel
baseline: packets at the reference's 0-ppm anchor SNR (11 dB) decode
after the polyphase channelizer; the LE 2M floor with the 1.2 MHz
prototype sits within 2 dB of 1M; and the 1.2 MHz 2M cutoff decodes
strictly more of a dense 2M scene below its floor than the shared 1.0
MHz filter. The card rows (every shipped fused mode at 11 dB) are in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from btle_tpu.wideband.sniffer import default_scan_tables as j_tables
from btle_tpu.wideband.sniffer import wideband_scan as j_wideband_scan

from btle_tpu_torch.golden import model as G
from btle_tpu_torch.rx.pipeline import decode_block
from btle_tpu_torch.spec import bits as B
from btle_tpu_torch.spec import crc24 as C
from btle_tpu_torch.spec import whitening as W
from btle_tpu_torch.tools import ber_2m_wideband, dev_2m_cutoff
from btle_tpu_torch.wideband import synthesize_wideband
from btle_tpu_torch.wideband.channelizer import channel_to_bin, channelize
from btle_tpu_torch.wideband.sniffer import (CUTOFF_MHZ_2M_SENS,
                                             default_scan_tables,
                                             wideband_scan)

torch.set_num_threads(2)
CPU = torch.device("cpu")


def test_wideband_packets_at_anchor_snr():
    rng = np.random.default_rng(1)
    snr_db = 11.0
    # wideband noise: the channel filter keeps 2/80 of the band, so the
    # int8-peak-referenced in-channel SNR maps to sqrt(20)x wideband sigma
    sigma80 = 127 / 10 ** (snr_db / 20) / np.sqrt(2) * np.sqrt(20)
    aa = torch.as_tensor(B.hex_to_bits("d6be898e"))
    mask = torch.ones(32, dtype=torch.int8)
    m = channel_to_bin(17)
    wh = torch.as_tensor(np.array(W.whitening_bits(17, 336)))[None]
    crc = torch.tensor([C.lfsr_init_to_table_init("555555")], dtype=torch.int32)
    adv = torch.tensor([True])

    n_ok = 0
    trials = 25
    for _ in range(trials):
        payload = rng.integers(0, 256, 30, dtype=np.uint8)
        pdu = B.bytes_to_bits(np.concatenate([[0x40, 30], payload]).astype(np.uint8))
        phy = G.assemble_phy_bits(pdu, 17)
        i80, q80 = G.gfsk_modulate_float(phy, 80)
        wi, wq = synthesize_wideband({17: (i80, q80)}, len(i80) + 8000, {17: 4000})
        wi = wi + rng.normal(0, sigma80, len(wi)).astype(np.float32)
        wq = wq + rng.normal(0, sigma80, len(wq)).astype(np.float32)
        yi, yq = channelize(wi, wq, device=CPU)
        out = decode_block(yi[m: m + 1], yq[m: m + 1], aa, mask, wh, crc, adv,
                           sps=4, lag=4, max_candidates=4)
        okk = out["crc_ok"][0].numpy()
        pdub = out["pdu_bytes"][0].numpy()
        exp = B.bits_to_bytes(pdu)
        n_ok += any(okk[k] and np.array_equal(pdub[k][: len(exp)].astype(np.uint8), exp)
                    for k in range(4))
    # reference anchor: ~0.1% BER at 11 dB -> essentially every packet decodes
    assert n_ok >= trials - 2, f"{n_ok}/{trials} packets at anchor SNR"


def _count(out, expected):
    out = {k: v.numpy() for k, v in out.items()}
    return dev_2m_cutoff.count_cell(out, expected)[0]


def test_wideband_2m_floor_within_2db_of_1m():
    """With the sensitivity-optimized 1.2 MHz prototype the 2M scene
    decodes EVERY packet at +2 dB int8-peak SNR (~2 dB above 1M's clean
    point)."""
    from btle_tpu_torch.wideband.selftest import _scene

    tables = default_scan_tables(CPU)
    wi0, wq0, expected = _scene(phy="2m")
    rng = np.random.default_rng(11)
    std = 127.0 * 10 ** (-2.0 / 20.0)
    ok = tot = 0
    for _ in range(3):
        wi = wi0 + rng.normal(0, std, len(wi0)).astype(np.float32)
        wq = wq0 + rng.normal(0, std, len(wq0)).astype(np.float32)
        out = wideband_scan(wi, wq, *tables, sps=2, lag=2, max_candidates=8,
                            cutoff_mhz=CUTOFF_MHZ_2M_SENS, device=CPU)
        ok += _count(out, expected)
        tot += len(expected)
    assert ok == tot, f"{ok}/{tot} 2M packets at 2 dB"


def test_2m_phy_aware_cutoff_beats_shared_filter():
    """At a below-floor SNR (-2 dB) the 1.2 MHz prototype decodes strictly
    more of a dense all-40-channel 2M scene than the 1M-shared 1.0 MHz
    filter (the JAX package's round-5 sweep: 84/120 vs 50/120 at -2 dB
    across three seeds)."""
    rng = np.random.default_rng(0x2A)
    wi, wq, expected = dev_2m_cutoff.build_scene(rng, dev_2m_cutoff.N_WB, "2m")
    peak = float(np.max(np.abs(wi)))
    sig = peak * 10 ** (2.0 / 20)                 # -2 dB int8-peak SNR
    nz = np.random.default_rng(0x2B).normal(0, sig, (2, len(wi))).astype(np.float32)
    tables = default_scan_tables(CPU)

    def count(cutoff):
        out = wideband_scan(wi + nz[0], wq + nz[1], *tables, sps=2, lag=2,
                            max_candidates=8, cutoff_mhz=cutoff, device=CPU)
        return _count(out, expected)

    n_old, n_new = count(1.0), count(1.2)
    assert n_new >= n_old + 5, (n_old, n_new)
    assert n_new >= 22, (n_old, n_new)


def _jax_cell(wi, wq, phy, cutoff, expected):
    sps = 2 if phy == "2m" else 4
    out = j_wideband_scan(jnp.asarray(wi), jnp.asarray(wq), *j_tables(),
                          sps=sps, lag=sps, max_candidates=8, cutoff_mhz=cutoff)
    return dev_2m_cutoff.count_cell({k: np.asarray(v) for k, v in out.items()},
                                    expected)


def test_dev_2m_cutoff_cell_equals_jax():
    """One cell of the cutoff x SNR table (2M, 1.2 MHz, 0 dB): decoded and
    ghost counts equal to the JAX package's scan of the same capture."""
    got = dev_2m_cutoff.run("cpu", snrs=(0.0,), cutoffs=(1.2,))
    wi, wq, expected = dev_2m_cutoff.build_scene(
        np.random.default_rng(0x2A), dev_2m_cutoff.N_WB, "2m")
    peak = float(np.max(np.abs(wi)))
    noise = np.random.default_rng(1).normal(0, 1.0, (2, len(wi))).astype(np.float32)
    sig = peak * 10 ** (-0.0 / 20)
    want = _jax_cell(wi + sig * noise[0], wq + sig * noise[1], "2m", 1.2, expected)
    assert got["rows"][1.2] == [list(want)] and got["expected"] == 40
    assert want[0] >= 30


def test_ber_2m_wideband_cell_equals_jax():
    """One cell of the 2M sensitivity table (1M, 1.0 MHz, -2 dB, one seed):
    the decode count equals the JAX package's scan of the same capture."""
    got = ber_2m_wideband.run("cpu", seeds=(0x2A,), snrs=(-2.0,),
                              configs=(("1m", 1.0),))
    wi, wq, expected = dev_2m_cutoff.build_scene(
        np.random.default_rng(0x2A), dev_2m_cutoff.N_WB, "1m")
    peak = float(np.max(np.abs(wi)))
    sig = peak * 10 ** (2.0 / 20)
    nz = np.random.default_rng(0x2B).normal(0, sig, (2, len(wi))).astype(np.float32)
    want = _jax_cell(wi + nz[0], wq + nz[1], "1m", 1.0, expected)
    assert got["rows"]["1m cutoff 1.0 MHz"] == [[want[0], 40]]


def test_fused_modes_at_anchor_snr_on_twins():
    """The first test's scene through the fused scan of every shipped mode
    (the kernels' plain twins here; the card row is in
    tests/test_torch_cuda.py): each at least 23 of 25 and within 1 packet
    of "f32"."""
    from btle_tpu_torch.tools import sensitivity

    res = sensitivity.run("cpu")
    assert set(res["decoded"]) == {"bf16x2w", "bf16", "f32"}
    assert sensitivity.check(res) == [], res
