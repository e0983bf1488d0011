"""The port's channel simulation and BER harness (BASELINE config 3)
against the JAX package on the CPU, then its statistics on its own.

Parity, with the same numpy inputs fed to both packages: apply_ppm
within 1e-3 absolute (the CFO phase reaches ~300 rad, where one float32
ulp of it moves a sample by 0.004, so both must round in the same order);
make_packets equal for the same rng; golden_rx_dense equal (found, CRC,
length, dewhitened bits) on the same int16 captures; one harness batch
with the same standard-normal draws injected on both sides equal in
errors and CRC-OK packets. The JAX side of that batch is its public
stages composed by hand (modulate_python, apply_ppm, awgn's sigma,
quantize_int16, golden_rx_dense), since its noise comes from jax.random.

Statistics, port only (its noise is a torch.Generator stream, equal to
the JAX stream in distribution, not bit for bit), with
tests/test_sim.py's packet counts and thresholds: BER <= 0.5% and >= 55
of 60 packets at the 0 ppm (11 dB) and 50 ppm (26 dB) anchors, worse
below the anchor, zero errors on a clean channel; then the full-depth
sweep tool (the 0.1% anchor criterion itself is held on the card).
"""

import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from btle_tpu.golden import model as G
from btle_tpu.phy.modulator import modulate_python as j_modulate
from btle_tpu.sim import BerHarness as JHarness
from btle_tpu.sim import apply_ppm as j_apply_ppm
from btle_tpu.sim import golden_rx_dense as j_golden_rx_dense
from btle_tpu.sim import quantize_int16 as j_quantize
from btle_tpu.sim import reference_max_snr as j_reference_max_snr
from btle_tpu.sim.ber import BER_PDU_HEX
from btle_tpu.spec import bits as B

from btle_tpu_torch import sim as tsim
from btle_tpu_torch.sim import sweep as tsweep

torch.set_num_threads(2)


@pytest.mark.parametrize("ppm,sps", [(30.0, 8), (50.0, 8), (-20.0, 8),
                                     (45.0, 4), (0.0, 8)])
def test_apply_ppm_equals_jax(ppm, sps):
    pdu_bits = B.hex_to_bits(BER_PDU_HEX)
    i, q, _ = G.btle_tx(pdu_bits, 37, sps=sps, flavor="python" if sps == 8 else "c")
    ji, jq = j_apply_ppm(jnp.asarray(i), jnp.asarray(q), jnp.float32(ppm), sps)
    ti, tq = tsim.apply_ppm(torch.as_tensor(i), torch.as_tensor(q), ppm, sps)
    assert np.max(np.abs(np.asarray(ji) - ti.numpy())) < 1e-3
    assert np.max(np.abs(np.asarray(jq) - tq.numpy())) < 1e-3
    # the golden float64 model: a fraction of an LSB, as test_sim.py holds
    gi, gq, _ = G.add_freq_sampling_error(i, q, ppm, sps=sps)
    assert np.max(np.abs(ti.numpy() - gi)) < 0.05
    # batched rows are the rows' own results
    bi, _ = tsim.apply_ppm(torch.as_tensor(np.stack([i, i])),
                           torch.as_tensor(np.stack([q, q])), ppm, sps)
    assert torch.equal(bi[1], ti)


def test_reference_max_snr_and_anchors():
    for ppm in (0, 50, 22.5, 13.0, -35.0, 60.0):
        assert tsim.reference_max_snr(ppm) == j_reference_max_snr(ppm)
    assert tsim.reference_max_snr(22.5) == 13.5
    assert (tsweep.PPMS, tsweep.POINT_PLAN, tsweep.ANCHOR_CRITERION) == (
        (0.0, 20.0, 30.0, 50.0), ((-4.0, 100), (-2.5, 200), (-1.0, 300),
                                  (0.0, 300)), 1e-3)


@pytest.mark.parametrize("phy", ["1m", "2m"])
def test_make_packets_equal(phy):
    jp, jd = JHarness(phy=phy).make_packets(7, np.random.default_rng(3))
    tp, td = tsim.BerHarness(phy=phy, device="cpu").make_packets(
        7, np.random.default_rng(3))
    assert tp.dtype == torch.int8 and td.dtype == torch.int8
    assert np.array_equal(np.asarray(jp), tp.numpy())
    assert np.array_equal(np.asarray(jd), td.numpy())


def _j_modulate_ppm(phys, ppm, sps):
    """The JAX package's modulate_python and apply_ppm over a batch of
    phy-bit rows (its harness vmaps them)."""
    def one(b):
        i8, q8 = j_modulate(b, sps=sps)
        return j_apply_ppm(i8, q8, jnp.float32(ppm), sps)
    return jax.vmap(one)(jnp.asarray(phys))


def _captures(seed, snr_db, ppm, n_pk=6, sps=8, phy="1m"):
    """n_pk int16 captures through the golden chain (numpy), one with its
    access address destroyed (no AA found)."""
    rng = np.random.default_rng(seed)
    h = tsim.BerHarness(sps=sps, phy=phy, device="cpu")
    phys, pdus = h.make_packets(n_pk, rng)
    i1, q1 = _j_modulate_ppm(phys.numpy(), ppm, sps)
    sig = 127 / 10 ** (snr_db / 20) / np.sqrt(2)
    ni = rng.normal(0, sig, i1.shape).astype(np.float32)
    nq = rng.normal(0, sig, q1.shape).astype(np.float32)
    i3, q3 = j_quantize(i1 + ni, q1 + nq)
    i3, q3 = np.asarray(i3).copy(), np.asarray(q3).copy()
    i3[0, 8 * sps: 40 * sps] = 0          # no access address in row 0
    q3[0, 8 * sps: 40 * sps] = 0
    return i3, q3, h


@pytest.mark.parametrize("snr_db,ppm", [(9.0, 0.0), (26.0, 50.0), (6.0, 20.0)])
def test_golden_rx_dense_equals_jax(snr_db, ppm):
    i3, q3, h = _captures(int(snr_db * 10 + ppm), snr_db, ppm)
    got = tsim.golden_rx_dense(torch.as_tensor(i3), torch.as_tensor(q3),
                               h.aa_bits, h.whiten, h.crc_init, True, h.sps)
    for r in range(i3.shape[0]):
        want = j_golden_rx_dense(jnp.asarray(i3[r]), jnp.asarray(q3[r]),
                                 jnp.asarray(h.aa_bits.numpy()),
                                 jnp.asarray(h.whiten.numpy()),
                                 jnp.int32(h.crc_init), jnp.asarray(True), h.sps)
        for k, (g, w) in enumerate(zip(got, want)):
            assert np.array_equal(g[r].numpy(), np.asarray(w)), (r, k)
    found, crc_ok = got[0].numpy(), got[1].numpy()
    assert not found[0]
    if snr_db > 20:
        assert found[1:].all() and crc_ok[1:].all()
    one = tsim.golden_rx_dense(torch.as_tensor(i3[2]), torch.as_tensor(q3[2]),
                               h.aa_bits, h.whiten, h.crc_init, True, h.sps)
    assert all(torch.equal(a, b[2]) for a, b in zip(one, got))


@pytest.mark.parametrize("snr_db,ppm,phy", [(8.5, 0.0, "1m"), (24.0, 50.0, "1m"),
                                            (14.0, 30.0, "1m"), (11.0, 20.0, "2m")])
def test_harness_batch_equals_jax_with_injected_noise(snr_db, ppm, phy):
    """One batch of 100 packets: errors and CRC-OK counts equal, with the
    same numpy standard-normal draws on both sides."""
    rng = np.random.default_rng(int(snr_db) + len(phy))
    h = tsim.BerHarness(phy=phy, device="cpu")
    phys, pdus = h.make_packets(h.BATCH, rng)
    n = phys.shape[1] * h.sps + 2 * h.sps
    ni = rng.standard_normal((h.BATCH, n)).astype(np.float32)
    nq = rng.standard_normal((h.BATCH, n)).astype(np.float32)
    err, ok = h.run_batch(phys, pdus, snr_db, ppm, noise=(ni, nq))

    i1, q1 = _j_modulate_ppm(phys.numpy(), ppm, h.sps)
    sigma = 127.0 / jnp.power(10.0, jnp.float32(snr_db) / 20.0) / jnp.sqrt(2.0)
    i3, q3 = j_quantize(i1 + jnp.asarray(ni) * sigma, q1 + jnp.asarray(nq) * sigma)
    j_err = j_ok = 0
    pd = pdus.numpy()
    for r in range(h.BATCH):
        found, crc_ok, plen, dew = (np.asarray(v) for v in j_golden_rx_dense(
            i3[r], q3[r], jnp.asarray(h.aa_bits.numpy()),
            jnp.asarray(h.whiten.numpy()), jnp.int32(h.crc_init),
            jnp.asarray(True), h.sps))
        mism = int(np.sum((np.arange(pd.shape[1]) < 16 + int(plen) * 8)
                          & (dew[: pd.shape[1]] != pd[r])))
        j_err += 0 if crc_ok else (mism if found else pd.shape[1])
        j_ok += int(crc_ok)
    assert (int(err), int(ok)) == (j_err, j_ok)
    assert 0 < j_ok


@pytest.mark.parametrize("ppm", [0.0, 50.0])
def test_anchor_snr_ber(ppm):
    h = tsim.BerHarness(device="cpu")
    snr = tsim.reference_max_snr(ppm)
    ber, ok, nbits = h.ber_point(snr, ppm, 60, seed=11)
    # reference curve: ~0.1% BER at the anchor; 0.5% slack for the
    # reduced packet count (tests/test_sim.py's bound)
    assert ber <= 5e-3, (ppm, snr, ber)
    assert ok >= 55


def test_degradation_below_anchor():
    h = tsim.BerHarness(device="cpu")
    ber_hi, _, _ = h.ber_point(11.0, 0.0, 40, seed=5)
    ber_lo, _, _ = h.ber_point(7.0, 0.0, 40, seed=5)
    assert ber_lo > ber_hi
    assert ber_lo > 1e-3


def test_clean_channel_zero_errors():
    h = tsim.BerHarness(device="cpu")
    ber, ok, nbits = h.ber_point(40.0, 0.0, 20, seed=6)
    assert ber == 0.0
    # the harness rounds up to its fixed batch width
    assert ok == nbits // (39 * 8)


def test_awgn_generator_and_sigma():
    i = torch.zeros((4, 20000))
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = tsim.awgn(i, i, 11.0, generator=g1)
    b = tsim.awgn(i, i, 11.0, generator=g2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    sigma = 127 / 10 ** (11.0 / 20) / np.sqrt(2)
    assert abs(float(a[0].std()) / sigma - 1) < 0.02
    assert not torch.equal(a[0], a[1])


def test_full_depth_sweep_tool():
    """btle_tpu_torch.tools.ber_sweep at full depth (16 points, 3600
    packets) on the CPU: ~93,600 bits at each anchor, each anchor within
    tests/test_sim.py's 0.5% bound, and each ppm's lowest point markedly
    worse (tests/test_ber_full.py's waterfall criterion). The reference's
    0.1% anchor criterion sits at the waterfall's knee, where one packet
    whose access address is lost costs 312 bits (3.3e-3 of an anchor's
    bits): a single sweep misses it for some seeds in both packages, so
    it is asserted on the card (chip_smoke.py's "ber" phase), as the JAX
    package asserts it only in its @slow test."""
    from btle_tpu_torch.tools import ber_sweep

    out = ber_sweep.run("cpu", seed=11)
    pts = out["points"]
    assert out["packets"] == 3600 and len(pts) == 16
    for p in pts:
        if p["is_anchor"]:
            assert p["bits"] >= 90_000 and p["ber"] <= 5e-3, p
    for ppm in tsweep.PPMS:
        curve = [p for p in pts if p["ppm"] == ppm]
        assert curve[0]["ber"] > 10 * max(curve[-1]["ber"], 1e-6)
    assert out["markdown"].count("(anchor)") == 4
    assert out["anchors_pass"] == all(p["ber"] <= 1e-3 for p in pts
                                      if p["is_anchor"])


def test_ber_cli(tmp_path):
    r = subprocess.run([sys.executable, "-m", "btle_tpu_torch", "ber", "--ppm",
                        "20", "--packets", "100", "--device", "cpu", "--plot",
                        str(tmp_path / "b.png")],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    rows = [json.loads(ln) for ln in r.stdout.splitlines()]
    assert [x["snr_db"] for x in rows] == [9.0, 10.5, 12.0, 13.0]
    assert all(x["bits"] == 31200 for x in rows)
    assert rows[-1]["ber"] < rows[0]["ber"]
    assert "plot" in r.stderr
