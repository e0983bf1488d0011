"""The LE Coded PHY of the port against the JAX package on the CPU: the
Viterbi decoders (radix-1 masked, radix-2 — the V1 kernel's plain twin —
and the hard-decision helper), the narrowband coded receiver on
tests/test_coded.py's S8 and S2 scenes through noise, the 40-channel
coded scan on its three-channel mixed-S scene, and the convert.py
hand-over of the coded scan tables.

Every input is made with numpy from a seed and fed to both packages.
Tolerances: decoded bits, positions, CI, lengths, CRC verdicts and AA
agreement counts equal; path metrics within rtol 1e-6 (the +-1 branch
products are exact and both packages add in the same order, so they
agree to the bit here; the tolerance covers a reordered float sum).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from btle_tpu.golden import model as G
from btle_tpu.phy import viterbi as JV
from btle_tpu.rx import coded as JC
from btle_tpu.spec import bits as B
from btle_tpu.spec import coded as K
from btle_tpu.wideband import coded as JW
from btle_tpu.wideband import synthesize_wideband

from btle_tpu_torch import convert
from btle_tpu_torch.phy import viterbi as TV
from btle_tpu_torch.rx import coded as TC
from btle_tpu_torch.wideband import coded as TW

torch.set_num_threads(2)


def make_packet(rng, ch, s, n_payload=12):
    payload = rng.integers(0, 256, n_payload, dtype=np.uint8)
    pdu = B.bytes_to_bits(
        np.concatenate([[0x42, n_payload], payload]).astype(np.uint8))
    sym = K.assemble_coded_phy(pdu, ch, s=s)
    exp = np.concatenate([[0x42, n_payload], payload]).astype(np.uint8)
    return sym, exp


def _soft(rng, rows, n, kind):
    """(rows, n) la and lb: noisy codewords, plain noise, or hard +-1 with
    ties (sign of noise, and some exact zeros)."""
    if kind == "codeword":
        out = []
        for _ in range(rows):
            msg = np.concatenate([rng.integers(0, 2, n - 3), np.zeros(3)])
            enc = K.fec_encode(msg.astype(np.int8)).astype(np.float32) * 2 - 1
            out.append(enc + rng.normal(0, 0.55, enc.shape).astype(np.float32))
        x = np.stack(out)
        return x[:, 0::2].copy(), x[:, 1::2].copy()
    la = rng.normal(0, 1, (rows, n)).astype(np.float32)
    lb = rng.normal(0, 1, (rows, n)).astype(np.float32)
    if kind == "hard":
        la, lb = np.sign(la), np.sign(lb)
        la[:, ::7] = 0.0
    return la, lb


@pytest.mark.parametrize("kind", ["codeword", "noise", "hard"])
@pytest.mark.parametrize("n", [8, 130, 364])
def test_viterbi_r2_equals_jax(kind, n):
    rng = np.random.default_rng(n + len(kind))
    la, lb = _soft(rng, 4, n, kind)
    bits, pm = TV.viterbi_decode_r2(torch.as_tensor(la), torch.as_tensor(lb), n)
    assert bits.dtype == torch.int8 and bits.shape == (4, n)
    for r in range(4):
        jb, jpm = JV.viterbi_decode_r2(jnp.asarray(la[r]), jnp.asarray(lb[r]), n)
        assert np.array_equal(np.asarray(jb), bits[r].numpy()), r
        np.testing.assert_allclose(float(pm[r]), float(jpm), rtol=1e-6)
    one = TV.viterbi_decode_r2(la[0], lb[0], n)
    assert torch.equal(one[0], bits[0]) and float(one[1]) == float(pm[0])


@pytest.mark.parametrize("kind", ["codeword", "hard"])
def test_viterbi_radix1_equals_jax(kind):
    rng = np.random.default_rng(7)
    n = 120
    la, lb = _soft(rng, 3, n, kind)
    n_valid = np.array([n, n - 17, 5])
    bits, pm = TV.viterbi_decode(la, lb, n_valid)
    for r in range(3):
        jb, jpm = JV.viterbi_decode(jnp.asarray(la[r]), jnp.asarray(lb[r]),
                                    int(n_valid[r]))
        assert np.array_equal(np.asarray(jb), bits[r].numpy()), r
        np.testing.assert_allclose(float(pm[r]), float(jpm), rtol=1e-6)


def test_fec_decode_bits_equals_jax(rng):
    for n, flips in ((5, 0), (64, 0), (200, 20)):
        msg = np.concatenate([rng.integers(0, 2, n), np.zeros(3)]).astype(np.int8)
        enc = K.fec_encode(msg)
        enc[rng.choice(len(enc), flips, replace=False)] ^= 1
        got = TV.fec_decode_bits(enc, device="cpu")
        assert np.array_equal(got, JV.fec_decode_bits(enc))
        assert np.array_equal(got, msg)


def test_radix2_tables_equal():
    for r, g in zip(JV._radix2_tables(), TV._radix2_tables()):
        assert r.dtype == g.dtype and np.array_equal(r, g)


def _coded_scene(rng, s, sigma=20.0, n_payload=12):
    sym, exp = make_packet(rng, 37, s, n_payload)
    ci, cq = G.gfsk_modulate_float(sym, 4)
    n = len(ci) + 4000
    wi = np.zeros(n, np.float32)
    wq = np.zeros(n, np.float32)
    wi[1000: 1000 + len(ci)] = ci
    wq[1000: 1000 + len(cq)] = cq
    wi += rng.normal(0, sigma, n).astype(np.float32)
    wq += rng.normal(0, sigma, n).astype(np.float32)
    return wi, wq, exp


@pytest.mark.parametrize("s,sigma", [(8, 20.0), (2, 20.0), (8, 60.0)])
def test_coded_sync_and_decode_equals_jax(s, sigma):
    rng = np.random.default_rng(10 * s + int(sigma))
    wi, wq, exp = _coded_scene(rng, s, sigma)
    aa_hex = "d6be898e"
    aa_pm, ci_pm = TC._aa_pattern_pm(aa_hex), TC._ci_patterns_pm(aa_hex)
    assert np.array_equal(aa_pm, JC._aa_pattern_pm(aa_hex))
    assert np.array_equal(ci_pm, JC._ci_patterns_pm(aa_hex))
    from btle_tpu_torch.spec import crc24 as tC
    from btle_tpu_torch.spec import whitening as tW

    whiten = np.array(tW.whitening_bits(37, TC.MAX_PDU_BITS + 24))
    crc = tC.lfsr_init_to_table_init("555555")
    want = JC.coded_sync_and_decode(
        jnp.asarray(wi), jnp.asarray(wq), jnp.asarray(aa_pm),
        jnp.asarray(ci_pm), jnp.asarray(whiten), jnp.int32(crc), sps=4,
        max_candidates=6)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = TC.coded_sync_and_decode(torch.as_tensor(wi), torch.as_tensor(wq),
                                   aa_pm, ci_pm, whiten, crc, sps=4,
                                   max_candidates=6)
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    for k in ("pos", "valid", "ci_s2", "payload_len", "crc_ok", "agree"):
        assert np.array_equal(got[k], want[k]), k
    ok = got["crc_ok"] | want["crc_ok"]
    assert np.array_equal(got["pdu_bits"][ok], want["pdu_bits"][ok])
    assert ok.any() and set(got["ci_s2"][ok]) == {s}
    first = np.flatnonzero(ok)[0]
    assert np.array_equal(B.bits_to_bytes(got["pdu_bits"][first])[: len(exp)], exp)


@pytest.mark.parametrize("s", [8, 2])
def test_decode_coded_equals_jax(s):
    rng = np.random.default_rng(s)
    wi, wq, exp = _coded_scene(rng, s)
    kw = dict(sps=4, access_address_hex="d6be898e", crc_init_hex="555555",
              max_candidates=8)
    want = JC.decode_coded(wi, wq, 37, **kw)
    got = TC.decode_coded(wi, wq, 37, device="cpu", **kw)
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert np.array_equal(g[k], w[k]), k
    assert got[0]["crc_ok"] and got[0]["s"] == s
    assert np.array_equal(got[0]["pdu_bytes"][: len(exp)], exp)


def test_scan_coded_capture_equals_jax():
    """tests/test_coded.py's three-channel mixed-S scene (37 S=8, 9 S=2,
    25 S=8) through both packages' 40-channel coded scan."""
    rng = np.random.default_rng(0)
    n = 160000
    wi = np.zeros(n, np.float32)
    wq = np.zeros(n, np.float32)
    exp = {}
    for k, (ch, s) in enumerate([(37, 8), (9, 2), (25, 8)]):
        sym, e = make_packet(rng, ch, s, n_payload=8)
        burst = G.gfsk_modulate_float(sym, 80)
        si, sq = synthesize_wideband({ch: burst}, n, {ch: 8000 + 9000 * k})
        wi += si
        wq += sq
        exp[ch] = (e, s)
    wi += rng.normal(0, 3, n).astype(np.float32)
    wq += rng.normal(0, 3, n).astype(np.float32)

    def keys(pkts):
        return [(p["channel"], p["pos"], p["s"], p["crc_ok"], p["payload_len"],
                 bytes(p["pdu_bytes"]), p["aa_agree"]) for p in pkts]

    want = JW.scan_coded_capture(wi, wq)
    got = TW.scan_coded_capture(wi, wq, device="cpu")
    assert keys(got) == keys(want)
    ok = {p["channel"]: p for p in got if p["crc_ok"]}
    for ch, (e, s) in exp.items():
        assert ok[ch]["s"] == s
        assert np.array_equal(ok[ch]["pdu_bytes"][: len(e)], e)
    assert not [p for p in got if p["crc_ok"] and p["channel"] not in exp]


@pytest.mark.parametrize("aa_hex,crc_hex", [("d6be898e", "555555"),
                                            ("60850a1b", "a77b22")])
def test_coded_tables_convert(aa_hex, crc_hex):
    """convert.coded_tables_from_numpy of the JAX package's tables equals
    the port's own coded_scan_tables."""
    want = [np.asarray(t) for t in JW.coded_scan_tables(aa_hex, crc_hex)]
    got = convert.coded_tables_from_numpy(*want, device="cpu")
    own = TW.coded_scan_tables(aa_hex, crc_hex, device="cpu")
    for g, o in zip(got, own):
        assert g.dtype == o.dtype and torch.equal(g, o)
