"""The port's narrowband receive path on the CPU (the plain twins of the
scan and candidate decode kernels) against the JAX package: the dense
scan (``scan_block``, and the Pallas ``scan_block_fused`` in interpret
mode), the K4 twin with clamped tail gathers against the XLA decode,
``stream_decode`` and ``golden_decode``. Inputs come from numpy seeds;
every comparison is exact (integers, bytes, bools)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from btle_tpu.golden import model as G
from btle_tpu.phy.pallas_scan import scan_block_fused as j_scan_block_fused
from btle_tpu.rx import decoder as jdec
from btle_tpu.rx.pipeline import _decode_candidate as j_decode_candidate
from btle_tpu.rx.pipeline import scan_block as j_scan_block
from btle_tpu.spec import bits as B
from btle_tpu.spec import whitening as W
from btle_tpu.spec.crc24 import CRC24_TABLE, lfsr_init_to_table_init

from btle_tpu_torch.phy.scan_kernel import scan_block_reference
from btle_tpu_torch.rx import decoder as tdec
from btle_tpu_torch.rx.decode_kernel import decode_candidates, decode_candidates_reference
from btle_tpu_torch.rx.pipeline import _decode_candidate, scan_block

torch.set_num_threads(2)

ADV_AA = B.hex_to_bits("d6be898e")
CONN_AA = 0x60850A1B
CONN_AA_HEX = "1b0a8560"
CONN_CRC_HEX = "a77b22"


def _pdu_bits(rng, n, header):
    payload = rng.integers(0, 256, n, dtype=np.uint8)
    return B.bytes_to_bits(np.concatenate([[header, n], payload]).astype(np.uint8))


def _scene(seed, n, placements, amplitude=127.0, noise=2, sps=4):
    """int16 (i, q) of n samples: uniform noise of +-noise plus one golden
    burst per (pos, channel, pdu_bits, aa_hex, crc_hex), scaled from the
    int8 golden scale to ``amplitude``."""
    rng = np.random.default_rng(seed)
    i = rng.integers(-noise, noise + 1, n).astype(np.float64)
    q = rng.integers(-noise, noise + 1, n).astype(np.float64)
    for pos, ch, bits, aa_hex, crc_hex in placements:
        ci, cq, _ = G.btle_tx(bits, ch, crc_init_hex=crc_hex,
                              access_address_hex=aa_hex, sps=sps,
                              flavor="c" if sps == 4 else "python")
        m = min(len(ci), n - pos)
        i[pos:pos + m] += np.asarray(ci[:m], np.float64) * amplitude / 127.0
        q[pos:pos + m] += np.asarray(cq[:m], np.float64) * amplitude / 127.0
    clip = lambda x: np.clip(np.round(x), -32768, 32767).astype(np.int16)
    return clip(i), clip(q)


def _adv_scene(seed, n=9000, amplitude=127.0, sps=4, noise=2):
    rng = np.random.default_rng(seed + 100)
    return _scene(seed, n, [(1000, 37, _pdu_bits(rng, 12, 0x40), "d6be898e",
                             "555555"),
                            (5000, 37, _pdu_bits(rng, 20, 0x02), "d6be898e",
                             "555555")],
                  amplitude=amplitude, sps=sps, noise=noise)


# --------------------------------------------------------------------------
# the dense scan (K7's twin)
# --------------------------------------------------------------------------


def _jax_scan(i, q, aa, mask, sps, lag):
    h, b = j_scan_block(jnp.asarray(i), jnp.asarray(q), jnp.asarray(aa),
                        jnp.asarray(mask), sps=sps, lag=lag)
    return np.asarray(h), np.asarray(b)


def _port_scan(i, q, aa, mask, sps, lag):
    h, b = scan_block(torch.as_tensor(i), torch.as_tensor(q),
                      torch.as_tensor(aa), torch.as_tensor(mask), sps, lag)
    return h.numpy(), b.numpy()


@pytest.mark.parametrize("amplitude", [6, 4096, 32767])
@pytest.mark.parametrize("sps,lag", [(4, 1), (2, 1), (8, 8)])
def test_scan_twin_matches_jax(amplitude, sps, lag):
    noise = max(2, amplitude // 40)
    i, q = _adv_scene(amplitude + sps, n=6000 * max(1, sps // 4) + 173,
                      amplitude=float(amplitude), sps=sps, noise=noise)
    mask = np.ones(32, np.int8)
    ref = _jax_scan(i, q, ADV_AA, mask, sps, lag)
    got = _port_scan(i, q, ADV_AA, mask, sps, lag)
    for r, g in zip(ref, got):
        assert r.dtype == g.dtype and r.shape == g.shape
        np.testing.assert_array_equal(r, g)
    if amplitude > 6 and lag == 1:
        assert ref[0].sum() >= 2         # both packets' AAs are found


@pytest.mark.parametrize("mask_hex", ["ffff00ff", "0f0f0f0f", "00000000"])
def test_scan_twin_masks(mask_hex):
    i, q = _adv_scene(3, n=5000, amplitude=300.0, noise=40)
    mask = B.hex_to_bits(mask_hex)
    ref = _jax_scan(i, q, ADV_AA, mask, 4, 1)
    got = _port_scan(i, q, ADV_AA, mask, 4, 1)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)
    if mask_hex == "00000000":
        assert got[0].all()


@pytest.mark.parametrize("floats", [False, True])
def test_scan_twin_rows_with_per_row_aa(floats):
    """(C, N) rows with a (C, 32) AA row each — the wideband rescan's
    shape — in int16 and in float32."""
    rng = np.random.default_rng(11)
    rows_i, rows_q = [], []
    for c in range(3):
        i, q = _adv_scene(20 + c, n=4000, amplitude=200.0, noise=30)
        rows_i.append(i)
        rows_q.append(q)
    i, q = np.stack(rows_i), np.stack(rows_q)
    if floats:
        i = i.astype(np.float32) * np.float32(0.37) + rng.normal(
            0, 0.5, i.shape).astype(np.float32)
        q = q.astype(np.float32) * np.float32(0.37)
    aa = np.stack([ADV_AA, rng.integers(0, 2, 32).astype(np.int8), ADV_AA])
    mask = np.ones(32, np.int8)
    mask[[3, 30]] = 0
    got = _port_scan(i, q, aa, mask, 4, 4)
    for c in range(3):
        ref = _jax_scan(i[c], q[c], aa[c], mask, 4, 4)
        np.testing.assert_array_equal(ref[0], got[0][c])
        np.testing.assert_array_equal(ref[1], got[1][c])


# the lengths at which the CUDA kernel's 512-position tiles end: n_hit = 0,
# n_hit or n_bits one past a tile, ragged tails at sps 8 / lag 8, lag 8 at
# sps 1 and 2
SCAN_EDGES = [(1 + 31 * 4, 4, 1), (8 + 31 * 8, 8, 8), (1 + 31 * 4 + 513, 4, 1),
              (2 * 512 + 1 + 1, 4, 1), (8 + 31 * 8 + 3 * 512 + 3, 8, 8),
              (8 + 31 + 2 * 512 + 7, 1, 8), (8 + 62 + 2 * 512 + 5, 2, 8)]


@pytest.mark.parametrize("floats", [False, True])
@pytest.mark.parametrize("n,sps,lag", SCAN_EDGES)
def test_scan_twin_tile_edges_match_jax(n, sps, lag, floats):
    """Two (C, N) rows of wide noise at the kernel's tile edges, each with
    its own AA row, under a full care mask and a 4-bit one (so some
    positions hit): the twin equals the JAX scan row by row."""
    rng = np.random.default_rng(n + sps + lag)
    i, q = rng.integers(-3000, 3001, (2, 2, n)).astype(np.int16)
    if floats:
        i = i.astype(np.float32) * np.float32(0.37)
        q = q.astype(np.float32) * np.float32(0.37)
    aa = np.stack([ADV_AA, rng.integers(0, 2, 32).astype(np.int8)])
    for mask_hex in ("ffffffff", "0000000f"):
        mask = B.hex_to_bits(mask_hex)
        got = _port_scan(i, q, aa, mask, sps, lag)
        assert got[0].shape == (2, n - lag - 31 * sps)
        for c in range(2):
            ref = _jax_scan(i[c], q[c], aa[c], mask, sps, lag)
            np.testing.assert_array_equal(ref[0], got[0][c])
            np.testing.assert_array_equal(ref[1], got[1][c])
        if mask_hex == "0000000f" and n > 600:
            assert got[0].any()


@pytest.mark.parametrize("sps,lag", [(4, 1), (8, 8)])
def test_pallas_scan_interpret_matches_twin(sps, lag):
    """The TPU kernel (interpret mode, as tests/test_pallas.py runs it) on
    tests/test_pallas.py's scene equals the port's twin."""
    rng = np.random.default_rng(0)
    pdu = B.bytes_to_bits(
        np.concatenate([[0x40, 12], rng.integers(0, 256, 12, dtype=np.uint8)]).astype(np.uint8))
    ci, cq, _ = G.btle_tx(pdu, 37, sps=sps, flavor="c" if sps == 4 else "python")
    n = 20000
    i = rng.integers(-5, 6, n).astype(np.int16)
    q = rng.integers(-5, 6, n).astype(np.int16)
    i[3000:3000 + len(ci)] += np.asarray(ci, np.int16)
    q[3000:3000 + len(cq)] += np.asarray(cq, np.int16)
    mask = np.ones(32, np.int8)
    with pltpu.force_tpu_interpret_mode():
        h, b = j_scan_block_fused(jnp.asarray(i), jnp.asarray(q),
                                  jnp.asarray(ADV_AA), jnp.asarray(mask),
                                  sps=sps, lag=lag)
    got = scan_block_reference(torch.as_tensor(i), torch.as_tensor(q),
                               torch.as_tensor(ADV_AA), torch.as_tensor(mask),
                               sps, lag)
    np.testing.assert_array_equal(np.asarray(h), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(b), got[1].numpy())
    assert got[0].numpy().sum() >= 1


# --------------------------------------------------------------------------
# K4 with clamped tail gathers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sps", [4, 2])
def test_decode_clamp_tail_twin_matches_xla_decode(sps):
    rng = np.random.default_rng(sps)
    m, kb, c = 6, 3000, 8
    bits = rng.integers(0, 2, (m, kb)).astype(np.int8)
    pos = rng.integers(0, kb, (m, c)).astype(np.int32)
    pos[:, -1] = kb - 1 - np.arange(m) * 37      # windows past the tail
    pos[0, 0] = kb + 40                          # past the lattice
    whiten = np.stack([W.whitening_bits(ch, 336) for ch in (37, 3, 38, 9, 20, 39)])
    crc = np.full(m, lfsr_init_to_table_init("555555"), np.int32)
    crc[1] = lfsr_init_to_table_init(CONN_CRC_HEX)
    adv = np.array([True, False, True, False, False, True])
    args = [torch.as_tensor(a) for a in (bits, pos, whiten, crc, adv)]
    got = decode_candidates(*args, sps=sps, clamp_tail=True)
    twin = decode_candidates_reference(*args, sps=sps, clamp_tail=True)
    plen, match, pkt, len_ok, _ = _decode_candidate(
        args[1], args[0], args[2], args[3], args[4], sps)
    for g, t, x in zip(got, twin, (pkt, plen, match, len_ok)):
        assert torch.equal(g, t) and torch.equal(g, x)
    table = jnp.asarray(CRC24_TABLE.astype(np.int32))
    for r in range(m):
        f = jax.vmap(lambda p, _r=r: j_decode_candidate(
            p, jnp.asarray(bits[_r]), jnp.asarray(whiten[_r]),
            jnp.int32(crc[_r]), jnp.asarray(adv[_r]), table, sps))
        jplen, jmatch, jpkt, jlen_ok, _ = f(jnp.asarray(pos[r]))
        np.testing.assert_array_equal(np.asarray(jpkt), got[0][r].numpy())
        np.testing.assert_array_equal(np.asarray(jplen), got[1][r].numpy())
        np.testing.assert_array_equal(np.asarray(jmatch), got[2][r].numpy())
        np.testing.assert_array_equal(np.asarray(jlen_ok), got[3][r].numpy())
    # the zero-padded mode really differs on these tails
    zero = decode_candidates_reference(*args, sps=sps)
    assert not torch.equal(zero[0], got[0])


# --------------------------------------------------------------------------
# stream_decode and golden_decode
# --------------------------------------------------------------------------


def _key(res):
    pk = lambda p: (p.sample_pos, p.phase, p.payload_len, p.crc_ok,
                    bytes(p.pdu_bytes), bytes(p.crc_bytes), p.rssi_dbm)
    return ([pk(p) for p in res.packets], [pk(p) for p in res.bad_headers],
            res.num_hits, res.consumed)


def _both(i, q, **kw):
    ref = jdec.stream_decode(i, q, **kw)
    got = tdec.stream_decode(i, q, device="cpu", **kw)
    assert _key(ref) == _key(got)
    return got


def _data_scene(seed, n=9000):
    rng = np.random.default_rng(seed)
    return _scene(seed, n, [(700, 9, _pdu_bits(rng, 8, 0x01), CONN_AA_HEX,
                             CONN_CRC_HEX),
                            (4200, 9, _pdu_bits(rng, 25, 0x02), CONN_AA_HEX,
                             CONN_CRC_HEX)])


CASES = {
    "adv": lambda: (_adv_scene(1), dict(channel=37)),
    "adv_limit_start": lambda: (_adv_scene(2), dict(channel=37, scan_limit=6000,
                                                     start=700)),
    "data": lambda: (_data_scene(3), dict(
        channel=9, access_address=CONN_AA,
        crc_init_table=lfsr_init_to_table_init(CONN_CRC_HEX))),
    "raw": lambda: (_adv_scene(4), dict(channel=37, raw=True)),
    "rssi": lambda: (_adv_scene(5, amplitude=900.0, noise=20),
                     dict(channel=37, rssi=True)),
    "aa_mask": lambda: (_adv_scene(6, noise=60, amplitude=400.0),
                        dict(channel=37, aa_mask_hex="ffff0fff")),
    "slot_overflow": lambda: (_adv_scene(7, noise=60, amplitude=400.0),
                              dict(channel=37, aa_mask_hex="000000ff",
                                   max_candidates=3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_decode_matches_jax(case):
    (i, q), kw = CASES[case]()
    got = _both(i, q, **kw)
    if case in ("adv", "rssi", "data"):
        assert sum(p.crc_ok for p in got.packets) == 2
    if case == "rssi":
        assert all(p.rssi_dbm is not None for p in got.packets)
    if case == "slot_overflow":
        assert got.num_hits > 3


@pytest.mark.parametrize("raw", [False, True])
def test_stream_decode_tail_window(raw):
    """scan_limit=None with a packet whose window reaches into the
    lattice's last samples: the clamped tail gathers decide the bytes."""
    rng = np.random.default_rng(9)
    bits = _pdu_bits(rng, 30, 0x40)
    ci, _, _ = G.btle_tx(bits, 37, sps=4, flavor="c")
    n = 3000 + len(ci) - 400             # the burst's last 400 samples cut
    i, q = _scene(9, n, [(3000, 37, bits, "d6be898e", "555555")])
    got = _both(i, q, channel=37, raw=raw)
    if raw:
        assert any(p.sample_pos >= 3000 for p in got.packets)


@pytest.mark.parametrize("sps", [8, 4])
def test_golden_decode_matches_jax(sps):
    rng = np.random.default_rng(sps)
    bits = _pdu_bits(rng, 14, 0x40)
    ci, cq, _ = G.btle_tx(bits, 37, sps=sps, flavor="python")
    pad = rng.integers(-3, 4, (2, 700)).astype(np.int16)
    i = np.concatenate([pad[0], np.asarray(ci, np.int16), pad[1]])
    q = np.concatenate([pad[1], np.asarray(cq, np.int16), pad[0]])
    ref = jdec.golden_decode(i, q, 37, sps=sps)
    got = tdec.golden_decode(i, q, 37, sps=sps, device="cpu")
    assert got.crc_ok and ref.crc_ok
    assert (ref.payload_len, ref.best_phase, ref.aa_found) == \
        (got.payload_len, got.best_phase, got.aa_found)
    np.testing.assert_array_equal(ref.pdu_bits, got.pdu_bits)
    np.testing.assert_array_equal(B.bits_to_bytes(got.pdu_bits),
                                  B.bits_to_bytes(bits))


def test_decoders_need_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda")
    i, q = _adv_scene(1, n=3000)
    with pytest.raises(RuntimeError):
        tdec.stream_decode(i, q, 37)
    with pytest.raises(RuntimeError):
        tdec.golden_decode(i, q, 37)
