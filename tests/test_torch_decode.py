"""The port's candidate decode (the plain twin of the CUDA kernel, on the
CPU) and earliest-hit selection against the JAX package.

Random lattices and positions across all 40 channels, mixed CRC inits
and adv/data flags. decode_candidates_reference has the Pallas kernel's
semantics (zero past the lattice end), so it must equal
decode_candidates_pallas everywhere; against the XLA decode
(_decode_candidate, which clamps gathers to the last element) it must be
exactly equal for every candidate whose window lies inside the lattice.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from btle_tpu.rx.pallas_decode import decode_candidates_pallas
from btle_tpu.rx.pipeline import _decode_candidate as j_decode_candidate
from btle_tpu.rx.pipeline import earliest_hits as j_earliest_hits
from btle_tpu.spec import whitening as W
from btle_tpu.spec.crc24 import CRC24_TABLE, lfsr_init_to_table_init

from btle_tpu_torch.rx.decode_kernel import decode_candidates, decode_candidates_reference
from btle_tpu_torch.rx.pipeline import _decode_candidate, earliest_hits

torch.set_num_threads(2)


def _inputs(sps, kb=5000, c=16, seed=0):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (40, kb)).astype(np.int8)
    span = (32 + 336) * sps
    pos = rng.integers(0, kb - span, (40, c)).astype(np.int32)
    pos[3, 2] = kb - 100           # tail candidates: past the lattice end
    pos[7, 0] = kb + 50            # out of range: clamped
    whiten = np.stack([W.whitening_bits(ch, 336) for ch in range(40)])
    crc = np.full(40, lfsr_init_to_table_init("555555"), np.int32)
    crc[5:10] = 12345              # mixed inits (followed-connection case)
    adv = np.array([i % 3 == 0 for i in range(40)])
    return bits, pos, whiten, crc, adv


@pytest.mark.parametrize("sps", [4, 2])
def test_decode_reference_matches_pallas_and_xla(sps):
    bits, pos, whiten, crc, adv = _inputs(sps)
    with pltpu.force_tpu_interpret_mode():
        ref = decode_candidates_pallas(
            jnp.asarray(bits), jnp.asarray(pos), jnp.asarray(whiten),
            jnp.asarray(crc), jnp.asarray(adv), sps=sps, interpret=True)
    ref = [np.asarray(a) for a in ref]
    got = decode_candidates(torch.as_tensor(bits), torch.as_tensor(pos),
                            torch.as_tensor(whiten), torch.as_tensor(crc),
                            torch.as_tensor(adv), sps=sps)
    got = [a.numpy() for a in got]
    for r, g, name in zip(ref, got, ("bytes", "plen", "match", "len_ok")):
        assert r.shape == g.shape and r.dtype == g.dtype, name
        np.testing.assert_array_equal(r, g, err_msg=name)
    # decoding random bits must hit both verdicts somewhere
    assert got[3].any() and not got[3].all()

    table = jnp.asarray(CRC24_TABLE.astype(np.int32))
    xla = []
    for ch in range(40):
        f = jax.vmap(lambda p, _ch=ch: j_decode_candidate(
            p, jnp.asarray(bits[_ch]), jnp.asarray(whiten[_ch]),
            jnp.int32(crc[_ch]), jnp.asarray(adv[_ch]), table, sps))
        plen, cm, pb, lo, _ = f(jnp.asarray(pos[ch]))
        xla.append((np.asarray(pb), np.asarray(plen), np.asarray(cm),
                    np.asarray(lo)))
    xla = [np.stack(x) for x in zip(*xla)]
    inside = pos.astype(np.int64) + (32 + 335) * sps < bits.shape[1]
    assert inside.sum() == pos.size - 2
    for r, g in zip(xla, got):
        np.testing.assert_array_equal(r[inside], g[inside])


@pytest.mark.parametrize("sps", [4, 2])
def test_xla_decode_candidate_matches(sps):
    """The port's _decode_candidate (the XLA decode's clamped gathers)
    equals btle_tpu's everywhere, tail candidates included."""
    bits, pos, whiten, crc, adv = _inputs(sps, kb=3000, c=8, seed=1)
    pos = np.clip(pos, 0, bits.shape[1] - 1)
    table = jnp.asarray(CRC24_TABLE.astype(np.int32))
    plen, cm, pb, lo, dew = _decode_candidate(
        torch.as_tensor(pos), torch.as_tensor(bits), torch.as_tensor(whiten),
        torch.as_tensor(crc), torch.as_tensor(adv), sps)
    for ch in (0, 3, 5, 7, 39):
        f = jax.vmap(lambda p, _ch=ch: j_decode_candidate(
            p, jnp.asarray(bits[_ch]), jnp.asarray(whiten[_ch]),
            jnp.int32(crc[_ch]), jnp.asarray(adv[_ch]), table, sps))
        r = [np.asarray(a) for a in f(jnp.asarray(pos[ch]))]
        for a, b in zip(r, (plen[ch], cm[ch], pb[ch], lo[ch], dew[ch])):
            np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("density,min_pos", [(1e-3, 0), (2e-2, 0),
                                             (2e-2, 1500), (0.0, 0)])
def test_earliest_hits_match(density, min_pos):
    rng = np.random.default_rng(3)
    hit = rng.random((40, 4100)) < density
    hit[9, :40] = True                       # more hits than slots early on
    pos, valid, num = earliest_hits(torch.as_tensor(hit), 16, min_pos)
    for ch in range(40):
        rp, rv, rn = (np.asarray(a) for a in j_earliest_hits(
            jnp.asarray(hit[ch]), 16, min_pos))
        np.testing.assert_array_equal(rp, pos[ch].numpy())
        np.testing.assert_array_equal(rv, valid[ch].numpy())
        assert int(rn) == int(num[ch])


def test_reference_is_cpu_path_only():
    bits, pos, whiten, crc, adv = _inputs(4, kb=2000, c=4)
    args = [torch.as_tensor(a) for a in (bits, pos, whiten, crc, adv)]
    ref = decode_candidates_reference(*args, sps=4)
    got = decode_candidates(*args, sps=4)
    for r, g in zip(ref, got):
        assert torch.equal(r, g)
    with pytest.raises(ValueError):
        decode_candidates(args[0].to("meta"), *args[1:], sps=4)


def _warp_schedule_model(lattice, pos, whiten, crc_init, adv, sps, clamp):
    """numpy model of csrc/decode_candidates.cu's schedule for one
    candidate: the 11 ballot words (bit l of word w = dewhitened window
    bit 32w + l, zero past bit 336), bytes cut from the words, the
    header's length, and the CRC walked one table lookup per byte over a
    table built by 8 reflected LFSR steps per entry (the CTA prologue)."""
    table = np.zeros(256, np.uint32)
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ 0xDA6000 if c & 1 else c >> 1
        table[b] = c
    kb = lattice.shape[0]
    p = int(pos) if clamp else min(max(int(pos), 0), kb - 1)
    i = np.arange(352)
    idx = p + 32 * sps + i * sps
    if clamp:
        raw = lattice[np.clip(idx, 0, kb - 1)].astype(np.int64)
    else:
        raw = np.where(idx < kb, lattice[np.minimum(idx, kb - 1)], 0).astype(np.int64)
    bit = np.where(i < 336, (raw ^ np.pad(whiten.astype(np.int64), (0, 16))) & 1, 0)
    words = [sum(int(bit[32 * w + lane]) << lane for lane in range(32)) for w in range(11)]

    def byte(b):
        return (words[b >> 2] >> (8 * (b & 3))) & 0xFF

    plen = byte(1) & (63 if adv else 31)
    plen_c = min(plen, 37)
    crc = int(crc_init) & 0xFFFFFF
    for b in range(plen_c + 2):
        crc = int(table[(crc ^ byte(b)) & 0xFF]) ^ (crc >> 8)
    rcv = byte(plen_c + 2) | byte(plen_c + 3) << 8 | byte(plen_c + 4) << 16
    return table, [byte(b) for b in range(42)], plen, crc == rcv, crc


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("sps", [1, 2, 4, 8])
def test_warp_schedule_model_matches_twin_and_jax_crc(sps, clamp):
    """The kernel's warp formulation (ballot words, byte walk over an
    in-kernel table) gives the twin's bytes, length and CRC verdict on
    random candidates, positions before, at and past the lattice end; its
    table is btle_tpu.spec.crc24's, and its CRC state is
    crc24_bytes over the header and payload."""
    from btle_tpu.spec.crc24 import crc24_bytes

    bits, pos, whiten, crc, adv = _inputs(sps, kb=3000, c=6)
    pos[:, 0] = -40
    pos[:, 1] = 2999
    pos[:, 2] = 3100
    args = [torch.as_tensor(a) for a in (bits, pos, whiten, crc, adv)]
    pkt, plen, match, _ = decode_candidates_reference(*args, sps=sps, clamp_tail=clamp)
    for m in range(0, 40, 3):
        for c in range(pos.shape[1]):
            table, got, g_plen, g_match, state = _warp_schedule_model(
                bits[m], pos[m, c], whiten[m], crc[m], bool(adv[m]), sps, clamp)
            assert got == pkt[m, c].tolist()
            assert g_plen == int(plen[m, c]) and g_match == bool(match[m, c])
            span = min(g_plen, 37) + 2
            assert state == crc24_bytes(np.asarray(got[:span], np.uint8), int(crc[m]))
    np.testing.assert_array_equal(table, CRC24_TABLE)
