"""The port's copies of the JAX package's numpy tables and helpers are
equal to the originals: channelizer and fused-front-end table functions,
spec tables, golden-model pieces, the self-test scene, and the
convert.py round trip of scan and filter tables."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from btle_tpu.golden import model as G
from btle_tpu.spec import bits as B
from btle_tpu.spec import crc24 as C
from btle_tpu.spec import whitening as W
from btle_tpu.wideband import channelizer as jch
from btle_tpu.wideband import fused as jfused

from btle_tpu_torch import convert
from btle_tpu_torch.golden import model as tG
from btle_tpu_torch.spec import bits as tB
from btle_tpu_torch.spec import crc24 as tC
from btle_tpu_torch.spec import whitening as tW
from btle_tpu_torch.wideband import channelizer as tch
from btle_tpu_torch.wideband import fused as tfused

torch.set_num_threads(2)

GEOMETRIES = [(640, 1.0), (640, 1.2), (1280, 1.0), (1280, 1.2)]
TABLE_FNS = ["prototype_filter", "_poly_kernel", "_fused_kernel", "_g_stack",
             "_g_chunks", "_g_chunks_hilo", "_g_chunks_x2", "_poly_tables",
             "_polyx_tables"]


def _flat(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("num_taps,cutoff", GEOMETRIES)
@pytest.mark.parametrize("table_fn", TABLE_FNS)
def test_table_fns_equal(table_fn, num_taps, cutoff):
    src = jch if hasattr(jch, table_fn) else jfused
    if table_fn == "_polyx_tables":
        ref = src._polyx_tables(num_taps, 2, cutoff)
        got = tfused._polyx_tables(num_taps, 2, cutoff)
    else:
        ref = getattr(src, table_fn)(num_taps, cutoff)
        got = getattr(tch if hasattr(tch, table_fn) else tfused, table_fn)(
            num_taps, cutoff)
    ref, got = _flat(ref), _flat(got)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        r, g = np.asarray(r), np.asarray(g)
        assert r.dtype == g.dtype and r.shape == g.shape
        assert np.array_equal(r, g)


def test_channel_maps_and_dft_equal():
    assert np.array_equal(jch.branch_columns(), tch.branch_columns())
    for r, g in zip(jch._dft_matrix(), tch._dft_matrix()):
        assert np.array_equal(r, g)
    for ch in range(40):
        assert jch.channel_to_bin(ch) == tch.channel_to_bin(ch)
    for m in range(40):
        assert jch.bin_to_channel(m) == tch.bin_to_channel(m)


def test_spec_copies_equal():
    for ch in range(40):
        assert np.array_equal(W.whitening_bits(ch, 336), tW.whitening_bits(ch, 336))
    assert np.array_equal(W.make_whitening_table(), tW.make_whitening_table())
    assert np.array_equal(C.CRC24_TABLE, tC.CRC24_TABLE)
    for r, g in zip(C.linear_crc_matrices(42), tC.linear_crc_matrices(42)):
        assert np.array_equal(r, g)
    for h in ("555555", "a1b2c3"):
        assert C.lfsr_init_to_table_init(h) == tC.lfsr_init_to_table_init(h)
    assert C.crc_init_reorder(0x123456) == tC.crc_init_reorder(0x123456)
    assert np.array_equal(B.hex_to_bits("d6be898e"), tB.hex_to_bits("d6be898e"))


@pytest.mark.parametrize("channel,phy", [(37, "1m"), (9, "1m"), (38, "2m"),
                                         (22, "2m")])
def test_golden_copies_equal(channel, phy):
    rng = np.random.default_rng(7)
    pdu = B.bytes_to_bits(rng.integers(0, 256, 14, dtype=np.uint8))
    kw = dict(crc_init_hex="a1b2c3", access_address_hex="35556550",
              phy=phy)
    ref = G.assemble_phy_bits(pdu, channel, **kw)
    got = tG.assemble_phy_bits(pdu, channel, **kw)
    assert np.array_equal(ref, got)
    for sps in (8, 80):
        for r, g in zip(G.gfsk_modulate_float(ref, sps),
                        tG.gfsk_modulate_float(got, sps)):
            assert np.array_equal(r, g)
    assert np.array_equal(G.gauss_fir(40), tG.gauss_fir(40))


@pytest.mark.parametrize("phy", ["1m", "2m"])
def test_selftest_scene_equals_jax(phy):
    """The port builds the known-answer scene from its golden copies; it
    must be the JAX package's scene (built through the TX descriptor
    path) sample for sample."""
    from btle_tpu.wideband.selftest import _scene as jscene

    from btle_tpu_torch.wideband.selftest import _scene as tscene

    rwi, rwq, rexp = jscene(phy)
    gwi, gwq, gexp = tscene(phy)
    assert rexp.keys() == gexp.keys()
    for ch in rexp:
        assert np.array_equal(rexp[ch], gexp[ch])
    np.testing.assert_allclose(gwi, rwi, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gwq, rwq, rtol=0, atol=1e-4)


def test_convert_scan_tables_round_trip():
    from btle_tpu.wideband.sniffer import default_scan_tables as jtables

    from btle_tpu_torch.wideband.sniffer import default_scan_tables as ttables

    ref = [np.asarray(a) for a in jtables()]
    got = convert.scan_tables_from_numpy(*ref, device="cpu")
    port = ttables(device="cpu")
    for r, g, p in zip(ref, got, port):
        assert torch.equal(g, p)
        assert np.array_equal(g.numpy().astype(r.dtype), r)


@pytest.mark.parametrize("num_taps", [640, 1280])
def test_convert_filter_tables_round_trip(num_taps):
    (gk,) = convert.filter_tables_from_numpy(
        "bf16x2w", (jfused._g_chunks_hilo(num_taps),), "cpu")
    assert gk.dtype == torch.bfloat16
    assert np.array_equal(gk.to(torch.float32).numpy(),
                          jfused._g_chunks_hilo(num_taps))
    perm, kcoefx, w4x = convert.filter_tables_from_numpy(
        "f32", jfused._polyx_tables(num_taps), "cpu")
    ref = jfused._polyx_tables(num_taps)
    assert np.array_equal(perm.numpy(), ref[0])
    assert np.array_equal(kcoefx.numpy(), ref[1])
    assert np.array_equal(w4x.numpy(), ref[2])
    for r, g in zip(tfused._device_tables("f32", num_taps, 1.0,
                                          torch.device("cpu")),
                    (perm, kcoefx, w4x)):
        assert torch.equal(r, g)
    with pytest.raises(ValueError):
        convert.filter_tables_from_numpy(
            "bf16x2w", (jfused._g_chunks(num_taps),), "cpu")


@pytest.mark.parametrize("num_taps", [640, 1280])
def test_k5_device_tables_equal_jax(num_taps):
    """The weights K5 runs on, per numerics class, are the JAX package's
    at that class: _g_chunks rounded to bf16 ("bf16", as jnp.asarray casts
    it), _g_chunks_x2 ("f32x2") and _g_chunks ("f32" im2col), exactly."""
    import jax.numpy as jnp

    dev = torch.device("cpu")
    (bf16,) = tfused._device_tables("bf16", num_taps, 1.0, dev)
    want = np.asarray(jnp.asarray(jfused._g_chunks(num_taps), jnp.bfloat16),
                      np.float32)
    assert bf16.dtype == torch.bfloat16
    assert np.array_equal(bf16.to(torch.float32).numpy(), want)
    (x2,) = tfused._device_tables("f32x2", num_taps, 1.0, dev)
    assert x2.dtype == torch.bfloat16
    assert np.array_equal(x2.to(torch.float32).numpy(), jfused._g_chunks_x2(num_taps))
    (f32,) = tfused._device_tables("f32_im2col", num_taps, 1.0, dev)
    assert f32.dtype == torch.float32
    assert np.array_equal(f32.numpy(), jfused._g_chunks(num_taps))
    with pytest.raises(ValueError):
        convert.filter_tables_from_numpy("f32x2", (jfused._g_chunks(num_taps),), dev)


# modules the port copies from the JAX package as they are (pure Python /
# numpy): their code must stay the original's
COPIED_MODULES = ["ll/hop.py", "ll/multifollow.py", "stream/blocks.py",
                  "stream/sources.py", "stream/ndjson.py", "stream/pcap.py",
                  "stream/control.py", "stream/hci.py"]


@pytest.mark.parametrize("module", COPIED_MODULES)
def test_copied_modules_equal_originals(module):
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    trees = [ast.dump(ast.parse((root / pkg / module).read_text()))
             for pkg in ("btle_tpu", "btle_tpu_torch")]
    assert trees[0] == trees[1]


def test_runtime_source_byte_equal():
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    assert ((root / "btle_tpu_torch" / "runtime" / "runtime.cpp").read_bytes()
            == (root / "btle_tpu" / "runtime" / "runtime.cpp").read_bytes())
