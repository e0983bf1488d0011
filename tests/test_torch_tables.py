"""The port's copies of the JAX package's numpy tables and helpers are
equal to the originals: channelizer and fused-front-end table functions,
spec tables (the LE Coded framing too), golden-model pieces (pulses,
phase tables, the three modulators), the fixed-point modulator tables,
the TX descriptor and playback modules, the self-test scene, and the
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


def test_spec_coded_copy_equal():
    """spec/coded.py: constants, FEC encoder, pattern mapper and demapper,
    Coded-PHY framing and the coded AA patterns equal the original's."""
    from btle_tpu.spec import coded as K
    from btle_tpu_torch.spec import coded as tK

    for name in ("FEC_G0", "FEC_G1", "FEC_K", "N_TERM", "P4_MAP",
                 "PREAMBLE_UNIT", "N_PREAMBLE_SYMBOLS", "CI_S8", "CI_S2"):
        assert getattr(K, name) == getattr(tK, name), name
    rng = np.random.default_rng(11)
    msg = rng.integers(0, 2, 77).astype(np.int8)
    for state in (0, 5):
        assert np.array_equal(K.fec_encode(msg, state), tK.fec_encode(msg, state))
    for s in (2, 8):
        assert np.array_equal(K.pattern_map(msg, s), tK.pattern_map(msg, s))
        soft = rng.normal(0, 1, 4 * 33)
        assert np.array_equal(K.pattern_demap_soft(soft, s),
                              tK.pattern_demap_soft(soft, s))
        pdu = rng.integers(0, 2, 14 * 8).astype(np.int8)
        for aa, crc in (("d6be898e", "555555"), ("60850a1b", "a77b22")):
            assert np.array_equal(K.assemble_coded_phy(pdu, 9, s, aa, crc),
                                  tK.assemble_coded_phy(pdu, 9, s, aa, crc))
            assert np.array_equal(K.coded_aa_symbols(aa, s),
                                  tK.coded_aa_symbols(aa, s))
        assert K.fec2_symbol_count(112, s) == tK.fec2_symbol_count(112, s)
    assert np.array_equal(K.preamble_symbols(), tK.preamble_symbols())
    assert K.fec1_symbol_count() == tK.fec1_symbol_count()


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


GOLDEN_COPIES = ["gauss_fir", "sin_cos_tables", "c_flavor_pulse", "c_flavor_taps",
                 "gfsk_modulate_python", "gfsk_modulate_float", "gfsk_modulate_c",
                 "_c_tables", "assemble_phy_bits", "btle_tx", "demod_symbol_lag",
                 "search_bit_sequence", "GoldenRxResult", "btle_rx",
                 "add_freq_sampling_error", "add_noise"]


@pytest.mark.parametrize("name", GOLDEN_COPIES)
def test_golden_functions_are_copies(name):
    """Each golden function the port copies has the original's code."""
    import ast
    import inspect

    assert (ast.dump(ast.parse(inspect.getsource(getattr(G, name))))
            == ast.dump(ast.parse(inspect.getsource(getattr(tG, name)))))


@pytest.mark.parametrize("name", ["deinterleave", "ring_source"])
def test_runtime_functions_are_copies(name):
    """The runtime helpers the port copies (numpy and ctypes around the
    byte-equal runtime.cpp) have the original's code."""
    import ast
    import inspect

    from btle_tpu import runtime as jrt
    from btle_tpu_torch import runtime as trt

    assert (ast.dump(ast.parse(inspect.getsource(getattr(jrt, name))))
            == ast.dump(ast.parse(inspect.getsource(getattr(trt, name)))))


@pytest.mark.parametrize("sps", [4, 8])
def test_golden_modulator_copies_equal(sps):
    bits = np.random.default_rng(sps).integers(0, 2, 300).astype(np.int8)
    for r, g in zip(G.sin_cos_tables(64, sps), tG.sin_cos_tables(64, sps)):
        assert r.dtype == g.dtype and np.array_equal(r, g)
    assert np.array_equal(G.c_flavor_pulse(sps), tG.c_flavor_pulse(sps))
    assert np.array_equal(G.c_flavor_taps(sps), tG.c_flavor_taps(sps))
    for r, g in zip(G.gfsk_modulate_python(bits, sps), tG.gfsk_modulate_python(bits, sps)):
        assert r.dtype == g.dtype and np.array_equal(r, g)
    if sps == 4:
        for r, g in zip(G.gfsk_modulate_c(bits, 4), tG.gfsk_modulate_c(bits, 4)):
            assert r.dtype == g.dtype and np.array_equal(r, g)
        for r, g in zip(G._c_tables(), tG._c_tables()):
            assert np.array_equal(r, g)
    with pytest.raises(ValueError):
        tG.gfsk_modulate_python(bits, 80)


@pytest.mark.parametrize("table_fn,sps", [("golden_mod_tables", 8),
                                          ("golden_mod_tables", 4),
                                          ("c_mod_tables", 4)])
def test_mod_tables_equal(table_fn, sps):
    from btle_tpu.phy import tables as jt

    from btle_tpu_torch.phy import tables as tt

    ref, got = getattr(jt, table_fn)(sps), getattr(tt, table_fn)(sps)
    for r, g in zip(ref, got):
        assert np.asarray(r).dtype == np.asarray(g).dtype and np.array_equal(r, g)


def test_descriptor_constant_tables_equal():
    from btle_tpu.tx import descriptor as jd

    from btle_tpu_torch.tx import descriptor as td

    for name in ("DEFAULT_SPACE_MS", "ADV_PKT_TYPES", "LL_CTRL_OPCODES", "AD_TYPES",
                 "ALL_PKT_TYPES", "ADV_AA", "IBEACON_PREFIX"):
        assert getattr(jd, name) == getattr(td, name), name


@pytest.mark.parametrize("phy", ["1m", "2m"])
def test_selftest_scene_equals_jax(phy):
    """The port builds the known-answer scene through its TX descriptor
    path, as the JAX package does; it must be the JAX package's scene
    sample for sample."""
    from btle_tpu.wideband.selftest import _scene as jscene

    from btle_tpu_torch.wideband.selftest import _scene as tscene

    rwi, rwq, rexp = jscene(phy)
    gwi, gwq, gexp = tscene(phy)
    assert rexp.keys() == gexp.keys()
    for ch in rexp:
        assert np.array_equal(rexp[ch], gexp[ch])
    assert gwi.dtype == rwi.dtype and np.array_equal(gwi, rwi)
    assert gwq.dtype == rwq.dtype and np.array_equal(gwq, rwq)


def test_convert_scan_tables_round_trip():
    from btle_tpu.wideband.sniffer import default_scan_tables as jtables

    from btle_tpu_torch.wideband.sniffer import default_scan_tables as ttables

    ref = [np.asarray(a) for a in jtables()]
    got = convert.scan_tables_from_numpy(*ref, device="cpu")
    port = ttables(device="cpu")
    for r, g, p in zip(ref, got, port):
        assert torch.equal(g, p)
        assert np.array_equal(g.numpy().astype(r.dtype), r)


def _hilo_mapping(g_hilo):
    """The tensor-core B operand by its definition, entry by entry:
    B[s*40 + i, o] = Ghi[s][o, i], B[s*40 + i, 80 + o] = Glo[s][o, i] with
    G[s] the shift-s block of the stacked im2col pair (rows 0..79 hi,
    80..159 lo), zero rows up to a multiple of 64."""
    n_chunks, _, cols = g_hilo.shape
    chunk = cols // 40
    shifts = n_chunks * chunk
    want = np.zeros((-(-shifts * 40 // 64) * 64, 160), np.float32)
    for s in range(shifts):
        c, j = divmod(s, chunk)
        for o in range(80):
            want[s * 40: s * 40 + 40, o] = g_hilo[c, o, j * 40: j * 40 + 40]
            want[s * 40: s * 40 + 40, 80 + o] = g_hilo[c, 80 + o, j * 40: j * 40 + 40]
    return want


@pytest.mark.parametrize("num_taps", [640, 1280])
def test_convert_filter_tables_round_trip(num_taps):
    (b,) = convert.filter_tables_from_numpy(
        "bf16x2w", (jfused._g_chunks_hilo(num_taps),), "cpu")
    assert b.dtype == torch.bfloat16 and b.is_contiguous()
    assert np.array_equal(b.to(torch.float32).numpy(),
                          _hilo_mapping(jfused._g_chunks_hilo(num_taps)))
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


def _sgemm_mapping(g):
    """T[i, s, o] = G[s // chunk][o, (s % chunk)*40 + i], element by
    element: the FP32 filterbank's (40, S, 80) weight layout."""
    n_chunks, rows, cols = g.shape
    chunk = cols // 40
    want = np.zeros((40, n_chunks * chunk, rows), np.float32)
    for s in range(n_chunks * chunk):
        c, j = divmod(s, chunk)
        for i in range(40):
            want[i, s, :] = g[c, :, j * 40 + i]
    return want


def _bf16_mapping(g):
    """B[s*40 + i, o] = G[s // chunk][o, (s % chunk)*40 + i], element by
    element, zero rows up to a multiple of 64: the tensor-core B layout of
    the "bf16" class."""
    n_chunks, rows, cols = g.shape
    chunk = cols // 40
    shifts = n_chunks * chunk
    want = np.zeros((-(-shifts * 40 // 64) * 64, rows), np.float32)
    for s in range(shifts):
        c, j = divmod(s, chunk)
        for i in range(40):
            want[s * 40 + i, :] = g[c, :, j * 40 + i]
    return want


@pytest.mark.parametrize("num_taps", [640, 1280])
def test_k5_device_tables_equal_jax(num_taps):
    """The weights K5 runs on, per numerics class, are the JAX package's
    at that class: _g_chunks rounded to bf16 ("bf16", as jnp.asarray casts
    it) and _g_chunks_x2 with its duplicated columns dropped ("f32x2"),
    each in its tensor-core B layout with zero rows up to a multiple of
    64, and _g_chunks in the FP32 kernel's (40, S, 80) layout ("f32"
    im2col), exactly."""
    import jax.numpy as jnp

    dev = torch.device("cpu")
    (bf16,) = tfused._device_tables("bf16", num_taps, 1.0, dev)
    want = _bf16_mapping(np.asarray(jnp.asarray(jfused._g_chunks(num_taps), jnp.bfloat16),
                                    np.float32))
    assert bf16.dtype == torch.bfloat16 and tuple(bf16.shape) == want.shape
    assert bf16.shape[0] % convert.HILO_K_ALIGN == 0
    assert not bool(bf16[jfused._g_chunks(num_taps).size // 80:].any())
    assert np.array_equal(bf16.to(torch.float32).numpy(), want)
    (x2,) = tfused._device_tables("f32x2", num_taps, 1.0, dev)
    assert x2.dtype == torch.bfloat16
    assert np.array_equal(x2.to(torch.float32).numpy(),
                          _hilo_mapping(jfused._g_chunks_hilo(num_taps)))
    (f32,) = tfused._device_tables("f32_im2col", num_taps, 1.0, dev)
    assert f32.dtype == torch.float32 and f32.is_contiguous()
    assert np.array_equal(f32.numpy(), _sgemm_mapping(jfused._g_chunks(num_taps)))
    with pytest.raises(ValueError):
        convert.filter_tables_from_numpy("f32x2", (jfused._g_chunks(num_taps),), dev)


# modules the port copies from the JAX package as they are (pure Python /
# numpy): their code must stay the original's
COPIED_MODULES = ["ll/hop.py", "ll/multifollow.py", "stream/blocks.py",
                  "stream/sources.py", "stream/ndjson.py", "stream/pcap.py",
                  "stream/control.py", "stream/hci.py", "tx/descriptor.py",
                  "tx/playback.py", "ll/l2cap.py", "utils/spectrum.py",
                  "cli/vendors.py", "cli/aggregate.py", "cli/pcap_loader.py",
                  "cli/analyze.py", "ll/extchain.py", "cli/tui.py", "utils/vectors.py"]


@pytest.mark.parametrize("module", COPIED_MODULES)
def test_copied_modules_equal_originals(module):
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    trees = [ast.dump(ast.parse((root / pkg / module).read_text()))
             for pkg in ("btle_tpu", "btle_tpu_torch")]
    assert trees[0] == trees[1]


def test_oui_registry_byte_equal():
    """The port's bundled IEEE registry is the JAX package's file."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    port = root / "btle_tpu_torch" / "cli" / "data" / "oui.tsv.gz"
    assert port.read_bytes() == (root / "btle_tpu" / "cli" / "data" / "oui.tsv.gz").read_bytes()
    assert port.stat().st_size > 300_000


def test_runtime_source_byte_equal():
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    assert ((root / "btle_tpu_torch" / "runtime" / "runtime.cpp").read_bytes()
            == (root / "btle_tpu" / "runtime" / "runtime.cpp").read_bytes())


# the tap counts of the CPU tests (640, the selftest's 1280) and smaller
HILO_TAPS = [80, 160, 640, 1280]


@pytest.mark.parametrize("num_taps", HILO_TAPS)
@pytest.mark.parametrize("kind,table_fn", [("bf16x2w", "_g_chunks_hilo"),
                                           ("f32x2", "_g_chunks_x2")])
def test_hilo_weight_layout_is_the_mapping(kind, table_fn, num_taps):
    """The tensor-core kernel's B operand, built through
    filter_tables_from_numpy from the JAX package's own table of the
    class, equals the mapping element by element with zero padding; the
    bf16x2w and f32x2 tables give one B."""
    (b,) = convert.filter_tables_from_numpy(
        kind, (getattr(jfused, table_fn)(num_taps),), "cpu")
    want = _hilo_mapping(jfused._g_chunks_hilo(num_taps))
    assert b.dtype == torch.bfloat16 and tuple(b.shape) == want.shape
    assert b.shape[0] % convert.HILO_K_ALIGN == 0
    assert b.shape[0] >= jfused._g_stack(num_taps).shape[0] * 40
    assert np.array_equal(b.to(torch.float32).numpy(), want)


@pytest.mark.parametrize("num_taps", HILO_TAPS)
def test_bf16_weight_layout_is_the_mapping(num_taps):
    """convert.bf16_weights of the JAX package's _g_chunks, numpy or
    tensor in (a bf16 tensor kept as it is), equals the mapping of its
    bf16 rounding element by element; the twin on it equals the chunked
    true-FP32 sums of the bf16 weights; a table that is not an im2col one
    is refused."""
    g = jfused._g_chunks(num_taps)
    g16 = torch.as_tensor(g).to(torch.bfloat16)
    want = _bf16_mapping(g16.to(torch.float32).numpy())
    for src in (g, torch.as_tensor(g), g16):
        b = convert.bf16_weights(src)
        assert b.dtype == torch.bfloat16 and b.is_contiguous()
        assert np.array_equal(b.to(torch.float32).numpy(), want)
    width = jfused._g_stack(num_taps).shape[0]
    rng = np.random.default_rng(num_taps)
    frames = torch.as_tensor(rng.normal(0, 3, (300 + width - 1, 40))).to(torch.bfloat16)
    y = tfused.filterbank_im2col_reference(frames, convert.bf16_weights(g), width, 300,
                                           "bf16")
    chunk = g.shape[2] // 40
    ref = torch.zeros((80, 300))
    x = frames.to(torch.float32).t()
    with tch.true_fp32():
        for s0 in range(0, width, chunk):
            s1 = min(s0 + chunk, width)
            w = torch.stack([g16[s // chunk, :, (s % chunk) * 40:(s % chunk + 1) * 40]
                             for s in range(s0, s1)], dim=2).to(torch.float32)
            ref += torch.nn.functional.conv1d(x[None, :, s0: s1 + 299].contiguous(), w)[0]
    assert torch.equal(y, ref)
    with pytest.raises(ValueError):
        convert.bf16_weights(g[:, :40])


@pytest.mark.parametrize("num_taps", [640, 1280])
def test_f32x2_table_with_differing_copies_is_refused(num_taps):
    bad = jfused._g_chunks_x2(num_taps).copy()
    bad[2, 17, 80 * 3 + 40 + 5] += np.float32(2.0 ** -8)   # the xlo copy only
    with pytest.raises(ValueError, match="differ"):
        convert.filter_tables_from_numpy("f32x2", (bad,), "cpu")
    with pytest.raises(ValueError):
        convert.filter_tables_from_numpy("f32x2", (bad[:, :, :-40],), "cpu")


@pytest.mark.parametrize("num_taps", HILO_TAPS)
def test_sgemm_weight_layout_is_the_mapping(num_taps):
    """convert.sgemm_weights of the JAX package's _g_chunks equals the
    mapping element by element, numpy or tensor in; the twin on it
    equals the twin on the im2col chunks (the same per-chunk sums), and
    a table that is not an im2col one is refused."""
    g = jfused._g_chunks(num_taps)
    want = _sgemm_mapping(g)
    for src in (g, torch.as_tensor(g)):
        t = convert.sgemm_weights(src)
        assert t.dtype == torch.float32 and t.is_contiguous()
        assert np.array_equal(t.numpy(), want)
    width = jfused._g_stack(num_taps).shape[0]
    frames = torch.as_tensor(np.random.default_rng(num_taps).normal(
        0, 3, (40, 700 + width - 1)).astype(np.float32))
    y = tfused.filterbank_im2col_reference(frames, convert.sgemm_weights(g), width, 700,
                                           "f32_im2col")
    w = torch.as_tensor(want).permute(2, 0, 1)
    chunk = g.shape[2] // 40
    ref = torch.zeros((80, 700))
    with tch.true_fp32():
        for s0 in range(0, width, chunk):
            s1 = min(s0 + chunk, width)
            ref += torch.nn.functional.conv1d(frames[None, :, s0: s1 + 699],
                                              w[:, :, s0:s1].contiguous())[0]
    assert torch.equal(y, ref)
    with pytest.raises(ValueError):
        convert.sgemm_weights(g[:, :40])
