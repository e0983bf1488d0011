"""The port's public surface against the JAX package's, and the functions
that completed it held against their originals on the CPU: the golden
chain (btle_tx, btle_rx and its parts, the channel impairments),
phy.demodulator.aa_hits, runtime.deinterleave and runtime.ring_source.

The walk: every port module with a counterpart file in btle_tpu has each
public callable of the original — those the original defines, and for a
package the ones it re-exports from modules the port has. The CLI's
subcommands still to port (tui, send-cmd, mcp: ROADMAP Queue 1 item
15 (a2)) are exempt.
"""

import importlib
import inspect
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from btle_tpu import runtime as jruntime
from btle_tpu.golden import model as G
from btle_tpu.phy import demodulator as jdemod
from btle_tpu.spec import bits as B

from btle_tpu_torch import golden as tgolden
from btle_tpu_torch import phy as tphy
from btle_tpu_torch import runtime as truntime
from btle_tpu_torch import stream as tstream

ROOT = pathlib.Path(__file__).resolve().parent.parent
# cli/app.py subcommands the port lacks until ROADMAP Queue 1 item 15 (a2)
EXEMPT = {"btle_tpu.cli.app": {"cmd_tui", "cmd_send_cmd", "cmd_mcp"}}
# the LE Coded and simulation modules: each must be walked (no exemption)
CODED_AND_SIM = ("btle_tpu.sim", "btle_tpu.sim.ber", "btle_tpu.sim.channel",
                 "btle_tpu.sim.sweep", "btle_tpu.spec.coded", "btle_tpu.phy.viterbi",
                 "btle_tpu.rx.coded", "btle_tpu.wideband.coded")


def _module_name(pkg: str, rel: pathlib.Path) -> str:
    parts = rel.with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join((pkg, *parts))


def _has_port_file(jax_module: str) -> bool:
    rel = pathlib.Path(*jax_module.split(".")[1:])
    port = ROOT / "btle_tpu_torch" / rel
    return (port.with_suffix(".py")).exists() or (port / "__init__.py").exists()


PAIRS = sorted(
    (_module_name("btle_tpu", p.relative_to(ROOT / "btle_tpu_torch")),
     _module_name("btle_tpu_torch", p.relative_to(ROOT / "btle_tpu_torch")))
    for p in (ROOT / "btle_tpu_torch").rglob("*.py")
    if p.name != "__main__.py"
    and (ROOT / "btle_tpu" / p.relative_to(ROOT / "btle_tpu_torch")).exists())


def test_walk_covers_coded_and_sim():
    walked = {j for j, _ in PAIRS}
    assert set(CODED_AND_SIM) <= walked, sorted(set(CODED_AND_SIM) - walked)
    assert not set(CODED_AND_SIM) & set(EXEMPT)


@pytest.mark.parametrize("jax_name,port_name", PAIRS)
def test_port_modules_have_the_originals_public_callables(jax_name, port_name):
    jm, tm = importlib.import_module(jax_name), importlib.import_module(port_name)
    is_pkg = hasattr(jm, "__path__")
    want = set()
    for name, value in vars(jm).items():
        if name.startswith("_") or inspect.ismodule(value) or not callable(value):
            continue
        home = getattr(value, "__module__", None) or ""
        if home == jax_name or (is_pkg and home.startswith("btle_tpu.")
                                and _has_port_file(home)):
            want.add(name)
    missing = sorted(want - EXEMPT.get(jax_name, set()) - set(vars(tm)))
    assert not missing, f"{port_name} lacks {missing}"


# --------------------------------------------------------------------------
# the golden chain
# --------------------------------------------------------------------------


def _pdu(rng, n=20, header=0x40):
    return B.bytes_to_bits(np.concatenate(
        [[header, n], rng.integers(0, 256, n)]).astype(np.uint8))


@pytest.mark.parametrize("flavor,sps,phy", [("python", 8, "1m"), ("c", 4, "1m"),
                                            ("python", 8, "2m"), ("c", 4, "2m")])
def test_btle_tx_equals_jax(flavor, sps, phy):
    pdu = _pdu(np.random.default_rng(sps))
    kw = dict(crc_init_hex="a1b2c3", access_address_hex="35556550", sps=sps,
              flavor=flavor, phy=phy)
    for r, g in zip(G.btle_tx(pdu, 9, **kw), tgolden.btle_tx(pdu, 9, **kw)):
        assert r.dtype == g.dtype and np.array_equal(r, g)


@pytest.mark.parametrize("ppm,snr_db,sps,flavor", [(0.0, 30.0, 8, "python"),
                                                   (20.0, 20.0, 4, "c"),
                                                   (50.0, 14.0, 8, "python")])
def test_btle_rx_chain_equals_jax(ppm, snr_db, sps, flavor):
    """btle_tx, add_freq_sampling_error, add_noise (the same generator
    seed fed to both) and btle_rx give the JAX package's arrays and
    result field for field."""
    pdu = _pdu(np.random.default_rng(int(ppm) + sps), n=17)
    outs = []
    for mod in (G, tgolden):
        i, q, _ = mod.btle_tx(pdu, 37, sps=sps, flavor=flavor)
        i, q, fo = mod.add_freq_sampling_error(i, q, ppm, sps=sps)
        i, q = mod.add_noise(i, q, snr_db, rng=np.random.default_rng(99))
        pad = np.zeros(5 * sps)
        i16 = np.round(np.concatenate([pad, i, pad])).astype(np.int16)
        q16 = np.round(np.concatenate([pad, q, pad])).astype(np.int16)
        outs.append((fo, i16, q16, mod.btle_rx(i16, q16, 37, sps=sps)))
    (fo_j, i_j, q_j, res_j), (fo_t, i_t, q_t, res_t) = outs
    assert fo_j == fo_t and np.array_equal(i_j, i_t) and np.array_equal(q_j, q_t)
    assert isinstance(res_t, tgolden.GoldenRxResult)
    for field in ("pdu_bits", "phy_bits", "bits_all_phases", "decision_all_phases"):
        assert np.array_equal(getattr(res_j, field), getattr(res_t, field)), field
    assert (res_j.crc_ok, res_j.payload_len, res_j.best_phase) == \
        (res_t.crc_ok, res_t.payload_len, res_t.best_phase)
    if snr_db >= 20:
        assert res_t.crc_ok


def test_demod_and_search_equal_jax():
    rng = np.random.default_rng(4)
    i, q = rng.integers(-127, 128, (2, 500)).astype(np.int16)
    for r, g in zip(G.demod_symbol_lag(i, q), tgolden.demod_symbol_lag(i, q)):
        assert r.dtype == g.dtype and np.array_equal(r, g)
    bits = rng.integers(0, 2, 400).astype(np.int8)
    for pattern in (bits[123:155], np.ones(40, np.int8), bits[-32:]):
        assert G.search_bit_sequence(bits, pattern) == tgolden.search_bit_sequence(bits, pattern)


# --------------------------------------------------------------------------
# aa_hits
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sps,lag,mask_hex", [(4, 1, "ffffffff"), (4, 4, "f7fffffe"),
                                              (2, 2, "ffff0fff"), (8, 8, "00000000")])
def test_aa_hits_equals_jax(sps, lag, mask_hex):
    rng = np.random.default_rng(sps * 10 + lag)
    rows = []
    for r in range(2):
        i, q, _ = G.btle_tx(_pdu(rng, 12), 37, sps=sps, flavor="c" if sps == 4 else "python")
        n = len(i) + 3000
        ii = np.round(rng.normal(0, 6, n)).astype(np.int16)
        qq = np.round(rng.normal(0, 6, n)).astype(np.int16)
        at = 500 + 700 * r
        ii[at: at + len(i)] += i.astype(np.int16)
        qq[at: at + len(q)] += q.astype(np.int16)
        rows.append((ii[: 3000 + 200 * 8], qq[: 3000 + 200 * 8]))
    aa = B.hex_to_bits("d6be898e")
    mask = B.hex_to_bits(mask_hex)
    want = [jdemod.aa_hits(jnp.asarray(i), jnp.asarray(q), jnp.asarray(aa),
                           jnp.asarray(mask), sps, lag) for i, q in rows]
    ti = torch.as_tensor(np.stack([r[0] for r in rows]))
    tq = torch.as_tensor(np.stack([r[1] for r in rows]))
    hit, bits = tphy.aa_hits(ti, tq, torch.as_tensor(aa), torch.as_tensor(mask), sps, lag)
    assert hit.dtype == torch.bool and bits.dtype == torch.int8
    for k, (wh, wb) in enumerate(want):
        assert np.array_equal(hit[k].numpy(), np.asarray(wh))
        assert np.array_equal(bits[k].numpy(), np.asarray(wb))
    if mask_hex == "00000000":
        assert bool(hit.all())
    elif mask_hex == "ffffffff":
        assert int(hit.sum()) >= 2
    one = tphy.aa_hits(ti[0], tq[0], aa, mask, sps, lag)
    assert torch.equal(one[0], hit[0]) and torch.equal(one[1], bits[0])


# --------------------------------------------------------------------------
# runtime.deinterleave and runtime.ring_source
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fmt,dtype", [("i8", np.int8), ("i16", np.int16),
                                       ("f32", np.float32)])
def test_deinterleave_equals_jax(fmt, dtype):
    rng = np.random.default_rng(len(fmt))
    if fmt == "f32":
        inter = rng.normal(0, 0.2, 4097).astype(np.float32)
    else:
        inter = rng.integers(-100, 100, 4097).astype(dtype)
    for scale in ((256.0, 100.0) if fmt == "f32" else (256.0,)):
        want = jruntime.deinterleave(inter, fmt, scale)
        got = truntime.deinterleave(inter, fmt, scale)
        for w, g in zip(want, got):
            assert g.dtype == np.int16 and np.array_equal(w, g)
    with pytest.raises(ValueError):
        truntime.deinterleave(inter.astype(np.int16), "u8")


def test_ring_source_feeds_the_sniffer():
    """tests/test_runtime.py's ring -> ring_source -> Sniffer round trip
    with the port's ring and narrowband Sniffer on the CPU: the one packet
    decodes CRC-OK with its payload."""
    if not truntime.available():
        pytest.skip("native runtime not built (no g++)")
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, 15, dtype=np.uint8)
    pdu = B.bytes_to_bits(np.concatenate([[0x40, len(payload)], payload]).astype(np.uint8))
    ci, cq, _ = tgolden.btle_tx(pdu, 37, sps=4, flavor="c")
    inter = np.zeros(2 * (len(ci) + 2000), dtype=np.int16)
    inter[2000::2] = np.concatenate([ci, np.zeros(1000, np.int8)])[: len(inter[2000::2])]
    inter[2001::2] = np.concatenate([cq, np.zeros(1000, np.int8)])[: len(inter[2001::2])]
    ring = truntime.IqRingBuffer(1 << 16)
    ring.write(inter, "i16")
    done = {"v": False}
    src = truntime.ring_source(ring, 4096, 1500, stop=lambda: done["v"])
    done["v"] = True
    sn = tstream.Sniffer(tstream.SnifferConfig(channel=37, sps=4, scan_len=4096),
                         quiet_text=True, device="cpu")
    ok = [e for e in sn.run(src) if e.crc_ok]
    ring.close()
    assert len(ok) == 1
    assert np.array_equal(np.frombuffer(ok[0].payload_bytes, np.uint8),
                          B.bits_to_bytes(pdu)[2:])
