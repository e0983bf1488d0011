"""The port's TX path against btle_tpu on the CPU, all exact: the torch
modulators (both fixed-point flavors), synthesize in every flavor, the
plan and scene composers, the descriptor parser on every example and
test descriptor, the tx CLI's files byte for byte, UDP playback into
the port's native ring, and the self-test scene built through it."""

import ast
import dataclasses
import pathlib
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from btle_tpu.cli import app as japp
from btle_tpu.phy import modulator as jmod
from btle_tpu.tx import descriptor as jdesc
from btle_tpu.tx import synth as jsynth

from btle_tpu_torch import runtime
from btle_tpu_torch.cli import app as tapp
from btle_tpu_torch.phy import modulator as tmod
from btle_tpu_torch.tx import descriptor as tdesc
from btle_tpu_torch.tx import synth as tsynth

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKET_FILES = sorted((ROOT / "examples" / "packets").glob("*.txt"))
# short Space gaps keep the 80 Msps files small
PLAN = ["37-ADV_IND-TxAdd-1-RxAdd-0-AdvA-010203040506-AdvData-00112233-Space-1",
        "9-LL_DATA-AA-60850A1B-LLID-1-NESN-0-SN-0-MD-0-DATA-AABBCC-CRCInit-A77B22-Space-2",
        "38-IBEACON-AdvA-0A1B2C3D4E5F-UUID-00112233445566778899AABBCCDDEEFF"
        "-Major-0001-Minor-0002-TxPower-C5-Space-1"]


def _test_tx_examples() -> dict:
    """tests/test_tx.py's EXAMPLES (one descriptor per packet type), read
    from its source (it imports modules that read absent files)."""
    tree = ast.parse((ROOT / "tests" / "test_tx.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "EXAMPLES":
            return ast.literal_eval(node.value)
    raise AssertionError("EXAMPLES not found")


EXAMPLES = _test_tx_examples()


def _file_descriptors():
    out = []
    for path in PACKET_FILES:
        for line in path.read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#") and not line.startswith("r"):
                out.append(line)
    return out


def _specs_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None and np.array_equal(x, y), f.name
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
        else:
            assert x == y, f.name
    assert np.array_equal(a.phy_bits(), b.phy_bits())


# --------------------------------------------------------------------------
# modulators
# --------------------------------------------------------------------------


@pytest.mark.parametrize("flavor,sps", [("python", 8), ("python", 4), ("c", 4)])
@pytest.mark.parametrize("n_bits", [1, 37, 2000])
def test_modulators_equal_jax(flavor, sps, n_bits):
    rng = np.random.default_rng(n_bits + sps)
    bits = rng.integers(0, 2, (3, n_bits)).astype(np.int8)
    want = jmod.modulate_batch(jnp.asarray(bits), flavor, sps)
    got = tmod.modulate_batch(torch.as_tensor(bits), flavor, sps)
    fn = tmod.modulate_python if flavor == "python" else tmod.modulate_c
    one = fn(torch.as_tensor(bits[1]), sps)
    for w, g, o in zip(want, got, one):
        assert g.dtype == torch.int8 and g.shape[-1] == tmod.num_samples(n_bits, flavor, sps)
        assert np.array_equal(np.asarray(w), g.numpy())
        assert np.array_equal(np.asarray(w)[1], o.numpy())


def test_modulators_equal_golden_on_a_long_packet():
    """A 2000-bit packet walks the phase accumulator far past its table:
    the int64 cumsum masked to the table keeps the low bits the JAX
    int32 cumsum and the golden model's int16 accumulator keep."""
    from btle_tpu.golden import model as G

    bits = np.random.default_rng(2000).integers(0, 2, 2000).astype(np.int8)
    gi, gq = G.gfsk_modulate_c(bits, 4)
    ti, tq = tmod.modulate_c(torch.as_tensor(bits), 4)
    assert np.array_equal(gi, ti.numpy()) and np.array_equal(gq, tq.numpy())
    gi, gq, _ = G.gfsk_modulate_python(bits, 8)
    ti, tq = tmod.modulate_python(torch.as_tensor(bits), 8)
    assert np.array_equal(gi, ti.numpy()) and np.array_equal(gq, tq.numpy())


def test_masked_int64_cumsum_equals_wrapping_int32():
    """The low bits of torch's int64 cumsum equal those of a cumsum that
    wraps at 32 bits (jnp.cumsum of int32), past the wrap."""
    x = np.full(64, 2**30 - 3, np.int32)
    wrapped = np.cumsum(x, dtype=np.int32)                 # wraps
    got = torch.cumsum(torch.as_tensor(x), 0)
    assert got.dtype == torch.int64 and int(got[-1]) > 2**31
    assert np.array_equal((got & 2047).numpy(), wrapped & 2047)


def test_modulate_batch_rejects_unknown_flavor():
    with pytest.raises(ValueError):
        tmod.modulate_batch(torch.zeros((1, 8), dtype=torch.int8), "float")


# --------------------------------------------------------------------------
# descriptors
# --------------------------------------------------------------------------


@pytest.mark.parametrize("desc", _file_descriptors() + sorted(EXAMPLES.values()))
def test_parse_descriptor_equal(desc):
    want, got = jdesc.parse_descriptor(desc), tdesc.parse_descriptor(desc)
    _specs_equal(want, got)
    if want.raw_phy_bits is None:
        _specs_equal(want.to_2m(), got.to_2m())
    else:
        # a RAW packet's bits are final on-air bits: neither reframes it
        for spec in (want, got):
            with pytest.raises(ValueError, match="cannot reframe"):
                spec.to_2m()


@pytest.mark.parametrize("path", PACKET_FILES, ids=lambda p: p.name)
def test_read_packet_file_equal(path):
    want, wrep = jdesc.read_packet_file(str(path))
    got, grep = tdesc.read_packet_file(str(path))
    assert wrep == grep and len(want) == len(got)
    for a, b in zip(want, got):
        _specs_equal(a, b)


@pytest.mark.parametrize("desc", ["37-NOSUCHTYPE-a-b", "37-ADV_IND-TxAdd-1",
                                  "37-ADV_IND-TxAdd-1-RxAdd-0-AdvA-010203",
                                  "37-RAW-ABC"])
def test_descriptor_errors_equal(desc):
    with pytest.raises(jdesc.DescriptorError) as want:
        jdesc.parse_descriptor(desc)
    with pytest.raises(tdesc.DescriptorError) as got:
        tdesc.parse_descriptor(desc)
    assert str(want.value) == str(got.value)


def test_parse_sequence_repeat_equal():
    for items in ([EXAMPLES["ADV_IND"], "r30"], [EXAMPLES["ADV_IND"], "r-1"], PLAN):
        (ws, wr), (gs, gr) = (jdesc.parse_descriptor_sequence(items),
                              tdesc.parse_descriptor_sequence(items))
        assert wr == gr and len(ws) == len(gs)


# --------------------------------------------------------------------------
# synthesis and composition
# --------------------------------------------------------------------------


@pytest.mark.parametrize("flavor,sps", [("c", 4), ("python", 8), ("float", 4),
                                        ("float", 80)])
def test_synthesize_equal(flavor, sps):
    specs = [jdesc.parse_descriptor(d) for d in sorted(EXAMPLES.values())]
    tspecs = [tdesc.parse_descriptor(d) for d in sorted(EXAMPLES.values())]
    want = jsynth.synthesize(specs, flavor=flavor, sps=sps)
    got = tsynth.synthesize(tspecs, flavor=flavor, sps=sps, device="cpu")
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.i.dtype == w.i.dtype and g.space_ms == w.space_ms
        assert np.array_equal(w.i, g.i) and np.array_equal(w.q, g.q)
    assert tsynth.synthesize([], device="cpu") == []


def test_synthesize_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsynth.synthesize([tdesc.parse_descriptor(PLAN[0])])


@pytest.mark.parametrize("phy", ["1m", "2m"])
def test_plan_to_stream_equal(phy):
    specs, _ = jdesc.parse_descriptor_sequence(PLAN)
    tspecs, _ = tdesc.parse_descriptor_sequence(PLAN)
    if phy == "2m":
        specs, tspecs = [s.to_2m() for s in specs], [s.to_2m() for s in tspecs]
    rate = 2 if phy == "2m" else 1
    want = jsynth.plan_to_stream(jsynth.synthesize(specs), 4, 2, rate)
    got = tsynth.plan_to_stream(tsynth.synthesize(tspecs, device="cpu"), 4, 2, rate)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(w, g)
    with pytest.raises(ValueError):
        tsynth.plan_to_stream(tsynth.synthesize(tspecs, device="cpu"), 4, 1, 3 - rate)


@pytest.mark.parametrize("noise", [0.0, 2.0])
def test_plan_to_wideband_equal(noise):
    specs, _ = jdesc.parse_descriptor_sequence(PLAN)
    tspecs, _ = tdesc.parse_descriptor_sequence(PLAN)
    want = jsynth.plan_to_wideband(specs, noise_std=noise, amplitude=0.5, seed=3)
    got = tsynth.plan_to_wideband(tspecs, noise_std=noise, amplitude=0.5, seed=3)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(w, g)


def test_scene_to_wideband_and_burst_samples_equal():
    specs, _ = jdesc.parse_descriptor_sequence(PLAN)
    tspecs, _ = tdesc.parse_descriptor_sequence(PLAN)
    specs.append(specs[0].to_2m())
    tspecs.append(tspecs[0].to_2m())
    offs = [5000, 5000, 90_000, 140_000]
    want = jsynth.scene_to_wideband(list(zip(specs, offs)), 200_000, noise_std=1.0, seed=9)
    got = tsynth.scene_to_wideband(list(zip(tspecs, offs)), 200_000, noise_std=1.0, seed=9)
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    for s, t in zip(specs, tspecs):
        assert jsynth.burst_num_samples(s) == tsynth.burst_num_samples(t)


# --------------------------------------------------------------------------
# the tx CLI
# --------------------------------------------------------------------------


def _run_both(tmp_path, args, files):
    """The JAX CLI and the port's CLI (on the CPU) with the same
    arguments; every named output file must be byte-equal."""
    outs = {}
    for name, main, extra in (("jax", japp.main, []),
                              ("port", tapp.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        argv = [a.format(d=d) for a in args]
        assert main(["tx", *argv, *extra]) == 0
        outs[name] = d
    for f in files:
        a, b = (outs[n] / f for n in ("jax", "port"))
        if a.is_dir():
            for x in sorted(a.iterdir()):
                assert x.read_bytes() == (b / x.name).read_bytes(), x.name
        else:
            assert a.read_bytes() == b.read_bytes() and a.stat().st_size > 0, f


@pytest.mark.parametrize("fmt", ["f32", "i8"])
def test_cli_out_equal(tmp_path, fmt):
    _run_both(tmp_path, ["--file", str(ROOT / "examples/packets/discovery.txt"),
                         "--out", "{d}/out.bin", "--out-format", fmt,
                         "--dump-dir", "{d}/dump"], ["out.bin", "dump"])


@pytest.mark.parametrize("phy", ["1m", "2m"])
def test_cli_wideband_out_equal(tmp_path, phy):
    _run_both(tmp_path, [*PLAN, "--phy", phy, "--repeat", "2", "--out", "{d}/nb.f32",
                         "--wideband-out", "{d}/wb.f32", "--wideband-noise", "2"],
              ["nb.f32", "wb.f32"])


def test_cli_refuses_coded_phy(tmp_path):
    """--phy coded8 re-frames each packet's PDU for LE Coded; a RAW packet
    has no PDU to re-frame, and both packages refuse it alike."""
    from btle_tpu.cli import app as japp

    raw = "39-RAW-AAD6BE898E5F134B5D86F2999CC3D7DF5EDF15DE-SPACE-1"
    for main, dev in ((tapp.main, ["--device", "cpu"]), (japp.main, [])):
        with pytest.raises(SystemExit, match="RAW packets cannot be re-framed"):
            main(["tx", raw, "--phy", "coded8", "--out", str(tmp_path / "x.bin"),
                  *dev])


def test_cli_udp_into_the_native_ring():
    """tx --udp plays the plan as bursts (warm-up zeros, the packet, its
    Space gap) into the port's UdpIngest: the ring holds exactly the
    JAX package's samples in that layout."""
    from btle_tpu_torch.tx.playback import NUM_PRE_SEND_ZEROS

    if not runtime.available():
        pytest.skip("the native runtime did not build (no g++)")
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ring = runtime.IqRingBuffer(1 << 20)
    ingest = runtime.UdpIngest(ring, port, fmt="i16")
    try:
        assert tapp.main(["tx", *PLAN, "--udp", f"127.0.0.1:{port}",
                          "--device", "cpu"]) == 0
        want_i, want_q = [], []
        for p in jsynth.synthesize(jdesc.parse_descriptor_sequence(PLAN)[0]):
            gap = np.zeros(int(p.space_ms * 1000 * 4), np.int16)
            zeros = np.zeros(NUM_PRE_SEND_ZEROS, np.int16)
            want_i += [zeros, p.i.astype(np.int16), gap]
            want_q += [zeros, p.q.astype(np.int16), gap]
        want_i, want_q = np.concatenate(want_i), np.concatenate(want_q)
        deadline = time.monotonic() + 10
        while ring.available_pairs < len(want_i) and time.monotonic() < deadline:
            time.sleep(0.01)
        got_i, got_q = ring.drain(len(want_i) + 1024)
    finally:
        ingest.stop()
        ring.close()
    assert np.array_equal(got_i, want_i) and np.array_equal(got_q, want_q)
