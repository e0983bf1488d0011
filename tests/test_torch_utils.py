"""The port's utilities (btle_tpu_torch.utils and the vector tool
btle_tpu_torch.tools.gen_test_vectors) beside the JAX package's:
tests/test_utils.py case for case, where every vector file the port
writes must be byte-equal to the JAX package's, plus BlockStats under a
fixed clock and a torch.profiler trace on the CPU."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from btle_tpu import utils as J
from btle_tpu.golden import model as JG
from btle_tpu.utils import vectors as JV

from btle_tpu_torch import utils as T
from btle_tpu_torch.golden import model as G
from btle_tpu_torch.spec import bits as B
from btle_tpu_torch.utils import vectors as TV

from test_golden import BER_PDU_HEX

ROOT = pathlib.Path(__file__).resolve().parent.parent


def assert_same_files(jdir: pathlib.Path, tdir: pathlib.Path, manifests=()):
    """Every file of the two directories byte-equal; in the JSON
    ``manifests`` the directory names are swapped first."""
    jnames = sorted(p.name for p in jdir.iterdir())
    assert jnames == sorted(p.name for p in tdir.iterdir()) and jnames
    for name in jnames:
        want, got = (jdir / name).read_bytes(), (tdir / name).read_bytes()
        if name in manifests:
            got = got.replace(str(tdir).encode(), str(jdir).encode())
        assert got == want, name


class TestStageVectors:
    def test_tx_stages_consistent(self):
        pdu = B.hex_to_bits(BER_PDU_HEX)
        v = T.tx_stage_vectors(pdu, 37)
        ref = J.tx_stage_vectors(pdu, 37)
        for field in ("info_bits", "info_crc_bits", "phy_bits", "upsampled", "i", "q"):
            got, want = getattr(v, field), getattr(ref, field)
            assert got.dtype == want.dtype and np.array_equal(got, want), field
        assert len(v.info_crc_bits) == len(v.info_bits) + 24
        np.testing.assert_array_equal(v.phy_bits[:40], v.info_crc_bits[:40])
        gi, gq, _ = G.btle_tx(pdu, 37)
        np.testing.assert_array_equal(v.i, gi)
        np.testing.assert_array_equal(v.q, gq)

    def test_dump_files_readable(self, tmp_path):
        pdu = B.hex_to_bits(BER_PDU_HEX)
        files = T.dump_tx_vectors(pdu, str(tmp_path / "port"))
        J.dump_tx_vectors(pdu, str(tmp_path / "jax"))
        assert_same_files(tmp_path / "jax", tmp_path / "port")
        got = np.loadtxt(files["modulator_output_i_ref"], dtype=np.int64)
        np.testing.assert_array_equal(got, T.tx_stage_vectors(pdu, 37).i)

    def test_vector_tool_end_to_end(self, tmp_path):
        args = ["--sps", "8", "--snr", "30", "--modules"]
        for cmd, out in (([sys.executable, "-m", "btle_tpu_torch.tools.gen_test_vectors"],
                          tmp_path / "port"),
                         ([sys.executable, "tools/gen_test_vectors.py"], tmp_path / "jax")):
            r = subprocess.run([*cmd, "--out", str(out), *args], capture_output=True,
                               text=True, timeout=120, cwd=ROOT)
            assert r.returncode == 0, r.stderr
        assert r.stdout and r.stdout.startswith("wrote ")
        assert_same_files(tmp_path / "jax", tmp_path / "port",
                          ("btle_config.json", "vector_manifest.json"))
        port = tmp_path / "port"
        assert int(np.loadtxt(port / "btle_rx_crc_ok_ref.txt", dtype=np.int64)) == 1
        assert "".join((port / "btle_rx_pdu_octets_ref.txt").read_text().split()) \
            == BER_PDU_HEX
        assert json.loads((port / "btle_config.json").read_text())["snr_db"] == 30.0


class TestFoAlignment:
    def test_c_vs_python_flavor_fo_curves(self):
        pdu = B.hex_to_bits(BER_PDU_HEX)
        i8, q8, _ = G.btle_tx(pdu, 37, sps=8, flavor="python")
        i4, q4, _ = G.btle_tx(pdu, 37, sps=4, flavor="c")
        fo8 = T.instantaneous_freq(i8, q8, 8)
        fo4 = T.instantaneous_freq(i4, q4, 4)
        np.testing.assert_array_equal(fo8, J.instantaneous_freq(i8, q8, 8))
        np.testing.assert_array_equal(fo4, J.instantaneous_freq(i4, q4, 4))
        n_sym = min(len(fo8) // 8, len(fo4) // 4) - 8
        s8 = fo8[8 * 4: 8 * 4 + (n_sym - 8) * 8: 8]
        s4 = fo4[4 * 4: 4 * 4 + (n_sym - 8) * 4: 4]
        best = min(np.mean(np.abs(s8[: len(s4) - 8] - s4[k: k + len(s8[: len(s4) - 8])]))
                   for k in range(8))
        assert best < 0.05, best

    def test_fo_peak_deviation(self):
        bits = np.tile([1, 1, 1, 1, 0, 0, 0, 0], 8).astype(np.int8)
        i, q, _ = G.gfsk_modulate_python(bits, 8)
        fo = T.instantaneous_freq(i, q, 8)
        np.testing.assert_array_equal(fo, J.instantaneous_freq(i, q, 8))
        assert 0.2 < np.max(fo) < 0.3
        assert -0.3 < np.min(fo) < -0.2

    @pytest.mark.parametrize("sps,flavor", [(4, "c"), (8, "python")])
    def test_fixed_vs_float_flavor_fo_curves(self, sps, flavor):
        pdu = B.hex_to_bits(BER_PDU_HEX)
        fi_i, fi_q, phy = G.btle_tx(pdu, 37, sps=sps, flavor=flavor)
        fl_i, fl_q = G.gfsk_modulate_float(phy, sps)
        fo_fix = T.instantaneous_freq(fi_i, fi_q, sps)
        fo_flt = T.instantaneous_freq(fl_i, fl_q, sps)
        np.testing.assert_array_equal(fo_flt, J.instantaneous_freq(fl_i, fl_q, sps))
        n = min(len(fo_fix), len(fo_flt)) - 4 * sps
        best = min(np.mean(np.abs(fo_fix[4 * sps: n - 2 * sps]
                                  - fo_flt[4 * sps + k: n - 2 * sps + k]))
                   for k in range(-2 * sps, 2 * sps + 1))
        assert best < 0.05, (sps, flavor, best)

    @pytest.mark.parametrize("sps", [10, 80])
    def test_fixed_point_flavor_rejects_non_pow2_sps(self, sps):
        from btle_tpu.phy.tables import golden_mod_tables as jtables

        from btle_tpu_torch.phy.tables import golden_mod_tables

        bits = np.zeros(16, np.int8)
        for modulate, tables in ((G.gfsk_modulate_python, golden_mod_tables),
                                 (JG.gfsk_modulate_python, jtables)):
            with pytest.raises(ValueError, match="power-of-two"):
                modulate(bits, sps)
            with pytest.raises(ValueError, match="power-of-two"):
                tables(sps)


class TestModuleVectorHandoff:
    def test_all_module_sets_emitted(self, tmp_path):
        pdu = B.hex_to_bits("422506050403020119095344")
        out = TV.dump_module_vectors(pdu, str(tmp_path / "port"), sps=8)
        JV.dump_module_vectors(pdu, str(tmp_path / "jax"), sps=8)
        assert TV.MODULE_TBS == JV.MODULE_TBS
        assert set(out) == set(TV.MODULE_TBS)
        for mod, files in out.items():
            for role, path in files.items():
                assert (tmp_path / "port" / path.split("/")[-1]).exists(), (mod, role)
        assert_same_files(tmp_path / "jax", tmp_path / "port", ("vector_manifest.json",))

    def test_chain_consistency(self, tmp_path):
        sps = 8
        pdu = B.hex_to_bits("4225060504030201aabbccdd")
        out = TV.dump_module_vectors(pdu, str(tmp_path / "port"), sps=sps)
        JV.dump_module_vectors(pdu, str(tmp_path / "jax"), sps=sps)
        assert_same_files(tmp_path / "jax", tmp_path / "port", ("vector_manifest.json",))

        def load(mod, role):
            return np.loadtxt(out[mod][role], dtype=np.int64, ndmin=1)

        up_in = load("bit_repeat_upsample", "input_bits")
        up_out = load("bit_repeat_upsample", "output_ref")
        assert len(up_out) == sps * len(up_in)
        assert set(np.unique(up_out)) <= {-1, 1}
        np.testing.assert_array_equal(load("gauss_filter", "input_nrz"), up_out)
        np.testing.assert_array_equal(load("vco", "input_freq_words"),
                                      load("gauss_filter", "output_ref"))
        cos = load("vco", "output_cos_ref")
        assert cos.min() >= -128 and cos.max() <= 127
        np.testing.assert_array_equal(load("gfsk_modulation", "output_i_ref"),
                                      load("btle_tx", "output_i_ref"))
        assert len(load("crc24", "output_ref")) == len(load("crc24", "input_bits")) + 24
        bits = load("search_unique_bit_sequence", "input_bits")
        pattern = load("search_unique_bit_sequence", "input_pattern")
        k = int(load("search_unique_bit_sequence", "output_position_ref")[0])
        np.testing.assert_array_equal(bits[k:k + 32], pattern)
        assert load("btle_rx_core", "output_crc_ok_ref")[0] == 1
        np.testing.assert_array_equal(load("btle_rx_core", "output_pdu_octets_ref"),
                                      load("btle_controller", "output_pdu_octets_ref"))


class TestProfiling:
    def test_block_stats_summary_under_a_fixed_clock(self, monkeypatch):
        """Both packages' BlockStats over the same clock readings: the same
        throughput, real-time factor and summary line."""
        from btle_tpu.utils import profiling as jprof

        from btle_tpu_torch.utils import profiling as tprof

        outs = []
        for mod in (jprof, tprof):
            ticks = iter([0.0, 0.25, 1.0, 1.5])
            monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
            st = mod.BlockStats(samples_per_block=131072, sample_rate_hz=4e6)
            for _ in range(2):
                st.begin()
                st.end()
            outs.append((st.blocks, st.busy_s, st.throughput_sps, st.realtime_factor,
                         st.summary()))
        assert outs[1] == outs[0]
        assert outs[1][4] == "2 blocks, 0.3 Msps (0.1x real time)"
        assert mod.BlockStats(1, 0.0).realtime_factor == 0.0

    def test_device_trace_writes_a_chrome_trace(self, tmp_path):
        """device_trace on the CPU (no card: CPU activity only) writes a
        Chrome trace into the directory, naming the ops it ran."""
        import torch

        with T.device_trace(str(tmp_path)) as prof:
            torch.ones(64, 64) @ torch.ones(64, 64)
        files = list(tmp_path.glob("trace-*.json"))
        assert len(files) == 1 and str(files[0]) == prof.trace_path
        names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
        assert any("mm" in str(n) for n in names)
