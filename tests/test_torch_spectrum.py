"""The port's waterfall / IQ inspection (utils/spectrum.py, a copy of
btle_tpu.utils.spectrum, and the ``iq-show`` subcommand) against
btle_tpu on the CPU, mirroring tests/test_spectrum.py: the tone rows, the
reference's per-column loop semantics, the axis extent, the occupancy
summary and the CLI on synthetic captures. Arrays are compared exactly
(the same numpy code on the same inputs), CLI outputs byte for byte."""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from btle_tpu.cli import app as japp
from btle_tpu.utils import spectrum as J

from btle_tpu_torch.cli import app as tapp
from btle_tpu_torch.utils import spectrum as T
from btle_tpu_torch.utils.spectrum import occupancy, waterfall, waterfall_extent

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tone(f_hz, fs_hz, n, amp=100.0):
    t = np.arange(n) / fs_hz
    z = amp * np.exp(1j * 2 * np.pi * f_hz * t)
    return z.real, z.imag


class TestWaterfall:
    def test_tone_lands_in_expected_row(self):
        fs, fft = 8e6, 256
        i, q = tone(1e6, fs, 4096)
        p = waterfall(i, q, fft_size=fft)
        assert p.shape == (fft, 4096 // fft)
        assert np.all(p.argmax(axis=0) == fft // 2 + 32)
        assert np.array_equal(p, J.waterfall(i, q, fft_size=fft))

    def test_negative_freq_below_center(self):
        i, q = tone(-2e6, 8e6, 2048)
        p = waterfall(i, q, fft_size=128)
        assert np.all(p.argmax(axis=0) == 128 // 2 - 128 // 4)

    def test_matches_reference_loop_semantics(self):
        rng = np.random.default_rng(7)
        i, q = rng.normal(size=600), rng.normal(size=600)
        fft_size, win, hop = 64, 100, 37
        p = waterfall(i, q, fft_size=fft_size, win_len=win, hop=hop)
        z = i + 1j * q
        num_col = (600 - win) // hop + 1
        assert p.shape == (fft_size, num_col)
        for c in range(num_col):
            ref = np.abs(np.fft.fft(z[c * hop: c * hop + win], fft_size)) ** 2
            np.testing.assert_allclose(p[:, c], np.fft.fftshift(ref), rtol=1e-10)
        assert np.array_equal(p, J.waterfall(i, q, fft_size=fft_size, win_len=win, hop=hop))

    def test_extent_matches_reference_axis_math(self):
        t0, t1, f_lo, f_hi = waterfall_extent(8192, 4e6, 256, 256)
        assert t0 == 0.0
        assert t1 == pytest.approx((8192 // 256) * 256 / 4e6 * 1e6)
        assert (f_lo, f_hi) == (-2e6, 2e6)
        assert (t0, t1, f_lo, f_hi) == J.waterfall_extent(8192, 4e6, 256, 256)

    def test_too_short_capture_raises(self):
        with pytest.raises(ValueError):
            waterfall(np.zeros(10), np.zeros(10), fft_size=64)
        with pytest.raises(ValueError):
            waterfall(np.zeros(100), np.zeros(100), hop=0)

    def test_occupancy_finds_the_tone(self):
        fs = 8e6
        rng = np.random.default_rng(3)
        i, q = tone(1e6, fs, 8192, amp=50.0)
        i = i + rng.normal(size=8192)
        q = q + rng.normal(size=8192)
        p = waterfall(i, q, fft_size=256)
        occ = occupancy(p, fs)
        assert occ and abs(occ[0]["freq_offset_hz"] - 1e6) < fs / 256
        assert occ[0]["duty"] > 0.9
        assert occ == J.occupancy(p, fs)


@pytest.mark.parametrize("seed", range(3))
def test_random_captures_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3000, 9000))
    i, q = rng.normal(0, 3, n), rng.normal(0, 3, n)
    for f in rng.uniform(-3e6, 3e6, 3):
        ti, tq = tone(f, 8e6, n, amp=float(rng.uniform(5, 50)))
        i, q = i + ti, q + tq
    for fft, win, hop in ((64, None, None), (256, 300, 100), (128, 64, 17)):
        p = T.waterfall(i, q, fft_size=fft, win_len=win, hop=hop)
        assert np.array_equal(p, J.waterfall(i, q, fft_size=fft, win_len=win, hop=hop))
        for thr in (3.0, 12.0):
            assert T.occupancy(p, 8e6, thr) == J.occupancy(p, 8e6, thr)


def _capture(tmp_path, fmt, amp=80.0, n=65536, f=0.5e6):
    i, q = tone(f, 8e6, n, amp=amp)
    iq = np.empty(2 * n, np.float32)
    iq[0::2], iq[1::2] = i, q
    path = tmp_path / f"cap.{fmt}"
    if fmt == "f32":
        (iq / 256.0).astype(np.float32).tofile(path)
    elif fmt == "i8":
        np.clip(np.round(iq), -128, 127).astype(np.int8).tofile(path)
    else:
        iq.astype(np.int16).tofile(path)
    return path


def _both(argv):
    outs = []
    for main in (japp.main, tapp.main):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            assert main(list(argv)) == 0
        outs.append((out.getvalue(), err.getvalue()))
    return outs


class TestCliIqShow:
    def test_iq_show_summary_and_png(self, tmp_path):
        path = _capture(tmp_path, "i16")
        (jout, jerr), (tout, terr) = _both(["iq-show", str(path), "--format", "i16",
                                            "--rate", "8e6"])
        assert tout == jout
        assert "IQ pairs @ 8 Msps" in tout and "+500.0 kHz" in tout
        out_png = tmp_path / "wf.png"
        r = subprocess.run(
            [sys.executable, "-m", "btle_tpu_torch", "iq-show", str(path), "--format", "i16",
             "--rate", "8e6", "--out", str(out_png)],
            capture_output=True, text=True, cwd=REPO, timeout=300,
            env={**os.environ, "PYTHONPATH": REPO})
        assert r.returncode == 0, r.stderr
        assert r.stdout == tout
        try:
            import matplotlib  # noqa: F401

            assert out_png.exists() and out_png.stat().st_size > 1000
        except ImportError:
            assert "skipped" in r.stderr

    @pytest.mark.parametrize("fmt,extra", [
        ("f32", ["--center", "2.402e9", "--max-samples", "32768"]),
        ("i8", ["--fft", "128", "--win", "200", "--hop", "50", "--threshold-db", "6"]),
        ("i16", ["--rate", "4e6", "--max-samples", "10000"]),
    ])
    def test_iq_show_equals_jax(self, tmp_path, fmt, extra):
        path = _capture(tmp_path, fmt)
        (jout, _), (tout, _) = _both(["iq-show", str(path), "--format", fmt, *extra])
        assert tout == jout
        if fmt == "f32":
            assert "2402.5 MHz" in tout

    def test_quiet_capture_and_many_bins(self, tmp_path):
        rng = np.random.default_rng(1)
        noise = rng.normal(0, 1, 2 * 20000).astype(np.int16)
        path = tmp_path / "noise.i16"
        noise.tofile(path)
        (jout, _), (tout, _) = _both(["iq-show", str(path)])
        assert tout == jout and "no bins above" in tout
        n = 40000
        i, q = np.zeros(n), np.zeros(n)
        for f in np.linspace(-3.5e6, 3.5e6, 20):
            ti, tq = tone(f, 8e6, n, amp=60.0)
            i, q = i + ti, q + tq
        iq = np.empty(2 * n, np.int16)
        iq[0::2], iq[1::2] = np.round(i), np.round(q)
        path = tmp_path / "comb.i16"
        iq.tofile(path)
        (jout, _), (tout, _) = _both(["iq-show", str(path)])
        assert tout == jout and "more occupied bins" in tout
