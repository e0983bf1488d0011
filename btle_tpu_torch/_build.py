"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<source>.cu`` exports plain C functions ``btle_<name>``,
one per kernel (usually one, named as the source; a source templated
over several kernels exports one per instance), each launching its
kernel on the given stream and returning ``cudaGetLastError()``. On first use the source is compiled with nvcc
(``-gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC``) into ``build/btle_tpu_torch/`` at the repository root, keyed
by a hash of the source, the flags and ``nvcc --version``, and loaded
with ctypes. Several kernels build in
parallel: one nvcc per source, all started together (``build``).

Kernels allocate nothing: the Python wrapper allocates outputs with
``torch.empty`` and passes device pointers, sizes and
``torch.cuda.current_stream()``. A wrapper launches through a
``CudaKernel``, which counts its launches (``launches``), so a run can
show which kernels the main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "btle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# ctypes argument kinds of each C entry point, in order: "p" a device
# pointer or the stream (c_void_p), "i" a 32-bit int, "l" a 64-bit int
_SIGNATURES = {
    # frames, B table (hi/lo or bf16), y, J, Ky, K_pad, warps_m, stream
    "filterbank_bf16x2w": "pppliiip",
    "filterbank_im2col_f32x2": "pppliiip",
    "filterbank_im2col_bf16": "pppliiip",
    # frames, (40, S, 80) weights, y, J, Ky, S, width, warps, stream
    "filterbank_im2col_f32": "pppliiiip",
    # f4, kcoefx, w4x, y, J, Ky, rows, n_slices, stack, warps, stream
    "filterbank_polyx_f32": "ppppliiiiip",
    # y, aa_rows, aa_mask, bits, hit, mag, Ky, n_bits, n_hit, sps, lag, stream
    "demod_tail": "ppppppllliip",
    # bits, pos, whiten, crc_inits, adv, bytes, plen, match, len_ok,
    # M, Kb, C, sps, clamp_tail, stream
    "decode_candidates": "pppppppppiliiip",
    # stream (an empty kernel: the launch floor beside K4)
    "launch_floor": "p",
    # i, q, aa_rows, aa_mask, bits, hit, rows, N, sps, lag, is_float, stream
    "scan_block": "ppppppiliiip",
    # s, w, acc, hit, rows, ld_s, n_out, sps, grp, is_int8, n_mask, stream
    "aa_corr": "ppppilliiiip",
    # s, x, rows, nbp, grp, sps, k0, stream
    "shift_stack": "ppiliilp",
    # f, kc, out, rows, ld_f, n_cols, n, step, stream
    "shift_fma": "pppilliip",
    # la, lb, pred, signs, bits, pm_end, n_trellis, n_steps, stream
    "viterbi_r2": "ppppppiip",
}
# the kernels whose source also exports btle_<name>_plan(..., int info[5]):
# the launch shape a call would take, read back as PLAN_KEYS (the last is
# columns per CTA, or candidates per CTA for decode_candidates, positions
# per CTA for scan_block and trellises per CTA for viterbi_r2)
_PLAN_SIGNATURES = {
    # rows, n, step, n_cols, 16-byte copies
    "shift_fma": "iiili",
    # Ky, width, warps
    "filterbank_im2col_f32": "iii",
    # Ky, n_slices, stack, warps
    "filterbank_polyx_f32": "iiii",
    # M, C
    "decode_candidates": "ii",
    # rows, n_out, sps, grp, is_int8
    "aa_corr": "iliii",
    # rows, N, sps, lag, is_float
    "scan_block": "iliii",
    # rows, nbp, grp
    "shift_stack": "ili",
    # n_trellis, n_steps
    "viterbi_r2": "ii",
}
PLAN_KEYS = ("smem_bytes", "ctas_per_sm", "ctas", "threads", "tile_columns")
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong}
# the source of each entry point not named as its source
_SOURCES = {"filterbank_bf16x2w": "filterbank_hilo_mma",
            "filterbank_im2col_f32x2": "filterbank_hilo_mma",
            "filterbank_im2col_bf16": "filterbank_hilo_mma",
            "filterbank_im2col_f32": "filterbank_sgemm_f32",
            "shift_stack": "aa_corr",
            "launch_floor": "decode_candidates",
            "viterbi_r2": "viterbi"}


def source_of(name: str) -> str:
    """The csrc source (without .cu) that defines entry point ``name``."""
    return _SOURCES.get(name, name)


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or nvcc on PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def source_path(name: str) -> Path:
    return CSRC / f"{name}.cu"


@lru_cache(maxsize=None)
def nvcc_version() -> str:
    return subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout


def library_path(name: str) -> Path:
    """The built library, keyed by the source, the flags and the compiler
    version, so a change to any of them rebuilds."""
    h = hashlib.sha1(source_path(name).read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    h.update(nvcc_version().encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=None, force: bool = False) -> dict[str, str]:
    """Compile the sources of the named kernels (default: all) whose
    library is missing (with ``force``, every one), one nvcc per source,
    all started together. Returns {source: compiler output} for the
    sources compiled now (ptxas register/shared-memory reports); raises
    naming every source that failed."""
    names = sorted({source_of(n) for n in
                    (_SIGNATURES if names is None else names)})
    todo = [n for n in names if force or not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(source_path(n))]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


class CudaKernel:
    """One hand-written kernel: its C entry point, loaded on first launch,
    and the count of its launches."""

    def __init__(self, name: str, replaces: str):
        self.name = name
        self.source_name = source_of(name)
        self.replaces = replaces          # the TPU kernel it ports (file:line)
        self.launches = 0
        self._fn = None

    @property
    def source(self) -> str:
        return str(source_path(self.source_name).relative_to(_PKG.parent))

    def _load(self):
        if self._fn is None:
            build([self.source_name])
            lib = ctypes.CDLL(str(library_path(self.source_name)))
            fn = getattr(lib, f"btle_{self.name}")
            fn.argtypes = [_CTYPES[c] for c in _SIGNATURES[self.name]]
            fn.restype = ctypes.c_int
            self._fn = (lib, fn)
        return self._fn[1]

    def plan(self, *args) -> dict:
        """The launch shape of a call with ``args`` (the kernel's C
        ``btle_<name>_plan``, on the current device): {PLAN_KEYS: int}.
        Only the kernels of _PLAN_SIGNATURES have one."""
        self._load()
        fn = getattr(self._fn[0], f"btle_{self.name}_plan")
        fn.argtypes = [_CTYPES[c] for c in _PLAN_SIGNATURES[self.name]] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        info = (ctypes.c_int * len(PLAN_KEYS))()
        err = fn(*args, info)
        if err != 0:
            raise RuntimeError(f"{self.name}_plan failed: cudaError {err}")
        return dict(zip(PLAN_KEYS, info))

    def launch(self, *args):
        """Launch on the current CUDA stream. Tensors pass as their device
        pointers; the stream is appended. Raises on a refused launch."""
        import torch

        fn = self._load()
        conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        conv.append(torch.cuda.current_stream().cuda_stream)
        err = fn(*conv)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {err}")
        self.launches += 1
