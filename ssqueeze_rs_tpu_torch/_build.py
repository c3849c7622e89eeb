"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

`nvcc` compiles every source in ``csrc/`` (one process per source, all
started together) and links them into one shared library with a plain C
interface for sm_90a (Hopper), which is loaded with ctypes. The
library lands in ``_build/`` under a name that carries the hash of the
sources and flags, so an edited source rebuilds at its next use and an
unchanged one is loaded as it is. Nothing is built or imported until a
kernel is first launched on a CUDA tensor: importing the package needs
neither nvcc nor a GPU.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-lineinfo"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_D = ctypes.c_double
_PLAN = [_F] * 5        # the binning plan p0..p4 (reassign_cuda._plan_floats)
_PLAN64 = [_D] * 5      # the same in double (the `_f64` entry points)
_SIGNATURES = {
    "ssq_cwt_phase": [_P, _P, _P, _P, _F, _P, _P, _P, _P, _LL, _I, _I, _I,
                      _I, _I, _F, _P, _LL, _P, _P, _P, _P],
    "ssq_cwt_planes": [_P] * 4 + [_F] + [_P] * 4 + [_LL] + [_I] * 6 +
                      [_P, _LL] + [_P] * 5,
    "ssq_ifft_halfband": [_P] * 4 + [_LL] + [_I] * 4 + [_P, _LL] + [_P] * 3,
    # B, B' and I: the launch-shape int, then the bin range (k0, rows)
    "ssq_reassign": [_P] * 4 + [_I, _I, _LL, _I, _I, _I] + _PLAN +
                    [_I, _I, _I, _P, _P, _P],
    "ssq_reassign4": [_P] * 6 + [_I, _I, _LL, _I, _I, _I, _I, _F] + _PLAN +
                     [_I, _I, _I, _P, _P, _P],
    "ssq_reassign_mxu": [_P] * 6 + [_I, _I, _LL, _I, _I, _I, _I, _F] +
                        _PLAN + [_I, _I, _I, _P, _P, _P],
    "ssq_stft_dft": [_P] * 4 + [_I, _LL, _I, _I, _I, _I, _LL, _F, _I, _P,
                                 _P],
    "ssq_stft_fused": [_P] * 4 + [_I, _LL, _I, _I, _I, _LL, _F, _P, _P, _F,
                                   _I, _I] + _PLAN + [_I, _I] + [_P] * 5,
    "ssq_istft_ola": [_P] * 5 + [_I, _LL, _LL, _I, _I, _I, _I, _P, _P, _P],
    "ssq_reassign_bwd": [_P, _P, _I, _I, _LL, _I, _I, _I] + _PLAN + [_P] * 5,
    "ssq_reassign4_bwd": [_P] * 6 + [_I, _I, _LL, _I, _I, _I, _I, _F] +
                         _PLAN + [_P] * 5,
    # B, B', C and C' on float64 planes
    # (B, B' in double: columns, row groups and stages of _f64_plan, then
    # the bin range)
    "ssq_reassign_f64": [_P] * 4 + [_I, _I, _LL, _I, _I, _I] + _PLAN64 +
                        [_I] * 5 + [_P, _P, _P],
    "ssq_reassign4_f64": [_P] * 6 + [_I, _I, _LL, _I, _I, _I, _I, _D] +
                         _PLAN64 + [_I] * 5 + [_P, _P, _P],
    "ssq_reassign_bwd_f64": [_P, _P, _I, _I, _LL, _I, _I, _I] + _PLAN64 +
                            [_P] * 5,
    "ssq_reassign4_bwd_f64": [_P] * 6 + [_I, _I, _LL, _I, _I, _I, _I, _D] +
                             _PLAN64 + [_P] * 5,
    # the probes (ssqueeze_rs_tpu_torch/tools)
    "ssq_ablate_cwt": [_P] * 4 + [_F] + [_P] * 4 + [_LL] + [_I] * 6 +
                      [_P, _LL] + [_P] * 5,
    "ssq_cwt_copy_floor": [_P, _LL, _I, _LL, _I, _I, _I] + [_P] * 5,
    "ssq_cwt_staged": [_P] * 4 + [_F] + [_P] * 4 + [_LL] + [_I] * 5 +
                      [_P, _LL] + [_P] * 5,
    "ssq_cwt_staged_plan": [_P],
    "ssq_ablate_reassign": [_P] * 6 + [_I, _I, _LL, _I, _I, _I, _I, _F] +
                           _PLAN + [_I, _I, _I, _P, _P, _P],
    "ssq_ablate_reassign3": [_P] * 4 + [_I, _I, _LL, _I, _I, _I] + _PLAN +
                            [_I, _I, _P, _P, _P],
    "ssq_grid_slope": [_P, _P, _LL, _I, _I, _P],
    # A, B, the operand scratch, out; m, k, n, R, grid, precision, chains
    "ssq_rate_dot": [_P] * 4 + [_I] * 7 + [_P],
    "ssq_rate_prep": [_P] * 3 + [_I] * 5 + [_P],
    "ssq_rate_copy": [_P, _P] + [_I] * 4 + [_P],
    "ssq_dma_overlap": [_P] * 4 + [_I, _I, _I, _LL, _I, _P],
    # ... variant, cluster, stream; M, cluster, the plan's six ints
    "ssq_dma_overlap_cluster": [_P] * 4 + [_I, _I, _I, _LL, _I, _I, _P],
    "ssq_dma_overlap_plan": [_I, _I, _P],
    "ssq_mxu_dots": [_P, _P, _P] + [_I] * 6 + [_P],
    # batch, M, K, N, steps, accumulate, the plan's eight ints
    "ssq_mxu_dots_plan": [_I] * 6 + [_P],
    "ssq_mxu_elem": [_I, _P, _P, _P] + [_I] * 5 + [_LL, _P],
}

_LIB = None
BUILD_LOG = {}    # the last compile in this process: seconds, path


def _sources():
    """Every source the build reads: the .cu files and the headers they
    include, so the library name follows each of them."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) +
                  glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME
        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME); "
                       "the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libssq_kernels_{h.hexdigest()[:16]}.so")


def report_path(path: str) -> str:
    """The nvcc/ptxas report (registers, shared memory per kernel) kept
    beside the library at `path`."""
    return path[:-len(".so")] + ".txt"


def build() -> str:
    """Compile ``csrc/*.cu`` unless the library for their hash exists: one
    nvcc per source, all at once, then one link. nvcc's output, with
    ptxas's per-kernel report, is kept beside the library (`report_path`).
    Returns the library path."""
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = [s for s in _sources() if s.endswith(".cu")]
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    t0 = time.perf_counter()
    try:
        jobs = []
        for src in srcs:
            obj = os.path.join(work, os.path.basename(src)[:-3] + ".o")
            cmd = [nvcc] + NVCC_FLAGS + ["-Xptxas", "-v", "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        report, failed = [], []
        for cmd, _, proc in jobs:
            out, _ = proc.communicate()
            report.append(f"$ {' '.join(cmd)}\n{out}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = os.path.join(work, "lib.so")
        cmd = [nvcc] + ARCH + ["-shared", "-o", tmp] + [o for _, o, _ in jobs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        with open(report_path(path), "w") as f:
            f.write("\n".join(report))
        os.replace(tmp, path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    BUILD_LOG.update(seconds=time.perf_counter() - t0, path=path)
    return path


def lib():
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.ssq_error_string.argtypes = [ctypes.c_int]
        handle.ssq_error_string.restype = ctypes.c_char_p
        _LIB = handle
    return _LIB


def check(err: int, what: str):
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        name = lib().ssq_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({name})")
