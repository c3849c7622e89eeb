"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

`nvcc` compiles every source in ``csrc/`` into one shared library with a
plain C interface for sm_90a (Hopper), which is loaded with ctypes. The
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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "ssq_cwt_phase": [_P, _P, _P, _P, _F, _P, _P, _P, _P, _LL, _I, _I, _I,
                      _I, _I, _F, _P, _LL, _P, _P, _P, _P],
    "ssq_reassign": [_P, _P, _P, _P, _I, _I, _LL, _I, _I, _I, _F, _F, _F, _F,
                     _F, _P, _P, _P],
}

_LIB = None
BUILD_LOG = {}    # the last compile in this process: seconds, path


def _sources():
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
    """Compile ``csrc/*.cu`` unless the library for their hash exists, and
    keep nvcc's output, with ptxas's per-kernel report, beside it
    (`report_path`). Returns the library path."""
    path = library_path()
    if os.path.exists(path):
        return path
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = [s for s in _sources() if s.endswith(".cu")]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc] + NVCC_FLAGS + ["-Xptxas", "-v", "-o", tmp] + srcs
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        with open(report_path(path), "w") as f:
            f.write(res.stdout + res.stderr)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
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
