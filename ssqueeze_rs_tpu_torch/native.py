"""ctypes bindings for the native host runtime (``native/ssq_native.cpp``;
counterpart of ``ssqueeze_rs_tpu/native.py``).

Provides:
  * `MappedRecording`: a memory-mapped channel-major recording read in
    halo-overlapped chunks (reflect boundary), directly or through the
    C++ prefetch ring (`iter_chunks_prefetch`): the host-side feeder of
    `parallel.process_recording` for raw files,
  * `reassign_cpu`: the OpenMP fused reassignment on the CPU (float64),
  * `tkeo_cpu` / `tkeo_modified_cpu`.

The library is compiled from the repository's ``native/ssq_native.cpp``
with ``native/Makefile``'s flags at first use, into ``_build/`` under a
name that carries the hash of the source, the flags and the host (as
`_build` names the CUDA library), and loaded with ctypes. Without it (no g++, or an installed
package without the source) `tkeo_*` fall back to numpy, `reassign_cpu`
to the port's float64 `ops.ssqueeze.reassign` on the CPU, and
`MappedRecording` raises. The functions take numpy arrays or CPU tensors
and return numpy; a tensor on another device raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import time

import numpy as np

from ._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "ssq_native.cpp")
CXX = "g++"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
            "-fopenmp", "-pthread"]
BUILD_LOG = {}    # the last compile in this process: seconds, path
_lib = None


def library_path() -> str:
    """Where the library for the current source and flags lives. The
    code is compiled for the building host's CPU (-march=native), so the
    name also carries the host's name: a library built elsewhere and
    copied along with the tree is not loaded."""
    h = hashlib.sha256(" ".join([CXX] + CXXFLAGS + [platform.node(),
                                                    platform.machine()])
                       .encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libssq_native_{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile ``native/ssq_native.cpp`` unless the library for its hash
    exists (into a temporary file first, so concurrent builds do not see
    half a library). Returns the library path; raises if g++ fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        res = subprocess.run([CXX] + CXXFLAGS + ["-o", tmp, SOURCE],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{CXX} failed ({res.returncode}) on "
                               f"{SOURCE}:\n{res.stdout}{res.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_LOG.update(seconds=time.perf_counter() - t0, path=path)
    return path


def _load(build: bool = True):
    """The loaded library, compiled at first use; None when the source is
    missing or does not compile."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(SOURCE):
        return None
    path = library_path()
    if not os.path.exists(path):
        if not build:
            return None
        try:
            build_library()
        except (OSError, RuntimeError):
            return None
    lib = ctypes.CDLL(path)

    lib.ssq_open.restype = ctypes.c_void_p
    lib.ssq_open.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                             ctypes.c_int32]
    lib.ssq_n_samples.restype = ctypes.c_int64
    lib.ssq_n_samples.argtypes = [ctypes.c_void_p]
    lib.ssq_close.restype = None
    lib.ssq_close.argtypes = [ctypes.c_void_p]
    lib.ssq_read_chunk_f32.restype = ctypes.c_int
    lib.ssq_read_chunk_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
    lib.ssq_reassign_f64.restype = None
    lib.ssq_reassign_f64.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double)]
    for name in ("ssq_tkeo_f32", "ssq_tkeo_mod_f32"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                       ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
    lib.ssq_prefetch_start.restype = ctypes.c_void_p
    lib.ssq_prefetch_start.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int32]
    lib.ssq_prefetch_next.restype = ctypes.c_int64
    lib.ssq_prefetch_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64)]
    lib.ssq_prefetch_stop.restype = None
    lib.ssq_prefetch_stop.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _fptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _host_array(a, dtype):
    """`a` (array-like or CPU tensor) as a C-contiguous numpy array of
    `dtype`; a tensor on another device raises."""
    import torch

    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"the native host runtime takes numpy arrays "
                             f"or CPU tensors (got a tensor on {a.device})")
        a = a.detach().numpy()
    return np.ascontiguousarray(np.asarray(a, dtype))


class MappedRecording:
    """Memory-mapped channel-major float32/float64 recording with
    halo-overlapped chunk reads (reflect boundary)."""

    def __init__(self, path, n_channels: int, dtype="float32"):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable (g++ missing, "
                               f"or {SOURCE} not found?)")
        self._lib = lib
        code = 0 if np.dtype(dtype) == np.float32 else 1
        self._h = lib.ssq_open(os.fspath(path).encode(), n_channels, code)
        if not self._h:
            raise OSError(f"could not map {path}")
        self.n_channels = n_channels
        self.n_samples = lib.ssq_n_samples(self._h)
        self.dtype = np.dtype(dtype)

    def read_chunk(self, start: int, chunk_len: int, halo_left: int = 0,
                   halo_right: int = 0) -> np.ndarray:
        """(n_channels, halo_left + chunk_len + halo_right) float32."""
        if self.dtype != np.float32:
            raise NotImplementedError("chunk reads are float32")
        ext = halo_left + chunk_len + halo_right
        out = np.empty((self.n_channels, ext), np.float32)
        rc = self._lib.ssq_read_chunk_f32(
            self._h, start, chunk_len, halo_left, halo_right,
            _fptr(out, ctypes.c_float))
        if rc != 0:
            raise RuntimeError("ssq_read_chunk_f32 failed")
        return out

    def iter_chunks(self, chunk_len: int, halo: int):
        """Yield (start, chunk_with_halos) across the recording."""
        start = 0
        while start < self.n_samples:
            cl = min(chunk_len, self.n_samples - start)
            yield start, self.read_chunk(start, cl, halo, halo)
            start += chunk_len

    def iter_chunks_prefetch(self, chunk_len: int, halo: int,
                             depth: int = 3):
        """As `iter_chunks`, fed by the native prefetch ring: a C++ worker
        thread reads and reflect-pads the next chunks into `depth` slots
        while the consumer computes, so the host read overlaps the
        device's work. Yields (start, chunk), `chunk` a fresh numpy
        array (the slot refills once the next chunk is asked for)."""
        if self.dtype != np.float32:
            raise NotImplementedError("prefetch reads are float32")
        lib = self._lib
        p = lib.ssq_prefetch_start(self._h, chunk_len, halo, depth)
        if not p:
            raise RuntimeError("ssq_prefetch_start failed")
        try:
            buf = ctypes.POINTER(ctypes.c_float)()
            clen = ctypes.c_int64()
            while True:
                start = lib.ssq_prefetch_next(p, ctypes.byref(buf),
                                              ctypes.byref(clen))
                if start < 0:
                    break
                # a slot holds its chunk's channels back to back, each
                # this chunk's extent long
                ext = int(clen.value) + 2 * halo
                flat = np.ctypeslib.as_array(
                    buf, shape=(self.n_channels * ext,))
                yield int(start), flat.reshape(self.n_channels, ext).copy()
        finally:
            lib.ssq_prefetch_stop(p)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.ssq_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def __del__(self):
        self.close()


def reassign_cpu(Wx, dWx, ssq_freqs, const_arr, gamma, mode: str,
                 flipud: bool = False, Sfs=None):
    """Fused reassignment on the CPU in float64 (OpenMP over columns):
    Tx (nf, n) complex128 numpy from Wx and dWx (na, n)."""
    from .ops.ssqueeze import bin_params

    lib = _load()
    Wx = _host_array(Wx, np.complex128)
    dWx = _host_array(dWx, np.complex128)
    na, n = Wx.shape
    nf = len(ssq_freqs)
    consts = np.array(np.broadcast_to(_host_array(const_arr, np.float64),
                                      (na,)))
    sfs = (_host_array(Sfs, np.float64) if Sfs is not None
           else np.zeros(na))

    mode_str, params = bin_params(_host_array(ssq_freqs, np.float64),
                                  mode.startswith("log"))
    if lib is None:
        # the port's float64 reassignment, on the CPU
        import torch
        from .ops.ssqueeze import reassign
        out = reassign(
            torch.from_numpy(Wx), torch.from_numpy(dWx),
            torch.from_numpy(consts), float(gamma), torch.from_numpy(sfs),
            params, mode=mode_str, flipud=flipud, fused=True,
            transform="stft" if Sfs is not None else "cwt", nf=nf)
        return out.numpy()

    mode_code = {"log": 0, "log-piecewise": 1, "lin": 2}[mode_str]
    if mode_code == 0:
        p = (params["vlmin"], params["dvl"], 0.0, 0.0, 0)
    elif mode_code == 1:
        p = (params["vlmin0"], params["vlmin1"], params["dvl0"],
             params["dvl1"], int(params["idx1"]))
    else:
        p = (params["vmin"], params["dv"], 0.0, 0.0, 0)
    out = np.zeros((nf, n), np.complex128)
    lib.ssq_reassign_f64(
        _fptr(Wx.view(np.float64), ctypes.c_double),
        _fptr(dWx.view(np.float64), ctypes.c_double),
        _fptr(sfs, ctypes.c_double), _fptr(consts, ctypes.c_double),
        na, n, nf, mode_code, int(Sfs is not None), int(flipud),
        float(gamma), float(p[0]), float(p[1]), float(p[2]), float(p[3]),
        int(p[4]), _fptr(out.view(np.float64), ctypes.c_double))
    return out


def tkeo_cpu(x):
    """Teager-Kaiser energy x[i]^2 - x[i-1] x[i+1] per channel, float32
    (C, n - 2)."""
    lib = _load()
    x = np.atleast_2d(_host_array(x, np.float32))
    C, n = x.shape
    if lib is None:
        return x[:, 1:-1] ** 2 - x[:, :-2] * x[:, 2:]
    out = np.empty((C, n - 2), np.float32)
    lib.ssq_tkeo_f32(_fptr(x, ctypes.c_float), C, n,
                     _fptr(out, ctypes.c_float))
    return out


def tkeo_modified_cpu(x):
    """Modified TKEO x[i-1] x[i-2] - x[i] x[i-3] per channel, float32
    (C, n - 3)."""
    lib = _load()
    x = np.atleast_2d(_host_array(x, np.float32))
    C, n = x.shape
    if lib is None:
        return x[:, 2:-1] * x[:, 1:-2] - x[:, 3:] * x[:, :-3]
    out = np.empty((C, n - 3), np.float32)
    lib.ssq_tkeo_mod_f32(_fptr(x, ctypes.c_float), C, n,
                         _fptr(out, ctypes.c_float))
    return out
