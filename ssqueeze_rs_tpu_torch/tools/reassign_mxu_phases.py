"""Kernel I's time by phase on the card (``csrc/reassign_mxu.cu``).

Builds copies of ``reassign_mxu.cu`` beside the kernel library, each into
a shared library of its own (one nvcc each, all started together):

  * ``clocks``: the kernel with ``clock64()`` read around each phase of a
    stage and around the store, the cycles summed over the threads into
    a device array that ``ssq_mxu_phase_clocks`` reads back;
  * ``no_products``: the products not issued (binning, tile writes and
    the store alone);
  * ``no_bins``: no entry binned (the tiles stay zero; loads, products and
    the store run).

Then, at the three timed shapes of chip_smoke.py phase 18 (the ssq_cwt
headline planes, nf = 293; the STFT planes at n_fft = 598, nf = 300; at
n_fft = 2048 on 20 000 samples, nf = 1025) it times kernel I, both
ablations and B' (medians of K runs, behind one spin of the card), and
reads the clocks of one run of ``clocks``: cycles a thread a block by
phase. Prints one JSON line and the card line.

    python -m ssqueeze_rs_tpu_torch.tools.reassign_mxu_phases [K]

It needs the card: the phases are the CUDA kernel's. The edits are text
substitutions at fixed anchors of the source; `clocked_source` and
`ablated_source` raise if an anchor is gone, and the CPU tests apply them
to the source as it stands.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from . import _common

PHASES = ("loads issued", "copies awaited", "bins", "products awaited",
          "barrier 1", "tile writes", "proxy fence", "barrier 2",
          "products issued", "last barrier", "store")

# (anchor, replacement): each anchor occurs once in the source
_CLOCKS = [
    ("namespace {\n\nusing ssq::Plan;",
     "__device__ unsigned long long g_mxu_clocks[32];\n"
     "namespace {\n\nusing ssq::Plan;"),
    ("  for (int t = 0; t < kStages - 1 && t < T; ++t) load(t);\n"
     "  for (int t = 0; t < T; ++t) {\n",
     "  unsigned long long pr[11] = {0};\n"
     "  long long tt, tb0 = clock64();\n"
     "  for (int t = 0; t < kStages - 1 && t < T; ++t) load(t);\n"
     "  for (int t = 0; t < T; ++t) {\n    tt = clock64();\n"),
    ("    ssq::mbar_wait(&bars[t % kStages], (t / kStages) & 1);\n",
     "    pr[0] += clock64() - tt; tt = clock64();\n"
     "    ssq::mbar_wait(&bars[t % kStages], (t / kStages) & 1);\n"
     "    pr[1] += clock64() - tt; tt = clock64();\n"),
    ("    ssq::wgmma_wait<0>();       // this warpgroup's products of "
     "stage t - 1\n",
     "    pr[2] += clock64() - tt; tt = clock64();\n"
     "    ssq::wgmma_wait<0>();\n    pr[3] += clock64() - tt; "
     "tt = clock64();\n"),
    ("    __syncthreads();            // every product of stage t - 1 has "
     "run\n",
     "    __syncthreads();\n    pr[4] += clock64() - tt; tt = clock64();\n"),
    ("    ssq::fence_proxy_async();\n    __syncthreads();            // "
     "stage t's tiles are whole\n",
     "    pr[5] += clock64() - tt; tt = clock64();\n"
     "    ssq::fence_proxy_async();\n    pr[6] += clock64() - tt; "
     "tt = clock64();\n    __syncthreads();\n"
     "    pr[7] += clock64() - tt; tt = clock64();\n"),
    ("    ssq::wgmma_commit();\n",
     "    ssq::wgmma_commit();\n    pr[8] += clock64() - tt;\n"),
    ("  __syncthreads();              // every product has run: D takes the "
     "tiles\n",
     "  tt = clock64();\n  __syncthreads();\n"
     "  pr[9] += clock64() - tt; tt = clock64();\n"),
    ("        (part ? txi : txr)[obase + (long long)bin * n + c] = "
     "tx(part, bin, c);\n    }\n  }\n}\n",
     "        (part ? txi : txr)[obase + (long long)bin * n + c] = "
     "tx(part, bin, c);\n    }\n  }\n  pr[10] += clock64() - tt;\n"
     "  for (int i = 0; i < 11; ++i) atomicAdd(&g_mxu_clocks[i], pr[i]);\n"
     "  if (tid == 0) {\n"
     "    atomicAdd(&g_mxu_clocks[20], (unsigned long long)(clock64() - "
     "tb0));\n    atomicAdd(&g_mxu_clocks[21], 1ull);\n  }\n}\n"),
]
_READER = """
extern "C" int ssq_mxu_phase_clocks(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[32] = {0};
    return (int)cudaMemcpyToSymbol(g_mxu_clocks, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(out, g_mxu_clocks, 32 * 8);
}
"""
_ABLATIONS = {
    "no_products": [
        ("    for (int s = 0; s < STEPS; ++s)\n#pragma unroll\n"
         "      for (int u = 0; u < CPG; ++u) {",
         "    for (int s = 0; s < STEPS && N < 0; ++s)\n#pragma unroll\n"
         "      for (int u = 0; u < CPG; ++u) {")],
    "no_bins": [
        ("      const bool valid = e < ROWS * COLS",
         "      const bool valid = N < 0 && e < ROWS * COLS")],
}


def _apply(text, edits):
    for anchor, replacement in edits:
        if text.count(anchor) != 1:
            raise ValueError("reassign_mxu.cu no longer holds the anchor "
                             f"{anchor[:60]!r} once")
        text = text.replace(anchor, replacement)
    return text


def clocked_source(text):
    """reassign_mxu.cu with the phase clocks and their reader."""
    return _apply(text, _CLOCKS) + _READER


def ablated_source(text, name):
    """reassign_mxu.cu with ablation `name` (`_ABLATIONS`)."""
    return _apply(text, _ABLATIONS[name])


def _build_copies(sources):
    """Compile each {name: text} into its own library beside the kernel
    library; returns {name: ctypes handle}."""
    from .. import _build
    root = os.path.join(_build.BUILD_DIR, "mxu_phases")
    shutil.rmtree(root, ignore_errors=True)
    jobs = {}
    for name, text in sources.items():
        d = os.path.join(root, name)
        shutil.copytree(_build.CSRC, d)
        src = os.path.join(d, "reassign_mxu.cu")
        with open(src, "w") as f:
            f.write(text)
        so = os.path.join(d, "lib.so")
        cmd = [_build._nvcc()] + _build.NVCC_FLAGS + ["-shared", "-o", so,
                                                      src]
        jobs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    handles = {}
    for name, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{out}")
        h = ctypes.CDLL(so)
        h.ssq_reassign_mxu.argtypes = _build._SIGNATURES["ssq_reassign_mxu"]
        h.ssq_reassign_mxu.restype = ctypes.c_int
        handles[name] = h
    return handles


class _Using:
    """Route kernel I's launches through the library `handle` (every other
    entry point stays the package's)."""

    def __init__(self, handle):
        self.handle = handle

    def __enter__(self):
        from .. import _build
        self.lib, main = _build.lib, _build.lib()
        fn = self.handle.ssq_reassign_mxu

        class Lib:
            def __getattr__(self, name):
                return fn if name == "ssq_reassign_mxu" else getattr(main,
                                                                      name)
        _build.lib = Lib
        return self

    def __exit__(self, *exc):
        from .. import _build
        _build.lib = self.lib


class _Impl:
    def __init__(self, value):
        self.value = value

    def __enter__(self):
        self.old = os.environ.get("SSQ_TPU_REASSIGN_IMPL")
        os.environ["SSQ_TPU_REASSIGN_IMPL"] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("SSQ_TPU_REASSIGN_IMPL", None)
        else:
            os.environ["SSQ_TPU_REASSIGN_IMPL"] = self.old


def _cases(dev):
    """chip_smoke.py phase 18's timed inputs: {key: reassign4 args}."""
    from .. import stft
    from ..config import EPS32
    from ..ops import fft_cuda
    from ..ops.cwt import cwt_phase_args
    from ..ops.ssqueeze import plan_reassignment, plan_ssqueeze
    from ..scales import process_scales
    from ..utils.pad import padsignal
    from ..wavelets import Wavelet
    gamma, N = 10 * EPS32, 160_000

    def stft_case(xs, n_fft):
        (sr, si), (dr, di) = stft(xs, n_fft=n_fft, derivative=True,
                                  planar_out=True)
        nf = sr.shape[-2]
        Sfs = np.linspace(0, 0.5, nf, dtype=np.float32)
        const, mode, params = plan_reassignment(Sfs, nf, False,
                                                transform="stft")
        return (sr, si, dr, di,
                torch.as_tensor(const, dtype=torch.float32, device=dev),
                torch.as_tensor(Sfs, device=dev), gamma, params, mode, False,
                nf, "stft")

    wavelet = Wavelet.build("gmw", l1_norm=True)
    scales = process_scales("log-piecewise", N, wavelet)[:300]
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(N),
                        dtype=torch.float32, device=dev)
    xp, _, n1, _ = padsignal(x, "reflect", get_params=True)
    planes = fft_cuda.cwt_fused(*cwt_phase_args(
        xp, scales.squeeze(-1), 1.0, wavelet), keep=(n1, N), derivative=True)
    na = planes[0].shape[0]
    freqs, const, mode, params = plan_ssqueeze(
        N, na, None, scales, fs=1.0, maprange="peak", wavelet=wavelet)
    x20 = torch.as_tensor(np.random.default_rng(18).standard_normal(20_000),
                          dtype=torch.float32, device=dev)
    return {"cwt nf=293": (*planes, torch.as_tensor(const,
                                                     dtype=torch.float32,
                                                     device=dev),
                           torch.zeros(na, device=dev), gamma, params, mode,
                           True, len(freqs), "cwt"),
            "stft nf=300": stft_case(x, 598),
            "stft nf=1025": stft_case(x20, 2048)}


def main(argv=None):
    args = _common.parse_args(argv, __doc__.split("\n\n")[0])
    dev = _common.pick_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("reassign_mxu_phases times the CUDA kernel's "
                           "phases: it has no CPU mode")
    from .. import _build
    from ..ops import reassign_cuda as R
    _build.build()
    with open(os.path.join(_build.CSRC, "reassign_mxu.cu")) as f:
        text = f.read()
    sources = {"clocks": clocked_source(text)}
    sources.update({k: ablated_source(text, k) for k in _ABLATIONS})
    handles = _build_copies(sources)
    clocks = handles["clocks"]
    clocks.ssq_mxu_phase_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    clocks.ssq_mxu_phase_clocks.restype = ctypes.c_int
    out = {}
    for key, a in _cases(dev).items():
        row = {}
        with _Impl("vpu"):
            row["B'"] = _common.time_ms(lambda: R.reassign4(*a), dev, args.K)
        with _Impl("mxu"):
            row["I"] = _common.time_ms(lambda: R.reassign4(*a), dev, args.K)
            for name in _ABLATIONS:
                with _Using(handles[name]):
                    row[name] = _common.time_ms(lambda: R.reassign4(*a), dev,
                                                args.K)
            with _Using(clocks):
                R.reassign4(*a)
                torch.cuda.synchronize(dev)
                buf = (ctypes.c_ulonglong * 32)()
                _build.check(clocks.ssq_mxu_phase_clocks(buf, 1), "clocks")
                R.reassign4(*a)
                torch.cuda.synchronize(dev)
                _build.check(clocks.ssq_mxu_phase_clocks(buf, 0), "clocks")
        blocks, threads = buf[21], 128 * R.MXU_GROUPS
        row["blocks"] = blocks
        row["cycles_a_block"] = buf[20] / blocks
        row["phases"] = {p: buf[i] / blocks / threads
                         for i, p in enumerate(PHASES)}
        row["plan"] = R._mxu_plan(a[10])._asdict()
        out[key] = row
        b4 = row["B'"]
        print(f"{key}: I {row['I']:.3f} ms, no_products "
              f"{row['no_products']:.3f}, no_bins {row['no_bins']:.3f}, "
              f"B' {b4:.3f}; cycles a thread a block: " +
              ", ".join(f"{p} {c:.0f}" for p, c in row["phases"].items()) +
              f" (block {row['cycles_a_block']:.0f})", flush=True)
    print(json.dumps({"reassign_mxu_phases": out}))
    print(_common.card_line(dev))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
