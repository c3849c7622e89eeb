"""Variants of probe J6's resident dots on the card (``csrc/mxu_probe.cu``).

Builds copies of ``mxu_probe.cu`` beside the kernel library, each into a
shared library of its own (one nvcc each, all started together), each
with one design choice of the resident route undone or changed:

  * ``1 set``, ``2 sets``, ``8 sets``: the steps whose products are in
    flight before one wait (``kChains``; the kernel takes 4);
  * ``pipelined``: two accumulator sets, step s + 1's products issued
    before step s is added into the running sum (a wait<1> between them);
  * ``n8 units``: units of 8 rows of out (228 at q_dots) in place of 16.

Then it times q_dots at GRID 16 (``mxu_probe``) and 128 (``mxu_probe2``)
and q_dots4 with the kernel as built and with every variant (medians of K
runs, behind one spin of the card), holds each to the plain version
(within 1e-5 of max|out|), and prints each build's registers and ptxas's
wgmma serialization messages (C75xx), one JSON line and the card line.

    python -m ssqueeze_rs_tpu_torch.tools.mxu_dots_variants [K]

It needs the card. The edits are text substitutions at fixed anchors of
the source; `variant_source` raises if an anchor is gone, and the CPU
tests apply them to the source as it stands.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import torch

from . import _common, mxu_probe, mxu_probe2

_CHAINS = "constexpr int kChains = 4;"
_UNIT = "constexpr int kUnitN = 16;"
# the resident steps as built: kChains sets in flight, one wait
_LOOP = """  int i = 0;
  for (; i + kChains <= ns; i += kChains) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) issue<W>(acc[c], fa, at(i + c));
    ssq::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kChains; ++c) take(acc[c]);
  }
  for (; i < ns; ++i) {   // the last ns % kChains steps, one at a time
    issue<W>(acc[0], fa, at(i));
    ssq::wgmma_wait<0>();
    take(acc[0]);
  }
"""
# two sets, the next step in flight while the last is added
_PIPELINED = """  if (ns > 0) issue<W>(acc[0], fa, at(0));
  int i = 0;
  for (; i + 2 < ns; i += 2) {
    issue<W>(acc[1], fa, at(i + 1));
    ssq::wgmma_wait<1>();
    take(acc[0]);
    issue<W>(acc[0], fa, at(i + 2));
    ssq::wgmma_wait<1>();
    take(acc[1]);
  }
  if (i + 1 < ns) {
    issue<W>(acc[1], fa, at(i + 1));
    ssq::wgmma_wait<1>();
    take(acc[0]);
    ssq::wgmma_wait<0>();
    take(acc[1]);
  } else if (ns > 0) {
    ssq::wgmma_wait<0>();
    take(acc[0]);
  }
"""
VARIANTS = {
    "1 set": [(_CHAINS, "constexpr int kChains = 1;")],
    "2 sets": [(_CHAINS, "constexpr int kChains = 2;")],
    "8 sets": [(_CHAINS, "constexpr int kChains = 8;")],
    "pipelined": [(_LOOP, _PIPELINED)],
    "n8 units": [(_UNIT, "constexpr int kUnitN = 8;")],
}
# (name, module, B's key) of the timed questions
CASES = (("q_dots GRID 16", mxu_probe, "B"), ("q_dots GRID 128", mxu_probe2, "B"),
         ("q_dots4 GRID 128", mxu_probe2, "B4"))


def variant_source(text, name):
    """mxu_probe.cu with variant `name` (`VARIANTS`)."""
    for anchor, replacement in VARIANTS[name]:
        if text.count(anchor) != 1:
            raise ValueError("mxu_probe.cu no longer holds the anchor "
                             f"{anchor[:60]!r} once")
        text = text.replace(anchor, replacement)
    return text


def ptxas_notes(report):
    """(registers of dots_resident, its C75xx messages) from nvcc's
    -Xptxas -v output."""
    lines = report.splitlines()
    regs = None
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "dots_resident" in line:
            for nxt in lines[i + 1:i + 5]:
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    regs = int(m.group(1))
                    break
    notes = sorted({m.group(1) for m in re.finditer(
        r"\((C75\d\d)\)[^\n]*dots_resident", report)})
    return regs, notes


def _build_copies(sources):
    """Compile each {name: text} into its own library beside the kernel
    library; returns {name: (ctypes handle, ptxas report)}."""
    from .. import _build
    root = os.path.join(_build.BUILD_DIR, "mxu_dots_variants")
    shutil.rmtree(root, ignore_errors=True)
    jobs = {}
    for i, (name, text) in enumerate(sources.items()):
        d = os.path.join(root, str(i))
        shutil.copytree(_build.CSRC, d)
        src = os.path.join(d, "mxu_probe.cu")
        with open(src, "w") as f:
            f.write(text)
        so = os.path.join(d, "lib.so")
        cmd = ([_build._nvcc()] + _build.NVCC_FLAGS +
               ["-Xptxas", "-v", "-shared", "-o", so, src])
        jobs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{out}")
        h = ctypes.CDLL(so)
        h.ssq_mxu_dots.argtypes = _build._SIGNATURES["ssq_mxu_dots"]
        h.ssq_mxu_dots.restype = ctypes.c_int
        built[name] = (h, out)
    return built


def _dots_with(handle):
    """`mxu_probe.dots` (accumulated) through the library `handle`."""
    from .. import _build

    def dots(A, B, steps):
        out = torch.empty((A.shape[0], B.shape[1]), dtype=torch.float32,
                          device=A.device)
        _build.check(handle.ssq_mxu_dots(
            A.data_ptr(), B.data_ptr(), out.data_ptr(), 1, A.shape[0],
            A.shape[1], B.shape[1], steps, 1,
            torch.cuda.current_stream(A.device).cuda_stream), "variant dots")
        return out
    return dots


def main(argv=None):
    args = _common.parse_args(argv, __doc__.split("\n\n")[0])
    dev = _common.pick_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("mxu_dots_variants times builds of the CUDA "
                           "kernel: it has no CPU mode")
    from .. import _build
    path = _build.build()
    with open(os.path.join(_build.CSRC, "mxu_probe.cu")) as f:
        text = f.read()
    built = _build_copies({k: variant_source(text, k) for k in VARIANTS})
    with open(_build.report_path(path)) as f:
        report = f.read()
    notes = {"as built": ptxas_notes(report)}
    notes.update({k: ptxas_notes(v[1]) for k, v in built.items()})
    dots = {"as built": lambda A, B, s: mxu_probe.dots(A, B, s)}
    dots.update({k: _dots_with(v[0]) for k, v in built.items()})
    out = {}
    for case, mod, bkey in CASES:
        size = mod.HEADLINE
        inp = mod.make_inputs(dev, size)
        A, B = inp["A"], inp[bkey]
        steps = size["GRID"] * size["NG"]
        plain = mxu_probe.dots_plain(A, B, steps)
        flops = 2.0 * steps * A.shape[0] * A.shape[1] * B.shape[1]
        for name, fn in dots.items():
            got = fn(A, B, steps)
            rel = float((got - plain).abs().max() / plain.abs().max())
            ms = _common.time_ms(lambda: fn(A, B, steps), dev, args.K)
            out.setdefault(name, dict(registers=notes[name][0],
                                      ptxas=notes[name][1]))[case] = dict(
                ms=ms, tflop_s=flops / ms / 1e9, rel=rel)
    for name, row in out.items():
        print(f"{name:<10s} " + ", ".join(
            f"{case} {row[case]['ms']:.4f} ms ({row[case]['tflop_s']:.1f} "
            f"TFLOP/s, rel {row[case]['rel']:.1e})" for case, _, _ in CASES) +
            f"; {row['registers']} registers, ptxas "
            f"{' '.join(row['ptxas']) or 'no serialization'}", flush=True)
    print(json.dumps({"mxu_dots_variants": out}))
    print(_common.card_line(dev))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
