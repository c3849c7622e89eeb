"""Compare the machine code (SASS) of the path kernels built from two
source trees: the check that a change to a shared header leaves the
kernels the package runs as they were.

    python -m ssqueeze_rs_tpu_torch.tools.sass_compare OLD_CSRC [NEW_CSRC]
        [--sources cwt_planes.cu,stft_dft.cu,ssq_stft.cu,istft_ola.cu,reassign.cu]

Each source is compiled in both trees with the library's own flags
(`_build.NVCC_FLAGS`) to a cubin (all compiles at once), and every
function of each cubin is disassembled (`cuobjdump -sass`). Two functions
are the same where their instructions and encodings are equal line for
line once the hash that nvcc puts into the names of anonymous-namespace
symbols is masked. NEW_CSRC defaults to this package's `csrc/`. The
default sources hold kernels D, E and A (cwt_planes.cu, on cwt_pair.cuh),
F (stft_dft.cu), G (ssq_stft.cu), H (istft_ola.cu) and B and B'
(reassign.cu, on reassign.cuh, whose scatter probe P4 instantiates with
ablation flags). Prints a line a
source and one JSON line; exits 1 where a function differs or is in one
tree alone. Needs nvcc and cuobjdump (the CUDA toolkit), no card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

from .. import _build

SOURCES = ("cwt_planes.cu", "stft_dft.cu", "ssq_stft.cu", "istft_ola.cu",
           "reassign.cu")
# the hash nvcc puts into the names of anonymous-namespace symbols, inside
# an identifier
_HASH = re.compile(r"(?<=_)[0-9a-f]{8,}(?=_)")
_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def _mask(line):
    return _IDENT.sub(lambda m: _HASH.sub(lambda h: "#" * len(h.group()),
                                          m.group()), line)


def functions(sass):
    """{masked name: [masked lines]} of `cuobjdump -sass` output."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _mask(m.group(1))
            out[name] = []
        elif name is not None and line.strip():
            out[name].append(_mask(line.strip()))
    return out


def _cuobjdump():
    found = shutil.which("cuobjdump")
    if found:
        return found
    return os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")


def compile_cubins(pairs, work):
    """Compile each (source path, cubin name) into `work`, all at once;
    returns the cubin paths in order (raises on a failed compile)."""
    nvcc = _build._nvcc()
    jobs = []
    for src, name in pairs:
        cubin = os.path.join(work, name)
        cmd = [nvcc] + _build.NVCC_FLAGS + ["-cubin", "-o", cubin, src]
        jobs.append((cmd, cubin, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out}")
    return [c for _, c, _ in jobs]


def sass_of(cubin):
    res = subprocess.run([_cuobjdump(), "-sass", cubin], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {cubin}: {res.stderr}")
    return functions(res.stdout)


def compare(old_csrc, new_csrc, sources=SOURCES, dump=None):
    """{source: dict(functions, same, differ, only_old, only_new)} with
    the names of the differing and unmatched functions; with `dump`, a
    directory, the two SASS texts of each differing function are written
    there."""
    work = tempfile.mkdtemp(dir=_build.BUILD_DIR if os.path.isdir(
        _build.BUILD_DIR) else None)
    try:
        pairs = []
        for s in sources:
            pairs += [(os.path.join(old_csrc, s), f"old_{s}.cubin"),
                      (os.path.join(new_csrc, s), f"new_{s}.cubin")]
        cubins = compile_cubins(pairs, work)
        result = {}
        for i, s in enumerate(sources):
            old, new = sass_of(cubins[2 * i]), sass_of(cubins[2 * i + 1])
            both = sorted(set(old) & set(new))
            differ = [f for f in both if old[f] != new[f]]
            for k, f in enumerate(differ if dump else ()):
                for tag, fns in (("old", old), ("new", new)):
                    with open(os.path.join(dump, f"{s}.{k}.{tag}.sass"),
                              "w") as out:
                        out.write(f"{f}\n" + "\n".join(fns[f]) + "\n")
            result[s] = dict(
                functions=len(both),
                same=sum(old[f] == new[f] for f in both),
                differ=differ,
                only_old=sorted(set(old) - set(new)),
                only_new=sorted(set(new) - set(old)))
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("old", help="the csrc/ directory to compare against")
    p.add_argument("new", nargs="?", default=_build.CSRC,
                   help="the csrc/ directory compared (default: this "
                        "package's)")
    p.add_argument("--sources", default=",".join(SOURCES),
                   help="comma-separated .cu files (default: %(default)s)")
    p.add_argument("--dump", default=None,
                   help="a directory for the SASS of differing functions")
    a = p.parse_args(argv)
    if a.dump:
        os.makedirs(a.dump, exist_ok=True)
    result = compare(a.old, a.new, tuple(a.sources.split(",")), a.dump)
    ok = True
    for s, r in result.items():
        bad = r["differ"] or r["only_old"] or r["only_new"]
        ok = ok and not bad and r["functions"] > 0
        print(f"{s}: {r['same']} of {r['functions']} functions identical"
              + (f"; differ {r['differ']}, only old {r['only_old']}, only "
                 f"new {r['only_new']}" if bad else ""), flush=True)
    print(json.dumps(dict(identical=ok, sources=result)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
