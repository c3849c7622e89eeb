"""Kernel build logic of the torch port, on a machine without nvcc: the
library name follows the content of every source the build compiles
(headers included), every C entry point the wrappers call has its ctypes
signature, and a missing compiler raises a clear error and leaves nothing
behind. (The build itself runs only where nvcc and a GPU are, through
chip_smoke.py.)"""
import ctypes
import os
import shutil

import pytest

from ssqueeze_rs_tpu_torch import _build


@pytest.fixture
def src_tree(tmp_path, monkeypatch):
    """A private copy of csrc/ and an empty build directory."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    return csrc


def test_library_name_follows_source_content(src_tree):
    first = _build.library_path()
    assert first == _build.library_path()
    assert os.path.basename(first).startswith("libssq_kernels_")
    src = src_tree / "reassign.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path() != first


@pytest.mark.parametrize("name", ["bins.cuh", "bluestein.cuh", "stft_dft.cu",
                                  "ssq_stft.cu", "istft_ola.cu",
                                  "reassign_bwd.cu", "cwt_pair.cuh",
                                  "reassign.cu", "cwt_planes.cu",
                                  "reassign_mxu.cu",
                                  "reassign.cuh", "ablate_cwt.cu",
                                  "ablate_reassign.cu",
                                  "grid_slope.cu", "rate_probe.cu",
                                  "dma_overlap.cu", "mxu_probe.cu",
                                  "fft_radix.cuh", "planes.cuh",
                                  "reassign_walk.cuh", "wgmma.cuh",
                                  "reassign64.cu", "reassign64.cuh",
                                  "tma.cuh"])
def test_library_name_covers_every_source(src_tree, name):
    first = _build.library_path()
    src = src_tree / name
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path() != first


def test_entry_points_have_signatures():
    """Each extern "C" entry point of csrc/*.cu has argtypes, with one
    entry per parameter."""
    import re
    for path in _build._sources():
        if not path.endswith(".cu"):
            continue
        text = open(path).read()
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text):
            assert name in _build._SIGNATURES, name
            assert len(_build._SIGNATURES[name]) == params.count(",") + 1, name
    assert {"ssq_reassign4", "ssq_stft_dft", "ssq_stft_fused",
            "ssq_istft_ola", "ssq_reassign_bwd", "ssq_reassign4_bwd",
            "ssq_cwt_planes", "ssq_ifft_halfband",
            "ssq_reassign_mxu", "ssq_ablate_cwt", "ssq_cwt_copy_floor",
            "ssq_cwt_staged", "ssq_ablate_reassign", "ssq_grid_slope",
            "ssq_grid_slope_plan",
            "ssq_rate_dot", "ssq_rate_copy", "ssq_dma_overlap",
            "ssq_mxu_dots", "ssq_mxu_elem", "ssq_reassign_f64",
            "ssq_reassign4_f64", "ssq_reassign_bwd_f64",
            "ssq_reassign4_bwd_f64"} <= set(_build._SIGNATURES)


def _c_entry_points():
    import re
    for path in _build._sources():
        if path.endswith(".cu"):
            with open(path) as f:
                yield from re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                      f.read())


@pytest.mark.parametrize("name", ["ssq_reassign", "ssq_reassign4",
                                  "ssq_reassign_bwd", "ssq_reassign4_bwd",
                                  "ssq_reassign_f64", "ssq_reassign4_f64",
                                  "ssq_reassign_bwd_f64",
                                  "ssq_reassign4_bwd_f64",
                                  "ssq_reassign_mxu"])
def test_reassign_argtypes_follow_the_c_types(name):
    """Each parameter of kernels B, B', C and C' (float and double) and I
    has the ctypes type of its C declaration: a pointer, long long, int,
    float or double (a float64 constant passed as c_float would be
    rounded)."""
    import ctypes
    params = dict(_c_entry_points())[name].split(",")
    want = []
    for decl in params:
        decl = decl.strip()
        want.append(ctypes.c_void_p if "*" in decl else
                    ctypes.c_longlong if "long long" in decl else
                    ctypes.c_double if decl.startswith("double") else
                    ctypes.c_float if decl.startswith("float") else
                    ctypes.c_int)
    assert _build._SIGNATURES[name] == want
    doubles = sum(t is ctypes.c_double for t in want)
    assert doubles == (0 if not name.endswith("_f64") else
                       6 if "reassign4" in name else 5)


def test_tensor_core_helpers_are_shared():
    """Kernel I and probes J5's products, J6's dots and J7's chain take
    their wgmma products (J6 its register-A forms), roundings, async
    copies, barriers and cluster helpers from one header (wgmma.cuh), J5,
    J6, J7 and the double B/B' their TMA copies and the tensor-map encoder
    from another (tma.cuh), the only file that defines tma_load; none of
    them writes that PTX itself. The mma.sync header is gone with its last
    user (J7's old chain)."""
    def read(name):
        with open(os.path.join(_build.CSRC, name)) as f:
            return f.read()
    assert not os.path.exists(os.path.join(_build.CSRC, "mma.cuh"))
    for name in ("rate_probe.cu", "mxu_probe.cu", "dma_overlap.cu"):
        text = read(name)
        assert '#include "wgmma.cuh"' in text, name
        assert '#include "tma.cuh"' in text, name
        assert '"mma.cuh"' not in text, name
        for ptx in ("wgmma.mma_async", "cp.async.bulk", "mma.sync",
                    '"cvt.rna', "mapa", "barrier.cluster", "asm"):
            assert ptx not in text, (name, ptx)
    text = read("mxu_probe.cu")
    assert "WgmmaRS<" in text
    text = read("dma_overlap.cu")
    assert "WgmmaSS<N>" in text and "cluster_rank()" in text
    assert "bulk_copy_peer(" in text and "cudaLaunchKernelEx" in text
    text = read("reassign_mxu.cu")
    assert '#include "wgmma.cuh"' in text
    assert "asm" not in text
    assert '#include "tma.cuh"' in read("reassign64.cu")
    defines = [os.path.basename(p) for p in _build._sources()
               if "void tma_load(" in open(p).read()]
    assert defines == ["tma.cuh"]
    assert "cudaGetDriverEntryPoint" not in read("reassign64.cu")
    assert "cudaGetDriverEntryPoint" in read("tma.cuh")
    header = read("wgmma.cuh")
    assert header.count("\"wgmma.mma_async.sync.aligned.m64n") == 20
    assert header.count(".f32.tf32.tf32 ") == 2
    assert header.count("struct WgmmaRS<") == 2
    for helper in ("uint32_t tf32(", "uint32_t pack_bf16(",
                   "int cluster_rank(", "void cluster_sync(",
                   "uint32_t cluster_addr("):
        assert header.count(helper) == 1, helper


def test_cwt_kernels_share_the_four_step_header():
    """Kernels A, D and E run one launch pair (cwt_pair.cuh: launch 1
    takes a loader, launch 2 a store), included by their entry points
    (cwt_planes.cu) and by the probes P1-P3 (ablate_cwt.cu), which
    instantiate the same kernels with ablation flags; all of them, F
    (stft_dft.cu), G (ssq_stft.cu) and H (istft_ola.cu) run on the
    register-radix core (fft_radix.cuh); F and G share its chirp-z frame
    routine (bluestein.cuh), and G has no dense DFT tile and no atomics.
    The radix-2 four-step design (fft4.cuh, cwt_planes.cuh) is gone. The
    second launches' output planes (planes.cuh) come through
    cwt_pair.cuh. The build hashes every header with the sources; B and B'
    (reassign.cu) run reassign.cuh, and their probe P4 the row walk they
    ran before (reassign_walk.cuh)."""
    import re
    sources = [os.path.basename(p) for p in _build._sources()]
    assert {"cwt_pair.cuh", "fft_radix.cuh", "planes.cuh", "reassign.cuh",
            "reassign_walk.cuh", "bluestein.cuh"} <= set(sources)
    assert not {"cwt_phase.cu", "dft_tile.cuh", "fft4.cuh",
                "cwt_planes.cuh"} & set(sources)
    for name, header in (("cwt_pair.cuh", "fft_radix.cuh"),
                         ("cwt_pair.cuh", "planes.cuh"),
                         ("cwt_planes.cu", "cwt_pair.cuh"),
                         ("ablate_cwt.cu", "cwt_pair.cuh"),
                         ("ablate_cwt.cu", "tma.cuh"),
                         ("stft_dft.cu", "bluestein.cuh"),
                         ("ssq_stft.cu", "bluestein.cuh"),
                         ("ssq_stft.cu", "bins.cuh"),
                         ("bluestein.cuh", "fft_radix.cuh"),
                         ("istft_ola.cu", "fft_radix.cuh"),
                         ("reassign.cu", "reassign.cuh"),
                         ("ablate_reassign.cu", "reassign_walk.cuh")):
        with open(os.path.join(_build.CSRC, name)) as f:
            assert f'#include "{header}"' in f.read(), name
    for name in sources:
        with open(os.path.join(_build.CSRC, name)) as f:
            text = f.read()
        for header in ("fft4.cuh", "cwt_planes.cuh"):
            assert f'#include "{header}"' not in text, name
    # A and E have no stage kernel of their own: the pair's kernels are D's,
    # and A's entry point runs them with its loader and store; the entry
    # points' file has no kernel
    kernel = r"__global__ void (?:__launch_bounds__\([^)]*\)\s*)?(\w+)\("
    with open(os.path.join(_build.CSRC, "cwt_pair.cuh")) as f:
        assert re.findall(kernel, f.read()) == ["cwt_d_stage1",
                                                 "cwt_d_stage2"]
    with open(os.path.join(_build.CSRC, "cwt_planes.cu")) as f:
        text = f.read()
    assert re.findall(kernel, text) == []
    assert 'extern "C" int ssq_cwt_phase(' in text
    assert "run_planes<2>(load, ps," in text
    for name in ("stft_dft.cu", "ssq_stft.cu", "istft_ola.cu"):
        with open(os.path.join(_build.CSRC, name)) as f:
            text = f.read()
        assert "dft_tile" not in text, name
        assert "atomicAdd" not in text, name
    # 23 and 14 parameters (D: planes, E: given Z planes); A 22 (D's
    # inputs but the derivative flag, gamma^2, three planes); P1 takes D's
    # with the variant for the derivative flag, P3 D's without it; F 15
    # (the signal, its three Bluestein tables, shapes, fs, the planes); G
    # 28 (F's inputs with two windows, const, Sfs, gamma^2, the binning
    # plan, frames a block and the entries' stride, four planes); H 15
    # (the two planes, F's three tables, shapes, the partials, out)
    assert len(_build._SIGNATURES["ssq_cwt_planes"]) == 23
    assert len(_build._SIGNATURES["ssq_ifft_halfband"]) == 14
    assert len(_build._SIGNATURES["ssq_cwt_phase"]) == 22
    assert len(_build._SIGNATURES["ssq_ablate_cwt"]) == 23
    assert len(_build._SIGNATURES["ssq_cwt_staged"]) == 22
    assert len(_build._SIGNATURES["ssq_stft_dft"]) == 15
    assert len(_build._SIGNATURES["ssq_stft_fused"]) == 28
    assert len(_build._SIGNATURES["ssq_istft_ola"]) == 15


def test_reassign_sources():
    """Kernels B and B' (reassign.cu) run the lanes kernel of reassign.cuh;
    probe P4 (ablate_reassign.cu) runs that scatter under its ablation
    flags and the row walk of reassign_walk.cuh; both headers bin through
    bins.cuh; no reassignment source uses atomics; the columns a block the
    entry points dispatch are the planner's, and the ctypes rows carry the
    one launch-shape int."""
    import re
    from ssqueeze_rs_tpu_torch.ops import reassign_cuda
    text = {}
    for name in ("reassign.cu", "reassign.cuh", "reassign_walk.cuh",
                 "ablate_reassign.cu", "reassign_bwd.cu", "reassign_mxu.cu",
                 "bins.cuh"):
        with open(os.path.join(_build.CSRC, name)) as f:
            text[name] = f.read()
        assert "atomicAdd" not in text[name], name
    inc = {n: set(re.findall(r'#include "([\w.]+)"', t))
           for n, t in text.items()}
    assert inc["reassign.cu"] == {"reassign.cuh"}
    assert inc["ablate_reassign.cu"] == {"reassign.cuh", "reassign_walk.cuh"}
    assert "bins.cuh" in inc["reassign.cuh"] & inc["reassign_walk.cuh"]
    assert "__match_any_sync" in text["reassign.cuh"]
    assert "constexpr int kLanes = 16;" in text["reassign.cuh"]
    assert "reassign_walk_kernel" in text["reassign_walk.cuh"]
    dispatched = {int(c) for c in
                  re.findall(r"case (\d+): return launch<", text["reassign.cu"])}
    assert dispatched == {reassign_cuda._block_cols(nf)
                          for nf in range(1, 3633)} == {32, 8}
    # B 21 and B' 25 parameters (their inputs, the columns a block, the
    # bin range, the Tx planes, the stream); P4's 3-plane entry B's with
    # its variant (full or walk) in place of the bin range
    assert len(_build._SIGNATURES["ssq_reassign"]) == 21
    assert len(_build._SIGNATURES["ssq_reassign4"]) == 25
    sig = _build._SIGNATURES["ssq_reassign"]
    assert _build._SIGNATURES["ssq_ablate_reassign3"] == (
        sig[:-5] + [ctypes.c_int] + sig[-3:])


def test_reassign64_sources():
    """B and B' in double (reassign64.cu) bin through bins.cuh, stage
    the planes by TMA (8-byte cp.async where n is odd) on mbarriers
    (wgmma.cuh's and tma.cuh's helpers) and store Tx by TMA, add in rounds by row with
    no atomics, dispatch exactly the (columns, row groups, blocks an SM)
    the plan takes over nf = 1..3632, and their entries take the plan's
    columns, row groups and stages; reassign.cu has no double
    instantiation left."""
    import re
    from ssqueeze_rs_tpu_torch.ops import reassign_cuda
    with open(os.path.join(_build.CSRC, "reassign64.cu")) as f:
        text = f.read()
    with open(os.path.join(_build.CSRC, "reassign.cu")) as f:
        old = f.read()
    with open(os.path.join(_build.CSRC, "reassign64.cuh")) as f:
        bins = f.read()
    assert set(re.findall(r'#include "([\w.]+)"', text)) == {
        "reassign64.cuh", "tma.cuh", "wgmma.cuh"}
    assert set(re.findall(r'#include "([\w.]+)"', bins)) == {"bins.cuh"}
    assert "atomicAdd" not in bins and "__noinline__" in bins
    # the SASS count of an entry's path instantiates the same entry_bin
    tool = os.path.join(os.path.dirname(_build.CSRC), "tools",
                        "reassign64_path.cu")
    with open(tool) as f:
        assert '#include "../csrc/reassign64.cuh"' in f.read()
    assert "atomicAdd" not in text and "__shfl_up_sync" in text
    assert "tma_load(" in text and "mbar_wait" in text
    assert "tma_store(" in text
    with open(os.path.join(_build.CSRC, "tma.cuh")) as f:
        tma = f.read()
    assert "cp.async.bulk.tensor.2d" in tma
    assert "cp.async.bulk.tensor.3d.global.shared" in tma
    assert "double" not in old and "_f64" not in old
    cases = {tuple(int(x) for x in case) for case in
             re.findall(r"SSQ_F64_CASE\((\d+), (\d+), (\d+)\)\n", text)}
    planned = {(p.cols, p.groups, p.blocks) for nf in range(1, 3633)
               for p in (reassign_cuda._f64_plan(nf, 3),
                         reassign_cuda._f64_plan(nf, 4))}
    assert cases == planned
    assert {case[:2] for case in cases} == {
        (c, g) for c, gs in reassign_cuda.F64_SHAPES.items() for g in gs}
    assert "kMaxStages = %d;" % reassign_cuda._F64_MAX_STAGES in text
    # B 23 and B' 27 parameters: B's and B''s float32 ones, the columns a
    # block replaced by the plan's columns, row groups and stages
    assert len(_build._SIGNATURES["ssq_reassign_f64"]) == 23
    assert len(_build._SIGNATURES["ssq_reassign4_f64"]) == 27


def test_missing_nvcc_raises_and_leaves_nothing(src_tree, monkeypatch):
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not os.path.exists(_build.BUILD_DIR) or \
        not os.listdir(_build.BUILD_DIR)


def test_existing_library_is_reused_without_nvcc(src_tree, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    path = _build.library_path()
    os.makedirs(_build.BUILD_DIR)
    with open(path, "wb"):
        pass
    assert _build.build() == path
    assert _build.report_path(path).endswith(".txt")
    assert _build.report_path(path) != path


def test_build_with_a_stand_in_compiler(src_tree, monkeypatch, tmp_path):
    """The build's own logic end to end, with a stand-in for nvcc that
    writes each output it is asked for: one compile per .cu, one link,
    the report with each compile's output, the library at its hashed
    name."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    "while [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then out=$2; fi; shift\n"
                    "done\n"
                    "echo compiled > \"$out\"; echo ptxas info\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    path = _build.build()
    assert path == _build.library_path() and os.path.exists(path)
    sources = sorted(os.path.basename(p) for p in _build._sources()
                     if p.endswith(".cu"))
    assert _build.BUILD_LOG["path"] == path
    with open(_build.report_path(path)) as f:
        report = f.read()
    assert report.count("ptxas info") == len(sources)
    assert sorted(line.rsplit("/", 1)[1] for line in report.splitlines()
                  if line.startswith("$ ")) == sources
    assert set(os.listdir(_build.BUILD_DIR)) == {
        os.path.basename(path), os.path.basename(_build.report_path(path))}


def test_sass_compare_masks_only_the_namespace_hash():
    """tools/sass_compare reads `cuobjdump -sass` output function by
    function and masks the hash nvcc puts into anonymous-namespace names,
    and nothing else: two builds that differ only there compare equal,
    an instruction or an encoding that differs does not."""
    from ssqueeze_rs_tpu_torch.tools import sass_compare as sc

    def dump(hash_, instr="FFMA R4, R2, R3, R4 ;", enc="0x000fe20000000f00"):
        return (
            "\tcode for sm_90a\n"
            f"\t\tFunction : _ZN46_GLOBAL__N__{hash_}_13_cwt_planes_cu_"
            "0002529412cwt_d_stage1ILi9ELi2ENS_5DLoadEEEvT1_iP6float2xx\n"
            "\t.headerflags\t@\"EF_CUDA_SM90\"\n"
            f"        /*0000*/  {instr}   /* 0x00000a00ff017b82 */\n"
            f"                                   /* {enc} */\n"
            "\t\tFunction : _Z4plainv\n"
            "        /*0000*/  EXIT ;   /* 0x000000000000794d */\n")

    a = sc.functions(dump("7c6e1227"))
    assert len(a) == 2 and all(len(v) == 3 for k, v in a.items()
                               if "cwt_d_stage1" in k)
    assert a == sc.functions(dump("0a1b2c3d"))
    assert a != sc.functions(dump("7c6e1227", instr="FMUL R4, R2, R3 ;"))
    assert a != sc.functions(dump("7c6e1227", enc="0x000fe20000000f01"))
    assert "0x00000a00ff017b82" in next(v for v in a.values())[1]
