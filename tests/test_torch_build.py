"""Kernel build logic of the torch port, on a machine without nvcc: the
library name follows the content of every source the build compiles
(headers included), every C entry point the wrappers call has its ctypes
signature, and a missing compiler raises a clear error and leaves nothing
behind. (The build itself runs only where nvcc and a GPU are, through
chip_smoke.py.)"""
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


@pytest.mark.parametrize("name", ["bins.cuh", "dft_tile.cuh", "stft_dft.cu",
                                  "ssq_stft.cu", "istft_ola.cu",
                                  "reassign_bwd.cu"])
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
            "ssq_istft_ola", "ssq_reassign_bwd",
            "ssq_reassign4_bwd"} <= set(_build._SIGNATURES)


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
