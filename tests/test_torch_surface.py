"""The port's public surface against the JAX package's, on the CPU: the
names the port exports with the JAX signatures (apart from `device`;
for a module, its `__all__` and the signature of each name in it), the
`Wavelet` members with their kinds and signatures (all but `viz` and
`VISUALS`, which wait for `visuals`), `morsefreq` with every `n_out`, and
a guard that no module of the port, nor chip_smoke.py, imports JAX or the
JAX package.

Tolerances: `morsefreq` is host float64 scipy in both packages, computed
in the same order, so equal.
"""
import importlib
import inspect
import json
import os
import types
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import ssqueeze_rs_tpu as J
import ssqueeze_rs_tpu_torch as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXPORTED = ["DEFAULTS", "EPS32", "EPS64", "mad", "WARN", "NOTE", "p2up",
            "padsignal", "window_norm", "xifn", "aifftshift_idx",
            "make_scales", "cwt_scalebounds", "infer_scaletype",
            "logscale_transition_idx", "find_maximum",
            "find_first_occurrence", "morsefreq", "gmw_k_constants",
            "morseafun", "pi", "wavs", "morlet", "bump", "cmhat", "hhhat",
            "gmw", "gmw_l1", "gmw_l2", "gmw_l1_k", "gmw_l2_k", "compute_gmw",
            "morsewave", "laguerre", "freq_resolution",
            "est_riskshrink_thresh", "replace_at_inf", "replace_at_nan",
            "replace_at_inf_or_nan", "replace_at_value", "replace_under_abs",
            "afftshift_idx", "window_resolution", "tkeo", "tkeo_modified",
            "extract_ridges", "ridge", "TestSignals", "signals", "toolkit",
            "experimental", "scale_to_freq", "freq_to_scale", "algos",
            "compat"]

# the JAX package's public names the port leaves to later items (ROADMAP
# Queue 1 items 7 and 9)
NOT_YET = {"io", "ParquetRecording", "parquet_to_raw", "visuals"}
WAVELET_NOT_YET = {"viz", "VISUALS"}


def _same_signature(ours, theirs):
    sig = inspect.signature(ours)
    params = [p for p in sig.parameters.values() if p.name != "device"]
    return sig.replace(parameters=params) == inspect.signature(theirs)


@pytest.mark.parametrize("name", EXPORTED)
def test_exported_with_the_jax_signature(name):
    assert name in T.__all__
    ours, theirs = getattr(T, name), getattr(J, name)
    if isinstance(theirs, types.ModuleType):
        assert isinstance(ours, types.ModuleType)
        assert ours.__all__ == theirs.__all__
        for sub in theirs.__all__:
            a, b = getattr(ours, sub), getattr(theirs, sub)
            if callable(b) and not isinstance(b, type):
                assert _same_signature(a, b), sub
        return
    if isinstance(theirs, type):
        members = [m for m in dir(theirs) if not m.startswith("_")]
        for m in members:
            a, b = getattr(ours, m), getattr(theirs, m)
            if callable(b):
                assert _same_signature(a, b), m
        return
    if not callable(theirs):
        assert type(ours) is type(theirs)
        assert (sorted(ours) == sorted(theirs) if isinstance(theirs, dict)
                else ours == theirs)
        return
    assert _same_signature(ours, theirs)


# port-only keyword arguments a signature may add after the JAX ones: the
# device of the port's entry points, and cwt_core's cached filterbank
PORT_ONLY = {"device", "filterbank"}
J_OPS = importlib.import_module("ssqueeze_rs_tpu.ops")
T_OPS = importlib.import_module("ssqueeze_rs_tpu_torch.ops")
J_PAR = importlib.import_module("ssqueeze_rs_tpu.parallel")
T_PAR = importlib.import_module("ssqueeze_rs_tpu_torch.parallel")


def _same_but_port_only(ours, theirs):
    sig = inspect.signature(ours)
    params = [p for p in sig.parameters.values() if p.name not in PORT_ONLY]
    return sig.replace(parameters=params) == inspect.signature(theirs)


def test_ops_and_parallel_names_match_jax():
    """The `ops` and `parallel` subpackages export the JAX package's names,
    in its order."""
    assert T_OPS.__all__ == J_OPS.__all__
    assert T_PAR.__all__ == J_PAR.__all__


@pytest.mark.parametrize("name", J_OPS.__all__)
def test_ops_signature_matches_jax(name):
    assert _same_but_port_only(getattr(T_OPS, name), getattr(J_OPS, name))


def test_ops_ssqueeze_reassign_is_the_jax_one():
    """ops.ssqueeze.reassign takes complex Wx (the JAX signature), not the
    planes of the kernel wrapper `reassign_cuda.reassign`."""
    ours = importlib.import_module("ssqueeze_rs_tpu_torch.ops.ssqueeze")
    theirs = importlib.import_module("ssqueeze_rs_tpu.ops.ssqueeze")
    assert "reassign" in ours.__all__
    assert inspect.signature(ours.reassign) == \
        inspect.signature(theirs.reassign)
    assert ours.reassign is T_OPS.reassign


@pytest.mark.parametrize("name", J_PAR.__all__)
def test_parallel_signature_matches_jax(name):
    assert _same_signature(getattr(T_PAR, name), getattr(J_PAR, name))


def test_every_public_name_but_the_later_items():
    """In a fresh process: a long one has more of the JAX package's
    submodules imported (and so listed by dir) than its __init__ imports."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {REPO!r})
        import ssqueeze_rs_tpu as J, ssqueeze_rs_tpu_torch as T
        names = lambda m: {{n for n in dir(m) if not n.startswith("_")}}
        print(json.dumps(sorted(names(J) - names(T))))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-3000:]
    assert set(json.loads(res.stdout.strip().splitlines()[-1])) == NOT_YET
    assert set(EXPORTED) <= set(T.__all__)


def test_wavelet_members_match_jax():
    """Every public member of the JAX `Wavelet` but viz/VISUALS, of the
    same kind (property, cached property, method, static method, value)
    and, for callables, the same signature apart from `device`."""
    names = {m for m in dir(J.Wavelet) if not m.startswith("_")}
    assert names - WAVELET_NOT_YET <= set(dir(T.Wavelet))
    for m in sorted(names - WAVELET_NOT_YET):
        a = inspect.getattr_static(T.Wavelet, m)
        b = inspect.getattr_static(J.Wavelet, m)
        assert type(a) is type(b), m
        fa, fb = getattr(a, "__func__", a), getattr(b, "__func__", b)
        if isinstance(b, property) or not callable(fb):
            if not isinstance(b, property) and not hasattr(b, "func"):
                assert a == b, m
            continue
        assert _same_signature(fa, fb), m


@pytest.mark.parametrize("n_out", [1, 2, 3, 4])
@pytest.mark.parametrize("gamma, beta", [(3, 60), (2, 5), (3.5, 20),
                                         (1.5, 2)])
def test_morsefreq_matches_jax(gamma, beta, n_out):
    ours = T.morsefreq(gamma, beta, n_out=n_out)
    theirs = J.morsefreq(gamma, beta, n_out=n_out)
    if n_out == 1:
        ours, theirs = (ours,), (theirs,)
    assert len(ours) == len(theirs) == n_out
    assert all(float(a) == float(b) for a, b in zip(ours, theirs))


def test_xifn_takes_an_array_module():
    import torch
    for N in (8, 9):
        ref = J.xifn(0.5, N)
        assert np.array_equal(T.xifn(0.5, N), ref)
        t = T.xifn(0.5, N, xp=torch, dtype=torch.float64)
        assert np.array_equal(t.numpy(), ref)


def test_no_module_imports_jax():
    """Every module of the port and chip_smoke.py import in a process
    whose import system refuses `jax`, `jaxlib` and `ssqueeze_rs_tpu`."""
    code = textwrap.dedent(f"""
        import importlib, importlib.abc, pkgutil, sys
        REFUSED = ("jax", "jaxlib", "ssqueeze_rs_tpu")

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in REFUSED:
                    raise ImportError("refused: " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        sys.path.insert(0, {REPO!r})
        import ssqueeze_rs_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, "ssqueeze_rs_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = [m for m in sys.modules if m.split(".")[0] in REFUSED]
        assert not bad, bad
        print(len(names))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.strip().splitlines()[-1]) >= 30
