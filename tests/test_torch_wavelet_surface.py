"""The port's wavelet builders and `Wavelet` members against the JAX
package's, on the CPU: `morsewave`, `laguerre`, `compute_gmw`, the `gmw*`
and `morlet`/`bump`/`cmhat`/`hhhat` factories, `freq_resolution`, the
`Wavelet` state and resolution members, and custom callable wavelets
(through `cwt`, and the bounded registry).

Tolerances: the host functions are the same float64 numpy / scipy code
in both packages, so they agree to 1e-12 relative. The factories
evaluated on a tensor (torch on its device) at their default float64
agree with the JAX factory to 5e-6 relative; at float32 with the JAX
factory's float32 numpy to 2e-5 (log, exp and pow may round apart by an
ulp in each package, and the GMW exponent sums terms of order
beta ln w ~ 100 at beta = 60, so one ulp of a term moves psih by ~1e-5
relative). `cwt` with a custom callable agrees to 5e-6 of max|Wx|,
the port's bar for float32 transforms.
"""
import gc

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ssqueeze_rs_tpu as J
import ssqueeze_rs_tpu_torch as T
from ssqueeze_rs_tpu.wavelets import Wavelet as JW
from ssqueeze_rs_tpu_torch.wavelets import Wavelet as TW
from ssqueeze_rs_tpu_torch.wavelets import base as tbase

REL = 1e-12
SPECS = ["gmw", ("gmw", {"beta": 6.0}), ("gmw", {"order": 2}),
         ("gmw", {"norm": "energy", "gamma": 2.0, "beta": 8.0}),
         "morlet", "bump", "cmhat", "hhhat"]


def _close(a, b, rel=REL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    top = np.abs(b).max()
    assert np.abs(a - b).max() <= rel * (top if top > 0 else 1)


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("norm", ["bandpass", "energy"])
@pytest.mark.parametrize("N", [256, 255])
def test_morsewave(N, norm, K):
    freqs = [0.4, -1.1, 2.0]
    for ours, theirs in zip(T.morsewave(N, freqs, 3, 20, K, norm),
                            J.morsewave(N, freqs, 3, 20, K, norm)):
        _close(ours, theirs)


@pytest.mark.parametrize("k, c", [(0, 1.5), (3, 6.0), (6, 0.25)])
def test_laguerre(k, c):
    x = np.random.default_rng(k).uniform(0, 8, 97)
    _close(T.laguerre(x, k, c), J.laguerre(x, k, c))


@pytest.mark.parametrize("kw", [
    dict(), dict(time=True), dict(norm="energy", beta=10.0, time=True),
    dict(order=2, centered_scale=True), dict(norm="energy", norm_scale=False,
                                             centered_scale=True)])
@pytest.mark.parametrize("N, scale", [(512, 4.0), (511, 13.5)])
def test_compute_gmw(N, scale, kw):
    ours = T.compute_gmw(N, scale, **kw)
    theirs = J.compute_gmw(N, scale, **kw)
    for a, b in zip(ours if kw.get("time") else (ours,),
                    theirs if kw.get("time") else (theirs,)):
        _close(a, b)


FACTORIES = [("gmw", {}), ("gmw_l1", dict(beta=12.0)),
             ("gmw_l2", dict(beta=4.0)), ("gmw_l1_k", dict(k=2)),
             ("gmw_l2_k", dict(k=1, beta=5.0)), ("morlet", {}),
             ("morlet", dict(mu=6.0)), ("bump", {}),
             ("bump", dict(mu=3.0, s=0.5, om=0.2)), ("cmhat", {}),
             ("hhhat", dict(mu=3.0))]


@pytest.mark.parametrize("name, kw", FACTORIES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(FACTORIES)])
def test_factories(name, kw):
    """numpy input: equal to 1e-12; a float64 tensor (torch on its
    device, the factories' default dtype) within 5e-6 relative of the JAX
    factory; a float32 tensor (not for the energy norm, which both
    packages refuse in float32) within 2e-5 of the JAX factory in float32
    numpy."""
    w = np.random.default_rng(3).uniform(0.01, 20, 300)
    theirs = getattr(J, name)(**kw)(w)
    _close(getattr(T, name)(**kw)(w), theirs)
    t = getattr(T, name)(**kw)(torch.as_tensor(w))
    assert isinstance(t, torch.Tensor) and t.dtype in (torch.float64,
                                                       torch.complex128)
    assert np.abs(t.numpy() - theirs).max() <= 5e-6 * np.abs(theirs).max()
    if name.startswith("gmw_l2"):
        return
    theirs = np.asarray(getattr(J, name)(dtype="float32", **kw)(w))
    t = getattr(T, name)(dtype="float32", **kw)(
        torch.as_tensor(w, dtype=torch.float32))
    assert t.dtype in (torch.float32, torch.complex64)
    assert np.abs(t.numpy() - theirs).max() <= 2e-5 * np.abs(theirs).max()


def test_energy_float32_factory_refused():
    with pytest.raises(ValueError, match="float32"):
        T.gmw(norm="energy", dtype="float32")


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_wavelet_members(spec):
    """The state and resolution members on the same spec: equal to 1e-12
    (same host float64 code)."""
    ours, theirs = TW.build(spec), JW.build(spec)
    assert ours.config_str == theirs.config_str
    assert ours.dtype == theirs.dtype and ours.N == theirs.N
    assert ours.TF_PROPS == theirs.TF_PROPS
    for m in ("wc", "wc_ct", "scalec_ct"):
        assert np.isclose(getattr(ours, m), getattr(theirs, m), rtol=REL,
                          atol=0), m
    for m in ("std_t", "std_w", "std_f", "std_t_d", "std_w_d", "std_f_d",
              "harea"):
        assert np.isclose(getattr(ours, m)(N=512),
                          getattr(theirs, m)(N=512), rtol=REL, atol=0), m
    for kind in ("energy", "peak"):
        assert np.isclose(ours.center_frequency(scale=6.0, N=512, kind=kind),
                          theirs.center_frequency(scale=6.0, N=512,
                                                  kind=kind), rtol=REL)
    _close(ours.xi, theirs.xi)
    _close(ours.xifn(np.array([1.0, 2.5]), 64),
           theirs.xifn(np.array([1.0, 2.5]), 64))
    _close(ours.psifn(), theirs.psifn())
    _close(ours.psifn(scale=3.0, N=300), theirs.psifn(scale=3.0, N=300))
    w = np.linspace(-2, 30, 128)
    _close(ours.psifn(w), theirs.psifn(w))
    _close(ours.Psih(np.array([1.0, 4.0]), 256),
           theirs.Psih(np.array([1.0, 4.0]), 256))
    _close(ours.Psih(), theirs.Psih())
    _close(ours.sample(3.0, 128), theirs.sample(3.0, 128))
    _close(ours.psi_time(2.0, 129), theirs.psi_time(2.0, 129))


@pytest.mark.parametrize("spec", ["gmw", "morlet", "bump"])
@pytest.mark.parametrize("scale, N", [(10, 1024), (2.0, 512), (300.0, 1024)])
def test_freq_resolution(spec, scale, N):
    for force_int in (True, False):
        assert np.isclose(T.freq_resolution(spec, scale, N,
                                            force_int=force_int),
                          J.freq_resolution(spec, scale, N,
                                            force_int=force_int),
                          rtol=REL, atol=0)
    assert np.isclose(T.freq_resolution(spec, scale, N, nondim=False),
                      J.freq_resolution(spec, scale, N, nondim=False),
                      rtol=REL, atol=0)


def test_default_length_state_and_reset():
    """`N` is settable and moves `wc`; `reset_properties` recomputes for
    the current N; neither touches ==/hash; `info` prints the same
    summary; `isinstance_by_name` compares class names."""
    ours, theirs = TW.build("gmw"), JW.build("gmw")
    h = hash(ours)
    for w in (ours, theirs):
        w.N = 300
        w.reset_properties()
    assert ours.N == 300 and hash(ours) == h and ours == TW.build("gmw")
    assert np.isclose(ours.wc, theirs.wc, rtol=REL)
    with pytest.raises(Exception):
        ours.name = "morlet"
    assert T.wavelets.isinstance_by_name(ours, TW)
    assert not T.wavelets.isinstance_by_name(ours, JW)


def test_info_prints_the_jax_summary(capsys):
    TW.build("morlet").info(N=512)
    ours = capsys.readouterr().out
    JW.build("morlet").info(N=512)
    assert ours == capsys.readouterr().out and "Heisenberg" in ours


def test_wavs_lists_the_families():
    assert T.wavs()[:5] == J.wavs()[:5]


def test_custom_callable_through_cwt():
    """A custom psih through cwt in both packages, the JAX one written for
    jnp and the port's for torch (each package hands its callable numpy
    in host planning and its own array type in the transform), and one
    written with operators only, which both take as is."""
    x = np.random.default_rng(0).standard_normal(512).astype(np.float32)
    fj = lambda w: jnp.exp(-(jnp.abs(jnp.asarray(w)) - 5.0) ** 2) * \
        (jnp.asarray(w) > 0)  # noqa: E731
    ft = lambda w: torch.exp(-(torch.as_tensor(w).abs() - 5.0) ** 2) * \
        (torch.as_tensor(w) > 0)  # noqa: E731
    fa = lambda w: (w > 0) * w ** 2 / (1 + w ** 4)  # noqa: E731
    for theirs_fn, ours_fn in ((fj, ft), (fa, fa)):
        Wj, sj = J.cwt(x, theirs_fn, scales="log", dtype="float32")
        Wt, st = T.cwt(torch.as_tensor(x), ours_fn, scales="log")
        Wj = np.asarray(Wj)
        assert np.array_equal(st, sj)
        assert np.abs(Wt.numpy() - Wj).max() <= 5e-6 * np.abs(Wj).max()
    Tx, *_ = T.ssq_cwt(torch.as_tensor(x), ft, scales="log")
    assert bool(torch.isfinite(Tx).all())
    assert TW.build(ft).name == TW.build(ft).name


def test_callable_registry_bounded_and_robust():
    """An inline lambda stays usable after the caller drops it, the same
    callable maps to one family, the registry holds at most 64, and an
    evicted family fails with a clear message."""
    w = TW.build(lambda om: np.exp(-(om - 5.0) ** 2))
    gc.collect()
    assert np.isclose(w(np.array([4.0, 5.0]))[1], 1.0)
    before = len(tbase._FAMILIES)
    for i in range(2 * tbase._CUSTOM_MAX):
        TW.build(lambda om, i=i: np.exp(-(om - i) ** 2))
    assert len(tbase._CUSTOM_LRU) <= tbase._CUSTOM_MAX
    assert len(tbase._FAMILIES) <= before + tbase._CUSTOM_MAX
    with pytest.raises(RuntimeError, match="no longer registered"):
        TW(w.name, ()).psih(np.array([1.0]))
