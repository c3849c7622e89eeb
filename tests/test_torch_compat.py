"""The port's drop-in `_rs` API (`ssqueeze_rs_tpu_torch.compat`) against
the JAX package's (`ssqueeze_rs_tpu.compat`) on the CPU (`device="cpu"`),
mirroring tests/test_compat.py's seven tests as parity tests, and the
`cache_wavelet=True` filterbank cache of `cwt` / `ssq_cwt` against the JAX
package's `_cache_filterbank`.

Tolerances:
  transforms     float64 on both sides: max|d| < 1e-10 of max|ref| (Tx:
                 the same nonzero pattern on >= 99.999 % of entries and
                 max|d| <= 1e-9 of sum|Tx|), as tests/test_torch_float64.py;
                 for the pure tone the pattern on the entries above 1e-12
                 of max|Tx| (below, entries hold only Wx at the rounding
                 floor, whose phase is noise in either package)
  freqs, scales  equal (host float64 planning on both sides)
  wavelets       host numpy on both sides: within 1e-12 of max|ref|
  cache          the cached Pw and Nyquist vector bitwise JAX's (the same
                 numpy float32 sampling); cwt / ssq_cwt with the cache
                 against without at tests/test_cwt.py's bars (Wx 1e-5 of
                 max|Wx|; the mean column-sum difference of |Tx| 1e-4 of
                 the mean column sum)
"""
import importlib

import numpy as np
import pytest
import torch

from ssqueeze_rs_tpu import compat as J
from ssqueeze_rs_tpu.wavelets.base import Wavelet as JWavelet
from ssqueeze_rs_tpu_torch import compat as T, cwt, mad_rms, ssq_cwt
from ssqueeze_rs_tpu_torch.scales import process_scales
from ssqueeze_rs_tpu_torch.utils.pad import p2up
from ssqueeze_rs_tpu_torch.wavelets import Wavelet

CPU = dict(device="cpu")
# the modules (the packages' `ops.cwt` names the function)
j_cwt_mod = importlib.import_module("ssqueeze_rs_tpu.ops.cwt")
t_cwt_mod = importlib.import_module("ssqueeze_rs_tpu_torch.ops.cwt")


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _close(ours, theirs, bar=1e-10):
    assert isinstance(ours, np.ndarray)
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    assert np.abs(ours - theirs).max() < bar * np.abs(theirs).max()


def _tx_close(ours, theirs, floor=0.0):
    """The float64 Tx bars; `floor`: the nonzero pattern is compared on
    entries above floor * max|Tx| only."""
    assert isinstance(ours, np.ndarray) and ours.dtype == np.complex128
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape
    top = floor * np.abs(theirs).max()
    assert ((np.abs(ours) > top) == (np.abs(theirs) > top)).mean() >= 0.99999
    assert np.abs(ours - theirs).max() <= 1e-9 * np.abs(theirs).sum()


def test_every_name_is_ported():
    assert T.__all__ == J.__all__
    assert np.array_equal(T._default_rust_scales(160_000),
                          J._default_rust_scales(160_000))
    assert len(T._default_rust_scales(160_000)) == 490
    assert np.array_equal(T._default_rust_scales(3), J._default_rust_scales(3))


def test_stft_signature_and_freqs():
    x = np.random.default_rng(0).standard_normal(1000)
    window = np.hanning(257)[:-1]
    Sx, freqs = T.stft(x, 256, 64, window, "reflect", **CPU)
    Sj, fj = J.stft(x, 256, 64, window, "reflect")
    assert Sx.shape == (129, (1000 - 1) // 64 + 1)
    assert np.array_equal(freqs, fj)
    assert np.allclose(freqs, np.linspace(0, 0.5, 129))
    _close(Sx, Sj)


def test_cwt_and_icwt_roundtrip():
    t = np.linspace(0, 10, 2048, endpoint=False)
    x = np.cos(2 * np.pi * 3 * np.exp(t / 3))
    Wx, scales, dWx = T.cwt(x, "gmw", nv=32, **CPU)
    Wj, sj, _ = J.cwt(x, "gmw", nv=32)
    assert dWx is None
    assert np.array_equal(scales, sj)
    assert np.isclose(scales[0], 2.0) and np.isclose(scales[-1], len(x) / 2)
    _close(Wx, Wj)
    xr = T.icwt(Wx, "gmw", scales=scales, **CPU)
    _close(xr, J.icwt(Wj, "gmw", scales=sj))
    assert mad_rms(x, xr) < 0.2
    # the default scales and the derivative (a 3-tuple either way)
    _close(T.icwt(Wx, "gmw", **CPU), J.icwt(Wj, "gmw"))
    Wd, _, dW = T.cwt(x, "gmw", nv=32, derivative=True, **CPU)
    Wdj, _, dWj = J.cwt(x, "gmw", nv=32, derivative=True)
    _close(Wd, Wdj)
    _close(dW, dWj)
    # cwt_simd is an alias
    assert T.cwt_simd is T.cwt
    Wx2, _, _ = T.cwt_simd(x, "gmw", nv=32, **CPU)
    assert np.array_equal(Wx, Wx2)


def test_ssq_cwt_returns_pair():
    t = np.linspace(0, 1, 1024, endpoint=False)
    x = np.cos(2 * np.pi * 100 * t)
    Tx, ssq_freqs = T.ssq_cwt(x, "gmw", fs=1024.0, **CPU)
    Tj, fj = J.ssq_cwt(x, "gmw", fs=1024.0)
    assert Tx.shape[1] == len(x) and len(ssq_freqs) == Tx.shape[0]
    assert np.array_equal(ssq_freqs, fj)
    # a pure tone: 0.19 % of the entries hold only contributions of Wx at
    # the rounding floor (|Wx| far below 1e-12 of its largest, above
    # gamma = 10 EPS64), whose phase is rounding noise in either package;
    # the bins are held on the entries above 1e-12 of max|Tx|
    _tx_close(Tx, Tj, floor=1e-12)


def test_ssq_stft_returns_pair():
    x = np.random.default_rng(1).standard_normal(512)
    window = np.hanning(129)[:-1]
    Tx, freqs = T.ssq_stft(x, window, n_fft=128, **CPU)
    Tj, fj = J.ssq_stft(x, window, n_fft=128)
    assert Tx.shape == (65, 512) and len(freqs) == 65
    assert np.array_equal(freqs, fj)
    _tx_close(Tx, Tj)


def test_wavelet_functions():
    w = np.linspace(0, 20, 500)
    for name in ("morlet", "gmw"):
        _close(getattr(T, name)(w), getattr(J, name)(w), 1e-12)
    _close(T.morlet(w, mu=6.0, dtype="float32"),
           J.morlet(w, mu=6.0, dtype="float32"), 1e-12)
    for kind in ("peak", "energy"):
        assert T.gmw_center_frequency(3.0, 60.0, kind) == \
            J.gmw_center_frequency(3.0, 60.0, kind)
    for name in ("gmw_freq", "gmw_time", "morlet_freq", "morlet_time"):
        _close(getattr(T, name)(n=512, scale=8.0),
               getattr(J, name)(n=512, scale=8.0), 1e-12)
    _close(T.gmw_freq(n=511, scale=3.0, gamma=4.0, beta=20.0, order=1,
                      dtype="float32"),
           J.gmw_freq(n=511, scale=3.0, gamma=4.0, beta=20.0, order=1,
                      dtype="float32"), 1e-12)
    pt = T.gmw_time(n=512, scale=8.0)
    assert abs(np.argmax(np.abs(pt)) - 256) <= 1


def test_pad_signal():
    x = np.arange(1.0, 5.0)
    for padtype in ("reflect", "symmetric", "zero", "replicate"):
        xp = T.pad_signal(x, padtype, padlength=11, **CPU)
        assert isinstance(xp, np.ndarray) and len(xp) == 11
        assert np.array_equal(xp, J.pad_signal(x, padtype, padlength=11))


def test_hello():
    assert "torch" in T.hello_from_bin()


# -- cache_wavelet ----------------------------------------------------------------
@pytest.mark.parametrize("wavelet", ["gmw", "morlet"])
def test_cached_filterbank_is_jax_bitwise(wavelet):
    N = 3000
    M = p2up(N)[0]
    scales = process_scales("log-piecewise", N, Wavelet.build(wavelet),
                            nv=8).squeeze(-1)
    Pw, pnyq = t_cwt_mod.cache_filterbank(Wavelet.build(wavelet), scales, M,
                                          "cpu")
    token = j_cwt_mod._cache_filterbank(JWavelet.build(wavelet), scales, M)
    Pj, pj = j_cwt_mod._FB_CACHE[token]
    assert Pw.dtype == pnyq.dtype == torch.float32
    assert np.array_equal(Pw.numpy(), Pj)
    assert np.array_equal(pnyq.numpy(), pj)


@pytest.mark.parametrize("derivative", [False, True])
def test_cwt_with_cache_matches_without(derivative):
    """tests/test_cwt.py's cache test: Wx (and dWx) within 1e-5."""
    x = np.random.default_rng(2).standard_normal(4096).astype(np.float32)
    kw = dict(nv=16, derivative=derivative, **CPU)
    ref = cwt(x, **kw)
    out = cwt(x, cache_wavelet=True, **kw)
    for a, b in zip(out[::2], ref[::2]):
        assert (a - b).abs().max() < 1e-5 * b.abs().max()
    # the complex-psih route ignores the cache, as in the JAX package
    n_before = len(t_cwt_mod._FB_CACHE)
    out = cwt(x, ("bump", {"om": 0.5}), cache_wavelet=True, nv=8, **CPU)
    assert len(t_cwt_mod._FB_CACHE) == n_before
    assert torch.equal(out[0], cwt(x, ("bump", {"om": 0.5}), nv=8,
                                   **CPU)[0])


@pytest.mark.parametrize("opts", [{}, {"get_dWx": True},
                                  {"squeezing": "lebesgue"}],
                         ids=["phase", "get_dWx", "lebesgue"])
def test_ssq_cwt_with_cache_matches_without(opts):
    """tests/test_cwt.py's setup and bars, through kernel A (or D) fed the
    cached filterbank: Wx within 1e-5 of max|Wx|, the mean column-sum
    difference of |Tx| within 1e-4 of the mean column sum."""
    x = np.random.default_rng(3).standard_normal(4000).astype(np.float32)
    kw = dict(scales="log", fs=1.0, **opts, **CPU)
    wav = ("gmw", {"beta": 8.0})
    Tx, Wx, *_ = ssq_cwt(x, wav, **kw)
    Tc, Wc, *_ = ssq_cwt(x, wav, cache_wavelet=True, **kw)
    assert (Wc - Wx).abs().max() < 1e-5 * Wx.abs().max()
    cs, cs_c = Tx.abs().sum(-2), Tc.abs().sum(-2)
    assert (cs - cs_c).abs().mean() < 1e-4 * cs.mean()


def test_filterbank_cache_lru():
    """At most 8 entries, least recently used out first, keyed on the full
    (name, params, scales, M) tuple and the device."""
    t_cwt_mod._FB_CACHE.clear()
    wav = Wavelet.build("gmw")
    sc = np.geomspace(2.0, 100.0, 12)
    first = t_cwt_mod.cache_filterbank(wav, sc, 1024, "cpu")
    assert t_cwt_mod.cache_filterbank(wav, sc, 1024, "cpu") is first
    # scales differing in one entry, another M, another wavelet's params:
    # each its own entry
    sc2 = sc.copy()
    sc2[-1] *= 1 + 1e-15
    keys = [(wav, sc2, 1024), (wav, sc, 2048),
            (Wavelet.build(("gmw", {"beta": 8.0})), sc, 1024)]
    for w, s, M in keys:
        assert t_cwt_mod.cache_filterbank(w, s, M, "cpu") is not first
    assert len(t_cwt_mod._FB_CACHE) == 4
    for k in range(10):
        t_cwt_mod.cache_filterbank(wav, sc[:k + 2], 1024, "cpu")
        assert len(t_cwt_mod._FB_CACHE) == min(4 + k + 1, 8)
    assert len(t_cwt_mod._FB_CACHE) == t_cwt_mod._FB_CACHE_MAX == 8
    key = (wav.name, wav.params, sc.tobytes(), 1024, "cpu")
    assert key not in t_cwt_mod._FB_CACHE       # the oldest went first
    last = (wav.name, wav.params, sc[:11].tobytes(), 1024, "cpu")
    assert list(t_cwt_mod._FB_CACHE)[-1] == last
