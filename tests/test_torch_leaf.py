"""The port's leaf modules against the JAX package's, on the CPU: the
test signals (`TestSignals`) and `toolkit`, the TKEO, the utils
(`est_riskshrink_thresh`, the replacers, `buffer` / `unbuffer`, the
window resolutions, `afftshift`, the FFT wrappers, `find_closest*`,
`unpad`) and `scale_to_freq` / `freq_to_scale`.

Tolerances: the test signals and toolkit signals are the same host numpy
code, so bitwise equal; so are `find_closest*` and the window and scale
conversions (host float64, equal to 1e-12 relative). The TKEO,
`est_riskshrink_thresh` and `buffer` / `unbuffer` on float32 tensors
agree with the JAX package to 5e-6 relative (float32 products and sums
rounded in their own order).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ssqueeze_rs_tpu as J
import ssqueeze_rs_tpu_torch as T
from ssqueeze_rs_tpu import toolkit as jtk
from ssqueeze_rs_tpu.utils import closest as jcl, fft as jfft, pad as jpad
from ssqueeze_rs_tpu.utils import common as jcommon, windows as jwin
from ssqueeze_rs_tpu_torch import toolkit as ttk
from ssqueeze_rs_tpu_torch.utils import closest as tcl, fft as tfft
from ssqueeze_rs_tpu_torch.utils import common as tcommon, pad as tpad
from ssqueeze_rs_tpu_torch.utils import windows as twin

REL32 = 5e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("name", J.TestSignals.SUPPORTED)
def test_signal_bank_bitwise(name):
    for N in (256, 301):
        ours = T.TestSignals(N, snr=10, seed=3).make_signals(name,
                                                             get_params=True)
        theirs = J.TestSignals(N, snr=10, seed=3).make_signals(
            name, get_params=True)
        assert ours.keys() == theirs.keys()
        for k in ours:
            assert np.array_equal(ours[k][0], theirs[k][0])
            assert np.array_equal(ours[k][1], theirs[k][1])
            assert ours[k][2] == theirs[k][2]


def test_signal_bank_specs_and_plots():
    """(name, kwargs) specs and 'carrier:am' compositions as in the JAX
    package; the plotting methods draw, headless (tests/test_torch_visuals.py
    holds what they draw to the JAX package's)."""
    specs = [("lchirp", dict(fmin=5, fmax=50)), "cosine:am-cosine",
             ("sine", dict(f=7)), "par-lchirp"]
    for ours, theirs in zip(T.TestSignals(512).make_signals(specs),
                            J.TestSignals(512).make_signals(specs)):
        assert np.array_equal(ours, theirs)
    import warnings
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    ts = T.TestSignals(256)
    for call in (lambda: ts.demo("cosine"),
                 lambda: ts.test_transforms(
                     lambda x, t, p: (np.outer(x, x), {}), "cosine"),
                 lambda: ts.wavcomp("gmw", "cosine", device="cpu"),
                 lambda: ts.cwt_vs_stft("gmw", None, "cosine", device="cpu"),
                 lambda: ts.ridgecomp("lchirp", device="cpu")):
        plt.close("all")
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*non-interactive.*")
            call()
        assert plt.get_fignums()
    plt.close("all")


def test_toolkit_bitwise():
    for f in ("cos_f", "sin_f"):
        assert np.array_equal(getattr(ttk, f)([1, 3, 5], N=100, phi=0.1),
                              getattr(jtk, f)([1, 3, 5], N=100, phi=0.1))
    Tx = np.random.default_rng(0).standard_normal((40, 300))
    for a, b in zip(ttk.lin_band(torch.as_tensor(Tx), 0.2, 0.1, bw=0.05),
                    jtk.lin_band(Tx, 0.2, 0.1, bw=0.05)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(ttk.where_amax(torch.as_tensor(Tx)), jtk.where_amax(Tx)):
        assert np.array_equal(a, b)
    # viz=True plots |Tx| and the band (tests/test_torch_visuals.py)
    import warnings
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*non-interactive.*")
        band = ttk.lin_band(torch.as_tensor(Tx), 0.2, 0.1, viz=True)
    assert plt.get_fignums() and all(
        np.array_equal(a, b) for a, b in zip(band, jtk.lin_band(Tx, 0.2,
                                                                0.1)))
    plt.close("all")


@pytest.mark.parametrize("shape", [(64,), (3, 2, 101)])
def test_tkeo(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    for name in ("tkeo", "tkeo_modified"):
        ours = getattr(T, name)(torch.as_tensor(x))
        theirs = np.asarray(getattr(J, name)(jnp.asarray(x)))
        assert ours.shape == theirs.shape and ours.dtype == torch.float32
        assert _rel(ours, theirs) <= REL32
        assert torch.equal(getattr(T, name)(x, device="cpu"), ours)


def test_tkeo_short_signals_raise_the_jax_errors():
    for name, n in (("tkeo", 2), ("tkeo_modified", 4)):
        with pytest.raises(ValueError) as ours:
            getattr(T, name)(torch.zeros(n))
        with pytest.raises(ValueError) as theirs:
            getattr(J, name)(jnp.zeros(n))
        assert str(ours.value) == str(theirs.value)


def test_est_riskshrink_thresh():
    rng = np.random.default_rng(2)
    Wx = (rng.standard_normal((2, 40, 500)) +
          1j * rng.standard_normal((2, 40, 500))).astype(np.complex64)
    theirs = J.est_riskshrink_thresh(Wx, 16)
    assert T.est_riskshrink_thresh(Wx, 16) == theirs
    ours = T.est_riskshrink_thresh(torch.as_tensor(Wx), 16)
    assert isinstance(ours, torch.Tensor) and ours.ndim == 0
    assert abs(float(ours) - theirs) <= REL32 * theirs


@pytest.mark.parametrize("name", ["replace_at_inf_or_nan", "replace_at_inf",
                                  "replace_at_nan", "replace_at_value",
                                  "replace_under_abs"])
def test_replacers(name):
    x = np.array([1.0, np.inf, -np.inf, np.nan, 0.0, 1e-9, -3.0, 2.5])
    ref = x[::-1].copy()
    kw = (dict(value=2.5, replacement=-7.0) if name == "replace_at_value"
          else dict(value=1e-6, replacement=9.0) if name == "replace_under_abs"
          else dict(replacement=4.0))
    for r in (None, ref):
        theirs = getattr(J, name)(x, r, **kw)
        np.testing.assert_array_equal(getattr(T, name)(x, r, **kw), theirs)
        ours = getattr(T, name)(torch.as_tensor(x), r, **kw)
        assert isinstance(ours, torch.Tensor)
        np.testing.assert_array_equal(ours.numpy(), theirs)


@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("seg_len, n_overlap", [(16, 12), (15, 10), (8, 0)])
def test_buffer_unbuffer(seg_len, n_overlap, modulated):
    x = np.random.default_rng(4).standard_normal((2, 200)).astype(np.float32)
    theirs = jwin.buffer(x, seg_len, n_overlap, modulated)
    assert np.array_equal(twin.buffer(x, seg_len, n_overlap, modulated),
                          theirs)
    ours = twin.buffer(torch.as_tensor(x), seg_len, n_overlap, modulated)
    assert ours.shape == theirs.shape and np.array_equal(ours.numpy(), theirs)
    hop = seg_len - n_overlap
    window = np.hanning(seg_len).astype(np.float32)
    for win_exp in (0, 1, 2):
        ref = jwin.unbuffer(theirs[0], window, hop, seg_len, 200, win_exp)
        assert np.array_equal(
            twin.unbuffer(theirs[0], window, hop, seg_len, 200, win_exp), ref)
        got = twin.unbuffer(torch.as_tensor(theirs[0]), window, hop, seg_len,
                            200, win_exp)
        assert _rel(got, ref) <= REL32


@pytest.mark.parametrize("n", [64, 127])
def test_window_resolution_and_area(n):
    window = np.hanning(n)
    for a, b in zip(T.window_resolution(window),
                    J.window_resolution(window)):
        assert np.isclose(a, b, rtol=1e-12, atol=0)
    for kw in (dict(), dict(time=False, frequency=True),
               dict(frequency=True)):
        ours = np.atleast_1d(twin.window_area(window, **kw))
        theirs = np.atleast_1d(jwin.window_area(window, **kw))
        np.testing.assert_allclose(ours, theirs, rtol=1e-12, atol=0)


@pytest.mark.parametrize("N", [8, 9, 64, 65])
def test_analytic_shifts(N):
    assert np.array_equal(T.afftshift_idx(N), J.afftshift_idx(N))
    x = np.random.default_rng(N).standard_normal((3, N))
    for f in ("afftshift", "aifftshift"):
        theirs = getattr(jfft, f)(x)
        assert np.array_equal(getattr(tfft, f)(x), theirs)
        assert np.array_equal(getattr(tfft, f)(torch.as_tensor(x)).numpy(),
                              theirs)


def test_fft_wrappers_and_object():
    """The FFT entry points on torch.fft, on a CPU tensor, against the JAX
    package's (float64: equal to 1e-12 relative); `FFT` takes and
    validates `patience` as the JAX object does, and wisdom is a no-op."""
    x = np.random.default_rng(5).standard_normal((4, 64))
    xt = torch.as_tensor(x)
    pairs = [(tfft.fft(xt), jfft.fft(x)), (tfft.rfft(xt), jfft.rfft(x)),
             (tfft.ifft(xt), jfft.ifft(x)),
             (tfft.irfft(tfft.rfft(xt), n=64), jfft.irfft(jfft.rfft(x), n=64)),
             (tfft.fftshift(xt), jfft.fftshift(x)),
             (tfft.ifftshift(xt), jfft.ifftshift(x)),
             (tfft.FFT_GLOBAL.rfft(xt), jfft.FFT_GLOBAL.rfft(x))]
    for ours, theirs in pairs:
        assert _rel(np.abs(ours.numpy()), np.abs(np.asarray(theirs))) <= 1e-12
        assert np.allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                           atol=1e-12 * np.abs(np.asarray(theirs)).max())
    f = tfft.FFT(patience=(1, 30))
    assert f.patience == 1 and f.planning_timelimit == 30
    assert f.load_wisdom() is None and f.save_wisdom() is None
    for bad in (3, (0, 5), (1, 2, 3)):
        with pytest.raises(ValueError):
            tfft.FFT(patience=bad)
    assert f.threads >= 1


@pytest.mark.parametrize("logscale", [False, True])
def test_find_closest(logscale):
    rng = np.random.default_rng(6)
    v = (np.geomspace(0.1, 10, 50) if logscale else np.linspace(0.1, 10, 50))
    a = rng.uniform(0.05, 12, (30, 40))
    for f in ("find_closest_brute", "find_closest_smart"):
        assert np.array_equal(getattr(tcl, f)(a, v), getattr(jcl, f)(a, v))
    fn = "find_closest_log" if logscale else "find_closest_lin"
    assert np.array_equal(getattr(tcl, fn)(a, v), getattr(jcl, fn)(a, v))
    for smart in (None, False):
        assert np.array_equal(tcl.find_closest(a, v, logscale, smart=smart),
                              jcl.find_closest(a, v, logscale, smart=smart))


def test_small_helpers():
    x = np.arange(20.0)
    assert np.array_equal(tpad.unpad(torch.as_tensor(x), 3, 10).numpy(),
                          jpad.unpad(x, 3, 10))
    assert T.pi == J.pi
    # no card here: the budget warning is silent, as the JAX one off-TPU
    tcommon.warn_hbm_budget(10 ** 9, 10 ** 4)
    assert tcommon.find_closest_parallel_is_faster((20, 30),
                                                   verbose=0) is False
    assert jcommon.find_closest_parallel_is_faster((20, 30),
                                                   verbose=0) is False


@pytest.mark.parametrize("freqs", [np.linspace(0.01, 0.4, 12),
                                   np.geomspace(0.005, 0.5, 9)])
def test_scale_frequency_conversions(freqs):
    for wavelet in ("gmw", ("morlet", {"mu": 6.0})):
        ours = T.freq_to_scale(freqs, wavelet, 512, n_search_scales=60)
        theirs = J.freq_to_scale(freqs, wavelet, 512, n_search_scales=60)
        np.testing.assert_allclose(ours, theirs, rtol=1e-12, atol=0)
        for padtype in ("reflect", None):
            np.testing.assert_array_equal(
                T.scale_to_freq(ours, wavelet, 512, fs=2.0, padtype=padtype),
                J.scale_to_freq(ours, wavelet, 512, fs=2.0, padtype=padtype))
