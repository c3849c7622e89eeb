"""The torch port's `ssq_cwt` / `issq_cwt` end to end against the JAX
package's fused path (SSQ_TPU_MXU_FFT=1, SSQ_TPU_KERNELS=1: both Pallas
kernels in interpret mode), float32, GMW log-piecewise scales at nv = 4,
N = 9000 (the smallest N for which the JAX kernels build), on 1-D and
(2, N) input.

Tolerances (Tx is compared bin-flip tolerantly: an ulp of log2 or of the
phase can move a whole entry to the neighbouring bin):
  Tx   mean over columns of the relative error of sum_k |Tx| < 1e-4;
       |sum Tx - sum Tx_jax| < 1e-5 * sum |Tx_jax|; and against a float64
       transform, |sum Tx - S64| < 1e-5 * |S64| (sum Tx does not depend on
       the bins; zero-mean input cancels it to ~1e-3 of sum |Tx|, where
       the JAX kernel's bf16x3 products alone are 1.6e-5 of |S64| off)
  Wx   max|dWx| / max|Wx_jax| < 1e-5
  x    issq_cwt: max|dx| / max|x_jax| < 1e-5
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ssqueeze_rs_tpu import ssq_cwt as j_ssq_cwt, issq_cwt as j_issq_cwt
from ssqueeze_rs_tpu_torch import ssq_cwt, issq_cwt
from ssqueeze_rs_tpu_torch.trace import COUNTS
from ssqueeze_rs_tpu_torch.scales import process_scales
from ssqueeze_rs_tpu_torch.utils.fft import xifn
from ssqueeze_rs_tpu_torch.utils.pad import p2up
from ssqueeze_rs_tpu_torch.wavelets import Wavelet

N, NV, FS = 9000, 4, 1000.0
KW = dict(wavelet="gmw", scales="log-piecewise", nv=NV, fs=FS)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _signals():
    rng = np.random.default_rng(3)
    t = np.arange(N) / FS
    noise = rng.standard_normal(N)
    chirp = np.cos(2 * np.pi * (5 * t + 20 * t * t))
    return np.stack([noise, chirp]).astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    x = _signals()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SSQ_TPU_MXU_FFT", "1")
        mp.setenv("SSQ_TPU_KERNELS", "1")
        jax.clear_caches()
        jax_1d = j_ssq_cwt(x[0], dtype="float32", **KW)
        jax_2d = j_ssq_cwt(x, dtype="float32", **KW)
        jax_out = [[np.asarray(a) for a in r] for r in (jax_1d, jax_2d)]
    jax.clear_caches()
    return x, jax_out, [ssq_cwt(x[0], device="cpu", **KW),
                        ssq_cwt(x, device="cpu", **KW)]


def _sum64(x):
    """sum over all (row, column) of Wx * const from a float64 transform:
    what sum Tx is, whatever the bins."""
    wav = Wavelet.build("gmw", l1_norm=True)
    sc = process_scales("log-piecewise", N, wav, nv=NV)
    _, _, _, nv = process_scales(sc, N, get_params=True)
    M, n1, n2 = p2up(N)
    xh = np.fft.fft(np.pad(x.astype(np.float64), (n1, n2), mode="reflect"))
    psih = wav.psih(sc.astype(np.float32).astype(np.float64) * xifn(1, M), np)
    psih[:, M // 2] /= 2
    psih[:, M // 2 + 1:] = 0
    Wx = np.fft.ifft(psih * xh)[:, n1:n1 + N]
    const = np.broadcast_to(np.log(2) / np.asarray(nv).squeeze(), (len(sc),))
    return (Wx * const[:, None]).sum()


@pytest.mark.parametrize("batched", [False, True])
def test_ssq_cwt_matches_jax(runs, batched):
    x, jax_out, torch_out = runs
    Tx_j, Wx_j, f_j, s_j = jax_out[batched]
    Tx, Wx, f, s = torch_out[batched]
    assert isinstance(f, np.ndarray) and isinstance(s, np.ndarray)
    assert np.array_equal(f, f_j) and np.array_equal(s, s_j)
    assert Tx.dtype == Wx.dtype == torch.complex64
    Tx, Wx = Tx.numpy(), Wx.numpy()
    Tx_j, Wx_j = Tx_j[..., :N], Wx_j[..., :N]
    assert Tx.shape == Tx_j.shape and Wx.shape == Wx_j.shape
    assert Tx.shape[-1] == N and Tx.ndim == (3 if batched else 2)

    assert np.abs(Wx - Wx_j).max() / np.abs(Wx_j).max() < 1e-5
    cs, cs_j = np.abs(Tx).sum(-2), np.abs(Tx_j).sum(-2)
    assert np.mean(np.abs(cs - cs_j) / cs_j) < 1e-4
    for a, b in zip(Tx.reshape((-1,) + Tx.shape[-2:]),
                    Tx_j.reshape((-1,) + Tx.shape[-2:])):
        assert abs(a.sum() - b.sum()) < 1e-5 * np.abs(b).sum()


def test_total_against_float64(runs):
    x, _, torch_out = runs
    s64 = _sum64(x[0])
    assert abs(torch_out[0][0].numpy().sum() - s64) < 1e-5 * abs(s64)


def test_batch_equals_single(runs):
    """Row 0 of the batched call is the single call, up to float32 FFT
    rounding (a batched FFT may be planned differently): 1e-6 of max|Wx|,
    and bin-flip-tolerant on Tx."""
    _, _, (one, two) = runs
    np.testing.assert_allclose(two[1][0].numpy(), one[1].numpy(), rtol=0,
                               atol=1e-6 * float(one[1].abs().max()))
    cs1 = one[0].abs().sum(-2)
    cs2 = two[0][0].abs().sum(-2)
    assert float(((cs1 - cs2).abs() / cs1).mean()) < 1e-5


def test_issq_cwt_matches_jax(runs):
    x, jax_out, torch_out = runs
    for Tx_j, out in zip((jax_out[0][0], jax_out[1][0]),
                         (torch_out[0][0], torch_out[1][0])):
        xr_j = np.asarray(j_issq_cwt(jnp.asarray(Tx_j), "gmw"))
        xr = issq_cwt(out, "gmw").numpy()
        assert xr.shape == xr_j.shape
        assert np.abs(xr - xr_j).max() / np.abs(xr_j).max() < 1e-5


def test_sine_probe():
    """100 Hz sine at fs = 1000: the ssq peak lands within 1 % of 100 Hz
    and the inversion reconstructs it."""
    x = np.cos(2 * np.pi * 100 * np.arange(N) / FS).astype(np.float32)
    before = (COUNTS["launch.ssq_cwt_phase"], COUNTS["launch.ssq_reassign"])
    Tx, _, f, _ = ssq_cwt(torch.as_tensor(x), "gmw", fs=FS)
    assert (COUNTS["launch.ssq_cwt_phase"],
            COUNTS["launch.ssq_reassign"]) == before
    assert Tx.device.type == "cpu" and bool(torch.isfinite(Tx).all())
    peak = f[int(Tx.abs().mean(-1).argmax())]
    assert abs(peak - 100) < 1.0
    xr = issq_cwt(Tx, "gmw").numpy()
    assert np.mean(np.abs(x - xr)) / np.sqrt(np.mean(x ** 2)) < 1e-3


def _double(W):
    return W * 2


# fixed ids: every xdist worker must collect the same names. Every option
# the port once refused keeps its id and now runs.
UNPORTED = {
    "float64": dict(dtype="float64"),
    "order1": dict(order=1),
    "order01": dict(order=(0, 1)),
    "get_w": dict(get_w=True),
    "get_dWx": dict(get_dWx=True),
    "phase": dict(difftype="phase", get_w=True),
    "numeric": dict(difftype="numeric", get_w=True),
    "lebesgue": dict(squeezing="lebesgue"),
    "abs": dict(squeezing="abs"),
    "callable_squeezing": dict(squeezing=_double),
    "complex_psih": dict(wavelet=("bump", {"om": 0.5})),
    "callable_wavelet": dict(wavelet=lambda w: (w > 0) * w**2 / (1 + w**4)),
    "no_pad_not_pow2": dict(padtype=None),
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_options_raise(name):
    """Every option the port once refused runs on the CPU, custom callable
    wavelets included, and gives a finite Tx; float64 (the squeeze in
    double) gives complex128 outputs within 1e-10 of the JAX package's
    float64 ssq_cwt (Tx: max|d| <= 1e-9 of sum|Tx|)."""
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    out = ssq_cwt(torch.as_tensor(x), **UNPORTED[name])
    assert out[0].shape[-1] == 1000 and bool(torch.isfinite(out[0]).all())
    assert out[1].shape[-1] == 1000
    if name == "float64":
        ref = j_ssq_cwt(x, **UNPORTED[name])
        assert out[0].dtype == out[1].dtype == torch.complex128
        Tx, Tx_j = out[0].numpy(), np.asarray(ref[0])
        assert np.abs(Tx - Tx_j).max() <= 1e-9 * np.abs(Tx_j).sum()
        Wx_j = np.asarray(ref[1])
        assert np.abs(out[1].numpy() - Wx_j).max() < 1e-10 * np.abs(Wx_j).max()
        assert np.array_equal(out[2], ref[2])


def test_cache_wavelet_raises():
    """`cache_wavelet=True` (once refused) runs kernel A's plain version on
    the cached filterbank, against the JAX package's cached ssq_cwt at
    tests/test_cwt.py's bars: Wx within 1e-5 of max|Wx|, the mean
    column-sum difference of |Tx| within 1e-4 of the mean column sum."""
    x = np.random.default_rng(3).standard_normal(4000).astype(np.float32)
    kw = dict(scales="log", fs=1.0, cache_wavelet=True)
    wav = ("gmw", {"beta": 8.0})
    Tx, Wx, f, _ = ssq_cwt(torch.as_tensor(x), wav, **kw)
    Tx_j, Wx_j, f_j, _ = (np.asarray(a) for a in j_ssq_cwt(
        x, wav, dtype="float32", **kw))
    assert np.array_equal(f, f_j)
    Wx_j = Wx_j[..., :Wx.shape[-1]]
    assert np.abs(Wx.numpy() - Wx_j).max() < 1e-5 * np.abs(Wx_j).max()
    cs, cs_j = np.abs(Tx.numpy()).sum(0), np.abs(Tx_j[..., :Tx.shape[-1]]
                                                 ).sum(0)
    assert np.abs(cs - cs_j).mean() < 1e-4 * cs_j.mean()


# -- the routes through kernels D and E (and the plain FFT route) ----------------
ROUTES = {
    "get_w": dict(get_w=True),
    "get_dWx": dict(get_dWx=True),
    "get_w_dWx": dict(get_w=True, get_dWx=True),
    "lebesgue": dict(squeezing="lebesgue"),
    "abs": dict(squeezing="abs"),
    "callable": dict(squeezing=_double),
    "phase": dict(difftype="phase", get_w=True),
    "numeric": dict(difftype="numeric", get_w=True),
    "numeric2": dict(difftype="numeric", get_w=True, difforder=2),
    "order1": dict(order=1),
    "order012": dict(order=(0, 1, 2)),
    "bump": dict(wavelet=("bump", {"om": 0.5})),
    "no_pad_not_pow2": dict(padtype=None),
}
N_R = 2048


def _route_signal():
    t = np.arange(N_R) / FS
    noise = np.random.default_rng(4).standard_normal(N_R)
    return (np.cos(2 * np.pi * (20 * t + 60 * t * t)) + 0.1 * noise
            ).astype(np.float32)


@pytest.mark.parametrize("route", list(ROUTES))
def test_ssq_cwt_routes_match_jax(route):
    """Each route against the JAX package's ssq_cwt on the CPU (its XLA
    routes), GMW at nv = 8, N = 2048 (1500 for padtype=None): Tx with the
    bin-flip-tolerant bars of test_ssq_cwt_matches_jax (mean column
    relative error of sum_k |Tx| < 1e-4, |sum Tx - sum Tx_jax| < 1e-5 *
    sum |Tx_jax|); Wx and dWx within 1e-5 of max|.|; w (float32 phase of
    Wx that differs by ~3e-6 between the packages): the +inf mask agrees
    on >= 99.9 % of entries."""
    kw = dict(ROUTES[route])
    wav = kw.pop("wavelet", "gmw")
    x = _route_signal()
    if route == "no_pad_not_pow2":
        x = x[:1500]
    ref = [np.asarray(a) for a in j_ssq_cwt(x, wav, nv=8, fs=FS,
                                            dtype="float32", **kw)]
    out = ssq_cwt(torch.as_tensor(x), wav, nv=8, fs=FS, **kw)
    assert len(out) == len(ref)
    Tx, Wx = out[0].numpy(), out[1].numpy()
    assert Tx.shape == ref[0].shape and Wx.shape == ref[1].shape
    assert Tx.shape[-1] == len(x)
    assert np.array_equal(out[2], ref[2]) and np.array_equal(out[3], ref[3])
    cs, cs_j = np.abs(Tx).sum(-2), np.abs(ref[0]).sum(-2)
    assert np.mean(np.abs(cs - cs_j) / cs_j) < 1e-4
    assert abs(Tx.sum() - ref[0].sum()) < 1e-5 * np.abs(ref[0]).sum()
    assert np.abs(Wx - ref[1]).max() / np.abs(ref[1]).max() < 1e-5
    for a, b in zip(out[4:], ref[4:]):
        a = a.numpy()
        if np.iscomplexobj(b):          # dWx
            assert np.abs(a - b).max() / np.abs(b).max() < 1e-5
        else:                           # w
            assert a.shape == b.shape
            assert (np.isinf(a) == np.isinf(b)).mean() >= 0.999


def test_numeric_needs_padding():
    with pytest.raises(ValueError, match="numeric"):
        ssq_cwt(torch.zeros(1024), difftype="numeric", get_w=True,
                padtype=None)


def test_unported_inverse_and_grad_raise():
    """The component inversion (cc/cw) is ported
    (tests/test_torch_ssq_stft.py holds it to the JAX package), and a
    signal that requires grad gets a finite gradient through ssq_cwt
    (tests/test_torch_grad.py holds it to jax.grad)."""
    Tx = torch.zeros((4, 16), dtype=torch.complex64)
    x = issq_cwt(Tx, cc=np.zeros(16, int), cw=np.ones(16, int))
    assert x.shape == (2, 16)
    x = torch.tensor(np.random.default_rng(0).standard_normal(1000),
                     dtype=torch.float32, requires_grad=True)
    Tx, Wx, *_ = ssq_cwt(x, "gmw", nv=8)
    ((Tx.abs() ** 2).sum() + (Wx.abs() ** 2).sum()).backward()
    assert x.grad.shape == x.shape and bool(torch.isfinite(x.grad).all())
    assert bool(x.grad.abs().max() > 0)
