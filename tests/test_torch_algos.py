"""The reference's kernel-layer names (`algos`) and the experimental phase
transform and squeeze of the port against the JAX package's, on the CPU,
all fed the same planes: a noisy chirp's CWT (and dWx) and STFT (and
dSx), float32, computed once by the JAX package.

Tolerances:
  * `indexed_sum`: within 5e-6 of sum|a| per column (float32 sums in row
    order here, in XLA's scatter order there); bitwise on a repeat.
  * `indexed_sum_onfly` (kernel B's plain version), `ssqueeze_fast` (B')
    and `phase_ssqueeze`: the bars `tests/test_torch_reassign.py` holds
    the plain reassignment to. log2 or the phase may round apart by an ulp
    between torch and XLA and move a value across a rounding tie, so Tx
    entries agree to 1e-6 of max|Tx| on >= 99.99 % of entries, and the
    column sums (which do not depend on the bins) to 1e-6 of the largest.
  * `phase_transform`'s w and the `phase_*_cpu` pairs, as
    `tests/test_torch_cwt.py` holds the phase transforms: the +inf masks
    agree on >= 99.9 % of entries; where |Wx|^2 > 1e4 gamma^2, w within
    1e-4 relative on >= 99.9 % of entries (w is ill-conditioned near 0,
    so no max bar; the STFT phase |Sfs - r| relative to Sfs + w, which
    bounds |r|); difftype 'phase' within 1e-3 (its float32 unwrapped
    phase grows to thousands of radians, where the two packages'
    cumulative sums differ by an ulp).
  * `nCk` and the re-exports: equal.
"""
import numpy as np
import pytest
import torch

import ssqueeze_rs_tpu as J
import ssqueeze_rs_tpu_torch as T
from ssqueeze_rs_tpu import algos as ja, experimental as je
from ssqueeze_rs_tpu_torch import algos as ta, experimental as te

N = 1024
FS = 100.0


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(0)
    t = np.arange(N) / FS
    x = (np.cos(2 * np.pi * (2 * t + 0.8 * t * t)) +
         0.1 * rng.standard_normal(N)).astype(np.float32)
    Wx, scales, dWx = J.cwt(x, ("gmw", {"beta": 8.0}), scales="log", fs=FS,
                            derivative=True, dtype="float32")
    Sx, dSx, *_ = J.stft(x, n_fft=126, dtype="float32", derivative=True)
    return dict(x=x, Wx=np.array(Wx), dWx=np.array(dWx),
                scales=np.asarray(scales), Sx=np.array(Sx),
                dSx=np.array(dSx))


def _tx_close(ours, theirs):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    top = np.abs(theirs).max()
    assert (np.abs(ours - theirs) <= 1e-6 * top).mean() >= 0.9999
    cs, cs_j = ours.sum(-2), theirs.sum(-2)
    assert np.abs(cs - cs_j).max() <= 1e-6 * np.abs(cs_j).max()


def _w_close(ours, theirs, Wx, gamma, bar=1e-4, Sfs=None):
    """For the STFT phase |Sfs - r|, the error is r's, so it is taken
    relative to |r| <= Sfs + w: w near 0 is as ill-conditioned as the CWT
    phase near 0."""
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert (np.isinf(ours) == np.isinf(theirs)).mean() >= 0.999
    strong = np.abs(np.asarray(Wx)) ** 2 > 1e4 * gamma ** 2
    assert strong.mean() > 0.5
    scale = np.abs(theirs) + (0 if Sfs is None else
                              np.abs(np.asarray(Sfs))[:, None])
    scale = np.where(scale > 0, scale, 1)[strong]     # w = 0 on the DC row
    rel = np.abs(ours[strong] - theirs[strong]) / scale
    assert (rel < bar).mean() >= 0.999


def test_nck_and_reexports():
    for n, k in [(10, 3), (5, 0), (3, 5), (40, 20), (7, 7)]:
        assert ta.nCk(n, k) == ja.nCk(n, k)
    assert ta.__all__ == ja.__all__
    from ssqueeze_rs_tpu_torch.utils import closest, common
    assert ta.find_closest is closest.find_closest
    assert ta.replace_under_abs is common.replace_under_abs
    assert ta.find_maximum is T.find_maximum


def test_indexed_sum(planes):
    a = np.abs(planes["Wx"]).astype(np.float32)
    k = np.random.default_rng(1).integers(0, a.shape[0], a.shape)
    theirs = np.asarray(ja.indexed_sum(a, k))
    ours = ta.indexed_sum(torch.as_tensor(a), torch.as_tensor(k))
    assert ours.shape == theirs.shape and ours.dtype == torch.float32
    col = a.sum(0)
    assert (np.abs(ours.numpy() - theirs).max(0) <= 5e-6 * col).all()
    assert torch.equal(ta.indexed_sum(torch.as_tensor(a), k), ours)


@pytest.mark.parametrize("flipud", [False, True])
@pytest.mark.parametrize("logscale", [False, True])
def test_indexed_sum_onfly(planes, logscale, flipud):
    Wx = planes["Wx"]
    w = np.abs(np.asarray(ja.phase_cwt_cpu(Wx, planes["dWx"], 1e-5)))
    w = w.astype(np.float32)
    na = Wx.shape[0]
    freqs = (np.geomspace(0.5, 50, na) if logscale
             else np.linspace(0.5, 50, na))
    const = np.linspace(0.5, 1.5, na)
    theirs = ja.indexed_sum_onfly(Wx, w, freqs, const, logscale, flipud)
    ours = ta.indexed_sum_onfly(torch.as_tensor(Wx), torch.as_tensor(w),
                                freqs, const, logscale, flipud)
    assert ours.dtype == torch.complex64
    _tx_close(ours.numpy(), theirs)
    # a real Wx gives a real Tx, as in the JAX package
    real = ta.indexed_sum_onfly(torch.as_tensor(Wx.real), torch.as_tensor(w),
                                freqs, const, logscale, flipud)
    assert real.dtype == torch.float32
    assert torch.equal(real, ours.real)


@pytest.mark.parametrize("transform", ["cwt", "stft"])
def test_ssqueeze_fast(planes, transform):
    if transform == "cwt":
        Wx, dWx, Sfs = planes["Wx"], planes["dWx"], None
        freqs = np.geomspace(0.5, 50, Wx.shape[0])
    else:
        Wx, dWx = planes["Sx"], planes["dSx"]
        Sfs = np.linspace(0, 0.5, Wx.shape[0]).astype(np.float32)
        freqs = np.linspace(0, 0.5, Wx.shape[0])
    const = np.full(Wx.shape[0], 0.7)
    kw = dict(logscale=transform == "cwt", gamma=1e-5, Sfs=Sfs)
    theirs = ja.ssqueeze_fast(Wx, dWx, freqs, const, **kw)
    ours = ta.ssqueeze_fast(torch.as_tensor(Wx), torch.as_tensor(dWx),
                            freqs, const, **kw)
    _tx_close(ours.numpy(), theirs)


def test_phase_pairs(planes):
    Wx, dWx = planes["Wx"], planes["dWx"]
    _w_close(ta.phase_cwt_cpu(torch.as_tensor(Wx), dWx, 1e-5),
             ja.phase_cwt_cpu(Wx, dWx, 1e-5), Wx, 1e-5)
    Sx, dSx = planes["Sx"], planes["dSx"]
    Sfs = np.linspace(0, 0.5, Sx.shape[0]).astype(np.float32)
    _w_close(ta.phase_stft_gpu(torch.as_tensor(Sx), dSx, Sfs, 1e-5),
             ja.phase_stft_gpu(Sx, dSx, Sfs, 1e-5), Sx, 1e-5, Sfs=Sfs)
    assert ta.phase_cwt_gpu is ta.phase_cwt_cpu


def test_double_planes_raise(planes):
    Wx = torch.as_tensor(planes["Wx"]).to(torch.complex128)
    w = torch.ones(Wx.shape, dtype=torch.float32)
    freqs = np.linspace(0.5, 50, Wx.shape[0])
    with pytest.raises(NotImplementedError, match="float64"):
        ta.indexed_sum_onfly(Wx, w, freqs)
    with pytest.raises(NotImplementedError, match="float64"):
        ta.ssqueeze_fast(Wx, Wx, freqs, 1.0)


def test_zero_denormals():
    x = np.array([1e-40, -1e-41, 0.5, -2.0, 1e-30], np.float32)
    ref = ja.zero_denormals(x.copy())
    y = x.copy()
    assert ta.zero_denormals(y) is y and np.array_equal(y, ref)
    t = ta.zero_denormals(torch.as_tensor(x))
    assert isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), ref)


@pytest.mark.parametrize("difftype", ["trig", "phase", "numeric"])
def test_phase_transform_cwt(planes, difftype):
    """w of the CWT phase transform from Wx and dWx ('trig') or from Wx
    alone ('phase', 'numeric'), and dWx by trigdiff when not given."""
    Wx, dWx = planes["Wx"], planes["dWx"]
    kw = dict(difftype=difftype, fs=FS, get_w=True, gamma=1e-5)
    theirs = je.phase_transform(Wx, dWx, **kw)
    ours = te.phase_transform(torch.as_tensor(Wx), torch.as_tensor(dWx),
                              **kw)
    assert ours[1].shape == theirs[1].shape
    _w_close(ours[0].numpy(), theirs[0], theirs[1], 1e-5,
             1e-3 if difftype == "phase" else 1e-4)
    if difftype == "trig":
        # dWx by trig differentiation of the (unpadded) Wx
        ours = te.phase_transform(torch.as_tensor(Wx), fs=FS)
        theirs = je.phase_transform(Wx, fs=FS)
        d, dj = ours[2].numpy(), np.asarray(theirs[2])
        assert np.abs(d - dj).max() <= 1e-5 * np.abs(dj).max()


def test_phase_transform_stft(planes):
    Sx, dSx = planes["Sx"], planes["dSx"]
    ours = te.phase_transform(torch.as_tensor(Sx), torch.as_tensor(dSx),
                              fs=2.0, get_w=True, transform="stft")
    theirs = je.phase_transform(Sx, dSx, fs=2.0, get_w=True,
                                transform="stft")
    assert np.array_equal(ours[3], theirs[3])
    _w_close(ours[0].numpy(), theirs[0], Sx, theirs[4], Sfs=theirs[3])
    with pytest.raises(NotImplementedError):
        te.phase_transform(torch.as_tensor(Sx), transform="stft")


@pytest.mark.parametrize("get_w", [False, True])
@pytest.mark.parametrize("transform", ["cwt", "stft"])
def test_phase_ssqueeze(planes, transform, get_w):
    """The squeeze of a given TF array: B' from dWx, or B from w with
    `get_w`; Tx at the reassignment bars, ssq_freqs equal."""
    if transform == "cwt":
        Wx, dWx = planes["Wx"], planes["dWx"]
        kw = dict(scales=planes["scales"], wavelet=("gmw", {"beta": 8.0}),
                  fs=FS)
    else:
        Wx, dWx = planes["Sx"], planes["dSx"]
        kw = dict(fs=FS, ssq_freqs=np.linspace(0, FS / 2, Wx.shape[0]))
    theirs = je.phase_ssqueeze(Wx, dWx, transform=transform, get_w=get_w,
                               **kw)
    ours = te.phase_ssqueeze(torch.as_tensor(Wx), torch.as_tensor(dWx),
                             transform=transform, get_w=get_w, **kw)
    _tx_close(ours[0].numpy(), theirs[0])
    assert np.array_equal(ours[2], theirs[2])
    assert (ours[5] is None) == (theirs[5] is None)
    assert (ours[6] is None) == (theirs[6] is None)
