"""`extract_ridges` of the port against the JAX package's, on the CPU,
and the component-separation workflow (`examples/component_separation.py`:
ssq_cwt -> extract_ridges -> issq_cwt over bands around each ridge) in
both packages.

Inputs: TestSignals two-component signals (a sine plus a linear chirp)
at N = 1024 and 2048, their ssq_cwt and ssq_stft planes computed once by
the JAX package and handed to both; and a synthetic plane whose ridges
sit near row 0, so the +-bw zeroing clamps there.

Tolerances: both packages run the same float32 recursion in the same
order, but log may round apart by an ulp between torch and XLA, and
where two components' penalized paths nearly tie, which ridge takes
which component follows that last bit: the JAX package's own ridges at
N = 1024 trade components over ~30 columns when 1 % of Tx moves by one
ulp. So the rows each column's ridges sit on must be equal (the ridge
indices, each column's pair in row order), and so must the labelled
indices on the inputs whose paths do not tie that closely (N = 2048,
the rows-near-0 plane, the workflow). ridge_f is the host scales indexed
by the ridge, so equal; ridge_e is |Tf|^2 in float32 (numpy on the host
in JAX, torch here), within 5e-6 relative, in the same per-column order.
The workflow holds each package to the example's own bar, mad_rms < 0.5
per component, and the two packages to the same ridges.
"""
import numpy as np
import pytest
import torch

import ssqueeze_rs_tpu as J
import ssqueeze_rs_tpu_torch as T

WAV = ("gmw", {"beta": 6.0})


def _two_components(P, N):
    ts = P.TestSignals(N)
    x1, _ = ts.sine(N, f=64 * N / 2048)
    x2, _ = ts.lchirp(N, fmin=128 * N / 2048, fmax=400 * N / 2048)
    return x1, x2


@pytest.fixture(scope="module")
def planes():
    out = {}
    for N in (1024, 2048):
        x = sum(_two_components(J, N)).astype(np.float32)
        Tx, _, f, _ = J.ssq_cwt(x, WAV, dtype="float32")
        Sx, _, sf, *_ = J.ssq_stft(x, dtype="float32")
        out[N] = {"cwt": (np.array(Tx), np.asarray(f)),
                  "stft": (np.array(Sx), np.asarray(sf))}
    return out


def _by_row(ridge, *params):
    """Each column's ridges (and their params) in row order."""
    order = np.argsort(ridge, axis=1, kind="stable")
    return [np.take_along_axis(a, order, axis=1) for a in (ridge, *params)]


def _check(Tf, scales, labelled=True, **kw):
    theirs = J.extract_ridges(Tf, scales, **kw)
    ours = T.extract_ridges(torch.as_tensor(Tf), scales, **kw)
    if not kw.get("get_params"):
        ours, theirs = (ours,), (theirs,)
    assert isinstance(ours[0], np.ndarray)
    assert ours[0].dtype == theirs[0].dtype
    if labelled:
        assert np.array_equal(ours[0], theirs[0])
    ours, theirs = _by_row(*ours), _by_row(*theirs)
    assert np.array_equal(ours[0], theirs[0])
    if kw.get("get_params"):
        assert ours[1].dtype == theirs[1].dtype
        assert np.array_equal(ours[1], theirs[1])
        assert ours[2].shape == theirs[2].shape
        assert (np.abs(ours[2] - theirs[2]).max() <=
                5e-6 * np.abs(theirs[2]).max())
    return ours[0]


@pytest.mark.parametrize("get_params", [False, True])
@pytest.mark.parametrize("transform", ["cwt", "stft"])
@pytest.mark.parametrize("N", [1024, 2048])
def test_ridges_match_jax(planes, N, transform, get_params):
    Tf, scales = planes[N][transform]
    ridge = _check(Tf, scales, labelled=N == 2048, penalty=2.0, n_ridges=2,
                   bw=25, transform=transform, get_params=get_params)
    assert ridge.shape == (N, 2)
    # the two ridges follow different components over most of the signal
    assert (ridge[:, 0] != ridge[:, 1]).mean() > 0.9


@pytest.mark.parametrize("get_params", [False, True])
def test_ridges_near_row_zero(get_params):
    """Two bands at rows 3-4 and 36-44 of a noisy plane, two ridges,
    bw = 15: the first zeroing clamps at row 0. (A third ridge would run
    through noise alone, where the path hangs on last-ulp roundings of
    the log: the backtrack holds a float32 recomputation to eps, so it is
    not compared.)"""
    rng = np.random.default_rng(7)
    na, n = 64, 700
    Tf = 0.05 * (rng.standard_normal((na, n)) +
                 1j * rng.standard_normal((na, n)))
    t = np.arange(n)
    Tf[3 + (t // 350), t] += 3.0
    Tf[40 + (np.sin(t / 60) * 4).astype(int), t] += 2.0
    Tf = Tf.astype(np.complex64)
    scales = np.geomspace(1.0, 64.0, na)
    for transform in ("cwt", "stft"):
        ridge = _check(Tf, scales, penalty=1.0, n_ridges=2, bw=15,
                       transform=transform, get_params=get_params)
        assert set(np.unique(ridge[:, 0])) <= {3, 4}
        assert ridge[:, 1].min() >= 36 and ridge[:, 1].max() <= 44


def test_ridges_stay_on_their_device():
    """Array input goes where `device` says; the result is host numpy."""
    Tf = np.abs(np.random.default_rng(8).standard_normal((30, 200)))
    Tf = Tf.astype(np.complex64)
    sc = np.geomspace(1, 30, 30)
    a = T.extract_ridges(Tf, sc, device="cpu")
    b = T.extract_ridges(torch.as_tensor(Tf), sc)
    assert np.array_equal(a, b) and a.shape == (200, 1)


def _separate(P, x1, x2, as_input):
    x = (x1 + x2).astype(np.float32)
    Tx, _, f, _ = P.ssq_cwt(as_input(x), WAV, dtype="float32")
    cc = np.asarray(P.extract_ridges(Tx, f, penalty=2.0, n_ridges=2,
                                     bw=25)).astype(np.int32)
    xrec = np.asarray(P.issq_cwt(Tx, WAV, cc, np.full_like(cc, 20)))
    errs = [min(P.mad_rms(src, xrec[k]) for k in range(2))
            for src in (x1, x2)]
    return cc, errs


def test_component_separation_workflow():
    """examples/component_separation.py at N = 2048 in float32: each
    package recovers both components within the example's mad_rms bar,
    from the same ridges."""
    x1, x2 = _two_components(J, 2048)
    cc_j, errs_j = _separate(J, x1, x2, lambda a: a)
    cc_t, errs_t = _separate(T, x1, x2, torch.as_tensor)
    assert max(errs_j) < 0.5 and max(errs_t) < 0.5, (errs_j, errs_t)
    assert np.array_equal(cc_t, cc_j)
