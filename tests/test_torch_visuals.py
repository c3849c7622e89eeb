"""The port's plots (`ssqueeze_rs_tpu_torch.visuals`, `Wavelet.viz`, the
`TestSignals` plots, `toolkit.lin_band(viz=True)`) against the JAX
package's, headless (matplotlib's Agg backend), on the CPU: every
function runs, and the data of what it draws (each line's x and y, each
image's array, each scatter's points, in drawing order) matches the JAX
function's on the same input. The port is given tensors where the JAX
package is given the same numpy arrays.

Tolerances: host numpy (the generic plots, the wavelet views, which
sample the wavelets with numpy in both packages, the gif's bytes) equal;
plots of float32 transforms at the port's bars against the JAX package:
|Wx| and |Sx| images within 1e-5 of max (tests/test_torch_cwt.py), |Tx|
images by their column sums within 1e-3 of the largest (bin flips,
tests/test_torch_pipeline.py), ridges equal on >= 95 % of columns: where
rows nearly tie (the chirp's start in |Sx|) a ridge follows the last bit
of its plane, which the two packages' float32 transforms do not share
(tests/test_torch_ridge.py hands both the same planes and compares the
ridges exactly).
"""
import os
import subprocess
import sys
import textwrap

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import ssqueeze_rs_tpu as J  # noqa: E402
import ssqueeze_rs_tpu_torch as T  # noqa: E402
from ssqueeze_rs_tpu import visuals as jv  # noqa: E402
from ssqueeze_rs_tpu_torch import visuals as tv  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(4)
G = RNG.standard_normal((16, 24))
Z = G + 1j * RNG.standard_normal((16, 24))


@pytest.fixture(autouse=True)
def _quiet():
    """Agg's show() only warns; every test starts and ends with no
    figure."""
    import warnings
    plt.close("all")
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*non-interactive.*")
        warnings.filterwarnings("ignore", message=".*FigureCanvasAgg.*")
        yield
    plt.close("all")


def _drawn(fn, *args, **kw):
    """(return value, what fn drew: [(kind, array), ...])."""
    plt.close("all")
    ret = fn(*args, **kw)
    data = []
    for num in plt.get_fignums():
        for ax in plt.figure(num).axes:
            for ln in ax.lines:
                data += [("x", np.asarray(ln.get_xdata(), float)),
                         ("y", np.asarray(ln.get_ydata(), float))]
            data += [("image", np.asarray(im.get_array()))
                     for im in ax.images]
            data += [("points", np.asarray(c.get_offsets()))
                     for c in ax.collections]
            if ax.patches:
                data.append(("bars", np.array([p.get_bbox().bounds
                                               for p in ax.patches])))
    plt.close("all")
    return ret, data


def _tensor(a):
    return torch.as_tensor(a) if isinstance(a, np.ndarray) else a


def _same_drawing(ours, theirs):
    assert [k for k, _ in ours] == [k for k, _ in theirs]
    for (k, a), (_, b) in zip(ours, theirs):
        assert a.shape == b.shape and np.array_equal(a, b), k


# each function of visuals.__all__ with an input; arrays go to the port as
# tensors
CASES = {
    "imshow": [((G,), dict(show=False)),
               ((Z,), dict(complex=1, show=False)),
               ((G,), dict(ridge=1, ticks=0, show=False)),
               ((G,), dict(abs=1, norm=(0, 2.0), cmap="turbo",
                           borders=False, xticks=np.arange(24) * 0.5,
                           yticks=np.arange(16), show=False)),
               ((G,), dict(ridge=np.arange(24) % 16, show=False))],
    "plot": [((G[0],), {}), ((np.arange(24), Z[0]), dict(complex=2,
                                                         c_annot=True)),
             ((G[0],), dict(vlines=([4, 8], {"color": "r"}), hlines=0.5,
                            vert=True, ticks=(0, 1), xticks=[1, 2]))],
    "scat": [((np.arange(16), G[:, 0]),
              dict(vlines=3, title="t", abs=True)),
             ((Z[0],), dict(complex=True))],
    "plotscat": [((G[1],), {})],
    "hist": [((G,), dict(show=False, stats=True, bins=20))],
    "plots": [(([None, None], [G[0], G[1]]), dict(nrows=2, show=False)),
              (([np.arange(24), [np.arange(24), np.arange(24)]],
                [G[0], [G[1], G[2]]]), dict(show=False, _scat=1,
                                            titles=["a", "b"]))],
    "vhlines": [(([2, 5],), {}), (([1.5], ), dict(kind="h"))],
    "wavelet_filterbank": [(("gmw",), dict(N=256, show=False)),
                           (("morlet",), dict(N=256, skips=3,
                                              title_append="x",
                                              show=False))],
    "wavelet_waveforms": [(("gmw",), dict(N=256, scale=8.0, show=False)),
                          (("bump",), dict(N=256, zoom=False,
                                           show=False))],
    "wavelet_heatmap": [(("gmw",), dict(N=256, show=False))],
    "wavelet_tf": [((("gmw", {"beta": 8.0}),), dict(N=256, show=False))],
    "sweep_std_t": [(("gmw",), dict(N=256, get=True, show=False))],
    "sweep_std_w": [(("morlet",), dict(N=256, get=True, show=False))],
    "sweep_harea": [(("gmw",), dict(N=256, get=True, show=False))],
    "viz_gmw_orders": [((), dict(N=256, orders=(0, 1), show=False)),
                       ((), dict(N=256, n_orders=2, beta=20.0,
                                 show=False))],
    "viz_cwt_higher_order": [(([Z, 2 * Z],), dict(show=False)),
                             ((Z,), dict(show=False))],
    "viz_cwt_scalebounds": [(("gmw",), dict(N=256, show=False)),
                            (("morlet",), dict(N=256, min_scale=2.0,
                                               max_scale=30.0,
                                               show=False))],
}


def test_every_function_has_a_case():
    assert tv.__all__ == jv.__all__
    assert set(CASES) | {"wavelet_tf_anim"} == set(tv.__all__)


@pytest.mark.parametrize("name, i", [(n, i) for n, cs in CASES.items()
                                     for i in range(len(cs))])
def test_draws_what_jax_draws(name, i):
    args, kw = CASES[name][i]
    theirs = _drawn(getattr(jv, name), *args, **kw)
    t_args = tuple([_tensor(b) for b in a] if isinstance(a, list) and
                   name == "viz_cwt_higher_order" else _tensor(a)
                   for a in args)
    ours = _drawn(getattr(tv, name), *t_args, **kw)
    assert theirs[1], "the case draws nothing"
    _same_drawing(ours[1], theirs[1])
    if name in ("hist", "sweep_std_t", "sweep_std_w", "sweep_harea"):
        for a, b in zip(ours[0], theirs[0]):   # stats / (scales, values)
            assert np.array_equal(a, b)


def test_wavelet_tf_anim(tmp_path):
    """The gif is byte for byte the JAX package's; an existing path gets a
    numeric suffix; savepath=None draws static frames instead."""
    kw = dict(N=128, testing=True)
    p1 = tv.wavelet_tf_anim("gmw", savepath=str(tmp_path / "t.gif"), **kw)
    p2 = tv.wavelet_tf_anim("gmw", savepath=str(tmp_path / "t.gif"), **kw)
    pj = jv.wavelet_tf_anim("gmw", savepath=str(tmp_path / "j.gif"), **kw)
    assert p1.endswith("t.gif") and p2.endswith("t1.gif")
    assert open(p1, "rb").read() == open(pj, "rb").read()
    kw = dict(N=128, scales=np.geomspace(2, 16, 10), n_frames=5,
              savepath=None)
    assert _drawn(tv.wavelet_tf_anim, "gmw", **kw)[0] is None
    _same_drawing(_drawn(tv.wavelet_tf_anim, "gmw", **kw)[1],
                  _drawn(jv.wavelet_tf_anim, "gmw", **kw)[1])


@pytest.mark.parametrize("name", T.Wavelet.VISUALS + ("overview",))
def test_wavelet_viz(tmp_path, name):
    assert T.Wavelet.VISUALS == J.Wavelet.VISUALS
    kw = (dict(N=128, testing=True, savepath=str(tmp_path / f"{name[5:]}.gif"))
          if name.startswith("anim") else dict(N=256, show=False))
    spec = ("gmw", {"beta": 12.0})
    ours = _drawn(T.Wavelet.build(spec).viz, name, **kw)
    if name.startswith("anim"):
        kw["savepath"] = str(tmp_path / "j.gif")
    theirs = _drawn(J.Wavelet.build(spec).viz, name, **kw)
    _same_drawing(ours[1], theirs[1])
    with pytest.raises(ValueError, match="not supported"):
        T.Wavelet.build("gmw").viz("nope")


def _held(ours, theirs, kinds):
    """Images of transforms by their bar (`kinds`: 'w' for |Wx| / |Sx|,
    't' for |Tx|, one per image in order); lines and points equal."""
    imgs = [(a, b) for (k, a), (_, b) in zip(ours, theirs) if k == "image"]
    assert [k for k, _ in ours] == [k for k, _ in theirs]
    assert len(imgs) == len(kinds)
    for (a, b), kind in zip(imgs, kinds):
        assert a.shape == b.shape
        if kind == "w":
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
        else:
            ca, cb = np.abs(a).sum(0), np.abs(b).sum(0)
            assert np.abs(ca - cb).max() <= 1e-3 * cb.max()


def test_signals_demo_and_test_transforms():
    for dft in (None, "rows"):
        _same_drawing(
            _drawn(T.TestSignals(N=256).demo, "am_cosine", dft=dft)[1],
            _drawn(J.TestSignals(N=256).demo, "am_cosine", dft=dft)[1])
    with pytest.raises(ValueError, match="dft"):
        T.TestSignals().demo(dft="x")

    def fn(x, t, params):
        return [np.outer(x[:16], x[:32])], dict(abs=False)

    ours = _drawn(T.TestSignals(N=256).test_transforms, fn,
                  signals=["cosine", "lchirp"])
    theirs = _drawn(J.TestSignals(N=256).test_transforms, fn,
                    signals=["cosine", "lchirp"])
    _same_drawing(ours[1], theirs[1])


def test_signals_wavcomp_and_cwt_vs_stft():
    ours = _drawn(T.TestSignals(N=512).wavcomp, ["gmw", "morlet"],
                  signals="am_cosine", device="cpu")
    theirs = _drawn(J.TestSignals(N=512).wavcomp, ["gmw", "morlet"],
                    signals="am_cosine")
    _held(ours[1], theirs[1], "wtwt")
    ours = _drawn(T.TestSignals(N=512).cwt_vs_stft, "gmw", "hann",
                  signals="lchirp", n_fft=128, device="cpu")
    theirs = _drawn(J.TestSignals(N=512).cwt_vs_stft, "gmw", "hann",
                    signals="lchirp", n_fft=128)
    _held(ours[1], theirs[1], "wtwt")


@pytest.mark.parametrize("transform", ["cwt", "stft"])
def test_signals_ridgecomp(transform):
    kw = dict(signals="lchirp", N=512, n_ridges=1, transform=transform)
    if transform == "stft":
        kw["n_fft"] = 128
    ours = _drawn(T.TestSignals().ridgecomp, device="cpu", **kw)[1]
    theirs = _drawn(J.TestSignals().ridgecomp, **kw)[1]
    _held([d for d in ours if d[0] == "image"],
          [d for d in theirs if d[0] == "image"], "wt")
    lines = [(a, b) for (k, a), (_, b) in zip(ours, theirs) if k == "y"]
    assert len(lines) == 2
    for a, b in lines:
        assert np.mean(a == b) >= 0.95


def test_lin_band_viz():
    Tx = np.abs(Z)
    ours = _drawn(T.toolkit.lin_band, torch.as_tensor(Tx), 0.5, 0.1,
                  viz=True)
    theirs = _drawn(J.toolkit.lin_band, Tx, 0.5, 0.1, viz=True)
    _same_drawing(ours[1], theirs[1])
    for a, b in zip(ours[0], theirs[0]):
        assert np.array_equal(a, b)


def test_imports_without_matplotlib_or_pyarrow():
    """The package imports where neither matplotlib nor pyarrow exists;
    a plot then raises ImportError."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["matplotlib"] = None
        sys.modules["pyarrow"] = None
        sys.path.insert(0, {REPO!r})
        import ssqueeze_rs_tpu_torch as T
        assert "matplotlib.pyplot" not in sys.modules
        assert T.io.have_pyarrow() is False
        try:
            T.visuals.plot([1, 2])
        except ImportError:
            print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "ok"
