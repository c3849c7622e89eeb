"""The CWT family of the torch port against the JAX package, on the CPU.

Kernel level: kernel D's plain version (`cwt_fused_plain`) against the
JAX package's fused CWT kernel (`cwt_halfband_fused`, Pallas in interpret
mode) and kernel E's (`ifft_halfband_planar_plain`) against
`ifft_halfband_planar_fused`, fed the same inputs: white noise, N = 9000
(M = 2^14, the smallest M the JAX kernels build for), GMW log-piecewise
scales at nv = 4, one and two signals, keep (n1, N) and (0, M). The JAX
kernels multiply in bf16x3, about 5e-6 of max|Wx| off the exact
transform, while the torch versions are float32 FFTs; so each is also held
to a float64 transform of the same inputs.

Entry points: `cwt`, `icwt`, `phase_cwt`, `phase_cwt_num` against the
JAX package's public functions on the CPU (its XLA routes).

Tolerances:
  D, E planes    max|d| / max|plane|: JAX vs torch < 1e-5 (bf16x3);
                 torch vs float64 < 1e-6
  cwt            Wx, dWx max|d| / max|.| < 1e-5 (float32 FFTs in other
                 orders and a float32 grid rounded once); float64 < 1e-10
  icwt           max|d| / max|x_jax| < 1e-5 (float64 where the JAX test
                 runs float64); the round trip's mad_rms under the JAX
                 package's own bars (tests/test_cwt.py: 0.1, 0.02, 0.12)
  phase          w where |Wx|^2 > 1e4 gamma^2: relative error < 1e-4 on
                 >= 99.9 % of entries (w is ill-conditioned near 0, so no
                 max bar); the +inf mask agrees on >= 99.9 % of entries.
                 Both packages get the same Wx, dWx. difftype='phase':
                 within 1e-3, since its unwrapped phase reaches ~5e3 rad
                 here, where the two packages' cumulative sums differ by
                 an ulp (~5e-4 rad) against phase steps of ~0.2 rad.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ssqueeze_rs_tpu as J
from ssqueeze_rs_tpu.ops.cwt import _xi_grid_np
from ssqueeze_rs_tpu.ops.fft_pallas import (cwt_halfband_fused,
                                            ifft_halfband_planar_fused)
from ssqueeze_rs_tpu.scales import process_scales
from ssqueeze_rs_tpu.utils.pad import padsignal
from ssqueeze_rs_tpu.wavelets import Wavelet
import ssqueeze_rs_tpu_torch as T
from ssqueeze_rs_tpu_torch.ops import fft_cuda
from ssqueeze_rs_tpu_torch.trace import COUNTS
from ssqueeze_rs_tpu_torch.ops.phase import unwrap

N, NV, FS = 9000, 4, 1000.0


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


# -- kernel level ---------------------------------------------------------------
@pytest.fixture(scope="module")
def kcase():
    """JAX-planned kernel inputs for two white-noise signals."""
    wav = Wavelet.build("gmw", l1_norm=True)
    sc = process_scales("log-piecewise", N, wav, nv=NV).squeeze(-1)
    sc = sc.astype(np.float32)
    rng = np.random.default_rng(12)
    planes = []
    for _ in range(2):
        x = rng.standard_normal(N).astype(np.float32)
        xp, M, n1, _ = padsignal(jnp.asarray(x), "reflect", get_params=True)
        xh = np.asarray(jnp.fft.rfft(xp))
        planes.append(xh)
    xig = _xi_grid_np(M)
    K1, M2 = xig.shape
    Pw = np.asarray(wav.psih(jnp.asarray(sc)[:, None, None] *
                             jnp.asarray(xig)[None], jnp), np.float32)
    pnyq = np.asarray(wav.psih(jnp.asarray(sc) * np.float32(np.pi), jnp) / 2,
                      np.float32)
    xr = np.stack([np.asarray(h.real[:M // 2], np.float32).reshape(K1, M2)
                   for h in planes])
    xi = np.stack([np.asarray(h.imag[:M // 2], np.float32).reshape(K1, M2)
                   for h in planes])
    znyq = np.concatenate([np.float32(h[-1].real) * pnyq for h in planes])
    dt32 = np.float32(1 / FS)
    inv_dt, pi_dt = np.float32(1) / dt32, np.float32(np.pi) / dt32
    return dict(Pw=Pw, xr=xr, xi=xi, xig=xig, inv_dt=inv_dt, znyq=znyq,
                pi_dt=pi_dt, M=M, n1=n1, na=len(sc))


def _args(c, b):
    na = c["na"]
    znyq = c["znyq"][:b * na]
    zeros = np.zeros_like(znyq)
    return (c["Pw"], c["xr"][:b], c["xi"][:b], c["xig"], c["inv_dt"],
            (znyq, zeros), (zeros, znyq * c["pi_dt"]))


def _float64_planes(c, b, keep):
    """The float64 transform of the same float32 inputs: (W, dW), each
    (b*na, L) complex."""
    Pw, xr, xi, xig, inv_dt, (znyq, _), _ = _args(c, b)
    M, na = c["M"], c["na"]
    Z = (Pw[None].astype(np.float64) *
         (xr[:, None] + 1j * xi[:, None].astype(np.float64))
         ).reshape(b * na, -1)
    s = xig.astype(np.float64).reshape(-1) * np.float64(inv_dt)
    spec = np.zeros((2, b * na, M), complex)
    spec[0, :, :M // 2], spec[1, :, :M // 2] = Z, 1j * Z * s
    spec[0, :, M // 2] = znyq
    spec[1, :, M // 2] = 1j * znyq.astype(np.float64) * np.float64(c["pi_dt"])
    start, L = keep
    W, dW = np.fft.ifft(spec)[..., start:start + L]
    return W, dW


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("keep", ["signal", "all"])
@pytest.mark.parametrize("derivative", [False, True], ids=["wx", "dwx"])
def test_cwt_fused_plain_matches_jax(kcase, derivative, keep, b):
    keep = (kcase["n1"], N) if keep == "signal" else (0, kcase["M"])
    args = _args(kcase, b)
    ref = cwt_halfband_fused(
        *(jnp.asarray(a) for a in args[:5]), tuple(map(jnp.asarray, args[5])),
        tuple(map(jnp.asarray, args[6])), keep=keep, derivative=derivative,
        interpret=True)
    ref = [np.asarray(o) for o in ref]
    out = [o.numpy() for o in fft_cuda.cwt_fused_plain(
        *args, keep=keep, derivative=derivative)]
    assert len(out) == (4 if derivative else 2)
    W, dW = _float64_planes(kcase, b, keep)
    for p, exact in ((0, W), (2, dW))[:len(out) // 2]:
        scale = np.abs(ref[p] + 1j * ref[p + 1]).max()
        for a, r, e in ((out[p], ref[p], exact.real),
                        (out[p + 1], ref[p + 1], exact.imag)):
            assert a.shape == (b * kcase["na"], keep[1])
            assert np.abs(a - r).max() / scale < 1e-5
            assert np.abs(a - e).max() / np.abs(exact).max() < 1e-6


def test_cwt_fused_cpu_dispatch_and_planes(kcase):
    """A CPU tensor (or numpy input) runs the plain version and never the
    kernel; D's Wx planes are kernel A's plain Wx planes bit for bit, and
    without the derivative they are the derivative run's first two."""
    args = _args(kcase, 2)
    keep = (kcase["n1"], N)
    keys = ("launch.ssq_cwt_phase", "launch.ssq_cwt_planes",
            "launch.ssq_ifft_halfband")
    before = [COUNTS[k] for k in keys]
    d4 = fft_cuda.cwt_fused(*args, keep=keep, derivative=True)
    d2 = fft_cuda.cwt_fused(*args, keep=keep, derivative=False)
    assert [COUNTS[k] for k in keys] == before
    a = fft_cuda.cwt_phase_plain(*args, keep=keep, gamma=1e-6)
    for p in range(2):
        assert d4[p].device.type == "cpu"
        assert torch.equal(d4[p], a[p])
        np.testing.assert_allclose(d2[p].numpy(), d4[p].numpy(), rtol=0,
                                   atol=1e-6 * float(d4[p].abs().max()))


def _zcase(B=6):
    rng = np.random.default_rng(13)
    M1, M2 = fft_cuda.best_split(1 << 14)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, M1 // 2, M2), f(B, M1 // 2, M2), f(B), f(B)


@pytest.mark.parametrize("keep", [(0, 1 << 14), (3000, 9000)],
                         ids=["all", "window"])
def test_ifft_halfband_plain_matches_jax(keep):
    Zr, Zi, nr, ni = _zcase()
    ref = [np.asarray(o) for o in ifft_halfband_planar_fused(
        jnp.asarray(Zr), jnp.asarray(Zi), keep=keep, nyq_r=jnp.asarray(nr),
        nyq_i=jnp.asarray(ni), interpret=True)]
    out = [o.numpy() for o in fft_cuda.ifft_halfband_planar_plain(
        Zr, Zi, keep, nr, ni)]
    M = 1 << 14
    spec = np.zeros((len(nr), M), complex)
    spec[:, :M // 2] = (Zr + 1j * Zi.astype(np.float64)).reshape(len(nr), -1)
    spec[:, M // 2] = nr + 1j * ni.astype(np.float64)
    exact = np.fft.ifft(spec)[:, keep[0]:keep[0] + keep[1]]
    scale = np.abs(ref[0] + 1j * ref[1]).max()
    for a, r, e in zip(out, ref, (exact.real, exact.imag)):
        assert a.shape == (len(nr), keep[1])
        assert np.abs(a - r).max() / scale < 1e-5
        assert np.abs(a - e).max() / np.abs(exact).max() < 1e-6


def test_ifft_halfband_cpu_dispatch_and_checks():
    Zr, Zi, nr, ni = _zcase(3)
    before = COUNTS["launch.ssq_ifft_halfband"]
    got = fft_cuda.ifft_halfband_planar(Zr, Zi, None, nr, ni)
    assert COUNTS["launch.ssq_ifft_halfband"] == before
    ref = fft_cuda.ifft_halfband_planar_plain(Zr, Zi, None, nr, ni)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert got[0].shape == (3, 1 << 14)
    zero = fft_cuda.ifft_halfband_planar(Zr, Zi, (0, 100))
    ref0 = fft_cuda.ifft_halfband_planar_plain(
        Zr, Zi, (0, 100), np.zeros(3, np.float32), np.zeros(3, np.float32))
    assert all(torch.equal(a, b) for a, b in zip(zero, ref0))
    with pytest.raises(ValueError, match="both"):
        fft_cuda.ifft_halfband_planar(Zr, Zi, None, nr, None)
    with pytest.raises(ValueError, match="shape"):
        fft_cuda.ifft_halfband_planar(Zr, Zi[:, :2], None)


# -- cwt --------------------------------------------------------------------------
WAVELETS = {"gmw": "gmw", "gmw_b8": ("gmw", {"beta": 8.0}),
            "morlet": "morlet", "bump_om": ("bump", {"om": 0.5})}


def _signal(n=2048, seed=5):
    t = np.arange(n) / FS
    rng = np.random.default_rng(seed)
    return (np.cos(2 * np.pi * (30 * t + 50 * t * t)) +
            0.3 * rng.standard_normal(n)).astype(np.float32)


def _check_cwt(out, ref, bar=1e-5):
    """Each complex plane of `out` (torch) against `ref` (JAX): same
    shape, same NaN entries, max|d| / max|ref| < bar on the rest."""
    assert len(out) == len(ref)
    for a, r in zip(out, ref):
        r = np.asarray(r)
        if isinstance(a, torch.Tensor):
            a = a.numpy()
            assert a.shape == r.shape
            nan = np.isnan(r)
            assert np.array_equal(np.isnan(a), nan)
            assert _rel(a[~nan], r[~nan]) < bar
        else:
            assert np.array_equal(a, r)


@pytest.mark.parametrize("l1_norm", [True, False], ids=["l1", "l2"])
@pytest.mark.parametrize("derivative", [False, True], ids=["wx", "dwx"])
@pytest.mark.parametrize("wavelet", list(WAVELETS))
def test_cwt_matches_jax(wavelet, derivative, l1_norm):
    """gmw, morlet: the planar route (kernel D); bump with om != 0: the
    complex half-band route (kernel E). GMW at its default beta = 60
    with the energy norm overflows float32 (w^60) into NaN rows in both
    packages alike: the NaN entries are held equal."""
    x = _signal()
    kw = dict(nv=8, fs=FS, derivative=derivative, l1_norm=l1_norm)
    ref = J.cwt(x, WAVELETS[wavelet], dtype="float32", **kw)
    out = T.cwt(torch.as_tensor(x), WAVELETS[wavelet], **kw)
    _check_cwt(out, ref)


@pytest.mark.parametrize("n,padtype", [(2048, "reflect"), (2048, None),
                                       (1500, "reflect"), (1500, None),
                                       (1500, "zero"), (1500, "wrap")])
def test_cwt_padtypes_match_jax(n, padtype):
    """N = 2^k without padding takes the planar route on the signal
    itself; N = 1500 without padding the full-length route (plain FFTs)."""
    x = _signal(n)
    kw = dict(nv=8, fs=FS, derivative=True, padtype=padtype)
    _check_cwt(T.cwt(torch.as_tensor(x), **kw),
               J.cwt(x, dtype="float32", **kw))


@pytest.mark.parametrize("wavelet", ["gmw", "bump_om"])
def test_cwt_rpadded_matches_jax(wavelet):
    x = _signal(1500)
    kw = dict(nv=8, derivative=True, rpadded=True)
    out = T.cwt(torch.as_tensor(x), WAVELETS[wavelet], **kw)
    assert out[0].shape[-1] == 4096      # p2up(1500)
    _check_cwt(out, J.cwt(x, WAVELETS[wavelet], dtype="float32", **kw))


@pytest.mark.parametrize("wavelet", ["gmw", "bump_om"])
def test_cwt_batched_matches_single_and_jax(wavelet):
    """(2, N) input against each signal alone (1e-6 of max|Wx|: a batched
    FFT may be planned differently) and against JAX's batched call."""
    X = np.stack([_signal(seed=6), _signal(seed=7)])
    kw = dict(nv=8, derivative=True)
    Wb, sc, dWb = T.cwt(torch.as_tensor(X), WAVELETS[wavelet], **kw)
    assert Wb.shape[:2] == (2, len(sc))
    for i in range(2):
        Wi, _, dWi = T.cwt(torch.as_tensor(X[i]), WAVELETS[wavelet], **kw)
        assert _rel(Wb[i].numpy(), Wi.numpy()) < 1e-6
        assert _rel(dWb[i].numpy(), dWi.numpy()) < 1e-6
    _check_cwt((Wb, sc, dWb), J.cwt(X, WAVELETS[wavelet], dtype="float32",
                                    **kw))


@pytest.mark.parametrize("derivative", [False, True], ids=["wx", "dwx"])
def test_cwt_float64_matches_jax(derivative):
    """float64 takes the full-length route in both packages."""
    x = _signal().astype(np.float64)
    kw = dict(nv=8, fs=FS, derivative=derivative, dtype="float64")
    out = T.cwt(torch.as_tensor(x), **kw)
    assert out[0].dtype == torch.complex128
    _check_cwt(out, J.cwt(x, **kw), bar=1e-10)


@pytest.mark.parametrize("order,average", [(1, None), ((0, 1, 2), None),
                                           ((0, 1), False), ([1, 2], True)],
                         ids=["1", "012", "01_list", "12_avg"])
def test_cwt_higher_order_matches_jax(order, average):
    x = _signal()
    kw = dict(scales="log", nv=8, order=order, average=average,
              derivative=True)
    ref = J.cwt(x, "gmw", dtype="float32", **kw)
    out = T.cwt(torch.as_tensor(x), "gmw", **kw)
    if isinstance(ref[0], list):      # unaveraged orders: one per order
        assert len(out[0]) == len(ref[0])
        for k in range(len(ref[0])):
            _check_cwt((out[0][k], out[2][k]), (ref[0][k], ref[2][k]))
        assert np.array_equal(out[1], ref[1])
    else:
        _check_cwt(out, ref)


def test_cwt_nan_checks_and_cache_wavelet():
    """NaN input is zeroed; `cache_wavelet=True` (once refused) takes the
    cached filterbank and matches the JAX package's cached cwt at 1e-5."""
    x = _signal(1024)
    x[10] = np.nan
    Wx, _ = T.cwt(torch.as_tensor(x), nv=8)
    assert bool(torch.isfinite(Wx).all())
    _check_cwt((Wx,), (J.cwt(x, nv=8, dtype="float32")[0],))
    Wc, sc = T.cwt(torch.as_tensor(x), nv=8, cache_wavelet=True)
    _check_cwt((Wc, sc), J.cwt(x, nv=8, dtype="float32", cache_wavelet=True))
    _check_cwt((Wc,), (Wx.numpy(),))


# -- icwt -------------------------------------------------------------------------
def _echirp(n):
    t = np.linspace(0, 10, n, endpoint=False)
    return np.cos(2 * np.pi * 3 * np.exp(t / 3)), t


@pytest.mark.parametrize("one_int", [True, False], ids=["1int", "2int"])
@pytest.mark.parametrize("scales", ["log", "log-piecewise"])
def test_icwt_matches_jax(scales, one_int):
    """Inversion of the same Wx (JAX's float64 transform) in both
    packages, x_mean = 0.5 (added once), and each package's own round
    trip under the JAX tests' bars."""
    x, ts = _echirp(1024)
    wav = ("gmw", {"beta": 8.0}) if scales == "log" else "gmw"
    Wx, sc = J.cwt(x, wav, scales=scales, t=ts, dtype="float64")
    Wx = np.array(Wx)
    kw = dict(scales=sc, one_int=one_int, x_len=len(x), x_mean=0.5)
    ref = np.asarray(J.icwt(Wx, wav, **kw))
    out = T.icwt(torch.as_tensor(Wx), wav, **kw).numpy()
    assert out.shape == ref.shape and out.dtype == np.float64
    assert _rel(out, ref) < 1e-10
    bar = {(True, "log"): 0.1, (True, "log-piecewise"): 0.02}.get(
        (one_int, scales), 0.12)
    Wt, sct = T.cwt(torch.as_tensor(x), wav, scales=scales, t=ts,
                    dtype="float64")
    xr = T.icwt(Wt, wav, scales=sct, one_int=one_int, x_len=len(x))
    assert T.mad_rms(x, xr) < bar


def test_icwt_float32_and_batched():
    """float32 input (one- and two-integral) against JAX, and a (2, N)
    batch against each row."""
    x = np.stack([_signal(1024, 8), _signal(1024, 9)])
    Wx, sc = J.cwt(x, "gmw", scales="log", nv=16, dtype="float32")
    Wx = np.array(Wx)
    for one_int in (True, False):
        kw = dict(scales=sc, one_int=one_int)
        ref = np.asarray(J.icwt(Wx, "gmw", **kw))
        out = T.icwt(torch.as_tensor(Wx), "gmw", **kw)
        assert out.dtype == torch.float32
        assert _rel(out.numpy(), ref) < 1e-5
        for i in range(2):
            one = T.icwt(torch.as_tensor(Wx[i]), "gmw", **kw)
            assert _rel(out[i].numpy(), one.numpy()) < 1e-6


# -- phase transforms --------------------------------------------------------------
@pytest.fixture(scope="module")
def wx_pair():
    x = _signal(2048, 10)
    Wx, _, dWx = J.cwt(x, "gmw", nv=8, fs=FS, derivative=True,
                       dtype="float32")
    Wxp, _, _ = J.cwt(x, "gmw", nv=8, fs=FS, derivative=True,
                      dtype="float32", rpadded=True)
    return np.array(Wx), np.array(dWx), np.array(Wxp)


def _check_w(w, w_ref, Wx, gamma, bar=1e-4):
    w, w_ref = np.asarray(w), np.asarray(w_ref)
    assert w.shape == w_ref.shape
    assert (np.isinf(w) == np.isinf(w_ref)).mean() >= 0.999
    strong = (np.abs(Wx) ** 2 > 1e4 * gamma ** 2) & np.isfinite(w_ref)
    assert strong.mean() > 0.3
    rel = np.abs(w - w_ref)[strong] / np.abs(w_ref)[strong]
    assert (rel < bar).mean() >= 0.999


@pytest.mark.parametrize("difftype", ["trig", "phase"])
def test_phase_cwt_matches_jax(wx_pair, difftype):
    Wx, dWx, _ = wx_pair
    d = dWx if difftype == "trig" else None
    ref = J.phase_cwt(jnp.asarray(Wx), None if d is None else jnp.asarray(d),
                      difftype)
    out = T.phase_cwt(torch.as_tensor(Wx),
                      None if d is None else torch.as_tensor(d), difftype)
    _check_w(out.numpy(), ref, Wx, np.sqrt(np.finfo(np.float32).eps),
             1e-4 if difftype == "trig" else 1e-3)


@pytest.mark.parametrize("difforder", [1, 2, 4])
def test_phase_cwt_num_matches_jax(wx_pair, difforder):
    _, _, Wxp = wx_pair
    ref = J.phase_cwt_num(jnp.asarray(Wxp), 1 / FS, difforder)
    out = T.phase_cwt_num(torch.as_tensor(Wxp), 1 / FS, difforder)
    _check_w(out.numpy(), ref, Wxp, 10 * np.finfo(np.float32).eps)


def test_unwrap_is_numpys():
    rng = np.random.default_rng(14)
    p = np.cumsum(rng.uniform(-4, 4, (3, 500)), axis=-1)
    p[0, 7] = p[0, 6] + np.pi       # a jump of exactly pi stays
    p[1, 9] = p[1, 8] - np.pi
    out = unwrap(torch.as_tensor(p), dim=-1).numpy()
    np.testing.assert_allclose(out, np.unwrap(p, axis=-1), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(unwrap(torch.as_tensor(p.T), dim=0).numpy(),
                               np.unwrap(p.T, axis=0), rtol=0, atol=1e-9)


def test_trigdiff_matches_jax():
    x = _signal(1500, 11)
    Wxp, _ = J.cwt(x, "gmw", nv=8, rpadded=True, dtype="float32")
    Wxp = np.array(Wxp)
    ref = np.asarray(J.trigdiff(Wxp, FS, rpadded=True, N=1500, n1=274))
    out = T.trigdiff(torch.as_tensor(Wxp), FS, rpadded=True, N=1500, n1=274)
    assert out.shape == ref.shape
    assert _rel(out.numpy(), ref) < 1e-5
    Wx = Wxp[..., 274:274 + 1500]
    ref2 = np.asarray(J.trigdiff(Wx, FS))
    assert _rel(T.trigdiff(torch.as_tensor(Wx), FS).numpy(), ref2) < 1e-5


# -- the device rule of the entry points --------------------------------------------
def _entry_calls():
    x = np.zeros(512, np.float32)
    W = np.zeros((4, 512), np.complex64)
    S = np.zeros((33, 512), np.complex64)
    return {
        "cwt": lambda **k: T.cwt(x, nv=4, **k),
        "icwt": lambda **k: T.icwt(W, scales=np.geomspace(2, 16, 4), **k),
        "ssq_cwt": lambda **k: T.ssq_cwt(x, nv=4, **k),
        "issq_cwt": lambda **k: T.issq_cwt(W, **k),
        "stft": lambda **k: T.stft(x, n_fft=64, **k),
        "istft": lambda **k: T.istft(S, n_fft=64, **k),
        "ssq_stft": lambda **k: T.ssq_stft(x, n_fft=64, **k),
        "issq_stft": lambda **k: T.issq_stft(S, n_fft=64, **k),
    }


ENTRIES = ["cwt", "icwt", "ssq_cwt", "issq_cwt", "stft", "istft", "ssq_stft",
           "issq_stft"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_array_input_needs_cuda_or_device_cpu(monkeypatch, entry):
    """Array input goes to the CUDA device by default: without one it
    raises, naming device='cpu'; with device='cpu' it runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _entry_calls()[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    out = call(device="cpu")
    first = out[0] if isinstance(out, tuple) else out
    assert first.device.type == "cpu"


REPAIRED = ["ssqueeze", "trigdiff", "phase_cwt", "phase_stft",
            "phase_cwt_num"]


@pytest.mark.parametrize("entry", REPAIRED)
def test_array_input_device_rule_repaired(monkeypatch, wx_pair, entry):
    """ssqueeze, trigdiff and the phase transforms follow the device rule
    too (they squeezed or differentiated numpy input on the host before,
    even with a GPU): array input raises without a CUDA device; with
    device='cpu' it runs there and equals the JAX function."""
    Wx, dWx, Wxp = wx_pair
    Sfs = np.linspace(0, 0.5 * FS, Wx.shape[0]).astype(np.float32)
    scales = np.asarray(J.process_scales("log-piecewise", Wx.shape[-1], "gmw",
                                         nv=8))
    sq = dict(dWx=dWx, gamma=1e-6, scales=scales, fs=FS, maprange="peak",
              wavelet="gmw")
    calls = {
        "ssqueeze": (lambda **k: T.ssqueeze(Wx, **sq, **k)[0],
                     lambda: J.ssqueeze(Wx, **sq)[0]),
        "trigdiff": (lambda **k: T.trigdiff(Wx, FS, **k),
                     lambda: J.trigdiff(Wx, FS)),
        "phase_cwt": (lambda **k: T.phase_cwt(Wx, dWx, **k),
                      lambda: J.phase_cwt(jnp.asarray(Wx), jnp.asarray(dWx))),
        "phase_stft": (lambda **k: T.phase_stft(Wx, dWx, Sfs, **k),
                       lambda: J.phase_stft(jnp.asarray(Wx), jnp.asarray(dWx),
                                            jnp.asarray(Sfs))),
        "phase_cwt_num": (lambda **k: T.phase_cwt_num(Wxp, 1 / FS, **k),
                          lambda: J.phase_cwt_num(jnp.asarray(Wxp), 1 / FS)),
    }
    call, ref = calls[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    out = call(device="cpu")
    assert out.device.type == "cpu"
    ref = np.asarray(ref())
    if entry == "ssqueeze":      # bin-flip tolerant, as ssq_cwt's bars
        c, c_j = np.abs(out.numpy()).sum(-2), np.abs(ref).sum(-2)
        assert np.abs(c - c_j).max() < 1e-3 * c_j.max()
    elif entry == "trigdiff":
        assert _rel(out.numpy(), ref) < 1e-5
    else:
        _check_w(out.numpy(), ref, Wxp if entry == "phase_cwt_num" else Wx,
                 np.sqrt(np.finfo(np.float32).eps) if entry == "phase_cwt"
                 else 10 * np.finfo(np.float32).eps)


def test_tensor_input_stays_on_its_device():
    x = torch.as_tensor(_signal(512))
    Wx, _ = T.cwt(x, nv=4)
    assert Wx.device.type == "cpu"
    Wx2, _ = T.cwt(x.numpy(), nv=4, device="cpu")
    assert torch.equal(Wx, Wx2)


# -- kernel D's register-radix core and its row chunks -------------------------
# A numpy mirror of csrc/fft_radix.cuh, the register-radix FFT core of
# kernels D and F: its pass schedule, its shared-memory layout, and a model
# that runs the schedule with the kernel's own index maps and twiddle
# exponents.
#
# A column of P = 2^n points (2 <= P <= 4096) is transformed by Stockham
# passes. Each thread holds E points of a column in registers (16 where
# radix-16 passes need fewer passes than radix 8, else min(8, P)); a pass
# of radix R (E, then one smaller pass for what is left) does E/R radix-R
# DFTs in registers and exchanges the points through shared memory, so a
# column of 512 points takes 3 passes (8 8 8) and 1024 or 2048 take 3
# (16 16 4, 16 16 8) where radix 2 took 9, 10 and 11. Pass
# p of stride Ns reads butterfly b's inputs at b + r * P/R and writes its
# outputs at (b // Ns) * Ns * R + b % Ns + r * Ns after the twiddle
# w^((b % Ns) * r * P / (Ns * R)), w = e^(sign 2 pi i / P). The first pass
# reads only the first `n_in` inputs (the rest are zero) and the last one
# writes only outputs in [lo, hi).
#
# Columns go through `ncol(P)` at a time, `units(P)` slots a thread of a
# block of T = 256: slot u of thread t is unit t + u T, column unit % ncol
# and lane unit // ncol, so neighbouring threads work on neighbouring
# columns (the kernels' device-memory runs); slot-major (`pair`, kernel
# D's first launch with the derivative, two slots a thread) slot u of
# thread t is column u * ncu + t % ncu and lane t // ncu (ncu = ncol / 2),
# so a thread's slots hold one lane of ncu-apart columns (two pipelines of
# one column).
# A column lives at `col_stride(P, pair)` float2 in shared memory with one
# float2 of padding after every E points (`pad`), which `bank_ways` shows
# keeps the exchanges free of bank conflicts in both layouts. The tests
# below hold the model to torch.fft and count those conflicts.
THREADS = 256
MIN_P, MAX_P = 2, 4096


def _log(P: int) -> int:
    return P.bit_length() - 1


def points_per_thread(P: int) -> int:
    """E (Shape::E): 16 where radix-16 passes take fewer passes than
    radix 8 (P = 16, 128, 256, 1024, 2048, 4096), else min(8, P)."""
    log = _log(P)
    return 16 if -(-log // 4) < -(-log // 3) else min(8, P)


def units(P: int, pair: bool = False) -> int:
    """Slots (columns' lanes) a thread holds (Shape::U): 16 points a
    thread, 32 at P = 4096 (two columns in flight); two slots in the
    slot-major layout."""
    if P < 8 or pair:
        return 2
    return (2 if P == 4096 else 1) * 16 // points_per_thread(P)


def ncol(P: int, pair: bool = False) -> int:
    """Columns in flight in a block (Shape::NCOL)."""
    return units(P, pair) * THREADS // (P // points_per_thread(P))


def passes(P: int):
    """[(R, Ns), ...]: passes of radix E, then one of a smaller radix for
    the rest."""
    if P < MIN_P or P > MAX_P or P & (P - 1):
        raise ValueError(f"P={P}: the core takes powers of two in "
                         f"[{MIN_P}, {MAX_P}]")
    log, le = _log(P), _log(points_per_thread(P))
    radices = [1 << le] * (log // le) + ([1 << (log % le)] if log % le
                                        else [])
    out, ns = [], 1
    for R in radices:
        out.append((R, ns))
        ns *= R
    return out


def pad(i, P: int):
    """Padded shared-memory index of point i of a column of P: one float2
    of padding after every E points."""
    return i + (i >> _log(points_per_thread(P)))


def _ncu(P: int, pair: bool) -> int:
    """Columns side by side in a warp's slot (Shape::NCU)."""
    return ncol(P, pair) // 2 if pair else ncol(P)


def slot(t: int, u: int, P: int, pair: bool = False):
    """(column, lane) of slot u of thread t (fftr::units)."""
    if pair:
        ncu = _ncu(P, pair)
        return u * ncu + t % ncu, t // ncu
    unit = t + u * THREADS
    return unit % ncol(P), unit // ncol(P)


def col_stride(P: int, pair: bool = False) -> int:
    """float2 between neighbouring columns in shared memory (Shape::LD):
    the padded length plus 16 / ncu (at least 1), which spreads the
    columns a half-warp touches over the banks."""
    return pad(P, P) + max(1, 16 // _ncu(P, pair))


def _dft(v, sign):
    """Radix-R DFT of the last axis, as the kernel's butterflies."""
    R = v.shape[-1]
    k = np.arange(R)
    return v @ np.exp(sign * 2j * np.pi * np.outer(k, k) / R)


def model_fft(x, sign=1, n_in=None, lo=0, hi=None):
    """The core's schedule on columns x (..., P), complex128: unnormalised
    DFT with e^(sign 2 pi i k n / P), only the first `n_in` inputs read,
    outputs outside [lo, hi) left zero."""
    x = np.asarray(x, np.complex128)
    P = x.shape[-1]
    n_in = P if n_in is None else n_in
    hi = P if hi is None else hi
    E = points_per_thread(P)
    tpc = P // E
    plan = passes(P)
    cur = x.copy()
    cur[..., n_in:] = 0
    for p, (R, ns) in enumerate(plan):
        nxt = np.zeros_like(cur)
        for j in range(tpc):
            for s in range(E // R):
                b = j + s * tpc
                r = np.arange(R)
                v = cur[..., b + r * (P // R)]
                if ns > 1:
                    m = (b % ns) * r * (P // (ns * R))
                    v = v * np.exp(sign * 2j * np.pi * m / P)
                v = _dft(v, sign)
                nxt[..., (b // ns) * ns * R + b % ns + r * ns] = v
        cur = nxt
    out = np.zeros_like(cur)
    out[..., lo:hi] = cur[..., lo:hi]
    return out


def bank_ways(P: int, pair: bool = False):
    """The worst n-way bank conflict of the core's shared-memory exchanges
    (every pass's writes and the next pass's reads) in the kernels' block
    layout: float2 accesses go in half-warps of 16 threads over 32 banks
    of 4 bytes; 1 is conflict-free."""
    E = points_per_thread(P)
    tpc = P // E
    ld = col_stride(P, pair)
    plan = passes(P)
    worst = 1
    for u0 in range(units(P, pair)):
        for t0 in range(0, THREADS, 16):
            half = [slot(t, u0, P, pair) for t in range(t0, t0 + 16)]
            for p, (R, ns) in enumerate(plan):
                for s in range(E // R):
                    for r in range(R):
                        for kind in ("write", "read"):
                            if kind == "write" and p == len(plan) - 1:
                                continue
                            if kind == "read" and p == 0:
                                continue
                            words = {}
                            for c, j in half:
                                b = j + s * tpc
                                if kind == "write":
                                    i = (b // ns) * ns * R + b % ns + r * ns
                                else:
                                    i = b + r * (P // R)
                                a = 2 * (c * ld + pad(i, P))
                                for w in (a, a + 1):
                                    words.setdefault(w % 32, set()).add(w)
                            worst = max(worst, max(len(v) for v in
                                                   words.values()))
    return worst


@pytest.mark.parametrize("P", [1 << k for k in range(1, 13)])
def test_radix_core_schedule_matches_torch_fft(P):
    """The pass schedule of csrc/fft_radix.cuh (index maps and twiddle
    exponents, `model_fft`) is the unnormalised DFT: equal to
    torch.fft.ifft * P (sign +, D's) and torch.fft.fft (sign -, F's
    forward) within 1e-12 of the largest output, in full and pruned as D
    and F prune it (only the first P/2 inputs nonzero; only outputs in a
    window wanted)."""
    rng = np.random.default_rng(P)
    x = rng.standard_normal((3, P)) + 1j * rng.standard_normal((3, P))
    lo, hi = P // 5, P - P // 3
    for sign, ref_fn in ((1, lambda a: torch.fft.ifft(a) * P),
                         (-1, torch.fft.fft)):
        ref = ref_fn(torch.as_tensor(x)).numpy()
        assert _rel(model_fft(x, sign), ref) < 1e-12
        half = x.copy()
        half[:, P // 2:] = 0
        ref = ref_fn(torch.as_tensor(half)).numpy()
        out = model_fft(x, sign, n_in=P // 2, lo=lo, hi=hi)
        assert _rel(out[:, lo:hi], ref[:, lo:hi]) < 1e-12
        assert not out[:, :lo].any() and not out[:, hi:].any()
    # radix-8 or radix-16 passes, then one smaller: the fewer passes of
    # the two, 512 points in 3 (8 8 8), 1024 and 2048 in 3 (16 16 4, 8)
    plan = passes(P)
    log = P.bit_length() - 1
    assert np.prod([R for R, _ in plan]) == P
    assert len(plan) == min(-(-log // 3), -(-log // 4))


@pytest.mark.parametrize("pair", [False, True], ids=["cols", "slots"])
@pytest.mark.parametrize("P", [1 << k for k in range(1, 13)])
def test_radix_core_layout_is_free_of_bank_conflicts(P, pair):
    """The core's shared-memory layout (a float2 of padding after every E
    points, the column stride of Shape::LD) keeps every exchange of every
    pass free of bank conflicts in both of the kernels' block layouts
    (256 threads; neighbouring threads on neighbouring columns, or
    slot-major)."""
    assert ncol(P, pair) >= 2
    assert bank_ways(P, pair) == 1


def model_launch1(Z):
    """Launch 1 of kernels D, E and A in numpy (complex128): the row's k2
    columns of the half spectrum Z (..., K1, M2), k1 < M1/2 and the rest
    zero, through the core's schedule `model_fft` (sign +, only the first
    M1/2 inputs read), times the twiddle e^(2 pi i n1 k2 / M): the
    intermediate Y (..., n1, k2) (csrc/cwt_pair.cuh cwt_d_stage1)."""
    K1, M2 = Z.shape[-2:]
    M1 = 2 * K1
    cols = np.zeros(Z.shape[:-2] + (M2, M1), complex)
    cols[..., :K1] = np.swapaxes(Z, -1, -2)
    n1, k2 = np.arange(M1), np.arange(M2)
    return np.swapaxes(model_fft(cols, 1, n_in=K1) *
                       np.exp(2j * np.pi * np.outer(k2, n1) / (M1 * M2)),
                       -1, -2)


def model_e_route(Zr, Zi, nr, ni, keep):
    """Kernel E's route in numpy (complex128): D's launch 1 over each row's
    k2 columns with E's loader (Z[k1, k2] from the row's planes,
    `model_launch1`); D's launch 2 over the n1 rows of Y, `model_fft`
    wanting only the n2 in [r0, r1) that cover the keep window, and the
    store j = n1 + M1 n2 - start of (v + nyq (-1)^n1) / M
    (csrc/cwt_pair.cuh cwt_d_stage2 with PlanesStore). Returns (rows, L)
    complex."""
    B, K1, M2 = Zr.shape
    M1 = 2 * K1
    M, log1 = M1 * M2, _log(M1)
    start, L = keep
    n1 = np.arange(M1)
    Y = model_launch1(Zr + 1j * Zi.astype(np.float64))
    r0, r1 = start >> log1, ((start + L - 1) >> log1) + 1
    V = model_fft(Y, 1, lo=r0, hi=r1)                  # (B, n1, n2)
    nyq = (nr + 1j * ni.astype(np.float64))[:, None]
    out = np.zeros((B, L), complex)
    for n2 in range(r0, r1):
        j = n1 + M1 * n2 - start
        ok = (j >= 0) & (j < L)
        out[:, j[ok]] = (V[:, n1[ok], n2] +
                         nyq * np.where(n1[ok] % 2, -1, 1)) / M
    return out


def model_a_route(Pw, xr, xi, xig, inv_dt, nyq_w, nyq_d, keep, gamma2):
    """Kernel A's route in numpy (complex128): D's launch 1 with D's loader
    (Z = Pw x^ and dZ = i Z xig / dt, rows b-major; `model_launch1`), then
    launch 2 in the core's slot-major layout (PhaseStore): block y, thread
    t, slot u holds column `slot(t, u, M2, pair=True)`, that is pipeline
    u of n1 = y ncu + column % ncu, so one thread holds Wx and dWx of each
    of its outputs and forms w = |B C - A D| / (|Wx|^2 2 pi), +inf where
    |Wx|^2 <= gamma2. Every kept output is written once. Returns (Wxr,
    Wxi, w), each (rows, L)."""
    na, K1, M2 = Pw.shape
    M1 = 2 * K1
    M, log1 = M1 * M2, _log(M1)
    start, L = keep
    Z = (Pw[None].astype(np.float64) *
         (xr[:, None] + 1j * xi[:, None].astype(np.float64))
         ).reshape(-1, K1, M2)
    s = xig.astype(np.float64) * np.float64(inv_dt)
    Y = model_launch1(np.stack([Z, 1j * Z * s]))       # (2, rows, n1, k2)
    r0, r1 = start >> log1, ((start + L - 1) >> log1) + 1
    V = model_fft(Y, 1, lo=r0, hi=r1)                  # (2, rows, n1, n2)
    nyq = [np.asarray(a, np.float64) + 1j * np.asarray(b, np.float64)
           for a, b in (nyq_w, nyq_d)]
    ncu, E = _ncu(M2, True), points_per_thread(M2)
    tpc = M2 // E
    out = np.zeros((3, Z.shape[0], L))
    hits = np.zeros(L, int)
    for y in range(-(-M1 // ncu)):
        for t in range(THREADS):
            (c0, lane), (c1, lane1) = (slot(t, u, M2, pair=True)
                                       for u in (0, 1))
            assert (c0 // ncu, c1 // ncu) == (0, 1) and lane1 == lane
            assert c0 % ncu == c1 % ncu
            n1 = y * ncu + c0 % ncu
            if n1 >= M1:
                continue
            n2 = lane + tpc * np.arange(E)
            j = n1 + M1 * n2 - start
            ok = (n2 >= r0) & (n2 < r1) & (j >= 0) & (j < L)
            alt = (-1) ** n1 / M
            W, dW = (V[p][:, n1, n2[ok]] / M + nyq[p][:, None] * alt
                     for p in (0, 1))
            mag2 = np.abs(W) ** 2
            ratio = (dW.imag * W.real - dW.real * W.imag) / (mag2 * 2 * np.pi)
            out[0][:, j[ok]], out[1][:, j[ok]] = W.real, W.imag
            out[2][:, j[ok]] = np.where(mag2 > gamma2, np.abs(ratio), np.inf)
            hits[j[ok]] += 1
    assert (hits == 1).all()
    return out


@pytest.mark.parametrize("keep", [(0, 1 << 14), (3000, 9000)],
                         ids=["all", "window"])
def test_e_route_model_matches_plain_and_jax(keep):
    """Kernel E's route (D's launch pair with E's loader and Nyquist
    term, `model_e_route`) at N = 9000 (M = 2^14 = 128 x 128), keep
    (0, M) and a window from a nonzero start: within 1e-5 of max|out| of
    `ifft_halfband_planar_plain` and of the JAX package's
    `ifft_halfband_planar_fused` (interpret mode; the existing bar between
    the two), and 1e-12 of the float64 transform (the model is the
    kernel's schedule in complex128)."""
    Zr, Zi, nr, ni = _zcase()
    out = model_e_route(Zr, Zi, nr, ni, keep)
    plain = fft_cuda.ifft_halfband_planar_plain(Zr, Zi, keep, nr, ni)
    ref = ifft_halfband_planar_fused(
        jnp.asarray(Zr), jnp.asarray(Zi), keep=keep, nyq_r=jnp.asarray(nr),
        nyq_i=jnp.asarray(ni), interpret=True)
    M = 1 << 14
    spec = np.zeros((len(nr), M), complex)
    spec[:, :M // 2] = (Zr + 1j * Zi.astype(np.float64)).reshape(len(nr), -1)
    spec[:, M // 2] = nr + 1j * ni.astype(np.float64)
    exact = np.fft.ifft(spec)[:, keep[0]:keep[0] + keep[1]]
    assert out.shape == (len(nr), keep[1])
    assert _rel(out, exact) < 1e-12
    for r in (plain, ref):
        got = np.asarray(r[0]) + 1j * np.asarray(r[1])
        assert _rel(out, got) < 1e-5


def test_e_chunks_rows_as_d(monkeypatch):
    """Kernel E's wrapper sizes its row chunks as D's with one pipeline
    (`d_chunk_rows(M, 1, rows)`, Y within the L2 budget), not by the 2 GB
    cap the adjoints keep: read off the entry point's arguments with the
    library stubbed, at the budget and at one of two rows' Y."""
    from ssqueeze_rs_tpu_torch import _build
    calls = []

    class Lib:
        def ssq_ifft_halfband(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_build, "_LIB", Lib())
    monkeypatch.setattr(fft_cuda, "_stream", lambda device: None)
    Zr, Zi, nr, ni = (torch.as_tensor(a) for a in _zcase(7))
    M = 1 << 14
    for budget in (fft_cuda._D_Y_BYTES, 2 * M * 8):
        monkeypatch.setattr(fft_cuda, "_D_Y_BYTES", budget)
        fft_cuda._ifft_halfband_cuda(torch.device("cpu"), Zr, Zi, nr, ni,
                                     (0, M))
        assert calls[-1][10] == fft_cuda.d_chunk_rows(M, 1, 7)
    assert [c[10] for c in calls] == [7, 2]


@pytest.mark.parametrize("keep", ["signal", "all"])
def test_a_route_model_matches_plain_a(kcase, keep):
    """Kernel A's route (D's launch 1 with D's loader, launch 2 in the
    slot-major layout with the phase store, `model_a_route`) at N = 9000
    (M = 2^14 = 128 x 128), keep (n1, N) and (0, M), gives plain A's
    (`cwt_phase_plain`) Wx within 1e-5 of max|Wx| and its w by the bars of
    test_torch_cwt_phase.py: where |Wx|^2 > 1e4 gamma^2, relative error
    < 1e-4 on >= 99.9 % of entries, and the +inf mask on >= 99.9 %; the
    model writes every kept output once."""
    a = _args(kcase, 1)
    M = kcase["M"]
    keep = (kcase["n1"], N) if keep == "signal" else (0, M)
    gamma = 1e-5
    gamma2 = float(np.float32(gamma ** 2))
    wr, wi, w = model_a_route(*a, keep=keep, gamma2=gamma2)
    pr, pi_, pw = (t.numpy() for t in fft_cuda.cwt_phase_plain(
        *a, keep=keep, gamma=gamma))
    assert wr.shape == pr.shape == (kcase["na"], keep[1])
    assert _rel(wr, pr) < 1e-5 and _rel(wi, pi_) < 1e-5
    strong = pr ** 2 + pi_ ** 2 > 1e4 * gamma2
    w_rel = np.abs(w - pw)[strong] / np.abs(pw)[strong]
    assert (w_rel < 1e-4).mean() >= 0.999
    assert (np.isinf(w) == np.isinf(pw)).mean() >= 0.999


def test_a_chunks_rows_as_d(monkeypatch, kcase):
    """Kernel A's wrapper sizes its row chunks as D's with the derivative
    (`d_chunk_rows(M, 2, rows)`, Y within the L2 budget), no longer by
    the 2 GB cap the adjoints keep: read off the entry point's arguments
    with the library stubbed, at the budget and at two rows' Y."""
    from ssqueeze_rs_tpu_torch import _build
    calls = []

    class Lib:
        def ssq_cwt_phase(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_build, "_LIB", Lib())
    monkeypatch.setattr(fft_cuda, "_stream", lambda device: None)
    _, Pw, xr, xi, xig, nyq = fft_cuda._prepare(*_args(kcase, 2)[:4],
                                                *_args(kcase, 2)[5:])
    M, rows = kcase["M"], 2 * kcase["na"]
    for budget in (fft_cuda._D_Y_BYTES, 2 * 2 * M * 8):
        monkeypatch.setattr(fft_cuda, "_D_Y_BYTES", budget)
        fft_cuda._cwt_phase_cuda(torch.device("cpu"), Pw, xr, xi, xig, 1.0,
                                 nyq, (0, M), 1e-5)
        assert calls[-1][17] == fft_cuda.d_chunk_rows(M, 2, rows)
    assert [c[17] for c in calls] == [rows, 2]


@pytest.mark.parametrize("pipes", [1, 2])
@pytest.mark.parametrize("logM", range(4, 23))
def test_d_chunk_planner_covers_every_row_once(logM, pipes):
    """Kernel D's row chunks (E's with one pipeline): at least one row a
    chunk, an intermediate within the L2 budget whenever one row fits it,
    and chunks that cover every row once, in order, for one row, a few and
    the headline's 293 and 2 x 293."""
    M = 1 << logM
    assert fft_cuda.best_split(M) is not None
    for rows in (1, 7, 293, 586):
        step = fft_cuda.d_chunk_rows(M, pipes, rows)
        assert 1 <= step <= rows
        if pipes * M * 8 <= fft_cuda._D_Y_BYTES:
            assert pipes * step * M * 8 <= fft_cuda._D_Y_BYTES
        else:
            assert step == 1
        # the chunk loop of ssq_cwt_planes (csrc/cwt_planes.cu)
        chunks = [(r0, min(step, rows - r0)) for r0 in range(0, rows, step)]
        assert all(n >= 1 for _, n in chunks)
        covered = [r for r0, n in chunks for r in range(r0, r0 + n)]
        assert covered == list(range(rows))
