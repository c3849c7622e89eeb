"""The torch port's `ssq_stft` / `issq_stft` (and `issq_cwt`'s component
inversion) against the JAX package, float32, on the CPU: the fused route
(plain G, `ssq_stft_fused_plain`) against the JAX kernel G in interpret
mode, and the two-kernel route (plain F + plain B') against the JAX XLA
route, at N = 2000, n_fft = 256.

Tolerances:
  Sx, dSx max|d| / max|S_jax| < 2e-6 (the JAX kernels' own bar)
  Tx      bin-flip tolerant: max over columns of |sum_k |Tx| - sum_k |Tx_jax||
          < 1e-3 of the largest column marginal, the JAX package's own bar
          between its fused and two-kernel routes (an ulp of the phase can
          move a whole entry to the neighbouring bin)
  w       the infinity mask agrees on >= 99.9 % of entries; finite values
          where |Sx| > 100 gamma within 1e-4 relative on >= 99.9 % (w is
          ill-conditioned where |Sx| is small)
  x       issq_stft / issq_cwt: max|d| / max|x_jax| < 1e-5
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ssqueeze_rs_tpu import (ssq_stft as j_ssq_stft, issq_stft as j_issq_stft,
                             issq_cwt as j_issq_cwt)
from ssqueeze_rs_tpu_torch import ssq_stft, issq_stft, issq_cwt, ssqueeze
from ssqueeze_rs_tpu_torch.trace import COUNTS
from ssqueeze_rs_tpu_torch.utils.common import as_signal

N, N_FFT, FS = 2000, 256, 1000.0


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _signal(seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(N) / FS
    return (np.cos(2 * np.pi * 97 * t) + 0.2 * rng.standard_normal(N)
            ).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _col_rel(Tx, Tx_j):
    c, c_j = np.abs(np.asarray(Tx)).sum(-2), np.abs(np.asarray(Tx_j)).sum(-2)
    return np.abs(c - c_j).max() / c_j.max()


def _jax(monkeypatch, kernels, **kw):
    monkeypatch.setenv("SSQ_TPU_KERNELS", "1" if kernels else "0")
    jax.clear_caches()
    out = j_ssq_stft(_signal(), n_fft=N_FFT, fs=FS, dtype="float32", **kw)
    monkeypatch.delenv("SSQ_TPU_KERNELS")
    jax.clear_caches()
    return [np.asarray(a) for a in out]


def _counts():
    return tuple(COUNTS["launch." + k] for k in (
        "ssq_stft_dft", "ssq_stft_fused", "ssq_istft_ola", "ssq_reassign",
        "ssq_reassign4"))


def test_fused_route_matches_jax_kernel(monkeypatch):
    """Plain G against the JAX kernel G (interpret mode)."""
    Tj, Sj, fj, sfj = _jax(monkeypatch, True)
    before = _counts()
    Tx, Sx, f, sf = ssq_stft(_signal(), device="cpu", n_fft=N_FFT, fs=FS)
    assert _counts() == before
    assert Tx.dtype == Sx.dtype == torch.complex64
    assert Tx.shape == Sx.shape == Tj.shape == (N_FFT // 2 + 1, N)
    assert np.array_equal(f, fj) and np.array_equal(sf, sfj)
    assert _rel(Sx.numpy(), Sj) < 2e-6
    assert _col_rel(Tx.numpy(), Tj) < 1e-3


@pytest.mark.parametrize("kw", [dict(hop_len=2), dict(flipud=True),
                                dict(ssq_freqs="Sfs")],
                         ids=["hop2", "flipud", "ssq_freqs"])
def test_two_kernel_route_matches_jax(monkeypatch, kw):
    """Plain F (or the hop-2 product) + plain B' against the JAX XLA
    route, and the ssq_freqs flip rule."""
    if kw.get("ssq_freqs") == "Sfs":
        kw = dict(ssq_freqs=np.linspace(0, FS / 2, N_FFT // 2 + 1,
                                        dtype=np.float32))
    Tj, Sj, fj, sfj = _jax(monkeypatch, False, **kw)
    Tx, Sx, f, sf = ssq_stft(_signal(), device="cpu", n_fft=N_FFT, fs=FS, **kw)
    assert Tx.shape == Tj.shape and Sx.shape == Sj.shape
    assert np.array_equal(f, fj) and np.array_equal(sf, sfj)
    assert _rel(Sx.numpy(), Sj) < 2e-6
    assert _col_rel(Tx.numpy(), Tj) < 1e-3


def test_fused_route_equals_two_kernel_route():
    """Plain G and plain F + plain B' on the same input put >= 99.9 % of
    the entries in the same bins with the same values (on the CPU they are
    the same code; on the card chip_smoke holds kernel G to kernels F and
    B' the same way)."""
    x = _signal(1)
    Sfs = np.linspace(0, FS / 2, N_FFT // 2 + 1, dtype=np.float32)
    Tg, Sg, *_ = ssq_stft(x, device="cpu", n_fft=N_FFT, fs=FS)
    Tb, Sb, *_ = ssq_stft(x, device="cpu", n_fft=N_FFT, fs=FS, ssq_freqs=Sfs)
    assert torch.equal(Sg, Sb)
    top = float(Tb.abs().max())
    assert float(((Tg - Tb).abs() <= 1e-6 * top).float().mean()) >= 0.999


def test_get_w_and_get_dWx_match_jax(monkeypatch):
    """get_w: the phase plane (`phase_stft`) and the w route through
    kernel B; get_dWx: dSx."""
    Tj, Sj, _, _, wj, dSj = _jax(monkeypatch, False, get_w=True,
                                 get_dWx=True)
    Tx, Sx, _, _, w, dSx = ssq_stft(_signal(), device="cpu", n_fft=N_FFT,
                                    fs=FS, get_w=True, get_dWx=True)
    assert _rel(dSx.numpy(), dSj) < 2e-6
    assert _col_rel(Tx.numpy(), Tj) < 1e-3
    w = w.numpy()
    assert np.mean(np.isinf(w) == np.isinf(wj)) >= 0.999
    strong = np.abs(Sj) > 100 * 10 * np.finfo(np.float32).eps
    ok = np.abs(w - wj)[strong] <= 1e-4 * np.abs(wj)[strong]
    assert ok.mean() >= 0.999
    _, _, _, _, dSx2 = ssq_stft(_signal(), device="cpu", n_fft=N_FFT, fs=FS,
                                get_dWx=True)
    assert torch.equal(dSx2, dSx)


@pytest.mark.parametrize("squeezing", ["abs", "lebesgue"])
def test_squeezing_matches_jax(monkeypatch, squeezing):
    """'abs' and 'lebesgue' squeeze the transformed Sx, with the phase
    from the transformed Sx too (the reference quirk)."""
    Tj, *_ = _jax(monkeypatch, False, squeezing=squeezing)
    Tx, *_ = ssq_stft(_signal(), device="cpu", n_fft=N_FFT, fs=FS,
                      squeezing=squeezing)
    assert _col_rel(Tx.numpy(), Tj) < 1e-3


def test_issq_stft_matches_jax():
    Tx = ssq_stft(_signal(2), device="cpu", n_fft=N_FFT)[0]
    xj = np.asarray(j_issq_stft(jnp.asarray(Tx.numpy()), n_fft=N_FFT))
    x = issq_stft(Tx, device="cpu", n_fft=N_FFT)
    assert x.shape == (N,) and _rel(x.numpy(), xj) < 1e-5
    assert np.mean(np.abs(x.numpy() - _signal(2))) < 0.1


def _curves(nf, n, seed):
    rng = np.random.default_rng(seed)
    cc = np.stack([rng.integers(0, nf, n), rng.integers(0, nf, n)], -1)
    cc[::7, 1] = -1                                 # an absent curve
    cw = rng.integers(1, 6, (n, 2))
    return cc, cw


@pytest.mark.parametrize("which", ["cwt", "stft", "stft_batched"])
def test_component_inversion_matches_jax(which):
    """cc/cw component inversion: one row per curve band plus the
    residual, for issq_cwt and issq_stft (and a batch of two)."""
    nf, n = 129, 300
    rng = np.random.default_rng(3)
    shape = (2, nf, n) if which == "stft_batched" else (nf, n)
    Tx = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
          ).astype(np.complex64)
    cc, cw = _curves(nf, n, 4)
    if which == "cwt":
        x = issq_cwt(torch.as_tensor(Tx), "gmw", cc=cc, cw=cw)
        xj = j_issq_cwt(jnp.asarray(Tx), "gmw", cc=cc, cw=cw)
    else:
        x = issq_stft(torch.as_tensor(Tx), cc=cc, cw=cw)
        xj = j_issq_stft(jnp.asarray(Tx), cc=cc, cw=cw)
    assert x.shape == np.shape(xj) == shape[:-2] + (3, n)
    assert _rel(x.numpy(), xj) < 1e-5


def test_unported_raise():
    """float64 (once refused) runs: ssq_stft within the float64 bars of
    the JAX package's (Sx 1e-10 of max|Sx|, Tx 1e-9 of sum|Tx|), and
    `ssqueeze` of a complex128 Wx gives complex128 Tx; a signal that
    requires grad stays in its graph and gets a finite gradient through
    ssq_stft (tests/test_torch_grad.py holds it to jax.grad)."""
    x64 = _signal().astype(np.float64)
    Tx, Sx, f, _ = ssq_stft(x64, device="cpu", n_fft=N_FFT, dtype="float64")
    Tx_j, Sx_j, f_j, _ = (np.asarray(a) for a in j_ssq_stft(
        x64, n_fft=N_FFT, dtype="float64"))
    assert Tx.dtype == Sx.dtype == torch.complex128
    assert np.array_equal(f, f_j)
    assert np.abs(Sx.numpy() - Sx_j).max() < 1e-10 * np.abs(Sx_j).max()
    assert np.abs(Tx.numpy() - Tx_j).max() <= 1e-9 * np.abs(Tx_j).sum()
    Tw, _ = ssqueeze(np.ones((5, 40), np.complex128), w=np.full((5, 40), 0.5),
                     ssq_freqs=np.linspace(0, 1, 5), transform="stft",
                     device="cpu")
    assert Tw.dtype == torch.complex128 and bool(torch.isfinite(Tw).all())
    x = torch.tensor(_signal(), requires_grad=True)
    assert as_signal(x) is x
    Tx, Sx, *_ = ssq_stft(x, device="cpu", n_fft=N_FFT, fs=FS)
    ((Tx.abs() ** 2).sum() + (Sx.abs() ** 2).sum()).backward()
    assert x.grad.shape == x.shape and bool(torch.isfinite(x.grad).all())
