"""The torch port's STFT family (`stft`, `istft` and their kernels' plain
versions, F = `stft_dft_plain`, H = `istft_ola_plain`) against the JAX
package, float32, on the CPU.

References: the JAX XLA route (the default off-TPU), which the JAX
package's own tests hold to its Pallas kernels within 2e-6
(tests/test_stft_pallas.py), and the Pallas kernels themselves in
interpret mode (SSQ_TPU_KERNELS=1) at n_fft = 121, where interpretation
is quick.

Tolerances:
  host constants (windows, DFT and irfft matrices, window norm): exact,
          or rtol 1e-12 where the two packages sum in float64
  Sx, dSx max|d| / max|S_jax| < 2e-6: the JAX kernels' own bar; both
          sides sum the same float32 products (598 at most) in other orders
  x       istft: max|d| / max|x_jax| < 2e-6, the same bar
  round trip mad_rms(x, istft(stft(x))) < 1e-5 (the JAX package's bar)
"""
import sys

import numpy as np
import pytest
import torch
import jax

from ssqueeze_rs_tpu import stft as j_stft, istft as j_istft
from ssqueeze_rs_tpu.utils import windows as j_windows
from ssqueeze_rs_tpu_torch import stft, istft, get_window, mad_rms
from ssqueeze_rs_tpu_torch.ops import stft_cuda
from ssqueeze_rs_tpu_torch.utils import windows as t_windows

# the modules (the packages export functions of the same names)
j_stft_mod = sys.modules["ssqueeze_rs_tpu.ops.stft"]
t_stft_mod = sys.modules["ssqueeze_rs_tpu_torch.ops.stft"]

N, FS = 4000, 10.0


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _signal(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_kernels(monkeypatch, on):
    """Route the JAX package through its Pallas kernels (interpret mode)
    or its XLA route; the flag is read when a program is built."""
    monkeypatch.setenv("SSQ_TPU_KERNELS", "1" if on else "0")
    jax.clear_caches()
    j_stft_mod._stft_program.cache_clear()


WINDOWS = {   # (window, win_len, n_fft)
    "dpss598": (None, 598, 598),
    "hann256": ("hann", 256, 256),
    "dpss121": (None, 121, 121),
    "dpss100_in128": (None, 100, 128),
    "array64": (np.hanning(64), 64, 64),
}


@pytest.mark.parametrize("case", list(WINDOWS.values()), ids=list(WINDOWS))
def test_windows_match_jax(case):
    window, win_len, n_fft = case
    for dtype in ("float32", "float64"):
        w_t, dw_t = get_window(window, win_len, n_fft, derivative=True,
                               dtype=dtype)
        w_j, dw_j = j_windows.get_window(window, win_len, n_fft,
                                         derivative=True, dtype=dtype)
        assert w_t.dtype == w_j.dtype and np.array_equal(w_t, w_j)
        assert np.array_equal(dw_t, dw_j)
    for hop in (1, 4):
        assert t_windows.check_nola(w_t, hop) == j_windows.check_nola(w_j, hop)
        for win_exp in (0, 1, 2):
            np.testing.assert_allclose(
                t_windows.window_norm(w_t, hop, n_fft, 6000, win_exp),
                j_windows.window_norm(w_j, hop, n_fft, 6000, win_exp),
                rtol=1e-12, atol=0)


@pytest.mark.parametrize("n_fft", [598, 256, 121])
def test_dft_and_irfft_matrices_match_jax(n_fft):
    w = get_window(None, n_fft, n_fft, dtype="float32")
    for modulated in (True, False):
        assert np.array_equal(t_stft_mod._dft_matrix(w, n_fft, modulated),
                              j_stft_mod._dft_matrix(w, n_fft, modulated))
        for a, b in zip(t_stft_mod._irfft_mats(n_fft, modulated),
                        j_stft_mod._irfft_mats(n_fft, modulated)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("n_fft", [598, 256, 121])
def test_stft_matches_jax(monkeypatch, n_fft):
    """Plain F (hop 1) with the derivative against the JAX XLA route."""
    _jax_kernels(monkeypatch, False)
    x = _signal(N)
    Sj, dSj = j_stft(x, n_fft=n_fft, fs=FS, derivative=True, dtype="float32")
    before = dict(stft_cuda.LAUNCHES)
    Sx, dSx = stft(x, device="cpu", n_fft=n_fft, fs=FS, derivative=True)
    assert stft_cuda.LAUNCHES == before
    assert Sx.dtype == torch.complex64 and Sx.shape == Sj.shape
    assert _rel(Sx.numpy(), Sj) < 2e-6
    assert _rel(dSx.numpy(), dSj) < 2e-6


def test_stft_batch_matches_jax(monkeypatch):
    _jax_kernels(monkeypatch, False)
    x = _signal((2, N), seed=1)
    Sj, dSj = j_stft(x, n_fft=256, fs=FS, derivative=True, dtype="float32")
    Sx, dSx = stft(torch.as_tensor(x), n_fft=256, fs=FS, derivative=True)
    assert Sx.shape == Sj.shape == (2, 129, N)
    assert _rel(Sx.numpy(), Sj) < 2e-6 and _rel(dSx.numpy(), dSj) < 2e-6
    one = stft(x[1], device="cpu", n_fft=256)
    torch.testing.assert_close(Sx[1], one, rtol=0, atol=0)


def test_stft_matches_jax_kernel(monkeypatch):
    """Plain F against the JAX kernel F itself (interpret mode), n_fft
    121, derivative on, unmodulated (dSx scaled by fs all the same)."""
    _jax_kernels(monkeypatch, True)
    x = _signal(1500, seed=2)
    Sj, dSj = j_stft(x, n_fft=121, fs=FS, derivative=True, modulated=False,
                     dtype="float32")
    Sx, dSx = stft(x, device="cpu", n_fft=121, fs=FS, derivative=True,
                   modulated=False)
    assert _rel(Sx.numpy(), Sj) < 2e-6 and _rel(dSx.numpy(), dSj) < 2e-6


@pytest.mark.parametrize("hop", [4, 3])
def test_stft_hop_matches_jax(monkeypatch, hop):
    """hop > 1: unfold + torch.matmul against the JAX XLA route."""
    _jax_kernels(monkeypatch, False)
    x = _signal(N, seed=3)
    Sj, dSj = j_stft(x, n_fft=256, hop_len=hop, fs=FS, derivative=True,
                     dtype="float32")
    Sx, dSx = stft(x, device="cpu", n_fft=256, hop_len=hop, fs=FS,
                   derivative=True)
    assert Sx.shape == Sj.shape
    assert _rel(Sx.numpy(), Sj) < 2e-6 and _rel(dSx.numpy(), dSj) < 2e-6


def test_stft_rfft_route_matches_jax(monkeypatch):
    """n_fft > 2048 takes the rfft of the windowed frames, as in JAX."""
    _jax_kernels(monkeypatch, False)
    x = _signal(3000, seed=4)
    Sj = j_stft(x, n_fft=2100, hop_len=64, dtype="float32")
    Sx = stft(x, device="cpu", n_fft=2100, hop_len=64)
    assert Sx.shape == Sj.shape
    assert _rel(Sx.numpy(), Sj) < 2e-6


@pytest.mark.parametrize("win_exp", [0, 1, 2])
def test_istft_matches_jax_kernel(monkeypatch, win_exp):
    """Plain H (hop 1, one column per sample) against the JAX kernel H in
    interpret mode."""
    x = _signal(2000, seed=5)
    _jax_kernels(monkeypatch, False)
    Sj = j_stft(x, n_fft=121, dtype="float32")
    _jax_kernels(monkeypatch, True)
    xj = np.asarray(j_istft(Sj, n_fft=121, N=2000, win_exp=win_exp))
    before = dict(stft_cuda.LAUNCHES)
    xr = istft(np.asarray(Sj), device="cpu", n_fft=121, N=2000,
               win_exp=win_exp)
    assert stft_cuda.LAUNCHES == before
    assert xr.dtype == torch.float32 and xr.shape == xj.shape
    assert _rel(xr.numpy(), xj) < 2e-6


@pytest.mark.parametrize("hop,n_fft", [(4, 256), (1, 598)])
def test_istft_unfused_matches_jax(monkeypatch, hop, n_fft):
    """The product + overlap-add route (hop > 1, or fewer samples than
    columns) against the JAX XLA route."""
    _jax_kernels(monkeypatch, False)
    x = _signal(N, seed=6)
    Sj = j_stft(x, n_fft=n_fft, hop_len=hop, dtype="float32")
    n_out = hop * Sj.shape[-1] - (1 if hop == 1 else 0)
    xj = np.asarray(j_istft(Sj, n_fft=n_fft, hop_len=hop, N=n_out))
    xr = istft(np.asarray(Sj), device="cpu", n_fft=n_fft, hop_len=hop, N=n_out)
    assert xr.shape == xj.shape
    assert _rel(xr.numpy(), xj) < 2e-6


@pytest.mark.parametrize("hop", [1, 4])
def test_round_trip(hop):
    x = _signal((2, N), seed=7)
    Sx = stft(torch.as_tensor(x), n_fft=256, hop_len=hop)
    xr = istft(Sx, n_fft=256, hop_len=hop, N=N)
    assert xr.shape == (2, N)
    assert mad_rms(x, xr) < 1e-5


def test_plain_kernels_by_definition():
    """F and H's plain versions against their definitions in float64:
    out[r, j] = sum_t K_T[r, t] xp[j + t] and
    out[c] = sum_t (Fr @ Sr - Fs @ Si)[t, c - t]."""
    rng = np.random.default_rng(8)
    n_fft, n_out = 9, 30
    xp = rng.standard_normal(n_out + n_fft - 1)
    K = rng.standard_normal((6, n_fft))
    ref = np.stack([[K[r] @ xp[j:j + n_fft] for j in range(n_out)]
                    for r in range(6)])
    ref[3:] *= 2.5
    out = stft_cuda.stft_dft(torch.as_tensor(xp), torch.as_tensor(K), n_fft,
                             n_out, fs=2.5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    Sr, Si = rng.standard_normal((2, 5, n_out))
    Fr, Fs = rng.standard_normal((2, n_fft, 5))
    v = Fr @ Sr - Fs @ Si
    ref = np.zeros(n_out + n_fft - 1)
    for t in range(n_fft):
        ref[t:t + n_out] += v[t]
    out = stft_cuda.istft_ola(*(torch.as_tensor(a) for a in (Sr, Si, Fr, Fs)),
                              n_fft)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_shape_contracts_and_gates():
    """The kernels' shape contracts raise as the JAX wrappers do, and the
    gates decide from shapes alone."""
    xp = torch.zeros(100)
    with pytest.raises(ValueError, match="n_out \\+ n_fft - 1"):
        stft_cuda.stft_dft(xp, torch.zeros((6, 9)), 9, 93)
    with pytest.raises(ValueError, match="n_out \\+ n_fft - 1"):
        stft_cuda.ssq_stft_fused(xp, torch.zeros((20, 9)), 9, 93, 1.0,
                                 torch.zeros(5), torch.zeros(5), 1e-6,
                                 dict(vmin=0.0, dv=0.1), "lin", False)
    with pytest.raises(ValueError, match="do not match"):
        stft_cuda.istft_ola(torch.zeros((5, 30)), torch.zeros((5, 30)),
                            torch.zeros((9, 4)), torch.zeros((9, 4)), 9)
    assert stft_cuda._ssq_cols(300, 598) == 32
    assert stft_cuda._ssq_cols(1025, 2048) == 16
    assert stft_cuda.ssq_stft_fused_ok(2048)
    assert stft_cuda.istft_ola_ok(2048) and not stft_cuda.istft_ola_ok(4096)


def test_float64_raises():
    x = _signal(1000)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        stft(x, device="cpu", n_fft=64, dtype="float64")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        istft(np.zeros((33, 100), np.complex128), device="cpu", n_fft=64)
