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


# -- kernel F's structure (DftSpec) and its Bluestein tables ----------------
# K_T as each of F's three callers builds it, beside the structure it
# carries to the kernel: the STFT (window; window and derivative window) and
# H's adjoint [Fr^T; -Fs^T] at win_exp 0, 1, 2.
F_CALLERS = ["stft", "stft_dwin", "irfft0", "irfft1", "irfft2"]


def _caller_k_t(kind, n_fft, modulated):
    """(K_T float32 as the caller builds it, its DftSpec)."""
    win, dwin = get_window(None, n_fft, n_fft, derivative=True,
                           dtype="float32")
    if kind.startswith("stft"):
        wins = (t_stft_mod._win_bytes(win),
                t_stft_mod._win_bytes(dwin) if kind == "stft_dwin" else None,
                n_fft, modulated)
        return (t_stft_mod._k_t_host(*wins), t_stft_mod._dft_spec(*wins))
    mats = (n_fft, modulated, t_stft_mod._win_bytes(win), int(kind[-1]))
    Fr, Fs = t_stft_mod._irfft_mats_weighted(*mats, "cpu")
    return (torch.cat([Fr.t(), -Fs.t()]).numpy(),
            t_stft_mod._irfft_spec(*mats))


@pytest.mark.parametrize("kind", F_CALLERS)
@pytest.mark.parametrize("modulated", [True, False], ids=["mod", "nomod"])
@pytest.mark.parametrize("n_fft", [9, 16, 127, 598])
def test_dft_spec_rebuilds_callers_k_t(n_fft, modulated, kind):
    """The structure each caller hands kernel F stands for the dense K_T
    the plain version takes: rebuilt from float64, within float32
    rounding of K_T's largest entry (H's matrices round twice: cos * w / n,
    then the window power)."""
    K, spec = _caller_k_t(kind, n_fft, modulated)
    assert spec.rows == K.shape[0] and spec.n_fft == K.shape[1] == n_fft
    assert np.abs(spec.dense() - K).max() <= 2.5e-7 * np.abs(K).max()


def _bluestein_model(xp, spec, n_out, fs=None):
    """Kernel F's steps in plain torch on the CPU, from the same host
    tables: each frame times the chirped window A_w, an FFT of Q points,
    the product with B, an unnormalised inverse FFT, D on the first nf
    outputs; the second window's planes times fs."""
    Q, A, B, D = stft_cuda.bluestein_tables(spec)
    frames = xp.unfold(-1, spec.n_fft, 1).to(torch.complex64)
    planes = []
    for w in range(len(spec.windows)):
        a = frames * torch.as_tensor(A[w])
        c = torch.fft.ifft(torch.fft.fft(a, n=Q) * torch.as_tensor(B)) * Q
        X = (c[..., :spec.nf] * torch.as_tensor(D)).transpose(-1, -2)
        if fs is not None and w == 1:
            X = X * fs
        planes += [X.real, X.imag]
    return torch.cat(planes, dim=-2)


@pytest.mark.parametrize("kind", F_CALLERS)
@pytest.mark.parametrize("modulated", [True, False], ids=["mod", "nomod"])
@pytest.mark.parametrize("n_fft", [9, 16, 127, 598])
def test_bluestein_model_matches_plain_f(n_fft, modulated, kind):
    """The chirp-z steps kernel F runs, on the tables it reads, equal
    `stft_dft_plain` within F's bar (2e-6 of the largest plane value):
    the tables are right before any chip time is spent. Q is the power of
    two >= n_fft + nf - 1."""
    K, spec = _caller_k_t(kind, n_fft, modulated)
    n_out = 150
    xp = torch.as_tensor(_signal((2, n_out + n_fft - 1), seed=n_fft))
    fs = 3.0 if kind == "stft_dwin" else None
    ref = stft_cuda.stft_dft_plain(xp, torch.as_tensor(K), n_fft, n_out, fs)
    out = _bluestein_model(xp, spec, n_out, fs)
    Q = stft_cuda.bluestein_tables(spec)[0]
    assert Q >= n_fft + spec.nf - 1 and Q // 2 < max(4, n_fft + spec.nf - 1)
    assert _rel(out, ref) < 2e-6


def test_stft_dft_cuda_route_needs_the_structure():
    """Kernel F computes from the structure: its route raises without one
    (before any launch), on a structure that does not match K_T, and on fs
    with one window; the entry points pass it."""
    K, spec = _caller_k_t("stft", 16, True)
    xp, K = torch.zeros(115), torch.as_tensor(K)
    run = stft_cuda._stft_dft_cuda
    with pytest.raises(ValueError, match="DftSpec"):
        run(torch.device("cpu"), xp, K, 16, 100, None, None)
    with pytest.raises(ValueError, match="does not match"):
        run(torch.device("cpu"), xp, K[:4], 16, 100, None, spec)
    with pytest.raises(ValueError, match="one-window"):
        run(torch.device("cpu"), xp, K, 16, 100, 2.0, spec)
