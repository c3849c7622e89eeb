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
  G's steps (F's chirp-z model, the phase, the bins, the ordered walk):
          Tx against plain G on >= 99.9 % of entries within 1e-5 max|Tx|,
          column sums within 1e-5 (chip_smoke's bars for kernel G); against
          the JAX kernel G the column marginals within 1e-3 (an ulp of the
          phase can move an entry to the neighbouring bin)
"""
import sys

import numpy as np
import pytest
import torch
import jax

from ssqueeze_rs_tpu import (stft as j_stft, istft as j_istft,
                             ssq_stft as j_ssq_stft)
from ssqueeze_rs_tpu.utils import windows as j_windows
from ssqueeze_rs_tpu_torch import stft, istft, get_window, mad_rms
from ssqueeze_rs_tpu_torch.config import EPS32
from ssqueeze_rs_tpu_torch.ops import reassign_cuda, stft_cuda
from ssqueeze_rs_tpu_torch.ops.ssqueeze import plan_reassignment
from ssqueeze_rs_tpu_torch.trace import COUNTS
from ssqueeze_rs_tpu_torch.utils import pad as t_pad, windows as t_windows

# the modules (the packages export functions of the same names)
j_stft_mod = sys.modules["ssqueeze_rs_tpu.ops.stft"]
t_stft_mod = sys.modules["ssqueeze_rs_tpu_torch.ops.stft"]

N, FS = 4000, 10.0
G_FS = 1000.0       # kernel G's cases: a sampling rate in Hz, as ssq_stft's


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _signal(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _stft_launches():
    """Launches counted of kernels F, G and H."""
    return {k: COUNTS["launch." + k]
            for k in ("ssq_stft_dft", "ssq_stft_fused", "ssq_istft_ola")}


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
    before = _stft_launches()
    Sx, dSx = stft(x, device="cpu", n_fft=n_fft, fs=FS, derivative=True)
    assert _stft_launches() == before
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
    before = _stft_launches()
    xr = istft(np.asarray(Sj), device="cpu", n_fft=121, N=2000,
               win_exp=win_exp)
    assert _stft_launches() == before
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
    assert stft_cuda._ssq_plan(598) == (32, 36)
    assert stft_cuda._ssq_plan(2048) == (4, 4)
    assert stft_cuda.ssq_stft_fused_ok(2048)
    assert stft_cuda.istft_ola_ok(2048) and not stft_cuda.istft_ola_ok(4096)


def test_float64_raises():
    """float64 (once refused) takes the rfft route in float64, and a
    complex128 Sx the irfft route: both within 1e-10 of the JAX package's
    float64 transforms."""
    x = _signal(1000).astype(np.float64)
    Sx = stft(x, device="cpu", n_fft=64, dtype="float64")
    Sj = np.array(j_stft(x, n_fft=64, dtype="float64"))
    assert Sx.dtype == torch.complex128
    assert np.abs(Sx.numpy() - Sj).max() < 1e-10 * np.abs(Sj).max()
    xr = istft(Sj, device="cpu", n_fft=64)
    xj = np.asarray(j_istft(Sj, n_fft=64))
    assert xr.dtype == torch.float64
    assert np.abs(xr.numpy() - xj).max() < 1e-10 * np.abs(xj).max()


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


# -- kernel G on F's frame routine: its steps, its structure, its plan ------
def _g_inputs(n_fft, n_out, seed):
    """A padded signal and G's four-plane K_T, structure and linear plan,
    as `ssq_stft`'s fused route builds them (fs = 1000)."""
    x = torch.as_tensor(_signal(n_out, seed=seed))
    xp = t_pad.padsignal(x, "reflect", padlength=n_out + n_fft - 1)
    win, dwin = get_window(None, n_fft, n_fft, derivative=True,
                           dtype="float32")
    wins = (t_stft_mod._win_bytes(win), t_stft_mod._win_bytes(dwin), n_fft,
            True)
    nf = n_fft // 2 + 1
    Sfs = np.linspace(0, 0.5 * G_FS, nf, dtype=np.float32)
    const, mode, params = plan_reassignment(Sfs, nf, False, transform="stft")
    return (x, xp, torch.as_tensor(t_stft_mod._k_t_host(*wins)),
            t_stft_mod._dft_spec(*wins), torch.as_tensor(Sfs),
            torch.as_tensor(const, dtype=torch.float32), mode, params)


def _ssq_stft_model(xp, spec, n_out, fs, Sfs, const, gamma, mode, params):
    """Kernel G's steps in plain torch, from F's host tables: F's
    chirp-z model (`_bluestein_model`) for the window and the derivative
    window (times fs); w and the bin of every entry as kernel B' forms
    them (`phase_w`, `bin_indices`); the value Sx * const[i], each product
    rounded once; then each frame's walk over its entries in increasing i,
    one add into its bin apiece (the kernel's ordered squeeze). Returns
    (Tx, Sx) complex64, each (nf, n_out)."""
    nf = spec.nf
    sr, si, dr, di = _bluestein_model(xp, spec, n_out, fs).split(nf, dim=-2)
    w = reassign_cuda.phase_w(sr, si, dr, di, Sfs, gamma, "stft")
    k = reassign_cuda.bin_indices(w, mode, params, False, nf)
    vr, vi = sr * const[:, None], si * const[:, None]
    txr, txi = torch.zeros_like(sr), torch.zeros_like(si)
    frames = torch.arange(n_out)
    for i in range(nf):
        m = k[i] >= 0
        at = (k[i][m], frames[m])
        txr.index_put_(at, vr[i][m], accumulate=True)
        txi.index_put_(at, vi[i][m], accumulate=True)
    return torch.complex(txr, txi), torch.complex(sr, si)


def _tx_within(Tk, Tp):
    """(share of entries within 1e-5 max|Tp|, max column-sum difference /
    max|column sum|): chip_smoke's bars between G and its references."""
    d = (Tk - Tp).abs()
    within = float((d <= 1e-5 * Tp.abs().max()).float().mean())
    cs_k, cs_p = Tk.sum(-2), Tp.sum(-2)
    return within, float((cs_k - cs_p).abs().max() / cs_p.abs().max())


@pytest.mark.parametrize("n_fft", [9, 16, 127, 256, 598])
def test_ssq_stft_model_matches_plain_g(n_fft):
    """G's steps on F's tables (`_ssq_stft_model`): Sx is F's chirp-z
    model bit for bit (G runs F's frame routine), and Tx agrees with plain
    G (`ssq_stft_fused_plain`: the dense F product, then B') on >= 99.9 %
    of entries within 1e-5 of max|Tx| with column sums within 1e-5, the
    bars chip_smoke holds kernel G to (the two Sx differ by float32
    rounding, which can move an entry to the neighbouring bin)."""
    n_out = 400
    x, xp, K4, spec, Sfs, const, mode, params = _g_inputs(n_fft, n_out,
                                                          n_fft)
    gamma = 10 * EPS32
    Tm, Sm = _ssq_stft_model(xp, spec, n_out, G_FS, Sfs, const, gamma, mode,
                             params)
    F = _bluestein_model(xp, spec, n_out, G_FS)
    assert torch.equal(Sm, torch.complex(F[:spec.nf], F[spec.nf:2 * spec.nf]))
    Tp, Sp = stft_cuda.ssq_stft_fused_plain(xp, K4, n_fft, n_out, G_FS, Sfs,
                                            const, gamma, params, mode, False)
    assert _rel(Sm, Sp) < 2e-6
    within, col = _tx_within(Tm, Tp)
    assert within >= 0.999 and col < 1e-5
    assert float((Tm != 0).float().mean()) > 0.3


def test_ssq_stft_model_matches_jax_kernel(monkeypatch):
    """G's steps on F's tables against the JAX kernel G (interpret mode)
    through the JAX package's ssq_stft at N = 2000, n_fft = 256: Sx within
    2e-6 and Tx column marginals within 1e-3 (the bars of
    tests/test_torch_ssq_stft.py between plain G and the same kernel)."""
    n_fft, n_out = 256, 2000
    x, xp, _, spec, Sfs, const, mode, params = _g_inputs(n_fft, n_out, 3)
    monkeypatch.setenv("SSQ_TPU_KERNELS", "1")
    jax.clear_caches()
    Tj, Sj, *_ = (np.asarray(a) for a in j_ssq_stft(
        x.numpy(), n_fft=n_fft, fs=G_FS, dtype="float32"))
    monkeypatch.delenv("SSQ_TPU_KERNELS")
    jax.clear_caches()
    Tm, Sm = _ssq_stft_model(xp, spec, n_out, G_FS, Sfs, const, 10 * EPS32,
                             mode, params)
    assert _rel(Sm.numpy(), Sj) < 2e-6
    c, c_j = np.abs(Tm.numpy()).sum(-2), np.abs(Tj).sum(-2)
    assert np.abs(c - c_j).max() / c_j.max() < 1e-3


def test_ssq_stft_fused_cuda_route_needs_the_structure(monkeypatch):
    """Kernel G computes from the structure: its route raises without one
    and on a one-window structure, before any launch."""
    from ssqueeze_rs_tpu_torch import _build

    class NoLaunch:
        def ssq_stft_fused(self, *args):
            raise AssertionError("launched")

    monkeypatch.setattr(_build, "_LIB", NoLaunch())
    x, xp, K4, spec, Sfs, const, mode, params = _g_inputs(16, 100, 0)
    run = lambda s: stft_cuda._ssq_stft_cuda(
        torch.device("cpu"), xp, K4, 16, 100, G_FS, Sfs, const, 1e-6, params,
        mode, False, s)
    with pytest.raises(ValueError, match="DftSpec"):
        run(None)
    with pytest.raises(ValueError, match="does not match"):
        run(_caller_k_t("stft", 16, True)[1])


def test_ssq_stft_plan_fits_every_admitted_n_fft():
    """G's plan (frames a block T, the staged entries' frame stride SS)
    fits 227 KB at every n_fft the gate admits, takes the largest T that
    fits, and the gate refuses every n_fft whose chirp-z transform is past
    the core's 4096 points (n_fft > 2731). The planner's mirror of the
    core's Shape agrees with the bank-conflict mirror of
    tests/test_torch_cwt.py; where SS is padded, a warp's round stores
    (bin = lane + const, frame = column) hit 32 distinct banks."""
    from test_torch_cwt import ncol, col_stride, passes
    for log in range(2, 13):
        Q = 1 << log
        nc, floats = stft_cuda._core_shape(Q)
        tw = Q + sum(R * ns for R, ns in passes(Q)[1:-1])
        assert nc == ncol(Q) and floats == tw + 2 * nc * col_stride(Q)
    admitted = []
    for n_fft in range(2, 4200):
        plan = stft_cuda._ssq_plan(n_fft)
        assert (plan is not None) == stft_cuda.ssq_stft_fused_ok(n_fft)
        if plan is None:
            assert stft_cuda._bluestein_q(n_fft) > 4096
            continue
        admitted.append(n_fft)
        T, SS = plan
        nc = stft_cuda._core_shape(stft_cuda._bluestein_q(n_fft))[0]
        assert 1 <= T <= 256 and SS >= T
        assert stft_cuda._ssq_smem(n_fft, T, SS) <= stft_cuda.MAX_SMEM
        if T < 256:
            assert stft_cuda._ssq_smem(n_fft, 2 * T, 2 * T) > \
                stft_cuda.MAX_SMEM
        if SS != T:
            lanes = 32 // nc
            banks = {(lane * SS + c) % 32 for lane in range(lanes)
                     for c in range(nc)}
            assert len(banks) == 32
    assert admitted == list(range(2, 2732))


# -- kernel H as F's adjoint: its route on F's tables ------------------------
# The matrices H's callers hand it, beside the structure of [Fr^T; -Fs^T]:
# istft (`_irfft_spec`), F's VJP with one window and with two (the stft and
# its derivative window; Si is then the second window's planes times fs)
# and ssq_stft's backward (the first window of its four-plane K_T).
H_CALLERS = ["stft", "stft_dwin", "ssq_stft"]


def _h_caller(kind, n_fft, modulated, win_exp=1):
    """(Fr, Fs, the DftSpec of [Fr^T; -Fs^T]) as the caller builds them."""
    win, dwin = get_window(None, n_fft, n_fft, derivative=True,
                           dtype="float32")
    if kind == "istft":
        mats = (n_fft, modulated, t_stft_mod._win_bytes(win), win_exp)
        Fr, Fs = t_stft_mod._irfft_mats_weighted(*mats, "cpu")
        return Fr, Fs, t_stft_mod._irfft_spec(*mats)
    wins = (t_stft_mod._win_bytes(win),
            t_stft_mod._win_bytes(dwin) if kind != "stft" else None, n_fft,
            modulated)
    K = torch.as_tensor(t_stft_mod._k_t_host(*wins))
    spec = t_stft_mod._dft_spec(*wins)
    if kind == "ssq_stft":
        nf = spec.nf
        return (K[:nf].t(), -K[nf:2 * nf].t(),
                stft_cuda.DftSpec(n_fft, spec.windows[:1], modulated))
    h = K.shape[0] // 2
    return K[:h].t(), -K[h:].t(), spec


def _bluestein_adjoint_model(planes, spec, n_segs):
    """Kernel H's steps in plain torch on the CPU, from F's host tables
    conjugated: for each window w, G_w = rows [w 2nf, w 2nf + nf) + i rows
    [w 2nf + nf, (w + 1) 2nf) of the stacked planes (..., rows, n_segs), a
    = conj(D) G_w, an FFT of Q points, the product with conj(B), an
    unnormalised inverse FFT c, and y = sum_w Re(conj(A_w) c) on the first
    n_fft outputs; then the overlap-add in the kernel's order: a block of
    64 frames adds its frames into a span of 64 + n_fft - 1 samples in
    frame order, and the spans go into the output in block order.
    Returns (..., n_segs + n_fft - 1) float32."""
    Q, A, B, D = (torch.as_tensor(t) for t in
                  stft_cuda.bluestein_tables(spec))
    n, nf = spec.n_fft, spec.nf
    g = planes.to(torch.float32)
    y = 0
    for w in range(len(spec.windows)):
        r = 2 * w * nf
        G = torch.complex(g[..., r:r + nf, :], g[..., r + nf:r + 2 * nf, :])
        a = G.transpose(-1, -2) * D.conj()
        c = torch.fft.ifft(torch.fft.fft(a, n=int(Q)) * B.conj()) * Q
        y = y + (c[..., :n] * A[w].conj()).real
    F = stft_cuda._H_FRAMES
    nblk = -(-n_segs // F)
    lead = tuple(y.shape[:-2])
    frames = torch.zeros(lead + (nblk * F, n))
    frames[..., :n_segs, :] = y
    frames = frames.reshape(lead + (nblk, F, n))
    span = torch.zeros(lead + (nblk, F + n - 1))
    for jl in range(F):
        span[..., jl:jl + n] += frames[..., jl, :]
    out = torch.zeros(lead + (nblk * F + n - 1,))
    for i in range(nblk):
        out[..., i * F:i * F + F + n - 1] += span[..., i, :]
    return out[..., :n_segs + n - 1]


def _planes(Fr, n_segs, seed, batch=()):
    """Random stacked planes [Sr; Si] (..., 2 h, n_segs) for Fr (n_fft, h)."""
    return torch.as_tensor(_signal(batch + (2 * Fr.shape[1], n_segs),
                                   seed=seed))


@pytest.mark.parametrize("win_exp", [1, 2])
@pytest.mark.parametrize("modulated", [True, False], ids=["mod", "nomod"])
@pytest.mark.parametrize("n_fft", [598, 599, 256])
def test_bluestein_adjoint_model_matches_plain_h_istft(n_fft, modulated,
                                                       win_exp):
    """Kernel H's route (F's chirp-z steps backwards on the conjugated
    tables, the overlap-add in the kernel's order) with istft's structure
    equals `istft_ola_plain` within H's bar (2e-6 of the largest output
    sample), with two signals and a partial last block of frames."""
    Fr, Fs, spec = _h_caller("istft", n_fft, modulated, win_exp)
    n_segs = 150
    g = _planes(Fr, n_segs, seed=n_fft + win_exp, batch=(2,))
    h = Fr.shape[1]
    ref = stft_cuda.istft_ola_plain(g[..., :h, :], g[..., h:, :], Fr, Fs,
                                    n_fft)
    out = _bluestein_adjoint_model(g, spec, n_segs)
    assert spec.rows == 2 * h and out.shape == ref.shape == (2, 747 if
                                                             n_fft == 598
                                                             else n_segs +
                                                             n_fft - 1)
    assert _rel(out, ref) < 2e-6


@pytest.mark.parametrize("kind", H_CALLERS)
@pytest.mark.parametrize("modulated", [True, False], ids=["mod", "nomod"])
@pytest.mark.parametrize("n_fft", [598, 599, 16])
def test_bluestein_adjoint_model_matches_plain_h_callers(n_fft, modulated,
                                                         kind):
    """The same for F's VJP (one and two windows: W = 2 puts window 0's
    [Re; Im] rows in Sr and window 1's in Si) and ssq_stft's backward
    (the first window of the four-plane structure)."""
    Fr, Fs, spec = _h_caller(kind, n_fft, modulated)
    n_segs = 130
    g = _planes(Fr, n_segs, seed=n_fft)
    h = Fr.shape[1]
    ref = stft_cuda.istft_ola_plain(g[:h], g[h:], Fr, Fs, n_fft)
    assert spec.rows == 2 * h
    assert _rel(_bluestein_adjoint_model(g, spec, n_segs), ref) < 2e-6


@pytest.mark.parametrize("n_fft", [121, 256])
def test_bluestein_adjoint_model_matches_jax_kernel(n_fft):
    """H's route against the JAX package's kernel H (`istft_ola_fused`,
    interpret mode) on the same planes and matrices, within 2e-6."""
    from ssqueeze_rs_tpu.ops.stft_pallas import istft_ola_fused
    Fr, Fs, spec = _h_caller("istft", n_fft, True)
    n_segs = 700
    g = _planes(Fr, n_segs, seed=3)
    h = Fr.shape[1]
    ref = np.asarray(istft_ola_fused(
        jax.lax.complex(g[:h].numpy(), g[h:].numpy()), Fr.numpy(),
        Fs.numpy(), n_fft, interpret=True))
    assert _rel(_bluestein_adjoint_model(g, spec, n_segs), ref) < 2e-6


@pytest.mark.parametrize("n_fft", [598, 599])
def test_bluestein_adjoint_route_istft_matches_jax(monkeypatch, n_fft):
    """istft (hop 1) with H's route in place of the plain product against
    the JAX package's istft on its XLA route, within istft's bar."""
    _jax_kernels(monkeypatch, False)
    x = _signal(3000, seed=9)
    Sj = j_stft(x, n_fft=n_fft, dtype="float32")
    xj = np.asarray(j_istft(Sj, n_fft=n_fft, N=3000))

    def route(Sr, Si, Fr, Fs, n, adjoint=None):
        return _bluestein_adjoint_model(torch.cat([Sr, Si], dim=-2), adjoint,
                                        Sr.shape[-1])

    monkeypatch.setattr(t_stft_mod, "istft_ola", route)
    xr = istft(np.asarray(Sj), device="cpu", n_fft=n_fft, N=3000)
    assert _rel(xr.numpy(), xj) < 2e-6


@pytest.mark.parametrize("kind", ["stft", "stft_dwin"])
def test_bluestein_models_are_adjoint(kind):
    """<F x, g> = <x, H g> between the models of F's and H's routes on one
    structure (F's forward and its adjoint), to 1e-5 relative."""
    Fr, Fs, spec = _h_caller(kind, 598, True)
    n_segs = 200
    g = _planes(Fr, n_segs, seed=11)
    x = torch.as_tensor(_signal(n_segs + 597, seed=12))
    Fx = _bluestein_model(x, spec, n_segs)
    Hg = _bluestein_adjoint_model(g, spec, n_segs)
    lhs = float((Fx.double() * g.double()).sum())
    rhs = float((x.double() * Hg.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), abs(rhs))


def test_istft_ola_cuda_route_needs_the_structure():
    """Kernel H computes from the structure of [Fr^T; -Fs^T]: its route
    raises without one (before any launch), on one whose rows or n_fft do
    not match the planes, and past the core's largest transform; the
    callers pass it (test_h_callers_hand_their_structure)."""
    Fr, Fs, spec = _h_caller("istft", 16, True)
    g = _planes(Fr, 100, seed=1)
    Sr, Si = g[:9], g[9:]
    check = stft_cuda._check_adjoint
    run = stft_cuda._istft_ola_cuda
    with pytest.raises(ValueError, match="DftSpec"):
        run(torch.device("cpu"), Sr, Si, 16, None)
    with pytest.raises(ValueError, match="does not match"):
        run(torch.device("cpu"), Sr[:5], Si[:5], 16, spec)
    with pytest.raises(ValueError, match="does not match"):
        check(spec, Sr, 17)
    two = _h_caller("stft_dwin", 16, True)[2]
    with pytest.raises(ValueError, match="does not match"):
        check(two, Sr, 16)
    check(two, g, 16)                   # 2 W nf rows: Sr holds 2 nf
    big = _h_caller("istft", 2732, True)[2]
    with pytest.raises(ValueError, match="does not fit"):
        check(big, torch.zeros((1367, 5)), 2732)
    assert stft_cuda.istft_ola_ok(2731) and not stft_cuda.istft_ola_ok(2732)


@pytest.mark.parametrize("kind", ["istft", "stft", "stft_dwin", "ssq_stft"])
@pytest.mark.parametrize("n_fft", [598, 599])
def test_h_callers_hand_their_structure(monkeypatch, n_fft, kind):
    """Each caller of kernel H hands it the structure whose dense()
    rebuilds the [Fr^T; -Fs^T] it passes (within float32 rounding of the
    largest entry, as test_dft_spec_rebuilds_callers_k_t): istft, F's
    backward with one and two windows, ssq_stft's backward."""
    from ssqueeze_rs_tpu_torch.ops.ssqueeze import plan_reassignment
    seen = []
    real = stft_cuda.istft_ola

    def record(Sr, Si, Fr, Fs, n, adjoint=None):
        seen.append((Fr, Fs, n, adjoint))
        return real(Sr, Si, Fr, Fs, n, adjoint=adjoint)

    monkeypatch.setattr(stft_cuda, "istft_ola", record)
    monkeypatch.setattr(t_stft_mod, "istft_ola", record)
    n_out = 40
    xp = torch.as_tensor(_signal(n_out + n_fft - 1, seed=2),
                         dtype=torch.float32).requires_grad_()
    win, dwin = get_window(None, n_fft, n_fft, derivative=True,
                           dtype="float32")
    if kind == "istft":
        S = stft(_signal(300, seed=2), device="cpu", n_fft=n_fft)
        istft(S, device="cpu", n_fft=n_fft, N=300, win_exp=2)
    elif kind.startswith("stft"):
        wins = (t_stft_mod._win_bytes(win),
                t_stft_mod._win_bytes(dwin) if kind == "stft_dwin" else None,
                n_fft, True)
        K = torch.as_tensor(t_stft_mod._k_t_host(*wins))
        stft_cuda.stft_dft(xp, K, n_fft, n_out,
                           fs=2.0 if kind == "stft_dwin" else None,
                           spec=t_stft_mod._dft_spec(*wins)).sum().backward()
    else:
        wins = (t_stft_mod._win_bytes(win), t_stft_mod._win_bytes(dwin),
                n_fft, True)
        K = torch.as_tensor(t_stft_mod._k_t_host(*wins))
        nf = n_fft // 2 + 1
        Sfs = np.linspace(0, 0.5, nf, dtype=np.float32)
        const, mode, params = plan_reassignment(Sfs, nf, False,
                                                transform="stft")
        Tx, Sx = stft_cuda.ssq_stft_fused(
            xp, K, n_fft, n_out, 1.0, Sfs, const, 1e-6, params, mode, False,
            spec=t_stft_mod._dft_spec(*wins))
        (Tx.abs().sum() + Sx.abs().sum()).backward()
    assert len(seen) == 1
    Fr, Fs, n, adjoint = seen[0]
    Kp = torch.cat([Fr.t(), -Fs.t()]).numpy()
    assert n == n_fft and adjoint is not None and adjoint.n_fft == n_fft
    assert len(adjoint.windows) == (2 if kind == "stft_dwin" else 1)
    assert np.abs(adjoint.dense() - Kp).max() <= 2.5e-7 * np.abs(Kp).max()
