"""Gradients of the torch port against `jax.grad` of the JAX package, on the
CPU: each autograd.Function of the port (C / C' in `ReassignFn` /
`Reassign4Fn`, A's `CwtPhaseFn`, F's `StftDftFn`, H's `IstftOlaFn`, G's
`SsqStftFusedFn`) against the JAX custom VJP it ports, with the Pallas
kernels in interpret mode, and the entry points end to end against the
JAX package's own routes. Inputs come from numpy seeds; the kernels run
their plain versions here (the card holds each kernel to them in
chip_smoke.py).

Tolerances, and why:
  C, C'   bins: masks equal, >= 99.99 % of unmasked entries agree (an ulp
          of log2 or of the phase may cross a rounding tie, the bar
          tests/test_torch_reassign.py holds B to); gWx EQUAL to JAX's
          wherever the bins agree (one float32 product per entry on both
          sides); gw, gdWx exactly 0; the hand backward bitwise equal to
          torch.autograd through the plain forward
  A, D, E max|d| / max|g| < 1e-5 against JAX (its own bar between the
          kernel's VJP and XLA autodiff); A < 1e-6 against autograd of
          `cwt_phase_plain` (the same float32 FFTs, other sum orders);
          D's grid cotangent (sums over every row) < 1e-4; 1/dt's (one
          sum over every row and bin, which cancels) < 1e-5 of the sum of
          its terms' magnitudes
  cwt     end to end (loss sum|Wx|^2 + sum|dWx|^2) < 1e-4 against
          jax.grad of the JAX cwt (a linear pipeline)
  F, H    < 1e-5 against JAX (sums of <= 598 float32 products in other
          orders; JAX's backward runs in HIGHEST precision); F's backward
          through H's chirp-z route (a float32 model of the kernel's
          steps) the same
  G       < 5e-3 (a bin that flips between the two packages moves an
          isolated gradient contribution: the JAX package's own bar)
  end to end: ssq_cwt and ssq_stft < 5e-3 (bin flips, as G); the Wx-only
          loss, stft and istft < 1e-4 (linear pipelines: the JAX tests'
          bars)
  pad     the adjoint equals autograd of the gather exactly, and to 1e-12
          relative (float64) for 'replicate', whose edge sums run in
          another order
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ssqueeze_rs_tpu import (ssq_cwt as j_ssq_cwt, ssq_stft as j_ssq_stft,
                             stft as j_stft, istft as j_istft, cwt as j_cwt)
from ssqueeze_rs_tpu.ops.fft_pallas import (cwt_halfband_fused,
                                            ifft_halfband_planar_fused)
from ssqueeze_rs_tpu.ops.reassign_pallas import _bin_indices, reassign_pallas
from ssqueeze_rs_tpu.ops.ssqueeze import bin_params
from ssqueeze_rs_tpu.ops.stft_pallas import (stft_dft_fused, istft_ola_fused,
                                             ssq_stft_fused as j_ssq_fused)
from ssqueeze_rs_tpu_torch import cwt, ssq_cwt, ssq_stft, stft, istft
from ssqueeze_rs_tpu_torch.config import EPS32
from ssqueeze_rs_tpu_torch.ops import fft_cuda, reassign_cuda, stft_cuda
from ssqueeze_rs_tpu_torch.ops.ssqueeze import plan_reassignment
from ssqueeze_rs_tpu_torch.ops.stft import (_k_t_host, _win_bytes,
                                            _irfft_mats_weighted)
from ssqueeze_rs_tpu_torch.utils import pad as t_pad
from ssqueeze_rs_tpu_torch.utils.windows import get_window

NA, N_COLS = 24, 300          # tests/test_grad.py's reassignment setup
GAMMA = 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _leaf(a):
    return torch.tensor(np.asarray(a), requires_grad=True)


def _grads(loss, leaves):
    loss.backward()
    return [t.grad for t in leaves]


# -- C: the 3-plane VJP gather --------------------------------------------------
FREQS = {
    "log": np.geomspace(0.05, 50.0, NA),
    "log-piecewise": np.hstack([np.geomspace(0.05, 1.0, 16, endpoint=False),
                                np.geomspace(1.0, 50.0, 8)]),
    "lin": np.linspace(0.05, 50.0, NA),
}


def _planes3(seed):
    """Wx planes, a phase plane spread over the grids (log-uniform, ~5 %
    masked, a few zeros), const, and the Tx cotangents."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    wr, wi = (rng.standard_normal((NA, N_COLS)).astype(f32) for _ in range(2))
    w = np.exp(rng.uniform(np.log(0.02), np.log(100.0), (NA, N_COLS)))
    w[rng.random((NA, N_COLS)) < 0.05] = np.inf
    w[rng.random((NA, N_COLS)) < 0.01] = 0.0
    const = np.linspace(0.01, 0.05, NA).astype(f32)
    R1, R2 = (rng.standard_normal((NA, N_COLS)).astype(f32) for _ in range(2))
    return wr, wi, w.astype(f32), const, R1, R2


@pytest.mark.parametrize("flipud", [False, True])
@pytest.mark.parametrize("mode_expect", list(FREQS))
def test_reassign_bwd_matches_jax(mode_expect, flipud):
    wr, wi, w, const, R1, R2 = _planes3(2)
    mode, params = bin_params(FREQS[mode_expect], mode_expect != "lin")
    assert mode == mode_expect
    nf = NA

    def j_loss(wr, wi, w):
        Tx = reassign_pallas((wr, wi), None, jnp.asarray(const), GAMMA,
                             jnp.zeros(NA, jnp.float32), params, mode=mode,
                             flipud=flipud, transform="cwt", nf=nf,
                             interpret=True, w_plane=w)
        return jnp.sum(Tx.real * R1 + Tx.imag * R2)

    gj = jax.grad(j_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (wr, wi, w)))
    gj = [np.asarray(g) for g in gj]

    leaves = [_leaf(a) for a in (wr, wi, w)]
    txr, txi = reassign_cuda.reassign(*leaves, const, params, mode, flipud,
                                      nf)
    gt = _grads((txr * torch.as_tensor(R1) + txi * torch.as_tensor(R2)).sum(),
                leaves)

    k_j = np.asarray(_bin_indices(mode, dict(params), GAMMA, flipud, "cwt",
                                  nf, N_COLS, N_COLS, None, None, None, None,
                                  None, w_pre=jnp.asarray(w))[0])
    k_t = reassign_cuda.bin_indices(torch.as_tensor(w), mode, params, flipud,
                                    nf).numpy()
    assert np.array_equal(k_j < 0, k_t < 0)
    unmasked = k_j >= 0
    agree = k_j == k_t
    assert agree[unmasked].mean() >= 0.9999
    for a, b in zip(gt[:2], gj[:2]):
        assert np.array_equal(a.numpy()[agree], b[agree])
    assert not gt[2].any() and not gj[2].any()

    # the hand backward against torch.autograd through the plain forward
    ref = [_leaf(a) for a in (wr, wi)]
    pr, pi = reassign_cuda.reassign_plain(*ref, w, const, params, mode,
                                          flipud, nf)
    gp = _grads((pr * torch.as_tensor(R1) + pi * torch.as_tensor(R2)).sum(),
                ref)
    assert all(torch.equal(a, b) for a, b in zip(gt[:2], gp))


# -- C': the 4-plane VJP gather -------------------------------------------------
@pytest.mark.parametrize("transform", ["cwt", "stft"])
def test_reassign4_bwd_matches_jax(transform):
    rng = np.random.default_rng(3)
    f32 = np.float32
    planes = [rng.standard_normal((NA, N_COLS)).astype(f32) for _ in range(4)]
    planes[0][5:7] *= 1e-5           # rows under gamma: masked
    planes[1][5:7] *= 1e-5
    const = np.linspace(0.01, 0.05, NA).astype(f32)
    if transform == "cwt":
        freqs, flipud = np.geomspace(0.01, 1.0, NA), True
        Sfs = np.zeros(NA, f32)
    else:
        freqs, flipud = np.linspace(0.0, 1.0, NA), False
        Sfs = np.linspace(0.0, 1.0, NA).astype(f32)
    mode, params = bin_params(freqs, transform == "cwt")
    nf = NA
    R1, R2 = (rng.standard_normal((nf, N_COLS)).astype(f32) for _ in range(2))

    def j_loss(wr, wi, dr, di):
        Tx = reassign_pallas((wr, wi), (dr, di), jnp.asarray(const), GAMMA,
                             jnp.asarray(Sfs), params, mode=mode,
                             flipud=flipud, transform=transform, nf=nf,
                             interpret=True)
        return jnp.sum(Tx.real * R1 + Tx.imag * R2)

    gj = [np.asarray(g) for g in jax.grad(j_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(p) for p in planes))]
    leaves = [_leaf(p) for p in planes]
    txr, txi = reassign_cuda.reassign4(*leaves, const, Sfs, GAMMA, params,
                                       mode, flipud, nf, transform)
    gt = _grads((txr * torch.as_tensor(R1) + txi * torch.as_tensor(R2)).sum(),
                leaves)

    k_j = np.asarray(_bin_indices(mode, dict(params), GAMMA, flipud,
                                  transform, nf, N_COLS, N_COLS,
                                  *(jnp.asarray(p) for p in planes),
                                  jnp.asarray(Sfs)[:, None])[0])
    w = reassign_cuda.phase_w(*(torch.as_tensor(p) for p in planes),
                              torch.as_tensor(Sfs), GAMMA, transform)
    k_t = reassign_cuda.bin_indices(w, mode, params, flipud, nf).numpy()
    assert (k_j < 0).any() and (k_j >= 0).mean() > 0.9
    agree = k_j == k_t
    assert agree.mean() >= 0.9999
    for a, b in zip(gt[:2], gj[:2]):
        assert np.array_equal(a.numpy()[agree], b[agree])
    for g in gt[2:] + gj[2:]:
        assert not np.asarray(g).any()

    ref = [_leaf(p) for p in planes[:2]]
    pr, pi = reassign_cuda.reassign4_plain(*ref, *planes[2:], const, Sfs,
                                           GAMMA, params, mode, flipud, nf,
                                           transform)
    gp = _grads((pr * torch.as_tensor(R1) + pi * torch.as_tensor(R2)).sum(),
                ref)
    assert all(torch.equal(a, b) for a, b in zip(gt[:2], gp))


# -- A: CwtPhaseFn --------------------------------------------------------------
def test_cwt_phase_grad_matches_jax():
    """tests/test_grad.py's kernel-A setup: M = 2^14, na = 4, b = 2,
    keep = (100, 9000), loss sum o * R over Wxr and Wxi."""
    M = 1 << 14
    M1, M2 = fft_cuda.best_split(M)
    K1 = M1 // 2
    rng = np.random.default_rng(1)
    na, b = 4, 2
    f32 = np.float32
    Pw = rng.standard_normal((na, K1, M2)).astype(f32)
    xr = rng.standard_normal((b, K1, M2)).astype(f32)
    xi = rng.standard_normal((b, K1, M2)).astype(f32)
    xig = rng.uniform(0, 3, (K1, M2)).astype(f32)
    znyq = rng.standard_normal(b * na).astype(f32)
    zeros = np.zeros_like(znyq)
    keep = (100, 9000)
    R = [rng.standard_normal((b * na, keep[1])).astype(f32) for _ in range(2)]
    gamma = 10 * EPS32

    def j_loss(Pw, xr, xi, znyq):
        z = jnp.zeros_like(znyq)
        out = cwt_halfband_fused(Pw, xr, xi, jnp.asarray(xig), 2.0, (znyq, z),
                                 (z, znyq), keep=keep, derivative=True,
                                 phase_gamma=gamma, interpret=True)
        return sum(jnp.sum(o * r) for o, r in zip(out[:2], R))

    gj = jax.grad(j_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (Pw, xr, xi, znyq)))

    def port(fn):
        leaves = [_leaf(a) for a in (Pw, xr, xi, znyq)]
        zt = torch.zeros(b * na)
        out = fn(*leaves[:3], xig, 2.0, (leaves[3], zt), (zt, leaves[3]),
                 keep=keep, gamma=gamma)
        return _grads(sum((o * torch.as_tensor(r)).sum()
                          for o, r in zip(out[:2], R)), leaves)

    gt = port(fft_cuda.cwt_phase)
    gp = port(fft_cuda.cwt_phase_plain)
    for a, j, p in zip(gt, gj, gp):
        assert _rel(a.numpy(), j) < 1e-5
        assert _rel(a.numpy(), p.numpy()) < 1e-6


# -- D and E: CwtFusedFn, IfftHalfbandFn ------------------------------------------
def _fused_inputs(rng, na=3, b=2):
    M1, M2 = fft_cuda.best_split(1 << 14)
    K1 = M1 // 2
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(na, K1, M2), f(b, K1, M2), f(b, K1, M2),
            rng.uniform(0, 3, (K1, M2)).astype(np.float32),
            f(b * na), f(b * na), f(b * na), f(b * na))


@pytest.mark.parametrize("derivative", [False, True], ids=["wx", "dwx"])
def test_cwt_fused_grad_matches_jax(derivative):
    """M = 2^14, na = 3, b = 2, keep = (100, 9000), loss sum o * R over
    every output plane; cotangents of Pw, the signal planes, the grid,
    1/dt and the four Nyquist vectors."""
    rng = np.random.default_rng(9)
    inputs = _fused_inputs(rng)
    inv_dt = np.float32(1.7)
    keep = (100, 9000)
    n_out = 4 if derivative else 2
    R = [rng.standard_normal((6, keep[1])).astype(np.float32)
         for _ in range(n_out)]

    def j_loss(Pw, xr, xi, xig, inv_dt, nwr, nwi, ndr, ndi):
        out = cwt_halfband_fused(Pw, xr, xi, xig, inv_dt, (nwr, nwi),
                                 (ndr, ndi), keep=keep, derivative=derivative,
                                 interpret=True)
        return sum(jnp.sum(o * r) for o, r in zip(out, R))

    args = [jnp.asarray(a) for a in inputs]
    args.insert(4, jnp.asarray(inv_dt))
    gj = [np.asarray(g) for g in jax.grad(j_loss, argnums=tuple(range(9)))(
        *args)]
    leaves = [_leaf(a) for a in inputs]
    t_inv = torch.tensor(inv_dt, requires_grad=True)
    out = fft_cuda.cwt_fused(*leaves[:4], t_inv, leaves[4:6], leaves[6:],
                             keep=keep, derivative=derivative)
    assert len(out) == n_out
    gt = _grads(sum((o * torch.as_tensor(r)).sum() for o, r in zip(out, R)),
                leaves[:4] + [t_inv] + leaves[4:])
    names = ["Pw", "xr", "xi", "xig", "inv_dt", "nwr", "nwi", "ndr", "ndi"]
    for name, a, j in zip(names, gt, gj):
        a = a.numpy()
        assert a.shape == j.shape, name
        if not derivative and name in ("xig", "inv_dt", "ndr", "ndi"):
            assert not a.any() and not j.any(), name
            continue
        if name == "inv_dt":
            # one sum over every (row, bin) that cancels: held relative
            # to the sum of its terms' magnitudes, sum|g_xig * xig| * dt
            terms = np.abs(gj[3] * inputs[3]).sum() / inv_dt
            assert abs(a - j) / terms < 1e-5, name
            continue
        assert _rel(a, j) < (1e-4 if name == "xig" else 1e-5), name


def test_ifft_halfband_grad_matches_jax():
    rng = np.random.default_rng(10)
    M1, M2 = fft_cuda.best_split(1 << 14)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    Zr, Zi, nr, ni = f(4, M1 // 2, M2), f(4, M1 // 2, M2), f(4), f(4)
    keep = (3000, 9000)
    R = [f(4, keep[1]) for _ in range(2)]

    def j_loss(Zr, Zi, nr, ni):
        out = ifft_halfband_planar_fused(Zr, Zi, keep=keep, nyq_r=nr,
                                         nyq_i=ni, interpret=True)
        return sum(jnp.sum(o * r) for o, r in zip(out, R))

    gj = jax.grad(j_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (Zr, Zi, nr, ni)))
    leaves = [_leaf(a) for a in (Zr, Zi, nr, ni)]
    out = fft_cuda.ifft_halfband_planar(leaves[0], leaves[1], keep,
                                        leaves[2], leaves[3])
    gt = _grads(sum((o * torch.as_tensor(r)).sum() for o, r in zip(out, R)),
                leaves)
    for a, j in zip(gt, gj):
        assert _rel(a.numpy(), np.asarray(j)) < 1e-5


@pytest.mark.parametrize("case", ["gmw", "bump", "full"])
def test_cwt_grad_matches_jax(case):
    """Loss sum|Wx|^2 + sum|dWx|^2 of cwt(derivative=True) on the planar
    route (kernel D), the complex half-band route (kernel E, bump with
    om = 0.5) and the full-length route (N = 1500, padtype=None)."""
    n = 1500 if case == "full" else 2048
    x = np.cos(2 * np.pi * 40 * np.arange(n) / 1000.0).astype(np.float32)
    x += 0.2 * np.random.default_rng(11).standard_normal(n).astype(np.float32)
    wav = ("bump", {"om": 0.5}) if case == "bump" else "gmw"
    kw = dict(nv=8, fs=1000.0, derivative=True,
              padtype=None if case == "full" else "reflect")

    def loss(Wx, dWx, xp):
        return xp.sum(xp.abs(Wx) ** 2) + xp.sum(xp.abs(dWx) ** 2)

    gj = np.asarray(jax.grad(lambda x: loss(
        *j_cwt(x, wav, dtype="float32", **kw)[::2], jnp))(jnp.asarray(x)))
    x_t = _leaf(x)
    Wx, _, dWx = cwt(x_t, wav, **kw)
    (gt,) = _grads(loss(Wx, dWx, torch), [x_t])
    assert np.isfinite(gt.numpy()).all()
    assert _rel(gt.numpy(), gj) < 1e-4


# -- F and H: StftDftFn, IstftOlaFn -----------------------------------------------
@pytest.mark.parametrize("fs", [None, 500.0], ids=["plain", "derivative"])
def test_stft_dft_grad_matches_jax(fs):
    n_fft, n_out = 128, 1000
    win, dwin = get_window(None, n_fft, n_fft, derivative=True,
                           dtype="float32")
    K_T = _k_t_host(_win_bytes(win), _win_bytes(dwin) if fs else None, n_fft,
                    True)
    K_j = K_T.copy()
    if fs:
        K_j[K_T.shape[0] // 2:] *= np.float32(fs)
    rng = np.random.default_rng(4)
    xp = rng.standard_normal(n_out + n_fft - 1).astype(np.float32)
    R = rng.standard_normal((K_T.shape[0], n_out)).astype(np.float32)

    gj = jax.grad(lambda x: jnp.sum(stft_dft_fused(
        x, K_j, n_fft, n_out, interpret=True) * R))(jnp.asarray(xp))
    x = _leaf(xp)
    out = stft_cuda.stft_dft(x, torch.as_tensor(K_T), n_fft, n_out, fs=fs)
    (gt,) = _grads((out * torch.as_tensor(R)).sum(), [x])
    assert _rel(gt.numpy(), gj) < 1e-5


@pytest.mark.parametrize("fs", [None, 500.0], ids=["plain", "derivative"])
def test_stft_dft_grad_through_h_route_matches_jax(monkeypatch, fs):
    """F's backward with kernel H's CUDA route in place of the plain
    product: the chirp-z adjoint model (tests/test_torch_stft.py) on the
    structure F's backward hands H (one window, or two with the derivative
    window's planes times fs), against jax.grad of the JAX kernel F within
    F's and H's bar."""
    from test_torch_stft import _bluestein_adjoint_model
    from ssqueeze_rs_tpu_torch.ops.stft import _dft_spec
    n_fft, n_out = 128, 1000
    win, dwin = get_window(None, n_fft, n_fft, derivative=True,
                           dtype="float32")
    wins = (_win_bytes(win), _win_bytes(dwin) if fs else None, n_fft, True)
    K_T = _k_t_host(*wins)
    K_j = K_T.copy()
    if fs:
        K_j[K_T.shape[0] // 2:] *= np.float32(fs)
    rng = np.random.default_rng(4)
    xp = rng.standard_normal(n_out + n_fft - 1).astype(np.float32)
    R = rng.standard_normal((K_T.shape[0], n_out)).astype(np.float32)

    def h_route(Sr, Si, Fr, Fs, n, adjoint=None):
        assert adjoint is not None
        return _bluestein_adjoint_model(torch.cat([Sr, Si], dim=-2),
                                        adjoint, Sr.shape[-1])

    monkeypatch.setattr(stft_cuda, "istft_ola", h_route)
    gj = jax.grad(lambda x: jnp.sum(stft_dft_fused(
        x, K_j, n_fft, n_out, interpret=True) * R))(jnp.asarray(xp))
    x = _leaf(xp)
    out = stft_cuda.stft_dft(x, torch.as_tensor(K_T), n_fft, n_out, fs=fs,
                             spec=_dft_spec(*wins))
    (gt,) = _grads((out * torch.as_tensor(R)).sum(), [x])
    assert _rel(gt.numpy(), gj) < 1e-5


@pytest.mark.parametrize("n_fft,win_exp", [(598, 1), (256, 0), (121, 2)])
def test_istft_ola_grad_matches_jax(n_fft, win_exp):
    n_segs = 1000
    win = get_window(None, n_fft, n_fft=n_fft, dtype="float32")
    Fr, Fs = _irfft_mats_weighted(n_fft, True, _win_bytes(win), win_exp,
                                  torch.device("cpu"))
    nf = n_fft // 2 + 1
    rng = np.random.default_rng(5)
    Sr, Si = (rng.standard_normal((nf, n_segs)).astype(np.float32)
              for _ in range(2))
    R = rng.standard_normal(n_segs + n_fft - 1).astype(np.float32)

    def j_loss(Sr, Si):
        x = istft_ola_fused(jax.lax.complex(Sr, Si), Fr.numpy(), Fs.numpy(),
                            n_fft, interpret=True)
        return jnp.sum(x * R)

    gj = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(Sr), jnp.asarray(Si))
    leaves = [_leaf(Sr), _leaf(Si)]
    out = stft_cuda.istft_ola(*leaves, Fr, Fs, n_fft)
    gt = _grads((out * torch.as_tensor(R)).sum(), leaves)
    for a, j in zip(gt, gj):
        assert _rel(a.numpy(), j) < 1e-5


# -- G: SsqStftFusedFn ------------------------------------------------------------
def _ssq_signal(N=1500, fs=500.0):
    """tests/test_stft_pallas.py's ssq_stft gradient setup."""
    rng = np.random.default_rng(8)
    t = np.arange(N) / fs
    return (np.cos(2 * np.pi * 60 * t) + 0.1 * rng.standard_normal(N)
            ).astype(np.float32)


def test_ssq_stft_fused_grad_matches_jax():
    n_fft, fs = 128, 500.0
    x = _ssq_signal()
    N = len(x)
    xp = np.pad(x, (n_fft // 2, (n_fft - 1) // 2), mode="reflect")
    win, dwin = get_window(None, n_fft, n_fft, derivative=True,
                           dtype="float32")
    K_T = _k_t_host(_win_bytes(win), _win_bytes(dwin), n_fft, True)
    nf = n_fft // 2 + 1
    Sfs = np.linspace(0, 0.5 * fs, nf, dtype=np.float32)
    const, mode, params = plan_reassignment(Sfs, nf, False, transform="stft")
    gamma = 10 * EPS32

    def j_loss(xp):
        Tx, Sx = j_ssq_fused(xp, K_T, n_fft, N, fs, jnp.asarray(Sfs),
                             jnp.asarray(const, jnp.float32), gamma, params,
                             mode, False, interpret=True)
        return jnp.sum(jnp.abs(Tx) ** 2) + jnp.sum(jnp.abs(Sx) ** 2)

    gj = np.asarray(jax.grad(j_loss)(jnp.asarray(xp)))
    x_t = _leaf(xp)
    Tx, Sx = stft_cuda.ssq_stft_fused(x_t, torch.as_tensor(K_T), n_fft, N, fs,
                                      Sfs, const, gamma, params, mode, False)
    (gt,) = _grads((Tx.abs() ** 2).sum() + (Sx.abs() ** 2).sum(), [x_t])
    assert np.isfinite(gt.numpy()).all()
    assert _rel(gt.numpy(), gj) < 5e-3


# -- the entry points end to end --------------------------------------------------
def _cwt_signal(N=1024):
    return np.cos(2 * np.pi * 50 * np.arange(N) / N).astype(np.float32)


@pytest.mark.parametrize("which", ["ssq", "wx"])
def test_ssq_cwt_grad_matches_jax(which):
    """tests/test_grad.py's end-to-end setup: N = 1024, GMW beta 8, log
    scales at nv = 16; loss sum|Tx|^2 + sum|Wx|^2, or sum|Wx|^2 alone."""
    x = _cwt_signal()
    N = len(x)
    kw = dict(scales="log", nv=16, fs=float(N))
    wav = ("gmw", {"beta": 8.0})

    def loss(Tx, Wx, xp):
        wx = xp.sum(xp.abs(Wx[..., :N]) ** 2)
        return wx if which == "wx" else wx + xp.sum(xp.abs(Tx[..., :N]) ** 2)

    gj = np.asarray(jax.grad(lambda x: loss(
        *j_ssq_cwt(x, wav, dtype="float32", **kw)[:2], jnp))(jnp.asarray(x)))
    x_t = _leaf(x)
    Tx, Wx, *_ = ssq_cwt(x_t, wav, **kw)
    (gt,) = _grads(loss(Tx, Wx, torch), [x_t])
    assert np.isfinite(gt.numpy()).all()
    assert _rel(gt.numpy(), gj) < (1e-4 if which == "wx" else 5e-3)


@pytest.mark.parametrize("route", ["fused", "two_kernel"])
def test_ssq_stft_grad_matches_jax(monkeypatch, route):
    """Both port routes (kernel G; F then B') against the JAX XLA route,
    loss sum|Tx|^2 + sum|Sx|^2."""
    n_fft, fs = 128, 500.0
    x = _ssq_signal()
    kw = dict(n_fft=n_fft, fs=fs)
    if route == "two_kernel":
        kw["ssq_freqs"] = np.linspace(0, fs / 2, n_fft // 2 + 1,
                                      dtype=np.float32)
    monkeypatch.setenv("SSQ_TPU_KERNELS", "0")
    jax.clear_caches()

    def j_loss(x):
        Tx, Sx, *_ = j_ssq_stft(x, dtype="float32", **kw)
        return jnp.sum(jnp.abs(Tx) ** 2) + jnp.sum(jnp.abs(Sx) ** 2)

    gj = np.asarray(jax.grad(j_loss)(jnp.asarray(x)))
    jax.clear_caches()
    x_t = _leaf(x)
    Tx, Sx, *_ = ssq_stft(x_t, **kw)
    (gt,) = _grads((Tx.abs() ** 2).sum() + (Sx.abs() ** 2).sum(), [x_t])
    assert np.isfinite(gt.numpy()).all()
    assert _rel(gt.numpy(), gj) < 5e-3


def test_stft_grad_matches_jax(monkeypatch):
    x = np.random.default_rng(2).standard_normal(1000).astype(np.float32)
    monkeypatch.setenv("SSQ_TPU_KERNELS", "0")
    jax.clear_caches()
    gj = np.asarray(jax.grad(lambda x: jnp.sum(jnp.abs(
        j_stft(x, n_fft=128, hop_len=1, dtype="float32")) ** 2))(
        jnp.asarray(x)))
    jax.clear_caches()
    x_t = _leaf(x)
    (gt,) = _grads((stft(x_t, n_fft=128).abs() ** 2).sum(), [x_t])
    assert _rel(gt.numpy(), gj) < 1e-4


def test_istft_grad_matches_jax(monkeypatch):
    """Loss sum x^2 of istft, with respect to the planes of Sx."""
    N, n_fft = 2000, 256
    x = np.random.default_rng(5).standard_normal(N).astype(np.float32)
    Sx = stft(x, n_fft=n_fft, device="cpu").numpy()
    Sr, Si = Sx.real.copy(), Sx.imag.copy()
    monkeypatch.setenv("SSQ_TPU_KERNELS", "0")
    jax.clear_caches()
    gj = jax.grad(lambda a, b: jnp.sum(j_istft(
        jax.lax.complex(a, b), n_fft=n_fft, hop_len=1, N=N) ** 2),
        argnums=(0, 1))(jnp.asarray(Sr), jnp.asarray(Si))
    jax.clear_caches()
    leaves = [_leaf(Sr), _leaf(Si)]
    y = istft(torch.complex(*leaves), n_fft=n_fft, N=N)
    gt = _grads((y ** 2).sum(), leaves)
    for a, j in zip(gt, gj):
        assert _rel(a.numpy(), j) < 1e-4


# -- the pad's adjoint ----------------------------------------------------------
@pytest.mark.parametrize("padtype", list(t_pad.PAD_MODES))
def test_pad_adjoint_equals_autograd_of_gather(padtype):
    """padsignal's deterministic adjoint against autograd of the plain
    gather (nn.functional.pad for 'zero'), with pads shorter and longer
    than the signal and a leading batch dim."""
    rng = np.random.default_rng(6)
    for N, padlength in ((10, 37), (7, 30), (100, 256), (1000, 1597)):
        x = _leaf(rng.standard_normal((2, N)))
        xp = t_pad.padsignal(x, padtype, padlength=padlength)
        g = torch.as_tensor(rng.standard_normal(xp.shape))
        (a,) = torch.autograd.grad(xp, x, g)
        _, n1, n2 = t_pad.pad_params(N, padlength)
        ref = (torch.nn.functional.pad(x, (n1, n2)) if padtype == "zero" else
               x[..., t_pad._source_index(padtype, N, n1, n2, "cpu")])
        assert torch.equal(xp, ref)
        (b,) = torch.autograd.grad(ref, x, g)
        if padtype == "replicate":
            assert float((a - b).abs().max() / b.abs().max()) < 1e-12
        else:
            assert torch.equal(a, b)
