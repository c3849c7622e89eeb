"""Kernel B's plain-torch versions against the JAX package's
reassignment kernel (`reassign_pallas`, Pallas in interpret mode), both
fed the SAME planes, for the log, log-piecewise and lin bin modes:
`reassign_plain` (B) against its 3-plane contract (`w_plane`), flipud on
and off, and `reassign4_plain` (B') against its 4-plane contract (Wx and
dWx), for the CWT and the STFT phase transforms.

Tolerances: log2 may differ by an ulp between torch and XLA, which can
move a value across a rounding tie, so the bin indices must agree on
>= 99.99 % of unmasked entries (not all); the per-column sum over bins,
which does not depend on the bins, must agree to 1e-6 of the largest
column sum (the two sum the same float32 products in other orders).
For B', the bins of the torch phase plane and of the JAX binning code run
eagerly agree on >= 99.99 % of unmasked entries; the Tx entries agree to
1e-6 of max|Tx| on >= 99.99 % of entries (the JAX kernel's fused XLA
code rounds w in its own way, so its bins can differ from the eager ones
too, and each bin that moves changes two entries); column sums as for B.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ssqueeze_rs_tpu import cwt
from ssqueeze_rs_tpu.ops.reassign_pallas import _bin_indices, reassign_pallas
from ssqueeze_rs_tpu.ops.ssqueeze import bin_params
from ssqueeze_rs_tpu_torch.ops import reassign_cuda

GAMMA = 1e-6

FREQS = {
    "log": np.geomspace(0.05, 50.0, 200),
    "log-piecewise": np.hstack([np.geomspace(0.05, 1.0, 150, endpoint=False),
                                np.geomspace(1.0, 50.0, 50)]),
    "lin": np.linspace(0.05, 50.0, 200),
}


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def planes():
    """A chirp's CWT planes and its w plane (the fused-phase formula, +inf
    where |Wx|^2 <= gamma^2), with sub-gamma rows so the mask is used;
    then the dWx planes."""
    N = 1024
    rng = np.random.default_rng(0)
    t = np.linspace(0, 10, N, endpoint=False)
    x = np.cos(2 * np.pi * 3 * np.exp(t / 3)) + 0.1 * rng.standard_normal(N)
    Wx, _, dWx = cwt(x, ("gmw", {"beta": 8.0}), scales="log", fs=N / 10,
                     derivative=True, dtype="float32")
    Wx, dWx = np.asarray(Wx).copy(), np.asarray(dWx)
    Wx[40:45] *= 1e-9
    C, D = Wx.real, Wx.imag
    A, B = dWx.real, dWx.imag
    mag2 = C * C + D * D
    w = np.abs((B * C - A * D) / (mag2 * np.float32(6.283185307179586)))
    w = np.where(mag2 > np.float32(GAMMA ** 2), w, np.inf).astype(np.float32)
    const = np.linspace(0.01, 0.05, Wx.shape[0]).astype(np.float32)
    return C, D, w, const, A.astype(np.float32), B.astype(np.float32)


def _jax_tx(C, D, w, const, mode, params, flipud, nf):
    out = reassign_pallas((jnp.asarray(C), jnp.asarray(D)), None,
                          jnp.asarray(const), GAMMA,
                          jnp.zeros((C.shape[0],), jnp.float32), params,
                          mode=mode, flipud=flipud, transform="cwt", nf=nf,
                          interpret=True, w_plane=jnp.asarray(w))
    return np.asarray(out)


@pytest.mark.parametrize("flipud", [False, True])
@pytest.mark.parametrize("mode_expect", list(FREQS))
def test_plain_matches_jax_kernel(planes, mode_expect, flipud):
    C, D, w, const = planes[:4]
    freqs = FREQS[mode_expect]
    mode, params = bin_params(freqs, mode_expect != "lin")
    assert mode == mode_expect
    nf = len(freqs)

    k_jax, _ = _bin_indices(mode, dict(params), GAMMA, flipud, "cwt", nf,
                            w.shape[1], w.shape[1], None, None, None, None,
                            None, w_pre=jnp.asarray(w))
    k_jax = np.asarray(k_jax)
    k_t = reassign_cuda.bin_indices(torch.as_tensor(w), mode, params,
                                    flipud, nf).numpy()
    assert np.array_equal(k_jax < 0, k_t < 0)
    unmasked = k_jax >= 0
    assert unmasked.mean() > 0.9 and not unmasked.all()
    assert (k_jax == k_t)[unmasked].mean() >= 0.9999

    txr, txi = reassign_cuda.reassign_plain(C, D, w, const, params, mode,
                                            flipud, nf)
    tx = (txr + 1j * txi).numpy()
    tx_jax = _jax_tx(C, D, w, const, mode, params, flipud, nf)
    assert tx.shape == tx_jax.shape == (nf, C.shape[1])
    cs, cs_jax = tx.sum(0), tx_jax.sum(0)
    assert np.abs(cs - cs_jax).max() <= 1e-6 * np.abs(cs_jax).max()


def test_batch_and_cpu_dispatch(planes):
    """(2, na, n) planes give each signal's own Tx; a CPU call never
    launches the kernel; numpy input lands on the CPU."""
    C, D, w, const = planes[:4]
    mode, params = bin_params(FREQS["log"], True)
    nf = len(FREQS["log"])
    one = reassign_cuda.reassign_plain(C, D, w, const, params, mode, True, nf)
    C2 = np.stack([C, 2 * C])
    D2 = np.stack([D, 2 * D])
    w2 = np.stack([w, w])
    before = reassign_cuda.LAUNCHES
    two = reassign_cuda.reassign(C2, D2, w2, const, params, mode, True, nf)
    assert reassign_cuda.LAUNCHES == before
    assert two[0].device.type == "cpu" and two[0].shape == (2, nf, C.shape[1])
    for a, b in zip(two, one):
        assert torch.equal(a[0], b)
        assert torch.equal(a[1], 2 * b)


def test_width_and_const_checks(planes):
    """Plane widths are checked up front (the JAX wrapper only fails in
    a reshape)."""
    C, D, w, const = planes[:4]
    mode, params = bin_params(FREQS["log"], True)
    with pytest.raises(ValueError, match="share one"):
        reassign_cuda.reassign(C, D, w[:, :-1], const, params, mode, True, 200)
    with pytest.raises(ValueError, match="const"):
        reassign_cuda.reassign(C, D, w, const[:-1], params, mode, True, 200)
    with pytest.raises(ValueError, match="mode"):
        reassign_cuda.reassign(C, D, w, const, params, "nope", True, 200)


@pytest.mark.parametrize("transform", ["cwt", "stft"])
@pytest.mark.parametrize("mode_expect", list(FREQS))
def test_plain4_matches_jax_kernel(planes, mode_expect, transform):
    """B' (4 planes, w and mask formed from Wx and dWx) against the JAX
    kernel's 4-plane contract."""
    C, D, _, const, A, B = planes
    na, n = C.shape
    freqs = FREQS[mode_expect]
    mode, params = bin_params(freqs, mode_expect != "lin")
    nf = len(freqs)
    Sfs = np.linspace(0.0, 40.0, na).astype(np.float32)
    flipud = transform == "cwt"

    k_jax, mask = _bin_indices(mode, dict(params), GAMMA, flipud, transform,
                               nf, n, n, jnp.asarray(C), jnp.asarray(D),
                               jnp.asarray(A), jnp.asarray(B),
                               jnp.asarray(Sfs)[:, None])
    k_jax = np.asarray(k_jax)
    w = reassign_cuda.phase_w(*(torch.as_tensor(a) for a in (C, D, A, B)),
                              torch.as_tensor(Sfs), GAMMA, transform)
    k_t = reassign_cuda.bin_indices(w, mode, params, flipud, nf).numpy()
    assert np.array_equal(k_jax < 0, k_t < 0)
    unmasked = k_jax >= 0
    assert unmasked.mean() > 0.9 and not unmasked.all()
    agree = k_jax == k_t
    assert agree[unmasked].mean() >= 0.9999

    before = reassign_cuda.LAUNCHES4
    txr, txi = reassign_cuda.reassign4(C, D, A, B, const, Sfs, GAMMA, params,
                                       mode, flipud, nf, transform)
    assert reassign_cuda.LAUNCHES4 == before
    tx = (txr + 1j * txi).numpy()
    tx_jax = np.asarray(reassign_pallas(
        (jnp.asarray(C), jnp.asarray(D)), (jnp.asarray(A), jnp.asarray(B)),
        jnp.asarray(const), GAMMA, jnp.asarray(Sfs), params, mode=mode,
        flipud=flipud, transform=transform, nf=nf, interpret=True))
    assert tx.shape == tx_jax.shape == (nf, n)
    top = np.abs(tx_jax).max()
    assert (np.abs(tx - tx_jax) <= 1e-6 * top).mean() >= 0.9999
    cs, cs_jax = tx.sum(0), tx_jax.sum(0)
    assert np.abs(cs - cs_jax).max() <= 1e-6 * np.abs(cs_jax).max()


def test_block_cols_repair():
    """Columns per block of csrc/reassign.cu chosen from nf: the (2, nf,
    cols) accumulator stays within 227 KB of shared memory. With the fixed
    32 columns, nf = 909 and above (the STFT's 1025 rows at n_fft = 2048)
    were refused."""
    assert reassign_cuda._block_cols(300) == 32
    assert reassign_cuda._block_cols(908) == 32
    assert reassign_cuda._block_cols(909) == 16
    assert reassign_cuda._block_cols(1025) == 16
    assert reassign_cuda._block_cols(3632) == 8
    with pytest.raises(ValueError, match="shared-memory"):
        reassign_cuda._block_cols(3633)
