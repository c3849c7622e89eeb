"""Kernel B's plain-torch version (`reassign_plain`) against the JAX
package's reassignment kernel (`reassign_pallas` with `w_plane`, the
3-plane contract; Pallas in interpret mode), both fed the SAME Wx planes
and the same w plane, for the log, log-piecewise and lin bin modes with
flipud on and off.

Tolerances: log2 may differ by an ulp between torch and XLA, which can
move a value across a rounding tie, so the bin indices must agree on
>= 99.99 % of unmasked entries (not all); the per-column sum over bins,
which does not depend on the bins, must agree to 1e-6 of the largest
column sum (the two sum the same float32 products in other orders).
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
    where |Wx|^2 <= gamma^2), with sub-gamma rows so the mask is used."""
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
    return C, D, w, const


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
    C, D, w, const = planes
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
    C, D, w, const = planes
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
    C, D, w, const = planes
    mode, params = bin_params(FREQS["log"], True)
    with pytest.raises(ValueError, match="share one"):
        reassign_cuda.reassign(C, D, w[:, :-1], const, params, mode, True, 200)
    with pytest.raises(ValueError, match="const"):
        reassign_cuda.reassign(C, D, w, const[:-1], params, mode, True, 200)
    with pytest.raises(ValueError, match="mode"):
        reassign_cuda.reassign(C, D, w, const, params, "nope", True, 200)
