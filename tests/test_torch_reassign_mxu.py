"""Kernel I (the digit-split tensor-core reassignment) of the torch port
on the CPU: its plain version `reassign_mxu_plain`, which the port runs
under SSQ_TPU_REASSIGN_IMPL=mxu on CPU tensors, against the JAX
package's `reassign_pallas` under the same selector (the MXU Pallas kernel
in interpret mode), and against the port's plain B'. Inputs: the chirp
CWT planes of tests/test_reassign_pallas.py (`_setup`), made by the JAX
package from a seeded numpy signal and handed to both.

Tolerances. Within the port, the JAX package's own bar for I against B'
(tests/test_reassign_pallas.py::test_mxu_impl_matches_vpu): sum over
entries of |I - B'| / sum |B'| < 2e-5 (the two sum the same float32
products in other orders) and nonzero patterns equal on >= 99.99 % of
entries. Across the packages the log modes' bins themselves differ: an
ulp of log2 between torch and XLA moves ~0.01 % of the values to the
neighbouring bin (4.5e-5 sum-relative here, for B' as much as for I), so
the port's I is held to the JAX I with the B' parity bars of
tests/test_torch_reassign.py (>= 99.99 % of entries within 1e-6 of
max|Tx|, column sums within 1e-6), and what I changes against B' must be
the same in both packages: sum |(I - B')_port - (I - B')_jax| / sum |B'|
< 2e-5. The gradient through I is the gradient through B' bit for bit:
both backwards are the same gather C' over the same bins.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ssqueeze_rs_tpu import cwt
from ssqueeze_rs_tpu.ops.reassign_pallas import reassign_pallas
from ssqueeze_rs_tpu.ops.ssqueeze import bin_params
from ssqueeze_rs_tpu_torch.ops import reassign_cuda

GAMMA = 1e-5
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
    """tests/test_reassign_pallas.py::_setup: a chirp's CWT and dWx."""
    N = 1024
    rng = np.random.default_rng(0)
    t = np.linspace(0, 10, N, endpoint=False)
    x = np.cos(2 * np.pi * 3 * np.exp(t / 3)) + 0.1 * rng.standard_normal(N)
    Wx, _, dWx = cwt(x, ("gmw", {"beta": 8.0}), scales="log", fs=N / 10,
                     derivative=True, dtype="float32")
    Wx, dWx = np.asarray(Wx).astype(np.complex64), np.asarray(dWx)
    return (Wx.real.copy(), Wx.imag.copy(), dWx.real.astype(np.float32),
            dWx.imag.astype(np.float32))


def _case(planes, mode_expect, flipud, transform="cwt"):
    C, D, A, B = planes
    na = C.shape[0]
    freqs = FREQS[mode_expect]
    mode, params = bin_params(freqs, mode_expect != "lin")
    assert mode == mode_expect
    const = np.full(na, 0.021, np.float32)
    Sfs = (np.linspace(0.0, 40.0, na) if transform == "stft"
           else np.zeros(na)).astype(np.float32)
    return (C, D, A, B, const, Sfs, GAMMA, params, mode, flipud, len(freqs),
            transform)


def _held(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.abs(out - ref).sum() / np.abs(ref).sum() < 2e-5
    assert ((np.abs(out) > 0) == (np.abs(ref) > 0)).mean() >= 0.9999


def _tx(pair):
    return (pair[0] + 1j * pair[1]).numpy()


@pytest.mark.parametrize("flipud", [False, True])
@pytest.mark.parametrize("mode_expect", list(FREQS))
def test_mxu_matches_jax_mxu(monkeypatch, planes, mode_expect, flipud):
    """The port under SSQ_TPU_REASSIGN_IMPL=mxu (plain I on the CPU)
    against the JAX package's MXU kernel under the same selector."""
    a = _case(planes, mode_expect, flipud)
    C, D, A, B, const, Sfs = a[:6]

    def both(impl):
        monkeypatch.setenv("SSQ_TPU_REASSIGN_IMPL", impl)
        before = (reassign_cuda.LAUNCHES4, reassign_cuda.LAUNCHES_MXU)
        out = _tx(reassign_cuda.reassign4(*a))
        assert (reassign_cuda.LAUNCHES4, reassign_cuda.LAUNCHES_MXU) == before
        ref = np.asarray(reassign_pallas(
            (jnp.asarray(C), jnp.asarray(D)), (jnp.asarray(A), jnp.asarray(B)),
            jnp.asarray(const), GAMMA, jnp.asarray(Sfs), a[7], mode=a[8],
            flipud=flipud, transform="cwt", nf=a[10], interpret=True))
        return out, ref

    mxu, mxu_jax = both("mxu")
    vpu, vpu_jax = both("vpu")
    assert mxu.shape == mxu_jax.shape == (a[10], C.shape[1])
    top = np.abs(mxu_jax).max()
    assert (np.abs(mxu - mxu_jax) <= 1e-6 * top).mean() >= 0.9999
    cs, cs_jax = mxu.sum(0), mxu_jax.sum(0)
    assert np.abs(cs - cs_jax).max() <= 1e-6 * np.abs(cs_jax).max()
    _held(mxu, vpu)
    assert (np.abs((mxu - vpu) - (mxu_jax - vpu_jax)).sum() /
            np.abs(vpu_jax).sum()) < 2e-5


@pytest.mark.parametrize("transform", ["cwt", "stft"])
@pytest.mark.parametrize("mode_expect", list(FREQS))
def test_mxu_plain_matches_b4_plain(planes, mode_expect, transform):
    """Plain I against the port's plain B' on the same planes, with a
    batch of two (the second planes doubled)."""
    a = _case(planes, mode_expect, transform == "cwt", transform)
    two = tuple(np.stack([p, 2 * p]) for p in a[:4])
    out = reassign_cuda.reassign_mxu_plain(*two, *a[4:])
    ref = reassign_cuda.reassign4_plain(*two, *a[4:])
    assert out[0].shape == (2, a[10], a[0].shape[1])
    for b in range(2):
        _held(_tx((out[0][b], out[1][b])), _tx((ref[0][b], ref[1][b])))


def test_gradient_through_mxu_is_b4s(monkeypatch, planes):
    """reassign4's gradient under 'mxu' equals the one under 'vpu' bit for
    bit (the shared backward C' over the same bins), with zero to dWx."""
    a = _case(planes, "log-piecewise", True)
    g = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (a[10], a[0].shape[1])).astype(np.float32))

    def grads(impl):
        monkeypatch.setenv("SSQ_TPU_REASSIGN_IMPL", impl)
        leaves = [torch.tensor(p, requires_grad=True) for p in a[:4]]
        txr, txi = reassign_cuda.reassign4(*leaves, *a[4:])
        (txr * g + txi * g.flip(0)).sum().backward()
        return [p.grad for p in leaves]

    vpu, mxu = grads("vpu"), grads("mxu")
    for gv, gm in zip(vpu, mxu):
        assert torch.equal(gv, gm)
    assert float(vpu[0].abs().max()) > 0
    assert not vpu[2].any() and not vpu[3].any()


def test_selector(monkeypatch, planes):
    """An unknown SSQ_TPU_REASSIGN_IMPL raises (the JAX package would run
    'vpu'); the 3-plane route (kernel B) ignores the variable; `'vpu'` and
    no value run B'; 'mxu' runs plain I on CPU tensors."""
    a = _case(planes, "log", True)
    monkeypatch.setenv("SSQ_TPU_REASSIGN_IMPL", "MXU")
    with pytest.raises(ValueError, match="SSQ_TPU_REASSIGN_IMPL"):
        reassign_cuda.reassign4(*a)
    C, D, A, B, const, Sfs = a[:6]
    w = reassign_cuda.phase_w(*(torch.as_tensor(p) for p in (C, D, A, B)),
                              torch.as_tensor(Sfs), GAMMA, "cwt")
    three = (C, D, w, const, a[7], a[8], True, a[10])
    got = reassign_cuda.reassign(*three)
    monkeypatch.delenv("SSQ_TPU_REASSIGN_IMPL")
    ref = reassign_cuda.reassign(*three)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    b4 = reassign_cuda.reassign4(*a)
    monkeypatch.setenv("SSQ_TPU_REASSIGN_IMPL", "vpu")
    assert all(torch.equal(x, y) for x, y in
               zip(reassign_cuda.reassign4(*a), b4))
    monkeypatch.setenv("SSQ_TPU_REASSIGN_IMPL", "mxu")
    assert all(torch.equal(x, y) for x, y in
               zip(reassign_cuda.reassign4(*a),
                   reassign_cuda.reassign_mxu_plain(*a)))


def test_tiles_per_pass():
    """Kernel I keeps at most 4 tiles of 256 bins in registers per pass
    and spreads the tiles evenly over the passes; every nf B' takes (up
    to 3632) launches."""
    assert [reassign_cuda._mxu_tiles_per_pass(nf) for nf in
            (1, 256, 257, 293, 300, 1024, 1025, 2048, 3632)] == \
        [1, 1, 2, 2, 2, 4, 3, 4, 4]
