"""A real squeezed Wx gives a real Tx, as in the JAX package: its scatter
accumulates into zeros of the values' type, so `squeezing=lambda W:
abs(W)**2` (or a real Wx handed to `ssqueeze` / `reassign`) returns
float32 for float32 input, not complex64. Each entry point of the port
against the JAX package's on the CPU (its XLA routes), from one numpy
seed: the dtype equal, the values at the bars the files of each entry
point use today:
  ssq_cwt, ops.ssqueeze, ops.reassign   tests/test_torch_ssq_cwt.py's
        routes: mean column relative error of sum_k |Tx| < 1e-4, |sum Tx
        - sum Tx_jax| < 1e-5 * sum |Tx_jax|
  ssq_stft, StreamingSSQSTFT   tests/test_torch_ssq_stft.py: max over
        columns of |sum_k |Tx| - sum_k |Tx_jax|| < 1e-3 of the largest
  StreamingSSQCWT   tests/test_torch_streaming.py: sum |d| / sum |Tx_jax|
        < 5e-3
"""
import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ssqueeze_rs_tpu.streaming as J
from ssqueeze_rs_tpu import ssq_cwt as j_ssq_cwt, ssq_stft as j_ssq_stft
from ssqueeze_rs_tpu import cwt as j_cwt
import ssqueeze_rs_tpu_torch as T

# the modules (each package's `ops.ssqueeze` name is the function)
j_sq = importlib.import_module("ssqueeze_rs_tpu.ops.ssqueeze")
t_sq = importlib.import_module("ssqueeze_rs_tpu_torch.ops.ssqueeze")

FS, N = 1000.0, 2048


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _power(W):
    return abs(W) ** 2


def _signal(n=N, seed=4):
    t = np.arange(n) / FS
    noise = np.random.default_rng(seed).standard_normal(n)
    return (np.cos(2 * np.pi * (20 * t + 60 * t * t)) + 0.1 * noise
            ).astype(np.float32)


def _cwt_bars(Tx, Tx_j):
    Tx, Tx_j = np.asarray(Tx), np.asarray(Tx_j)
    assert Tx.shape == Tx_j.shape
    cs, cs_j = np.abs(Tx).sum(-2), np.abs(Tx_j).sum(-2)
    assert np.mean(np.abs(cs - cs_j) / cs_j) < 1e-4
    assert abs(Tx.sum() - Tx_j.sum()) < 1e-5 * np.abs(Tx_j).sum()


def _col_rel(Tx, Tx_j):
    c, c_j = np.abs(np.asarray(Tx)).sum(-2), np.abs(np.asarray(Tx_j)).sum(-2)
    return np.abs(c - c_j).max() / c_j.max()


def _dtype(t):
    return np.dtype(str(t.dtype).replace("torch.", ""))


def test_ssq_cwt_real_callable_gives_real_tx():
    x = _signal()
    Tx_j = np.asarray(j_ssq_cwt(x, "gmw", nv=8, fs=FS, dtype="float32",
                                squeezing=_power)[0])
    Tx = T.ssq_cwt(torch.as_tensor(x), "gmw", nv=8, fs=FS,
                   squeezing=_power)[0]
    assert Tx_j.dtype == _dtype(Tx) == np.float32
    _cwt_bars(Tx.numpy(), Tx_j)


def test_ssq_stft_real_callable_gives_real_tx():
    x = _signal(2000, seed=0)
    Tx_j = np.asarray(j_ssq_stft(x, n_fft=256, fs=FS, dtype="float32",
                                 squeezing=_power)[0])
    Tx = T.ssq_stft(x, device="cpu", n_fft=256, fs=FS, squeezing=_power)[0]
    assert Tx_j.dtype == _dtype(Tx) == np.float32
    assert _col_rel(Tx.numpy(), Tx_j) < 1e-3


def _real_planes():
    """A real Wx (|Wx|^2 of a GMW CWT), its dWx and the scales, from the
    JAX package's float32 cwt (the same arrays for both packages)."""
    x = _signal()
    Wx, scales, dWx = j_cwt(x, "gmw", nv=8, fs=FS, derivative=True,
                            dtype="float32")
    Wx, dWx = np.asarray(Wx)[..., :N], np.asarray(dWx)[..., :N]
    return (np.abs(Wx) ** 2).astype(np.float32), dWx, np.asarray(scales)


@pytest.mark.parametrize("route", ["dWx", "w"])
def test_ssqueeze_real_wx_gives_real_tx(route):
    """ops.ssqueeze on a real Wx: B' from dWx, or B from a phase plane."""
    Wr, dWx, scales = _real_planes()
    gamma = 1e-5
    kw = dict(scales=scales, fs=FS, transform="cwt", ssq_freqs="log")
    if route == "dWx":
        kw.update(dWx=dWx, gamma=gamma)
        w = None
    else:
        ratio = np.imag(dWx / np.where(Wr > 0, Wr, 1)) / (2 * np.pi)
        w = np.where(Wr > gamma, np.abs(ratio), np.inf).astype(np.float32)
    Tx_j, f_j = j_sq.ssqueeze(jnp.asarray(Wr), w, **kw)
    Tx, f = t_sq.ssqueeze(torch.as_tensor(Wr), w, device="cpu", **kw)
    assert np.asarray(Tx_j).dtype == _dtype(Tx) == np.float32
    assert np.array_equal(f, f_j)
    _cwt_bars(Tx.numpy(), np.asarray(Tx_j))


@pytest.mark.parametrize("fused", [True, False])
def test_reassign_real_wx_gives_real_tx(fused):
    """ops.ssqueeze.reassign (the JAX signature) on a real Wx, and on its
    float64 copy (float64 out in both packages)."""
    Wr, dWx, scales = _real_planes()
    nf = Wr.shape[-2]
    const, mode, params = t_sq.plan_reassignment(
        np.geomspace(1, 400, nf), nf, True, transform="cwt",
        cwt_scaletype="log", nv=8)
    gamma = 1e-5
    w = np.where(Wr > gamma, np.abs(np.imag(dWx / np.where(
        Wr > 0, Wr, 1))) / (2 * np.pi), np.inf).astype(np.float32)
    second = dWx if fused else w
    kw = dict(mode=mode, flipud=True, fused=fused, transform="cwt", nf=nf)
    for dt in (np.float32, np.float64):
        jprm = {k: jnp.asarray(v, jnp.int32 if k == "idx1" else dt)
                for k, v in params.items()}
        Tx_j = np.asarray(j_sq.reassign(
            jnp.asarray(Wr.astype(dt)), jnp.asarray(second),
            jnp.asarray(const, dt), jnp.asarray(gamma, dt),
            jnp.zeros(nf, dt), jprm, **kw))
        Tx = t_sq.reassign(torch.as_tensor(Wr.astype(dt)),
                           torch.as_tensor(np.array(second)), const, gamma,
                           None, params, **kw)
        assert Tx_j.dtype == _dtype(Tx) == dt
        _cwt_bars(Tx.numpy(), Tx_j)


def _stream(s, x, sizes):
    """Feed `x` in ragged chunks, flush; the columns of the calls that
    returned some (both packages' empty results are complex whatever the
    squeezing, and would promote a real Tx in the concatenation)."""
    outs, i, k = [], 0, 0
    while i < x.shape[-1]:
        outs.append(s.feed(x[..., i:i + sizes[k % len(sizes)]]))
        i += sizes[k % len(sizes)]
        k += 1
    outs.append(s.flush())
    outs = [o for o in outs if o[0].shape[-1]]
    return tuple(np.concatenate(p, axis=-1) for p in zip(*outs))


def test_streaming_ssq_cwt_real_callable_gives_real_tx():
    x = _signal(seed=5)
    kw = dict(block=512, fs=FS, nv=16, plan_N=N, halo=256, squeezing=_power)
    Tx, Wx = _stream(T.StreamingSSQCWT(**kw, device="cpu"), x, [512, 300])
    Tx_j, Wx_j = _stream(J.StreamingSSQCWT(**kw), x, [512, 300])
    assert Tx.dtype == Tx_j.dtype == np.float32
    assert Wx.dtype == Wx_j.dtype == np.complex64
    assert Tx.shape == Tx_j.shape and Tx.shape[-1] == N
    assert np.abs(Tx - Tx_j).sum() / np.abs(Tx_j).sum() < 5e-3


def test_streaming_ssq_stft_real_callable_gives_real_tx():
    x = _signal(1024, seed=9)
    kw = dict(block=256, n_fft=128, fs=FS, squeezing=_power)
    Tx, _ = _stream(T.StreamingSSQSTFT(**kw, device="cpu"), x, [256])
    Tx_j, _ = _stream(J.StreamingSSQSTFT(**kw), x, [256])
    assert Tx.dtype == Tx_j.dtype == np.float32
    assert _col_rel(Tx, Tx_j) < 1e-3
