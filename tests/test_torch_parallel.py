"""The port's sharded transforms (`ssqueeze_rs_tpu_torch.parallel`) on the
CPU: meshes of eight CPU entries, (1, 8) and (2, 4), against the JAX
package's `chunked_*` on its (1, 8) and (2, 4) meshes of virtual devices
(tests/conftest.py), the same x from a numpy seed and the shapes of
tests/test_parallel.py; against the port's own unsharded transforms;
`comm_report` against the JAX one; `halo_extend`'s ends; the
single-process runtime helpers; and a two-process gloo run (the time
axis across the processes) against the one-process run.

Tolerances: float64, 1e-10 of max|out| against JAX (Tx: max|d| <= 1e-9
sum|Tx|, a bin can move where ulp-level Wx differences meet a rounding
tie); float32, the bars of tests/test_torch_ssq_cwt.py (Wx 1e-5 of max,
mean column-marginal error 1e-4, total 1e-5) and
tests/test_torch_ssq_stft.py (Sx 2e-6 of max, column marginals 1e-3).
Against the port's unsharded transforms: stft, istft, ssq_stft's Sx,
icwt and the inverse squeezes equal; cwt within 1e-5 of max|Wx| (the JAX
test's bar); ssq_cwt's column marginals within 5e-2 (the JAX test's).
The JAX Pallas kernel under shard_map is not compared: its own test
fails on the unchanged package.
"""
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = dict(dtype="float64")
WAV = ("gmw", {"beta": 8.0})
SHAPES = [(1, 8), (2, 4)]


def _mesh(shape):
    from ssqueeze_rs_tpu_torch.parallel import make_mesh
    return make_mesh(shape, devices=["cpu"] * 8)


def _jmesh(shape):
    from ssqueeze_rs_tpu.parallel import make_mesh
    return make_mesh(shape, ("data", "time"))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _tx_ok(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() <= 1e-9 * np.abs(b).sum()


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture(autouse=True)
def _quiet_halo(monkeypatch):
    """Silence the halo-clip warnings of the small shards (both packages
    print them)."""
    from ssqueeze_rs_tpu_torch.parallel import chunked
    monkeypatch.setattr(chunked, "WARN", lambda msg: None)


# -- the forward transforms against JAX's chunked_* -----------------------------
@pytest.mark.parametrize("shape", SHAPES)
def test_chunked_stft_matches_jax_and_is_bitwise(shape):
    from ssqueeze_rs_tpu.parallel import chunked_stft as j_stft
    from ssqueeze_rs_tpu_torch import stft
    from ssqueeze_rs_tpu_torch.parallel import chunked_stft
    x = np.random.default_rng(0).standard_normal(2048)
    kw = dict(window="hann", n_fft=256, hop_len=64, **F64)
    got = chunked_stft(x, _mesh(shape), **kw)
    assert got.device.type == "cpu" and got.dtype == torch.complex128
    assert torch.equal(got, stft(torch.as_tensor(x), **kw))
    assert _rel(got, j_stft(x, _jmesh(shape), **kw)) < 1e-10


def test_chunked_stft_derivative_matches_jax():
    from ssqueeze_rs_tpu.parallel import chunked_stft as j_stft
    from ssqueeze_rs_tpu_torch import stft
    from ssqueeze_rs_tpu_torch.parallel import chunked_stft
    x = np.random.default_rng(1).standard_normal(1024)
    kw = dict(window="hann", n_fft=128, hop_len=16, fs=500.0, **F64)
    S, dS = chunked_stft(x, _mesh((1, 8)), derivative=True, **kw)
    Sr, dSr = stft(torch.as_tensor(x), derivative=True, **kw)
    assert torch.equal(S, Sr) and torch.equal(dS, dSr)
    Sj, dSj = j_stft(x, _jmesh((1, 8)), derivative=True, **kw)
    assert _rel(S, Sj) < 1e-10 and _rel(dS, dSj) < 1e-10


def test_chunked_stft_float32_hop1_bitwise():
    """float32 at hop 1: kernel F's route (its plain version here) on
    each shard equals the unsharded transform bit for bit."""
    from ssqueeze_rs_tpu_torch import stft
    from ssqueeze_rs_tpu_torch.parallel import chunked_stft
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(4096),
                        dtype=torch.float32)
    assert torch.equal(chunked_stft(x, _mesh((1, 8)), n_fft=128),
                       stft(x, n_fft=128))


@pytest.mark.parametrize("exact", [True, False])
def test_chunked_cwt_matches_jax(exact):
    from ssqueeze_rs_tpu.parallel import chunked_cwt as j_cwt
    from ssqueeze_rs_tpu_torch import cwt
    from ssqueeze_rs_tpu_torch.parallel import chunked_cwt
    N = 4096
    t = np.arange(N) / N
    x = np.cos(2 * np.pi * 64 * t) + 0.5 * np.cos(2 * np.pi * 300 * t)
    Wo, sc = chunked_cwt(x, _mesh((1, 8)), wavelet=WAV, scales="log",
                         exact=exact, **F64)
    Wj, scj = j_cwt(x, _jmesh((1, 8)), wavelet=WAV, scales="log",
                    exact=exact, **F64)
    assert np.array_equal(sc, np.asarray(scj))
    assert _rel(Wo, Wj) < 1e-10
    Wr, _ = cwt(torch.as_tensor(x), WAV, scales="log", **F64)
    err = _rel(Wo, Wr)
    assert err < (1e-5 if exact else 5e-2), err


def test_chunked_cwt_derivative_float32_matches_jax():
    from ssqueeze_rs_tpu.parallel import chunked_cwt as j_cwt
    from ssqueeze_rs_tpu_torch.parallel import chunked_cwt
    x = np.random.default_rng(3).standard_normal(2048).astype(np.float32)
    Wo, _, dWo = chunked_cwt(x, _mesh((1, 8)), scales="log", nv=16,
                             derivative=True)
    Wj, _, dWj = j_cwt(x, _jmesh((1, 8)), scales="log", nv=16,
                       derivative=True)
    assert Wo.dtype == torch.complex64
    assert _rel(Wo, Wj) < 1e-5 and _rel(dWo, dWj) < 1e-5


@pytest.mark.parametrize("shape", SHAPES)
def test_chunked_ssq_cwt_matches_jax(shape):
    from ssqueeze_rs_tpu.parallel import chunked_ssq_cwt as j_ssq
    from ssqueeze_rs_tpu_torch import ssq_cwt, issq_cwt
    from ssqueeze_rs_tpu_torch.utils.common import mad_rms
    from ssqueeze_rs_tpu_torch.parallel import chunked_ssq_cwt
    N = 2048
    t = np.linspace(0, 10, N, endpoint=False)
    x = np.cos(2 * np.pi * 3 * np.exp(t / 3))
    kw = dict(wavelet=WAV, scales="log", fs=N / 10, **F64)
    Tx, Wx, f, s = chunked_ssq_cwt(x, _mesh(shape), **kw)
    Tj, Wj, fj, sj = j_ssq(x, _jmesh(shape), **kw)
    assert np.array_equal(f, np.asarray(fj)) and np.array_equal(s, sj)
    assert _rel(Wx, Wj) < 1e-10 and _tx_ok(Tx, Tj)
    # against the port's unsharded ssq_cwt: the JAX test's bars
    Tr, *_ = ssq_cwt(torch.as_tensor(x), WAV, scales="log", fs=N / 10, **F64)
    col, col_r = Tx.abs().sum(0), Tr.abs().sum(0)
    assert float((col - col_r).abs().mean() / col_r.mean()) < 5e-2
    assert mad_rms(_np(issq_cwt(Tr, WAV)), _np(issq_cwt(Tx, WAV))) < 5e-2


def test_chunked_ssq_cwt_float32_matches_jax():
    from ssqueeze_rs_tpu.parallel import chunked_ssq_cwt as j_ssq
    from ssqueeze_rs_tpu_torch.parallel import chunked_ssq_cwt
    x = (np.cos(2 * np.pi * 100.0 * np.arange(2048) / 1000.0) +
         0.2 * np.random.default_rng(5).standard_normal(2048))
    Tx, Wx, *_ = chunked_ssq_cwt(x, _mesh((1, 8)), fs=1000.0, nv=16)
    Tj, Wj, *_ = j_ssq(x, _jmesh((1, 8)), fs=1000.0, nv=16)
    assert Tx.dtype == Wx.dtype == torch.complex64
    Tx, Tj = _np(Tx), np.asarray(Tj)
    assert _rel(Wx, Wj) < 1e-5
    cs, cs_j = np.abs(Tx).sum(0), np.abs(Tj).sum(0)
    assert np.mean(np.abs(cs - cs_j) / cs_j) < 1e-4
    assert abs(Tx.sum() - Tj.sum()) < 1e-5 * np.abs(Tj).sum()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_chunked_ssq_stft_matches_jax(dtype):
    from ssqueeze_rs_tpu.parallel import chunked_ssq_stft as j_ssq
    from ssqueeze_rs_tpu_torch import ssq_stft
    from ssqueeze_rs_tpu_torch.parallel import chunked_ssq_stft
    x = np.random.default_rng(3).standard_normal(1024)
    kw = dict(n_fft=128, fs=1000.0, dtype=dtype)
    To, So, f, sf = chunked_ssq_stft(x, _mesh((1, 8)), **kw)
    Tj, Sj, fj, sfj = j_ssq(x, _jmesh((1, 8)), **kw)
    assert np.array_equal(f, np.asarray(fj)) and np.array_equal(sf, sfj)
    Tr, Sr, *_ = ssq_stft(torch.as_tensor(x), **kw)
    assert torch.equal(So, Sr)
    if dtype == "float64":
        assert _rel(So, Sj) < 1e-10 and _tx_ok(To, Tj)
        assert float((To - Tr).abs().max()) <= 1e-12
    else:
        assert _rel(So, Sj) < 2e-6
        cs, cs_j = np.abs(_np(To)).sum(0), np.abs(np.asarray(Tj)).sum(0)
        assert np.mean(np.abs(cs - cs_j) / cs_j) < 1e-3


@pytest.mark.parametrize("squeezing", ["lebesgue", "abs"])
def test_chunked_squeezing_modes_match_jax(squeezing):
    from ssqueeze_rs_tpu.parallel import chunked_ssq_stft as j_ssq
    from ssqueeze_rs_tpu_torch.parallel import chunked_ssq_stft
    x = np.cos(2 * np.pi * 100.0 * np.arange(1024) / 1000.0)
    kw = dict(n_fft=128, fs=1000.0, squeezing=squeezing, **F64)
    To, *_ = chunked_ssq_stft(x, _mesh((1, 8)), **kw)
    Tj, *_ = j_ssq(x, _jmesh((1, 8)), **kw)
    assert _tx_ok(To, Tj)


def test_batch_and_time_sharding_matches_jax():
    """2-way batch x 4-way time: the batched chunked ssq_cwt equals the
    JAX package's and each row of it the one-row run."""
    from ssqueeze_rs_tpu.parallel import (chunked_ssq_cwt as j_ssq,
                                          shard_batch as j_shard)
    from ssqueeze_rs_tpu_torch.parallel import chunked_ssq_cwt, shard_batch
    X = np.random.default_rng(4).standard_normal((2, 1024))
    kw = dict(wavelet=WAV, scales="log", **F64)
    mesh = _mesh((2, 4))
    Xs = shard_batch(X, mesh, "data")
    assert set(Xs.blocks) == set(mesh.entries())
    Tb, Wb, *_ = chunked_ssq_cwt(Xs, mesh, batch_axis_name="data", **kw)
    jm = _jmesh((2, 4))
    Tj, Wj, *_ = j_ssq(j_shard(X, jm, "data"), jm, batch_axis_name="data",
                       **kw)
    assert _rel(Wb, Wj) < 1e-10 and _tx_ok(Tb, Tj)
    for i in range(2):
        Ti, *_ = chunked_ssq_cwt(X[i], _mesh((1, 4)), **kw)
        assert float((Tb[i] - Ti).abs().max()) <= 1e-12


# -- the inverse transforms ----------------------------------------------------
@pytest.mark.parametrize("n_fft, hop, win_exp, modulated",
                         [(64, 1, 1, True), (64, 4, 1, True),
                          (65, 1, 0, True), (64, 2, 2, False)])
def test_chunked_istft_bitwise_and_matches_jax(n_fft, hop, win_exp,
                                               modulated):
    from ssqueeze_rs_tpu.parallel import chunked_istft as j_istft
    from ssqueeze_rs_tpu_torch import istft, stft
    from ssqueeze_rs_tpu_torch.parallel import chunked_istft
    x = np.random.default_rng(7).standard_normal(1024)
    kw = dict(n_fft=n_fft, hop_len=hop, modulated=modulated)
    Sx = stft(torch.as_tensor(x), dtype="float64", **kw)
    got = chunked_istft(Sx, _mesh((1, 8)), win_exp=win_exp, **kw)
    want = istft(Sx, win_exp=win_exp, **kw)
    assert got.shape == want.shape and torch.equal(got, want)
    gj = j_istft(Sx.numpy(), _jmesh((1, 8)), win_exp=win_exp, **kw)
    assert _rel(got, gj) < 1e-10


def test_chunked_istft_float32_hop1_bitwise():
    """complex64 at hop 1 takes kernel H's route (its plain version here)
    with block-aligned frame halos: equal to the unsharded istft."""
    from ssqueeze_rs_tpu_torch import istft, stft
    from ssqueeze_rs_tpu_torch.parallel import chunked_istft
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(4096),
                        dtype=torch.float32)
    Sx = stft(x, n_fft=128)
    got = chunked_istft(Sx, _mesh((1, 8)), n_fft=128)
    assert torch.equal(got, istft(Sx, n_fft=128))


def test_chunked_istft_roundtrip_and_batch():
    from ssqueeze_rs_tpu_torch.utils.common import mad_rms
    from ssqueeze_rs_tpu_torch.parallel import (chunked_istft, chunked_stft,
                                                shard_batch)
    X = np.random.default_rng(8).standard_normal((2, 512))
    mesh = _mesh((2, 4))
    kw = dict(n_fft=64, hop_len=1)
    Sx = chunked_stft(shard_batch(X, mesh, "data"), mesh,
                      batch_axis_name="data", **kw, **F64)
    xr = chunked_istft(shard_batch(Sx, mesh, "data"), mesh,
                       batch_axis_name="data", **kw)
    assert xr.shape == (2, 512)
    for i in range(2):
        assert mad_rms(X[i], xr[i].numpy()) < 1e-12


def test_chunked_icwt_and_issq_match_jax_and_unsharded():
    from ssqueeze_rs_tpu.parallel import (chunked_icwt as j_icwt,
                                          chunked_issq_cwt as j_issq,
                                          chunked_issq_stft as j_issq_s)
    from ssqueeze_rs_tpu_torch import (cwt, icwt, issq_cwt, issq_stft,
                                       ssq_cwt, ssq_stft)
    from ssqueeze_rs_tpu_torch.parallel import (chunked_icwt,
                                                chunked_issq_cwt,
                                                chunked_issq_stft)
    mesh, jm = _mesh((1, 8)), _jmesh((1, 8))
    x = np.cos(2 * np.pi * 40 * np.arange(1024) / 1024) + \
        0.4 * np.random.default_rng(9).standard_normal(1024)
    xt = torch.as_tensor(x)
    Wx, _ = cwt(xt, WAV, scales="log", nv=16, **F64)
    got = chunked_icwt(Wx, mesh, wavelet=WAV, scales="log", nv=16)
    assert torch.equal(got, icwt(Wx, WAV, scales="log", nv=16))
    assert _rel(got, j_icwt(Wx.numpy(), jm, wavelet=WAV, scales="log",
                            nv=16)) < 1e-10
    with pytest.raises(NotImplementedError):
        chunked_icwt(Wx, mesh, wavelet=WAV, scales="log", nv=16,
                     one_int=False)
    Tx, *_ = ssq_cwt(xt[:512], WAV, scales="log", nv=16, **F64)
    got = chunked_issq_cwt(Tx, mesh, wavelet=WAV)
    assert torch.equal(got, issq_cwt(Tx, WAV))
    assert _rel(got, j_issq(Tx.numpy(), jm, wavelet=WAV)) < 1e-10
    Ts, *_ = ssq_stft(xt[:512], n_fft=64, **F64)
    got = chunked_issq_stft(Ts, mesh, n_fft=64)
    assert torch.equal(got, issq_stft(Ts, n_fft=64))
    assert _rel(got, j_issq_s(Ts.numpy(), jm, n_fft=64)) < 1e-10


def test_chunked_issq_component_inversion_matches_jax():
    from ssqueeze_rs_tpu.parallel import chunked_issq_cwt as j_issq
    from ssqueeze_rs_tpu_torch import issq_cwt, ssq_cwt
    from ssqueeze_rs_tpu_torch.parallel import chunked_issq_cwt
    from ssqueeze_rs_tpu_torch.toolkit import lin_band
    x = np.cos(2 * np.pi * 40 * np.arange(512) / 512) + \
        0.5 * np.random.default_rng(11).standard_normal(512)
    wav = ("gmw", {"beta": 6.0})
    Tx, *_ = ssq_cwt(torch.as_tensor(x), wav, scales="log:maximal", nv=16,
                     flipud=False, **F64)
    Cs, band = lin_band(Tx, 0.4, 0.4, 0.05)
    got = chunked_issq_cwt(Tx, _mesh((1, 8)), wavelet=wav, cc=Cs, cw=band)
    assert got.shape == (2, 512)
    assert torch.equal(got, issq_cwt(Tx, wav, Cs, band))
    gj = j_issq(Tx.numpy(), _jmesh((1, 8)), wavelet=wav, cc=np.asarray(Cs),
                cw=np.asarray(band))
    assert _rel(got, gj) < 1e-10


def test_chunked_errors():
    from ssqueeze_rs_tpu_torch.parallel import (chunked_istft,
                                                chunked_ssq_cwt, make_mesh)
    mesh = _mesh((1, 8))
    with pytest.raises(ValueError, match="hop_len \\* n_frames"):
        chunked_istft(torch.zeros(65, 128, dtype=torch.complex128), mesh,
                      n_fft=128, hop_len=2, N=255)
    with pytest.raises(ValueError, match="maximal"):
        chunked_ssq_cwt(np.zeros(1024), mesh, fs=1000.0, maprange="maximal")
    with pytest.raises(Exception):
        chunked_ssq_cwt(np.zeros(1024), mesh, fs=1000.0, squeezing="bogus")
    with pytest.raises(ValueError, match="divisible"):
        chunked_ssq_cwt(np.zeros(1001), mesh, fs=1000.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh((1, 1))


# -- comm_report, halo_extend ------------------------------------------------------
@pytest.mark.parametrize("transform, kw", [
    ("stft", dict(n_fft=512, hop_len=4)),
    ("ssq_stft", dict(n_fft=256)),
    ("istft", dict(n_fft=256, hop_len=4)),
    ("cwt", dict(scales="log", nv=8)),
    ("ssq_cwt", dict(scales="log", nv=8)),
    ("ssq_cwt", dict(scales="log", nv=8, exact=False)),
    ("cwt", dict(scales="log", nv=8, batch=3, dtype="float64")),
])
def test_comm_report_equals_jax(transform, kw):
    from ssqueeze_rs_tpu.parallel import comm_report as j_report
    from ssqueeze_rs_tpu_torch.parallel import comm_report
    assert comm_report(transform, 65536, 8, **kw) == \
        j_report(transform, 65536, 8, **kw)


@pytest.mark.parametrize("boundary", ["reflect", "zero"])
def test_halo_extend_ends(boundary):
    """Each shard gets its neighbours' edges; the globally first and last
    shards mirror their own samples (excluding the edge sample) or pad
    zeros, as the JAX halo_extend."""
    from ssqueeze_rs_tpu_torch.parallel.chunked import halo_extend
    from ssqueeze_rs_tpu_torch.parallel.mesh import PartitionSpec, Sharded
    from ssqueeze_rs_tpu_torch.parallel.mesh import block_of
    mesh = _mesh((2, 4))
    x = torch.arange(2 * 32, dtype=torch.float64).reshape(2, 32)
    spec = PartitionSpec("data", "time")
    xs = Sharded(mesh, spec, x.shape, {i: block_of(x, mesh, spec, i)
                                       for i in mesh.local()})
    Hl, Hr = 3, 2
    ext = halo_extend(xs, "time", 4, Hl, Hr, boundary)
    assert ext.shape == (2, 32 + 4 * (Hl + Hr))
    xp = np.pad(x.numpy(), ((0, 0), (Hl, Hr)),
                mode="reflect" if boundary == "reflect" else "constant")
    for (d, t), b in ext.blocks.items():
        want = xp[d:d + 1, t * 8:t * 8 + 8 + Hl + Hr]
        assert np.array_equal(b.numpy(), want), (d, t)
    with pytest.raises(ValueError, match="n_shards"):
        halo_extend(xs, "time", 8, Hl, Hr, boundary)


# -- the runtime helpers -----------------------------------------------------------
def test_distributed_helpers_single_process():
    from ssqueeze_rs_tpu_torch.parallel import (global_from_local, initialize,
                                                is_distributed,
                                                make_host_chip_mesh)
    from ssqueeze_rs_tpu_torch.parallel.mesh import PartitionSpec as P
    initialize()                       # no coordinator -> no-op
    assert not is_distributed()
    mesh = make_host_chip_mesh(device=["cpu"] * 8)
    assert mesh.devices.shape == (1, 8)
    assert mesh.axis_names == ("data", "time")
    mesh2 = make_host_chip_mesh(time_parallel=4, device=["cpu"] * 8)
    assert mesh2.devices.shape == (2, 4) and mesh2.shape == {"data": 2,
                                                              "time": 4}
    x = np.arange(32, dtype=np.float32).reshape(4, 8)
    gx = global_from_local(x, mesh2, P("data", None))
    assert gx.shape == (4, 8)
    for (d, t), b in gx.blocks.items():
        assert np.array_equal(b.numpy(), x[2 * d:2 * d + 2])
    with pytest.raises(ValueError):
        make_host_chip_mesh(time_parallel=3, device=["cpu"] * 8)


# -- two processes over gloo ----------------------------------------------------------
def _worker(rank, port):
    """One of two CPU processes, four mesh entries each, on a (1, 8) mesh
    (the halos, the hybrid CWT's signal all_gather and its rows'
    all_to_all and the results' assembly cross the process boundary) and
    on a (2, 4) one ('data' across the processes). Each result must equal
    the one-process run on eight entries."""
    sys.path.insert(0, REPO)
    from ssqueeze_rs_tpu_torch.parallel import (
        chunked_cwt, chunked_istft, chunked_issq_cwt, chunked_ssq_cwt,
        chunked_stft, global_from_local, initialize, is_distributed,
        make_host_chip_mesh, make_mesh)
    from ssqueeze_rs_tpu_torch.parallel.mesh import PartitionSpec as P
    from ssqueeze_rs_tpu_torch.parallel import chunked
    chunked.WARN = lambda msg: None
    torch.set_num_threads(1)
    initialize(coordinator_address=f"localhost:{port}", num_processes=2,
               process_id=rank)
    assert is_distributed()
    mesh = make_host_chip_mesh(time_parallel=8, device=["cpu"] * 4)
    assert mesh.devices.shape == (1, 8)
    assert mesh.ranks.tolist() == [[0, 0, 0, 0, 1, 1, 1, 1]]
    one = make_mesh((1, 8), devices=["cpu"] * 8)
    N = 2048
    x = (np.cos(2 * np.pi * 128 * np.arange(N) / N) +
         0.1 * np.random.default_rng(0).standard_normal(N))
    xg = global_from_local(x[rank * N // 2:(rank + 1) * N // 2], mesh,
                           P("time"))
    kw = dict(window="hann", n_fft=128, hop_len=4, dtype="float64")
    Sx = chunked_stft(xg, mesh, **kw)
    assert torch.equal(Sx, chunked_stft(x, one, **kw))
    xr = chunked_istft(Sx, mesh, window="hann", n_fft=128, hop_len=4, N=N)
    assert torch.equal(xr, chunked_istft(Sx, one, window="hann", n_fft=128,
                                         hop_len=4, N=N))
    ckw = dict(wavelet=("gmw", {"beta": 8.0}), scales="log", nv=16,
               dtype="float64")
    W2, sc = chunked_cwt(xg, mesh, **ckw)
    W1, _ = chunked_cwt(x, one, **ckw)
    assert torch.equal(W2, W1)
    Tx, Wx, *_ = chunked_ssq_cwt(xg, mesh, fs=float(N), **ckw)
    T1, _, *_ = chunked_ssq_cwt(x, one, fs=float(N), **ckw)
    assert torch.equal(Tx, T1) and torch.equal(Wx, W1)
    xs = chunked_issq_cwt(Tx, mesh, wavelet=ckw["wavelet"])
    assert torch.equal(xs, chunked_issq_cwt(T1, one, wavelet=ckw["wavelet"]))
    # the hybrid's global rows exist here, so its exchanges crossed over
    from ssqueeze_rs_tpu_torch.parallel import comm_report
    report = comm_report("ssq_cwt", N, 8, wavelet=ckw["wavelet"],
                         scales="log", nv=16)
    assert report["rows_global"] > 0 and report["rows_local"] > 0
    # a (2, 4) mesh with 'data' across the processes: a batch split over
    # it, and replicas (no batch axis) whose row 0 the other process gets
    mesh2 = make_host_chip_mesh(time_parallel=4, device=["cpu"] * 4)
    assert mesh2.ranks.tolist() == [[0] * 4, [1] * 4]
    one2 = make_mesh((2, 4), devices=["cpu"] * 8)
    X = np.random.default_rng(1).standard_normal((2, 1024))
    Xg = global_from_local(X[rank:rank + 1], mesh2, P("data", "time"))
    T2, *_ = chunked_ssq_cwt(Xg, mesh2, batch_axis_name="data", **ckw)
    T1, *_ = chunked_ssq_cwt(X, one2, batch_axis_name="data", **ckw)
    assert torch.equal(T2, T1)
    S2 = chunked_stft(X[0], mesh2, **kw)
    assert torch.equal(S2, chunked_stft(X[0], one2, **kw))
    print(f"worker {rank}: ALL PASS", flush=True)


def test_two_process_gloo_equals_one_process():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "worker", str(r), str(port)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs, deadline = [], time.monotonic() + 110
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-3000:]
        assert f"worker {r}: ALL PASS" in out


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]))
