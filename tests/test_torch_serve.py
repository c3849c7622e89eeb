"""The port's `TransformServer` against the JAX package's
(`ssqueeze_rs_tpu.serve`) and its own direct transforms, float32 on the
CPU (tests/test_serve.py's contract): bucket reuse, trimming, exact
column counts for hop > 1, batching, metadata, the rpadded guard.

Tolerances: a served request against the port's direct transform of the
same padded signal: equal (the same code on the same input); against the
JAX server: Wx within 1e-5 of max|Wx| (float32 transforms summed in other
orders), Tx bin-flip tolerant (per-column sum_k |Tx| within 1e-3 of the
largest, tests/test_torch_ssq_cwt.py's bar); batch() against single
requests within 1e-6 of max|Tx|.
"""
import numpy as np
import pytest
import torch

from ssqueeze_rs_tpu.serve import TransformServer as JServer
import ssqueeze_rs_tpu_torch as T
from ssqueeze_rs_tpu_torch.serve import TransformServer, DEFAULT_BUCKETS


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _col_rel(Tx, Tx_ref):
    c, c_ref = np.abs(Tx).sum(-2), np.abs(Tx_ref).sum(-2)
    return np.abs(c - c_ref).max() / c_ref.max()


def test_bucket_reuse_and_correctness():
    srv = TransformServer("ssq_cwt", buckets=(512, 1024), fs=100.0,
                          device="cpu")
    rng = np.random.default_rng(0)
    x1 = rng.standard_normal(300).astype(np.float32)
    x2 = rng.standard_normal(450).astype(np.float32)   # same bucket (512)
    o1, o2 = srv(x1), srv(x2)
    assert srv.n_compiled == 1
    assert o1["Tx"].shape[-1] == 300 and o2["Tx"].shape[-1] == 450
    xp = np.pad(x1[None], ((0, 0), (0, 212)), mode="reflect")
    Tx_ref, Wx_ref, *_ = T.ssq_cwt(xp, "gmw", fs=100.0, device="cpu")
    assert np.array_equal(o1["Tx"], Tx_ref.numpy()[0, :, :300])
    j1 = JServer("ssq_cwt", buckets=(512, 1024), fs=100.0)(x1)
    assert np.abs(o1["Wx"] - j1["Wx"]).max() < 1e-5 * np.abs(j1["Wx"]).max()
    assert _col_rel(o1["Tx"], j1["Tx"]) < 1e-3
    assert np.array_equal(o1["scales"], j1["scales"])

    assert srv(rng.standard_normal(700))["Tx"].shape[-1] == 700
    assert srv.n_compiled == 2
    with pytest.raises(ValueError, match="largest bucket"):
        srv(rng.standard_normal(5000))
    assert DEFAULT_BUCKETS == JServer("stft").buckets


def test_server_stft_channels_and_warmup():
    srv = TransformServer("stft", buckets=(512,), n_fft=64, hop_len=4,
                          device="cpu")
    x = np.random.default_rng(1).standard_normal((3, 333))
    out = srv(x)
    j = JServer("stft", buckets=(512,), n_fft=64, hop_len=4)(x)
    assert out["Sx"].shape == j["Sx"].shape == (3, 33, 84)
    assert np.abs(out["Sx"] - j["Sx"]).max() < 5e-6 * np.abs(j["Sx"]).max()
    srv(np.random.default_rng(2).standard_normal((3, 500)))
    assert srv.n_compiled == 1

    cw = TransformServer("cwt", buckets=(256, 512), device="cpu")
    cw.warmup(channels=(1, 2))
    assert cw.n_compiled == 4
    out = cw(np.random.default_rng(3).standard_normal(200))
    assert cw.n_compiled == 4 and out["Wx"].shape[-1] == 200


def test_server_hop_exact_column_count():
    """The served STFT has the direct transform's column count for hop > 1
    even where hop does not divide the bucket."""
    srv = TransformServer("stft", buckets=(512,), n_fft=64, hop_len=3,
                          device="cpu")
    for N in (510, 511, 512, 333, 100):
        x = np.random.default_rng(N).standard_normal(N)
        direct = T.stft(x, n_fft=64, hop_len=3, device="cpu")
        assert srv(x)["Sx"].shape[-1] == direct.shape[-1], N


def test_server_batch_equals_singles():
    """batch(): one call for many requests (their count rounded up to a
    power of 2); each request's outputs equal its single serving."""
    srv = TransformServer("ssq_cwt", buckets=(2048,), fs=500.0,
                          wavelet=("gmw", {"beta": 8.0}), device="cpu")
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal(n).astype(np.float32)
          for n in (2048, 1500, 2000)]
    outs = srv.batch(xs)
    assert len(outs) == 3 and (4, 2048) in srv._shapes
    for x, got in zip(xs, outs):
        one = srv(x)
        assert got["Tx"].shape == one["Tx"].shape == (one["Tx"].shape[0],
                                                       len(x))
        top = np.abs(one["Tx"]).max()
        assert np.abs(got["Tx"] - one["Tx"]).max() <= 1e-6 * top
        assert np.array_equal(got["ssq_freqs"], one["ssq_freqs"])
    with pytest.raises(ValueError, match="1D requests"):
        srv.batch([rng.standard_normal((2, 100))])
    assert srv.batch([]) == []


def test_server_metadata_and_guards(monkeypatch):
    """scales / ssq_freqs are the host float64 planning values of the
    bucket; rpadded=True is refused; with no CUDA device and no `device`
    the server refuses to start."""
    srv = TransformServer("ssq_cwt", buckets=(1024,), fs=1000.0, nv=16,
                          device="cpu")
    x = np.random.default_rng(0).standard_normal(1000)
    out = srv(x)
    assert out["scales"].dtype == np.float64
    assert out["ssq_freqs"].dtype == np.float64
    _, _, fr, sc = T.ssq_cwt(np.pad(x, (0, 24), mode="reflect"), fs=1000.0,
                             nv=16, device="cpu")
    assert np.array_equal(out["scales"], sc)
    assert np.array_equal(out["ssq_freqs"], fr)
    st = TransformServer("ssq_stft", buckets=(1024,), n_fft=128, fs=1000.0,
                         device="cpu")(x)
    assert st["Tx"].shape == (65, 1000) and st["Sfs"].shape == (65,)
    with pytest.raises(ValueError, match="rpadded"):
        TransformServer("cwt", rpadded=True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformServer("cwt")
