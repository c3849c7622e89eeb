"""TransformServer's fetch from a CUDA device: each output array is the
memory of a page-locked block, bitwise the pageable copy of the same
tensor, and a request whose earlier result was dropped reuses the pinned
pool's blocks. Needs an NVIDIA card (marker `cuda`); imports no JAX, so it
runs on the card with `python -m pytest --noconftest -p no:cacheprovider
-m cuda tests/test_torch_serve_cuda.py`.
"""
import numpy as np
import pytest
import torch

from ssqueeze_rs_tpu_torch import ssq_cwt, ssq_stft, trace
from ssqueeze_rs_tpu_torch.serve import TransformServer

pytestmark = pytest.mark.cuda

FETCH = ("serve.fetch_bytes", "serve.fetch_pinned", "serve.fetch_pinned_new")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fetch into page-locked "
                    "memory runs only from a CUDA device")
    return torch.device("cuda")


def _direct(transform, xp, card):
    x = torch.as_tensor(xp[None], device=card)
    if transform == "ssq_cwt":
        Tx, Wx, *_ = ssq_cwt(x, "gmw", fs=100.0, dtype="float32")
        return {"Tx": Tx, "Wx": Wx}
    Tx, Sx, *_ = ssq_stft(x, n_fft=64, fs=100.0, dtype="float32")
    return {"Tx": Tx, "Sx": Sx}


@pytest.mark.parametrize("transform", ["ssq_cwt", "ssq_stft"])
def test_served_arrays_are_pinned_and_bitwise_pageable(card, transform):
    kw = dict(fs=100.0) if transform == "ssq_cwt" else dict(n_fft=64,
                                                            fs=100.0)
    srv = TransformServer(transform, buckets=(2048,), device=card, **kw)
    x = np.random.default_rng(0).standard_normal(1500).astype(np.float32)
    out = srv(x)
    xp = np.pad(x, (0, 548), mode="reflect")
    for k, v in _direct(transform, xp, card).items():
        assert torch.from_numpy(out[k]).is_pinned(), k
        assert np.array_equal(out[k], v[0, ..., :1500].cpu().numpy()), k
    for got in srv.batch([x, x[:1000]]):
        for k in got:
            if k in ("Tx", "Wx", "Sx"):
                assert torch.from_numpy(got[k]).is_pinned(), k


def test_a_request_after_a_dropped_result_reuses_the_pool(card):
    srv = TransformServer("ssq_cwt", buckets=(2048,), fs=100.0, device=card)
    rng = np.random.default_rng(1)
    x1, x2 = (rng.standard_normal(2000).astype(np.float32) for _ in "ab")
    first = srv(x1)
    kept = first["Tx"].copy()
    second = srv(x2)                    # the first result is still held
    assert np.array_equal(first["Tx"], kept)
    assert not np.shares_memory(first["Tx"], second["Tx"])
    del first, second
    allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    before = {k: trace.COUNTS[k] for k in FETCH}
    third = srv(x1)
    moved = {k: trace.COUNTS[k] - before[k] for k in FETCH}
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == allocs
    assert moved == {"serve.fetch_bytes": third["Tx"].nbytes
                     + third["Wx"].nbytes, "serve.fetch_pinned": 2,
                     "serve.fetch_pinned_new": 0}
    assert np.array_equal(third["Tx"], kept)
