"""The port's native host runtime (`ssqueeze_rs_tpu_torch.native`, the
library compiled from native/ssq_native.cpp into the port's _build/)
against the JAX package's (`ssqueeze_rs_tpu.native`, the same source built
by native/Makefile), on the CPU.

Tolerances: the reader, the prefetch ring, `reassign_cpu` and the TKEO run
the same C++ code with the same flags on both sides, so they are bitwise
equal; the reads are also bitwise the reflect gather of the array
(np.pad's rule, halos wider than the recording included). Without the
library, `reassign_cpu` takes the port's float64 `ops.ssqueeze.reassign`
and JAX's its jnp engine: within 1e-12 of max|Tx| (the JAX test's bar,
tests/test_native.py); the TKEO falls back to numpy's formulas in both,
bitwise.
"""
import numpy as np
import pytest
import torch

from ssqueeze_rs_tpu import native as J
from ssqueeze_rs_tpu import cwt as j_cwt
from ssqueeze_rs_tpu_torch import native as T
from ssqueeze_rs_tpu_torch.utils.pad import _reflect_indices


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """(path, data): 3 channels x 10 000 float32, channel-major."""
    data = np.random.default_rng(0).standard_normal((3, 10_000)).astype(
        np.float32)
    path = tmp_path_factory.mktemp("native") / "rec.f32"
    data.tofile(path)
    return path, data


def test_builds_into_the_port_build_dir():
    assert T.available() and J.available()
    path = T.library_path()
    assert path.startswith(T.BUILD_DIR) and T._load() is not None
    assert T.SOURCE.endswith("native/ssq_native.cpp")


@pytest.mark.parametrize("start, cl, hl, hr", [
    (1000, 500, 64, 64), (0, 500, 4, 0), (9500, 500, 0, 4),
    (0, 10_000, 25_000, 25_000), (9999, 1, 30_001, 12)])
def test_read_chunk_bitwise(recording, start, cl, hl, hr):
    """read_chunk: bitwise JAX's and the reflect gather of the array,
    with halos wider than the recording reflecting again and again."""
    path, data = recording
    with T.MappedRecording(path, n_channels=3) as rec, \
            J.MappedRecording(path, n_channels=3) as ref:
        assert rec.n_samples == ref.n_samples == data.shape[1]
        got = rec.read_chunk(start, cl, hl, hr)
        assert np.array_equal(got, ref.read_chunk(start, cl, hl, hr))
        idx = _reflect_indices(start - hl, start + cl + hr, data.shape[1])
        assert np.array_equal(got, data[:, idx])


@pytest.mark.parametrize("chunk_len, halo, depth", [
    (3000, 128, 3), (2000, 64, 2), (10_000, 4000, 4), (999, 20_000, 3)])
def test_iter_chunks_and_prefetch_bitwise(recording, chunk_len, halo, depth):
    """iter_chunks and the prefetch ring yield the same (start, chunk)
    sequence, the short last chunk included, bitwise JAX's."""
    path, _ = recording
    with T.MappedRecording(path, n_channels=3) as rec, \
            J.MappedRecording(path, n_channels=3) as ref:
        direct = list(rec.iter_chunks(chunk_len, halo))
        ring = list(rec.iter_chunks_prefetch(chunk_len, halo, depth=depth))
        ring_j = list(ref.iter_chunks_prefetch(chunk_len, halo, depth=depth))
    assert [s for s, _ in direct] == [s for s, _ in ring] == \
        [s for s, _ in ring_j] == list(range(0, 10_000, chunk_len))
    for (_, a), (_, b), (_, c) in zip(direct, ring, ring_j):
        assert np.array_equal(a, b) and np.array_equal(b, c)
    assert sum(c.shape[1] - 2 * halo for _, c in direct) == 10_000


def test_prefetch_stopped_early(recording):
    """Leaving the ring after one chunk stops its worker; the recording
    then closes and a new ring starts from the first chunk."""
    path, data = recording
    rec = T.MappedRecording(path, n_channels=3)
    it = rec.iter_chunks_prefetch(1000, 10, depth=3)
    start, chunk = next(it)
    it.close()
    again = next(rec.iter_chunks_prefetch(1000, 10))
    rec.close()
    assert start == again[0] == 0
    assert np.array_equal(chunk, again[1])
    assert np.array_equal(chunk[:, 10:], data[:, :1000 + 10])


def _planes():
    """Float64 Wx and dWx of a chirp (the JAX test's), with its bins."""
    N = 512
    t = np.linspace(0, 10, N, endpoint=False)
    x = np.cos(2 * np.pi * 3 * np.exp(t / 3))
    Wx, _, dWx = j_cwt(x, ("gmw", {"beta": 8.0}), scales="log", fs=N / 10,
                       derivative=True, dtype="float64")
    return np.array(Wx), np.array(dWx)


@pytest.mark.parametrize("mode, flipud, stft", [
    ("log", True, False), ("log-piecewise", False, False),
    ("lin", False, True)])
def test_reassign_cpu(monkeypatch, mode, flipud, stft):
    """reassign_cpu: bitwise JAX's (the same C++ loop); without the
    library, the port's float64 reassign within 1e-12 of max|Tx| of JAX's
    jnp route. Inputs as CPU tensors give the same Tx."""
    Wx, dWx = _planes()
    na = Wx.shape[0]
    if mode == "log-piecewise":
        ssq_freqs = np.concatenate([np.geomspace(0.05, 1.0, 60),
                                    np.geomspace(1.0, 25.0, 121)[1:]])
    elif mode == "log":
        ssq_freqs = np.geomspace(0.05, 25.0, 180)
    else:
        ssq_freqs = np.linspace(0.0, 25.0, 180)
    const = np.linspace(0.01, 0.03, na)
    Sfs = np.linspace(0.0, 25.0, na) if stft else None
    args = (ssq_freqs, const, 1e-8, mode, flipud, Sfs)
    out = T.reassign_cpu(Wx, dWx, *args)
    ref = J.reassign_cpu(Wx, dWx, *args)
    assert out.dtype == np.complex128 and out.shape == (180, Wx.shape[1])
    assert np.abs(ref).max() > 0
    assert np.array_equal(out, ref)
    assert np.array_equal(T.reassign_cpu(torch.as_tensor(Wx),
                                         torch.as_tensor(dWx), *args), out)

    monkeypatch.setattr(T, "_load", lambda build=True: None)
    monkeypatch.setattr(J, "_load", lambda build=True: None)
    deg = T.reassign_cpu(Wx, dWx, *args)
    deg_j = J.reassign_cpu(Wx, dWx, *args)
    assert deg.dtype == np.complex128
    assert np.abs(deg - deg_j).max() <= 1e-12 * np.abs(deg_j).max()
    assert np.abs(deg - out).max() <= 1e-12 * np.abs(out).max()


def test_tkeo(monkeypatch):
    """tkeo_cpu / tkeo_modified_cpu bitwise JAX's; without the library
    numpy's formulas, bitwise JAX's fallback; a 1-D signal is one
    channel."""
    x = np.random.default_rng(1).standard_normal((4, 1000)).astype(
        np.float32)
    for ours, theirs in ((T.tkeo_cpu, J.tkeo_cpu),
                         (T.tkeo_modified_cpu, J.tkeo_modified_cpu)):
        assert np.array_equal(ours(x), theirs(x))
        assert np.array_equal(ours(torch.as_tensor(x)), theirs(x))
        assert np.array_equal(ours(x[0]), theirs(x[0]))
    monkeypatch.setattr(T, "_load", lambda build=True: None)
    monkeypatch.setattr(J, "_load", lambda build=True: None)
    assert np.array_equal(T.tkeo_cpu(x), x[:, 1:-1] ** 2 - x[:, :-2] * x[:, 2:])
    assert np.array_equal(T.tkeo_cpu(x), J.tkeo_cpu(x))
    assert np.array_equal(T.tkeo_modified_cpu(x), J.tkeo_modified_cpu(x))


def test_refusals(monkeypatch, recording, tmp_path):
    """A tensor off the CPU raises; float64 recordings map but do not read
    chunks (as JAX's); a missing file raises; without the library the
    reader raises."""
    with pytest.raises(ValueError, match="CPU tensors"):
        T.tkeo_cpu(torch.empty((2, 8), device="meta"))
    path, _ = recording
    with T.MappedRecording(path, n_channels=3, dtype="float64") as rec:
        assert rec.n_samples == 5000
        with pytest.raises(NotImplementedError):
            rec.read_chunk(0, 10)
    with pytest.raises(OSError):
        T.MappedRecording(tmp_path / "missing.f32", n_channels=1)
    monkeypatch.setattr(T, "_load", lambda build=True: None)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        T.MappedRecording(path, n_channels=3)
