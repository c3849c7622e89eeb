"""The port's streaming transforms against the JAX package's
(`ssqueeze_rs_tpu.streaming`), float32 on the CPU: the same seeded numpy
signal, fed in the same ragged chunks to both, and against the port's own
offline transforms (tests/test_streaming.py's contract).

Tolerances:
  STFT columns     max|d| < 5e-6 of max|Sx| (both float32; the columns
                   are exact copies of the offline ones, the packages sum
                   the frame products in other orders)
  SSQ-STFT Tx      bin-flip tolerant, as tests/test_torch_ssq_stft.py:
                   per-column sum_k |Tx| within 1e-3 of the largest
  CWT              rows whose kernel tail mass beyond the halo is < 1e-6,
                   interior columns: within 1e-5 of max|Wx|
  SSQ-CWT          the 100 Hz tone's peak row within 5 %
  host planning    latency_samples, halo exactly; row_tail_mass and
                   ssq_freqs within 1e-12 relative (both host float64)
"""
import numpy as np
import pytest
import torch

import ssqueeze_rs_tpu.streaming as J
import ssqueeze_rs_tpu_torch as T
from ssqueeze_rs_tpu_torch.trace import COUNTS

FS = 1000.0


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _chirp(N, seed=0):
    t = np.arange(N) / FS
    rng = np.random.default_rng(seed)
    x = (np.cos(2 * np.pi * (20 + 80 * t) * t)
         + 0.5 * np.sin(2 * np.pi * 140 * t)
         + 0.01 * rng.standard_normal(N))
    return x.astype(np.float32)


def _stream(s, x, sizes):
    """Feed `x` in ragged chunks of the given sizes (cycled), collect."""
    outs, i, k = [], 0, 0
    while i < x.shape[-1]:
        n = sizes[k % len(sizes)]
        outs.append(s.feed(x[..., i:i + n]))
        i += n
        k += 1
    outs.append(s.flush())
    if isinstance(outs[0], tuple):
        return tuple(np.concatenate(p, axis=-1) for p in zip(*outs))
    return np.concatenate(outs, axis=-1)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


def _col_rel(Tx, Tx_ref):
    c, c_ref = np.abs(Tx).sum(-2), np.abs(Tx_ref).sum(-2)
    return np.abs(c - c_ref).max() / c_ref.max()


@pytest.mark.parametrize("hop,n_fft", [(1, 64), (4, 128), (16, 256)])
def test_streaming_stft_matches_jax_and_offline(hop, n_fft):
    x = _chirp(3000)
    kw = dict(block=512, n_fft=n_fft, hop_len=hop)
    sizes = [173, 512, 64, 1000]
    got = _stream(T.StreamingSTFT(**kw, device="cpu"), x, sizes)
    ref = _stream(J.StreamingSTFT(**kw), x, sizes)
    off = T.stft(x, n_fft=n_fft, hop_len=hop, device="cpu").numpy()
    assert got.shape == ref.shape == off.shape
    assert _rel(got, ref) < 5e-6 and _rel(got, off) < 5e-6


def test_streaming_stft_derivative_reset_and_edges():
    """dSx streams too; reset() restarts the stream; streams shorter than
    a block, and than the right pad, match offline (flush makes both
    reflect pads)."""
    x = _chirp(1500, seed=1)
    s = T.StreamingSTFT(block=256, n_fft=128, derivative=True, device="cpu")
    S, dS = _stream(s, x, sizes=[256])
    S_ref, dS_ref = _stream(J.StreamingSTFT(block=256, n_fft=128,
                                            derivative=True), x, [256])
    assert _rel(S, S_ref) < 5e-6 and _rel(dS, dS_ref) < 5e-6
    s.reset()
    S2, _ = _stream(s, x, sizes=[499, 3])
    assert np.array_equal(S2, S)
    with pytest.raises(RuntimeError, match="flushed"):
        s.feed(x[:10])
    for n, n_fft in ((200, 64), (50, 256)):
        xs = _chirp(n, seed=2)
        got = _stream(T.StreamingSTFT(block=512, n_fft=n_fft, device="cpu"),
                      xs, [n])
        off = T.stft(xs, n_fft=n_fft, device="cpu").numpy()
        assert got.shape == off.shape and _rel(got, off) < 5e-6


def test_streaming_ssq_stft_matches_jax_and_offline(monkeypatch):
    """Tx and Sx against the JAX streamer and the port's offline ssq_stft;
    the row grids and latency equal the JAX ones; under
    SSQ_TPU_REASSIGN_IMPL=mxu the same (plain I on the CPU)."""
    x = _chirp(2048)
    kw = dict(block=512, n_fft=128, fs=FS)
    s = T.StreamingSSQSTFT(**kw, device="cpu")
    j = J.StreamingSSQSTFT(**kw)
    Tx, Sx = _stream(s, x, [300, 512, 100])
    Tx_j, Sx_j = _stream(j, x, [300, 512, 100])
    Tx_o, Sx_o, fr_o, _ = T.ssq_stft(x, n_fft=128, fs=FS, device="cpu")
    assert Tx.shape == Tx_j.shape == tuple(Tx_o.shape)
    assert _rel(Sx, Sx_j) < 5e-6 and _rel(Sx, Sx_o.numpy()) < 5e-6
    assert _col_rel(Tx, Tx_j) < 1e-3 and _col_rel(Tx, Tx_o.numpy()) < 1e-3
    assert np.allclose(s.ssq_freqs, j.ssq_freqs, rtol=1e-12, atol=0)
    assert np.allclose(s.ssq_freqs, fr_o, rtol=1e-12, atol=0)
    assert s.latency_samples == j.latency_samples == (128 - 1) // 2
    monkeypatch.setenv("SSQ_TPU_REASSIGN_IMPL", "mxu")
    Tx_m, _ = _stream(T.StreamingSSQSTFT(**kw, device="cpu"), x,
                      [300, 512, 100])
    assert np.abs(Tx_m - Tx).sum() / np.abs(Tx).sum() < 2e-5


@pytest.mark.parametrize("sq", ["lebesgue", "abs"])
def test_streaming_squeezing_modes_match_jax(sq):
    x = _chirp(1024, seed=9)
    kw = dict(block=256, n_fft=128, fs=FS, squeezing=sq)
    Tx, _ = _stream(T.StreamingSSQSTFT(**kw, device="cpu"), x, [256])
    Tx_j, _ = _stream(J.StreamingSSQSTFT(**kw), x, [256])
    assert _col_rel(Tx, Tx_j) < 1e-3
    with pytest.raises(ValueError):
        T.StreamingSSQSTFT(block=256, n_fft=128, squeezing="bogus",
                           device="cpu")


def test_streaming_cwt_interior_and_planning():
    """Interior streamed CWT columns of the rows whose kernel fits the
    halo match the offline transform and the JAX streamer; the host
    planning (scales, halo, tail mass) equals the JAX streamer's."""
    N = 4096
    x = _chirp(N, seed=3)
    kw = dict(block=1024, fs=FS, nv=16, plan_N=N, halo=448)
    s = T.StreamingCWT(**kw, device="cpu")
    j = J.StreamingCWT(**kw)
    got = _stream(s, x, [1024])
    ref = _stream(j, x, [1024])
    off, scales = T.cwt(x, fs=FS, nv=16, device="cpu")
    off = off.numpy()
    assert got.shape == ref.shape == off.shape
    assert np.allclose(s.scales, scales, rtol=1e-12, atol=0)
    assert (s.halo, s.latency_samples) == (j.halo, j.latency_samples)
    assert np.allclose(s.row_tail_mass, j.row_tail_mass, rtol=1e-12,
                       atol=1e-300)
    tight = s.row_tail_mass < 1e-6
    assert tight.sum() > 0.25 * len(tight)
    inner = slice(s.halo, N - s.halo)
    for other in (ref, off):
        d = np.abs(got[tight][:, inner] - other[tight][:, inner]).max()
        assert d / np.abs(other).max() < 1e-5


def test_streaming_ssq_cwt_peak_and_grids():
    """The 100 Hz tone peaks within 5 %; ssq_freqs match the JAX streamer
    and offline ssq_cwt for both flipud values."""
    N = 2048
    x = np.cos(2 * np.pi * 100.0 * np.arange(N) / FS).astype(np.float32)
    for flipud in (True, False):
        kw = dict(block=512, fs=FS, nv=16, plan_N=N, halo=256, flipud=flipud)
        s = T.StreamingSSQCWT(**kw, device="cpu")
        j = J.StreamingSSQCWT(**kw)
        _, _, fr_o, _ = T.ssq_cwt(x, fs=FS, nv=16, flipud=flipud,
                                  device="cpu")
        assert np.allclose(s.ssq_freqs, j.ssq_freqs, rtol=1e-12, atol=0)
        assert np.allclose(s.ssq_freqs, fr_o, rtol=1e-12, atol=0)
    s = T.StreamingSSQCWT(block=512, fs=FS, nv=16, plan_N=N, halo=256,
                          device="cpu")
    Tx, Wx = _stream(s, x, [512])
    assert Tx.shape[-1] == N and Wx.shape[-1] == N
    inner = slice(s.halo, N - s.halo)
    f_peak = s.ssq_freqs[np.argmax(np.abs(Tx[:, inner]).sum(axis=1))]
    assert abs(f_peak - 100.0) / 100.0 < 0.05


@pytest.mark.parametrize("squeezing", ["sum", "lebesgue", "abs"])
@pytest.mark.parametrize("flipud", [True, False])
def test_streaming_ssq_cwt_tx_matches_jax(flipud, squeezing):
    """StreamingSSQCWT's Tx and Wx against the JAX streamer's on the same
    chunks: Tx within the bin-flip bar (sum |d| / sum |Tx_jax| < 5e-3),
    Wx within 1e-5 of max|Wx|."""
    N = 2048
    x = _chirp(N, seed=5)
    kw = dict(block=512, fs=FS, nv=16, plan_N=N, halo=256, flipud=flipud,
              squeezing=squeezing)
    Tx, Wx = _stream(T.StreamingSSQCWT(**kw, device="cpu"), x, [512, 300])
    Tx_j, Wx_j = _stream(J.StreamingSSQCWT(**kw), x, [512, 300])
    assert Tx.shape == Tx_j.shape and Wx.shape == Wx_j.shape
    assert Tx.shape[-1] == N
    assert np.abs(Tx - Tx_j).sum() / np.abs(Tx_j).sum() < 5e-3
    assert _rel(Wx, Wx_j) < 1e-5


def test_streaming_multichannel_and_device_rule(monkeypatch):
    """(channels, time) feeds stream exactly; an empty feed keeps the
    channel dims; a changed channel shape raises; with no CUDA device and
    no `device`, a streamer refuses to start."""
    C, N = 3, 1200
    x = np.random.default_rng(7).standard_normal((C, N)).astype(np.float32)
    s = T.StreamingSTFT(block=256, n_fft=64, device="cpu")
    small = s.feed(x[:, :10])
    assert small.shape == (C, 33, 0)
    got = np.concatenate([small, _stream(s, x[:, 10:], [256, 100])], axis=-1)
    off = T.stft(x, n_fft=64, device="cpu").numpy()
    assert got.shape == off.shape and _rel(got, off) < 5e-6
    s.reset()
    s.feed(x[:, :10])
    with pytest.raises(ValueError, match="channel shape changed"):
        s.feed(x[:2, :10])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls, kw in ((T.StreamingSTFT, dict(n_fft=64)),
                    (T.StreamingSSQCWT, dict(nv=8))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(block=256, **kw)


def test_streaming_ssq_cwt_launches_nothing_on_cpu():
    """A CPU streamer runs the plain versions: no kernel launch counted."""
    keys = ("launch.ssq_reassign4", "launch.ssq_reassign_mxu")
    before = [COUNTS[k] for k in keys]
    s = T.StreamingSSQCWT(block=256, fs=FS, nv=8, plan_N=1024, halo=128,
                          device="cpu")
    Tx, Wx = _stream(s, _chirp(700), [300])
    assert Tx.shape[-1] == Wx.shape[-1] == 700
    assert np.isfinite(Tx).all()
    assert [COUNTS[k] for k in keys] == before


def test_streaming_stft_geometry_sweep():
    """Bookkeeping fuzz: n_fft parity x hop x block x ragged feeds x
    stream lengths reproduce the JAX streamer's columns."""
    rng = np.random.default_rng(42)
    for trial in range(6):
        hop = int(rng.choice([1, 2, 3, 5, 8]))
        n_fft = int(rng.choice([32, 63, 64, 129, 200]))
        block = hop * int(rng.integers(8, 64))
        N = int(rng.integers(1, 2000))
        x = rng.standard_normal(N).astype(np.float32)
        sizes = [int(rng.integers(1, max(2, 2 * block))) for _ in range(4)]
        kw = dict(block=block, n_fft=n_fft, hop_len=hop)
        got = _stream(T.StreamingSTFT(**kw, device="cpu"), x, sizes)
        ref = _stream(J.StreamingSTFT(**kw), x, sizes)
        assert got.shape == ref.shape, (trial, hop, n_fft, block, N)
        assert _rel(got, ref) < 5e-6, (trial, hop, n_fft, block, N)
