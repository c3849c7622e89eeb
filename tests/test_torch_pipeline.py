"""The port's `parallel.process_recording` against the JAX package's
(`ssqueeze_rs_tpu.parallel.pipeline`) and its own offline transforms,
float32 on the CPU (tests/test_pipeline.py's contract): array, raw-file
(the native reader, with and without its prefetch ring) and parquet
sources, energy mode, one ssq frequency grid for a short final chunk, a
hop-misaligned chunk_len, the refusals. A file source reads the same
halo chunks as the array source, so its output is bitwise the array's.

Tolerances: STFT chunks against JAX's and against the offline transform
within 2e-5 of max|Sx| (the halo covers every frame, float32 sums in other
orders); ssq_cwt against JAX's process_recording bin-flip tolerant
(per-column sum_k |Tx| within 1e-3 of the largest); its ssq_freqs within
1e-6 relative (the JAX pipeline returns them through a float32 device
array); energy against the summed |output|^2 within 1e-5 relative (a
float32 sum over 1500 columns on one side, float64 on the other).
"""
import numpy as np
import pytest
import torch

from ssqueeze_rs_tpu.parallel.pipeline import process_recording as jax_pr
from ssqueeze_rs_tpu.io import ParquetRecording as JParquetRecording
import ssqueeze_rs_tpu_torch as T
from ssqueeze_rs_tpu_torch.parallel import (process_recording, process_stft,
                                            process_ssq_cwt)
from ssqueeze_rs_tpu_torch.utils.pad import _reflect_indices


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


def _col_rel(Tx, Tx_ref):
    c, c_ref = np.abs(Tx).sum(-2), np.abs(Tx_ref).sum(-2)
    return np.abs(c - c_ref).max() / c_ref.max()


def test_stft_from_array_and_raw_file(tmp_path):
    """Array chunks against the JAX pipeline and the offline stft; the
    same recording as a raw channel-major float32 file gives the same
    result."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8192)).astype(np.float32)
    kw = dict(transform="stft", fs=1000.0, chunk_len=2048, n_fft=256,
              hop_len=4, window="hann")
    out, meta = process_recording(x, device="cpu", **kw)
    ref, _ = jax_pr(x, **kw)
    off = T.stft(x, window="hann", n_fft=256, hop_len=4, device="cpu")
    assert out.shape == ref.shape == tuple(off.shape)
    assert _rel(out, ref) < 2e-5 and _rel(out, off.numpy()) < 2e-5
    assert np.array_equal(meta["freqs"], np.linspace(0, 500, 129))

    p = tmp_path / "rec.f32"
    x.tofile(p)
    got, _ = process_recording(p, n_channels=2, device="cpu", **kw)
    assert np.array_equal(got, out)
    with pytest.raises(ValueError, match="n_channels"):
        process_recording(p, device="cpu", **kw)
    with pytest.raises(ValueError, match="channels"):
        process_recording(p, n_channels=3, device="cpu", **kw)


def test_ssq_cwt_from_array_matches_jax():
    N = 4096
    t = np.linspace(0, 4, N, endpoint=False)
    x = np.cos(2 * np.pi * 50 * t).astype(np.float32)
    kw = dict(transform="ssq_cwt", fs=N / 4, chunk_len=2048, scales="log")
    out, meta = process_recording(x, device="cpu", **kw)
    ref, meta_j = jax_pr(x, **kw)
    assert out.shape == ref.shape and out.shape[-1] == N
    assert np.isfinite(out).all()
    assert _col_rel(out[0], ref[0]) < 1e-3
    assert np.allclose(meta["ssq_freqs"], meta_j["ssq_freqs"], rtol=1e-6,
                       atol=0)
    assert np.allclose(meta["scales"], meta_j["scales"], rtol=1e-6, atol=0)


def test_energy_mode():
    """out='energy' == the time-summed |full output|^2 per (channel, row),
    for the STFT and the ssq_cwt paths."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 4000)).astype(np.float32)
    for kw in (dict(transform="stft", n_fft=128),
               dict(transform="ssq_cwt", scales="log", nv=8)):
        kw.update(fs=1000.0, chunk_len=1500, device="cpu")
        full, _ = process_recording(x, **kw)
        en, _ = process_recording(x, out="energy", **kw)
        want = np.sum(np.abs(full.astype(np.complex128)) ** 2, axis=-1)
        assert en.shape == want.shape == full.shape[:2]
        assert np.allclose(en, want, rtol=1e-5, atol=0)


def test_short_final_chunk_single_grid_and_channel_batches(monkeypatch):
    """A shorter final chunk is binned on the same ssq frequency grid as
    the full chunks; splitting the channels into sub-batches (a tiny
    memory budget) changes nothing."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 2500)).astype(np.float32)  # 1000+1000+500
    kw = dict(transform="ssq_cwt", chunk_len=1000, halo=200, fs=100.0,
              device="cpu")
    r, m = process_recording(x, **kw)
    assert r.shape[-1] == 2500 and np.isfinite(r).all()
    fr = m["ssq_freqs"]
    assert (np.diff(fr) < 0).all() or (np.diff(fr) > 0).all()
    monkeypatch.setenv("SSQ_TPU_HBM_BUDGET_GB", "1e-9")
    r1, _ = process_recording(x, **kw)
    assert np.array_equal(r1, r)


def test_hop_misaligned_chunk_len_and_named_wrappers():
    """chunk_len not a multiple of hop_len reproduces the one-shot frame
    grid; the reference-named wrappers take (n_samples, n_channels)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6000)).astype(np.float32)
    ref = T.stft(x, n_fft=512, hop_len=256, fs=1000.0, device="cpu").numpy()
    out, _ = process_recording(x, transform="stft", fs=1000.0, n_fft=512,
                               hop_len=256, chunk_len=1000, device="cpu")
    assert out.shape == ref.shape and _rel(out, ref) < 2e-5

    S = process_stft(x.T, fs=1000.0, n_fft=128, hop_length=4,
                     chunk_len=1600, device="cpu")
    want = T.stft(x, window="hann", n_fft=128, hop_len=4, fs=1000.0,
                  device="cpu").numpy()
    assert _rel(np.transpose(S, (2, 0, 1)), want) < 2e-5
    Tx, fr = process_ssq_cwt(x.T[:3000], fs=1000.0, scales="log", nv=8,
                             chunk_len=2000, device="cpu")
    assert Tx.shape[1:] == (3000, 2) and len(fr) == Tx.shape[0]


def test_refusals_and_reflect_indices(monkeypatch):
    x = np.zeros((1, 1024), np.float32)
    with pytest.raises(ValueError, match="derivative"):
        process_recording(x, transform="cwt", derivative=True, device="cpu")
    # a parquet path goes to io.ParquetRecording (pyarrow) and is opened
    with pytest.raises(FileNotFoundError if T.io.have_pyarrow()
                       else ImportError):
        process_recording("missing.parquet", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        process_recording(x, transform="stft", n_fft=64)
    # halos wider than the recording reflect repeatedly, as np.pad does
    sig = np.arange(5)
    for lo, hi in ((-12, 17), (-3, 8), (0, 5)):
        padded = np.pad(sig, (max(0, -lo), max(0, hi - 5)), mode="reflect")
        want = padded[lo + max(0, -lo):hi + max(0, -lo)]
        assert np.array_equal(sig[_reflect_indices(lo, hi, 5)], want)


@pytest.mark.parametrize("transform, kw, bar", [
    ("stft", dict(n_fft=128, hop_len=2), "rel"),
    ("ssq_cwt", dict(scales="log", nv=8, halo=400), "col"),
    ("ssq_cwt", dict(scales="log", nv=8, halo=400, out="energy"), "en")])
def test_raw_file_and_parquet_sources(tmp_path, transform, kw, bar):
    """A raw file through the native reader, with the prefetch ring (depth
    2 and 3) and without, and a parquet file (by path, and as a
    ParquetRecording with columns chosen): bitwise the array source, and
    within this file's bars of the JAX pipeline on the same file (three
    tones in a little noise; their energy rows within 1e-3 of the
    largest)."""
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    t = np.arange(5000) / 1000.0
    x = (np.cos(2 * np.pi * np.array([[50.0], [120.0], [210.0]]) * t) +
         0.01 * np.random.default_rng(11).standard_normal((3, 5000))
         ).astype(np.float32)
    kw = dict(kw, transform=transform, fs=1000.0, chunk_len=1800,
              device="cpu")
    want, meta = process_recording(x, **kw)
    raw = tmp_path / "rec.f32"
    x.tofile(raw)
    for prefetch, depth in ((True, 3), (True, 2), (False, 3)):
        got, m = process_recording(raw, n_channels=3, prefetch=prefetch,
                                   prefetch_depth=depth, **kw)
        assert np.array_equal(got, want), (prefetch, depth)
        assert all(np.array_equal(m[k], meta[k]) for k in meta)
    path = tmp_path / "rec.parquet"
    pq.write_table(pa.table({f"ch{c}": x[c] for c in range(3)}), path,
                   row_group_size=700)
    got, _ = process_recording(str(path), **kw)
    assert np.array_equal(got, want)
    sub, _ = process_recording(x[[2, 0]], **kw)
    rec = T.io.ParquetRecording(path, columns=["ch2", "ch0"])
    assert np.array_equal(process_recording(rec, **kw)[0], sub)
    assert np.array_equal(
        process_recording(str(path), columns=["ch2", "ch0"], **kw)[0], sub)
    rec.close()

    jkw = {k: v for k, v in kw.items() if k != "device"}
    for src, extra in ((raw, dict(n_channels=3)),
                       (JParquetRecording(str(path)), {})):
        ref, _ = jax_pr(src, **jkw, **extra)
        assert ref.shape == want.shape
        if bar == "rel":
            assert _rel(want, ref) < 2e-5
        elif bar == "col":
            assert max(_col_rel(want[c], ref[c]) for c in range(3)) < 1e-3
        else:
            assert _rel(want, ref) < 1e-3
