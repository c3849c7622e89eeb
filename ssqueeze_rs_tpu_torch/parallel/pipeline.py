"""Out-of-core long-recording pipeline (counterpart of
``ssqueeze_rs_tpu/parallel/pipeline.py``): a multichannel recording is
read in halo-overlapped chunks, each chunk's channels are transformed
together on the device (in sub-batches that fit the memory budget), the
halos are trimmed, and the chunks' outputs are joined along time.

Sources: a raw channel-major float32 file, read through the native
memory-mapped reader (`native.MappedRecording`), with its C++ prefetch
ring reading the next chunks while the device works on this one
(`prefetch`); a parquet file or `io.ParquetRecording`; or a
(n_channels, n_samples) array.
"""
from __future__ import annotations

import os
from contextlib import closing

import numpy as np
import torch

from ..utils.common import array_device, assert_is_one_of, WARN
from ..utils.pad import p2up, _reflect_indices

__all__ = ["process_recording", "process_stft", "process_cwt",
           "process_ssq_cwt", "process_ssq_stft"]


def _chunk_iter_array(x, chunk_len, halo):
    """(start, chunk length, reflect-padded halo chunk) over a (C, N)
    array (or memmap: only each chunk's samples are read)."""
    C, N = x.shape
    start = 0
    while start < N:
        cl = min(chunk_len, N - start)
        idx = _reflect_indices(start - halo, start + cl + halo, N)
        yield start, cl, x[:, idx]
        start += chunk_len


def _raw_recording(path, n_channels):
    """A raw channel-major float32 file as a `native.MappedRecording`;
    a file whose samples do not split into `n_channels` raises."""
    from ..native import MappedRecording
    if n_channels is None:
        raise ValueError("n_channels required for file sources")
    size = os.path.getsize(path) // 4
    if size % n_channels:
        raise ValueError(f"{path}: {size} float32 samples do not split "
                         f"into {n_channels} channels")
    return MappedRecording(path, n_channels=n_channels, dtype="float32")


def process_recording(source, transform="ssq_cwt", fs=1.0, n_channels=None,
                      chunk_len=1_000_000, halo=None, hop_len=1, n_fft=None,
                      window=None, wavelet="gmw", scales="log-piecewise",
                      nv=32, dtype="float32", out="numpy", prefetch=True,
                      prefetch_depth=3, columns=None, device=None, **kw):
    """Stream a long multichannel recording through a TF transform.

    `source`: the path of a raw channel-major float32 file (`n_channels`
    required), read by the native reader, through its prefetch ring of
    `prefetch_depth` chunks when `prefetch`; a `.parquet`/`.pq` path or
    an `io.ParquetRecording` (`columns` selects the channel columns); or
    a (n_channels, n_samples) array. `device`: where the transforms run
    (the CUDA device by default, `utils.common.array_device`).

    `out`: 'numpy' (default) returns the full TF array; 'energy' reduces
    each chunk on the device to the per-(channel, row) energy
    sum_t |out|^2 and returns their sum, a (C, n_rows) spectral summary.

    Returns (result, meta): result (C, n_rows, ~N/hop) joined along time
    ('numpy') or (C, n_rows) ('energy'); meta holds frequencies/scales.
    """
    assert_is_one_of(out, "out", ("numpy", "energy"))
    assert_is_one_of(transform, "transform", ("stft", "cwt", "ssq_cwt",
                                              "ssq_stft"))
    from ..ops.stft import stft
    from ..ops.cwt import cwt
    from ..ops.ssq_cwt import ssq_cwt
    from ..ops.ssq_stft import ssq_stft
    from ..scales import process_scales
    from ..wavelets.base import Wavelet
    from ..io import ParquetRecording

    is_path = (isinstance(source, (str, bytes)) or
               hasattr(source, "__fspath__"))
    x = rec = None
    if isinstance(source, ParquetRecording) or (
            is_path and os.fspath(source).endswith((".parquet", ".pq"))):
        rec = (source if isinstance(source, ParquetRecording) else
               ParquetRecording(source, columns=columns))
    elif is_path:
        rec = _raw_recording(source, n_channels)
    else:
        x = np.atleast_2d(np.asarray(source))
    N = x.shape[-1] if rec is None else rec.n_samples
    dev = array_device(device)

    # halo: n_fft for the STFT paths, the wavelet's support for the CWT
    if transform in ("stft", "ssq_stft"):
        n_fft_eff = int(n_fft or 512)
        halo_eff = int(halo if halo is not None else n_fft_eff)
        # the global frame grid stays aligned only if the halo and the
        # chunk starts sit on hop multiples: the halo rounds up, chunk_len
        # snaps down to the hop grid
        halo_eff = -(-halo_eff // hop_len) * hop_len
        if chunk_len % hop_len:
            chunk_len = max((chunk_len // hop_len) * hop_len, hop_len)
    else:
        ext_guess = min(chunk_len, N)
        wav = Wavelet.build(wavelet, l1_norm=kw.get("l1_norm", True))
        scales_arr = process_scales(scales, ext_guess, wav, nv=nv)
        if halo is None:
            from .chunked import default_cwt_halo
            halo_eff = default_cwt_halo(wav, float(scales_arr.max()))
            if halo_eff > chunk_len // 2:
                # the largest scales' support exceeds the chunk: cap, as
                # the reference's dask scripts use a fixed overlap
                WARN(f"CWT halo for the largest scale ({halo_eff} samples) "
                     f"exceeds chunk_len/2; capping to {chunk_len // 2} — "
                     "large-scale rows are approximate near chunk edges "
                     "(pass `halo=` or raise `chunk_len` to control)")
                halo_eff = chunk_len // 2
        else:
            halo_eff = int(halo)

    # channel sub-batching: one chunk's transform holds ~20 arrays of
    # (rows, padded length) per channel on the device; split the channels
    # so a group fits the budget (SSQ_TPU_HBM_BUDGET_GB, default 8)
    budget = float(os.environ.get("SSQ_TPU_HBM_BUDGET_GB", "8")) * 1e9
    ext_max = min(chunk_len, N) + 2 * halo_eff
    if transform in ("stft", "ssq_stft"):
        rows = n_fft_eff // 2 + 1
        per_chan = 16 * rows * (ext_max // hop_len) * 4
    else:
        rows = len(scales_arr)
        per_chan = 20 * rows * p2up(ext_max)[0] * 4
    cbatch = max(1, int(budget // max(per_chan, 1)))

    Hl = halo_eff
    meta = {}
    if transform == "stft":
        lo = Hl // hop_len

        def tfn(ch, cl):
            S = stft(ch, window=window, n_fft=n_fft_eff, hop_len=hop_len,
                     fs=fs, dtype=dtype, **kw)
            return S[..., lo:lo + (cl - 1) // hop_len + 1]
        meta["freqs"] = np.linspace(0, fs / 2, n_fft_eff // 2 + 1)
    elif transform == "ssq_stft":
        lo = Hl // hop_len

        def tfn(ch, cl):
            Tx, _, ssq_freqs, _ = ssq_stft(
                ch, window=window, n_fft=n_fft_eff, hop_len=hop_len, fs=fs,
                dtype=dtype, **kw)
            meta["ssq_freqs"] = np.asarray(ssq_freqs)
            return Tx[..., lo:lo + (cl - 1) // hop_len + 1]
    elif transform == "cwt":
        if kw.get("derivative"):
            raise ValueError("process_recording(transform='cwt') does not "
                             "stream the derivative; call ops.cwt per "
                             "chunk for dWx")

        def tfn(ch, cl):
            Wx, sc = cwt(ch, wavelet, scales=scales_arr, fs=fs, nv=None,
                         dtype=dtype, **kw)
            meta["scales"] = np.asarray(sc)
            return Wx[..., Hl:Hl + cl]
    else:  # ssq_cwt
        # one ssq frequency grid for every chunk, planned from the
        # full-chunk extent: a shorter final chunk would otherwise be
        # binned on another grid than the rest
        from ..ops.ssqueeze import compute_associated_frequencies
        from ..scales import process_fs_and_t
        dt_g = process_fs_and_t(fs, None, ext_max)[0]
        _, scaletype_g, *_ = process_scales(scales_arr, ext_max, wav,
                                            get_params=True)
        ssq_freqs_g = compute_associated_frequencies(
            scales_arr, ext_max, wav, scaletype_g,
            kw.get("maprange", "peak"), True, dt_g, "cwt")

        def tfn(ch, cl):
            Tx, _, ssq_freqs, sc = ssq_cwt(ch, wavelet, scales=scales_arr,
                                           fs=fs, nv=None, dtype=dtype,
                                           ssq_freqs=ssq_freqs_g, **kw)
            meta["ssq_freqs"] = np.asarray(ssq_freqs)
            meta["scales"] = np.asarray(sc)
            return Tx[..., Hl:Hl + cl]

    def run(chunk, cl):
        """One chunk's channels, in sub-batches: energy or the output."""
        parts = []
        for c0 in range(0, chunk.shape[0], cbatch):
            ch = torch.as_tensor(np.ascontiguousarray(chunk[c0:c0 + cbatch],
                                                      dtype), device=dev)
            o = tfn(ch, cl)
            if out == "energy":
                o = (o.real * o.real + o.imag * o.imag).sum(-1)
            parts.append(o.cpu().numpy())
        return np.concatenate(parts, axis=0)

    def chunks():
        """(start, chunk length, halo chunk) from the source; the reader's
        generator is closed (the prefetch ring stopped) before the
        recording it reads is."""
        if rec is None:
            yield from _chunk_iter_array(x, chunk_len, halo_eff)
            return
        it = (rec.iter_chunks_prefetch(chunk_len, halo_eff,
                                       depth=prefetch_depth)
              if prefetch and not isinstance(rec, ParquetRecording)
              else rec.iter_chunks(chunk_len, halo_eff))
        with closing(it):
            for start, chunk in it:
                yield start, chunk.shape[-1] - 2 * halo_eff, chunk

    try:
        with closing(chunks()) as it:
            outs = [run(chunk, cl) for _, cl, chunk in it]
    finally:
        if rec is not None and rec is not source:
            rec.close()
    if out == "energy":
        return np.sum(np.stack(outs), axis=0), meta
    return np.concatenate(outs, axis=-1), meta


# -- the reference's orchestration names -----------------------------------------
# The reference ships its out-of-core path as dask scripts named
# process_stft / process_cwt / process_ssq_cwt / process_ssq_stft: data
# (n_samples, n_channels), chunked along time with a reflect halo, each
# chunk transformed per channel and stacked to (freq, time, channel).
# These wrappers give the same entry points over process_recording.
def _channels_first(data):
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    return np.ascontiguousarray(data.T)


def _freq_time_chan(res):
    return np.transpose(res, (1, 2, 0))


def process_stft(data, fs=None, n_fft=1024, hop_length=256,
                 window_name="hann", chunk_len=1_000_000, **kw):
    """(n_samples, n_channels) -> (n_freqs, n_frames, n_channels) complex
    (chunk size and halo: the dask scripts' map_overlap(depth=n_fft))."""
    res, _ = process_recording(_channels_first(data), transform="stft",
                               fs=float(fs or 1.0), n_fft=n_fft,
                               hop_len=hop_length, window=window_name,
                               chunk_len=chunk_len, **kw)
    return _freq_time_chan(res)


def process_cwt(data, fs=None, wavelet="gmw", scales=None, nv=32,
                derivative=False, padtype="reflect", chunk_len=100_000,
                **kw):
    """(n_samples, n_channels) -> (n_scales, n_samples, n_channels)
    complex Wx. `derivative` is accepted for signature parity; the
    stacked output is Wx either way."""
    res, _ = process_recording(_channels_first(data), transform="cwt",
                               fs=float(fs or 1.0), wavelet=wavelet,
                               scales=(scales if scales is not None
                                       else "log-piecewise"), nv=nv,
                               chunk_len=chunk_len, padtype=padtype, **kw)
    return _freq_time_chan(res)


def process_ssq_cwt(data, fs=None, wavelet="gmw", scales=None, nv=32,
                    padtype="reflect", squeezing="sum", maprange="peak",
                    chunk_len=100_000, **kw):
    """(n_samples, n_channels) -> ((n_freqs, n_samples, n_channels)
    complex Tx, ssq_freqs)."""
    res, meta = process_recording(
        _channels_first(data), transform="ssq_cwt", fs=float(fs or 1.0),
        wavelet=wavelet, scales=(scales if scales is not None
                                 else "log-piecewise"), nv=nv,
        chunk_len=chunk_len, padtype=padtype, squeezing=squeezing,
        maprange=maprange, **kw)
    return _freq_time_chan(res), meta.get("ssq_freqs")


def process_ssq_stft(data, fs=None, n_fft=1024, hop_length=1,
                     window_name="hann", chunk_len=1_000_000, **kw):
    """(n_samples, n_channels) -> ((n_freqs, n_frames, n_channels)
    complex Tx, ssq_freqs)."""
    res, meta = process_recording(
        _channels_first(data), transform="ssq_stft", fs=float(fs or 1.0),
        n_fft=n_fft, hop_len=hop_length, window=window_name,
        chunk_len=chunk_len, **kw)
    return _freq_time_chan(res), meta.get("ssq_freqs")
