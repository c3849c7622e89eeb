"""Scale <-> frequency conversion (host numpy) and the phase transform and
squeeze of an arbitrary TF array (counterpart of
``ssqueeze_rs_tpu/experimental.py``). `phase_transform` and
`phase_ssqueeze` run on the array's device (`utils.common.as_signal`:
array input goes to the CUDA device unless `device` says otherwise);
the squeeze is kernel B' (from dWx) or B (with `get_w`) on a CUDA tensor.
"""
from __future__ import annotations

import warnings

import numpy as np

from .scales import cwt_scalebounds
from .utils.pad import p2up
from .wavelets.base import Wavelet
from .wavelets.props import center_frequency

__all__ = ["freq_to_scale", "scale_to_freq", "phase_transform",
           "phase_ssqueeze"]


def freq_to_scale(freqs, wavelet, N, fs=1, n_search_scales=None, kind="peak",
                  base=2):
    """Approximate frequencies -> scales via a center-frequency search."""
    def log(x):
        return np.log(x) / np.log(base)

    freqs = np.asarray(freqs) / fs
    assert np.all(freqs >= 0), "frequencies must be positive"
    assert freqs.max() <= 0.5, "max frequency must be 0.5"
    assert freqs.max() == freqs[-1], "max frequency must be last sample"
    assert freqs.min() == freqs[0], "min frequency must be first sample"

    wavelet = Wavelet.build(wavelet)
    M = len(freqs)
    if n_search_scales is None:
        n_search_scales = 10 * M
    smin, smax = cwt_scalebounds(wavelet, N, preset="maximal",
                                 use_padded_N=False)
    search_scales = np.logspace(log(smin), log(smax), n_search_scales,
                                base=base)

    f_from_scales = np.array([
        min(max(center_frequency(wavelet, float(s), N, kind=kind), 0), np.pi)
        for s in search_scales]) / (2 * np.pi)

    fmin, fmax = freqs.min(), freqs.max()
    smax = search_scales[np.argmin(np.abs(f_from_scales - fmin))]
    smin = search_scales[np.argmin(np.abs(f_from_scales - fmax))]
    return np.logspace(log(smax), log(smin), M, base=base)


def scale_to_freq(scales, wavelet, N, fs=1, padtype="reflect"):
    """Scales -> frequencies via the wavelet's frequency-domain peak bin."""
    if isinstance(scales, float):
        scales = np.array([scales])
    scales = np.asarray(scales).squeeze()
    if scales.ndim == 0:
        scales = scales[None]
    wavelet = Wavelet.build(wavelet)

    Npad = p2up(N)[0] if padtype is not None else N
    psis = np.asarray(wavelet.sample(scales, Npad, xp=np, nohalf=True))
    idxs = np.argmax(psis, axis=-1)

    if np.any(idxs > Npad // 2) or 0 in idxs:
        warnings.warn("found potentially ill-behaved wavelets (peak indices "
                      "at negative freqs or at dc); will round idxs to 1 or "
                      "N/2")
        n_psis = len(psis)
        for i, ix in enumerate(idxs):
            if ix > Npad // 2 or ix == 0:
                idxs[i] = 1 if i > n_psis // 2 else Npad // 2

    freqs = idxs / Npad
    assert freqs.min() >= 0, freqs.min()
    assert freqs.max() <= 0.5, freqs.max()
    return freqs * fs


def phase_transform(Wx, dWx=None, difftype="trig", difforder=4, gamma=None,
                    fs=1.0, Sfs=None, rpadded=False, padtype="reflect",
                    N=None, n1=None, get_w=False, transform="cwt",
                    device=None):
    """Unified CWT & STFT synchrosqueezing phase transform of an arbitrary
    TF array, on Wx's device. Returns (w, Wx, dWx, Sfs, gamma)."""
    import torch

    from .config import EPS32, EPS64
    from .ops.diff import trigdiff
    from .ops.phase import phase_cwt, phase_cwt_num, phase_stft
    from .ops.ssq_stft import make_Sfs
    from .utils.common import as_signal

    Wx = as_signal(Wx, device)
    if transform == "stft" and dWx is None:
        raise NotImplementedError("`phase_transform` without `dWx` for "
                                  "STFT is not currently supported.")
    if rpadded and N is None:
        raise ValueError("`rpadded=True` requires `N`")
    if gamma is None:
        gamma = 10 * (EPS64 if Wx.dtype == torch.complex128 else EPS32)

    if transform == "cwt":
        if N is None and not rpadded:
            N = Wx.shape[-1]
        if n1 is None:
            n1 = p2up(N)[1]
        if dWx is None:
            dWx = trigdiff(Wx, fs, padtype, rpadded, N=N, n1=n1,
                           transform="cwt")
        if get_w:
            if difftype not in ("trig", "phase", "numeric"):
                raise ValueError("`difftype` must be one of: trig, phase, "
                                 f"numeric (got {difftype})")
            if difftype == "trig":
                w = phase_cwt(Wx, dWx, "trig", gamma)
            elif difftype == "phase":
                w = phase_cwt(Wx, None, "phase", gamma)
            else:
                Wx = Wx[..., (n1 - 4):(n1 + N + 4)]
                w = phase_cwt_num(Wx, 1 / fs, difforder, gamma)
        else:
            w = None
        Sfs = None
    else:
        if Sfs is None:
            Sfs = make_Sfs(Wx, fs)
        w = phase_stft(Wx, dWx, Sfs, gamma) if get_w else None
    return w, Wx, dWx, Sfs, gamma


def phase_ssqueeze(Wx, dWx=None, ssq_freqs=None, scales=None, Sfs=None,
                   fs=1.0, t=None, squeezing="sum", maprange=None,
                   wavelet=None, gamma=None, was_padded=True, flipud=False,
                   rpadded=False, padtype=None, N=None, n1=None,
                   difftype=None, difforder=None, get_w=False,
                   get_dWx=False, transform="cwt", device=None):
    """`phase_transform`, then `ssqueeze`, on an arbitrary CWT/STFT-like
    array on its device: kernel B' from dWx, or kernel B from w with
    `get_w`. Experimental; prefer `ssq_cwt` / `ssq_stft`. Returns
    (Tx, Wx, ssq_freqs, scales, Sfs, w, dWx)."""
    from .ops.ssqueeze import ssqueeze

    w, Wx, dWx, Sfs, gamma = phase_transform(
        Wx, dWx, difftype or "trig", difforder=difforder or 4, gamma=gamma,
        rpadded=rpadded, padtype=padtype, N=N, n1=n1, get_w=get_w, fs=fs,
        Sfs=Sfs, transform=transform, device=device)
    _dWx = None if (w is not None and not get_dWx) else dWx
    if maprange is None:
        maprange = "peak" if transform == "cwt" else "maximal"
    Tx, ssq_freqs = ssqueeze(Wx, w, ssq_freqs, scales, Sfs=Sfs, fs=fs, t=t,
                             squeezing=squeezing, maprange=maprange,
                             wavelet=wavelet, gamma=gamma,
                             was_padded=was_padded, flipud=flipud, dWx=_dWx,
                             transform=transform)
    # dWx is returned only when asked for: don't keep the big array alive
    if w is not None and not get_dWx:
        dWx = None
    return Tx, Wx, ssq_freqs, scales, Sfs, w, dWx
