"""Drop-in compatibility layer for the reference's `ssqueeze._rs` module
(counterpart of ``ssqueeze_rs_tpu/compat.py``).

The function signatures and return conventions of the Rust extension,
so code written against `from ssqueeze import _rs` runs unchanged:

    from ssqueeze_rs_tpu_torch import compat as _rs
    Sx, freqs = _rs.stft(x, n_fft, hop_length, window, "reflect")

Every transform runs the port in float64 (the STFT's rfft route, the
full-length CWT, kernels B' and B in double on the card) and returns host
numpy arrays. Array input goes to the CUDA device by the port's rule
(`utils.common.as_signal`); the transforms take one more keyword than
the Rust functions, `device` (`device="cpu"` runs the plain versions on
the CPU). The wavelet helpers are host numpy.

The reference quirks, as in the JAX package's layer:
  * `stft` is unmodulated and returns freqs normalized to [0, 0.5] (not
    scaled by fs);
  * `ssq_cwt` keeps the ln2/nv normalization constant the Rust version
    omits, so `Tx` is normalized as ssqueezepy's;
  * `icwt` is exported (the Rust one was written but never registered)
    and uses numerically integrated admissibility constants;
  * `cwt_simd` is an alias of `cwt`.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.cwt import cwt as _cwt, icwt as _icwt
from .ops.ssq_cwt import ssq_cwt as _ssq_cwt
from .ops.ssq_stft import ssq_stft as _ssq_stft
from .ops.stft import stft as _stft_fn
from .utils.common import as_signal
from .utils.pad import padsignal as _padsignal
from .wavelets.base import Wavelet
from .wavelets.gmw import morsefreq

__all__ = ["hello_from_bin", "stft", "ssq_stft", "cwt", "cwt_simd",
           "ssq_cwt", "icwt", "pad_signal", "morlet", "morlet_freq",
           "morlet_time", "gmw", "gmw_freq", "gmw_time",
           "gmw_center_frequency"]


def hello_from_bin() -> str:
    return "ssqueeze_rs_tpu_torch (PyTorch/CUDA backend)"


def _default_rust_scales(N, nv=32):
    """The Rust default scales: an endpoint-inclusive log grid 2 -> N/2
    of ceil(octaves*nv) points, step octaves/(num-1), so the last scale
    lands exactly on N/2 (not a fixed 1/nv-octave ladder)."""
    log_min, log_max = np.log2(2.0), np.log2(N * 0.5)
    na = int(np.ceil((log_max - log_min) * nv))
    if na <= 1:
        return np.array([2.0])
    step = (log_max - log_min) / (na - 1)
    return 2.0 ** (log_min + np.arange(na) * step)


def _np(a):
    """A tensor's values as a host numpy array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def stft(x, n_fft, hop_length, window, padtype="reflect", device=None):
    """(Sx, freqs) with freqs = linspace(0, 0.5, n_fft//2+1); unmodulated."""
    window = np.asarray(window)
    Sx = _stft_fn(x, window=window, n_fft=n_fft, hop_len=hop_length,
                  win_len=len(window), padtype=padtype, modulated=False,
                  dtype="float64", device=device)
    freqs = np.linspace(0, 0.5, n_fft // 2 + 1)
    return _np(Sx), freqs


def ssq_stft(x, window, n_fft=None, win_len=None, hop_len=1, fs=1.0,
             padtype="reflect", squeezing="sum", gamma=None, device=None):
    """(Tx, ssq_freqs)."""
    window = np.asarray(window) if window is not None else None
    Tx, Sx, ssq_freqs, Sfs = _ssq_stft(
        x, window=window, n_fft=n_fft, win_len=win_len, hop_len=hop_len,
        fs=fs, padtype=padtype, squeezing=squeezing, gamma=gamma,
        dtype="float64", device=device)
    return _np(Tx), np.asarray(ssq_freqs)


def cwt(x, wavelet="gmw", scales=None, fs=None, t=None, nv=32, l1_norm=True,
        derivative=False, padtype="reflect", rpadded=False, vectorized=True,
        patience=0, device=None):
    """(Wx, scales, dWx): always a 3-tuple, dWx None unless `derivative`
    (the Rust extension maps its Option<dWx> to None). Default scales
    follow the Rust convention (log, 2 -> N/2)."""
    if scales is None:
        scales = _default_rust_scales(np.shape(x)[-1], nv)
    out = _cwt(x, wavelet, scales=np.asarray(scales, dtype=np.float64),
               fs=fs, t=t, nv=nv, l1_norm=l1_norm, derivative=derivative,
               padtype=padtype, rpadded=rpadded, dtype="float64",
               device=device)
    if derivative:
        Wx, scales_out, dWx = out
        return _np(Wx), np.asarray(scales_out), _np(dWx)
    Wx, scales_out = out
    return _np(Wx), np.asarray(scales_out), None


# the Rust "SIMD" variant is the same algorithm
cwt_simd = cwt


def ssq_cwt(x, wavelet="gmw", scales=None, fs=None, t=None, ssq_freqs=None,
            nv=32, padtype="reflect", squeezing="sum", maprange="peak",
            difftype="trig", gamma=None, vectorized=True, flipud=True,
            device=None):
    """(Tx, ssq_freqs); default scales as `cwt`'s (the Rust ssq_cwt's
    grid)."""
    if scales is None:
        scales = _default_rust_scales(np.shape(x)[-1], nv)
    Tx, Wx, ssq_freqs_out, _ = _ssq_cwt(
        x, wavelet, scales=scales, nv=nv, fs=fs, t=t, ssq_freqs=ssq_freqs,
        padtype=padtype, squeezing=squeezing, maprange=maprange,
        difftype=difftype, gamma=gamma, flipud=flipud, dtype="float64",
        device=device)
    return _np(Tx), np.asarray(ssq_freqs_out)


def icwt(Wx, wavelet="gmw", scales=None, nv=None, one_int=True, x_len=None,
         x_mean=0, padtype="reflect", rpadded=False, l1_norm=True,
         device=None):
    """The inverse CWT, as a host array; default scales as `cwt`'s."""
    if scales is None:
        scales = _default_rust_scales(np.shape(Wx)[-1], nv if nv else 32)
    return _np(_icwt(Wx, wavelet, scales=np.asarray(scales), nv=nv,
                     one_int=one_int, x_len=x_len, x_mean=x_mean,
                     padtype=padtype, rpadded=rpadded, l1_norm=l1_norm,
                     device=device))


def pad_signal(x, padtype="reflect", padlength=None, device=None):
    """`padsignal` of x, as a host array."""
    return _np(_padsignal(as_signal(x, device), padtype,
                          padlength=padlength))


# -- wavelet functions (host numpy) -------------------------------------------
def morlet(w, mu=6.0, dtype="float64"):
    wav = Wavelet.build(("morlet", {"mu": float(mu)}))
    return np.asarray(wav(np.asarray(w, dtype=dtype)))


def morlet_freq(n=1024, scale=1.0, mu=6.0, dtype="float64"):
    wav = Wavelet.build(("morlet", {"mu": float(mu)}))
    return np.asarray(wav.sample(float(scale), int(n), xp=np, nohalf=True)
                      ).astype(dtype)


def morlet_time(n=1024, scale=1.0, mu=6.0, dtype="float64"):
    wav = Wavelet.build(("morlet", {"mu": float(mu)}))
    return np.asarray(wav.psi_time(float(scale), int(n), xp=np))


def gmw(w, gamma=3.0, beta=60.0, norm="bandpass", order=0, dtype="float64"):
    wav = Wavelet.build(("gmw", dict(gamma=float(gamma), beta=float(beta),
                                     norm=norm, order=int(order))))
    return np.asarray(wav(np.asarray(w, dtype=dtype)))


def gmw_freq(n=1024, scale=1.0, gamma=3.0, beta=60.0, norm="bandpass",
             order=0, dtype="float64"):
    wav = Wavelet.build(("gmw", dict(gamma=float(gamma), beta=float(beta),
                                     norm=norm, order=int(order))))
    return np.asarray(wav.sample(float(scale), int(n), xp=np, nohalf=True)
                      ).astype(dtype)


def gmw_time(n=1024, scale=1.0, gamma=3.0, beta=60.0, norm="bandpass",
             order=0, dtype="float64"):
    wav = Wavelet.build(("gmw", dict(gamma=float(gamma), beta=float(beta),
                                     norm=norm, order=int(order))))
    return np.asarray(wav.psi_time(float(scale), int(n), xp=np))


def gmw_center_frequency(gamma=3.0, beta=60.0, kind="peak"):
    """The GMW's peak ('peak') or energy ('energy') radian frequency."""
    wm, we = morsefreq(gamma, beta, n_out=2)
    return float(wm if kind == "peak" else we)
