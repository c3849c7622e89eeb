"""Synchrosqueezed STFT, forward and inverse (counterpart of
``ssqueeze_rs_tpu/ops/ssq_stft.py``).

Routes, decided from the arguments and shapes before anything launches:
  * fused: float32, n_fft <= 2048, hop 1, sum squeezing, default
    ssq_freqs, no get_w / get_dWx, and kernel G's shared-memory plan fits
    (`stft_cuda.ssq_stft_fused_ok`) -> kernel G, the whole pipeline.
  * planar: otherwise with float32, n_fft <= 2048, sum squeezing and no
    get_w -> the STFT planes (kernel F at hop 1) -> kernel B'.
  * otherwise the complex STFT -> `ssqueeze` (B' from dSx, or B from w
    when get_w).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EPS32
from ..scales import process_fs_and_t, infer_scaletype
from ..utils.common import WARN, as_signal
from ..utils.pad import padsignal
from ..utils.windows import get_window, check_nola
from .phase import phase_stft
from .ssq_cwt import _process_component_inversion_args, _invert_components
from .ssqueeze import ssqueeze, check_ssqueezing_args, plan_reassignment
from .stft import stft, _check_f32, _k_t, _win_bytes, MATMUL_NFFT_MAX
from .stft_cuda import ssq_stft_fused, ssq_stft_fused_ok

__all__ = ["ssq_stft", "issq_stft", "make_Sfs"]


def make_Sfs(Sx, fs):
    """Row frequencies of Sx: linspace(0, fs/2, n_rows), float32 for a
    complex64 Sx."""
    dtype = np.float64 if Sx.dtype == torch.complex128 else np.float32
    return np.linspace(0, 0.5 * fs, Sx.shape[-2], dtype=dtype)


def ssq_stft(x, window=None, n_fft=None, win_len=None, hop_len=1, fs=None,
             t=None, modulated=True, ssq_freqs=None, padtype="reflect",
             squeezing="sum", gamma=None, preserve_transform=None, dtype=None,
             astensor=True, flipud=False, get_w=False, get_dWx=False):
    """Synchrosqueezed STFT of `x` ((N,) or (..., N)), on x's device (the
    CPU for array input).

    Returns (Tx, Sx, ssq_freqs, Sfs[, w][, dSx]): Tx, Sx complex64
    (..., n_fft//2 + 1, n_hops); ssq_freqs, Sfs numpy. `preserve_transform`
    and `astensor` are accepted for signature parity and unused."""
    x = as_signal(x)
    N = x.shape[-1]
    _, fs, _ = process_fs_and_t(fs, t, N)
    check_ssqueezing_args(squeezing)
    if (isinstance(ssq_freqs, (np.ndarray, torch.Tensor)) and
            infer_scaletype(np.asarray(ssq_freqs))[0] != "linear"):
        raise ValueError("`ssq_freqs` must be linearly distributed for "
                         "`ssq_stft`")
    _check_f32(dtype)

    n_fft_eff = int(n_fft or min(N // hop_len, 512))
    planar = (n_fft_eff <= MATMUL_NFFT_MAX and squeezing == "sum" and
              not get_w)
    if (planar and hop_len == 1 and not get_dWx and ssq_freqs is None and
            ssq_stft_fused_ok(n_fft_eff)):
        return _ssq_stft_fused(x, window, n_fft_eff, win_len, fs, modulated,
                               padtype, gamma, flipud)
    kw = dict(n_fft=n_fft_eff, win_len=win_len, hop_len=hop_len, fs=fs,
              padtype=padtype, modulated=modulated, derivative=True)
    if planar:
        sxp, dsp = stft(x, window, planar_out=True, **kw)
        Sx = torch.complex(*sxp)
        dSx = torch.complex(*dsp) if get_dWx else dsp
    else:
        sxp = None
        Sx, dSx = stft(x, window, **kw)

    Sfs = make_Sfs(Sx, fs)
    if gamma is None:
        gamma = 10 * EPS32

    if get_w:
        w = phase_stft(Sx, dSx, Sfs, gamma)
        _dSx = None
    else:
        w = None
        _dSx = dSx

    if ssq_freqs is None:
        ssq_freqs = Sfs
    Tx, ssq_freqs = ssqueeze(Sx, w, squeezing=squeezing, ssq_freqs=ssq_freqs,
                             Sfs=Sfs, flipud=flipud, gamma=gamma, dWx=_dSx,
                             maprange="maximal", transform="stft",
                             wx_planes=sxp)

    if get_w and get_dWx:
        return Tx, Sx, ssq_freqs, Sfs, w, dSx
    elif get_w:
        return Tx, Sx, ssq_freqs, Sfs, w
    elif get_dWx:
        return Tx, Sx, ssq_freqs, Sfs, dSx
    return Tx, Sx, ssq_freqs, Sfs


def _ssq_stft_fused(x, window, n_fft, win_len, fs, modulated, padtype,
                    gamma, flipud):
    """The fused route (kernel G): hop 1, sum squeezing, default
    ssq_freqs; host planning as on the other routes (same window and DFT
    matrices, same plan_reassignment)."""
    N = x.shape[-1]
    if win_len is None:
        win_len = (len(window) if isinstance(window, (np.ndarray, torch.Tensor))
                   else n_fft)
    window, diff_window = get_window(window, int(win_len), n_fft,
                                     derivative=True, dtype="float32")
    check_nola(window, 1)
    K_T = _k_t(_win_bytes(window), _win_bytes(diff_window), int(n_fft),
               bool(modulated), x.device)
    nf = n_fft // 2 + 1
    Sfs = np.linspace(0, 0.5 * fs, nf, dtype=np.float32)
    const_arr, mode, params = plan_reassignment(Sfs, nf, False,
                                                transform="stft")
    if gamma is None:
        gamma = 10 * EPS32
    xp = padsignal(x.to(torch.float32), padtype, padlength=N + n_fft - 1)
    Tx, Sx = ssq_stft_fused(xp, K_T, n_fft, N, fs, Sfs, const_arr, gamma,
                            params, mode, bool(flipud))
    return Tx, Sx, (Sfs[::-1] if flipud else Sfs), Sfs


def issq_stft(Tx, window=None, cc=None, cw=None, n_fft=None, win_len=None,
              hop_len=1, modulated=True):
    """Inverse synchrosqueezed STFT: x = (2 / window[center]) * sum over
    rows of Re Tx (or per curve band with `cc`/`cw`); requires hop_len=1
    and a modulated STFT.

    As in the JAX package (a reference quirk kept as it is): the forward
    ssq_stft's Tx scales with `fs` (its reassignment constant is the
    ssq-frequency spacing in Hz), while this inversion assumes fs = 1:
    invert a transform taken with fs = 1, or divide the result by fs."""
    if not modulated:
        raise ValueError("inversion with `modulated == False` is unsupported.")
    if hop_len != 1:
        raise ValueError("inversion with `hop_len != 1` is unsupported.")

    cc, cw, full_inverse = _process_component_inversion_args(cc, cw)
    Tx = torch.as_tensor(Tx)
    n_fft = int(n_fft or (Tx.shape[-2] - 1) * 2)
    win_len = int(win_len or n_fft)

    window = get_window(window, win_len, n_fft=n_fft)
    check_nola(window, hop_len)
    if abs(np.argmax(window) - len(window) // 2) > 1:
        WARN("`window` maximum not centered; results may be inaccurate.")

    x = Tx.real.sum(dim=-2) if full_inverse else _invert_components(Tx, cc,
                                                                    cw)
    return x * float(2 / window[len(window) // 2])
