"""Synchrosqueezed STFT, forward and inverse (counterpart of
``ssqueeze_rs_tpu/ops/ssq_stft.py``).

Routes, decided from the arguments and shapes before anything launches
(float64 takes the last, as in the JAX package):
  * fused: float32, n_fft <= 2048, hop 1, sum squeezing, default
    ssq_freqs, no get_w / get_dWx, and kernel G's shared-memory plan fits
    (`stft_cuda.ssq_stft_fused_ok`) -> kernel G, the whole pipeline.
  * planar: otherwise with float32, n_fft <= 2048, sum squeezing and no
    get_w -> the STFT planes (kernel F at hop 1) -> kernel B'.
  * otherwise the complex STFT (the rfft route for float64) ->
    `ssqueeze` (B' from dSx, or B from w when get_w; their double
    instantiations for float64 on the card).

A call runs in the span `ssq.ssq_stft`, its stages in `ssq.plan`,
`ssq.prep`, `ssq.launch.<entry>` and `ssq.pack` (`trace`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EPS32, EPS64, real_dtype
from ..scales import process_fs_and_t, infer_scaletype
from ..trace import span, spanned
from ..utils.common import WARN, as_signal
from ..utils.pad import padsignal
from ..utils.windows import get_window, check_nola
from .fft_cuda import _f32
from .phase import phase_stft
from .ssq_cwt import _process_component_inversion_args, _invert_components
from .ssqueeze import ssqueeze, check_ssqueezing_args, plan_reassignment
from .stft import stft, _dft_spec, _k_t, _win_bytes, MATMUL_NFFT_MAX
from .stft_cuda import ssq_stft_fused, ssq_stft_fused_ok

__all__ = ["ssq_stft", "issq_stft", "make_Sfs"]


def make_Sfs(Sx, fs):
    """Row frequencies of Sx: linspace(0, fs/2, n_rows), float32 for a
    complex64 Sx."""
    dtype = np.float64 if Sx.dtype == torch.complex128 else np.float32
    return np.linspace(0, 0.5 * fs, Sx.shape[-2], dtype=dtype)


@spanned("ssq.ssq_stft")
def ssq_stft(x, window=None, n_fft=None, win_len=None, hop_len=1, fs=None,
             t=None, modulated=True, ssq_freqs=None, padtype="reflect",
             squeezing="sum", gamma=None, preserve_transform=None, dtype=None,
             astensor=True, flipud=False, get_w=False, get_dWx=False,
             device=None):
    """Synchrosqueezed STFT of `x` ((N,) or (..., N)), on x's device
    (`utils.common.as_signal`: array input goes to the CUDA device unless
    `device` says otherwise).

    Returns (Tx, Sx, ssq_freqs, Sfs[, w][, dSx]): Tx, Sx (..., n_fft//2
    + 1, n_hops), complex64 for `dtype` float32 (the default) and
    complex128 for float64; ssq_freqs, Sfs numpy. `preserve_transform`
    and `astensor` are accepted for signature parity and unused."""
    with span("ssq.plan"):
        x = as_signal(x, device)
        N = x.shape[-1]
        _, fs, _ = process_fs_and_t(fs, t, N)
        check_ssqueezing_args(squeezing)
        if (isinstance(ssq_freqs, (np.ndarray, torch.Tensor)) and
                infer_scaletype(np.asarray(ssq_freqs))[0] != "linear"):
            raise ValueError("`ssq_freqs` must be linearly distributed for "
                             "`ssq_stft`")
        dtype = real_dtype(dtype)

        n_fft_eff = int(n_fft or min(N // hop_len, 512))
        planar = (dtype == "float32" and n_fft_eff <= MATMUL_NFFT_MAX and
                  squeezing == "sum" and not get_w)
        fused = (planar and hop_len == 1 and not get_dWx and
                 ssq_freqs is None and ssq_stft_fused_ok(n_fft_eff))
    if fused:
        return _ssq_stft_fused(x, window, n_fft_eff, win_len, fs, modulated,
                               padtype, gamma, flipud)
    kw = dict(n_fft=n_fft_eff, win_len=win_len, hop_len=hop_len, fs=fs,
              padtype=padtype, modulated=modulated, derivative=True,
              dtype=dtype)
    if planar:
        sxp, dsp = stft(x, window, planar_out=True, **kw)
        with span("ssq.pack"):
            Sx = torch.complex(*sxp)
            dSx = torch.complex(*dsp) if get_dWx else dsp
    else:
        sxp = None
        Sx, dSx = stft(x, window, **kw)

    with span("ssq.plan"):
        Sfs = make_Sfs(Sx, fs)
    if gamma is None:
        gamma = 10 * (EPS64 if Sx.dtype == torch.complex128 else EPS32)

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
    with span("ssq.plan"):
        if win_len is None:
            win_len = (len(window)
                       if isinstance(window, (np.ndarray, torch.Tensor))
                       else n_fft)
        window, diff_window = get_window(window, int(win_len), n_fft,
                                         derivative=True, dtype="float32")
        check_nola(window, 1)
        wins = (_win_bytes(window), _win_bytes(diff_window), int(n_fft),
                bool(modulated))
        K_T = _k_t(*wins, x.device)
        nf = n_fft // 2 + 1
        Sfs = np.linspace(0, 0.5 * fs, nf, dtype=np.float32)
        const_arr, mode, params = plan_reassignment(Sfs, nf, False,
                                                    transform="stft")
        Sfs_d, const_d = (_f32(a, x.device) for a in (Sfs, const_arr))
    if gamma is None:
        gamma = 10 * EPS32
    with span("ssq.prep"):
        xp = padsignal(x.to(torch.float32), padtype,
                       padlength=N + n_fft - 1)
    Tx, Sx = ssq_stft_fused(xp, K_T, n_fft, N, fs, Sfs_d, const_d, gamma,
                            params, mode, bool(flipud), spec=_dft_spec(*wins))
    return Tx, Sx, (Sfs[::-1] if flipud else Sfs), Sfs


def issq_stft(Tx, window=None, cc=None, cw=None, n_fft=None, win_len=None,
              hop_len=1, modulated=True, device=None):
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
    Tx = as_signal(Tx, device)
    n_fft = int(n_fft or (Tx.shape[-2] - 1) * 2)
    win_len = int(win_len or n_fft)

    window = get_window(window, win_len, n_fft=n_fft)
    check_nola(window, hop_len)
    if abs(np.argmax(window) - len(window) // 2) > 1:
        WARN("`window` maximum not centered; results may be inaccurate.")

    x = Tx.real.sum(dim=-2) if full_inverse else _invert_components(Tx, cc,
                                                                    cw)
    return x * float(2 / window[len(window) // 2])
