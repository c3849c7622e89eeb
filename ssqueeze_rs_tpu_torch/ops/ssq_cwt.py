"""Synchrosqueezed CWT, forward and inverse (counterpart of
``ssqueeze_rs_tpu/ops/ssq_cwt.py``).

Forward routes, all on the input's device, as the JAX package's:
  * the planar route (float32, real psih, sum squeezing, trig phase):
    pad -> rfft -> psih on the half-band grid (or the cached filterbank
    with `cache_wavelet=True`) -> kernel A (Wx planes and the phase plane
    w) -> host planning -> kernel B; with `get_dWx`, kernel D (Wx and dWx
    planes) -> kernel B';
  * `cwt(derivative=True)` for every other option (float64, squeezing
    'lebesgue', 'abs' or a callable, difftype 'phase' / 'numeric', a
    complex psih, `padtype=None` with N not a power of 2): kernel D, E or
    plain torch FFTs (float64: the full-length route; see
    `cwt.cwt_core`), then B' from dWx or B from `phase_cwt` /
    `phase_cwt_num` with `get_w` (in double for float64);
  * `order > 0`: `cwt_higher_order` (kernel D per order) + `trigdiff`.

A call runs in the span `ssq.ssq_cwt`, its stages in `ssq.plan`,
`ssq.prep`, `ssq.launch.<entry>` and `ssq.pack` (`trace`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EPS32, EPS64, real_dtype
from ..scales import process_scales, process_fs_and_t
from ..trace import span, spanned
from ..utils.common import as_signal
from ..utils.pad import padsignal, p2up
from ..wavelets.adm import adm_ssq
from ..wavelets.base import Wavelet
from .cwt import cwt, cwt_core, cwt_higher_order, cache_filterbank
from .diff import trigdiff
from .fft_cuda import best_split
from .phase import phase_cwt, phase_cwt_num
from .ssqueeze import ssqueeze, check_ssqueezing_args

__all__ = ["ssq_cwt", "issq_cwt"]


def _planar_ssq_ok(N, wavelet, padtype, squeezing):
    """Is the planar route (f32 planes end to end) applicable? (float32
    is checked before.)"""
    M = p2up(N)[0] if padtype is not None else N
    return (best_split(M) is not None and wavelet.psih_is_real and
            squeezing == "sum")


@spanned("ssq.ssq_cwt")
def ssq_cwt(x, wavelet="gmw", scales="log-piecewise", nv=None, fs=None,
            t=None, ssq_freqs=None, padtype="reflect", squeezing="sum",
            maprange="peak", difftype="trig", difforder=None, gamma=None,
            vectorized=True, preserve_transform=None, astensor=True, order=0,
            nan_checks=None, patience=0, flipud=True, cache_wavelet=None,
            get_w=False, get_dWx=False, dtype=None, device=None):
    """Synchrosqueezed CWT of `x` ((N,) or (..., N)).

    Returns (Tx, Wx, ssq_freqs, scales[, w][, dWx]): Tx (..., nf, N), Wx
    (..., na, N), w and dWx tensors on x's device (complex64 / float32, or
    complex128 / float64 for `dtype='float64'`; `utils.common.as_signal`:
    array input goes to the CUDA device unless `device` says otherwise);
    ssq_freqs and scales numpy arrays. `cache_wavelet=True` takes the
    planar route's filterbank from `cwt.cache_filterbank`.
    `vectorized`, `preserve_transform`, `astensor` and `patience` are
    accepted and ignored, as in the JAX package."""
    with span("ssq.plan"):
        difforder = check_ssqueezing_args(squeezing, maprange, wavelet,
                                          difftype, difforder, get_w,
                                          transform="cwt")
        dtype = real_dtype(dtype)
        x = as_signal(x, device)
        N = x.shape[-1]
        dt, fs, _ = process_fs_and_t(fs, t, N)
        if nv is None and isinstance(scales, str):
            nv = 32

        wavelet = Wavelet.build(wavelet, l1_norm=True)
        higher = isinstance(order, (tuple, list, range)) or order > 0
        if not higher:
            scales, cwt_scaletype, *_ = process_scales(
                scales, N, wavelet, nv=nv, get_params=True)
    planes_w = w_plane = dwx_planes = None
    if higher:
        # averaged higher-order CWT; the derivative by trig differentiation
        # of the padded transform
        _, n1, _ = p2up(N)
        Wxp, scales_arr = cwt_higher_order(
            x, wavelet=wavelet, order=order,
            average=isinstance(order, (tuple, list, range)), scales=scales,
            fs=fs, nv=nv, l1_norm=True, derivative=False, padtype=padtype,
            rpadded=True, nan_checks=nan_checks, dtype=dtype)
        dWx = trigdiff(Wxp, fs, rpadded=True, N=N, n1=n1)
        Wx = Wxp[..., n1:n1 + N]
        scales = np.asarray(scales_arr).reshape(-1, 1)
        cwt_scaletype = process_scales(scales, N, wavelet, nv=nv,
                                       get_params=True)[1]
    else:
        rpadded = difftype == "numeric"
        if (not rpadded and not get_w and dtype == "float32" and
                _planar_ssq_ok(N, wavelet, padtype, squeezing)):
            with span("ssq.prep"):
                xx = x
                if nan_checks is None or nan_checks:
                    xx = torch.nan_to_num(xx, nan=0.0, posinf=0.0,
                                          neginf=0.0)
                xx = xx.to(torch.float32)
                if padtype is not None:
                    xp, _, n1, _ = padsignal(xx, padtype, get_params=True)
                else:
                    xp, n1 = xx, 0
            # kernel A forms the phase itself unless the dWx planes are
            # asked for (then kernel D emits them for B')
            phase_gamma = (float(gamma if gamma is not None else 10 * EPS32)
                           if not get_dWx and difftype == "trig" else None)
            sc = np.asarray(scales).squeeze(-1)
            filterbank = None
            if cache_wavelet:
                with span("ssq.plan"):
                    filterbank = cache_filterbank(wavelet, sc, xp.shape[-1],
                                                  xp.device)
            planes_w, planes_d = cwt_core(
                xp, sc, dt, wavelet=wavelet, derivative=True, l1_norm=True,
                N=N, n1=n1, rpadded=False, planar_out=True,
                phase_gamma=phase_gamma, filterbank=filterbank)
            with span("ssq.pack"):
                Wx = torch.complex(*planes_w)
                if phase_gamma is not None:
                    w_plane, dWx = planes_d, None
                else:
                    dwx_planes = planes_d
                    dWx = torch.complex(*planes_d) if get_dWx else None
        else:
            Wx, _, dWx = cwt(x, wavelet, scales=scales, fs=fs, nv=nv,
                             l1_norm=True, derivative=True, padtype=padtype,
                             rpadded=rpadded, nan_checks=nan_checks,
                             dtype=dtype, cache_wavelet=cache_wavelet)

    if gamma is None:
        gamma = 10 * (EPS64 if Wx.dtype == torch.complex128 else EPS32)

    if get_w:
        if difftype == "trig":
            w = phase_cwt(Wx, dWx, "trig", gamma)
        elif difftype == "phase":
            w = phase_cwt(Wx, None, "phase", gamma)
        else:
            # numeric: Wx is the padded transform; the phase is taken over
            # the N+8 window around the signal
            if padtype is None or higher:
                raise ValueError(
                    "difftype='numeric' requires padtype != None and "
                    "order=0 (the phase window reads the padded CWT)")
            _, n1, _ = p2up(N)
            Wx = Wx[..., (n1 - 4):(n1 + N + 4)]
            w = phase_cwt_num(Wx, dt, difforder, gamma)
        _dWx = None
    else:
        w = None
        _dWx = dwx_planes if dwx_planes is not None else dWx

    if ssq_freqs is None:
        ssq_freqs = cwt_scaletype
    Tx, ssq_freqs = ssqueeze(Wx, w, ssq_freqs, scales, fs=fs,
                             squeezing=squeezing, maprange=maprange,
                             wavelet=wavelet, gamma=gamma,
                             was_padded=padtype is not None, flipud=flipud,
                             dWx=_dWx, transform="cwt", wx_planes=planes_w,
                             w_plane=w_plane)

    if difftype == "numeric":
        Wx = Wx[..., 4:-4]
        Tx = Tx[..., 4:-4]
        w = w[..., 4:-4] if w is not None else None

    scales = np.asarray(scales).squeeze()
    if get_w and get_dWx:
        return Tx, Wx, ssq_freqs, scales, w, dWx
    elif get_w:
        return Tx, Wx, ssq_freqs, scales, w
    elif get_dWx:
        return Tx, Wx, ssq_freqs, scales, dWx
    return Tx, Wx, ssq_freqs, scales


# -- inverse ----------------------------------------------------------------
def _process_component_inversion_args(cc, cw):
    if cc is None and cw is None:
        return None, None, True
    cc = torch.as_tensor(np.asarray(cc), dtype=torch.int64)
    cw = torch.as_tensor(np.asarray(cw), dtype=torch.int64)
    if cc.ndim == 1:
        cc = cc[:, None]
    if cw.ndim == 1:
        cw = cw[:, None]
    return cc, cw, False


def _invert_components(Tx, cc, cw):
    """Sum Re Tx over the band [cc - cw, cc + cw] of each of the K curves
    (cc, cw: (n_times, K); cc = -1 where a curve is absent); the last
    output row is the residual, the rows no curve claims. Tx may have
    leading batch dims: output (..., K + 1, n_times)."""
    n_freqs = Tx.shape[-2]
    cc = cc.to(Tx.device).T                       # (K, n_times)
    cw = cw.to(Tx.device).T
    rows = torch.arange(n_freqs, device=Tx.device)[None, :, None]

    upper = torch.clamp(cc + cw, 0, n_freqs)
    lower = torch.clamp(cc - cw, 0, n_freqs)
    no_curve = cc == -1
    upper = torch.where(no_curve, torch.zeros_like(upper), upper)
    lower = torch.where(no_curve, torch.ones_like(lower), lower)
    # (K, n_freqs, n_times) band masks
    mask = (rows >= lower[:, None, :]) & (rows <= upper[:, None, :])

    Txr = Tx.real
    comps = torch.einsum("...fn,kfn->...kn", Txr, mask.to(Txr.dtype))
    remainder = ~mask.any(dim=0)
    resid = (Txr * remainder.to(Txr.dtype)).sum(dim=-2)
    return torch.cat([comps, resid[..., None, :]], dim=-2)


def issq_cwt(Tx, wavelet="gmw", cc=None, cw=None, device=None):
    """Inverse synchrosqueezed CWT, on Tx's device (`as_signal`'s rule for
    arrays and `device`). Full inversion: x = (2/Css) * sum over
    frequency rows of Re Tx; with `cc`/`cw`, one row per curve band plus
    the residual (`_invert_components`)."""
    cc, cw, full_inverse = _process_component_inversion_args(cc, cw)
    Tx = as_signal(Tx, device)
    x = Tx.real.sum(dim=-2) if full_inverse else _invert_components(Tx, cc,
                                                                    cw)
    Css = adm_ssq(Wavelet.build(wavelet))
    return x * (2 / Css)
