"""Continuous Wavelet Transform, forward and inverse (counterpart of
``ssqueeze_rs_tpu/ops/cwt.py``).

`cwt_core` takes the JAX package's routes, chosen by dtype, psih and the
padded length M only (never by device):

  * planar (float32, real psih, M a power of 2 that `best_split` takes):
    `rfft` of the padded signal, psih sampled on the half-band grid
    (k = M2*k1 + k2, k < M/2) on the signal's device (or, with
    `cache_wavelet=True`, taken from `cache_filterbank`: sampled once on
    the host, as the JAX package's cache), the Nyquist term, then kernel D
    (`fft_cuda.cwt_fused`: Wx and, with the derivative, dWx planes) or,
    for `ssq_cwt`'s phase, kernel A (`fft_cuda.cwt_phase`);
  * complex half-band (float32, complex psih, the same M): Z = psih * xhat
    on bins 0..M/2 in torch, stacked over rows with Z * i*xi/dt for the
    derivative, then kernel E (`fft_cuda.ifft_halfband_planar`);
  * full length (float64, or M not a power of 2): plain `torch.fft`, as
    the JAX package runs XLA there.

The planes come back N wide (or M with `rpadded`); the TPU package's
512-column alignment of the kept width is not carried over.
`icwt` is plain torch on the input's device.
"""
from __future__ import annotations

from collections import OrderedDict
from functools import lru_cache

import numpy as np
import torch

from ..config import real_dtype
from ..scales import (process_scales, process_fs_and_t,
                      logscale_transition_idx)
from ..trace import span
from ..utils.common import as_signal
from ..utils.fft import xifn
from ..utils.pad import padsignal
from ..wavelets.adm import adm_cwt, adm_ssq
from ..wavelets.base import Wavelet
from .fft_cuda import best_split, cwt_phase, cwt_fused, ifft_halfband_planar

__all__ = ["cwt", "icwt", "cwt_core", "cwt_higher_order", "cwt_phase_args",
           "xi_grid", "cache_filterbank"]

# the host-sampled filterbank cache of `cache_wavelet=True` (the JAX
# package's `_cache_filterbank`, ssqueeze_rs_tpu/ops/cwt.py): at most
# `_FB_CACHE_MAX` entries, least recently used out first
_FB_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_FB_CACHE_MAX = 8   # an entry is ~na*M/2*4 bytes (~150 MB at (300, 2^18))


def xi_grid(M: int, device="cpu") -> torch.Tensor:
    """Positive-frequency radian grid for bins k < M/2, float32, in the
    (K1, M2) layout (k = M2*k1 + k2), computed on `device` with the same
    float64 product as `utils.fft.xifn`, then rounded once."""
    M1, M2 = best_split(M)
    k = torch.arange(M // 2, dtype=torch.float64, device=device)
    return (k * (2 * np.pi / M)).to(torch.float32).reshape(M1 // 2, M2)


@lru_cache(maxsize=64)
def _xi_grid_np(M: int):
    """`xi_grid` on the host, as the JAX package builds it: `xifn` on the
    bins k < M/2, rounded once to float32, in the (K1, M2) layout."""
    M1, M2 = best_split(M)
    return xifn(1, M)[:M // 2].astype(np.float32).reshape(M1 // 2, M2)


def cache_filterbank(wavelet: Wavelet, scales_np, M: int, device):
    """The filterbank of `cache_wavelet=True` on `device`: (Pw (na, K1,
    M2), its Nyquist vector psih(scale*pi)/2 (na,)), both float32, sampled
    on the host with numpy exactly as the JAX package's
    `_cache_filterbank` (so bitwise its arrays) and uploaded once. The key
    is the full tuple (name, params, scales' bytes, M) and the device; at
    most `_FB_CACHE_MAX` entries are kept, least recently used out
    first."""
    scales_np = np.asarray(scales_np)
    key = (wavelet.name, wavelet.params, scales_np.tobytes(), int(M),
           str(torch.device(device)))
    if key in _FB_CACHE:
        _FB_CACHE.move_to_end(key)
        return _FB_CACHE[key]
    xig = _xi_grid_np(M)
    sc = scales_np.astype(np.float32)
    Pw = wavelet.psih(sc[:, None, None] * xig[None], np).astype(np.float32)
    pnyq = (wavelet.psih(sc * np.float32(np.pi), np) / 2).astype(np.float32)
    _FB_CACHE[key] = (torch.as_tensor(Pw, device=device),
                      torch.as_tensor(pnyq, device=device))
    while len(_FB_CACHE) > _FB_CACHE_MAX:
        _FB_CACHE.popitem(last=False)
    return _FB_CACHE[key]


def cwt_phase_args(xp: torch.Tensor, scales, dt: float, wavelet: Wavelet,
                   filterbank=None):
    """Kernel A's and D's inputs for an already padded f32 signal xp
    (..., M): the filterbank Pw sampled on xp's device (or the cached
    (Pw, Nyquist vector) pair `filterbank`, from `cache_filterbank`), the
    signal spectrum planes, the grid, 1/dt and the Nyquist vectors (rows
    b-major), as the tuple (Pw, xr, xi, xig, inv_dt, nyq_w, nyq_d)."""
    M = xp.shape[-1]
    split = best_split(M)
    if split is None:
        raise ValueError(f"padded length M={M} must be a power of 2 with "
                         "M <= 2^22 for the planar CWT route")
    M1, M2 = split
    K1 = M1 // 2
    b = int(np.prod(xp.shape[:-1])) if xp.ndim > 1 else 1
    device = xp.device
    f32 = torch.float32

    xh = torch.fft.rfft(xp.reshape(b, M), dim=-1)            # (b, M/2+1)
    xig = xi_grid(M, device)
    if filterbank is not None:
        Pw, pnyq = filterbank
    else:
        with span("ssq.plan"):
            sc = torch.as_tensor(np.asarray(scales, dtype=np.float32),
                                 device=device)
        Pw = wavelet.psih(sc[:, None, None] * xig[None], torch).to(f32)
        pnyq = (wavelet.psih(sc * np.float32(np.pi), torch) / 2).to(f32)
    na = Pw.shape[0]
    # Nyquist bin: psih(scale*pi)/2 * Re xhat[M/2], rows b-major; the
    # derivative spectrum's Nyquist value is i*pi/dt times it
    znyq = (xh[:, -1].real[:, None] * pnyq[None, :]).reshape(b * na)
    zeros = torch.zeros_like(znyq)
    dt32 = np.float32(dt)
    inv_dt = float(np.float32(1.0) / dt32)
    pi_dt = float(np.float32(np.pi) / dt32)
    xr = xh.real[:, :M // 2].reshape(b, K1, M2)
    xi = xh.imag[:, :M // 2].reshape(b, K1, M2)
    return Pw, xr, xi, xig, inv_dt, (znyq, zeros), (zeros, znyq * pi_dt)


def _route(xp, wavelet):
    """'planar', 'halfband' or 'full' (see the module docstring)."""
    if xp.dtype == torch.float32 and best_split(xp.shape[-1]) is not None:
        return "planar" if wavelet.psih_is_real else "halfband"
    return "full"


def cwt_core(xp, scales, dt, *, wavelet: Wavelet, derivative: bool,
             l1_norm: bool, N: int, n1: int, rpadded: bool,
             planar_out: bool = False, engines=None, fb_token=None,
             phase_gamma=None, keep_align=None, filterbank=None):
    """CWT of an already padded signal xp (..., M); scales: (na,) host
    array. Keeps [n1, n1+N) (or all M with `rpadded`). Returns
    (Wx, dWx or None), complex (..., na, L).

    `planar_out=True` (planar route only) returns float32 plane tuples
    ((Wxr, Wxi), (dWxr, dWxi) or None) instead. `phase_gamma` (with
    `planar_out` and `derivative`) runs kernel A: the second item is then
    the phase plane w = |Im(dWx/Wx)|/2pi, +inf where |Wx| <= gamma.
    `filterbank`: the planar route's cached (Pw, Nyquist vector)
    (`cache_filterbank`); the other routes sample psih themselves.
    `engines`, `fb_token` and `keep_align` belong to the JAX package's TPU
    routes (its engine choice, its filterbank cache key, its 512-column
    alignment of the kept width): they are taken and change nothing."""
    M = xp.shape[-1]
    route = _route(xp, wavelet)
    if planar_out and route != "planar":
        raise ValueError("planar_out requires float32, a real-valued psih "
                         "and a padded length best_split accepts")
    batch = tuple(xp.shape[:-1])
    b = int(np.prod(batch)) if batch else 1
    rdt = np.float64 if xp.dtype == torch.float64 else np.float32
    sc = np.asarray(scales, dtype=rdt).reshape(-1)
    na = len(sc)
    keep = (0, M) if rpadded else (n1, N)
    L = keep[1]
    root = (None if l1_norm else
            torch.as_tensor(np.sqrt(sc), device=xp.device)[:, None])

    if route == "planar":
        with span("ssq.prep"):
            args = cwt_phase_args(xp, sc, dt, wavelet, filterbank)
        if phase_gamma is not None:
            if not (planar_out and derivative):
                raise ValueError("phase_gamma needs planar_out and derivative")
            wxr, wxi, w = cwt_phase(*args, keep=keep, gamma=phase_gamma)
            planes = [wxr, wxi]
        else:
            planes = list(cwt_fused(*args, keep=keep, derivative=derivative))
        if root is not None:
            # rows b-major: the per-scale root repeats over the batch
            planes = [p * root.repeat(b, 1) for p in planes]
        planes = [p.reshape(batch + (na, L)) for p in planes]
        if phase_gamma is not None:
            # w is invariant under the per-row rescale (same factor on Wx
            # and dWx), so it needs no root
            return tuple(planes), w.reshape(batch + (na, L))
        pw, pd = tuple(planes[:2]), tuple(planes[2:]) or None
        if planar_out:
            return pw, pd
        with span("ssq.pack"):
            return (torch.complex(*pw),
                    torch.complex(*pd) if pd is not None else None)

    cdt = torch.complex128 if rdt == np.float64 else torch.complex64
    if route == "halfband":
        M1, M2 = best_split(M)
        xh = torch.fft.rfft(xp, dim=-1)                      # (..., M/2+1)
        Psih = wavelet.sample(sc, M, nohalf=False, half=True,
                              device=xp.device).to(cdt)
        Z = Psih * xh[..., None, :]                          # (..., na, M/2+1)
        if derivative:
            xi = torch.as_tensor(xifn(1, M, dtype=rdt)[:M // 2 + 1],
                                 device=xp.device)
            Z = torch.cat([Z, Z * (1j * xi / dt)], dim=-2)
        rows = Z.shape[-2]
        Zf = Z.reshape(b * rows, M // 2 + 1)
        zp = Zf[:, :M // 2].reshape(b * rows, M1 // 2, M2)
        outr, outi = ifft_halfband_planar(zp.real, zp.imag, keep,
                                          Zf[:, -1].real, Zf[:, -1].imag)
        with span("ssq.pack"):
            W = torch.complex(outr, outi).reshape(batch + (rows, L))
    else:
        xh = torch.fft.fft(xp, dim=-1)
        Psih = wavelet.sample(sc, M, nohalf=False, device=xp.device).to(cdt)
        Z = Psih * xh[..., None, :]
        if derivative:
            # one batched inverse FFT over [spectra; derivative spectra]
            xi = torch.as_tensor(xifn(1, M, dtype=rdt), device=xp.device)
            Z = torch.cat([Z, Z * (1j * xi / dt)], dim=-2)
        W = torch.fft.ifft(Z, dim=-1)
        if not rpadded:
            W = W[..., n1:n1 + N]
    Wx, dWx = (W[..., :na, :], W[..., na:, :]) if derivative else (W, None)
    if root is not None:
        Wx = Wx * root
        dWx = dWx * root if derivative else None
    return Wx, dWx


def cwt(x, wavelet="gmw", scales="log-piecewise", fs=None, t=None, nv=32,
        l1_norm=True, derivative=False, padtype="reflect", rpadded=False,
        vectorized=True, astensor=True, cache_wavelet=None, order=0,
        average=None, nan_checks=None, patience=0, dtype=None, device=None):
    """Continuous Wavelet Transform of `x` ((N,) or (..., N)).

    Runs on x's device (`utils.common.as_signal`: array input goes to the
    CUDA device unless `device` says otherwise). `vectorized`, `astensor`
    and `patience` are accepted and ignored, as in the JAX package.
    `cache_wavelet=True` takes the planar route's filterbank from
    `cache_filterbank` (host-sampled once per wavelet, scales, length and
    device) instead of sampling psih on the device at each call; on the
    other routes it does nothing, as in the JAX package. `order > 0` or
    a tuple of orders goes to `cwt_higher_order`.

    Returns (Wx, scales) or (Wx, scales, dWx) if `derivative`: Wx, dWx
    complex (..., na, N) tensors (M wide with `rpadded`), scales a numpy
    array."""
    if isinstance(order, (tuple, list, range)) or order > 0:
        return cwt_higher_order(
            x, wavelet=wavelet, order=order, average=average, scales=scales,
            fs=fs, t=t, nv=nv, l1_norm=l1_norm, derivative=derivative,
            padtype=padtype, rpadded=rpadded, nan_checks=nan_checks,
            dtype=dtype, device=device)

    x = as_signal(x, device)
    if nan_checks is None or nan_checks:
        x = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    x = x.to(getattr(torch, real_dtype(dtype)))

    N = x.shape[-1]
    dt, fs, _ = process_fs_and_t(fs, t, N)
    if not isinstance(scales, str):
        nv = None

    wavelet = Wavelet.build(wavelet, l1_norm=l1_norm)
    scales_arr = process_scales(scales, N, wavelet, nv=nv)

    if padtype is not None:
        xp, _, n1, _ = padsignal(x, padtype, get_params=True)
    else:
        xp, n1 = x, 0

    filterbank = None
    if cache_wavelet and _route(xp, wavelet) == "planar":
        filterbank = cache_filterbank(wavelet, scales_arr.squeeze(-1),
                                      xp.shape[-1], xp.device)
    Wx, dWx = cwt_core(xp, scales_arr.squeeze(-1), dt, wavelet=wavelet,
                       derivative=derivative, l1_norm=l1_norm, N=N, n1=n1,
                       rpadded=rpadded, filterbank=filterbank)
    scales_out = scales_arr.squeeze()
    if derivative:
        return Wx, scales_out, dWx
    return Wx, scales_out


def cwt_higher_order(x, wavelet="gmw", order=1, average=None, **kw):
    """CWT with higher-order GMWs, order by order through `cwt` (kernel D
    on the planar route); a tuple `order` is averaged unless
    `average=False`."""
    if isinstance(order, (list, range)):
        order = tuple(order)
    single = not isinstance(order, tuple)
    orders = (order,) if single else order

    wavelet = Wavelet.build(wavelet, l1_norm=kw.get("l1_norm", True))
    if wavelet.name != "gmw":
        raise ValueError("`wavelet` must be GMW for higher-order transforms "
                         f"(got {wavelet.name})")
    wavopts = wavelet.config
    wavopts.pop("order", None)

    # fix scales from the zeroth-order wavelet so all orders share a grid
    scales = kw.pop("scales", "log-piecewise")
    if isinstance(scales, str):
        wav0 = Wavelet.build(("gmw", dict(order=0, **wavopts)))
        scales = process_scales(scales, np.shape(x)[-1], wav0,
                                nv=kw.pop("nv", 32))
    else:
        kw.pop("nv", None)

    derivative = kw.get("derivative", False)
    Wx_all, dWx_all = [], []
    for k in orders:
        wav_k = Wavelet.build(("gmw", dict(order=int(k), **wavopts)))
        out = cwt(x, wav_k, scales=scales, **kw)
        Wx_all.append(out[0])
        if derivative:
            dWx_all.append(out[-1])

    if (average or (average is None and not single)) and len(Wx_all) > 1:
        Wx_all = torch.stack(Wx_all).mean(dim=0)
        if derivative:
            dWx_all = torch.stack(dWx_all).mean(dim=0)
    elif len(Wx_all) == 1:
        Wx_all = Wx_all[0]
        if derivative:
            dWx_all = dWx_all[0]

    scales_out = np.asarray(scales).squeeze()
    return ((Wx_all, scales_out, dWx_all) if derivative else
            (Wx_all, scales_out))


# -- inverse --------------------------------------------------------------------
def _icwt_norm(scaletype: str, l1_norm: bool):
    if l1_norm:
        return (lambda s: 1.0) if scaletype == "log" else (lambda s: s)
    if scaletype == "log":
        return lambda s: s**0.5
    return lambda s: s**1.5


def icwt(Wx, wavelet="gmw", scales="log-piecewise", nv=None, one_int=True,
         x_len=None, x_mean=0, padtype="reflect", rpadded=False, l1_norm=True,
         device=None):
    """Inverse CWT by the one- or two-integral formula, with leading batch
    dims, plain torch on Wx's device (`as_signal`'s rule for arrays and
    `device`). A log-piecewise grid is inverted as its two log segments,
    and `x_mean` is added once (the JAX package's fix of the reference,
    which added it to both segments)."""
    Wx = as_signal(Wx, device)
    *_, na, n = Wx.shape
    x_len = x_len or n
    if not isinstance(scales, (np.ndarray, torch.Tensor)) and nv is None:
        nv = 32

    wavelet = Wavelet.build(wavelet, l1_norm=l1_norm)
    scales, scaletype, _, nv = process_scales(np.asarray(scales) if
                                              isinstance(scales, torch.Tensor)
                                              else scales, x_len, wavelet,
                                              nv=nv, get_params=True)
    assert len(scales) == na, f"{len(scales)} != {na}"

    if scaletype == "log-piecewise":
        idx = logscale_transition_idx(scales)
        kw = dict(wavelet=wavelet, one_int=one_int, x_len=x_len,
                  x_mean=0, padtype=padtype, rpadded=rpadded,
                  l1_norm=l1_norm)
        x = icwt(Wx[..., :idx, :], scales=scales[:idx], **kw)
        x = x + icwt(Wx[..., idx:, :], scales=scales[idx:], **kw)
        return x + x_mean

    rdt = np.float64 if Wx.dtype in (torch.complex128, torch.float64) \
        else np.float32
    sc = np.asarray(scales.squeeze(-1), dtype=rdt)
    if one_int:
        x = _icwt_1int(Wx, sc, scaletype, l1_norm)
    else:
        x = _icwt_2int(Wx, sc, scaletype, l1_norm, wavelet, x_len, padtype,
                       rpadded)

    Cpsi = adm_ssq(wavelet) if one_int else adm_cwt(wavelet)
    if scaletype == "log":
        x = x * ((2 / Cpsi) * np.log(2 ** (1 / nv)))
    else:
        x = x * ((2 / Cpsi) * np.pi / 4)
    return x + x_mean


def _icwt_1int(Wx, scales, scaletype, l1_norm):
    """One-integral iCWT (analytic wavelets): sum over scales of
    Re(Wx)/norm."""
    norm = _icwt_norm(scaletype, l1_norm)
    s = torch.as_tensor(scales, device=Wx.device)[:, None]
    return (Wx.real / norm(s)).sum(dim=-2)


def _icwt_2int(Wx, scales, scaletype, l1_norm, wavelet, x_len, padtype,
               rpadded):
    """Two-integral iCWT, all scales in one batched FFT product."""
    if not rpadded:
        Wx, n_up, n1, _ = padsignal(Wx, padtype=padtype, get_params=True)
    else:
        n_up, n1 = Wx.shape[-1], 0

    norm = _icwt_norm(scaletype, l1_norm)
    pn = torch.as_tensor((-1.0) ** np.arange(n_up), dtype=Wx.real.dtype,
                         device=Wx.device)
    Psih = wavelet.sample(scales, n_up, nohalf=True, device=Wx.device) * pn
    xa = torch.fft.ifft(torch.fft.fft(Wx, dim=-1) * Psih, dim=-1)
    xa = torch.fft.ifftshift(xa, dim=-1)
    s = torch.as_tensor(scales, device=Wx.device)[:, None]
    x = (xa.real / norm(s)).sum(dim=-2)
    return x[..., n1:n1 + x_len]
