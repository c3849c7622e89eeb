"""Synchrosqueezing engine: reassignment planning and the squeeze
(counterpart of ``ssqueeze_rs_tpu/ops/ssqueeze.py``).

The frequency bin of each phase value is computed in closed form per
scaletype (log / log-piecewise / linear); the ssq frequency grid, the
per-row normalization constants and the bin constants are host numpy
planning. The scatter itself is kernel B (`reassign_cuda.reassign`, from
a phase plane) or B' (`reassign_cuda.reassign4`, from Wx and dWx).

Normalization constants:
  CWT log:    const = ln(2)/nv          (per-row array for log-piecewise)
  CWT linear: const = (s1 - s0)/scales  (per-row)
  STFT:       const = dssq_freq
"""
from __future__ import annotations

from types import FunctionType

import numpy as np
import torch

from ..config import EPS64
from ..scales import (process_scales, process_fs_and_t, infer_scaletype,
                      logscale_transition_idx)
from ..utils.common import WARN, NOTE, assert_is_one_of, unported
from ..utils.pad import p2up
from ..wavelets.base import Wavelet
from ..wavelets.props import center_frequency
from .reassign_cuda import reassign, reassign4

__all__ = ["bin_params", "plan_reassignment", "plan_ssqueeze", "ssqueeze",
           "compute_associated_frequencies", "ssq_freqrange",
           "check_ssqueezing_args"]


# -- binning parameter planning (host) ------------------------------------------
def _ensure_nonzero(name, x, silent=False):
    if x < EPS64:
        if not silent:
            WARN(f"computed `{name}` ({x:.2e}) is below EPS64; will set to "
                 "EPS64. Advised to check `ssq_freqs`.")
        x = EPS64
    return x


def bin_params(ssq_freqs, logscale: bool):
    """Closed-form bin-mapping constants: (mode, params)."""
    v = np.asarray(ssq_freqs).squeeze()
    if logscale:
        idx = logscale_transition_idx(v)
        vlmin = float(np.log2(v[0]))
        if idx is None:
            dvl = _ensure_nonzero("dvl", float(np.log2(v[1]) - np.log2(v[0])))
            return "log", dict(vlmin=vlmin, dvl=dvl)
        vlmin0, vlmin1 = vlmin, float(np.log2(v[idx - 1]))
        dvl0 = _ensure_nonzero("dvl0", float(np.log2(v[1]) - np.log2(v[0])),
                               silent=True)
        dvl1 = _ensure_nonzero("dvl1", float(np.log2(v[idx]) -
                                             np.log2(v[idx - 1])))
        return "log-piecewise", dict(vlmin0=vlmin0, vlmin1=vlmin1, dvl0=dvl0,
                                     dvl1=dvl1, idx1=idx - 1)
    dv = _ensure_nonzero("dv", float(v[1] - v[0]))
    return "lin", dict(vmin=float(v[0]), dv=dv)


def plan_reassignment(ssq_freqs, na, ssq_logscale, *, transform="cwt",
                      cwt_scaletype=None, nv=None, scales=None):
    """The normalization constant per scale row and the analytic
    bin-mapping plan. Returns (const_arr (na,) float64, mode, params)."""
    if transform == "cwt":
        if cwt_scaletype[:3] == "log":
            const = np.log(2) / nv
        else:
            const = ((scales[1] - scales[0]) / scales).squeeze()
    else:
        const = float(np.asarray(ssq_freqs)[1] - np.asarray(ssq_freqs)[0])
    const_arr = np.broadcast_to(
        np.asarray(const, dtype=np.float64).squeeze(), (na,)).copy()
    mode, params_host = bin_params(ssq_freqs, ssq_logscale)
    return const_arr, mode, params_host


# -- associated frequencies (host planning) -------------------------------------
def _get_center_frequency(wavelet, N, maprange, dt, scale, was_padded):
    if was_padded:
        N = p2up(N)[0]
    kw = dict(scale=float(np.asarray(scale).squeeze()), N=N, kind=maprange)
    if maprange == "energy":
        kw["force_int"] = True
    wc = center_frequency(wavelet, **kw)
    return wc / (2 * np.pi) / dt


def ssq_freqrange(maprange, dt, N, wavelet, scales, was_padded):
    """(fm, fM) frequency range per maprange."""
    if isinstance(maprange, tuple):
        fm, fM = maprange
    elif maprange == "maximal":
        dT = dt * N
        fm = 1 / dT
        fM = 1 / (2 * dt)
    elif maprange in ("peak", "energy"):
        kw = dict(wavelet=wavelet, N=N, maprange=maprange, dt=dt,
                  was_padded=was_padded)
        fm = _get_center_frequency(**kw, scale=scales[-1])
        fM = _get_center_frequency(**kw, scale=scales[0])
    return fm, fM


def _exp_fm(t, fmin, fmax):
    tmin, tmax = t.min(), t.max()
    a = (fmin**tmax / fmax**tmin) ** (1 / (tmax - tmin))
    b = fmax ** (1 / tmax) * (1 / a) ** (1 / tmax)
    return a * b**t


def compute_associated_frequencies(scales, N, wavelet, ssq_scaletype,
                                   maprange, was_padded=True, dt=1,
                                   transform="cwt"):
    """The ssq frequency grid."""
    fm, fM = ssq_freqrange(maprange, dt, N, wavelet, scales, was_padded)
    na = len(scales)

    if ssq_scaletype == "log":
        return fm * np.power(fM / fm, np.arange(na) / (na - 1))
    elif ssq_scaletype == "log-piecewise":
        idx = logscale_transition_idx(scales)
        if idx is None:
            return fm * np.power(fM / fm, np.arange(na) / (na - 1))
        f0, f2 = fm, fM
        f1 = _get_center_frequency(wavelet, N, maprange, dt, scales[idx],
                                   was_padded)
        t1 = np.arange(0, na - idx - 1) / (na - 1)
        t2 = np.arange(na - idx - 1, na) / (na - 1)
        t1 = np.hstack([t1, t2[0]])
        sqf1 = _exp_fm(t1, f0, f1)[:-1]
        sqf2 = _exp_fm(t2, f1, f2)
        ssq_freqs = np.hstack([sqf1, sqf2])
        ssq_idx = logscale_transition_idx(ssq_freqs)
        if ssq_idx is None:
            raise Exception("couldn't find logscale transition index of "
                            "generated `ssq_freqs`")
        assert (na - ssq_idx) == idx, f"{na - ssq_idx} != {idx}"
        return ssq_freqs
    else:
        if transform == "cwt":
            return np.linspace(fm, fM, na)
        return np.linspace(0, 0.5, na) / dt


# -- argument checking (host) ---------------------------------------------------
def check_ssqueezing_args(squeezing, maprange=None, wavelet=None,
                          difftype=None, difforder=None, get_w=None,
                          transform="cwt"):
    """Validate the squeezing arguments; returns the difference order."""
    if transform not in ("cwt", "stft"):
        raise ValueError(f"`transform` must be one of: cwt, stft (got "
                         f"{transform})")
    if not isinstance(squeezing, (str, FunctionType)):
        raise TypeError(f"`squeezing` must be string or function "
                        f"(got {type(squeezing)})")
    if isinstance(squeezing, str):
        assert_is_one_of(squeezing, "squeezing", ("sum", "lebesgue", "abs"))

    if maprange is not None:
        if isinstance(maprange, (tuple, list)):
            if not all(isinstance(m, (float, int)) for m in maprange):
                raise ValueError("all elements of `maprange` must be float "
                                 "or int")
        elif isinstance(maprange, str):
            assert_is_one_of(maprange, "maprange",
                             ("maximal", "peak", "energy"))
        else:
            raise TypeError(f"`maprange` must be str, tuple, or list "
                            f"(got {type(maprange)})")
        if isinstance(maprange, str) and maprange != "maximal":
            if transform != "cwt":
                NOTE("string `maprange` currently only functional with "
                     "`transform='cwt'`")
            elif wavelet is None:
                raise ValueError(f"maprange='{maprange}' requires `wavelet`")

    if difftype is not None:
        if difftype not in ("trig", "phase", "numeric"):
            raise ValueError("`difftype` must be one of: trig, phase, numeric"
                             f" (got {difftype})")
        elif difftype != "trig" and not get_w:
            raise ValueError("`difftype != 'trig'` requires `get_w = True`")

    if difforder is not None:
        if difftype != "numeric":
            WARN("`difforder` is ignored if `difftype != 'numeric'`")
        elif difforder not in (1, 2, 4):
            raise ValueError(f"`difforder` must be one of: 1, 2, 4 "
                             f"(got {difforder})")
    elif difftype == "numeric":
        difforder = 4
    return difforder


# -- public engine --------------------------------------------------------------
def plan_ssqueeze(N, na, ssq_freqs, scales, fs=None, t=None,
                  maprange="maximal", wavelet=None, was_padded=True,
                  transform="cwt"):
    """Host planning of a squeeze of na rows of N columns: (ssq_freqs,
    const_arr, mode, params) for `reassign` / `reassign4`, ssq_freqs in
    ascending (unflipped) order. `ssq_freqs`: an array, a scaletype name,
    or None (the CWT's own scaletype; for the STFT, linear)."""
    if scales is None and transform == "cwt":
        raise ValueError("`scales` can't be None if `transform == 'cwt'`")
    dt, _, _ = process_fs_and_t(fs, t, N)
    if transform == "cwt":
        scales, cwt_scaletype, _, nv = process_scales(scales, N,
                                                      get_params=True)
    else:
        cwt_scaletype, nv = None, None

    if not isinstance(ssq_freqs, (np.ndarray, torch.Tensor)):
        ssq_scaletype = (ssq_freqs if isinstance(ssq_freqs, str)
                         else cwt_scaletype)
        if ((maprange == "maximal" or isinstance(maprange, tuple)) and
                ssq_scaletype == "log-piecewise"):
            raise ValueError("can't have `ssq_scaletype = log-piecewise` or "
                             "tuple with `maprange = 'maximal'` "
                             f"(got {maprange})")
        wavelet_b = Wavelet.build(wavelet) if wavelet is not None else None
        ssq_freqs = compute_associated_frequencies(
            scales, N, wavelet_b, ssq_scaletype, maprange, was_padded, dt,
            transform)
    elif transform == "stft":
        ssq_scaletype = "linear"
        ssq_freqs = np.asarray(ssq_freqs)
    else:
        ssq_freqs = np.asarray(ssq_freqs)
        ssq_scaletype, _ = infer_scaletype(ssq_freqs)

    const_arr, mode, params = plan_reassignment(
        ssq_freqs, na, ssq_scaletype.startswith("log"), transform=transform,
        cwt_scaletype=cwt_scaletype, nv=nv, scales=scales)
    return ssq_freqs, const_arr, mode, params


def _planes(Wx):
    """(real, imag) float32 planes of a complex or real tensor."""
    if Wx.is_complex():
        return Wx.real, Wx.imag
    return Wx, torch.zeros_like(Wx)


def ssqueeze(Wx, w=None, ssq_freqs=None, scales=None, Sfs=None, fs=None,
             t=None, squeezing="sum", maprange="maximal", wavelet=None,
             gamma=None, was_padded=True, flipud=False, dWx=None,
             transform="cwt", wx_planes=None, w_plane=None):
    """Synchrosqueeze a CWT or STFT. Returns (Tx complex64 (..., nf, n),
    ssq_freqs).

    Wx: complex64 (..., na, n) tensor or array; the scatter runs on its
    device. Routes, by what is given:
      * `w_plane` (phase already computed in kernel A, +inf where masked)
        or `w` (a phase transform, +inf where masked): kernel B, the
        3-plane contract (`reassign_cuda.reassign`);
      * else `dWx` (complex, or a (real, imag) plane tuple) with `gamma`:
        kernel B' forms w and the mask |Wx|^2 > gamma^2 itself, for
        `transform` 'cwt' or 'stft' (`reassign_cuda.reassign4`).
    `wx_planes`: (real, imag) planes of Wx to feed the kernel directly
    (used with squeezing='sum' only). With squeezing 'lebesgue', 'abs' or
    a callable and no `w`, the phase comes from the TRANSFORMED Wx, as in
    the reference's fused ssqueeze."""
    if w is None and w_plane is None and (dWx is None or gamma is None):
        raise ValueError("if `w` is None, `dWx` and `gamma` must not be.")
    if isinstance(w, np.ndarray) and (w < 0).any():
        raise ValueError("found negatives in `w`")
    check_ssqueezing_args(squeezing, maprange, transform=transform,
                          wavelet=wavelet)

    Wx = Wx if isinstance(Wx, torch.Tensor) else torch.as_tensor(
        np.asarray(Wx))
    if Wx.dtype in (torch.complex128, torch.float64):
        unported("float64 / complex128 Wx", "Queue 1 item 3, float64 route")
    device = Wx.device
    ssq_freqs, const_arr, mode, params = plan_ssqueeze(
        Wx.shape[-1], Wx.shape[-2], ssq_freqs, scales, fs, t, maprange,
        wavelet, was_padded, transform)

    # squeezing transform of Wx
    if isinstance(squeezing, FunctionType):
        Wx = squeezing(Wx)
    elif squeezing == "lebesgue":
        # normalized by the scale count (shape[-2]) for any batch shape
        Wx = torch.ones(Wx.shape, dtype=Wx.dtype, device=device) / Wx.shape[-2]
    elif squeezing == "abs":
        Wx = Wx.abs().to(Wx.dtype)

    const = torch.as_tensor(const_arr, dtype=torch.float32, device=device)
    nf = len(ssq_freqs)
    wr, wi = (wx_planes if (wx_planes is not None and squeezing == "sum")
              else _planes(Wx))
    phase = w_plane if w_plane is not None else w
    if phase is not None:
        txr, txi = reassign(wr, wi, phase, const, params, mode, flipud, nf)
    else:
        dr, di = dWx if isinstance(dWx, tuple) else _planes(
            dWx if isinstance(dWx, torch.Tensor) else
            torch.as_tensor(np.asarray(dWx), device=device))
        if Sfs is None:
            Sfs = np.zeros(len(const_arr), np.float32)
        txr, txi = reassign4(wr, wi, dr, di, const, Sfs, gamma, params,
                             mode, flipud, nf, transform)

    # `scales` go high -> low: the CWT frequency grid is reported reversed
    if (transform == "cwt" and not flipud) or flipud:
        ssq_freqs = ssq_freqs[::-1]
    return torch.complex(txr, txi), ssq_freqs
