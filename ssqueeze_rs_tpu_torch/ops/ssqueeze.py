"""Synchrosqueezing engine: reassignment planning and the w-plane route
(counterpart of ``ssqueeze_rs_tpu/ops/ssqueeze.py``).

The frequency bin of each phase value is computed in closed form per
scaletype (log / log-piecewise / linear); the ssq frequency grid, the
per-row normalization constants and the bin constants are host numpy
planning. The scatter itself is kernel B (`reassign_cuda.reassign`).

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
from ..utils.common import WARN, NOTE, assert_is_one_of
from ..utils.pad import p2up
from ..wavelets.base import Wavelet
from ..wavelets.props import center_frequency
from .reassign_cuda import reassign

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
                  maprange="maximal", wavelet=None, was_padded=True):
    """Host planning of a CWT squeeze: (ssq_freqs, const_arr, mode, params)
    for `reassign`, ssq_freqs in ascending (unflipped) order."""
    check_ssqueezing_args("sum", maprange, transform="cwt", wavelet=wavelet)
    if scales is None:
        raise ValueError("`scales` can't be None if `transform == 'cwt'`")
    dt, _, _ = process_fs_and_t(fs, t, N)
    scales, cwt_scaletype, _, nv = process_scales(scales, N, get_params=True)

    if not isinstance(ssq_freqs, np.ndarray):
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
            "cwt")
    else:
        ssq_scaletype, _ = infer_scaletype(ssq_freqs)

    const_arr, mode, params = plan_reassignment(
        ssq_freqs, na, ssq_scaletype.startswith("log"), transform="cwt",
        cwt_scaletype=cwt_scaletype, nv=nv, scales=scales)
    return ssq_freqs, const_arr, mode, params


def ssqueeze(Wx_planes, w_plane, ssq_freqs=None, scales=None, fs=None, t=None,
             maprange="maximal", wavelet=None, was_padded=True, flipud=False):
    """Synchrosqueeze a CWT given as f32 planes with its phase plane
    already computed (the w-plane route of the JAX package's `ssqueeze`).

    Wx_planes: (Wxr, Wxi), each (..., na, n); w_plane: (..., na, n), +inf
    where masked. Returns (Tx complex64 (..., nf, n), ssq_freqs).
    The other squeezing routes (`w`, `dWx`, 'lebesgue'/'abs'/callable
    squeezing, STFT) wait for ROADMAP Queue 1 item 3."""
    wr, wi = Wx_planes
    ssq_freqs, const_arr, mode, params = plan_ssqueeze(
        wr.shape[-1], wr.shape[-2], ssq_freqs, scales, fs, t, maprange,
        wavelet, was_padded)
    const = torch.as_tensor(const_arr, dtype=torch.float32, device=wr.device)
    txr, txi = reassign(wr, wi, w_plane, const, params, mode, flipud,
                        len(ssq_freqs))
    # `scales` go high -> low: the frequency grid is reported reversed
    return torch.complex(txr, txi), ssq_freqs[::-1]
