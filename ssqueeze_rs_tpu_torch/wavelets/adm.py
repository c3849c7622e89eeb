"""Synchrosqueezing admissibility constant by numeric integration (host
numpy; counterpart of ``ssqueeze_rs_tpu/wavelets/adm.py``):

    adm_ssq = int_0^inf conj(psih(w)) / w dw

`adm_cwt` (the double-integral iCWT constant) waits for ROADMAP Queue 1
item 2.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..utils.common import WARN


def _min_neglect_idx(arr, th=1e-15):
    idx = np.nonzero(arr < th)[0]
    return int(idx[0]) if len(idx) else len(arr) - 1


def integrate_analytic(int_fn, nowarn=False):
    """Trapezoidal integral of an analytic-decaying unimodal fn over (0, inf)."""
    def _est_arr(mxlim, N):
        t = np.linspace(mxlim, 0.1, N, endpoint=False)[::-1].copy()
        arr = int_fn(t)
        max_idx = np.argmax(arr)
        min_neglect_idx = _min_neglect_idx(np.abs(arr[max_idx:]),
                                           th=1e-15) + max_idx
        return arr, t, min_neglect_idx

    def _integrate_near_zero():
        t = np.logspace(-15, -1, 1000)
        return np.trapezoid(int_fn(t), t)

    int_nz = _integrate_near_zero()

    mxlims = [1, 20, 80, 160]
    for m, mxlim in zip([1, 1, 4, 8], mxlims):
        arr, t, min_neglect_idx = _est_arr(mxlim, N=10000 * m)
        if ((len(t) - min_neglect_idx > 1000 * m) and
                np.sum(np.abs(arr)) > 1e-5):
            break
    else:
        if abs(int_nz) < 1e-5:
            raise Exception("Could not find converging or non-negligibly"
                            "-valued bounds of integration for `int_fn`")
        elif not nowarn:
            WARN("Integrated only from 1e-15 to 0.1 in logspace")
    arr, t = arr[:min_neglect_idx], t[:min_neglect_idx]
    return np.trapezoid(arr, t) + int_nz


def adm_ssq(wavelet):
    """Synchrosqueezing admissibility: int conj(psih(w))/w dw, w=0..inf.
    Accepts str / (str, dict) / Wavelet specs."""
    from .base import Wavelet
    return _adm_ssq_cached(Wavelet.build(wavelet))


@lru_cache(maxsize=256)
def _adm_ssq_cached(wavelet):
    Css = integrate_analytic(lambda w: np.conj(np.asarray(wavelet(w))) / w)
    return float(Css.real) if abs(np.imag(Css)) < 1e-15 else complex(Css)
