"""Wavelet center frequency and the 1D searches behind it (host numpy;
counterpart of ``ssqueeze_rs_tpu/wavelets/props.py``). Results are cached
per (wavelet, scale, N, kind) since Wavelet is hashable. The frequency
resolution waits for ROADMAP Queue 1 item 2."""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..utils.common import NOTE, assert_is_one_of
from ..utils.fft import xifn, aifftshift_idx

pi = np.pi


def find_maximum(fn, step_size=1e-3, steps_per_search=10000, step_start=0,
                 step_limit=1000, min_value=-1):
    """Max of a unimodal 1D function and its argmax."""
    steps_per_search = int(steps_per_search)
    largest_max = min_value
    input_value = None
    increment = int(steps_per_search * step_size)

    search_idx = 0
    while True:
        start = step_start + increment * search_idx
        end = start + increment
        input_values = np.linspace(start, end, steps_per_search, endpoint=False)
        output_values = np.abs(np.asarray(fn(input_values)))

        output_max = output_values.max()
        if output_max > largest_max:
            largest_max = output_max
            input_value = input_values[np.argmax(output_values)]
        elif output_max < largest_max:
            break
        search_idx += 1
        if input_values.max() > step_limit:
            raise ValueError(
                "could not find function maximum with given "
                f"(step_size, steps_per_search, step_start, step_limit, "
                f"min_value)=({step_size}, {steps_per_search}, {step_start}, "
                f"{step_limit}, {min_value})")
    return input_value, largest_max


def find_first_occurrence(fn, value, step_size=1e-3, steps_per_search=10000,
                          step_start=0, step_limit=1000):
    """Earliest input for which |fn| == value."""
    steps_per_search = int(steps_per_search)
    increment = int(steps_per_search * step_size)

    step_limit_exceeded = False
    search_idx = 0
    while True:
        start = step_start + increment * search_idx
        end = start + increment
        input_values = np.linspace(start, end, steps_per_search, endpoint=False)
        if input_values.max() > step_limit:
            step_limit_exceeded = True
            input_values = np.clip(input_values, None, step_limit)

        output_values = np.abs(np.asarray(fn(input_values)))
        mxdiff = np.abs(np.diff(output_values)).max()

        if np.any(np.abs(output_values - value) <= mxdiff):
            idx = np.argmin(np.abs(output_values - value))
            break
        search_idx += 1
        if step_limit_exceeded:
            raise ValueError(
                f"could not find input yielding output value={value}")
    return input_values[idx], output_values[idx]


def _sampled(wavelet, scale, N):
    w = xifn(1, N)[aifftshift_idx(N)]
    psih = np.asarray(wavelet(scale * w))
    return w, psih, np.abs(psih) ** 2


def center_frequency(wavelet, scale=None, N=1024, kind="energy",
                     force_int=None):
    """Radian center frequency: 'energy' | 'peak' | 'peak-ct'.
    Accepts str / (str, dict) / Wavelet specs."""
    from .base import Wavelet
    if kind == "peak-ct" and scale is not None:
        NOTE("`scale` ignored with `kind = 'peak-ct'`")
    return _center_frequency_cached(Wavelet.build(wavelet), scale, N, kind,
                                    force_int)


@lru_cache(maxsize=4096)
def _center_frequency_cached(wavelet, scale=None, N=1024, kind="energy",
                             force_int=None):
    assert_is_one_of(kind, "kind", ("energy", "peak", "peak-ct"))
    if scale is None and kind != "peak-ct":
        wc, _ = find_maximum(wavelet)
        scale = (4 / pi) * wc

    if kind == "energy":
        force_int = force_int or True
        use_formula = not force_int
        if use_formula:
            scale_orig = scale
            wc_ct, _ = find_maximum(wavelet)
            scale = (4 / pi) * wc_ct
        w, _, apsih2 = _sampled(wavelet, scale, N)
        wc = np.trapezoid(apsih2 * w) / np.trapezoid(apsih2)
        if use_formula:
            wc *= (scale / scale_orig)
        return float(wc)
    elif kind == "peak":
        w, _, apsih2 = _sampled(wavelet, scale, N)
        return float(w[np.argmax(apsih2)])
    else:  # peak-ct
        wc, _ = find_maximum(wavelet)
        return float(wc)


def time_resolution(wavelet, scale=10, N=1024, min_decay=1e3, max_mult=2,
                    min_mult=2, force_int=True, nondim=True):
    """Time std of the wavelet at `scale`. Accepts str / (str, dict) /
    Wavelet specs."""
    from .base import Wavelet
    return _time_resolution_cached(Wavelet.build(wavelet), scale, N,
                                   min_decay, max_mult, min_mult, force_int,
                                   nondim)


@lru_cache(maxsize=1024)
def _time_resolution_cached(wavelet, scale=10, N=1024, min_decay=1e3,
                            max_mult=2, min_mult=2, force_int=True,
                            nondim=True):
    use_formula = ((scale < 4 or scale > N / 5) and not force_int)
    if use_formula:
        scale_orig = scale
        scale = (4 / pi) * wavelet.wc_ct

    # the integration span: the first multiple of N over which |psi|^2
    # has decayed by min_decay at its edge (psi with the Nyquist halving)
    t = apsi2 = None
    for mult in np.arange(min_mult, max_mult + 1):
        Nt = int(mult * N)
        apsi2 = np.abs(wavelet.psi_time(scale, Nt)) ** 2
        if apsi2.max() / apsi2[:max(10, Nt // 100)].mean() > min_decay:
            T = N
            t = np.arange(-mult * T / 2, mult * T / 2, step=T / N)
            break
    if t is None:
        raise Exception(
            f"Couldn't find decay timespan satisfying (min_decay, max_mult) = "
            f"({min_decay}, {max_mult}) for scale={scale}")

    var_t = np.trapezoid(t**2 * apsi2, t) / np.trapezoid(apsi2, t)
    std_t = np.sqrt(var_t)
    if use_formula:
        std_t *= (scale_orig / scale)
        scale = scale_orig
    if nondim:
        std_t *= center_frequency(wavelet, scale, N=N, kind="peak")
    return float(std_t)
