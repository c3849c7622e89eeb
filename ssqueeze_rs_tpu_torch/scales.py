"""Scale planning for the CWT family (counterpart of
``ssqueeze_rs_tpu/scales.py``): grid construction, bounds heuristics and
scale<->type introspection.

All of this is host-side numpy that runs once per (wavelet, N, preset)
and is cached; it reproduces the JAX package's grids bit for bit, which
the port's parity tests hold it to.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from .config import DEFAULTS
from .utils.common import WARN, assert_is_one_of
from .utils.pad import p2up
from .wavelets.base import Wavelet
from .wavelets.props import (find_maximum, find_first_occurrence,
                             center_frequency)

pi = np.pi


# -- small shared helpers -----------------------------------------------------
def _geom_grid(pow_lo, pow_hi, nv):
    """Geometric grid 2^(p/nv) for p in [pow_lo, pow_hi) — the canonical
    log-scale lattice (nv voices per octave)."""
    return 2 ** (np.arange(pow_lo, pow_hi) / nv)


def _log_curvature(a):
    """|d²/di² log a_i| — zero on a geometric grid; the discontinuity
    detector behind both introspection functions below."""
    return np.abs(np.diff(np.log(a), 2, axis=0))


def _as_column(scales):
    return np.asarray(scales).reshape(-1, 1)


# -- top-level planning API ---------------------------------------------------
def process_scales(scales, N, wavelet=None, nv=None, get_params=False,
                   use_padded_N=True):
    """Resolve a scales SPEC into a concrete grid.

    `scales` may be a name ('log' / 'log-piecewise' / 'linear', with an
    optional ':preset' suffix) — then a grid is built from the wavelet's
    scale bounds — or an explicit 1D array, which is validated and
    introspected. Returns the (na, 1) column, or with ``get_params``
    the tuple (scales, scaletype, na, nv).
    (behavior: cwt_utils.py:196-261)
    """
    preset = None
    if isinstance(scales, str):
        if ":" in scales:
            scales, preset = scales.split(":")
        elif scales == "log-piecewise":
            preset = "maximal"
        assert_is_one_of(scales, "scales", ("log", "log-piecewise", "linear"))
        if nv is None:
            nv = 32
        # validate + int-ify BEFORE the grid is built (reference
        # _assert_positive_integer, cwt_utils.py:196-261): a fractional
        # nv would lattice at nv but normalize downstream at int(nv)
        if not float(nv).is_integer() or nv <= 0:
            raise ValueError(f"`nv` must be a positive integer (got {nv})")
        nv = int(nv)
        if wavelet is None:
            raise ValueError("must set `wavelet` if `scales` isn't array")
        scaletype = scales
        wavelet = Wavelet.build(wavelet)
        lo, hi = cwt_scalebounds(wavelet, N=N, preset=preset,
                                 use_padded_N=use_padded_N)
        scales = make_scales(N, lo, hi, nv=nv, scaletype=scaletype,
                             wavelet=wavelet)
        return (scales if not get_params else
                (scales, scaletype, len(scales), nv))

    scales = np.asarray(scales)
    if scales.squeeze().ndim != 1:
        raise ValueError("`scales`, if array, must be 1D "
                         f"(got shape {scales.shape})")
    scaletype, nv_inferred = infer_scaletype(scales)
    if scaletype == "log":
        if nv is not None and nv_inferred != nv:
            raise Exception(f"`nv` used in `scales` differs from `nv` passed "
                            f"({nv_inferred} != {nv})")
        nv = nv_inferred
    elif scaletype == "log-piecewise":
        nv = nv_inferred
    scales = _as_column(scales)
    return (scales if not get_params else
            (scales, scaletype, len(scales), nv))


def make_scales(N, min_scale=None, max_scale=None, nv=32, scaletype="log",
                wavelet=None, downsample=None):
    """Build a scales column for the requested scaletype.

    log: the geometric lattice snapped to integer powers of 2^(1/nv)
    (floor at min_scale, ceil(nv*octaves) points). log-piecewise: the
    same lattice, with the redundant large-scale tail thinned by
    `downsample` (the tail start found spectrally — see
    find_downsampling_scale). linear: ceil(hi/lo) evenly spaced points
    over the snapped endpoints. (behavior: cwt_utils.py:301-372)
    """
    if scaletype == "log-piecewise" and wavelet is None:
        raise ValueError("must pass `wavelet` for `scaletype == 'log-piecewise'`")
    if min_scale is None and max_scale is None and wavelet is not None:
        min_scale, max_scale = cwt_scalebounds(wavelet, N, use_padded_N=True)
    else:
        min_scale = min_scale or 1
        max_scale = max_scale or N
    downsample = int(DEFAULTS["make_scales"]["downsample"]
                     if downsample is None else downsample)

    # snap to the 2^(1/nv) lattice: pow_lo = floor-power of min_scale,
    # na = ceil(voices spanning the octave range)
    na = int(np.ceil(nv * np.log2(max_scale / min_scale)))
    pow_lo = int(np.floor(nv * np.log2(min_scale)))
    pow_hi = pow_lo + na

    if scaletype == "log":
        scales = _geom_grid(pow_lo, pow_hi, nv)
    elif scaletype == "log-piecewise":
        scales = _geom_grid(pow_lo, pow_hi, nv)
        tail = find_downsampling_scale(wavelet, scales)
        if tail is not None:
            # keep [0, tail); thin the rest so the first kept tail point
            # is `downsample` lattice steps past the last dense point
            scales = np.hstack([scales[:tail],
                                scales[tail + downsample - 1::downsample]])
    elif scaletype == "linear":
        lo, hi = 2 ** (pow_lo / nv), 2 ** (pow_hi / nv)
        na = int(np.ceil(hi / lo))
        scales = np.linspace(lo, hi, na)
    else:
        raise ValueError(f"`scaletype` must be 'log', 'log-piecewise' or "
                         f"'linear'; got: {scaletype}")
    return scales.reshape(-1, 1)


def process_fs_and_t(fs, t, N):
    """(dt, fs, t) from a sampling rate or a uniform time vector; `t`
    wins when both are given. (behavior: cwt_utils.py:698-718)"""
    if fs is not None and t is not None:
        WARN("`t` will override `fs` (both were passed)")
    if t is not None:
        t = np.asarray(t)
        if len(t) != N:
            raise Exception(f"`t` must be of same length as `x` "
                            f"({len(t)} != {N})")
        elif not np.mean(np.abs(np.diff(t, 2, axis=0))) < 1e-7:
            raise Exception("Time vector `t` must be uniformly sampled.")
        fs = 1 / (t[1] - t[0])
    else:
        if fs is None:
            fs = 1
        elif fs <= 0:
            raise ValueError("`fs` must be > 0")
    return 1 / fs, fs, t


# -- introspection: array -> (scaletype, nv) ----------------------------------
def infer_scaletype(scales):
    """Classify a scales array as 'log' / 'linear' / 'log-piecewise'.

    A geometric grid has zero log-curvature, a linear grid zero plain
    curvature; thresholds are dtype-scaled (the f32 lattice carries
    ~8e-7 of rounding). Anything else must show a clean log-piecewise
    transition or is rejected. Returns (scaletype, nv) — nv is None for
    linear, a per-scale column for log-piecewise.
    (behavior incl. threshold constants: cwt_utils.py:264-298)
    """
    scales = _as_column(scales)
    if scales.dtype not in (np.float32, np.float64):
        raise TypeError("`scales.dtype` must be float32 or float64 "
                        f"(got {scales.dtype})")
    tol_log = 4e-15 if scales.dtype == np.float64 else 8e-7
    tol_lin = tol_log * 1e3

    if np.mean(_log_curvature(scales)) < tol_log:
        nv = int(np.round(1 / np.diff(np.log2(scales), axis=0)[0].squeeze()))
        return "log", nv
    if np.mean(np.abs(np.diff(scales, 2, axis=0))) < tol_lin:
        return "linear", None
    if logscale_transition_idx(scales) is None:
        raise ValueError("could not infer `scaletype` from `scales`; must be "
                         "linear or exponential")
    return "log-piecewise", nv_from_scales(scales)


def logscale_transition_idx(scales):
    """Index where a log-piecewise grid switches lattice step, or None.

    The candidate is the largest log-curvature point; it qualifies only
    if it dominates the mean 100x AND the rest of the curve is flat to
    the dtype tolerance (both segments geometric).
    (behavior: cwt_utils.py:375-394)
    """
    curv = _log_curvature(_as_column(scales))
    idx = int(np.argmax(curv)) + 2
    peak = curv.max()
    curv[idx - 2] = 0
    tol = 1e-14 if np.asarray(scales).dtype == np.float64 else 1e-6

    if not np.any(peak > 100 * np.abs(curv).mean()):
        return None
    elif not np.all(np.abs(curv) < tol):
        return None
    return idx


def nv_from_scales(scales):
    """Per-scale voices-per-octave column (constant for 'log'; two-level
    for log-piecewise — first entry replicated so the length matches).
    (behavior: cwt_utils.py:397-409)"""
    step = np.diff(np.log2(_as_column(scales)), axis=0)
    voices = 1 / step
    return np.vstack([voices[:1], voices])


# -- bounds heuristics: wavelet -> (min_scale, max_scale) ---------------------
def cwt_scalebounds(wavelet, N, preset=None, min_cutoff=None,
                    max_cutoff=None, cutoff=None, bin_loc=None, bin_amp=None,
                    use_padded_N=True):
    """(min_scale, max_scale) over which `wavelet` is well-behaved for a
    length-N transform. Accepts str / (str, dict) / Wavelet specs;
    results cached per frozen Wavelet. (behavior: cwt_utils.py:66-188)"""
    from .wavelets.base import Wavelet
    # user-facing argument-conflict warning lives OUTSIDE the cache
    # (inside it fires only on the first call per arg combination)
    if preset is not None and any(v is not None for v in
                                  (min_cutoff, max_cutoff, cutoff)):
        WARN("`preset` will override `min_cutoff, max_cutoff, cutoff`")
    return _scalebounds_cached(Wavelet.build(wavelet), N, preset,
                               min_cutoff, max_cutoff, cutoff, bin_loc,
                               bin_amp, use_padded_N)


_BOUND_DEFAULTS = dict(min_cutoff=0.6, max_cutoff=0.8, cutoff=-0.5)


@lru_cache(maxsize=1024)
def _scalebounds_cached(wavelet, N, preset=None, min_cutoff=None,
                        max_cutoff=None, cutoff=None, bin_loc=None,
                        bin_amp=None, use_padded_N=True):
    if preset is not None:
        assert_is_one_of(preset, "preset", ("maximal", "minimal", "naive"))
        if preset in ("naive", "maximal"):
            min_cutoff, max_cutoff = None, None
            if preset == "maximal":
                cutoff = -0.5
        else:
            min_cutoff, max_cutoff, cutoff = _BOUND_DEFAULTS.values()
    else:
        if min_cutoff is None:
            min_cutoff = _BOUND_DEFAULTS["min_cutoff"]
        elif min_cutoff <= 0:
            raise ValueError(f"`min_cutoff` must be >0 (got {min_cutoff})")
        if max_cutoff is None:
            max_cutoff = _BOUND_DEFAULTS["max_cutoff"]
        elif max_cutoff < min_cutoff:
            raise ValueError("must have `max_cutoff > min_cutoff` "
                             f"(got {max_cutoff}, {min_cutoff})")

    bin_loc = bin_loc or (2 if preset == "maximal" else None)
    bin_amp = bin_amp or (1 if preset == "maximal" else None)
    cutoff = cutoff if (cutoff is not None) else _BOUND_DEFAULTS["cutoff"]

    if preset == "naive":
        return 1, N

    M = p2up(N)[0] if use_padded_N else N
    lo = find_min_scale(wavelet, cutoff=cutoff)
    if preset in ("minimal", None):
        hi = find_max_scale_alt(wavelet, M, min_cutoff=min_cutoff,
                                max_cutoff=max_cutoff)
    else:
        hi = find_max_scale(wavelet, M, bin_loc=bin_loc, bin_amp=bin_amp)
    return lo, hi


def find_min_scale(wavelet, cutoff=1):
    """Smallest well-behaved scale: where the freq-domain wavelet decays
    to |cutoff| of its peak on the highest bin. cutoff > 0 searches past
    the peak (right tail), cutoff < 0 before it.
    (behavior: cwt_utils.py:412-431)"""
    w_peak, peak = find_maximum(wavelet)
    if cutoff > 0:
        search = (w_peak, 10 * w_peak)
    else:
        search = (0, w_peak)
    w_cutoff, _ = find_first_occurrence(wavelet, value=abs(cutoff) * peak,
                                        step_start=search[0],
                                        step_limit=search[1])
    return w_cutoff / pi


def find_max_scale(wavelet, N, bin_loc=1, bin_amp=1):
    """'maximal'-preset max scale: place the wavelet so its amplitude at
    DFT bin `bin_loc` is `bin_amp` of max, starting from the
    time-domain-centered scale 4/pi * wc_ct.
    (behavior: cwt_utils.py:434-456)"""
    from .utils.fft import xifn

    wc_ct = center_frequency(wavelet, kind="peak-ct", N=N)
    scale_ct = (4 / pi) * wc_ct

    psih = np.asarray(wavelet(scale_ct * xifn(1, N)))[:N // 2 + 1]
    xi = xifn(scale_ct, N)
    peak_idx = np.argmax(psih)
    w_bin = xi[np.where(psih[:peak_idx] < psih.max() * bin_amp)[0][-1]]
    return scale_ct * (w_bin / xi[bin_loc])


def find_max_scale_alt(wavelet, N, min_cutoff=0.1, max_cutoff=0.8):
    """'minimal'-preset max scale via the symmetric-bin-division search:
    walk the left tail from the min_cutoff crossing toward the peak and
    take the first near-integer division of the frequency axis.
    (behavior: cwt_utils.py:630-695)"""
    if max_cutoff <= 0 or min_cutoff <= 0:
        raise ValueError("`max_cutoff` and `min_cutoff` must be positive "
                         f"(got {max_cutoff}, {min_cutoff})")
    elif max_cutoff <= min_cutoff:
        raise ValueError("must have `max_cutoff > min_cutoff` "
                         f"(got {max_cutoff}, {min_cutoff})")

    w_peak, peak = find_maximum(wavelet)
    w_cutoff, _ = find_first_occurrence(wavelet, value=min_cutoff * peak,
                                        step_start=0, step_limit=w_peak)
    w_ltp = np.arange(w_cutoff, w_peak, step=1 / N)

    div_size = (w_peak - w_ltp[:-1]) * 2
    n_divs = w_ltp[:-1] / div_size
    try:
        idx = np.where(np.diff(n_divs % 1) < -0.8)[0][0]
    except IndexError:
        raise Exception("Failed to find sufficiently-integer xi divisions; "
                        "try widening (min_cutoff, max_cutoff)")
    div_scale = div_size[idx + 1]
    w_1div = pi / (N / 2)
    return div_scale / w_1div


# -- spectral redundancy detector (log-piecewise tail start) ------------------
def find_downsampling_scale(wavelet, scales, span=5, tol=3, method="sum",
                            nonzero_th=0.02, nonzero_tol=4.0, N=None):
    """First scale index past which adjacent freq-domain wavelets are
    excessively redundant (their peaks cluster within `tol` bins over a
    `span`-row window) — where log-piecewise thinning starts. Returns
    None when no window qualifies. (behavior: cwt_utils.py:459-580)"""
    scales = np.asarray(scales).squeeze()
    if isinstance(wavelet, Wavelet):
        return _downsampling_scale_cached(
            wavelet, tuple(scales.tolist()), span, tol, method, nonzero_th,
            nonzero_tol, N)
    return _find_downsampling_scale(wavelet, scales, span, tol, method,
                                    nonzero_th, nonzero_tol, N)


@lru_cache(maxsize=1024)
def _downsampling_scale_cached(wavelet, scales_key, span, tol, method,
                               nonzero_th, nonzero_tol, N):
    return _find_downsampling_scale(wavelet, np.asarray(scales_key), span,
                                    tol, method, nonzero_th, nonzero_tol, N)


def _find_downsampling_scale(wavelet, scales, span, tol, method, nonzero_th,
                             nonzero_tol, N):
    assert_is_one_of(method, "method", ("any", "all", "sum"))
    N = N or 2048
    if isinstance(wavelet, np.ndarray):
        Psih = wavelet
    else:
        Psih = np.asarray(wavelet.sample(scales, N, nohalf=True))
    if len(Psih) != len(scales):
        raise ValueError(f"len(Psih) != len(scales) "
                         f"({len(Psih)} != {len(scales)})")

    Psih = Psih[:, :Psih.shape[1] // 2]     # positive-frequency half
    n_groups = len(Psih) - span - 1

    i = 0
    for i in range(n_groups):
        group = Psih[i:i + span]
        # sparsity gate: rows must be narrow enough for peak distance
        # to be meaningful
        support = group > nonzero_th * group.max(axis=1)[:, None]
        if support.sum() / span > nonzero_tol:
            continue

        row_peaks = np.where(group == group.max(axis=1)[:, None])
        joint_peak = np.argmax(np.prod(group, 0))
        spread = np.abs(row_peaks[1] - joint_peak)

        clustered = (
            (method == "any" and spread.max() < tol) or
            (method == "all" and not np.all(spread > tol)) or
            (method == "sum" and spread.sum() < tol))
        if clustered:
            break
    return i if (i < n_groups - 1) else None
