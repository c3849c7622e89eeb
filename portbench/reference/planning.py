"""Host planning of the reference, in float64 numpy: the generalized Morse
wavelet, the 'log-piecewise' scale grid, the 'peak' ssq frequency grid,
the bin constants and the STFT's DPSS window.

These are frozen copies of the arithmetic that ssqueezepy defines
(`wavelets.py`, `utils/cwt_utils.py`, `ssqueezing.py`, `utils/stft_utils`)
and that the program under test reimplements, written out here so that the
benchmark's yardstick cannot move when the program does. Nothing here
imports the program.
"""
from __future__ import annotations

import numpy as np
import scipy.signal

PI = np.pi
EPS32 = float(np.finfo(np.float32).eps)
EPS64 = float(np.finfo(np.float64).eps)


def p2up(n):
    """(M, n1, n2): the padded length, a power of 2 nearest n in log2 (one
    octave up), and the left and right pad lengths."""
    up = int(2 ** (1 + np.round(np.log2(n))))
    n2 = (up - n) // 2
    return up, up - n - n2, n2


def xifn(scale, n):
    """Radian frequency grid scale * 2 pi k / n, k wrapped to the negative
    half past n // 2 (positive Nyquist)."""
    i = np.arange(n)
    k = np.where(i <= n // 2, i, i - n)
    return k * (2 * PI / n) * scale


class GMW:
    """Generalized Morse wavelet of order 0, bandpass (L1) normalized:
    psih(w) = 2 exp(-beta ln wc + wc^gamma + beta ln w - w^gamma), w > 0,
    with wc = (beta / gamma)^(1 / gamma)."""

    def __init__(self, gamma=3.0, beta=60.0):
        self.gamma, self.beta = float(gamma), float(beta)
        self.wc = (self.beta / self.gamma) ** (1 / self.gamma)

    def __call__(self, w, xp=np):
        g, b, wc = self.gamma, self.beta, self.wc
        wp = w * (w >= 0)
        wl = xp.log(xp.where(w > 0, wp, 1.0))
        return 2 * xp.exp(-b * np.log(wc) + wc ** g + b * wl - wp ** g) * (w > 0)


def find_maximum(fn, step_size=1e-3, steps_per_search=10000, step_start=0,
                 step_limit=1000):
    """(argmax, max) of |fn| for a unimodal fn, searched in windows of
    steps_per_search points."""
    largest, arg = -1, None
    inc = int(steps_per_search * step_size)
    i = 0
    while True:
        start = step_start + inc * i
        xs = np.linspace(start, start + inc, steps_per_search, endpoint=False)
        ys = np.abs(np.asarray(fn(xs)))
        if ys.max() > largest:
            largest, arg = ys.max(), xs[np.argmax(ys)]
        elif ys.max() < largest:
            break
        i += 1
        if xs.max() > step_limit:
            raise ValueError("no maximum found")
    return arg, largest


def find_first_occurrence(fn, value, step_size=1e-3, steps_per_search=10000,
                          step_start=0, step_limit=1000):
    """The first input (in steps) at which |fn| comes within one step's
    change of `value`, and |fn| there."""
    inc = int(steps_per_search * step_size)
    exceeded = False
    i = 0
    while True:
        start = step_start + inc * i
        xs = np.linspace(start, start + inc, steps_per_search, endpoint=False)
        if xs.max() > step_limit:
            exceeded = True
            xs = np.clip(xs, None, step_limit)
        ys = np.abs(np.asarray(fn(xs)))
        if np.any(np.abs(ys - value) <= np.abs(np.diff(ys)).max()):
            j = np.argmin(np.abs(ys - value))
            return xs[j], ys[j]
        i += 1
        if exceeded:
            raise ValueError(f"no input gives {value}")


def peak_frequency(wavelet, scale, n):
    """Radian frequency of the peak of |psih(scale * w)|^2 on the n-point
    grid."""
    i = np.arange(n)
    shift = np.concatenate([i[n // 2 + 1:], i[:n // 2 + 1]]) if n % 2 == 0 \
        else np.fft.ifftshift(i)
    w = xifn(1, n)[shift]
    return float(w[np.argmax(np.abs(wavelet(scale * w)) ** 2)])


def scale_bounds_maximal(wavelet, n):
    """(min_scale, max_scale) of the 'maximal' preset for a length-n
    signal: the half-peak point below the peak, and the scale whose peak
    sits next to DFT bin 2 of the padded length."""
    m = p2up(n)[0]
    w_peak, peak = find_maximum(wavelet)
    w_cut, _ = find_first_occurrence(wavelet, value=0.5 * peak,
                                     step_start=0, step_limit=w_peak)
    lo = w_cut / PI
    scale_ct = (4 / PI) * w_peak
    psih = np.asarray(wavelet(scale_ct * xifn(1, m)))[:m // 2 + 1]
    xi = xifn(scale_ct, m)
    k = np.argmax(psih)
    w_bin = xi[np.where(psih[:k] < psih.max())[0][-1]]
    return lo, scale_ct * (w_bin / xi[2])


def downsampling_index(wavelet, scales, span=5, tol=3, nonzero_th=0.02,
                       nonzero_tol=4.0, n=2048):
    """First row past which `span` adjacent filters peak within `tol` bins
    of each other (the 'sum' rule), or None."""
    psih = np.asarray(wavelet(scales[:, None] * xifn(1, n)[None, :]))
    psih = psih[:, :psih.shape[1] // 2]
    groups = len(psih) - span - 1
    i = 0
    for i in range(groups):
        g = psih[i:i + span]
        if (g > nonzero_th * g.max(axis=1)[:, None]).sum() / span > nonzero_tol:
            continue
        rows = np.where(g == g.max(axis=1)[:, None])
        joint = np.argmax(np.prod(g, 0))
        if np.abs(rows[1] - joint).sum() < tol:
            break
    return i if i < groups - 1 else None


def log_piecewise_scales(wavelet, n, nv=32, downsample=4):
    """The 'log-piecewise' grid: 2^(p / nv) from the floor power of the
    least scale over ceil(nv * octaves) points, the tail past
    `downsampling_index` thinned to every `downsample`-th point."""
    lo, hi = scale_bounds_maximal(wavelet, n)
    na = int(np.ceil(nv * np.log2(hi / lo)))
    p0 = int(np.floor(nv * np.log2(lo)))
    scales = 2 ** (np.arange(p0, p0 + na) / nv)
    tail = downsampling_index(wavelet, scales)
    if tail is not None:
        scales = np.hstack([scales[:tail],
                            scales[tail + downsample - 1::downsample]])
    return scales


def transition_index(v):
    """Index where a log-piecewise grid changes its step, or None."""
    curv = np.abs(np.diff(np.log(np.asarray(v).reshape(-1)), 2))
    idx = int(np.argmax(curv)) + 2
    peak = curv.max()
    curv[idx - 2] = 0
    tol = 1e-14 if np.asarray(v).dtype == np.float64 else 1e-6
    if not np.any(peak > 100 * np.abs(curv).mean()) or \
            not np.all(np.abs(curv) < tol):
        return None
    return idx


def voices(scales):
    """Voices per octave of each row: 1 / log2 step, the first repeated."""
    v = 1 / np.diff(np.log2(scales))
    return np.concatenate([v[:1], v])


def _exp_fm(t, fmin, fmax):
    tmin, tmax = t.min(), t.max()
    a = (fmin ** tmax / fmax ** tmin) ** (1 / (tmax - tmin))
    b = fmax ** (1 / tmax) * (1 / a) ** (1 / tmax)
    return a * b ** t


def ssq_freqs_peak(wavelet, scales, n, fs=1.0):
    """Ascending 'log-piecewise' ssq frequencies under maprange 'peak': the
    peak frequencies of the largest and least scale at the padded length as
    ends, two exponential runs meeting at the scales' transition."""
    m = p2up(n)[0]

    def fc(s):
        return peak_frequency(wavelet, s, m) / (2 * PI) / (1 / fs)

    na = len(scales)
    f0, f2 = fc(scales[-1]), fc(scales[0])
    idx = transition_index(scales)
    if idx is None:
        return f0 * np.power(f2 / f0, np.arange(na) / (na - 1))
    f1 = fc(scales[idx])
    t1 = np.arange(0, na - idx - 1) / (na - 1)
    t2 = np.arange(na - idx - 1, na) / (na - 1)
    t1 = np.hstack([t1, t2[0]])
    return np.hstack([_exp_fm(t1, f0, f1)[:-1], _exp_fm(t2, f1, f2)])


def log_piecewise_bins(freqs):
    """Closed-form constants of the log-piecewise bin map of ascending
    `freqs`: (vlmin0, vlmin1, dvl0, dvl1, idx1)."""
    v = np.asarray(freqs)
    idx = transition_index(v)
    if idx is None:
        raise ValueError("ssq frequencies are not log-piecewise")
    return (float(np.log2(v[0])), float(np.log2(v[idx - 1])),
            max(float(np.log2(v[1]) - np.log2(v[0])), EPS64),
            max(float(np.log2(v[idx]) - np.log2(v[idx - 1])), EPS64),
            idx - 1)


def dpss_window(n_fft):
    """The default STFT window, DPSS(n_fft, max(4, n_fft // 8)), periodic,
    and its time derivative by frequency-domain differentiation (even-n
    Nyquist zeroed), both with denormals zeroed."""
    w = scipy.signal.windows.dpss(n_fft, max(4, n_fft // 8), sym=False)
    xi = xifn(1, n_fft)
    if n_fft % 2 == 0:
        xi[n_fft // 2] = 0
    dw = np.fft.ifft(np.fft.fft(w) * 1j * xi).real
    tiny = 1000 * np.finfo(np.float64).tiny
    return (np.where(np.abs(w) < tiny, 0.0, w),
            np.where(np.abs(dw) < tiny, 0.0, dw))
