"""STFT window construction (counterpart of
``ssqueeze_rs_tpu/utils/windows.py``; host numpy, windows are small
constants):

  * string windows via scipy.signal.get_window(..., fftbins=True),
  * default window = DPSS(win_len, max(4, win_len//8), sym=False),
  * windows are center-padded to n_fft,
  * time-derivative window via frequency-domain differentiation
    (ifft(fft(w) * i*xi) with even-N Nyquist zeroed),
  * denormal zeroing.

`buffer`/`unbuffer`, `window_resolution` and `window_area` are not ported
yet (ROADMAP Queue 1 item 2).
"""
from __future__ import annotations

import numpy as np
import scipy.signal as sig
import torch

from .common import WARN
from .fft import xifn

__all__ = ["get_window", "window_norm", "check_nola"]


def _zero_denormals(w: np.ndarray) -> np.ndarray:
    tiny = 1000 * np.finfo(w.dtype).tiny
    w = w.copy()
    w[np.abs(w) < tiny] = 0.0
    return w


def get_window(window, win_len: int, n_fft: int | None = None,
               derivative: bool = False, dtype: str = "float64"):
    """Build (and optionally differentiate) a window of length `n_fft`.
    `window`: None (DPSS), a scipy window name, or an array (numpy or
    tensor). Returns numpy arrays."""
    if n_fft is None:
        pl = pr = 0
    else:
        if win_len > n_fft:
            raise ValueError(f"Can't have `win_len > n_fft` ({win_len} > {n_fft})")
        pl = (n_fft - win_len) // 2
        pr = n_fft - win_len - pl

    if window is not None:
        if isinstance(window, str):
            window = sig.get_window(window, win_len, fftbins=True)
        elif isinstance(window, torch.Tensor) or hasattr(window, "ndim"):
            window = (window.detach().cpu().numpy()
                      if isinstance(window, torch.Tensor)
                      else np.asarray(window))
            if len(window) != win_len:
                WARN(f"len(window) != win_len ({len(window)} != {win_len})")
        else:
            raise ValueError("`window` must be string or np.ndarray "
                             f"(got {type(window).__name__})")
    else:
        window = sig.windows.dpss(win_len, max(4, win_len // 8), sym=False)

    if len(window) < (win_len + pl + pr):
        window = np.pad(window, [pl, pr])

    if derivative:
        Nw = len(window)
        xi = xifn(1, Nw)
        if Nw % 2 == 0:
            xi[Nw // 2] = 0
        diff_window = np.fft.ifft(np.fft.fft(window) * 1j * xi).real

    window = _zero_denormals(window.astype(dtype))
    if derivative:
        diff_window = _zero_denormals(diff_window.astype(dtype))
        return window, diff_window
    return window


_WN_CACHE: dict = {}


def window_norm(window: np.ndarray, hop_len: int, n_fft: int, N: int,
                win_exp: int = 1) -> np.ndarray:
    """Sum of shifted window**(win_exp+1), the Griffin-Lim least-squares
    denominator, length N + n_fft - 1. Cached, and vectorized for many
    shifts (hop = 1 at N = 160 000 is 160 000 shifts)."""
    key = (window.tobytes(), int(hop_len), int(n_fft), int(N),
           int(win_exp), str(window.dtype))
    hit = _WN_CACHE.get(key)
    if hit is not None:
        return hit
    L = N + n_fft - 1
    max_hops = (L - n_fft) // hop_len + 1
    wpow = window.astype(np.float64) ** (win_exp + 1)
    if max_hops <= 4096:
        # few shifts: the direct loop is exact and fast
        wn = np.zeros(L, dtype=np.float64)
        for i in range(max_hops):
            n = i * hop_len
            wn[n:n + n_fft] += wpow
    else:
        # many shifts (small hop): per-residue prefix sums, O(L) —
        # wn[t] = sum of wpow[j] over j = t - i*hop in [0, n_fft)
        wn = np.zeros(L, dtype=np.float64)
        t = np.arange(L)
        r = t % hop_len
        lo = np.maximum(0, t - (max_hops - 1) * hop_len)
        hi = np.minimum(n_fft - 1, t)
        for rr in range(hop_len):
            sub = wpow[rr::hop_len]
            C = np.concatenate([[0.0], np.cumsum(sub)])
            sel = np.flatnonzero(r == rr)
            k_hi = np.clip((hi[sel] - rr) // hop_len, -1, len(sub) - 1)
            k_lo = np.clip(-(-(lo[sel] - rr) // hop_len), 0, len(sub))
            wn[sel] = C[k_hi + 1] - C[np.minimum(k_lo, k_hi + 1)]
    out = wn.astype(window.dtype)
    _WN_CACHE[key] = out
    while len(_WN_CACHE) > 64:
        _WN_CACHE.pop(next(iter(_WN_CACHE)))
    return out


def check_nola(window: np.ndarray, hop_len: int) -> bool:
    """Non-zero overlap-add criterion; warns when violated."""
    if hop_len > len(window):
        WARN("`hop_len > len(window)`; STFT not invertible")
        return False
    ok = bool(sig.check_NOLA(window, len(window), len(window) - hop_len))
    if not ok:
        WARN("`window` fails Non-zero Overlap Add (NOLA) criterion; "
             "STFT not invertible")
    # float32 right-boundary imprecision: critically-sampled frame counts
    # make the last hop's inversion numerically marginal for
    # time-localized windows in f32
    if (ok and str(np.asarray(window).dtype) == "float32" and
            not sig.check_NOLA(window, len(window),
                               len(window) - hop_len, tol=1e-3)):
        WARN("Imprecision expected at right-most hop of signal, in "
             "inversion. Lower `hop_len`, choose wider `window`, or use "
             "`dtype='float64'`.")
    return ok
