"""STFT window construction (counterpart of
``ssqueeze_rs_tpu/utils/windows.py``; host numpy, windows are small
constants):

  * string windows via scipy.signal.get_window(..., fftbins=True),
  * default window = DPSS(win_len, max(4, win_len//8), sym=False),
  * windows are center-padded to n_fft,
  * time-derivative window via frequency-domain differentiation
    (ifft(fft(w) * i*xi) with even-N Nyquist zeroed),
  * denormal zeroing.

`buffer` / `unbuffer` (MATLAB-style framing and its overlap-add) take
arrays (host numpy) or tensors (torch on their device).
"""
from __future__ import annotations

import numpy as np
import scipy.signal as sig
import torch

from .common import WARN
from .fft import xifn

__all__ = ["get_window", "window_norm", "check_nola", "window_resolution",
           "window_area", "buffer", "unbuffer"]


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


def window_resolution(window: np.ndarray):
    """(std_w, std_t, harea) of a window (host numpy)."""
    assert window.min() >= 0, f"`window` must be >= 0 (got min={window.min()})"
    N = len(window)
    t = np.arange(-N / 2, N / 2, step=1)
    ws = np.fft.fftshift(xifn(1, N))

    psihs = np.fft.fftshift(np.fft.fft(window))
    apsi2 = np.abs(window) ** 2
    apsih2s = np.abs(psihs) ** 2

    var_w = np.trapezoid(ws**2 * apsih2s, ws) / np.trapezoid(apsih2s, ws)
    var_t = np.trapezoid(t**2 * apsi2, t) / np.trapezoid(apsi2, t)

    std_w, std_t = np.sqrt(var_w), np.sqrt(var_t)
    return std_w, std_t, std_w * std_t


def window_area(window: np.ndarray, time: bool = True, frequency: bool = False):
    """Area under |window|^2 in time and/or frequency (host numpy)."""
    if not time and not frequency:
        raise ValueError("must compute something")
    if time:
        t = np.arange(-len(window) / 2, len(window) / 2, step=1)
        at = np.trapezoid(np.abs(window) ** 2, t)
    if frequency:
        ws = np.fft.fftshift(xifn(1, len(window)))
        apsih2s = np.abs(np.fft.fftshift(np.fft.fft(window))) ** 2
        aw = np.trapezoid(apsih2s, ws)
    if time and frequency:
        return at, aw
    return at if time else aw


def buffer(x, seg_len, n_overlap, modulated=False, parallel=None):
    """MATLAB-style framing: columns are successive length-`seg_len`
    slices of `x` overlapping by `n_overlap`; `modulated` swaps the halves
    of each frame (a per-hop ifftshift). `parallel` is accepted and
    ignored. 1D x -> (seg_len, n_segs); 2D (batch, N) -> (batch, seg_len,
    n_segs). A tensor is framed on its device by one gather."""
    is_t = isinstance(x, torch.Tensor)
    if not is_t:
        x = np.asarray(x)
    assert x.ndim in (1, 2)
    hop_len = seg_len - n_overlap
    n_segs = (x.shape[-1] - seg_len) // hop_len + 1
    starts = np.arange(n_segs) * hop_len
    idx = starts[None, :] + np.arange(seg_len)[:, None]   # (seg_len, n_segs)
    if modulated:
        # the back part has ceil(seg_len/2) samples: the swap point is
        # floor(seg_len/2) for odd lengths
        s20 = int(np.ceil(seg_len / 2))
        s21 = s20 - 1 if (seg_len % 2 == 1) else s20
        idx = np.concatenate([idx[s21:], idx[:s21]], axis=0)
    if is_t:
        return x[..., torch.as_tensor(idx, device=x.device)]
    return x[..., idx]


def unbuffer(xbuf, window, hop_len, n_fft, N, win_exp=1):
    """Overlap-add inverse of `buffer`: frame i, times window**win_exp,
    added at i * hop_len, in frame order; length N + n_fft - 1. A tensor
    `xbuf` is added on its device."""
    is_t = isinstance(xbuf, torch.Tensor)
    if is_t:
        window = torch.as_tensor(window, dtype=xbuf.dtype,
                                 device=xbuf.device)
    else:
        xbuf = np.asarray(xbuf)
        window = np.asarray(window)
    if N is None:
        N = xbuf.shape[-1] * hop_len + len(window) - 1
    if len(window) != n_fft:
        raise ValueError(f"Must have `len(window) == n_fft` "
                         f"(got {len(window)} != {n_fft})")
    if win_exp == 0:
        w = torch.ones_like(window) if is_t else np.ones_like(window)
    elif win_exp == 1:
        w = window
    else:
        w = window ** win_exp
    if is_t:
        x = torch.zeros(N + n_fft - 1, dtype=xbuf.dtype, device=xbuf.device)
    else:
        x = np.zeros(N + n_fft - 1, dtype=xbuf.dtype)
    for i in range(xbuf.shape[-1]):
        n = i * hop_len
        x[n:n + n_fft] += xbuf[:, i] * w
    return x
