"""find_closest: nearest-bin search (host numpy; counterpart of
``ssqueeze_rs_tpu/utils/closest.py``). The transforms never call this
(they bin with the closed forms of `ops.ssqueeze.bin_params`); it is the
reference-name API and a test oracle.

  * `parallel` is accepted and ignored everywhere.
  * the analytic log/lin forms clamp bins to len(v)-1, the number of
    target bins.
"""
from __future__ import annotations

import numpy as np

__all__ = ["find_closest", "find_closest_brute", "find_closest_smart",
           "find_closest_log", "find_closest_lin"]


def find_closest_brute(a, v, parallel=None):
    """Exact exhaustive argmin(|a[i,j] - v|)."""
    a = np.asarray(a)
    v = np.asarray(v)
    return np.abs(a[..., None] - v).argmin(-1).astype(np.int32)


def find_closest_smart(a, v, parallel=None):
    """Exact nearest bin in O(log len(v)) per element: bisect each element into the sorted
    targets, then keep whichever of the two bracketing targets is
    nearer (ties resolve to the LOWER target)."""
    a, v = np.asarray(a), np.asarray(v)
    order = v.argsort()
    targets = v[order]
    hi = np.searchsorted(targets, a).clip(max=len(v) - 1)
    lo = (hi - 1).clip(min=0)
    take_lower = ((np.abs(a - targets[hi]) >= np.abs(a - targets[lo]))
                  & (hi > 0))
    return order[np.where(take_lower, lo, hi)]


def find_closest_log(a, v, parallel=None):
    """Analytic bin for log-distributed `v`."""
    from ..ops.ssqueeze import bin_params
    mode, p = bin_params(v, True)
    a = np.asarray(a)
    omax = len(v) - 1
    if mode == "log":
        k = np.minimum(np.round(np.maximum(
            (np.log2(a) - p["vlmin"]) / p["dvl"], 0)), omax)
    else:
        al = np.log2(a)
        k_hi = np.minimum(np.round((al - p["vlmin1"]) / p["dvl1"])
                          + p["idx1"], omax)
        k_lo = np.maximum(np.round((al - p["vlmin0"]) / p["dvl0"]), 0)
        k = np.where(al > p["vlmin1"], k_hi, k_lo)
    return k.astype(np.int32)


def find_closest_lin(a, v, parallel=None):
    """Analytic bin for linearly-distributed `v`."""
    vmin, dv = v[0], v[1] - v[0]
    omax = len(v) - 1
    k = np.minimum(np.round(np.maximum((np.asarray(a) - vmin) / dv, 0)), omax)
    return k.astype(np.int32)


def find_closest(a, v, logscale=False, parallel=None, smart=None):
    """Nearest bin of each entry of `a` among `v`: exact (`smart`, the
    default) or by the analytic log / lin forms."""
    if smart or smart is None:
        if logscale:
            return find_closest_smart(np.log2(a), np.log2(v))
        return find_closest_smart(a, v)
    return find_closest_log(a, v) if logscale else find_closest_lin(a, v)
