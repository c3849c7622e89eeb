"""Teager-Kaiser Energy Operator, classic and modified (counterpart of
``ssqueeze_rs_tpu/ops/tkeo.py``): slices and products along the last
axis, on the input's device (`utils.common.as_signal`: array input goes
to the CUDA device unless `device` says otherwise), any leading dims.

  classic:   psi[n] = x[n]^2 - x[n-1]*x[n+1]            (output len N-2)
  modified:  psi[n] = x[n-1]*x[n-2] - x[n]*x[n-3]       (output len N-3,
             Deburchgrave et al. 2008; l=1, p=2, q=0, s=3)
"""
from __future__ import annotations

from ..utils.common import as_signal

__all__ = ["tkeo", "tkeo_modified"]


def tkeo(x, device=None):
    """Classic TKEO along the last axis. (..., N) -> (..., N-2)."""
    x = as_signal(x, device)
    if x.shape[-1] < 3:
        raise ValueError("Signal must have at least 3 points for TKEO")
    return x[..., 1:-1] ** 2 - x[..., :-2] * x[..., 2:]


def tkeo_modified(x, device=None):
    """Modified TKEO along the last axis. (..., N) -> (..., N-3)."""
    x = as_signal(x, device)
    if x.shape[-1] < 5:
        raise ValueError("Signal must have at least 5 points for modified "
                         "TKEO")
    # output[i-3] = x[i-1]*x[i-2] - x[i]*x[i-3], i = 3..N-1
    return x[..., 2:-1] * x[..., 1:-2] - x[..., 3:] * x[..., :-3]
