"""DFT frequency grids (counterpart of ``ssqueeze_rs_tpu/utils/fft.py``).

The radian grid with a *positive* Nyquist bin for even N:

    N=128: [0, 1, ..., 64, -63, ..., -1] * (2*pi/N) * scale
"""
from __future__ import annotations

import numpy as np


def xifn(scale, N, xp=None, dtype=None):
    """Radian frequency grid `scale * 2*pi*k/N` with positive Nyquist.

    `xp` selects the array module (numpy, the default, or torch); `dtype`
    defaults to float64 with numpy. Returns a 1D array of length N."""
    if xp is None:
        xp = np
    if dtype is None and xp is np:
        dtype = np.float64
    i = xp.arange(N)
    k = xp.where(i <= N // 2, i, i - N)
    if xp is not np:
        k = k.to(xp.float64)          # torch takes int * float as float32
    xi = k * (2 * np.pi / N) * scale
    if dtype is not None:
        xi = xi.astype(dtype) if xp is np else xi.to(dtype)
    return xi


def aifftshift_idx(N):
    """Analytic ifftshift as an index permutation: moves the left N//2+1
    bins to the right, turning the `xifn` grid into an ascending -pi..pi
    grid."""
    if N % 2 == 1:
        return np.fft.ifftshift(np.arange(N))
    return np.concatenate([np.arange(N // 2 + 1, N), np.arange(N // 2 + 1)])

