"""DFT frequency grids (counterpart of ``ssqueeze_rs_tpu/utils/fft.py``).

The radian grid with a *positive* Nyquist bin for even N:

    N=128: [0, 1, ..., 64, -63, ..., -1] * (2*pi/N) * scale
"""
from __future__ import annotations

import numpy as np


def xifn(scale, N, dtype=np.float64):
    """Radian frequency grid `scale * 2*pi*k/N` with positive Nyquist."""
    i = np.arange(N)
    k = np.where(i <= N // 2, i, i - N)
    return (k * (2 * np.pi / N) * scale).astype(dtype)


def aifftshift_idx(N):
    """Analytic ifftshift as an index permutation: moves the left N//2+1
    bins to the right, turning the `xifn` grid into an ascending -pi..pi
    grid."""
    if N % 2 == 1:
        return np.fft.ifftshift(np.arange(N))
    return np.concatenate([np.arange(N // 2 + 1, N), np.arange(N // 2 + 1)])

