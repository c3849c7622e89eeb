"""Phase transforms (counterpart of ``ssqueeze_rs_tpu/ops/phase.py``):
plain elementwise torch for `get_w=True` and tests; the squeezing paths
form w inside kernels A, B' and G.

    w_stft[a,b] = |Sfs[a] - Im(dSx/Sx) / 2pi|   (inf where |Sx| < gamma)

computed as (B*C - A*D) / ((C^2 + D^2) * 2pi) with A,B = Re,Im(dSx),
C,D = Re,Im(Sx). `phase_cwt` and `phase_cwt_num` are not ported yet
(ROADMAP Queue 1 item 3).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EPS32

__all__ = ["phase_stft"]

_TWO_PI = 6.283185307179586


def _imag_ratio_over_2pi(Wx, dWx):
    A, B = dWx.real, dWx.imag
    C, D = Wx.real, Wx.imag
    return (B * C - A * D) / ((C**2 + D**2) * _TWO_PI)


def phase_stft(Sx, dSx, Sfs, gamma=None):
    """STFT phase transform of complex64 Sx, dSx (..., n_freqs, n);
    Sfs: (n_freqs,) row frequencies. +inf where |Sx| < gamma (default
    10 * EPS32)."""
    if gamma is None:
        gamma = 10 * EPS32
    Sfs = (Sfs.to(Sx.device, torch.float32) if isinstance(Sfs, torch.Tensor)
           else torch.as_tensor(np.ascontiguousarray(Sfs, np.float32),
                                device=Sx.device))
    w = (Sfs[:, None] - _imag_ratio_over_2pi(Sx, dSx)).abs()
    return torch.where(Sx.abs() < gamma, torch.full_like(w, float("inf")), w)
