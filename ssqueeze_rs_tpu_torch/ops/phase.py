"""Phase transforms (counterpart of ``ssqueeze_rs_tpu/ops/phase.py``):
plain elementwise torch on the input's device, for `get_w=True` and
tests; the squeezing paths form w inside kernels A, B' and G.

    w_cwt[a,b]  = |Im(dWx/Wx) / 2pi|            (inf where |Wx| < gamma)
    w_stft[a,b] = |Sfs[a] - Im(dSx/Sx) / 2pi|   (inf where |Sx| < gamma)

computed as (B*C - A*D) / ((C^2 + D^2) * 2pi) with A,B = Re,Im(dWx),
C,D = Re,Im(Wx). `phase_cwt_num` differentiates Wx numerically instead.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EPS32, EPS64
from ..utils.common import as_signal

__all__ = ["phase_cwt", "phase_stft", "phase_cwt_num", "unwrap"]

_TWO_PI = 6.283185307179586


def _imag_ratio_over_2pi(Wx, dWx):
    A, B = dWx.real, dWx.imag
    C, D = Wx.real, Wx.imag
    return (B * C - A * D) / ((C**2 + D**2) * _TWO_PI)


def _eps(Wx):
    return EPS64 if Wx.dtype == torch.complex128 else EPS32


def unwrap(p, dim=-1):
    """numpy's `unwrap` (period 2pi, discontinuity pi) along `dim`: jumps
    between neighbours larger than pi are taken back by the multiple of
    2pi that brings them into [-pi, pi]."""
    dd = torch.diff(p, dim=dim)
    ddmod = torch.remainder(dd + np.pi, 2 * np.pi) - np.pi
    ddmod = torch.where((ddmod == -np.pi) & (dd > 0),
                        torch.full_like(ddmod, np.pi), ddmod)
    correct = torch.where(dd.abs() < np.pi, torch.zeros_like(dd),
                          ddmod - dd)
    head = p.narrow(dim, 0, 1)
    return torch.cat([head, p.narrow(dim, 1, p.shape[dim] - 1) +
                      torch.cumsum(correct, dim=dim)], dim=dim)


def phase_cwt(Wx, dWx, difftype="trig", gamma=None, device=None):
    """CWT phase transform of complex Wx (and dWx for 'trig'): +inf where
    |Wx| < gamma (default sqrt(eps) of Wx's precision). `difftype='phase'`
    (the forward difference of the unwrapped angle) is there for parity;
    'trig' is the accurate one. Runs on Wx's device (`as_signal`'s rule
    for arrays and `device`); a dWx array follows Wx."""
    Wx = as_signal(Wx, device)
    if dWx is not None:
        dWx = as_signal(dWx, Wx.device)
    if gamma is None:
        gamma = np.sqrt(_eps(Wx))
    if difftype == "trig":
        w = _imag_ratio_over_2pi(Wx, dWx).abs()
    elif difftype == "phase":
        u = unwrap(torch.angle(Wx), dim=-1)
        w = (torch.cat([torch.diff(u, dim=-1), u[..., -1:] - u[..., :1]],
                       dim=-1) / (2 * np.pi)).abs()
    else:
        raise ValueError(f"unsupported `difftype` '{difftype}'; must be one "
                         "of 'trig', 'phase'.")
    return torch.where(Wx.abs() < gamma, torch.full_like(w, float("inf")), w)


def phase_stft(Sx, dSx, Sfs, gamma=None, device=None):
    """STFT phase transform of complex Sx, dSx (..., n_freqs, n); Sfs:
    (n_freqs,) row frequencies, taken in Sx's real type. +inf where
    |Sx| < gamma (default 10 * eps of Sx's precision). Runs on Sx's device
    (`as_signal`'s rule for arrays and `device`); a dSx array follows
    Sx."""
    Sx = as_signal(Sx, device)
    dSx = as_signal(dSx, Sx.device)
    if gamma is None:
        gamma = 10 * _eps(Sx)
    rdtype = Sx.real.dtype if Sx.is_complex() else Sx.dtype
    Sfs = torch.as_tensor(Sfs if isinstance(Sfs, torch.Tensor)
                          else np.ascontiguousarray(Sfs), dtype=rdtype,
                          device=Sx.device)
    w = (Sfs[:, None] - _imag_ratio_over_2pi(Sx, dSx)).abs()
    return torch.where(Sx.abs() < gamma, torch.full_like(w, float("inf")), w)


def phase_cwt_num(Wx, dt, difforder=4, gamma=None, device=None):
    """Phase transform from a numerically differentiated Wx (forward
    difference, or 2nd / 4th-order centred differences over Wx extended
    by two columns each side, wrapping): +inf where |Wx| < gamma
    (default 10 * eps of Wx's precision; a gamma of 0 also takes the
    default, as in the reference). Runs on Wx's device (`as_signal`'s
    rule for arrays and `device`)."""
    Wx = as_signal(Wx, device)
    if difforder not in (1, 2, 4):
        raise ValueError(f"`difforder` must be one of: 1, 2, 4 (got "
                         f"{difforder})")
    if difforder in (2, 4):
        Wxr = torch.cat([Wx[..., -2:], Wx, Wx[..., :2]], dim=-1)
    if difforder == 1:
        w = torch.cat([Wx[..., 1:] - Wx[..., :-1],
                       Wx[..., :1] - Wx[..., -1:]], dim=-1) / dt
    elif difforder == 2:
        w = (-Wxr[..., 4:] + 4 * Wxr[..., 3:-1] - 3 * Wxr[..., 2:-2]) / (2 * dt)
    else:
        w = (-Wxr[..., 4:] + 8 * Wxr[..., 3:-1]
             - 8 * Wxr[..., 1:-3] + Wxr[..., :-4]) / (12 * dt)

    w = (-1j * w / Wx).real / (2 * np.pi)
    if not gamma:
        gamma = 10 * _eps(Wx)
    w = torch.where(Wx.abs() < gamma, torch.full_like(w, float("inf")), w)
    return w.abs()
