"""The reference's kernel-layer names (counterpart of
``ssqueeze_rs_tpu/algos.py``), on the input's device
(`utils.common.as_signal`: array input goes to the CUDA device):

  * `indexed_sum_onfly` and `ssqueeze_fast` are the reassignment: kernel B
    (3 planes, from a phase) and kernel B' (4 planes, from Wx and dWx) of
    `ops.reassign_cuda` on a CUDA tensor (their double instantiations for
    float64 / complex128), their plain versions on a CPU tensor. The
    output has Wx's row count and the bin clamp is len(Wx) - 1, as in the
    reference, which sizes `out` by Wx.
  * `indexed_sum` is one `scatter_add_` per row, in row order: a row puts
    at most one entry in each (k, j), so no two adds of one launch meet
    and the sums are bitwise run to run on any device (a single
    `scatter_add_` on CUDA adds with float atomics).
  * the phase pairs are the elementwise phase transforms; `_cpu` and
    `_gpu` are one implementation.

Planes keep their precision: float64 / complex128 run in float64, and
planes of mixed precision raise rather than being cast. `out=` is
accepted and ignored: results are returned. `parallel=` is accepted and
ignored.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .config import EPS32, EPS64
from .ops.phase import _imag_ratio_over_2pi
from .ops.reassign_cuda import reassign, reassign4
from .ops.ssqueeze import bin_params
from .utils.closest import (find_closest, find_closest_brute,
                            find_closest_smart, find_closest_log,
                            find_closest_lin)
from .utils.common import (as_signal, replace_at_inf_or_nan, replace_at_inf,
                           replace_at_nan, replace_at_value,
                           replace_under_abs)
from .wavelets.props import find_maximum, find_first_occurrence

__all__ = [
    "nCk", "indexed_sum", "indexed_sum_onfly", "ssqueeze_fast",
    "phase_cwt_cpu", "phase_cwt_gpu", "phase_stft_cpu", "phase_stft_gpu",
    "find_closest", "find_closest_brute", "find_closest_smart",
    "find_closest_log", "find_closest_lin",
    "replace_at_inf_or_nan", "replace_at_inf", "replace_at_nan",
    "replace_at_value", "replace_under_abs", "zero_denormals",
    "find_maximum", "find_first_occurrence",
]

_DOUBLE = (torch.float64, torch.complex128)


def nCk(n, k):
    """n-Choose-k as a float (nCk(n, k > n) == 1.0, the reference's empty
    product)."""
    r = min(int(k), int(n) - int(k))
    if r < 0:
        return 1.0
    return float(math.comb(int(n), r))


def _tensors(*arrays):
    """`arrays` as tensors on the first one's device."""
    out = [as_signal(arrays[0])]
    return out + [as_signal(a, out[0].device) for a in arrays[1:]]


def _planes(W):
    return (W.real, W.imag) if W.is_complex() else (W, torch.zeros_like(W))


def _real_dtype(W):
    return torch.float64 if W.dtype in _DOUBLE else torch.float32


def _const_row(const, na, W):
    return torch.as_tensor(np.broadcast_to(
        np.asarray(const, np.float64).squeeze(), (na,)).copy(),
        dtype=_real_dtype(W), device=W.device)


def _result(Wx, txr, txi):
    return torch.complex(txr, txi) if Wx.is_complex() else txr


def indexed_sum(a, k, parallel=None):
    """out[k[i,j], j] += a[i,j] for a, k of shape (na, n); out has a's
    shape. One `scatter_add_` per row, in row order: bitwise run to
    run."""
    a = as_signal(a)
    k = torch.as_tensor(k, device=a.device).to(torch.int64)
    out = torch.zeros_like(a)
    for i in range(a.shape[0]):
        out.scatter_add_(0, k[i:i + 1], a[i:i + 1])
    return out


def indexed_sum_onfly(Wx, w, ssq_freqs, const=1, logscale=False,
                      flipud=False, out=None, parallel=None):
    """`indexed_sum` with the bins formed on the fly (kernel B on CUDA):
    Tx[k(w[i,j]), j] += Wx[i,j] * const[i], entries with infinite `w`
    skipped; `k` by the closed-form log / log-piecewise / linear maps of
    `ssq_freqs`. Tx has Wx's shape."""
    Wx, w = _tensors(Wx, w)
    mode, params = bin_params(ssq_freqs, bool(logscale))
    na = Wx.shape[-2]
    txr, txi = reassign(*_planes(Wx), w, _const_row(const, na, Wx),
                        params, mode, bool(flipud), na)
    return _result(Wx, txr, txi)


def ssqueeze_fast(Wx, dWx, ssq_freqs, const, logscale=False, flipud=False,
                  gamma=None, out=None, Sfs=None, parallel=None):
    """Phase transform, bins and scatter in one pass (kernel B' on CUDA):
    `Sfs=None` takes the CWT phase |Im(dWx/Wx)|/2pi, else the STFT phase
    |Sfs - Im(dSx/Sx)/2pi|; entries with |Wx| <= gamma are skipped
    (default 10 * eps of Wx's precision). Tx has Wx's shape."""
    Wx, dWx = _tensors(Wx, dWx)
    if gamma is None:
        gamma = 10 * (EPS64 if Wx.dtype == torch.complex128 else EPS32)
    mode, params = bin_params(ssq_freqs, bool(logscale))
    na = Wx.shape[-2]
    transform = "cwt" if Sfs is None else "stft"
    Sfs = torch.as_tensor(np.zeros(na) if Sfs is None else Sfs,
                          dtype=_real_dtype(Wx), device=Wx.device)
    txr, txi = reassign4(*_planes(Wx), *_planes(dWx),
                         _const_row(const, na, Wx), Sfs, float(gamma),
                         params, mode, bool(flipud), na, transform)
    return _result(Wx, txr, txi)


def phase_cwt_cpu(Wx, dWx, gamma, parallel=None):
    """|Im(dWx/Wx)| / 2pi, inf where |Wx| < gamma, on Wx's device."""
    Wx = as_signal(Wx)
    dWx = as_signal(dWx, Wx.device)
    w = _imag_ratio_over_2pi(Wx, dWx).abs()
    return torch.where(Wx.abs() < gamma, torch.full_like(w, float("inf")), w)


def phase_stft_cpu(Wx, dWx, Sfs, gamma, parallel=None):
    """|Sfs - Im(dSx/Sx)/2pi|, inf where |Sx| < gamma, on Wx's device."""
    Wx = as_signal(Wx)
    dWx = as_signal(dWx, Wx.device)
    Sfs = as_signal(Sfs, Wx.device)
    w = (Sfs[:, None] - _imag_ratio_over_2pi(Wx, dWx)).abs()
    return torch.where(Wx.abs() < gamma, torch.full_like(w, float("inf")), w)


# one implementation on every device
phase_cwt_gpu = phase_cwt_cpu
phase_stft_gpu = phase_stft_cpu


def zero_denormals(x, parallel=None):
    """Zero values within 1000x of the dtype's smallest normal. A numpy
    array is modified in place, as the reference's; a tensor comes back
    as a new tensor on its device."""
    if isinstance(x, torch.Tensor):
        tiny = 1000 * torch.finfo(x.dtype).tiny
        return torch.where((x < tiny) & (x > -tiny), torch.zeros_like(x), x)
    tiny = 1000 * np.finfo(np.asarray(x).dtype).tiny
    if isinstance(x, np.ndarray):
        x[(x < tiny) & (x > -tiny)] = 0
        return x
    x = np.asarray(x)
    return np.where((x < tiny) & (x > -tiny), 0, x)
