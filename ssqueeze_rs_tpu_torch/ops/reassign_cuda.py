"""Kernel B: analytic binning + deterministic reassignment, 3-plane
contract (counterpart of ``ssqueeze_rs_tpu/ops/reassign_pallas.py``'s
`reassign_pallas` with `w_plane`, whose Pallas body is `_make_kernel`
with `phase_in=True`).

`reassign` dispatches on the device of its inputs: on a CUDA tensor it
launches the hand-written kernel (``csrc/reassign.cu``) or raises; on a
CPU tensor it runs `reassign_plain`, the same function in plain torch.
`LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from .fft_cuda import _f32

__all__ = ["reassign", "reassign_plain", "bin_indices", "LAUNCHES"]

LAUNCHES = 0
MODES = {"log": 0, "log-piecewise": 1, "lin": 2}
_PARAM_ORDER = {"log": ("vlmin", "dvl"),
                "log-piecewise": ("vlmin0", "vlmin1", "dvl0", "dvl1", "idx1"),
                "lin": ("vmin", "dv")}
_MAX_SMEM = 227 * 1024      # per-block shared memory on Hopper
_COLS = 32                  # columns per block in csrc/reassign.cu


def _plan_floats(mode, params):
    """The plan constants rounded once to float32, in kernel order."""
    if mode not in MODES:
        raise ValueError(f"`mode` must be one of {tuple(MODES)} (got {mode})")
    vals = [float(np.float32(params[k])) for k in _PARAM_ORDER[mode]]
    return vals + [0.0] * (5 - len(vals))


def bin_indices(w, mode, params, flipud, nf):
    """Bin index of every phase value: the log / log-piecewise / lin closed
    forms with round-half-even (torch.round), w == 0 -> bin 0 for the log
    modes, flipud; -1 where masked (w == +inf). Returns int64.
    The constants are 0-d tensors so every division is a true IEEE
    division (torch divides by a Python scalar through its reciprocal on
    CUDA, which can move a value across a rounding tie)."""
    p = torch.tensor(_plan_floats(mode, params), dtype=w.dtype,
                     device=w.device)
    omax = float(nf - 1)
    mask = w < float("inf")
    wsafe = torch.where(mask & (w > 0), w, torch.ones_like(w))
    if mode == "log":
        k = torch.clamp(torch.round(torch.clamp(
            (torch.log2(wsafe) - p[0]) / p[1], min=0.0)), max=omax)
    elif mode == "log-piecewise":
        wl = torch.log2(wsafe)
        k_hi = torch.clamp(torch.round((wl - p[1]) / p[3]) + p[4], max=omax)
        k_lo = torch.clamp(torch.round((wl - p[0]) / p[2]), min=0.0)
        k = torch.where(wl > p[1], k_hi, k_lo)
    else:
        k = torch.clamp(torch.round(torch.clamp(
            (w - p[0]) / p[1], min=0.0)), max=omax)
    if mode != "lin":
        k = torch.where(w > 0, k, torch.zeros_like(k))
    k = k.to(torch.int64)
    if flipud:
        k = (nf - 1) - k
    return torch.where(mask, k, torch.full_like(k, -1))


def _prepare(wr, wi, w, const):
    device = wr.device if isinstance(wr, torch.Tensor) else torch.device("cpu")
    wr, wi, w, const = (_f32(a, device) for a in (wr, wi, w, const))
    if not (wr.shape == wi.shape == w.shape) or wr.ndim < 2:
        raise ValueError(f"Wx and w planes must share one (..., na, n) shape "
                         f"(got {tuple(wr.shape)}, {tuple(wi.shape)}, "
                         f"{tuple(w.shape)})")
    if const.shape != (wr.shape[-2],):
        raise ValueError(f"`const` must have shape ({wr.shape[-2]},) "
                         f"(got {tuple(const.shape)})")
    return device, wr, wi, w, const


def reassign_plain(wr, wi, w, const, plan_params, mode, flipud, nf):
    """Plain-torch kernel B: Tx[k(i,j), j] += Wx[i,j] * const[i] with
    `scatter_add_`; masked entries go to bin 0 with value 0. Returns
    (Txr, Txi), each (..., nf, n). On CUDA, scatter_add_ uses atomics, so
    its sums are not run-to-run deterministic there."""
    _, wr, wi, w, const = _prepare(wr, wi, w, const)
    k = bin_indices(w, mode, plan_params, flipud, nf)
    mask = k >= 0
    c = const[:, None]
    vr = torch.where(mask, wr * c, torch.zeros_like(wr))
    vi = torch.where(mask, wi * c, torch.zeros_like(wi))
    k = torch.where(mask, k, torch.zeros_like(k))
    shape = wr.shape[:-2] + (nf, wr.shape[-1])
    txr = torch.zeros(shape, dtype=wr.dtype, device=wr.device)
    txi = torch.zeros(shape, dtype=wr.dtype, device=wr.device)
    return txr.scatter_add_(-2, k, vr), txi.scatter_add_(-2, k, vi)


def _reassign_cuda(device, wr, wi, w, const, plan_params, mode, flipud, nf):
    from .. import _build
    global LAUNCHES
    p = _plan_floats(mode, plan_params)
    if 2 * nf * _COLS * 4 > _MAX_SMEM:
        raise ValueError(f"nf={nf} frequency rows exceed the kernel's "
                         f"shared-memory accumulator (max "
                         f"{_MAX_SMEM // (8 * _COLS)})")
    na, n = wr.shape[-2:]
    batch = wr.shape[:-2]
    B = int(np.prod(batch)) if batch else 1
    wr, wi, w, const = (t.contiguous() for t in (wr, wi, w, const))
    txr, txi = (torch.empty(batch + (nf, n), dtype=torch.float32,
                            device=device) for _ in range(2))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _build.lib().ssq_reassign(
            wr.data_ptr(), wi.data_ptr(), w.data_ptr(), const.data_ptr(),
            B, na, n, nf, MODES[mode], int(bool(flipud)), *p,
            txr.data_ptr(), txi.data_ptr(), stream)
    _build.check(err, "reassign kernel")
    LAUNCHES += 1
    return txr, txi


def reassign(wr, wi, w, const, plan_params, mode, flipud, nf):
    """Synchrosqueezing reassignment from precomputed phase.

    wr/wi: (..., na, n) Wx planes; w: (..., na, n) phase plane, +inf where
    masked; const: (na,) per-row normalization; plan_params: the dict of
    bin constants from `bin_params` for `mode` ('log', 'log-piecewise',
    'lin'); flipud: reverse the bin order; nf: number of frequency rows.
    Returns (Txr, Txi), each (..., nf, n). Arrays may be numpy (they go to
    the CPU) or tensors."""
    device, wr, wi, w, const = _prepare(wr, wi, w, const)
    if device.type == "cuda":
        return _reassign_cuda(device, wr, wi, w, const, plan_params, mode,
                              flipud, nf)
    if device.type == "cpu":
        return reassign_plain(wr, wi, w, const, plan_params, mode, flipud, nf)
    raise ValueError(f"reassign: unsupported device {device}")
