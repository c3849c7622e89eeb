"""Kernel B: analytic binning + deterministic reassignment (counterpart
of ``ssqueeze_rs_tpu/ops/reassign_pallas.py``'s `reassign_pallas`, whose
Pallas body is `_make_kernel`), in its two input contracts:

  * `reassign` (B, 3 planes): Wx and the phase plane w, precomputed
    upstream (+inf where masked); `_make_kernel` with `phase_in=True`.
  * `reassign4` (B', 4 planes): Wx and dWx; w and the mask |Wx|^2 > gamma^2
    are formed in the kernel; `_make_kernel` with `phase_in=False`.

Both dispatch on the device of their inputs: on a CUDA tensor they
launch the hand-written kernel (``csrc/reassign.cu``) or raise; on a CPU
tensor they run their plain-torch versions. `LAUNCHES` (B) and
`LAUNCHES4` (B') count kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from .fft_cuda import _device_of, _f32

__all__ = ["reassign", "reassign_plain", "reassign4", "reassign4_plain",
           "phase_w", "bin_indices", "LAUNCHES", "LAUNCHES4"]

LAUNCHES = 0
LAUNCHES4 = 0
MODES = {"log": 0, "log-piecewise": 1, "lin": 2}
TRANSFORMS = {"cwt": 0, "stft": 1}
_PARAM_ORDER = {"log": ("vlmin", "dvl"),
                "log-piecewise": ("vlmin0", "vlmin1", "dvl0", "dvl1", "idx1"),
                "lin": ("vmin", "dv")}
MAX_SMEM = 227 * 1024       # per-block shared memory on Hopper
_TWO_PI = 6.283185307179586


def _block_cols(nf: int) -> int:
    """Columns (= threads) per block of csrc/reassign.cu: the largest of
    32, 16, 8 whose (2, nf, cols) float32 accumulator fits in shared
    memory; raises beyond nf = 3632."""
    for cols in (32, 16, 8):
        if 2 * nf * cols * 4 <= MAX_SMEM:
            return cols
    raise ValueError(f"nf={nf} frequency rows exceed the kernel's "
                     f"shared-memory accumulator (max {MAX_SMEM // 64})")


def _plan_floats(mode, params):
    """The plan constants rounded once to float32, in kernel order."""
    if mode not in MODES:
        raise ValueError(f"`mode` must be one of {tuple(MODES)} (got {mode})")
    vals = [float(np.float32(params[k])) for k in _PARAM_ORDER[mode]]
    return vals + [0.0] * (5 - len(vals))


def _gamma2(gamma):
    return float(np.float32(float(gamma) ** 2))


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


def phase_w(wr, wi, dr, di, Sfs, gamma, transform):
    """The 4-plane contract's phase plane, as the kernel forms it:
    w = |Sfs - (B*C - A*D) / (|Wx|^2 * 2pi)| for 'stft' and |...| alone
    for 'cwt' (C, D = Wx planes, A, B = dWx planes), +inf where
    |Wx|^2 <= gamma^2. Every product is rounded on its own, as torch
    rounds each op."""
    mag2 = wr * wr + wi * wi
    ratio = (di * wr - dr * wi) / (mag2 * _TWO_PI)
    if transform == "stft":
        ratio = Sfs[:, None] - ratio
    return torch.where(mag2 > _gamma2(gamma), ratio.abs(),
                       torch.full_like(ratio, float("inf")))


def _check_planes(*planes):
    if len({p.shape for p in planes}) != 1 or planes[0].ndim < 2:
        raise ValueError("Wx and w/dWx planes must share one (..., na, n) "
                         "shape (got " +
                         ", ".join(str(tuple(p.shape)) for p in planes) + ")")


def _check_row_vec(name, v, na):
    if v.shape != (na,):
        raise ValueError(f"`{name}` must have shape ({na},) "
                         f"(got {tuple(v.shape)})")


def _prepare(wr, wi, w, const):
    device = _device_of(wr)
    wr, wi, w, const = (_f32(a, device) for a in (wr, wi, w, const))
    _check_planes(wr, wi, w)
    _check_row_vec("const", const, wr.shape[-2])
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


def _launch(entry, device, planes, vecs, ints, plan, nf, what):
    """Common launch of the two C entry points: planes (..., na, n) and
    per-row vectors, outputs (..., nf, n)."""
    from .. import _build
    na, n = planes[0].shape[-2:]
    batch = planes[0].shape[:-2]
    B = int(np.prod(batch)) if batch else 1
    cols = _block_cols(nf)
    planes = [t.contiguous() for t in planes]
    vecs = [t.contiguous() for t in vecs]
    txr, txi = (torch.empty(batch + (nf, n), dtype=torch.float32,
                            device=device) for _ in range(2))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(_build.lib())(
            *(t.data_ptr() for t in planes + vecs), B, na, n, nf, *ints,
            *plan, cols, txr.data_ptr(), txi.data_ptr(), stream)
    _build.check(err, what)
    return txr, txi


def reassign(wr, wi, w, const, plan_params, mode, flipud, nf):
    """Synchrosqueezing reassignment from precomputed phase (kernel B).

    wr/wi: (..., na, n) Wx planes; w: (..., na, n) phase plane, +inf where
    masked; const: (na,) per-row normalization; plan_params: the dict of
    bin constants from `bin_params` for `mode` ('log', 'log-piecewise',
    'lin'); flipud: reverse the bin order; nf: number of frequency rows.
    Returns (Txr, Txi), each (..., nf, n). Arrays may be numpy (they go to
    the CPU) or tensors."""
    global LAUNCHES
    device, wr, wi, w, const = _prepare(wr, wi, w, const)
    if device.type == "cuda":
        plan = _plan_floats(mode, plan_params)
        out = _launch(lambda lib: lib.ssq_reassign, device, [wr, wi, w],
                      [const], [MODES[mode], int(bool(flipud))], plan, nf,
                      "reassign kernel")
        LAUNCHES += 1
        return out
    if device.type == "cpu":
        return reassign_plain(wr, wi, w, const, plan_params, mode, flipud, nf)
    raise ValueError(f"reassign: unsupported device {device}")


def _prepare4(wr, wi, dr, di, const, Sfs):
    device = _device_of(wr)
    wr, wi, dr, di, const, Sfs = (_f32(a, device)
                                  for a in (wr, wi, dr, di, const, Sfs))
    _check_planes(wr, wi, dr, di)
    _check_row_vec("const", const, wr.shape[-2])
    _check_row_vec("Sfs", Sfs, wr.shape[-2])
    return device, wr, wi, dr, di, const, Sfs


def _check_transform(transform):
    if transform not in TRANSFORMS:
        raise ValueError(f"`transform` must be one of {tuple(TRANSFORMS)} "
                         f"(got {transform})")


def reassign4_plain(wr, wi, dr, di, const, Sfs, gamma, plan_params, mode,
                    flipud, nf, transform):
    """Plain-torch kernel B': `phase_w`, then `reassign_plain`."""
    _check_transform(transform)
    _, wr, wi, dr, di, const, Sfs = _prepare4(wr, wi, dr, di, const, Sfs)
    w = phase_w(wr, wi, dr, di, Sfs, gamma, transform)
    return reassign_plain(wr, wi, w, const, plan_params, mode, flipud, nf)


def reassign4(wr, wi, dr, di, const, Sfs, gamma, plan_params, mode, flipud,
              nf, transform):
    """Synchrosqueezing reassignment from Wx and dWx (kernel B').

    wr/wi, dr/di: (..., na, n) Wx and dWx planes; const, Sfs: (na,) row
    normalization and row frequencies (Sfs is read for 'stft' only);
    gamma: entries with |Wx|^2 <= gamma^2 are masked; transform: 'stft'
    (w = |Sfs - Im(dWx/Wx)/2pi|) or 'cwt' (w = |Im(dWx/Wx)/2pi|); the rest
    as `reassign`. Returns (Txr, Txi), each (..., nf, n)."""
    global LAUNCHES4
    _check_transform(transform)
    device, wr, wi, dr, di, const, Sfs = _prepare4(wr, wi, dr, di, const,
                                                   Sfs)
    if device.type == "cuda":
        plan = [_gamma2(gamma)] + _plan_floats(mode, plan_params)
        out = _launch(lambda lib: lib.ssq_reassign4, device,
                      [wr, wi, dr, di], [const, Sfs],
                      [TRANSFORMS[transform], MODES[mode],
                       int(bool(flipud))], plan, nf, "reassign4 kernel")
        LAUNCHES4 += 1
        return out
    if device.type == "cpu":
        return reassign4_plain(wr, wi, dr, di, const, Sfs, gamma,
                               plan_params, mode, flipud, nf, transform)
    raise ValueError(f"reassign4: unsupported device {device}")
