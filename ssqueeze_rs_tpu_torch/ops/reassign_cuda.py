"""Kernel B: analytic binning + deterministic reassignment (counterpart
of ``ssqueeze_rs_tpu/ops/reassign_pallas.py``'s `reassign_pallas`, whose
Pallas body is `_make_kernel`), in its two input contracts:

  * `reassign` (B, 3 planes): Wx and the phase plane w, precomputed
    upstream (+inf where masked); `_make_kernel` with `phase_in=True`.
  * `reassign4` (B', 4 planes): Wx and dWx; w and the mask |Wx|^2 > gamma^2
    are formed in the kernel; `_make_kernel` with `phase_in=False`.

Both dispatch on the device of their inputs: on a CUDA tensor they
launch the hand-written kernel or raise; on a CPU tensor they run their
plain-torch versions. Planes stay in their real type, float32 or float64
(as the JAX `reassign_pallas` keeps float64 planes float64): float32
planes launch ``csrc/reassign.cu`` (16 lanes a column, at the columns a
block `_block_cols` takes from nf), float64 planes its double
counterpart ``csrc/reassign64.cu`` (the `_f64` entry points: the planes
staged by TMA, a float screen of the bins, the launch shape from
`_f64_plan`), with the plan constants, gamma^2 and the row vectors in
float64; planes of mixed type raise. Both
are differentiable with the JAX package's gradient semantics
(`ReassignFn`, `Reassign4Fn`): the backward is the VJP gather C / C'
(`reassign_bwd`, `reassign4_bwd`, ``csrc/reassign_bwd.cu``; counterpart
of `_make_bwd_kernel`), which dispatches the same way.

The 4-plane contract has a second implementation, kernel I
(``csrc/reassign_mxu.cu``, plain version `reassign_mxu_plain`;
counterpart of `_make_mxu_kernel`): the same bins, summed as a
digit-split one-hot matrix product on the tensor cores (wgmma, one
pass over the planes a launch, `_mxu_plan`). It has no entry
of its own: `reassign4` picks B' or I from
SSQ_TPU_REASSIGN_IMPL at each call ('vpu', the default, or 'mxu'; any
other value raises), as the JAX package's `reassign_pallas` does; the
3-plane `reassign` ignores it, and float64 planes take B' under either
(I is float32 only, as in JAX). Both share the backward C'.
Any number of frequency rows: a launch of B, B' (either type) or I sums
the bins of one range [k0, k0 + rows) into those Tx rows, and a call
splits [0, nf) into consecutive ranges of at most what the kernel's
accumulator holds (`_ranges`: 3632 bins for B and B' in float32 and in
double, 4096 for I), each planned on its own rows. Every launch reads
all the planes and adds only the entries whose final (clamped, flipped)
bin falls in its range, so each Tx entry takes the same adds in the same
order as in one launch: Tx does not depend on the split. At nf at or
under the limit a call is one launch, as before.

Each launch goes through `_build.launch`, which counts it in
`trace.COUNTS` under `launch.<entry>`: `launch.ssq_reassign` (B),
`launch.ssq_reassign4` (B'), `launch.ssq_reassign_mxu` (I),
`launch.ssq_reassign_bwd` (C) and `launch.ssq_reassign4_bwd` (C') for
float32, the same names with `_f64` for the double ones. They count
launches, not calls: a call split into ranges adds one a range.
"""
from __future__ import annotations

import contextlib
import os
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .fft_cuda import _as, _device_of, _zeros_for

__all__ = ["reassign", "reassign_plain", "reassign4", "reassign4_plain",
           "reassign_bwd", "reassign_bwd_plain", "reassign4_bwd",
           "reassign4_bwd_plain", "ReassignFn", "Reassign4Fn", "phase_w",
           "bin_indices", "reassign_mxu_plain",
           "reassign_impl"]

MODES = {"log": 0, "log-piecewise": 1, "lin": 2}
TRANSFORMS = {"cwt": 0, "stft": 1}
_PARAM_ORDER = {"log": ("vlmin", "dvl"),
                "log-piecewise": ("vlmin0", "vlmin1", "dvl0", "dvl1", "idx1"),
                "lin": ("vmin", "dv")}
MAX_SMEM = 227 * 1024       # per-block shared memory on Hopper
_TWO_PI = 6.283185307179586
F32_MAX_NF = MAX_SMEM // 64  # bins a launch of float32 B, B' (3632)
F64_MAX_NF = 3632            # bins a launch of B, B' in double


def _ranges(nf: int, most: int):
    """The bin ranges of a call over nf bins whose kernel takes at most
    `most` bins a launch: consecutive (k0, rows), each `most` rows but the
    last, covering [0, nf) once."""
    if nf < 1 or most < 1:
        raise ValueError(f"nf={nf} frequency rows in ranges of {most}")
    return [(k0, min(most, nf - k0)) for k0 in range(0, nf, most)]


def _block_cols(nf: int) -> int:
    """Columns a block (COLS) of csrc/reassign.cu (float32 planes), whose
    blocks have 16 lanes a column, for a launch of nf bins: 32 where the
    (2, nf, 32) accumulator fits in shared memory (nf <= 908), else 8 (16
    columns were slower at nf = 1025 on the card, PERF.md). Raises beyond
    nf = 3632 (a call past that is split into ranges, `_ranges`)."""
    for cols in (32, 8):
        if 2 * nf * cols * 4 <= MAX_SMEM:
            return cols
    raise ValueError(f"nf={nf} frequency rows exceed the kernel's "
                     f"shared-memory accumulator (max {MAX_SMEM // 64})")


# -- kernels B and B' in double (csrc/reassign64.cu) ----------------------------
F64_LANES = 16              # lanes a column: the rows a row group takes
F64_MIN_FLIGHT = 32 * 1024  # plane bytes in flight an SM the plan keeps
SM_SMEM = 228 * 1024        # shared memory of an SM
BLOCK_RESERVE = 1024        # of it, the runtime's share a resident block
_F64_MAX_STAGES = 16        # csrc/reassign64.cu kMaxStages
# the (columns, row groups) csrc/reassign64.cu instantiates: (8, 2) runs
# 2 to 4 blocks an SM of 256 threads (one instantiation for each count,
# with the registers that count allows); the others one block an SM of
# 512 threads, at 8, 4 or 2 columns as the accumulator allows
F64_SHAPES = {8: (2, 4), 4: (8,), 2: (16,)}
_F64_SINGLE = {8: 4, 4: 8, 2: 16}


class F64Plan(NamedTuple):
    """Launch plan of the double kernels B and B' (csrc/reassign64.cu)
    for nf bins and `planes` input planes: `cols` columns a block (a
    tile; each plane row of a tile is one run of 8 cols bytes),
    `groups` row groups of 16 rows (cols / 2 warps each), so `rows` =
    16 groups rows a ring stage; `stages` ring stages; `smem` bytes of
    dynamic shared memory a block; `blocks` blocks an SM the shared
    memory allows; `flight` plane bytes in flight an SM (blocks x
    (stages - 1) stages)."""
    cols: int
    groups: int
    rows: int
    stages: int
    smem: int
    blocks: int
    flight: int


def _f64_stage(cols: int, groups: int, planes: int) -> int:
    """Bytes of one ring stage: its planes' TMA boxes (16 groups rows x
    cols doubles each) and its mbarrier."""
    return planes * F64_LANES * groups * cols * 8 + 8


def _f64_acc(nf: int, cols: int) -> int:
    """Bytes of the two (nf, cols) float64 accumulator planes, each
    rounded up to 1024 bytes (the TMA's alignment)."""
    return 2 * -(-nf * cols * 8 // 1024) * 1024


def _f64_smem(nf: int, cols: int, groups: int, planes: int,
              stages: int) -> int:
    """csrc/reassign64.cu smem_bytes: 1024 bytes to align the base, the
    accumulator and the ring."""
    return 1024 + _f64_acc(nf, cols) + stages * _f64_stage(cols, groups,
                                                            planes)


def _f64_fit(nf, cols, groups, planes, blocks):
    """The plan of `blocks` blocks an SM at (cols, groups) with as many
    stages as their share of the SM holds, or None if that keeps fewer
    than 2 stages or F64_MIN_FLIGHT bytes in flight."""
    room = min(MAX_SMEM, SM_SMEM // blocks - BLOCK_RESERVE)
    stage = _f64_stage(cols, groups, planes)
    stages = min(_F64_MAX_STAGES,
                 (room - _f64_smem(nf, cols, groups, planes, 0)) // stage)
    flight = blocks * (stages - 1) * (stage - 8)
    if stages < 2 or flight < F64_MIN_FLIGHT:
        return None
    return F64Plan(cols, groups, F64_LANES * groups, stages,
                   _f64_smem(nf, cols, groups, planes, stages), blocks,
                   flight)


def _f64_plan(nf: int, planes: int = 4) -> F64Plan:
    """The double kernels' plan for nf bins and 3 or 4 planes: 8 columns
    (64-byte plane row runs) and 2 row groups in as many blocks an SM (4
    to 2) as leave each a ring of 2 or more stages keeping F64_MIN_FLIGHT
    bytes in flight an SM; else one block an SM of 512 threads, at the
    most columns (8, 4, 2) whose accumulator leaves such a ring. Then as
    many stages as the block's share of the SM holds, at most 16.
    Raises beyond nf = 3632 (a call past that is split into ranges,
    `_ranges`)."""
    if not 1 <= nf <= F64_MAX_NF:
        raise ValueError(f"nf={nf} frequency rows: the double kernels take "
                         "1 to 3632")
    for blocks in (4, 3, 2):
        plan = _f64_fit(nf, 8, 2, planes, blocks)
        if plan:
            return plan
    for cols, groups in _F64_SINGLE.items():
        plan = _f64_fit(nf, cols, groups, planes, 1)
        if plan:
            return plan
    raise AssertionError(f"no double plan at nf={nf}")


def _plan_floats(mode, params, dtype=torch.float32):
    """The plan constants in kernel order: rounded once to float32 for
    float32 planes, unrounded for float64 (as the JAX XLA route uses
    them)."""
    if mode not in MODES:
        raise ValueError(f"`mode` must be one of {tuple(MODES)} (got {mode})")
    vals = [float(params[k]) for k in _PARAM_ORDER[mode]]
    if dtype != torch.float64:
        vals = [float(np.float32(v)) for v in vals]
    return vals + [0.0] * (5 - len(vals))


def _gamma2(gamma, dtype=torch.float32):
    g2 = float(gamma) ** 2
    return g2 if dtype == torch.float64 else float(np.float32(g2))


_REAL = (torch.float32, torch.float64)


def _dtype_of(a):
    """The torch dtype of a tensor or array (None for anything else)."""
    if isinstance(a, torch.Tensor):
        return a.dtype
    if isinstance(a, np.ndarray):
        return {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}.get(a.dtype)
    return None


def _plane_dtype(*planes):
    """The real type the planes run in: float64 if they are float64, else
    float32. Planes of both real types raise: nothing is rounded
    silently."""
    types = {_dtype_of(p) for p in planes} & set(_REAL)
    if len(types) > 1:
        raise ValueError("planes of mixed dtypes (" +
                         ", ".join(str(_dtype_of(p)) for p in planes) +
                         "): pass every plane as float32 or every plane as "
                         "float64")
    return torch.float64 if types == {torch.float64} else torch.float32


def bin_indices(w, mode, params, flipud, nf):
    """Bin index of every phase value: the log / log-piecewise / lin closed
    forms with round-half-even (torch.round), w == 0 -> bin 0 for the log
    modes, flipud; -1 where masked (w == +inf). Returns int64.
    The constants are 0-d tensors so every division is a true IEEE
    division (torch divides by a Python scalar through its reciprocal on
    CUDA, which can move a value across a rounding tie)."""
    p = torch.tensor(_plan_floats(mode, params, w.dtype), dtype=w.dtype,
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
    rounds each op, in the planes' type (gamma^2 too)."""
    mag2 = wr * wr + wi * wi
    ratio = (di * wr - dr * wi) / (mag2 * _TWO_PI)
    if transform == "stft":
        ratio = Sfs[:, None] - ratio
    return torch.where(mag2 > _gamma2(gamma, wr.dtype), ratio.abs(),
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
    """The planes in their real type (`_plane_dtype`) on wr's device, and
    const in the same type."""
    device, dtype = _device_of(wr), _plane_dtype(wr, wi, w)
    wr, wi, w, const = (_as(a, device, dtype) for a in (wr, wi, w, const))
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


def reassign_bwd_plain(w, const, gr, gi, plan_params, mode, flipud, nf):
    """Plain-torch kernel C: gW[i,j] = gTx[k(i,j), j] * const[i] with
    `torch.gather`, 0 where masked. gr/gi: (..., nf, n) cotangents of Tx.
    Returns (gWr, gWi), each (..., na, n), in gr's type."""
    k = bin_indices(w, mode, plan_params, flipud, nf)
    mask = k >= 0
    k = torch.where(mask, k, torch.zeros_like(k))
    c = const[:, None]
    zero = torch.zeros((), dtype=gr.dtype, device=gr.device)
    return (torch.where(mask, torch.gather(gr, -2, k) * c, zero),
            torch.where(mask, torch.gather(gi, -2, k) * c, zero))


def reassign4_bwd_plain(wr, wi, dr, di, const, Sfs, gr, gi, gamma,
                        plan_params, mode, flipud, nf, transform):
    """Plain-torch kernel C': `phase_w`, then `reassign_bwd_plain`."""
    w = phase_w(wr, wi, dr, di, Sfs, gamma, transform)
    return reassign_bwd_plain(w, const, gr, gi, plan_params, mode, flipud, nf)


def _launch(entry, planes, vecs, ints, plan, nf, what, grads=None,
            per_block=None, out=None):
    """Common launch of the C entry point named `entry`: planes (..., na, n) and
    per-row vectors in. The forward ones (B, B', I and probe P4's 3-plane
    `full`; `grads` None) take the launch-shape ints `per_block` (float32
    B, B': the columns a block, `_block_cols`, when it is None; double B,
    B': `_f64_plan`'s columns, row groups and stages; I: its wgmma width
    `_mxu_plan(nf).n_tile`; for B, B' and I the bin range after them,
    `_launch_ranges`) and write (Txr, Txi), each (..., nf, n), into `out`
    when it is given; the backward ones (C, C') read the cotangents
    `grads` = (gr, gi), each (..., nf, n), and write (gWr, gWi), each
    (..., na, n). Outputs are in the planes' type."""
    from .. import _build
    device = planes[0].device
    na, n = planes[0].shape[-2:]
    batch = planes[0].shape[:-2]
    B = int(np.prod(batch)) if batch else 1
    dtype = planes[0].dtype
    planes = [t.contiguous() for t in planes]
    vecs = [t.contiguous() for t in vecs]
    if grads is None:
        mid = ([_block_cols(nf)] if per_block is None else
               [per_block] if isinstance(per_block, int) else
               list(per_block))
        rows = nf
    else:
        grads = [_cotangent(g, device, dtype).contiguous() for g in grads]
        if any(g.shape != batch + (nf, n) for g in grads):
            raise ValueError(f"{what}: cotangents " +
                             ", ".join(str(tuple(g.shape)) for g in grads) +
                             f" are not {batch + (nf, n)}")
        mid, rows = [g.data_ptr() for g in grads], na
    outs = (list(out) if out is not None else
            [torch.empty(batch + (rows, n), dtype=dtype, device=device)
             for _ in range(2)])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.launch(entry, *(t.data_ptr() for t in planes + vecs), B, na,
                      n, nf, *ints, *plan, *mid,
                      *(o.data_ptr() for o in outs), stream, what=what)
    return tuple(outs)


def _launch_ranges(entry, planes, vecs, ints, plan, nf, what, most, shape):
    """A forward launch (B, B' or I) over any nf: one launch a bin range of
    `_ranges(nf, most)`, each with the launch-shape ints `shape(rows)`
    and its range (k0, rows), all into one (Txr, Txi) pair. Returns
    ((Txr, Txi), launches)."""
    ranges = _ranges(nf, most)
    out = None
    for k0, rows in ranges:
        out = _launch(entry, planes, vecs, ints, plan, nf, what,
                      per_block=list(shape(rows)) + [k0, rows], out=out)
    return out, len(ranges)


def _entry(name, dtype):
    """The name of the C entry point `name`, or of its double
    instantiation `name_f64` for float64 planes, as `_launch` takes it."""
    return name + ("_f64" if dtype == torch.float64 else "")


def _f64_shape(dtype, nf, planes):
    """The launch-shape ints of B or B' for planes of `dtype`: the double
    plan's (columns, row groups, stages), or None (float32: `_block_cols`)."""
    if dtype != torch.float64:
        return None
    plan = _f64_plan(nf, planes)
    return plan.cols, plan.groups, plan.stages


def _scatter_shape(dtype, planes):
    """(most bins a launch, rows -> launch-shape ints) of B or B' on planes
    of `dtype`, as `_launch_ranges` takes them."""
    if dtype == torch.float64:
        return F64_MAX_NF, lambda rows: _f64_shape(dtype, rows, planes)
    return F32_MAX_NF, lambda rows: (_block_cols(rows),)


def _cotangent(g, device, dtype):
    """A Tx cotangent on `device` in the planes' type; a tensor of the
    other real type raises."""
    if _dtype_of(g) in _REAL and _dtype_of(g) != dtype:
        raise ValueError(f"cotangent of dtype {_dtype_of(g)} for {dtype} "
                         "planes")
    return _as(g, device, dtype)


def _reassign_dispatch(device, wr, wi, w, const, plan_params, mode, flipud,
                       nf):
    if device.type == "cuda":
        plan = _plan_floats(mode, plan_params, w.dtype)
        out, _ = _launch_ranges(
            _entry("ssq_reassign", w.dtype), [wr, wi, w], [const],
            [MODES[mode], int(bool(flipud))], plan, nf, "reassign kernel",
            *_scatter_shape(w.dtype, 3))
        return out
    if device.type == "cpu":
        return reassign_plain(wr, wi, w, const, plan_params, mode, flipud, nf)
    raise ValueError(f"reassign: unsupported device {device}")


def reassign_bwd(w, const, gr, gi, plan_params, mode, flipud, nf):
    """VJP gather of the 3-plane reassignment (kernel C): (gWr, gWi),
    each (..., na, n), from the cotangents gr/gi (..., nf, n) of (Txr,
    Txi); gW[i,j] = gTx[k(i,j), j] * const[i] with the bins of `reassign`,
    0 where masked. On a CUDA tensor it launches the kernel or raises; on
    a CPU tensor it runs `reassign_bwd_plain`. In w's type (float32 or
    float64)."""
    device, dtype = _device_of(w), _plane_dtype(w)
    w, const = _as(w, device, dtype), _as(const, device, dtype)
    if device.type == "cuda":
        return _launch(_entry("ssq_reassign_bwd", dtype), [w], [const],
                       [MODES[mode], int(bool(flipud))],
                       _plan_floats(mode, plan_params, dtype), nf,
                       "reassign_bwd kernel", grads=(gr, gi))
    if device.type == "cpu":
        return reassign_bwd_plain(w, const, _cotangent(gr, device, dtype),
                                  _cotangent(gi, device, dtype), plan_params,
                                  mode, flipud, nf)
    raise ValueError(f"reassign_bwd: unsupported device {device}")


class ReassignFn(torch.autograd.Function):
    """Kernel B with the JAX package's gradient (`_reassign_with_vjp`,
    phase_in): the bins are piecewise constant, so the cotangent reaches
    Wx only, through kernel C; w and const get zero. Saves w and const,
    as the JAX residuals do (no bin plane: C recomputes the bins)."""

    @staticmethod
    def forward(ctx, wr, wi, w, const, plan_params, mode, flipud, nf):
        ctx.save_for_backward(w, const)
        ctx.plan = (plan_params, mode, flipud, nf)
        return _reassign_dispatch(w.device, wr, wi, w, const, plan_params,
                                  mode, flipud, nf)

    @staticmethod
    @once_differentiable
    def backward(ctx, gr, gi):
        w, const = ctx.saved_tensors
        gwr, gwi = reassign_bwd(w, const, gr, gi, *ctx.plan)
        return (gwr, gwi, *_zeros_for(ctx, [(2, w), (3, const)]),
                None, None, None, None)


def reassign(wr, wi, w, const, plan_params, mode, flipud, nf):
    """Synchrosqueezing reassignment from precomputed phase (kernel B).

    wr/wi: (..., na, n) Wx planes; w: (..., na, n) phase plane, +inf where
    masked; const: (na,) per-row normalization; plan_params: the dict of
    bin constants from `bin_params` for `mode` ('log', 'log-piecewise',
    'lin'); flipud: reverse the bin order; nf: number of frequency rows.
    Returns (Txr, Txi), each (..., nf, n). Arrays may be numpy (they go to
    the CPU) or tensors, all float32 or all float64 (Tx in that type).
    Differentiable (`ReassignFn`: kernel C on CUDA)."""
    _, wr, wi, w, const = _prepare(wr, wi, w, const)
    return ReassignFn.apply(wr, wi, w, const, plan_params, mode, flipud, nf)


def _prepare4(wr, wi, dr, di, const, Sfs):
    """As `_prepare`, for the four planes and the two row vectors."""
    device, dtype = _device_of(wr), _plane_dtype(wr, wi, dr, di)
    wr, wi, dr, di, const, Sfs = (_as(a, device, dtype)
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


def reassign_impl() -> str:
    """The 4-plane implementation SSQ_TPU_REASSIGN_IMPL selects, read at
    call time: 'vpu' (the default, kernel B') or 'mxu' (kernel I). Unlike
    the JAX package, which takes any other value as 'vpu', an unknown
    value raises, so a typo cannot hide which kernel ran. float64 planes
    take B' under either value (I is float32 only, as in JAX)."""
    impl = os.environ.get("SSQ_TPU_REASSIGN_IMPL", "vpu")
    if impl not in ("vpu", "mxu"):
        raise ValueError("SSQ_TPU_REASSIGN_IMPL must be 'vpu' or 'mxu' "
                         f"(got {impl!r})")
    return impl


def _reassign4_dispatch(device, wr, wi, dr, di, const, Sfs, gamma,
                        plan_params, mode, flipud, nf, transform):
    dtype = wr.dtype
    if reassign_impl() == "mxu" and dtype == torch.float32:
        return _mxu_dispatch(device, wr, wi, dr, di, const, Sfs, gamma,
                             plan_params, mode, flipud, nf, transform)
    if device.type == "cuda":
        plan = ([_gamma2(gamma, dtype)] +
                _plan_floats(mode, plan_params, dtype))
        out, _ = _launch_ranges(
            _entry("ssq_reassign4", dtype), [wr, wi, dr, di], [const, Sfs],
            [TRANSFORMS[transform], MODES[mode], int(bool(flipud))], plan,
            nf, "reassign4 kernel", *_scatter_shape(dtype, 4))
        return out
    if device.type == "cpu":
        return reassign4_plain(wr, wi, dr, di, const, Sfs, gamma,
                               plan_params, mode, flipud, nf, transform)
    raise ValueError(f"reassign4: unsupported device {device}")


def reassign4_bwd(wr, wi, dr, di, const, Sfs, gr, gi, gamma, plan_params,
                  mode, flipud, nf, transform):
    """VJP gather of the 4-plane reassignment (kernel C'): as
    `reassign_bwd`, with the bins of `reassign4` (w and the mask formed
    from Wx and dWx)."""
    _check_transform(transform)
    device, wr, wi, dr, di, const, Sfs = _prepare4(wr, wi, dr, di, const,
                                                   Sfs)
    dtype = wr.dtype
    if device.type == "cuda":
        plan = ([_gamma2(gamma, dtype)] +
                _plan_floats(mode, plan_params, dtype))
        return _launch(_entry("ssq_reassign4_bwd", dtype), [wr, wi, dr, di],
                       [const, Sfs], [TRANSFORMS[transform], MODES[mode],
                                      int(bool(flipud))], plan, nf,
                       "reassign4_bwd kernel", grads=(gr, gi))
    if device.type == "cpu":
        return reassign4_bwd_plain(wr, wi, dr, di, const, Sfs,
                                   _cotangent(gr, device, dtype),
                                   _cotangent(gi, device, dtype), gamma,
                                   plan_params, mode, flipud, nf, transform)
    raise ValueError(f"reassign4_bwd: unsupported device {device}")


class Reassign4Fn(torch.autograd.Function):
    """Kernel B' or I (`reassign_impl`) with the JAX package's gradient
    (`_reassign_with_vjp`, 4 planes): the cotangent reaches Wx only,
    through kernel C' for either implementation (their bins are the
    same); dWx, const and Sfs get zero. Saves the four planes, const and
    Sfs (the JAX residuals)."""

    @staticmethod
    def forward(ctx, wr, wi, dr, di, const, Sfs, gamma, plan_params, mode,
                flipud, nf, transform):
        ctx.save_for_backward(wr, wi, dr, di, const, Sfs)
        ctx.plan = (gamma, plan_params, mode, flipud, nf, transform)
        return _reassign4_dispatch(wr.device, wr, wi, dr, di, const, Sfs,
                                   gamma, plan_params, mode, flipud, nf,
                                   transform)

    @staticmethod
    @once_differentiable
    def backward(ctx, gr, gi):
        wr, wi, dr, di, const, Sfs = ctx.saved_tensors
        gwr, gwi = reassign4_bwd(wr, wi, dr, di, const, Sfs, gr, gi,
                                 *ctx.plan)
        return (gwr, gwi, *_zeros_for(ctx, [(2, dr), (3, di), (4, const),
                                            (5, Sfs)]),
                None, None, None, None, None, None)


def reassign4(wr, wi, dr, di, const, Sfs, gamma, plan_params, mode, flipud,
              nf, transform):
    """Synchrosqueezing reassignment from Wx and dWx (kernel B', or I
    under SSQ_TPU_REASSIGN_IMPL=mxu: `reassign_impl`).

    wr/wi, dr/di: (..., na, n) Wx and dWx planes; const, Sfs: (na,) row
    normalization and row frequencies (Sfs is read for 'stft' only);
    gamma: entries with |Wx|^2 <= gamma^2 are masked; transform: 'stft'
    (w = |Sfs - Im(dWx/Wx)/2pi|) or 'cwt' (w = |Im(dWx/Wx)/2pi|); the rest
    as `reassign`. Returns (Txr, Txi), each (..., nf, n), in the planes'
    type (all float32 or all float64). Differentiable (`Reassign4Fn`:
    kernel C' on CUDA)."""
    _check_transform(transform)
    _, wr, wi, dr, di, const, Sfs = _prepare4(wr, wi, dr, di, const, Sfs)
    return Reassign4Fn.apply(wr, wi, dr, di, const, Sfs, gamma, plan_params,
                             mode, flipud, nf, transform)


# -- kernel I: the digit-split tensor-core scatter ------------------------------
MXU_MAX_NF = 4096        # kernel I's bins a launch: 64 high digits x a low
                         # digit <= 64
MXU_GROUPS = 4           # warpgroups of a block: each bins and multiplies
MXU_STAGES = 3           # plane stages in kernel I's shared-memory ring
_MXU_ACC = 64            # accumulator registers a thread
_MXU_MAX_COLS = 32       # columns a block
_MXU_ENTRIES = 2         # entries a thread bins a stage
_MXU_MAX_ROWS = 128      # rows a stage


class MxuPlan(NamedTuple):
    """Kernel I's launch plan for nf bins (csrc/reassign_mxu.cu computes
    the same from nf): bin k = f0 * khi + klo with khi < f1 <= 64 (the
    wgmma's M); N = `n_tile`, 6 * f0 (real and imaginary parts, three
    bf16 parts each) rounded up to 8 (16 past 128, 32 past 256), shared
    by `split` warpgroups a column (1, 2 or 4: at most 128 each); `cols`
    columns a block, whose sums stay in registers for the whole walk down
    the rows; `rows` rows a stage (whole k16 steps of 16 rows); `stages`
    plane stages in flight; `smem` bytes of dynamic shared memory;
    `passes` over the planes (one for every nf it takes)."""
    f0: int
    f1: int
    n_tile: int
    split: int
    cols: int
    rows: int
    stages: int
    smem: int
    passes: int


def _mxu_smem(n_tile: int, cols: int, rows: int) -> int:
    """Kernel I's shared memory: a stage's A tiles (2048 bytes a column a
    step) and B tiles (32 * n_tile bytes), which at the end hold the
    products D (64 x n_tile + 1 x cols + 1 floats), then the plane ring (each
    stage the four planes' tiles, rows padded to cols + 4 floats, and the
    rows' sfs and const) and the mbarriers."""
    tiles = cols * (rows // 16) * (2048 + 32 * n_tile)
    region = -(-max(tiles, 64 * (n_tile + 1) * (cols + 1) * 4) // 128) * 128
    stage = 4 * rows * (cols + 4) + 2 * rows     # rows padded to cols + 4
    return region + MXU_STAGES * stage * 4 + MXU_STAGES * 8


def _mxu_plan(nf: int) -> MxuPlan:
    """Kernel I's plan for nf bins: the smallest low-digit width f0 that
    keeps the high digit under 64, so that one product of N = `n_tile`
    columns (split over 1, 2 or 4 warpgroups, at most 128 each) a column
    and 16 rows covers every bin; as many columns a warpgroup as keep its
    accumulators within 64 registers a thread (at most 32 a block); the
    most rows a stage (a multiple of 16, at most 128 and two entries a
    thread) whose shared memory fits. Raises beyond nf = 4096 (a call past
    that is split into ranges, `_ranges`)."""
    if not 1 <= nf <= MXU_MAX_NF:
        raise ValueError(f"nf={nf} frequency rows: kernel I takes 1 to "
                         f"{MXU_MAX_NF}")
    f0 = -(-nf // 64)
    step = 8 if 6 * f0 <= 128 else 16 if 6 * f0 <= 256 else 32
    n_tile = -(-6 * f0 // step) * step
    split = 1 if n_tile <= 128 else 2 if n_tile <= 256 else 4
    per_group = min(_MXU_ACC // (n_tile // split // 2),
                    _MXU_MAX_COLS * split // MXU_GROUPS)
    cols = MXU_GROUPS // split * per_group
    rows = max(16, min(_MXU_MAX_ROWS,
                       _MXU_ENTRIES * 128 * MXU_GROUPS // cols // 16 * 16))
    while _mxu_smem(n_tile, cols, rows) > MAX_SMEM:
        rows -= 16
    return MxuPlan(f0, -(-nf // f0), n_tile, split, cols, rows, MXU_STAGES,
                   _mxu_smem(n_tile, cols, rows), 1)


@contextlib.contextmanager
def _full_f32_matmul():
    """float32 products without TF32 on the card, for the plain version."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _split3(v):
    """v = hi + mid + lo, each part rounded to bfloat16 (to nearest even)
    and carried in v's type: kernel I's `split3`."""
    hi = v.to(torch.bfloat16).to(v.dtype)
    r1 = v - hi
    mid = r1.to(torch.bfloat16).to(v.dtype)
    return hi, mid, (r1 - mid).to(torch.bfloat16).to(v.dtype)


def reassign_mxu_plain(wr, wi, dr, di, const, Sfs, gamma, plan_params, mode,
                       flipud, nf, transform):
    """Plain-torch kernel I, step by step: the bins of `reassign4_plain`,
    taken in kernel I's bin ranges (`_ranges(nf, MXU_MAX_NF)`; a range's
    bins relative to its start), split into digits k = f0 * khi + klo by
    `_mxu_plan(rows)`, each value
    cut into its three bfloat16 parts (`_split3`), and per column the
    product of khi's one-hot (rows x 64 high digits) with the parts at
    their low digit (rows x 3 parts x f0), real and imaginary parts side
    by side as the kernel's N, summed over rows and parts in float32 by
    `einsum` in column chunks (one-hots under ~1 GB). Returns (Txr, Txi),
    each (..., nf, n)."""
    _check_transform(transform)
    _, wr, wi, dr, di, const, Sfs = _prepare4(wr, wi, dr, di, const, Sfs)
    w = phase_w(wr, wi, dr, di, Sfs, gamma, transform)
    k_all = bin_indices(w, mode, plan_params, flipud, nf)
    c = const[:, None]
    zero = torch.zeros((), dtype=wr.dtype, device=wr.device)
    batch, (na, n) = wr.shape[:-2], wr.shape[-2:]
    f1 = torch.arange(64, device=wr.device)
    tx = torch.empty((int(np.prod(batch)) if batch else 1, nf, 2, n),
                     dtype=wr.dtype, device=wr.device)
    for k0, rows in _ranges(nf, MXU_MAX_NF):
        f0 = _mxu_plan(rows).f0
        mask = (k_all >= k0) & (k_all < k0 + rows)
        k = k_all - k0
        vr = torch.where(mask, wr * c, zero)
        vi = torch.where(mask, wi * c, zero)
        khi = torch.where(mask, torch.div(k, f0, rounding_mode="floor"), -1)
        klo = torch.where(mask, k % f0, 0)
        lo = torch.arange(f0, device=wr.device)
        step = max(1, (1 << 30) // (na * 4 * (64 + 2 * 3 * f0)))
        khi, klo, vr, vi = (a.reshape(-1, na, n) for a in (khi, klo, vr, vi))
        out = torch.empty((khi.shape[0], 64 * f0, 2, n), dtype=wr.dtype,
                          device=wr.device)
        with _full_f32_matmul():
            for b in range(khi.shape[0]):
                for j0 in range(0, n, step):
                    cols = slice(j0, j0 + step)
                    A = (khi[b, :, cols, None] == f1).to(wr.dtype)
                    sel = klo[b, :, cols, None] == lo
                    Bm = torch.stack([torch.stack(
                        [torch.where(sel, p[..., None], zero)
                         for p in _split3(v[b, :, cols])], 2)
                        for v in (vr, vi)], 3)    # (rows, cols, 3, 2, f0)
                    out[b, :, :, cols] = torch.einsum(
                        "icf,icpzg->fgzc", A, Bm).reshape(64 * f0, 2, -1)
        tx[:, k0:k0 + rows] = out[:, :rows]
    return tuple(tx[:, :, z].reshape(batch + (nf, n)) for z in (0, 1))


def _mxu_dispatch(device, wr, wi, dr, di, const, Sfs, gamma, plan_params,
                  mode, flipud, nf, transform):
    """Kernel I (CUDA tensors) or `reassign_mxu_plain` (CPU tensors), on
    inputs `_prepare4` has checked; `reassign4`'s forward under
    SSQ_TPU_REASSIGN_IMPL=mxu."""
    if device.type == "cuda":
        if wr.dtype != torch.float32:
            raise ValueError("kernel I takes float32 planes only")
        plan = [_gamma2(gamma)] + _plan_floats(mode, plan_params)
        out, _ = _launch_ranges(
            "ssq_reassign_mxu", [wr, wi, dr, di], [const, Sfs],
            [TRANSFORMS[transform], MODES[mode], int(bool(flipud))], plan,
            nf, "reassign_mxu kernel", MXU_MAX_NF,
            lambda rows: (_mxu_plan(rows).n_tile,))
        return out
    if device.type == "cpu":
        return reassign_mxu_plain(wr, wi, dr, di, const, Sfs, gamma,
                                  plan_params, mode, flipud, nf, transform)
    raise ValueError(f"reassign_mxu: unsupported device {device}")
