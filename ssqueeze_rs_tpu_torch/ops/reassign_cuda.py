"""Kernel B: analytic binning + deterministic reassignment (counterpart
of ``ssqueeze_rs_tpu/ops/reassign_pallas.py``'s `reassign_pallas`, whose
Pallas body is `_make_kernel`), in its two input contracts:

  * `reassign` (B, 3 planes): Wx and the phase plane w, precomputed
    upstream (+inf where masked); `_make_kernel` with `phase_in=True`.
  * `reassign4` (B', 4 planes): Wx and dWx; w and the mask |Wx|^2 > gamma^2
    are formed in the kernel; `_make_kernel` with `phase_in=False`.

Both dispatch on the device of their inputs: on a CUDA tensor they
launch the hand-written kernel (``csrc/reassign.cu``: 16 lanes a column,
at the columns a block `_block_cols` takes from nf) or raise; on a CPU
tensor they run their plain-torch versions. Both are differentiable with
the JAX package's gradient semantics (`ReassignFn`, `Reassign4Fn`): the
backward is the VJP gather C / C' (`reassign_bwd`, `reassign4_bwd`,
``csrc/reassign_bwd.cu``; counterpart of `_make_bwd_kernel`), which
dispatches the same way.

The 4-plane contract has a second implementation, kernel I
(``csrc/reassign_mxu.cu``, plain version `reassign_mxu_plain`;
counterpart of `_make_mxu_kernel`): the same bins, summed as a
digit-split one-hot matrix product on the tensor cores. It has no entry
of its own: `reassign4` picks B' or I from
SSQ_TPU_REASSIGN_IMPL at each call ('vpu', the default, or 'mxu'; any
other value raises), as the JAX package's `reassign_pallas` does; the
3-plane `reassign` ignores it. Both share the backward C'.
`LAUNCHES` (B), `LAUNCHES4` (B'), `LAUNCHES_MXU` (I), `LAUNCHES_BWD` (C)
and `LAUNCHES4_BWD` (C') count kernel launches.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .fft_cuda import _device_of, _f32, _zeros_for

__all__ = ["reassign", "reassign_plain", "reassign4", "reassign4_plain",
           "reassign_bwd", "reassign_bwd_plain", "reassign4_bwd",
           "reassign4_bwd_plain", "ReassignFn", "Reassign4Fn", "phase_w",
           "bin_indices", "reassign_mxu_plain",
           "reassign_impl", "LAUNCHES", "LAUNCHES4", "LAUNCHES_MXU",
           "LAUNCHES_BWD", "LAUNCHES4_BWD"]

LAUNCHES = 0
LAUNCHES4 = 0
LAUNCHES_MXU = 0
LAUNCHES_BWD = 0
LAUNCHES4_BWD = 0
MODES = {"log": 0, "log-piecewise": 1, "lin": 2}
TRANSFORMS = {"cwt": 0, "stft": 1}
_PARAM_ORDER = {"log": ("vlmin", "dvl"),
                "log-piecewise": ("vlmin0", "vlmin1", "dvl0", "dvl1", "idx1"),
                "lin": ("vmin", "dv")}
MAX_SMEM = 227 * 1024       # per-block shared memory on Hopper
_TWO_PI = 6.283185307179586


def _block_cols(nf: int) -> int:
    """Columns a block (COLS) of csrc/reassign.cu, whose blocks have 16
    lanes a column: 32 where the (2, nf, 32) float32 accumulator fits in
    shared memory (nf <= 908), else 8 (16 columns were slower at nf = 1025
    on the card, PERF.md); raises beyond nf = 3632."""
    for cols in (32, 8):
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


def reassign_bwd_plain(w, const, gr, gi, plan_params, mode, flipud, nf):
    """Plain-torch kernel C: gW[i,j] = gTx[k(i,j), j] * const[i] with
    `torch.gather`, 0 where masked. gr/gi: (..., nf, n) cotangents of Tx.
    Returns (gWr, gWi), each (..., na, n)."""
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
            per_block=None):
    """Common launch of the C entry points: planes (..., na, n) and
    per-row vectors in. The forward ones (B, B', I and probe P4's 3-plane
    `full`; `grads` None) take one launch-shape int (B, B': the columns
    per block, `_block_cols`, unless `per_block` is given; I: `per_block`,
    its tiles per pass) and write (Txr, Txi), each (..., nf, n); the
    backward ones (C, C') read the cotangents `grads` = (gr, gi), each
    (..., nf, n), and write (gWr, gWi), each (..., na, n)."""
    from .. import _build
    device = planes[0].device
    na, n = planes[0].shape[-2:]
    batch = planes[0].shape[:-2]
    B = int(np.prod(batch)) if batch else 1
    planes = [t.contiguous() for t in planes]
    vecs = [t.contiguous() for t in vecs]
    if grads is None:
        mid = [_block_cols(nf) if per_block is None else per_block]
        rows = nf
    else:
        grads = [_f32(g, device).contiguous() for g in grads]
        if any(g.shape != batch + (nf, n) for g in grads):
            raise ValueError(f"{what}: cotangents " +
                             ", ".join(str(tuple(g.shape)) for g in grads) +
                             f" are not {batch + (nf, n)}")
        mid, rows = [g.data_ptr() for g in grads], na
    outs = [torch.empty(batch + (rows, n), dtype=torch.float32,
                        device=device) for _ in range(2)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(_build.lib())(
            *(t.data_ptr() for t in planes + vecs), B, na, n, nf, *ints,
            *plan, *mid, *(o.data_ptr() for o in outs), stream)
    _build.check(err, what)
    return tuple(outs)


def _reassign_dispatch(device, wr, wi, w, const, plan_params, mode, flipud,
                       nf):
    global LAUNCHES
    if device.type == "cuda":
        plan = _plan_floats(mode, plan_params)
        out = _launch(lambda lib: lib.ssq_reassign, [wr, wi, w], [const],
                      [MODES[mode], int(bool(flipud))], plan, nf,
                      "reassign kernel")
        LAUNCHES += 1
        return out
    if device.type == "cpu":
        return reassign_plain(wr, wi, w, const, plan_params, mode, flipud, nf)
    raise ValueError(f"reassign: unsupported device {device}")


def reassign_bwd(w, const, gr, gi, plan_params, mode, flipud, nf):
    """VJP gather of the 3-plane reassignment (kernel C): (gWr, gWi),
    each (..., na, n), from the cotangents gr/gi (..., nf, n) of (Txr,
    Txi); gW[i,j] = gTx[k(i,j), j] * const[i] with the bins of `reassign`,
    0 where masked. On a CUDA tensor it launches the kernel or raises; on
    a CPU tensor it runs `reassign_bwd_plain`."""
    global LAUNCHES_BWD
    device = _device_of(w)
    w, const = _f32(w, device), _f32(const, device)
    if device.type == "cuda":
        out = _launch(lambda lib: lib.ssq_reassign_bwd, [w], [const],
                      [MODES[mode], int(bool(flipud))],
                      _plan_floats(mode, plan_params), nf,
                      "reassign_bwd kernel", grads=(gr, gi))
        LAUNCHES_BWD += 1
        return out
    if device.type == "cpu":
        return reassign_bwd_plain(w, const, _f32(gr, device),
                                  _f32(gi, device), plan_params, mode,
                                  flipud, nf)
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
    the CPU) or tensors. Differentiable (`ReassignFn`: kernel C on CUDA)."""
    _, wr, wi, w, const = _prepare(wr, wi, w, const)
    return ReassignFn.apply(wr, wi, w, const, plan_params, mode, flipud, nf)


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


def reassign_impl() -> str:
    """The 4-plane implementation SSQ_TPU_REASSIGN_IMPL selects, read at
    call time: 'vpu' (the default, kernel B') or 'mxu' (kernel I). Unlike
    the JAX package, which takes any other value as 'vpu', an unknown
    value raises, so a typo cannot hide which kernel ran."""
    impl = os.environ.get("SSQ_TPU_REASSIGN_IMPL", "vpu")
    if impl not in ("vpu", "mxu"):
        raise ValueError("SSQ_TPU_REASSIGN_IMPL must be 'vpu' or 'mxu' "
                         f"(got {impl!r})")
    return impl


def _reassign4_dispatch(device, wr, wi, dr, di, const, Sfs, gamma,
                        plan_params, mode, flipud, nf, transform):
    global LAUNCHES4
    if reassign_impl() == "mxu":
        return _mxu_dispatch(device, wr, wi, dr, di, const, Sfs, gamma,
                             plan_params, mode, flipud, nf, transform)
    if device.type == "cuda":
        plan = [_gamma2(gamma)] + _plan_floats(mode, plan_params)
        out = _launch(lambda lib: lib.ssq_reassign4, [wr, wi, dr, di],
                      [const, Sfs],
                      [TRANSFORMS[transform], MODES[mode],
                       int(bool(flipud))], plan, nf, "reassign4 kernel")
        LAUNCHES4 += 1
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
    global LAUNCHES4_BWD
    _check_transform(transform)
    device, wr, wi, dr, di, const, Sfs = _prepare4(wr, wi, dr, di, const,
                                                   Sfs)
    if device.type == "cuda":
        plan = [_gamma2(gamma)] + _plan_floats(mode, plan_params)
        out = _launch(lambda lib: lib.ssq_reassign4_bwd, [wr, wi, dr, di],
                      [const, Sfs], [TRANSFORMS[transform], MODES[mode],
                                     int(bool(flipud))], plan, nf,
                      "reassign4_bwd kernel", grads=(gr, gi))
        LAUNCHES4_BWD += 1
        return out
    if device.type == "cpu":
        return reassign4_bwd_plain(wr, wi, dr, di, const, Sfs,
                                   _f32(gr, device), _f32(gi, device), gamma,
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
    as `reassign`. Returns (Txr, Txi), each (..., nf, n). Differentiable
    (`Reassign4Fn`: kernel C' on CUDA)."""
    _check_transform(transform)
    _, wr, wi, dr, di, const, Sfs = _prepare4(wr, wi, dr, di, const, Sfs)
    return Reassign4Fn.apply(wr, wi, dr, di, const, Sfs, gamma, plan_params,
                             mode, flipud, nf, transform)


# -- kernel I: the digit-split tensor-core scatter ------------------------------
TILE_BINS = 256          # bins per tile of kernel I: 16 high x 16 low digits


def _mxu_tiles_per_pass(nf: int) -> int:
    """Tiles (of 256 bins) that one pass of kernel I keeps in registers:
    at most 4, the tiles spread evenly over ceil(tiles / 4) passes."""
    tiles = -(-nf // TILE_BINS)
    passes = -(-tiles // 4)
    return -(-tiles // passes)


@contextlib.contextmanager
def _full_f32_matmul():
    """float32 products without TF32 on the card, for the plain version."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def reassign_mxu_plain(wr, wi, dr, di, const, Sfs, gamma, plan_params, mode,
                       flipud, nf, transform):
    """Plain-torch kernel I: the bins of `reassign4_plain`, split into
    digits k = 16*khi + klo, and per column the product of khi's one-hot
    (F1 x na) with v times klo's one-hot (na x 16), by `einsum` over the
    rows in column chunks (one-hots under ~1 GB). Returns (Txr, Txi),
    each (..., nf, n)."""
    _check_transform(transform)
    _, wr, wi, dr, di, const, Sfs = _prepare4(wr, wi, dr, di, const, Sfs)
    w = phase_w(wr, wi, dr, di, Sfs, gamma, transform)
    k = bin_indices(w, mode, plan_params, flipud, nf)
    mask = k >= 0
    c = const[:, None]
    zero = torch.zeros((), dtype=wr.dtype, device=wr.device)
    vr, vi = torch.where(mask, wr * c, zero), torch.where(mask, wi * c, zero)
    khi, klo = k >> 4, k & 15          # k = -1: khi = -1 matches no row
    batch, (na, n) = wr.shape[:-2], wr.shape[-2:]
    F1 = -(-nf // 16)
    f1 = torch.arange(F1, device=wr.device)
    f0 = torch.arange(16, device=wr.device)
    step = max(1, (1 << 30) // (na * (4 * F1 + 144)))
    khi, klo, vr, vi = (a.reshape(-1, na, n) for a in (khi, klo, vr, vi))
    outs = [torch.empty((khi.shape[0], F1 * 16, n), dtype=wr.dtype,
                        device=wr.device) for _ in range(2)]
    with _full_f32_matmul():
        for b in range(khi.shape[0]):
            for j0 in range(0, n, step):
                cols = slice(j0, j0 + step)
                A = (khi[b, :, cols, None] == f1).to(wr.dtype)
                sel = klo[b, :, cols, None] == f0
                for out, v in zip(outs, (vr, vi)):
                    Bm = torch.where(sel, v[b, :, cols, None], zero)
                    out[b, :, cols] = torch.einsum(
                        "icf,icg->fgc", A, Bm).reshape(F1 * 16, -1)
    return tuple(o[:, :nf].reshape(batch + (nf, n)) for o in outs)


def _mxu_dispatch(device, wr, wi, dr, di, const, Sfs, gamma, plan_params,
                  mode, flipud, nf, transform):
    """Kernel I (CUDA tensors) or `reassign_mxu_plain` (CPU tensors), on
    inputs `_prepare4` has checked; `reassign4`'s forward under
    SSQ_TPU_REASSIGN_IMPL=mxu."""
    global LAUNCHES_MXU
    if device.type == "cuda":
        plan = [_gamma2(gamma)] + _plan_floats(mode, plan_params)
        out = _launch(lambda lib: lib.ssq_reassign_mxu, [wr, wi, dr, di],
                      [const, Sfs], [TRANSFORMS[transform], MODES[mode],
                                     int(bool(flipud))], plan, nf,
                      "reassign_mxu kernel",
                      per_block=_mxu_tiles_per_pass(nf))
        LAUNCHES_MXU += 1
        return out
    if device.type == "cpu":
        return reassign_mxu_plain(wr, wi, dr, di, const, Sfs, gamma,
                                  plan_params, mode, flipud, nf, transform)
    raise ValueError(f"reassign_mxu: unsupported device {device}")
