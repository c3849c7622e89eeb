"""Kernels F, G and H: the hop-1 STFT family (counterpart of
``ssqueeze_rs_tpu/ops/stft_pallas.py``).

  * `stft_dft` (F, ``csrc/stft_dft.cu``): framing + the stacked
    windowed-DFT product; replaces `_make_kernel` + `_frames_dft_into`.
  * `ssq_stft_fused` (G, ``csrc/ssq_stft.cu``): F's four planes, phase,
    linear bins and the deterministic reassignment in one kernel; replaces
    `_make_ssq_stft_kernel`.
  * `istft_ola` (H, ``csrc/istft_ola.cu``): irfft product + overlap-add;
    replaces `_make_istft_kernel`.

Each wrapper dispatches on the device of its inputs: on a CUDA tensor it
launches its kernel or raises; on a CPU tensor it runs its plain-torch
version (beside it, `*_plain`). `LAUNCHES` counts kernel launches per
kernel. The gates `ssq_stft_fused_ok` and `istft_ola_ok` decide from shapes
alone whether a kernel's shared-memory plan fits.

Gradients follow the JAX package's custom VJPs, with no kernel of their
own: F and H are linear and each one's adjoint is the other's math, so
F's backward (`StftDftFn`) launches H and H's (`IstftOlaFn`) launches F;
G's (`SsqStftFusedFn`) recomputes F's planes, runs the 4-plane VJP gather
C' on them and H on the summed Sx cotangents.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as nnf
from torch.autograd.function import once_differentiable

from .fft_cuda import _device_of, _f32, _zeros_for
from .reassign_cuda import (MAX_SMEM, MODES, _gamma2, _plan_floats,
                            reassign4_plain, reassign4_bwd)

__all__ = ["stft_dft", "stft_dft_plain", "stft_dft_vjp", "ssq_stft_fused",
           "ssq_stft_fused_plain", "ssq_stft_fused_ok", "istft_ola",
           "istft_ola_plain", "istft_ola_vjp", "istft_ola_ok", "ola_plain",
           "StftDftFn", "IstftOlaFn", "SsqStftFusedFn", "LAUNCHES"]

LAUNCHES = {"stft_dft": 0, "ssq_stft": 0, "istft_ola": 0}
_BK = 16            # taps per K tile (csrc/dft_tile.cuh kBK)
_F_BM = 128         # rows per block of kernel F
_G_R = 64           # frequency rows per plane per chunk of kernel G
_H_T = 1536         # samples per block of kernel H
_H_KC = 4           # frequency rows per stage of kernel H
_H_SLICES = 8       # frequency slices of kernel H


def _taps(n_fft: int) -> int:
    """n_fft rounded up to whole K tiles."""
    return -(-n_fft // _BK) * _BK


def _rows2(a):
    """(..., n) -> (B, n) contiguous, and the leading shape."""
    batch = tuple(a.shape[:-1])
    return a.reshape((int(np.prod(batch)) if batch else 1, a.shape[-1])
                     ).contiguous(), batch


def _check_signal(xp, K_T, n_fft, n_out, what):
    if K_T.ndim != 2 or K_T.shape[1] != n_fft:
        raise ValueError(f"{what}: K_T must have shape (rows, {n_fft}) "
                         f"(got {tuple(K_T.shape)})")
    if xp.shape[-1] != n_out + n_fft - 1:
        raise ValueError(f"{what} requires xp.shape[-1] == n_out + n_fft - 1 "
                         f"(= {n_out + n_fft - 1}); got {xp.shape[-1]}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


# -- F: framing + windowed DFT -------------------------------------------------
def stft_dft_plain(xp, K_T, n_fft, n_out, fs=None):
    """Plain-torch kernel F: the frames as an `unfold` view, one
    `torch.matmul` with K_T, then the second half of the rows times fs."""
    frames = xp.unfold(-1, n_fft, 1)                  # (..., n_out, n_fft)
    out = torch.matmul(K_T, frames.transpose(-1, -2))
    if fs is not None:
        out[..., K_T.shape[0] // 2:, :] *= fs
    return out


def _stft_dft_cuda(device, xp, K_T, n_fft, n_out, fs):
    from .. import _build
    rows = K_T.shape[0]
    NP = _taps(n_fft)
    rows_pad = -(-rows // _F_BM) * _F_BM
    K = nnf.pad(K_T.t(), (0, rows_pad - rows, 0, NP - n_fft)).contiguous()
    x2, batch = _rows2(xp)
    B, mp = x2.shape
    out = torch.empty((B, rows, n_out), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _build.lib().ssq_stft_dft(
            x2.data_ptr(), K.data_ptr(), B, mp, NP, rows, rows_pad, n_out,
            float(fs if fs is not None else 1.0),
            rows // 2 if fs is not None else rows, out.data_ptr(),
            _stream(device))
    _build.check(err, "stft_dft kernel")
    LAUNCHES["stft_dft"] += 1
    return out.reshape(batch + (rows, n_out))


def stft_dft_vjp(g, K_T, n_fft: int, fs=None):
    """Adjoint of `stft_dft` in xp (the JAX package's `_stft_fused_bwd`):
    the transposed DFT, then overlap-add, gx[c] = sum_t (K_T^T g')[t, c-t]
    with g' = g, its derivative rows times fs. That is kernel H's math
    with Fr = K_T[:R/2]^T, Sr = g'[:R/2], Fs = -K_T[R/2:]^T, Si = g'[R/2:],
    so it runs `istft_ola` (H on CUDA, the plain version on the CPU).
    g: (..., R, n_out); returns (..., n_out + n_fft - 1)."""
    h = K_T.shape[0] // 2
    gs, gd = g[..., :h, :], g[..., h:, :]
    if fs is not None:
        gd = gd * fs
    return istft_ola(gs, gd, K_T[:h].t(), -K_T[h:].t(), n_fft)


class StftDftFn(torch.autograd.Function):
    """Kernel F with the JAX package's gradient: linear in xp, backward
    `stft_dft_vjp` (kernel H); K_T gets zero."""

    @staticmethod
    def forward(ctx, xp, K_T, n_fft, n_out, fs):
        ctx.save_for_backward(K_T)
        ctx.meta = (n_fft, fs)
        if xp.device.type == "cuda":
            return _stft_dft_cuda(xp.device, xp, K_T, n_fft, n_out, fs)
        return stft_dft_plain(xp, K_T, n_fft, n_out, fs)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        K_T, = ctx.saved_tensors
        return (stft_dft_vjp(g, K_T, *ctx.meta), *_zeros_for(ctx, [(1, K_T)]),
                None, None, None)


def stft_dft(xp, K_T, n_fft: int, n_out: int, fs=None):
    """Hop-1 framing + stacked windowed-DFT product.

    xp: (..., n_out + n_fft - 1) float32 padded signal; K_T: (rows, n_fft)
    stacked [Sr; Si(; dSr; dSi)] DFT matrices. Returns (..., rows, n_out)
    float32; with `fs`, the second half of the rows (the derivative
    planes) is multiplied by fs. Differentiable in xp (`StftDftFn`)."""
    device = _device_of(xp)
    xp, K_T = _f32(xp, device), _f32(K_T, device)
    _check_signal(xp, K_T, n_fft, n_out, "stft_dft")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"stft_dft: unsupported device {device}")
    return StftDftFn.apply(xp, K_T, n_fft, n_out, fs)


# -- G: the fused ssq_stft ---------------------------------------------------
def _ssq_cols(nf: int, n_fft: int):
    """Columns per block of kernel G: the largest of 32, 16, 8 whose
    shared memory (csrc/ssq_stft.cu Shape::smem: the (2, nf, T)
    accumulator, the chunk's planes and bins, the K tiles and the signal
    window) fits; None if none does."""
    for T in (32, 16, 8):
        floats = (2 * nf * T + 5 * _G_R * T + 2 * _BK * 4 * _G_R +
                  T + _taps(n_fft))
        if 4 * floats <= MAX_SMEM:
            return T
    return None


def ssq_stft_fused_ok(n_fft: int) -> bool:
    """Whether kernel G's shared-memory plan fits at this n_fft (decided
    by shape alone)."""
    return _ssq_cols(n_fft // 2 + 1, n_fft) is not None


def _ssq_stft_planes_plain(xp, K_T, n_fft, n_out, fs, Sfs, const, gamma,
                           plan_params, mode, flipud):
    nf = K_T.shape[0] // 4
    sxr, sxi, dsr, dsi = stft_dft_plain(xp, K_T, n_fft, n_out, fs).split(
        nf, dim=-2)
    txr, txi = reassign4_plain(sxr, sxi, dsr, dsi, const, Sfs, gamma,
                               plan_params, mode, flipud, nf, "stft")
    return txr, txi, sxr, sxi


def ssq_stft_fused_plain(xp, K_T, n_fft, n_out, fs, Sfs, const, gamma,
                         plan_params, mode, flipud):
    """Plain-torch kernel G: plain F, then plain B' (phase, bins and
    `scatter_add_`)."""
    txr, txi, sxr, sxi = _ssq_stft_planes_plain(
        xp, K_T, n_fft, n_out, fs, Sfs, const, gamma, plan_params, mode,
        flipud)
    return torch.complex(txr, txi), torch.complex(sxr, sxi)


def _ssq_stft_cuda(device, xp, K_T, n_fft, n_out, fs, Sfs, const, gamma,
                   plan_params, mode, flipud):
    from .. import _build
    nf = K_T.shape[0] // 4
    cols = _ssq_cols(nf, n_fft)
    if cols is None:
        raise ValueError(f"ssq_stft_fused: n_fft={n_fft} does not fit the "
                         "kernel's shared memory (see ssq_stft_fused_ok)")
    plan = _plan_floats(mode, plan_params)
    NP = _taps(n_fft)
    nc = -(-nf // _G_R)
    # Kg[t, 256c + 64p + r] = plane p's row 64c + r at tap t
    K4 = nnf.pad(K_T.reshape(4, nf, n_fft), (0, NP - n_fft, 0, nc * _G_R - nf))
    Kg = K4.reshape(4, nc, _G_R, NP).permute(3, 1, 0, 2).reshape(
        NP, nc * 4 * _G_R).contiguous()
    x2, batch = _rows2(xp)
    B, mp = x2.shape
    outs = [torch.empty((B, nf, n_out), dtype=torch.float32, device=device)
            for _ in range(4)]
    with torch.cuda.device(device):
        err = _build.lib().ssq_stft_fused(
            x2.data_ptr(), Kg.data_ptr(), B, mp, NP, nf, nc, n_out,
            float(fs), const.contiguous().data_ptr(),
            Sfs.contiguous().data_ptr(), _gamma2(gamma), MODES[mode],
            int(bool(flipud)), *plan, cols, *(o.data_ptr() for o in outs),
            _stream(device))
    _build.check(err, "ssq_stft kernel")
    LAUNCHES["ssq_stft"] += 1
    return tuple(o.reshape(batch + (nf, n_out)) for o in outs)


class SsqStftFusedFn(torch.autograd.Function):
    """Kernel G with the JAX package's gradient (`_ssq_mega_bwd`, the
    two-kernel route's VJP): the backward recomputes F's four planes
    (kernel F), runs the 4-plane VJP gather C' on the Tx cotangents, adds
    the Sx cotangents and takes F's adjoint over the Sx rows (kernel H).
    The dS rows, fs, const and Sfs get zero. Saves xp, K_T, Sfs and const
    (the JAX residuals). Returns the planes (Txr, Txi, Sxr, Sxi)."""

    @staticmethod
    def forward(ctx, xp, K_T, n_fft, n_out, fs, Sfs, const, gamma,
                plan_params, mode, flipud):
        ctx.save_for_backward(xp, K_T, Sfs, const)
        ctx.meta = (n_fft, n_out, fs, gamma, plan_params, mode, flipud)
        args = (xp, K_T, n_fft, n_out, fs, Sfs, const, gamma, plan_params,
                mode, flipud)
        if xp.device.type == "cuda":
            return _ssq_stft_cuda(xp.device, *args)
        return _ssq_stft_planes_plain(*args)

    @staticmethod
    @once_differentiable
    def backward(ctx, gtxr, gtxi, gsxr, gsxi):
        xp, K_T, Sfs, const = ctx.saved_tensors
        n_fft, n_out, fs, gamma, plan_params, mode, flipud = ctx.meta
        nf = K_T.shape[0] // 4
        sxr, sxi, dsr, dsi = stft_dft(xp, K_T, n_fft, n_out, fs).split(
            nf, dim=-2)
        gwr, gwi = reassign4_bwd(sxr, sxi, dsr, dsi, const, Sfs, gtxr, gtxi,
                                 gamma, plan_params, mode, flipud, nf, "stft")
        del sxr, sxi, dsr, dsi
        gxp = istft_ola(gsxr + gwr, gsxi + gwi, K_T[:nf].t(),
                        -K_T[nf:2 * nf].t(), n_fft)
        return (gxp, *_zeros_for(ctx, [(1, K_T)]), None, None, None,
                *_zeros_for(ctx, [(5, Sfs), (6, const)]), None, None, None,
                None)


def ssq_stft_fused(xp, K_T, n_fft: int, n_out: int, fs, Sfs, const, gamma,
                   plan_params, mode: str, flipud: bool):
    """Whole hop-1 ssq_stft: framing, the four DFT planes (dS times fs),
    w = |Sfs - Im(dS/S)/2pi|, the bins of `mode` and the reassignment.

    xp: (..., n_out + n_fft - 1) float32; K_T: (4 nf, n_fft) stacked
    [Sr; Si; dSr; dSi] DFT matrices (fs not folded in); Sfs, const: (nf,);
    entries with |Sx|^2 <= gamma^2 are masked. Returns complex64
    (Tx, Sx), each (..., nf, n_out). Differentiable in xp
    (`SsqStftFusedFn`)."""
    device = _device_of(xp)
    xp, K_T, Sfs, const = (_f32(a, device) for a in (xp, K_T, Sfs, const))
    _check_signal(xp, K_T, n_fft, n_out, "ssq_stft_fused")
    nf = K_T.shape[0] // 4
    if K_T.shape[0] != 4 * nf or Sfs.shape != (nf,) or const.shape != (nf,):
        raise ValueError(f"ssq_stft_fused: K_T rows ({K_T.shape[0]}) must be "
                         f"4 * nf and Sfs, const (nf,)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"ssq_stft_fused: unsupported device {device}")
    txr, txi, sxr, sxi = SsqStftFusedFn.apply(
        xp, K_T, n_fft, n_out, fs, Sfs, const, gamma, plan_params, mode,
        flipud)
    return torch.complex(txr, txi), torch.complex(sxr, sxi)


# -- H: irfft product + overlap-add --------------------------------------------
def ola_plain(v, hop: int, out_len: int):
    """Overlap-add of the columns of v (..., n_fft, n_segs):
    out[..., t + i*hop] += v[..., t, i], one strided slice-add per t in
    increasing t: deterministic (no atomics, unlike index_add_ on CUDA)."""
    n_fft, n_segs = v.shape[-2:]
    G = (n_fft - 1) // hop + n_segs + 1
    out = torch.zeros(v.shape[:-2] + (G * hop,), dtype=v.dtype,
                      device=v.device)
    for t in range(n_fft):
        out[..., t:t + n_segs * hop:hop] += v[..., t, :]
    return out[..., :out_len]


def istft_ola_ok(n_fft: int) -> bool:
    """Whether kernel H's shared-memory plan (csrc/istft_ola.cu: 4 rows of
    both Sx planes over 1536 + NP columns and of both F' over NP taps)
    fits at this n_fft (decided by shape alone)."""
    NP = _taps(n_fft)
    return 4 * 2 * _H_KC * (_H_T + 2 * NP) <= MAX_SMEM


def istft_ola_plain(Sr, Si, Fr, Fs, n_fft):
    """Plain-torch kernel H: the two matrix products, then `ola_plain`."""
    v = torch.matmul(Fr, Sr) - torch.matmul(Fs, Si)
    return ola_plain(v, 1, v.shape[-1] + n_fft - 1)


def _istft_ola_cuda(device, Sr, Si, Fr, Fs, n_fft):
    from .. import _build
    if not istft_ola_ok(n_fft):
        raise ValueError(f"istft_ola: n_fft={n_fft} does not fit the "
                         "kernel's shared memory (see istft_ola_ok)")
    nf, n_segs = Sr.shape[-2:]
    batch = tuple(Sr.shape[:-2])
    B = int(np.prod(batch)) if batch else 1
    NP = _taps(n_fft)
    frT, fsT = (nnf.pad(F.t(), (0, NP - n_fft)).contiguous() for F in (Fr, Fs))
    k_slice = _H_KC * -(-nf // (_H_KC * _H_SLICES))
    nslices = -(-nf // k_slice)
    L = n_segs + n_fft - 1
    sr, si = (a.reshape(B, nf, n_segs).contiguous() for a in (Sr, Si))
    part = torch.empty((nslices, B, L), dtype=torch.float32, device=device)
    out = torch.empty((B, L), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _build.lib().ssq_istft_ola(
            sr.data_ptr(), si.data_ptr(), frT.data_ptr(), fsT.data_ptr(), B,
            nf, n_segs, NP, L, k_slice, nslices, part.data_ptr(),
            out.data_ptr(), _stream(device))
    _build.check(err, "istft_ola kernel")
    LAUNCHES["istft_ola"] += 1
    return out.reshape(batch + (L,))


def istft_ola_vjp(g, Fr, Fs, n_fft: int):
    """Adjoint of `istft_ola` in (Sr, Si) (the JAX package's
    `_istft_fused_bwd`): framing, then the transposed irfft products,
    gSr[k, n] = sum_t Fr[t, k] g[n + t], gSi[k, n] = -sum_t Fs[t, k]
    g[n + t]. That is kernel F's math with K_T = [Fr^T; -Fs^T], so it
    runs `stft_dft` (F on CUDA, the plain version on the CPU).
    g: (..., n_segs + n_fft - 1); returns (gSr, gSi), each
    (..., nf, n_segs)."""
    nf = Fr.shape[1]
    n_segs = g.shape[-1] - n_fft + 1
    out = stft_dft(g, torch.cat([Fr.t(), -Fs.t()]), n_fft, n_segs)
    return out[..., :nf, :], out[..., nf:, :]


class IstftOlaFn(torch.autograd.Function):
    """Kernel H with the JAX package's gradient: linear in (Sr, Si),
    backward `istft_ola_vjp` (kernel F); Fr and Fs get zero."""

    @staticmethod
    def forward(ctx, Sr, Si, Fr, Fs, n_fft):
        ctx.save_for_backward(Fr, Fs)
        ctx.n_fft = n_fft
        if Sr.device.type == "cuda":
            return _istft_ola_cuda(Sr.device, Sr, Si, Fr, Fs, n_fft)
        return istft_ola_plain(Sr, Si, Fr, Fs, n_fft)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        Fr, Fs = ctx.saved_tensors
        return (*istft_ola_vjp(g, Fr, Fs, ctx.n_fft),
                *_zeros_for(ctx, [(2, Fr), (3, Fs)]), None)


def istft_ola(Sr, Si, Fr, Fs, n_fft: int):
    """Hop-1 irfft product + overlap-add.

    Sr/Si: (..., nf, n_segs) float32 Sx planes; Fr/Fs: (n_fft, nf) irfft
    matrices with the window^win_exp factor folded into their rows.
    Returns (..., n_segs + n_fft - 1) float32, before the window-norm
    division: out[c] = sum_t (Fr @ Sr - Fs @ Si)[t, c - t].
    Differentiable in (Sr, Si) (`IstftOlaFn`)."""
    device = _device_of(Sr)
    Sr, Si, Fr, Fs = (_f32(a, device) for a in (Sr, Si, Fr, Fs))
    nf = Sr.shape[-2]
    if Si.shape != Sr.shape or Fr.shape != (n_fft, nf) or Fs.shape != Fr.shape:
        raise ValueError(f"istft_ola: planes {tuple(Sr.shape)}, "
                         f"{tuple(Si.shape)} and matrices {tuple(Fr.shape)}, "
                         f"{tuple(Fs.shape)} do not match (n_fft={n_fft})")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"istft_ola: unsupported device {device}")
    return IstftOlaFn.apply(Sr, Si, Fr, Fs, n_fft)
