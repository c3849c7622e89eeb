"""Kernels F, G and H: the hop-1 STFT family (counterpart of
``ssqueeze_rs_tpu/ops/stft_pallas.py``).

  * `stft_dft` (F, ``csrc/stft_dft.cu``): framing + the windowed DFT of
    every frame; replaces `_make_kernel` + `_frames_dft_into`. The plain
    version is the product with the stacked dense matrix K_T; the kernel
    computes the same function from its structure (`DftSpec`: tap windows,
    per-bin factors) as a chirp-z transform on the register-radix FFT
    core, from host tables built once per window (`bluestein_tables`).
  * `ssq_stft_fused` (G, ``csrc/ssq_stft.cu``): F's four planes (F's
    chirp-z frame routine on F's tables, so Sx is F's bit for bit), phase,
    linear bins and the deterministic reassignment in one kernel; replaces
    `_make_ssq_stft_kernel`. Its frames a block come from `_ssq_plan`.
  * `istft_ola` (H, ``csrc/istft_ola.cu``): irfft product + overlap-add;
    replaces `_make_istft_kernel`. The plain version is the two products
    with Fr, Fs and a slice-add overlap-add; the kernel computes F's
    adjoint from the same structure (the `DftSpec` of [Fr^T; -Fs^T]): a
    chirp-z transform a frame on F's tables, run backwards, and an
    overlap-add in a fixed order.

Each wrapper dispatches on the device of its inputs: on a CUDA tensor it
launches its kernel or raises (also when the caller gives no `DftSpec`);
on a CPU tensor it runs its plain-torch version (beside it,
`*_plain`).
Each launch goes through `_build.launch`, which counts it in
`trace.COUNTS` (`launch.ssq_stft_dft` for F, `launch.ssq_stft_fused` for
G, `launch.ssq_istft_ola` for H). The gates
`ssq_stft_fused_ok` and `istft_ola_ok` decide from shapes alone whether a
kernel takes an n_fft (G's shared-memory plan, H's transform length).

Gradients follow the JAX package's custom VJPs, with no kernel of their
own: F and H are linear and each one's adjoint is the other's math, so
F's backward (`StftDftFn`) launches H and H's (`IstftOlaFn`) launches F;
G's (`SsqStftFusedFn`) recomputes F's planes, runs the 4-plane VJP gather
C' on them and H on the summed Sx cotangents.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..trace import span
from .fft_cuda import _device_of, _f32, _zeros_for
from .reassign_cuda import (MAX_SMEM, MODES, _gamma2, _plan_floats,
                            reassign4_plain, reassign4_bwd)

__all__ = ["DftSpec", "bluestein_tables", "stft_dft", "stft_dft_plain",
           "stft_dft_vjp", "ssq_stft_fused",
           "ssq_stft_fused_plain", "ssq_stft_fused_ok", "istft_ola",
           "istft_ola_plain", "istft_ola_vjp", "istft_ola_ok", "ola_plain",
           "StftDftFn", "IstftOlaFn", "SsqStftFusedFn"]

_H_FRAMES = 64      # frames a block of kernel H (csrc/istft_ola.cu kFrames)
_MAX_Q = 4096       # the register-radix core's largest transform


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
class DftSpec(NamedTuple):
    """The structure of a stacked DFT matrix K_T, which kernel F computes
    from: for each tap window v_w (float64 bytes, one or two), rows
    [Re; Im] of X_w[k] = c_k sum_t v_w[t] x[t] e^{-2 pi i k t / n_fft},
    k < nf = n_fft // 2 + 1, with c_k = weight_k (`weights`, float64
    bytes; ones if None) times e^{2 pi i k (n_fft // 2) / n_fft} if
    `modulated`. The STFT (window and derivative window), G's recomputed
    planes and H's adjoint ([Fr^T; -Fs^T], weights 2/n or 1/n, the
    window^win_exp taps) all have it (`ops/stft.py` `_dft_spec`,
    `_irfft_spec`)."""
    n_fft: int
    windows: Tuple[bytes, ...]
    modulated: bool
    weights: Optional[bytes] = None

    @property
    def nf(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def rows(self) -> int:
        return 2 * len(self.windows) * self.nf

    def bin_factors(self) -> np.ndarray:
        """c_k (complex128, nf); the phase's angle from k (n//2) mod n in
        integers."""
        n, k = self.n_fft, np.arange(self.nf)
        c = np.ones(self.nf, np.complex128)
        if self.modulated:
            c = np.exp(2j * np.pi * ((k * (n // 2)) % n) / n)
        if self.weights is not None:
            c = c * np.frombuffer(self.weights, np.float64)
        return c

    def dense(self, dtype=np.float32) -> np.ndarray:
        """The stacked K_T (rows, n_fft) this structure stands for, from
        float64 (the plain version's float32 by default)."""
        n = self.n_fft
        t, k = np.arange(n), np.arange(self.nf)
        F = np.exp(-2j * np.pi * (np.outer(t, k) % n) / n) * self.bin_factors()
        mats = []
        for w in self.windows:
            Fw = F * np.frombuffer(w, np.float64)[:, None]
            mats += [Fw.real, Fw.imag]
        return np.ascontiguousarray(
            np.concatenate(mats, axis=1).T.astype(dtype))


def _chirp(m, n):
    """e^{-i pi m^2 / n}, the angle from m^2 mod 2n in integers (exact at
    any m)."""
    m = np.asarray(m, np.int64)
    return np.exp(-1j * np.pi * ((m * m) % (2 * n)) / n)


def _bluestein_q(n_fft: int) -> int:
    """Q of the chirp-z transform at n_fft: the power of two >= n_fft +
    nf - 1, at least 4."""
    return 1 << max(2, (n_fft + n_fft // 2 - 1).bit_length())


@lru_cache(maxsize=64)
def bluestein_tables(spec: DftSpec):
    """Kernel F's host tables for `spec`, float64 then complex64: Q (the
    power of two >= n_fft + nf - 1, at least 4), A (W, n_fft) = v_w[t]
    chirp(t), B (Q,) = FFT(b) / Q of the circular filter b[m] =
    conj chirp(m) at m in (-n_fft, nf), and D (nf,) = c_k chirp(k). Then
    X_w[k] = D[k] IFFT_Q(FFT_Q(A_w x) B)[k] Q (unnormalised inverse)."""
    n, nf = spec.n_fft, spec.nf
    Q = _bluestein_q(n)
    A = np.stack([np.frombuffer(w, np.float64) * _chirp(np.arange(n), n)
                  for w in spec.windows])
    b = np.zeros(Q, np.complex128)
    b[:nf] = np.conj(_chirp(np.arange(nf), n))
    m = np.arange(1, n)
    b[Q - m] = np.conj(_chirp(m, n))
    B = np.fft.fft(b) / Q
    D = spec.bin_factors() * _chirp(np.arange(nf), n)
    return Q, A.astype(np.complex64), B.astype(np.complex64), \
        D.astype(np.complex64)


@lru_cache(maxsize=64)
def _tables_on(spec: DftSpec, device):
    """`bluestein_tables` on `device` (uploaded once per window)."""
    Q, A, B, D = bluestein_tables(spec)
    return (Q,) + tuple(torch.as_tensor(t, device=device) for t in (A, B, D))


def stft_dft_plain(xp, K_T, n_fft, n_out, fs=None):
    """Plain-torch kernel F: the frames as an `unfold` view, one
    `torch.matmul` with K_T, then the second half of the rows times fs."""
    frames = xp.unfold(-1, n_fft, 1)                  # (..., n_out, n_fft)
    out = torch.matmul(K_T, frames.transpose(-1, -2))
    if fs is not None:
        out[..., K_T.shape[0] // 2:, :] *= fs
    return out


def _check_spec(spec, K_T, n_fft, fs, what="stft_dft"):
    if spec is None:
        raise ValueError(f"{what} on CUDA computes from the DFT's structure: "
                         "pass the DftSpec that K_T stands for (spec=)")
    if spec.n_fft != n_fft or spec.rows != K_T.shape[0] or \
            len(spec.windows) not in (1, 2):
        raise ValueError(f"{what}: spec (n_fft={spec.n_fft}, {spec.rows} "
                         f"rows) does not match K_T {tuple(K_T.shape)}")
    if fs is not None and len(spec.windows) != 2:
        raise ValueError(f"{what}: fs scales the second window's planes; "
                         "a one-window spec takes none")


def _stft_dft_cuda(device, xp, K_T, n_fft, n_out, fs, spec):
    from .. import _build
    _check_spec(spec, K_T, n_fft, fs)
    Q, A, Bt, D = _tables_on(spec, device)
    W, rows = len(spec.windows), K_T.shape[0]
    x2, batch = _rows2(xp)
    B, mp = x2.shape
    out = torch.empty((B, rows, n_out), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        _build.launch(
            "ssq_stft_dft", x2.data_ptr(), A.data_ptr(), Bt.data_ptr(),
            D.data_ptr(), B, mp, n_fft, spec.nf, W, Q.bit_length() - 1,
            n_out, float(fs if fs is not None else 1.0),
            int(fs is not None and W == 2), out.data_ptr(), _stream(device),
            what="stft_dft kernel")
    return out.reshape(batch + (rows, n_out))


def stft_dft_vjp(g, K_T, n_fft: int, fs=None, spec=None):
    """Adjoint of `stft_dft` in xp (the JAX package's `_stft_fused_bwd`):
    the transposed DFT, then overlap-add, gx[c] = sum_t (K_T^T g')[t, c-t]
    with g' = g, its derivative rows times fs. That is kernel H's math
    with Fr = K_T[:R/2]^T, Sr = g'[:R/2], Fs = -K_T[R/2:]^T, Si = g'[R/2:]
    ([Fr^T; -Fs^T] is K_T itself, so its structure is F's `spec`), so it
    runs `istft_ola` (H on CUDA, the plain version on the CPU).
    g: (..., R, n_out); returns (..., n_out + n_fft - 1)."""
    h = K_T.shape[0] // 2
    gs, gd = g[..., :h, :], g[..., h:, :]
    if fs is not None:
        gd = gd * fs
    return istft_ola(gs, gd, K_T[:h].t(), -K_T[h:].t(), n_fft, adjoint=spec)


class StftDftFn(torch.autograd.Function):
    """Kernel F with the JAX package's gradient: linear in xp, backward
    `stft_dft_vjp` (kernel H, on the forward's structure); K_T gets
    zero."""

    @staticmethod
    def forward(ctx, xp, K_T, n_fft, n_out, fs, spec):
        ctx.save_for_backward(K_T)
        ctx.meta = (n_fft, fs, spec)
        if xp.device.type == "cuda":
            return _stft_dft_cuda(xp.device, xp, K_T, n_fft, n_out, fs, spec)
        return stft_dft_plain(xp, K_T, n_fft, n_out, fs)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        K_T, = ctx.saved_tensors
        return (stft_dft_vjp(g, K_T, *ctx.meta), *_zeros_for(ctx, [(1, K_T)]),
                None, None, None, None)


def stft_dft(xp, K_T, n_fft: int, n_out: int, fs=None, spec=None):
    """Hop-1 framing + windowed DFT of every frame.

    xp: (..., n_out + n_fft - 1) float32 padded signal; K_T: (rows, n_fft)
    stacked [Sr; Si(; dSr; dSi)] DFT matrices; `spec`: the `DftSpec` K_T
    stands for, which kernel F computes from (needed on CUDA; the plain
    version takes K_T). Returns (..., rows, n_out) float32; with `fs`, the
    second half of the rows (the derivative planes) is multiplied by fs.
    Differentiable in xp (`StftDftFn`)."""
    device = _device_of(xp)
    xp, K_T = _f32(xp, device), _f32(K_T, device)
    _check_signal(xp, K_T, n_fft, n_out, "stft_dft")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"stft_dft: unsupported device {device}")
    return StftDftFn.apply(xp, K_T, n_fft, n_out, fs, spec)


# -- G: the fused ssq_stft ---------------------------------------------------
def _core_shape(Q: int):
    """(NCOL, float2 of the twiddle tables and both exchange buffers) of
    the register-radix core at Q points (csrc/fft_radix.cuh Shape<log2 Q>:
    16 points a lane where radix-16 passes need fewer passes than radix 8,
    else min(8, Q); U slots a thread of 256; a column's stride LD)."""
    log = Q.bit_length() - 1
    le = 4 if -(-log // 4) < -(-log // 3) else min(3, log)
    tpc = Q >> le
    units = 2 if Q < 8 else (2 if Q == 4096 else 1) * 16 >> le
    ncol = units * 256 // tpc
    ld = Q + (Q >> le) + (1 if ncol >= 16 else 16 // ncol)
    npass = -(-log // le)
    tw = Q + sum(1 << (le * (p + 1)) for p in range(1, npass - 1))
    return ncol, tw + 2 * ncol * ld


def _ssq_smem(n_fft: int, T: int, SS: int) -> int:
    """Bytes of kernel G's shared memory (csrc/ssq_stft.cu smem_bytes): the
    core, or the (2, nf, T) accumulator that takes its place after the last
    round; the staged entries' values (2, nf, SS) and bins (nf, SS) int16;
    the signal window."""
    nf = n_fft // 2 + 1
    core = 8 * _core_shape(_bluestein_q(n_fft))[1]
    front = max(core, 8 * nf * T)
    return front + 10 * nf * SS + 4 * (T + n_fft)


@lru_cache(maxsize=None)
def _ssq_plan(n_fft: int):
    """(T, SS) of kernel G at this n_fft: T frames a block, the largest of
    256 .. 1 whose shared memory fits, and SS the frame stride of the staged
    entries. Where the core has NCOL < 32 columns, a warp's round stores
    (i = lane + const, frame = col) are free of bank conflicts when
    SS = NCOL mod 32; that stride is taken where it fits, else SS = T.
    None where nothing fits or the transform is too long for the core."""
    Q = _bluestein_q(n_fft)
    if Q > _MAX_Q:
        return None
    ncol = _core_shape(Q)[0]
    for T in (256, 128, 64, 32, 16, 8, 4, 2, 1):
        strides = [T]
        if ncol < 32:
            strides.insert(0, T + (ncol - T) % 32)
        for SS in strides:
            if _ssq_smem(n_fft, T, SS) <= MAX_SMEM:
                return T, SS
    return None


def ssq_stft_fused_ok(n_fft: int) -> bool:
    """Whether kernel G's shared-memory plan fits at this n_fft (decided
    by shape alone)."""
    return _ssq_plan(n_fft) is not None


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
    with span("ssq.pack"):
        return torch.complex(txr, txi), torch.complex(sxr, sxi)


def _ssq_stft_cuda(device, xp, K_T, n_fft, n_out, fs, Sfs, const, gamma,
                   plan_params, mode, flipud, spec):
    from .. import _build
    _check_spec(spec, K_T, n_fft, fs, "ssq_stft_fused")
    plan = _ssq_plan(n_fft)
    if plan is None:
        raise ValueError(f"ssq_stft_fused: n_fft={n_fft} does not fit the "
                         "kernel's shared memory (see ssq_stft_fused_ok)")
    T, SS = plan
    nf = spec.nf
    Q, A, Bt, D = _tables_on(spec, device)
    x2, batch = _rows2(xp)
    B, mp = x2.shape
    outs = [torch.empty((B, nf, n_out), dtype=torch.float32, device=device)
            for _ in range(4)]
    with torch.cuda.device(device):
        _build.launch(
            "ssq_stft_fused", x2.data_ptr(), A.data_ptr(), Bt.data_ptr(),
            D.data_ptr(), B, mp, n_fft, nf, Q.bit_length() - 1, n_out,
            float(fs), const.contiguous().data_ptr(),
            Sfs.contiguous().data_ptr(), _gamma2(gamma), MODES[mode],
            int(bool(flipud)), *_plan_floats(mode, plan_params), T, SS,
            *(o.data_ptr() for o in outs), _stream(device),
            what="ssq_stft kernel")
    return tuple(o.reshape(batch + (nf, n_out)) for o in outs)


class SsqStftFusedFn(torch.autograd.Function):
    """Kernel G with the JAX package's gradient (`_ssq_mega_bwd`, the
    two-kernel route's VJP): the backward recomputes F's four planes
    (kernel F), runs the 4-plane VJP gather C' on the Tx cotangents, adds
    the Sx cotangents and takes F's adjoint over the Sx rows (kernel H, on
    the structure of the first window).
    The dS rows, fs, const and Sfs get zero. Saves xp, K_T, Sfs and const
    (the JAX residuals). Returns the planes (Txr, Txi, Sxr, Sxi)."""

    @staticmethod
    def forward(ctx, xp, K_T, n_fft, n_out, fs, Sfs, const, gamma,
                plan_params, mode, flipud, spec):
        ctx.save_for_backward(xp, K_T, Sfs, const)
        ctx.meta = (n_fft, n_out, fs, gamma, plan_params, mode, flipud)
        ctx.spec = spec
        args = (xp, K_T, n_fft, n_out, fs, Sfs, const, gamma, plan_params,
                mode, flipud)
        if xp.device.type == "cuda":
            return _ssq_stft_cuda(xp.device, *args, spec)
        return _ssq_stft_planes_plain(*args)

    @staticmethod
    @once_differentiable
    def backward(ctx, gtxr, gtxi, gsxr, gsxi):
        xp, K_T, Sfs, const = ctx.saved_tensors
        n_fft, n_out, fs, gamma, plan_params, mode, flipud = ctx.meta
        nf = K_T.shape[0] // 4
        sxr, sxi, dsr, dsi = stft_dft(xp, K_T, n_fft, n_out, fs,
                                      spec=ctx.spec).split(nf, dim=-2)
        gwr, gwi = reassign4_bwd(sxr, sxi, dsr, dsi, const, Sfs, gtxr, gtxi,
                                 gamma, plan_params, mode, flipud, nf, "stft")
        del sxr, sxi, dsr, dsi
        # [Fr^T; -Fs^T] = K_T's first 2 nf rows: the spec's first window
        spec = ctx.spec
        adjoint = None if spec is None else DftSpec(
            spec.n_fft, spec.windows[:1], spec.modulated, spec.weights)
        gxp = istft_ola(gsxr + gwr, gsxi + gwi, K_T[:nf].t(),
                        -K_T[nf:2 * nf].t(), n_fft, adjoint=adjoint)
        return (gxp, *_zeros_for(ctx, [(1, K_T)]), None, None, None,
                *_zeros_for(ctx, [(5, Sfs), (6, const)]), None, None, None,
                None, None)


def ssq_stft_fused(xp, K_T, n_fft: int, n_out: int, fs, Sfs, const, gamma,
                   plan_params, mode: str, flipud: bool, spec=None):
    """Whole hop-1 ssq_stft: framing, the four DFT planes (dS times fs),
    w = |Sfs - Im(dS/S)/2pi|, the bins of `mode` and the reassignment.

    xp: (..., n_out + n_fft - 1) float32; K_T: (4 nf, n_fft) stacked
    [Sr; Si; dSr; dSi] DFT matrices (fs not folded in); Sfs, const: (nf,);
    entries with |Sx|^2 <= gamma^2 are masked; `spec`: the `DftSpec` of
    K_T, which kernel G and the backward's kernels F and H compute from
    (needed on CUDA; the plain version takes K_T). Returns complex64
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
        flipud, spec)
    with span("ssq.pack"):
        return torch.complex(txr, txi), torch.complex(sxr, sxi)


# -- H: irfft product + overlap-add -------------------------------------------
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
    """Whether kernel H takes this n_fft (decided by shape alone): its
    chirp-z transform of Q >= n_fft + nf - 1 points fits the
    register-radix core (Q <= 4096, so n_fft <= 2731; the shared memory
    then holds the core's buffers, the frame buffer and the span)."""
    return _bluestein_q(n_fft) <= _MAX_Q


def istft_ola_plain(Sr, Si, Fr, Fs, n_fft):
    """Plain-torch kernel H: the two matrix products, then `ola_plain`."""
    v = torch.matmul(Fr, Sr) - torch.matmul(Fs, Si)
    return ola_plain(v, 1, v.shape[-1] + n_fft - 1)


def _check_adjoint(spec, Sr, n_fft):
    """Kernel H computes from the structure of [Fr^T; -Fs^T]: raise
    without one, or on one whose shape does not match the planes."""
    if spec is None:
        raise ValueError("istft_ola on CUDA computes from the DFT's "
                         "structure: pass the DftSpec of [Fr^T; -Fs^T] "
                         "(adjoint=)")
    if spec.n_fft != n_fft or spec.rows != 2 * Sr.shape[-2] or \
            len(spec.windows) not in (1, 2):
        raise ValueError(f"istft_ola: adjoint (n_fft={spec.n_fft}, "
                         f"{spec.rows} rows) does not match the planes "
                         f"{tuple(Sr.shape)} (n_fft={n_fft})")
    if not istft_ola_ok(n_fft):
        raise ValueError(f"istft_ola: n_fft={n_fft} does not fit the "
                         "kernel (see istft_ola_ok)")


def _istft_ola_cuda(device, Sr, Si, n_fft, spec):
    from .. import _build
    _check_adjoint(spec, Sr, n_fft)
    Q, A, Bt, D = _tables_on(spec, device)
    h, n_segs = Sr.shape[-2:]
    batch = tuple(Sr.shape[:-2])
    B = int(np.prod(batch)) if batch else 1
    L = n_segs + n_fft - 1
    sr, si = (a.reshape(B, h, n_segs).contiguous() for a in (Sr, Si))
    nblk = -(-n_segs // _H_FRAMES)
    part = torch.empty((B, nblk, _H_FRAMES + n_fft - 1), dtype=torch.float32,
                       device=device)
    out = torch.empty((B, L), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        _build.launch(
            "ssq_istft_ola", sr.data_ptr(), si.data_ptr(), A.data_ptr(),
            Bt.data_ptr(), D.data_ptr(), B, h, n_segs, n_fft, spec.nf,
            len(spec.windows), Q.bit_length() - 1, part.data_ptr(),
            out.data_ptr(), _stream(device), what="istft_ola kernel")
    return out.reshape(batch + (L,))


def istft_ola_vjp(g, Fr, Fs, n_fft: int, adjoint=None):
    """Adjoint of `istft_ola` in (Sr, Si) (the JAX package's
    `_istft_fused_bwd`): framing, then the transposed irfft products,
    gSr[k, n] = sum_t Fr[t, k] g[n + t], gSi[k, n] = -sum_t Fs[t, k]
    g[n + t]. That is kernel F's math with K_T = [Fr^T; -Fs^T] (whose
    `DftSpec` is `adjoint`), so it runs `stft_dft` (F on CUDA, the plain
    version on the CPU). g: (..., n_segs + n_fft - 1); returns (gSr, gSi),
    each (..., nf, n_segs)."""
    nf = Fr.shape[1]
    n_segs = g.shape[-1] - n_fft + 1
    out = stft_dft(g, torch.cat([Fr.t(), -Fs.t()]), n_fft, n_segs,
                   spec=adjoint)
    return out[..., :nf, :], out[..., nf:, :]


class IstftOlaFn(torch.autograd.Function):
    """Kernel H with the JAX package's gradient: linear in (Sr, Si),
    backward `istft_ola_vjp` (kernel F; both on the structure `adjoint`);
    Fr and Fs get zero."""

    @staticmethod
    def forward(ctx, Sr, Si, Fr, Fs, n_fft, adjoint):
        ctx.save_for_backward(Fr, Fs)
        ctx.n_fft, ctx.adjoint = n_fft, adjoint
        if Sr.device.type == "cuda":
            return _istft_ola_cuda(Sr.device, Sr, Si, n_fft, adjoint)
        return istft_ola_plain(Sr, Si, Fr, Fs, n_fft)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        Fr, Fs = ctx.saved_tensors
        return (*istft_ola_vjp(g, Fr, Fs, ctx.n_fft, ctx.adjoint),
                *_zeros_for(ctx, [(2, Fr), (3, Fs)]), None, None)


def istft_ola(Sr, Si, Fr, Fs, n_fft: int, adjoint=None):
    """Hop-1 irfft product + overlap-add.

    Sr/Si: (..., nf, n_segs) float32 Sx planes; Fr/Fs: (n_fft, nf) irfft
    matrices with the window^win_exp factor folded into their rows.
    Returns (..., n_segs + n_fft - 1) float32, before the window-norm
    division: out[c] = sum_t (Fr @ Sr - Fs @ Si)[t, c - t]. `adjoint`: the
    `DftSpec` of [Fr^T; -Fs^T], which kernel H and the backward's kernel F
    compute from (needed on CUDA; the plain version takes Fr, Fs).
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
    return IstftOlaFn.apply(Sr, Si, Fr, Fs, n_fft, adjoint)
