"""Kernel A: fused CWT + phase transform (counterpart of
``ssqueeze_rs_tpu/ops/fft_pallas.py``'s `cwt_halfband_fused` with
`phase_gamma`, whose Pallas body is `_make_cwt_kernel_phase`).

`cwt_phase` dispatches on the device of its inputs: on a CUDA tensor it
launches the hand-written kernel (``csrc/cwt_phase.cu``) or raises; on a
CPU tensor it runs `cwt_phase_plain`, the same function in plain torch.
`LAUNCHES` counts kernel launches, so a run can show that it went
through the kernel. It is differentiable (`CwtPhaseFn`) with the JAX
package's gradient (`_cwt_fused_bwd`, phase mode): `cwt_phase_vjp`, plain
torch on either device, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

__all__ = ["cwt_phase", "cwt_phase_plain", "cwt_phase_vjp", "CwtPhaseFn",
           "best_split", "LAUNCHES"]

LAUNCHES = 0
_TWO_PI = 6.283185307179586
_MAX_FACTOR = 2048      # largest M1 or M2 the kernel's shared memory holds
_Y_BYTES = 2 << 30      # cap on the kernel's intermediate: rows go through
                        # it in chunks, so a batch does not grow it


def best_split(M: int):
    """M1*M2 = M with both factors powers of 2, as square as possible
    (M1 <= M2), both <= 2048; None otherwise."""
    if M & (M - 1) or M < 4:
        return None
    log = M.bit_length() - 1
    M1, M2 = 1 << (log // 2), 1 << (log - log // 2)
    if M2 > _MAX_FACTOR:
        return None
    return M1, M2


def _device_of(a):
    """The device a wrapper dispatches on: a tensor's own, the CPU for
    an array."""
    return a.device if isinstance(a, torch.Tensor) else torch.device("cpu")


def _f32(a, device):
    """`a` as float32 on `device`. Arrays are copied there; a tensor on
    another device raises, so no tensor changes device (and route)."""
    if isinstance(a, torch.Tensor) and a.device != device:
        raise ValueError(f"inputs on {a.device} and {device}: pass every "
                         "tensor on one device")
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = a.copy()    # torch would share a buffer it may not write
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _zeros_for(ctx, pairs):
    """The zero cotangents a backward returns for the inputs (index,
    tensor) that ask for one (the JAX VJPs return zeros for them)."""
    return [torch.zeros_like(t) if ctx.needs_input_grad[i] else None
            for i, t in pairs]


def _prepare(Pw, xr, xi, xig, nyq_w, nyq_d):
    """Common input handling: everything float32 on Pw's device (numpy
    inputs go to the CPU), signal planes given a batch dim."""
    device = _device_of(Pw)
    Pw, xr, xi, xig = (_f32(a, device) for a in (Pw, xr, xi, xig))
    if xr.ndim == 2:
        xr, xi = xr[None], xi[None]
    nyq = [_f32(v, device) for v in (*nyq_w, *nyq_d)]
    na, K1, M2 = Pw.shape
    b = xr.shape[0]
    if xr.shape != (b, K1, M2) or xi.shape != xr.shape or xig.shape != (K1, M2):
        raise ValueError(f"shape mismatch: Pw {tuple(Pw.shape)}, x planes "
                         f"{tuple(xr.shape)}/{tuple(xi.shape)}, xig "
                         f"{tuple(xig.shape)}")
    if any(v.shape != (b * na,) for v in nyq):
        raise ValueError(f"Nyquist vectors must have shape ({b * na},)")
    return device, Pw, xr, xi, xig, nyq


def cwt_phase_plain(Pw, xr, xi, xig, inv_dt, nyq_w, nyq_d, keep, gamma):
    """Plain-torch kernel A: build the length-M spectrum (Z at bins
    [0, M/2), the Nyquist value at M/2, zeros above), `torch.fft.ifft`,
    keep [start, start+L) and compute w. Returns (Wxr, Wxi, w), each
    (b*na, L) with rows b-major."""
    _, Pw, xr, xi, xig, (nwr, nwi, ndr, ndi) = _prepare(
        Pw, xr, xi, xig, nyq_w, nyq_d)
    na, K1, M2 = Pw.shape
    b = xr.shape[0]
    rows, half = b * na, K1 * M2
    M = 2 * half
    start, L = keep
    Zr = (Pw[None] * xr[:, None]).reshape(rows, half)
    Zi = (Pw[None] * xi[:, None]).reshape(rows, half)
    s = (xig * float(np.float32(inv_dt))).reshape(half)
    spec = torch.zeros((2 * rows, M), dtype=torch.complex64, device=Pw.device)
    spec[:rows, :half] = torch.complex(Zr, Zi)
    spec[rows:, :half] = torch.complex(-Zi * s, Zr * s)
    spec[:rows, half] = torch.complex(nwr, nwi)
    spec[rows:, half] = torch.complex(ndr, ndi)
    out = torch.fft.ifft(spec, dim=-1)[:, start:start + L]
    C, D = out[:rows].real, out[:rows].imag
    A, B = out[rows:].real, out[rows:].imag
    mag2 = C * C + D * D
    ratio = (B * C - A * D) / (mag2 * _TWO_PI)
    gamma2 = float(np.float32(float(gamma) ** 2))
    w = torch.where(mag2 > gamma2, ratio.abs(),
                    torch.full_like(ratio, float("inf")))
    return C.contiguous(), D.contiguous(), w


def _cwt_phase_cuda(device, Pw, xr, xi, xig, inv_dt, nyq, keep, gamma):
    from .. import _build
    global LAUNCHES
    na, K1, M2 = Pw.shape
    b = xr.shape[0]
    rows = b * na
    M1 = 2 * K1
    M = M1 * M2
    start, L = keep
    if best_split(M) != (M1, M2):
        raise ValueError(f"(K1, M2) = ({K1}, {M2}) is not the split "
                         f"best_split({M}) gives")
    if not (0 <= start and L > 0 and start + L <= M):
        raise ValueError(f"keep={keep} outside [0, {M})")
    Pw, xr, xi, xig = (t.contiguous() for t in (Pw, xr, xi, xig))
    nyq = [v.contiguous() for v in nyq]
    ychunk = max(1, min(rows, _Y_BYTES // (2 * M * 8)))
    Y = torch.empty((2, ychunk, M, 2), dtype=torch.float32, device=device)
    owr, owi, ow = (torch.empty((rows, L), dtype=torch.float32, device=device)
                    for _ in range(3))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _build.lib().ssq_cwt_phase(
            Pw.data_ptr(), xr.data_ptr(), xi.data_ptr(), xig.data_ptr(),
            float(np.float32(inv_dt)), *(v.data_ptr() for v in nyq),
            rows, na, M1.bit_length() - 1, M2.bit_length() - 1, start, L,
            float(np.float32(float(gamma) ** 2)), Y.data_ptr(), ychunk,
            owr.data_ptr(), owi.data_ptr(), ow.data_ptr(), stream)
    _build.check(err, "cwt_phase kernel")
    LAUNCHES += 1
    return owr, owi, ow


def cwt_phase_vjp(Pw, xr, xi, gwr, gwi, keep, need_pw=True):
    """Adjoint of `cwt_phase`'s (Wxr, Wxi) outputs (the JAX package's
    `_cwt_fused_bwd`, phase mode: the derivative pipe and the phase plane
    get zero cotangent). Per row: the cotangent zero-filled outside the
    kept window, `torch.fft.fft` / M (the adjoint of the inverse DFT),
    bins [0, M/2) to Z and bin M/2 to the Nyquist value; then the adjoint
    of Z = Pw * x: gx = sum_i gZ * Pw, gPw = sum_b (gZr*xr + gZi*xi)
    (only if `need_pw`). Rows go in chunks, as the forward's, so the
    (rows, M) cotangent spectrum is never whole; each signal's and each
    row's sums are taken in a fixed order. Returns (gPw or None, gxr, gxi,
    gnyq_r, gnyq_i)."""
    na, K1, M2 = Pw.shape
    b = xr.shape[0]
    half = K1 * M2
    M = 2 * half
    start, L = keep
    rchunk = max(1, min(na, _Y_BYTES // (2 * M * 8)))
    Pf = Pw.reshape(na, half)
    xrf, xif = xr.reshape(b, half), xi.reshape(b, half)
    gxr, gxi = torch.zeros_like(xrf), torch.zeros_like(xif)
    gPw = torch.zeros_like(Pf) if need_pw else None
    gnr = torch.empty((b * na,), dtype=torch.float32, device=Pw.device)
    gni = torch.empty_like(gnr)
    for bi in range(b):
        for i0 in range(0, na, rchunk):
            i1 = min(na, i0 + rchunk)
            r0, r1 = bi * na + i0, bi * na + i1
            g = torch.zeros((i1 - i0, M), dtype=torch.complex64,
                            device=Pw.device)
            g[:, start:start + L] = torch.complex(gwr[r0:r1], gwi[r0:r1])
            spec = torch.fft.fft(g, dim=-1, norm="forward")
            del g
            gZr, gZi = spec.real[:, :half], spec.imag[:, :half]
            gnr[r0:r1] = spec.real[:, half]
            gni[r0:r1] = spec.imag[:, half]
            P = Pf[i0:i1]
            gxr[bi] += (gZr * P).sum(0)
            gxi[bi] += (gZi * P).sum(0)
            if need_pw:
                gPw[i0:i1] += gZr * xrf[bi] + gZi * xif[bi]
    return (gPw.reshape(na, K1, M2) if need_pw else None,
            gxr.reshape(b, K1, M2), gxi.reshape(b, K1, M2), gnr, gni)


class CwtPhaseFn(torch.autograd.Function):
    """Kernel A with the JAX package's gradient (`_cwt_fused_vjp`, phase
    mode): the backward is `cwt_phase_vjp` (plain torch); w is not
    differentiable, and the grid, 1/dt and the derivative pipe's Nyquist
    values get zero. Saves Pw and the signal planes (the JAX residuals)."""

    @staticmethod
    def forward(ctx, Pw, xr, xi, xig, nwr, nwi, ndr, ndi, inv_dt, keep,
                gamma):
        ctx.save_for_backward(Pw, xr, xi, xig, ndr, ndi)
        ctx.keep = keep
        nyq = (nwr, nwi, ndr, ndi)
        if Pw.device.type == "cuda":
            out = _cwt_phase_cuda(Pw.device, Pw, xr, xi, xig, inv_dt, nyq,
                                  keep, gamma)
        else:
            out = cwt_phase_plain(Pw, xr, xi, xig, inv_dt, nyq[:2], nyq[2:],
                                  keep, gamma)
        ctx.mark_non_differentiable(out[2])
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, gwr, gwi, _):
        Pw, xr, xi, xig, ndr, ndi = ctx.saved_tensors
        gPw, gxr, gxi, gnr, gni = cwt_phase_vjp(
            Pw, xr, xi, gwr, gwi, ctx.keep, need_pw=ctx.needs_input_grad[0])
        return (gPw, gxr, gxi, *_zeros_for(ctx, [(3, xig)]), gnr, gni,
                *_zeros_for(ctx, [(6, ndr), (7, ndi)]), None, None, None)


def cwt_phase(Pw, xr, xi, xig, inv_dt, nyq_w, nyq_d, keep, gamma):
    """Fused CWT core with the phase epilogue.

    Pw: (na, K1, M2) filterbank psih(scale * xi) on the half-band grid
    (k = M2*k1 + k2, M = 2*K1*M2); xr/xi: (b, K1, M2) or (K1, M2) signal
    spectrum planes; xig: (K1, M2) radian grid; inv_dt: 1/dt;
    nyq_w/nyq_d: ((b*na,), (b*na,)) Nyquist real/imag values of the Wx and
    dWx spectra; keep: (start, L) output window; gamma: mask threshold.
    Returns (Wxr, Wxi, w), each (b*na, L), rows b-major, with
    w = |Im(dWx/Wx)|/2pi and +inf where |Wx| <= gamma. Arrays may be
    numpy (they go to the CPU) or tensors. Differentiable in Pw, the
    signal planes and the Wx Nyquist values (`CwtPhaseFn`)."""
    device, Pw, xr, xi, xig, nyq = _prepare(Pw, xr, xi, xig, nyq_w, nyq_d)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"cwt_phase: unsupported device {device}")
    return CwtPhaseFn.apply(Pw, xr, xi, xig, *nyq, inv_dt, keep, gamma)
