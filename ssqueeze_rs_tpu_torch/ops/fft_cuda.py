"""The half-band CWT kernels: A (fused CWT + phase transform), D (fused
CWT planes) and E (half-band planar inverse FFT); counterparts of
``ssqueeze_rs_tpu/ops/fft_pallas.py``'s `cwt_halfband_fused` (with
`phase_gamma`: `_make_cwt_kernel_phase`; without: `_make_cwt_kernel` and
its variants) and `ifft_halfband_planar_fused` (`_make_kernel`).

Each wrapper (`cwt_phase`, `cwt_fused`, `ifft_halfband_planar`)
dispatches on the device of its inputs: on a CUDA tensor it launches the
hand-written kernel (``csrc/cwt_planes.cu``, where A, D and E run the same
two launches on the register-radix core ``csrc/fft_radix.cuh``: A is D
with the derivative and a phase epilogue, E D with its own loader) or
raises; on a CPU tensor it runs its plain version (`*_plain`), the same
function in plain torch.
Each kernel call goes through `_build.launch`, which counts it in
`trace.COUNTS` (`launch.ssq_cwt_phase` for A, `launch.ssq_cwt_planes` for
D, `launch.ssq_ifft_halfband` for E), so a run can show that it went
through each kernel. All three are differentiable
(`CwtPhaseFn`, `CwtFusedFn`, `IfftHalfbandFn`) with the JAX package's
gradients (`_cwt_fused_bwd`, `_fused_ifft_bwd`): `cwt_fused_vjp` and
`ifft_halfband_vjp`, plain torch + cuFFT on either device, as the JAX
package leaves them to XLA.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

__all__ = ["cwt_phase", "cwt_phase_plain", "CwtPhaseFn", "cwt_fused",
           "cwt_fused_plain", "CwtFusedFn", "ifft_halfband_planar",
           "ifft_halfband_planar_plain", "IfftHalfbandFn", "cwt_fused_vjp",
           "ifft_halfband_vjp", "best_split", "d_chunk_rows"]

_TWO_PI = 6.283185307179586
_MAX_FACTOR = 2048      # largest M1 or M2 the kernels' shared memory holds
_Y_BYTES = 2 << 30      # cap on the adjoints' cotangent spectra (plain
                        # torch + cuFFT): rows go through them in chunks,
                        # so a batch does not grow them
_D_Y_BYTES = 40 << 20   # kernels A's, D's and E's intermediate a chunk of
                        # rows: inside the H100's 50 MB L2, so their second
                        # launch reads Y from L2 (the fastest of 10, 20,
                        # 40 MB and one chunk in chip_smoke phase 15's
                        # sweeps)


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


def d_chunk_rows(M: int, pipes: int, rows: int) -> int:
    """Rows a chunk of kernel D (A: pipes = 2; E: pipes = 1): as many as
    keep its intermediate Y (pipes x rows x M complex floats) within
    `_D_Y_BYTES`, at least one (one row's Y alone exceeds the budget only
    at M = 2^22 with two pipelines)."""
    return max(1, min(rows, _D_Y_BYTES // (pipes * M * 8)))


def _device_of(a):
    """The device a wrapper dispatches on: a tensor's own, the CPU for
    an array."""
    return a.device if isinstance(a, torch.Tensor) else torch.device("cpu")


def _as(a, device, dtype):
    """`a` as `dtype` on `device`. Arrays are copied there; a tensor on
    another device raises, so no tensor changes device (and route)."""
    if isinstance(a, torch.Tensor) and a.device != device:
        raise ValueError(f"inputs on {a.device} and {device}: pass every "
                         "tensor on one device")
    if isinstance(a, np.ndarray) and not a.flags.writeable:
        a = a.copy()    # torch would share a buffer it may not write
    return torch.as_tensor(a, dtype=dtype, device=device)


def _f32(a, device):
    """`a` as float32 on `device` (`_as`)."""
    return _as(a, device, torch.float32)


def _f32_scalar(v) -> float:
    """A scalar (number or 0-d tensor) rounded to float32, as a float."""
    return float(np.float32(float(v)))


def _zeros_for(ctx, pairs):
    """The zero cotangents a backward returns for the inputs (index,
    tensor) that ask for one (the JAX VJPs return zeros for them)."""
    return [torch.zeros_like(t) if ctx.needs_input_grad[i] else None
            for i, t in pairs]


def _prepare(Pw, xr, xi, xig, nyq_w, nyq_d):
    """Common input handling: everything float32 on Pw's device (numpy
    inputs go to the CPU), signal planes given a batch dim; a missing
    `nyq_d` is zeros."""
    device = _device_of(Pw)
    Pw, xr, xi, xig = (_f32(a, device) for a in (Pw, xr, xi, xig))
    if xr.ndim == 2:
        xr, xi = xr[None], xi[None]
    na, K1, M2 = Pw.shape
    b = xr.shape[0]
    if nyq_d is None:
        nyq_d = (torch.zeros(b * na, device=device),) * 2
    nyq = [_f32(v, device) for v in (*nyq_w, *nyq_d)]
    if xr.shape != (b, K1, M2) or xi.shape != xr.shape or xig.shape != (K1, M2):
        raise ValueError(f"shape mismatch: Pw {tuple(Pw.shape)}, x planes "
                         f"{tuple(xr.shape)}/{tuple(xi.shape)}, xig "
                         f"{tuple(xig.shape)}")
    if any(v.shape != (b * na,) for v in nyq):
        raise ValueError(f"Nyquist vectors must have shape ({b * na},)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device, Pw, xr, xi, xig, nyq


def _check_split(K1, M2, keep):
    """(M1, M) of a half-band grid (K1, M2), checked against best_split
    and the keep window."""
    M1 = 2 * K1
    M = M1 * M2
    start, L = keep
    if best_split(M) != (M1, M2):
        raise ValueError(f"(K1, M2) = ({K1}, {M2}) is not the split "
                         f"best_split({M}) gives")
    if not (0 <= start and L > 0 and start + L <= M):
        raise ValueError(f"keep={keep} outside [0, {M})")
    return M1, M


# -- plain versions -------------------------------------------------------------
def _halfband_ifft(Zr, Zi, nr, ni, keep):
    """The length-M inverse DFT of rows whose spectrum is Z at bins
    [0, M/2) (Zr, Zi: (rows, M/2)), the Nyquist value (nr, ni) at M/2 and
    zeros above, kept at [start, start+L): complex64 (rows, L)."""
    rows, half = Zr.shape
    start, L = keep
    spec = torch.zeros((rows, 2 * half), dtype=torch.complex64,
                       device=Zr.device)
    spec[:, :half] = torch.complex(Zr, Zi)
    spec[:, half] = torch.complex(nr, ni)
    return torch.fft.ifft(spec, dim=-1)[:, start:start + L]


def _cwt_spectra(Pw, xr, xi, xig, inv_dt, derivative):
    """Z = Pw * xhat (rows b-major, flattened to (rows, M/2)), and with
    `derivative` stacked over rows with dZ = (-Zi, Zr) * xig * inv_dt."""
    na, K1, M2 = Pw.shape
    b = xr.shape[0]
    rows, half = b * na, K1 * M2
    Zr = (Pw[None] * xr[:, None]).reshape(rows, half)
    Zi = (Pw[None] * xi[:, None]).reshape(rows, half)
    if not derivative:
        return Zr, Zi
    s = (xig * _f32_scalar(inv_dt)).reshape(half)
    return torch.cat([Zr, -Zi * s]), torch.cat([Zi, Zr * s])


def cwt_phase_plain(Pw, xr, xi, xig, inv_dt, nyq_w, nyq_d, keep, gamma):
    """Plain-torch kernel A: build the length-M spectrum (Z at bins
    [0, M/2), the Nyquist value at M/2, zeros above), `torch.fft.ifft`,
    keep [start, start+L) and compute w. Returns (Wxr, Wxi, w), each
    (b*na, L) with rows b-major."""
    _, Pw, xr, xi, xig, (nwr, nwi, ndr, ndi) = _prepare(
        Pw, xr, xi, xig, nyq_w, nyq_d)
    rows = xr.shape[0] * Pw.shape[0]
    Zr, Zi = _cwt_spectra(Pw, xr, xi, xig, inv_dt, True)
    out = _halfband_ifft(Zr, Zi, torch.cat([nwr, ndr]),
                         torch.cat([nwi, ndi]), keep)
    C, D = out[:rows].real, out[:rows].imag
    A, B = out[rows:].real, out[rows:].imag
    mag2 = C * C + D * D
    ratio = (B * C - A * D) / (mag2 * _TWO_PI)
    gamma2 = float(np.float32(float(gamma) ** 2))
    w = torch.where(mag2 > gamma2, ratio.abs(),
                    torch.full_like(ratio, float("inf")))
    return C.contiguous(), D.contiguous(), w


def cwt_fused_plain(Pw, xr, xi, xig, inv_dt, nyq_w, nyq_d, keep,
                    derivative=True):
    """Plain-torch kernel D: the spectra of `_cwt_spectra`, the Nyquist
    values at M/2, `torch.fft.ifft`, keep. Returns (Wxr, Wxi) or, with
    `derivative`, (Wxr, Wxi, dWxr, dWxi), each (b*na, L), rows b-major."""
    _, Pw, xr, xi, xig, (nwr, nwi, ndr, ndi) = _prepare(
        Pw, xr, xi, xig, nyq_w, nyq_d)
    rows = xr.shape[0] * Pw.shape[0]
    Zr, Zi = _cwt_spectra(Pw, xr, xi, xig, inv_dt, derivative)
    if derivative:
        nr, ni = torch.cat([nwr, ndr]), torch.cat([nwi, ndi])
    else:
        nr, ni = nwr, nwi
    out = _halfband_ifft(Zr, Zi, nr, ni, keep)
    planes = (out[:rows].real, out[:rows].imag)
    if derivative:
        planes += (out[rows:].real, out[rows:].imag)
    return tuple(p.contiguous() for p in planes)


def _prepare_z(Zr, Zi, nyq_r, nyq_i):
    device = _device_of(Zr)
    Zr, Zi = _f32(Zr, device), _f32(Zi, device)
    B, K1, M2 = Zr.shape
    if Zi.shape != Zr.shape:
        raise ValueError(f"shape mismatch: Zr {tuple(Zr.shape)}, Zi "
                         f"{tuple(Zi.shape)}")
    if (nyq_r is None) != (nyq_i is None):
        raise ValueError("provide both `nyq_r` and `nyq_i`, or neither")
    if nyq_r is None:
        nyq_r = nyq_i = torch.zeros(B, device=device)
    nr, ni = _f32(nyq_r, device), _f32(nyq_i, device)
    if nr.shape != (B,) or ni.shape != (B,):
        raise ValueError(f"Nyquist vectors must have shape ({B},)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device, Zr, Zi, nr, ni


def ifft_halfband_planar_plain(Zr, Zi, keep=None, nyq_r=None, nyq_i=None):
    """Plain-torch kernel E: Zr, Zi (B, K1, M2) half-spectrum planes
    (k = M2*k1 + k2 < M/2), Nyquist values (B,) (zeros if not given).
    Returns (xr, xi), each (B, L) for keep = (start, L) (default (0, M))."""
    _, Zr, Zi, nr, ni = _prepare_z(Zr, Zi, nyq_r, nyq_i)
    B = Zr.shape[0]
    keep = keep if keep is not None else (0, Zr[0].numel() * 2)
    out = _halfband_ifft(Zr.reshape(B, -1), Zi.reshape(B, -1), nr, ni, keep)
    return out.real.contiguous(), out.imag.contiguous()


# -- the kernels ----------------------------------------------------------------
def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream(device).cuda_stream


def _cwt_phase_cuda(device, Pw, xr, xi, xig, inv_dt, nyq, keep, gamma):
    from .. import _build
    na, K1, M2 = Pw.shape
    rows = xr.shape[0] * na
    M1, M = _check_split(K1, M2, keep)
    start, L = keep
    Pw, xr, xi, xig = (t.contiguous() for t in (Pw, xr, xi, xig))
    nyq = [v.contiguous() for v in nyq]
    ychunk = d_chunk_rows(M, 2, rows)
    Y = torch.empty((2, ychunk, M, 2), dtype=torch.float32, device=device)
    owr, owi, ow = (torch.empty((rows, L), dtype=torch.float32, device=device)
                    for _ in range(3))
    _build.launch(
        "ssq_cwt_phase", Pw.data_ptr(), xr.data_ptr(), xi.data_ptr(),
        xig.data_ptr(), _f32_scalar(inv_dt), *(v.data_ptr() for v in nyq),
        rows, na, M1.bit_length() - 1, M2.bit_length() - 1, start, L,
        float(np.float32(float(gamma) ** 2)), Y.data_ptr(), ychunk,
        owr.data_ptr(), owi.data_ptr(), ow.data_ptr(), _stream(device),
        what="cwt_phase kernel")
    return owr, owi, ow


def _cwt_fused_cuda(device, Pw, xr, xi, xig, inv_dt, nyq, keep, derivative):
    from .. import _build
    na, K1, M2 = Pw.shape
    rows = xr.shape[0] * na
    M1, M = _check_split(K1, M2, keep)
    start, L = keep
    pipes = 2 if derivative else 1
    Pw, xr, xi, xig = (t.contiguous() for t in (Pw, xr, xi, xig))
    nyq = [v.contiguous() for v in nyq]
    ychunk = d_chunk_rows(M, pipes, rows)
    Y = torch.empty((pipes, ychunk, M, 2), dtype=torch.float32, device=device)
    out = [torch.empty((rows, L), dtype=torch.float32, device=device)
           for _ in range(2 * pipes)]
    ptrs = [o.data_ptr() for o in out] + [None] * (4 - len(out))
    _build.launch(
        "ssq_cwt_planes", Pw.data_ptr(), xr.data_ptr(), xi.data_ptr(),
        xig.data_ptr(), _f32_scalar(inv_dt), *(v.data_ptr() for v in nyq),
        rows, na, M1.bit_length() - 1, M2.bit_length() - 1, start, L,
        int(derivative), Y.data_ptr(), ychunk, *ptrs, _stream(device),
        what="cwt_fused kernel")
    return tuple(out)


def _ifft_halfband_cuda(device, Zr, Zi, nr, ni, keep):
    from .. import _build
    B, K1, M2 = Zr.shape
    M1, M = _check_split(K1, M2, keep)
    start, L = keep
    Zr, Zi, nr, ni = (t.contiguous() for t in (Zr, Zi, nr, ni))
    ychunk = d_chunk_rows(M, 1, B)
    Y = torch.empty((ychunk, M, 2), dtype=torch.float32, device=device)
    outr, outi = (torch.empty((B, L), dtype=torch.float32, device=device)
                  for _ in range(2))
    _build.launch(
        "ssq_ifft_halfband", Zr.data_ptr(), Zi.data_ptr(), nr.data_ptr(),
        ni.data_ptr(), B, M1.bit_length() - 1, M2.bit_length() - 1, start,
        L, Y.data_ptr(), ychunk, outr.data_ptr(), outi.data_ptr(),
        _stream(device), what="ifft_halfband kernel")
    return outr, outi


# -- adjoints (plain torch + cuFFT, as the JAX package leaves them to XLA) -----
def _ifft_adjoint(gr, gi, keep, M):
    """Adjoint of `_halfband_ifft` for a chunk of rows: the cotangent
    zero-filled outside the kept window, `torch.fft.fft` / M (the adjoint
    of the inverse DFT); bins [0, M/2) go to Z, bin M/2 to the Nyquist
    value. Returns (gZr, gZi, gnr, gni), the Z parts (rows, M/2)."""
    start, L = keep
    g = torch.zeros((gr.shape[0], M), dtype=torch.complex64, device=gr.device)
    g[:, start:start + L] = torch.complex(gr, gi)
    spec = torch.fft.fft(g, dim=-1, norm="forward")
    del g
    half = M // 2
    return (spec.real[:, :half], spec.imag[:, :half], spec.real[:, half],
            spec.imag[:, half])


def cwt_fused_vjp(Pw, xr, xi, xig, inv_dt, g_w, g_d, keep, need_pw=True,
                  need_grid=False):
    """Adjoint of the fused CWT (the JAX package's `_cwt_fused_bwd`):
    the adjoint of the linear inverse DFT (`_ifft_adjoint`) on the Wx
    cotangents `g_w` = (gWxr, gWxi) and, if given, the dWx cotangents
    `g_d`, then the hand adjoint of the spectra: the derivative pipe's
    cotangent folds back as gZr += s*gZi_d, gZi -= s*gZr_d (s = xig/dt),
    and Z = Pw * x gives gx = sum_i gZ * Pw, gPw = sum_b (gZr*xr + gZi*xi)
    (only if `need_pw`). With `need_grid` (and `g_d`) the cotangents of
    the grid and of 1/dt: g_s = sum_rows (Zr*gZi_d - Zi*gZr_d),
    g_xig = g_s/dt, g_invdt = sum g_s*xig. Rows go in chunks, as the
    forward's, so no (rows, M) cotangent spectrum is ever whole; each
    sum is taken in a fixed order. Returns (gPw, gxr, gxi, gnwr, gnwi,
    gndr, gndi, gxig, ginvdt), None for what was not asked for or (the
    d-pipe parts) has no cotangent."""
    na, K1, M2 = Pw.shape
    b = xr.shape[0]
    half = K1 * M2
    M = 2 * half
    pipes = 2 if g_d is not None else 1
    rchunk = max(1, min(na, _Y_BYTES // (pipes * M * 8)))
    Pf = Pw.reshape(na, half)
    xrf, xif = xr.reshape(b, half), xi.reshape(b, half)
    gxr, gxi = torch.zeros_like(xrf), torch.zeros_like(xif)
    gPw = torch.zeros_like(Pf) if need_pw else None
    new = lambda: torch.empty((b * na,), dtype=torch.float32,
                              device=Pw.device)
    gnwr, gnwi = new(), new()
    gndr, gndi = (new(), new()) if g_d is not None else (None, None)
    need_grid = need_grid and g_d is not None
    g_s = torch.zeros(half, dtype=torch.float32, device=Pw.device) \
        if need_grid else None
    if g_d is not None:
        s = (xig * _f32_scalar(inv_dt)).reshape(half)
    for bi in range(b):
        for i0 in range(0, na, rchunk):
            i1 = min(na, i0 + rchunk)
            r0, r1 = bi * na + i0, bi * na + i1
            P = Pf[i0:i1]
            gZr, gZi, gnwr[r0:r1], gnwi[r0:r1] = _ifft_adjoint(
                g_w[0][r0:r1], g_w[1][r0:r1], keep, M)
            if g_d is not None:
                gZr_d, gZi_d, gndr[r0:r1], gndi[r0:r1] = _ifft_adjoint(
                    g_d[0][r0:r1], g_d[1][r0:r1], keep, M)
                if need_grid:
                    Zr, Zi = P * xrf[bi], P * xif[bi]
                    g_s += (Zr * gZi_d - Zi * gZr_d).sum(0)
                gZr = gZr + s * gZi_d
                gZi = gZi - s * gZr_d
            gxr[bi] += (gZr * P).sum(0)
            gxi[bi] += (gZi * P).sum(0)
            if need_pw:
                gPw[i0:i1] += gZr * xrf[bi] + gZi * xif[bi]
    gxig = ginvdt = None
    if need_grid:
        gxig = (g_s * _f32_scalar(inv_dt)).reshape(K1, M2)
        ginvdt = (g_s * xig.reshape(half)).sum()
    return (gPw.reshape(na, K1, M2) if need_pw else None,
            gxr.reshape(b, K1, M2), gxi.reshape(b, K1, M2), gnwr, gnwi,
            gndr, gndi, gxig, ginvdt)


def ifft_halfband_vjp(gr, gi, keep, K1, M2):
    """Adjoint of the half-band planar inverse FFT (the JAX package's
    `_fused_ifft_bwd`): `_ifft_adjoint` over chunks of rows. Returns
    (gZr, gZi) (B, K1, M2) and (gnr, gni) (B,)."""
    B = gr.shape[0]
    M = 2 * K1 * M2
    rchunk = max(1, min(B, _Y_BYTES // (M * 8)))
    gZr = torch.empty((B, K1 * M2), dtype=torch.float32, device=gr.device)
    gZi, gnr, gni = torch.empty_like(gZr), gZr.new_empty(B), gZr.new_empty(B)
    for r0 in range(0, B, rchunk):
        r1 = min(B, r0 + rchunk)
        gZr[r0:r1], gZi[r0:r1], gnr[r0:r1], gni[r0:r1] = _ifft_adjoint(
            gr[r0:r1], gi[r0:r1], keep, M)
    return gZr.reshape(B, K1, M2), gZi.reshape(B, K1, M2), gnr, gni


# -- autograd.Functions and the public wrappers --------------------------------
class CwtPhaseFn(torch.autograd.Function):
    """Kernel A with the JAX package's gradient (`_cwt_fused_vjp`, phase
    mode): the backward is `cwt_fused_vjp` (plain torch) with no dWx
    cotangent; w is not differentiable, and the grid, 1/dt and the
    derivative pipe's Nyquist values get zero. Saves Pw and the signal
    planes (the JAX residuals)."""

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
        gPw, gxr, gxi, gnr, gni, *_ = cwt_fused_vjp(
            Pw, xr, xi, xig, 1.0, (gwr, gwi), None, ctx.keep,
            need_pw=ctx.needs_input_grad[0])
        return (gPw, gxr, gxi, *_zeros_for(ctx, [(3, xig)]), gnr, gni,
                *_zeros_for(ctx, [(6, ndr), (7, ndi)]), None, None, None)


class CwtFusedFn(torch.autograd.Function):
    """Kernel D with the JAX package's gradient (`_cwt_fused_vjp`): the
    backward is `cwt_fused_vjp` (plain torch). With the derivative the
    grid, 1/dt (when given as a tensor) and the dWx Nyquist values get
    their cotangents; without it they get zero. Saves Pw, the signal
    planes and the grid (the JAX residuals)."""

    @staticmethod
    def forward(ctx, Pw, xr, xi, xig, nwr, nwi, ndr, ndi, inv_dt, keep,
                derivative):
        ctx.save_for_backward(Pw, xr, xi, xig, ndr, ndi)
        ctx.keep, ctx.derivative = keep, derivative
        ctx.inv_dt = inv_dt
        nyq = (nwr, nwi, ndr, ndi)
        if Pw.device.type == "cuda":
            return _cwt_fused_cuda(Pw.device, Pw, xr, xi, xig, inv_dt, nyq,
                                   keep, derivative)
        return cwt_fused_plain(Pw, xr, xi, xig, inv_dt, nyq[:2], nyq[2:],
                               keep, derivative)

    @staticmethod
    @once_differentiable
    def backward(ctx, *g):
        Pw, xr, xi, xig, ndr, ndi = ctx.saved_tensors
        inv_dt, need = ctx.inv_dt, ctx.needs_input_grad
        need_grid = ctx.derivative and (need[3] or need[8])
        gPw, gxr, gxi, gnwr, gnwi, gndr, gndi, gxig, ginvdt = cwt_fused_vjp(
            Pw, xr, xi, xig, inv_dt, g[:2], g[2:] if ctx.derivative else None,
            ctx.keep, need_pw=need[0], need_grid=need_grid)
        if not ctx.derivative:
            gndr, gndi = _zeros_for(ctx, [(6, ndr), (7, ndi)])
        if gxig is None and need[3]:
            gxig = torch.zeros_like(xig)
        if need[8]:
            ginvdt = (torch.zeros_like(inv_dt) if ginvdt is None
                      else ginvdt.reshape(inv_dt.shape).to(inv_dt.dtype))
        return (gPw, gxr, gxi, gxig, gnwr, gnwi, gndr, gndi,
                ginvdt if need[8] else None, None, None)


class IfftHalfbandFn(torch.autograd.Function):
    """Kernel E with the JAX package's gradient (`_fused_ifft_bwd`, the
    transpose of the linear map): `ifft_halfband_vjp` (plain torch).
    Saves nothing (the map is linear; shapes come from the cotangents)."""

    @staticmethod
    def forward(ctx, Zr, Zi, nr, ni, keep):
        ctx.keep, ctx.grid = keep, tuple(Zr.shape[1:])
        if Zr.device.type == "cuda":
            return _ifft_halfband_cuda(Zr.device, Zr, Zi, nr, ni, keep)
        return ifft_halfband_planar_plain(Zr, Zi, keep, nr, ni)

    @staticmethod
    @once_differentiable
    def backward(ctx, gr, gi):
        return (*ifft_halfband_vjp(gr, gi, ctx.keep, *ctx.grid), None)


def cwt_phase(Pw, xr, xi, xig, inv_dt, nyq_w, nyq_d, keep, gamma):
    """Fused CWT core with the phase epilogue (kernel A).

    Pw: (na, K1, M2) filterbank psih(scale * xi) on the half-band grid
    (k = M2*k1 + k2, M = 2*K1*M2); xr/xi: (b, K1, M2) or (K1, M2) signal
    spectrum planes; xig: (K1, M2) radian grid; inv_dt: 1/dt;
    nyq_w/nyq_d: ((b*na,), (b*na,)) Nyquist real/imag values of the Wx and
    dWx spectra; keep: (start, L) output window; gamma: mask threshold.
    Returns (Wxr, Wxi, w), each (b*na, L), rows b-major, with
    w = |Im(dWx/Wx)|/2pi and +inf where |Wx| <= gamma. Arrays may be
    numpy (they go to the CPU) or tensors. Differentiable in Pw, the
    signal planes and the Wx Nyquist values (`CwtPhaseFn`)."""
    _, Pw, xr, xi, xig, nyq = _prepare(Pw, xr, xi, xig, nyq_w, nyq_d)
    return CwtPhaseFn.apply(Pw, xr, xi, xig, *nyq, inv_dt, keep, gamma)


def cwt_fused(Pw, xr, xi, xig, inv_dt, nyq_w, nyq_d=None, keep=None,
              derivative=True):
    """Fused CWT core emitting planes (kernel D): the inputs of
    `cwt_phase` (keep defaults to (0, M); nyq_d may be None without the
    derivative). Returns (Wxr, Wxi) or, with `derivative`, (Wxr, Wxi,
    dWxr, dWxi), each (b*na, L), rows b-major. Differentiable in Pw, the
    signal planes, the grid, the Nyquist values and 1/dt given as a
    tensor (`CwtFusedFn`)."""
    _, Pw, xr, xi, xig, nyq = _prepare(Pw, xr, xi, xig, nyq_w, nyq_d)
    if keep is None:
        keep = (0, 2 * Pw.shape[1] * Pw.shape[2])
    return CwtFusedFn.apply(Pw, xr, xi, xig, *nyq, inv_dt, tuple(keep),
                            bool(derivative))


def ifft_halfband_planar(Zr, Zi, keep=None, nyq_r=None, nyq_i=None):
    """Half-band planar inverse FFT (kernel E), the contract of the JAX
    package's `ifft_halfband_planar_fused`: Zr/Zi (B, K1, M2) float32
    planes of the half spectrum (k = M2*k1 + k2 < M/2, M = 2*K1*M2),
    keep = (start, L) (default (0, M)), Nyquist values (B,) (zeros if not
    given). Returns (xr, xi), each (B, L). Differentiable
    (`IfftHalfbandFn`)."""
    _, Zr, Zi, nr, ni = _prepare_z(Zr, Zi, nyq_r, nyq_i)
    if keep is None:
        keep = (0, 2 * Zr.shape[1] * Zr.shape[2])
    return IfftHalfbandFn.apply(Zr, Zi, nr, ni, tuple(keep))
