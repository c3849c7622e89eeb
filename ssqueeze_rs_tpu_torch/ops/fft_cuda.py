"""Kernel A: fused CWT + phase transform (counterpart of
``ssqueeze_rs_tpu/ops/fft_pallas.py``'s `cwt_halfband_fused` with
`phase_gamma`, whose Pallas body is `_make_cwt_kernel_phase`).

`cwt_phase` dispatches on the device of its inputs: on a CUDA tensor it
launches the hand-written kernel (``csrc/cwt_phase.cu``) or raises; on a
CPU tensor it runs `cwt_phase_plain`, the same function in plain torch.
`LAUNCHES` counts kernel launches, so a run can show that it went
through the kernel.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["cwt_phase", "cwt_phase_plain", "best_split", "LAUNCHES"]

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


def cwt_phase(Pw, xr, xi, xig, inv_dt, nyq_w, nyq_d, keep, gamma):
    """Fused CWT core with the phase epilogue.

    Pw: (na, K1, M2) filterbank psih(scale * xi) on the half-band grid
    (k = M2*k1 + k2, M = 2*K1*M2); xr/xi: (b, K1, M2) or (K1, M2) signal
    spectrum planes; xig: (K1, M2) radian grid; inv_dt: 1/dt;
    nyq_w/nyq_d: ((b*na,), (b*na,)) Nyquist real/imag values of the Wx and
    dWx spectra; keep: (start, L) output window; gamma: mask threshold.
    Returns (Wxr, Wxi, w), each (b*na, L), rows b-major, with
    w = |Im(dWx/Wx)|/2pi and +inf where |Wx| <= gamma. Arrays may be
    numpy (they go to the CPU) or tensors."""
    device, Pw, xr, xi, xig, nyq = _prepare(Pw, xr, xi, xig, nyq_w, nyq_d)
    if device.type == "cuda":
        return _cwt_phase_cuda(device, Pw, xr, xi, xig, inv_dt, nyq, keep,
                               gamma)
    if device.type == "cpu":
        return cwt_phase_plain(Pw, xr, xi, xig, inv_dt, nyq[:2], nyq[2:],
                               keep, gamma)
    raise ValueError(f"cwt_phase: unsupported device {device}")
