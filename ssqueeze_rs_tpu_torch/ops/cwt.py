"""CWT core, planar route (counterpart of ``ssqueeze_rs_tpu/ops/cwt.py``'s
`cwt_core` with `planar_out=True` and `phase_gamma`).

For analytic wavelets with a real psih the whole transform stays in f32
real/imag planes: `rfft` of the padded signal, psih sampled on the
half-band grid (k = M2*k1 + k2, k < M/2) on the signal's device, the
Nyquist term, then kernel A (`fft_cuda.cwt_phase`), which also computes
the phase transform w. The planes come back N wide; the TPU package's
512-column alignment of the kept width is not carried over. The public
`cwt`/`icwt` and the complex / float64 routes wait for ROADMAP Queue 1
item 3.
"""
from __future__ import annotations

import numpy as np
import torch

from ..wavelets.base import Wavelet
from .fft_cuda import best_split, cwt_phase

__all__ = ["cwt_core", "cwt_phase_args", "xi_grid"]


def xi_grid(M: int, device="cpu") -> torch.Tensor:
    """Positive-frequency radian grid for bins k < M/2, float32, in the
    (K1, M2) layout (k = M2*k1 + k2), computed on `device` with the same
    float64 product as `utils.fft.xifn`, then rounded once."""
    M1, M2 = best_split(M)
    k = torch.arange(M // 2, dtype=torch.float64, device=device)
    return (k * (2 * np.pi / M)).to(torch.float32).reshape(M1 // 2, M2)


def cwt_phase_args(xp: torch.Tensor, scales, dt: float, wavelet: Wavelet):
    """Kernel A's inputs for an already padded f32 signal xp (..., M):
    the filterbank Pw sampled on xp's device, the signal spectrum planes,
    the grid, 1/dt and the Nyquist vectors (rows b-major), as the tuple
    (Pw, xr, xi, xig, inv_dt, nyq_w, nyq_d)."""
    M = xp.shape[-1]
    split = best_split(M)
    if split is None:
        raise ValueError(f"padded length M={M} must be a power of 2 with "
                         "M <= 2^22 for the planar CWT route")
    M1, M2 = split
    K1 = M1 // 2
    b = int(np.prod(xp.shape[:-1])) if xp.ndim > 1 else 1
    device = xp.device
    f32 = torch.float32

    xh = torch.fft.rfft(xp.reshape(b, M), dim=-1)            # (b, M/2+1)
    xig = xi_grid(M, device)
    sc = torch.as_tensor(np.asarray(scales, dtype=np.float32), device=device)
    na = sc.shape[0]
    Pw = wavelet.psih(sc[:, None, None] * xig[None], torch).to(f32)
    pnyq = (wavelet.psih(sc * np.float32(np.pi), torch) / 2).to(f32)
    # Nyquist bin: psih(scale*pi)/2 * Re xhat[M/2], rows b-major; the
    # derivative spectrum's Nyquist value is i*pi/dt times it
    znyq = (xh[:, -1].real[:, None] * pnyq[None, :]).reshape(b * na)
    zeros = torch.zeros_like(znyq)
    dt32 = np.float32(dt)
    inv_dt = float(np.float32(1.0) / dt32)
    pi_dt = float(np.float32(np.pi) / dt32)
    xr = xh.real[:, :M // 2].reshape(b, K1, M2)
    xi = xh.imag[:, :M // 2].reshape(b, K1, M2)
    return Pw, xr, xi, xig, inv_dt, (znyq, zeros), (zeros, znyq * pi_dt)


def cwt_core(xp: torch.Tensor, scales, dt: float, *, wavelet: Wavelet,
             N: int, n1: int, gamma: float):
    """CWT + derivative phase of an already padded f32 signal.

    xp: (..., M) with M a power of 2; scales: (na,) host array; the kept
    window is [n1, n1+N). Returns (Wxr, Wxi, w), each (..., na, N), with
    w = |Im(dWx/Wx)|/2pi and +inf where |Wx| <= gamma (l1 norm)."""
    args = cwt_phase_args(xp, scales, dt, wavelet)
    wxr, wxi, w = cwt_phase(*args, keep=(n1, N), gamma=gamma)
    shape = tuple(xp.shape[:-1]) + (len(scales), N)
    return wxr.reshape(shape), wxi.reshape(shape), w.reshape(shape)
