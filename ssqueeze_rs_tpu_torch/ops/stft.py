"""Short-Time Fourier Transform, forward and inverse (counterpart of
``ssqueeze_rs_tpu/ops/stft.py``).

  * float32 with n_fft <= 2048: the windowed DFT is one product with a
    host-built stacked matrix K_T ([Sr; Si(; dSr; dSi)] rows; window,
    modulation twiddle and derivative window folded in). At hop 1 the
    framing and the DFT are kernel F (`stft_cuda.stft_dft`), which computes
    them from K_T's structure (`_dft_spec`); at hop > 1 the frames are an
    `unfold` view and the product a `torch.matmul`, as the JAX package
    leaves it to XLA.
  * float64, or n_fft > 2048: `torch.fft.rfft` of the windowed frames
    (the JAX package's batched-rfft route), window and signal in the
    transform's type, on either device.
  * The inverse is the Griffin-Lim least-squares overlap-add with
    window^win_exp and the sum of shifted window^(win_exp+1) as its norm.
    For complex64 at hop 1 with one column per sample the irfft product
    and the overlap-add are kernel H (`stft_cuda.istft_ola`); otherwise
    the product (or, for complex128 or n_fft > 2048, `torch.fft.irfft`)
    and a deterministic overlap-add run in torch, complex128 in
    float64 throughout.

Rows are frequencies, columns time: Sx is (..., n_fft//2 + 1, n_segs).
Both directions are differentiable on either device (kernels F and H are
each other's adjoint, `stft_cuda.StftDftFn` / `IstftOlaFn`).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import real_dtype
from ..scales import process_fs_and_t
from ..trace import span
from ..utils.common import as_signal
from ..utils.pad import padsignal
from ..utils.windows import get_window, window_norm, check_nola
from .stft_cuda import (DftSpec, stft_dft, istft_ola, istft_ola_ok,
                        ola_plain)

__all__ = ["stft", "istft", "stft_core", "overlap_add", "MATMUL_NFFT_MAX"]

MATMUL_NFFT_MAX = 2048


def _dft_matrix(window, n_fft, modulated):
    """Windowed rfft matrix W[t, k] (complex128, host)."""
    n_freqs = n_fft // 2 + 1
    t = np.arange(n_fft)
    k = np.arange(n_freqs)
    w = np.asarray(window, np.float64)
    F = np.exp(-2j * np.pi * np.outer(t, k) / n_fft)
    if modulated:
        # rfft(ifftshift(v))[k] = e^{2i pi k (n//2) / n} rfft(v)[k]
        # (floor, not ceil: ifftshift rolls by -(n//2))
        F = F * np.exp(2j * np.pi * k * (n_fft // 2) / n_fft)[None, :]
    return F * w[:, None]


@lru_cache(maxsize=64)
def _k_t_host(win_bytes, dwin_bytes, n_fft, modulated):
    """Stacked float32 DFT matrix K_T (k * nf, n_fft): [Sr; Si] rows, and
    [dSr; dSi] below them when the derivative window is given."""
    F1 = _dft_matrix(np.frombuffer(win_bytes, np.float64), n_fft, modulated)
    mats = [F1.real, F1.imag]
    if dwin_bytes is not None:
        F2 = _dft_matrix(np.frombuffer(dwin_bytes, np.float64), n_fft,
                         modulated)
        mats += [F2.real, F2.imag]
    return np.ascontiguousarray(
        np.concatenate(mats, axis=1).astype(np.float32).T)


@lru_cache(maxsize=64)
def _k_t(win_bytes, dwin_bytes, n_fft, modulated, device):
    """`_k_t_host` on `device` (uploaded once per window)."""
    return torch.as_tensor(_k_t_host(win_bytes, dwin_bytes, n_fft, modulated),
                           device=device)


def _win_bytes(window):
    return np.asarray(window, np.float64).tobytes()


def _dft_spec(win_bytes, dwin_bytes, n_fft, modulated):
    """The structure of `_k_t`'s matrix, which kernel F computes from."""
    wins = (win_bytes,) if dwin_bytes is None else (win_bytes, dwin_bytes)
    return DftSpec(int(n_fft), wins, bool(modulated))


def stft_core(xp, window, diff_window, fs, *, n_fft, hop_len, modulated,
              derivative, planar_out=False, force_fused=None):
    """STFT of an already padded float32 or float64 signal (time = last
    axis).

    `window`/`diff_window` are host numpy arrays. Returns (Sx, dSx or
    None), each (..., n_freqs, n_segs), complex128 for a float64 signal
    and complex64 otherwise; with `planar_out` (the float32
    matrix-product route only), float32 planes (Sxr, Sxi[, dSxr,
    dSxi]). `force_fused` pins the JAX package's TPU engine choice; here
    the route follows dtype and n_fft alone, so it is taken and changes
    nothing."""
    n_freqs = n_fft // 2 + 1
    use_matmul = xp.dtype == torch.float32 and n_fft <= MATMUL_NFFT_MAX
    if planar_out and not use_matmul:
        raise ValueError("planar_out requires the float32 matrix-product "
                         "route (n_fft <= 2048)")
    n_segs = (xp.shape[-1] - n_fft) // hop_len + 1
    if use_matmul:
        wins = (_win_bytes(window),
                _win_bytes(diff_window) if derivative else None,
                int(n_fft), bool(modulated))
        K_T = _k_t(*wins, xp.device)
        if hop_len == 1:
            out = stft_dft(xp, K_T, n_fft, n_segs,
                           fs=fs if derivative else None,
                           spec=_dft_spec(*wins))
        else:
            frames = xp.unfold(-1, n_fft, hop_len)      # (..., n_segs, n_fft)
            out = torch.matmul(K_T, frames.transpose(-1, -2))
            if derivative:
                out[..., 2 * n_freqs:, :] *= fs
        planes = out.split(n_freqs, dim=-2)
        if planar_out:
            return planes
        with span("ssq.pack"):
            Sx = torch.complex(planes[0], planes[1])
            return Sx, (torch.complex(planes[2], planes[3]) if derivative
                        else None)

    frames = xp.unfold(-1, n_fft, hop_len)              # (..., n_segs, n_fft)

    def one(win, scale=None):
        fw = frames * torch.as_tensor(win, dtype=xp.dtype, device=xp.device)
        if modulated:
            fw = torch.fft.ifftshift(fw, dim=-1)
        S = torch.fft.rfft(fw, dim=-1).transpose(-1, -2)
        return S * scale if scale is not None else S

    return one(window), (one(diff_window, fs) if derivative else None)


def stft(x, window=None, n_fft=None, win_len=None, hop_len=1, fs=None, t=None,
         padtype="reflect", modulated=True, derivative=False, dtype=None,
         planar_out=False, device=None):
    """Short-Time Fourier Transform.

    `x`: array or tensor, time on the last axis, any leading batch dims.
    Returns `Sx` (..., n_fft//2 + 1, n_hops) on x's device
    (`utils.common.as_signal`: array input goes to the CUDA device unless
    `device` says otherwise), complex64 for `dtype` float32 (the default)
    and complex128 for float64, plus `dSx` if `derivative`. `dSx` is scaled by
    `fs` for modulated and unmodulated STFTs alike, as in the JAX package.
    `planar_out` returns float32 plane tuples ((Sxr, Sxi)[, (dSxr, dSxi)])
    from the matrix-product route."""
    x = as_signal(x, device)
    N = x.shape[-1]
    _, fs, _ = process_fs_and_t(fs, t, N)
    n_fft = int(n_fft or min(N // hop_len, 512))
    if win_len is None:
        win_len = (len(window) if isinstance(window, (np.ndarray, torch.Tensor))
                   else n_fft)
    dtype = real_dtype(dtype)
    with span("ssq.plan"):
        window, diff_window = get_window(window, win_len, n_fft,
                                         derivative=True, dtype=dtype)
        check_nola(window, hop_len)

    with span("ssq.prep"):
        xp = padsignal(x.to(getattr(torch, dtype)), padtype,
                       padlength=N + n_fft - 1)
    out = stft_core(xp, window, diff_window, fs, n_fft=n_fft,
                    hop_len=hop_len, modulated=modulated,
                    derivative=derivative, planar_out=planar_out)
    if planar_out:
        return ((out[0], out[1]), (out[2], out[3])) if derivative else \
            (out[0], out[1])
    Sx, dSx = out
    return (Sx, dSx) if derivative else Sx


def overlap_add(xbuf, window, hop_len: int, n_fft: int, out_len: int,
                win_exp: int = 1):
    """Overlap-add of the columns of xbuf (..., n_fft, n_segs), each row t
    weighted by window[t]**win_exp, into (..., out_len): deterministic, in
    increasing t (`stft_cuda.ola_plain`)."""
    window = torch.as_tensor(window, dtype=xbuf.dtype, device=xbuf.device)
    if win_exp == 0:
        w = torch.ones_like(window)
    elif win_exp == 1:
        w = window
    else:
        w = window ** win_exp
    return ola_plain(xbuf * w[:, None], hop_len, out_len)


@lru_cache(maxsize=64)
def _irfft_mats(n_fft: int, modulated: bool):
    """Host matrices for irfft(+fftshift) as one real product:
    xbuf[t] = sum_k Fr[t,k]*Re(Sx[k]) - Fs[t,k]*Im(Sx[k])."""
    n_freqs = n_fft // 2 + 1
    t = np.arange(n_fft)
    # fftshift rolls by +(n//2): out[t] = in[(t - n//2) % n], i.e. source
    # index (t + (n+1)//2) % n (ceil, for odd n)
    tsrc = (t + (n_fft + 1) // 2) % n_fft if modulated else t
    k = np.arange(n_freqs)
    wgt = np.full(n_freqs, 2.0)
    wgt[0] = 1.0
    if n_fft % 2 == 0:
        wgt[-1] = 1.0
    ang = 2 * np.pi * np.outer(tsrc, k) / n_fft
    Fr = (np.cos(ang) * wgt / n_fft).astype(np.float32)
    Fs = (np.sin(ang) * wgt / n_fft).astype(np.float32)
    return Fr, Fs


def _win_pow(window_np, win_exp):
    if win_exp == 0:
        return np.ones_like(window_np)
    return window_np ** win_exp


@lru_cache(maxsize=64)
def _irfft_spec(n_fft, modulated, win_bytes, win_exp):
    """The structure of [Fr^T; -Fs^T] for `_irfft_mats_weighted`'s Fr, Fs,
    which H's adjoint (kernel F) computes from: the window^win_exp taps
    (rounded to float32 as there), weights 1/n at bin 0 (and at bin n/2
    for even n) and 2/n elsewhere, and the fftshift as the modulation
    phase."""
    n_freqs = n_fft // 2 + 1
    we = _win_pow(np.frombuffer(win_bytes, np.float64), win_exp)
    wgt = np.full(n_freqs, 2.0)
    wgt[0] = 1.0
    if n_fft % 2 == 0:
        wgt[-1] = 1.0
    return DftSpec(int(n_fft), (we.astype(np.float32).astype(np.float64)
                                .tobytes(),), bool(modulated),
                   (wgt / n_fft).tobytes())


@lru_cache(maxsize=64)
def _irfft_mats_weighted(n_fft, modulated, win_bytes, win_exp, device):
    """Kernel H's matrices on `device`: Fr, Fs with window^win_exp folded
    into their rows (float64 power, then float32, as the JAX package)."""
    we = _win_pow(np.frombuffer(win_bytes, np.float64),
                  win_exp).astype(np.float32)[:, None]
    Fr, Fs = _irfft_mats(n_fft, modulated)
    return (torch.as_tensor(Fr * we, device=device),
            torch.as_tensor(Fs * we, device=device))


def istft(Sx, window=None, n_fft=None, win_len=None, hop_len=1, N=None,
          modulated=True, win_exp=1, device=None):
    """Inverse STFT, Griffin-Lim least-squares for win_exp=1, with leading
    batch dims. Sx: complex (..., n_freqs, n_segs) array or tensor.
    Returns (..., N) on Sx's device (`as_signal`'s rule for arrays and
    `device`): float64 for a complex128 Sx (irfft and overlap-add in
    float64, as the JAX package), else float32."""
    Sx = as_signal(Sx, device)
    double = Sx.dtype in (torch.complex128, torch.float64)
    Sx = Sx.to(torch.complex128 if double else torch.complex64)
    n_fft = int(n_fft or (Sx.shape[-2] - 1) * 2)
    win_len = int(win_len or n_fft)
    N = int(N or hop_len * Sx.shape[-1])

    window = get_window(window, win_len, n_fft=n_fft,
                        dtype="float64" if double else "float32")
    check_nola(window, hop_len)
    wn = torch.as_tensor(window_norm(window, hop_len, n_fft, N, win_exp),
                         device=Sx.device)

    Sr, Si = Sx.real, Sx.imag
    if (not double and hop_len == 1 and N == Sx.shape[-1] and
            istft_ola_ok(n_fft)):
        mats = (n_fft, bool(modulated), _win_bytes(window), int(win_exp))
        Fr, Fs = _irfft_mats_weighted(*mats, Sx.device)
        x = istft_ola(Sr, Si, Fr, Fs, n_fft, adjoint=_irfft_spec(*mats))
    else:
        if not double and n_fft <= MATMUL_NFFT_MAX:
            Fr, Fs = (torch.as_tensor(F, device=Sx.device)
                      for F in _irfft_mats(n_fft, bool(modulated)))
            xbuf = torch.matmul(Fr, Sr) - torch.matmul(Fs, Si)
        else:
            xbuf = torch.fft.irfft(Sx, n=n_fft, dim=-2)
            if modulated:
                xbuf = torch.fft.fftshift(xbuf, dim=-2)
        x = overlap_add(xbuf, window, hop_len, n_fft, N + n_fft - 1, win_exp)

    tiny = torch.finfo(x.dtype).tiny
    ok = wn > tiny
    x = torch.where(ok, x / torch.where(ok, wn, torch.ones_like(wn)), x)
    # unpad: x[n_fft//2 : -(n_fft-1)//2]
    return x[..., n_fft // 2: (N + n_fft - 1) - (n_fft - 1) // 2]
