"""DFT frequency grids (counterpart of ``ssqueeze_rs_tpu/utils/fft.py``).

The radian grid with a *positive* Nyquist bin for even N:

    N=128: [0, 1, ..., 64, -63, ..., -1] * (2*pi/N) * scale

and the reference's FFT entry points (`fft`, `rfft`, ..., `FFT_GLOBAL`)
on torch.fft.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import as_signal


def xifn(scale, N, xp=None, dtype=None):
    """Radian frequency grid `scale * 2*pi*k/N` with positive Nyquist.

    `xp` selects the array module (numpy, the default, or torch); `dtype`
    defaults to float64 with numpy. Returns a 1D array of length N."""
    if xp is None:
        xp = np
    if dtype is None and xp is np:
        dtype = np.float64
    i = xp.arange(N)
    k = xp.where(i <= N // 2, i, i - N)
    if xp is not np:
        k = k.to(xp.float64)          # torch takes int * float as float32
    xi = k * (2 * np.pi / N) * scale
    if dtype is not None:
        xi = xi.astype(dtype) if xp is np else xi.to(dtype)
    return xi


def aifftshift_idx(N):
    """Analytic ifftshift as an index permutation: moves the left N//2+1
    bins to the right, turning the `xifn` grid into an ascending -pi..pi
    grid."""
    if N % 2 == 1:
        return np.fft.ifftshift(np.arange(N))
    return np.concatenate([np.arange(N // 2 + 1, N), np.arange(N // 2 + 1)])


def afftshift_idx(N):
    """Inverse of `aifftshift_idx`: moves the right N//2+1 bins to the
    left."""
    if N % 2 == 1:
        return np.fft.fftshift(np.arange(N))
    return np.concatenate([np.arange(N // 2 - 1, N), np.arange(N // 2 - 1)])


def _take_last(xh, idx):
    if isinstance(xh, torch.Tensor):
        return xh[..., torch.as_tensor(idx, device=xh.device)]
    return np.asarray(xh)[..., idx]


def afftshift(xh, xp=np):
    """Analytic fftshift along the last axis: the right N//2+1 bins (the
    Nyquist bin filed positive) move to the left. A tensor stays on its
    device; `xp` is accepted for the JAX package's signature."""
    return _take_last(xh, afftshift_idx(xh.shape[-1]))


def aifftshift(xh, xp=np):
    """Inverse of `afftshift`."""
    return _take_last(xh, aifftshift_idx(xh.shape[-1]))


# -- FFT entry points under the reference's names: torch.fft on the input's
# device (`as_signal`'s rule: arrays go to the CUDA device by default)
def fft(x, axis=-1, **kw):
    return torch.fft.fft(as_signal(x), dim=axis)


def rfft(x, axis=-1, **kw):
    return torch.fft.rfft(as_signal(x), dim=axis)


def ifft(x, axis=-1, **kw):
    # a real input's inverse comes back with torch's lazy conjugate bit
    return torch.fft.ifft(as_signal(x), dim=axis).resolve_conj()


def irfft(x, n=None, axis=-1, **kw):
    return torch.fft.irfft(as_signal(x), n=n, dim=axis)


def fftshift(x, axes=-1):
    # the last axis only by default: shifting every axis of a 2D transform
    # would scramble the scale/frequency axis
    return torch.fft.fftshift(as_signal(x), dim=axes)


def ifftshift(x, axes=-1):
    return torch.fft.ifftshift(as_signal(x), dim=axes)


class FFT:
    """Stateful FFT object with the reference's surface (`FFT`,
    `FFT_GLOBAL`). There is one backend, torch.fft (cuFFT on the card,
    whose plans torch caches per process), so `patience` (0, 1, 2 or a
    `(patience, planning_timelimit)` tuple) and `wisdom_dir` are validated
    and stored and change nothing; `load_wisdom` / `save_wisdom` do
    nothing and return None; `threads`, `cache_fft_objects` and `astensor`
    are accepted and ignored."""

    def __init__(self, planning_timelimit=120, wisdom_dir=None,
                 threads=None, patience=0, cache_fft_objects=False,
                 verbose=1):
        self.planning_timelimit = planning_timelimit
        self.wisdom_dir = wisdom_dir
        self._user_threads = threads
        self.cache_fft_objects = cache_fft_objects
        self.verbose = verbose
        self._patience = 0
        self.patience = patience

    @property
    def threads(self):
        if self._user_threads is None:
            import multiprocessing
            return multiprocessing.cpu_count()
        return self._user_threads

    @property
    def patience(self):
        return self._patience

    @patience.setter
    def patience(self, value):
        # a tuple also sets planning_timelimit
        if isinstance(value, tuple):
            if len(value) != 2 or value[0] == 0:
                raise ValueError("tuple `patience` must be "
                                 "(patience != 0, planning_timelimit); "
                                 f"got {value!r}")
            value, self.planning_timelimit = value
        if value not in (0, 1, 2):
            raise ValueError(f"`patience` must be 0, 1, or 2 (got "
                             f"{value!r})")
        self._patience = value

    def load_wisdom(self):
        """No-op: torch keeps its own cuFFT plan cache."""
        return None

    def save_wisdom(self):
        """No-op: torch keeps its own cuFFT plan cache."""
        return None

    def _patience_arg(self, patience):
        if patience is not None and patience != self._patience:
            self.patience = patience

    def fft(self, x, axis=-1, patience=None, astensor=False):
        self._patience_arg(patience)
        return fft(x, axis=axis)

    def rfft(self, x, axis=-1, patience=None, astensor=False):
        self._patience_arg(patience)
        return rfft(x, axis=axis)

    def ifft(self, x, axis=-1, patience=None, astensor=False):
        self._patience_arg(patience)
        return ifft(x, axis=axis)

    def irfft(self, x, axis=-1, patience=None, astensor=False, n=None):
        self._patience_arg(patience)
        return irfft(x, n=n, axis=axis)

    def fftshift(self, x, axes=-1, astensor=False):
        return fftshift(x, axes=axes)

    def ifftshift(self, x, axes=-1, astensor=False):
        return ifftshift(x, axes=axes)


FFT_GLOBAL = FFT()
