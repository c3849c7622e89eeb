"""Wavelet spec (counterpart of ``ssqueeze_rs_tpu/wavelets/base.py``).

A wavelet is a frozen, hashable (name, params) spec whose
`psih(w, xp)` evaluates the frequency-domain wavelet with numpy
(host planning) or torch (the filterbank, sampled on the tensor's
device). Hashability lets host planning results be cached per
(wavelet, N, ...).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ..config import DEFAULTS
from ..utils.common import assert_is_one_of
from ..utils.fft import xifn

# registry: name -> builder(params dict) -> psih(w, xp)
_FAMILIES = {}


def register_family(name):
    def deco(builder):
        _FAMILIES[name] = builder
        return builder
    return deco


@dataclass(frozen=True)
class Wavelet:
    """Frozen wavelet spec; positive-frequency support assumed."""
    name: str
    params: tuple  # sorted ((key, value), ...) pairs, hashable

    @staticmethod
    def build(spec="gmw", l1_norm: bool | None = None, **overrides) -> "Wavelet":
        """Accepts: Wavelet | str | (str, dict)."""
        if isinstance(spec, Wavelet):
            return spec
        if callable(spec):
            raise NotImplementedError(
                "custom callable wavelets are not ported yet "
                "(ROADMAP Queue 1 item 2, wavelets/base.py remainder)")
        if isinstance(spec, tuple):
            name, opts = spec
            opts = dict(opts)
        else:
            name, opts = spec, {}
        name = name.lower()
        opts.update(overrides)
        assert_is_one_of(name, "wavelet", tuple(_FAMILIES))
        if name == "gmw" and l1_norm is not None:
            opts.setdefault("norm", "bandpass" if l1_norm else "energy")
        for k, v in DEFAULTS.get(name, {}).items():
            opts.setdefault(k, v)
        return Wavelet(name, tuple(sorted(opts.items())))

    @property
    def config(self) -> dict:
        return dict(self.params)

    @cached_property
    def _fn(self):
        return _FAMILIES[self.name](self.config)

    def psih(self, w, xp=np):
        """Evaluate the frequency-domain wavelet at radian frequencies `w`
        (`xp` = np for arrays, torch for tensors)."""
        return self._fn(w, xp)

    def __call__(self, w):
        """numpy evaluation (host-side planning)."""
        return self.psih(np.asarray(w, dtype=np.float64), np)

    @cached_property
    def psih_is_real(self) -> bool:
        """Does psih evaluate real-valued? (the planar path's requirement)"""
        return bool(np.isrealobj(self(np.array([0.31, 0.7, 1.3]))))

    def sample(self, scales, N: int, nohalf: bool = False,
               half: bool = False, device=None):
        """Filterbank `psih(scales[:, None] * xi(1, N))`, shape
        (len(scales), N): host numpy, or torch on `device` when one is
        given (the grid in the scales' float type: float32 for float32
        scales, as the JAX package's traced sampling). `nohalf=False`
        halves the even-N Nyquist bin. `half=True` samples only the bins
        k = 0..N/2 (shape (len(scales), N/2 + 1), even N; exact for
        analytic wavelets, psih = 0 for w < 0), whose last bin is the
        Nyquist bin."""
        if half and N % 2:
            raise ValueError(f"half=True needs an even N (got {N})")
        nyq = N // 2 if (half or N % 2 == 0) else None
        if device is None:
            xi = xifn(1, N)[:N // 2 + 1] if half else xifn(1, N)
            w = np.asarray(scales).reshape(-1, 1) * xi[None, :]
            psih = np.array(self.psih(w, np))
        else:
            import torch
            sc = torch.as_tensor(np.asarray(scales), device=device)
            xi = torch.as_tensor(xifn(1, N, dtype=np.float32 if sc.dtype ==
                                      torch.float32 else np.float64),
                                 device=device)
            if half:
                xi = xi[:N // 2 + 1]
            psih = self.psih(sc.reshape(-1, 1) * xi[None, :], torch)
            if not nohalf and nyq is not None:
                psih = psih.clone()
        if not nohalf and nyq is not None:
            psih[..., nyq] /= 2
        return psih

    def psi_time(self, scale: float, N: int):
        """Centred time-domain wavelet at one scale, (N,) complex host
        numpy: the inverse FFT of the filterbank (Nyquist bin halved) with
        its spectrum reversed by (-1)^n."""
        psih = self.sample(scale, N)[0]
        return np.fft.ifft(psih * (-1.0) ** np.arange(N))

    @cached_property
    def wc_ct(self) -> float:
        """Continuous-time radian peak frequency (kind='peak-ct')."""
        from .props import find_maximum
        return float(find_maximum(self)[0])

    @cached_property
    def scalec_ct(self) -> float:
        """The scale that puts the peak at pi/4."""
        return (4 / np.pi) * self.wc_ct
