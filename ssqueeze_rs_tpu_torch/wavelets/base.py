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

    def sample(self, scales, N: int, nohalf: bool = False):
        """Host filterbank `psih(scales[:, None] * xi(1, N))`, shape
        (len(scales), N). `nohalf=False` halves the even-N Nyquist bin."""
        xi = xifn(1, N)
        w = np.asarray(scales).reshape(-1, 1) * xi[None, :]
        psih = np.array(self.psih(w, np))
        if not nohalf and N % 2 == 0:
            psih[..., N // 2] /= 2
        return psih
