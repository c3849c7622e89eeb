"""Wavelet spec (counterpart of ``ssqueeze_rs_tpu/wavelets/base.py``).

A wavelet is a frozen, hashable (name, params) spec whose
`psih(w, xp)` evaluates the frequency-domain wavelet with numpy
(host planning) or torch (the filterbank, sampled on the tensor's
device). Hashability lets host planning results be cached per
(wavelet, N, ...). A custom `psih` callable is registered under a
family name of its own (`Wavelet.build(fn)`).
"""
from __future__ import annotations

import itertools
from collections import OrderedDict
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

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


def factory_psih(fn, dtype):
    """The reference's `lambda w: psih(w)` over a family's `fn(w, xp)`:
    arrays and numbers in host numpy at `dtype`, a tensor in torch on its
    own device at `dtype`."""
    def psih(w):
        if isinstance(w, torch.Tensor):
            return fn(torch.atleast_1d(w.to(getattr(torch,
                                                    np.dtype(dtype).name))),
                      torch)
        return fn(np.atleast_1d(np.asarray(w, dtype)), np)
    return psih


# Custom callable wavelets: a bounded LRU of strong references, so
# `Wavelet.build(lambda ...)` keeps working after the caller drops the
# lambda, and throwaway lambdas cannot grow the registry without limit.
# Names are counter-unique forever, so a recycled id() never aliases a
# dead callable's cached planning.
_CUSTOM_LRU: "OrderedDict[str, object]" = OrderedDict()
_CUSTOM_BY_ID: dict = {}
_CUSTOM_MAX = 64
_custom_counter = itertools.count()


def _custom_builder(spec):
    """The family of a custom callable. It is handed what the JAX package
    hands its callables: host numpy in host planning (scale bounds,
    center frequencies: `xp` numpy), and in the transforms the frequency
    grid as a tensor on the signal's device, where JAX hands it a device
    array. So it must take both, as a JAX one must take numpy and jnp
    arrays: torch functions refuse numpy arrays (`torch.as_tensor(w)`
    first), numpy functions refuse CUDA tensors. A tensor result of a host
    call comes back as numpy."""
    def build(cfg):
        def psih(w, xp):
            out = spec(w)
            if xp is np:
                return np.asarray(out)
            return torch.as_tensor(out, device=w.device)
        return psih
    return build


def _register_callable(spec) -> str:
    name = _CUSTOM_BY_ID.get(id(spec))
    if (name is not None and name in _CUSTOM_LRU and
            _CUSTOM_LRU[name] is spec):
        _CUSTOM_LRU.move_to_end(name)
        return name
    name = f"_custom_{next(_custom_counter)}"
    _CUSTOM_LRU[name] = spec
    _CUSTOM_BY_ID[id(spec)] = name
    _FAMILIES[name] = _custom_builder(spec)
    while len(_CUSTOM_LRU) > _CUSTOM_MAX:
        old, oldspec = _CUSTOM_LRU.popitem(last=False)
        _FAMILIES.pop(old, None)
        if _CUSTOM_BY_ID.get(id(oldspec)) == old:
            del _CUSTOM_BY_ID[id(oldspec)]
    return name


@dataclass(frozen=True)
class Wavelet:
    """Frozen wavelet spec; positive-frequency support assumed."""
    name: str
    params: tuple  # sorted ((key, value), ...) pairs, hashable

    # -- construction ---------------------------------------------------------
    @staticmethod
    def build(spec="gmw", l1_norm: bool | None = None, **overrides) -> "Wavelet":
        """Accepts: Wavelet | str | (str, dict) | a custom psih callable
        (registered under a family name of its own; see `_custom_builder`
        for what it is handed)."""
        if isinstance(spec, Wavelet):
            return spec
        if callable(spec) and not isinstance(spec, str):
            return Wavelet(_register_callable(spec), ())
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

    @property
    def config_str(self) -> str:
        """`config` formatted like the reference: drops norm /
        centered_scale / dtype and a base wavelet's order=0, writes whole
        floats as ints."""
        cfg = ""
        for k, v in self.config.items():
            if k in ("norm", "centered_scale", "dtype"):
                continue
            if k == "order" and v == 0:
                continue
            if isinstance(v, float) and v.is_integer():
                v = int(v)
            cfg += f"{k}={v}, "
        return cfg.rstrip(", ") or "Default configs"

    # -- default-length state -------------------------------------------------
    # `N`, `wc` and the `Psih` memo live in the instance __dict__, not in
    # the dataclass fields: two Wavelets with equal (name, params) stay ==
    # and hash-equal whatever their default N.
    @property
    def N(self) -> int:
        """Default length of the methods that take `N`; settable:
        `wavelet.N = 2048`."""
        return self.__dict__.get("_default_N", 1024)

    @property
    def xi(self):
        """Radian frequency grid at scale=1, length `self.N` (numpy)."""
        return xifn(1, self.N, xp=np)

    @property
    def dtype(self) -> str:
        """dtype psih/psi are generated at: float64 for host planning
        unless the config names one."""
        return str(self.config.get("dtype", "float64"))

    # -- evaluation -----------------------------------------------------------
    @cached_property
    def _fn(self):
        try:
            builder = _FAMILIES[self.name]
        except KeyError:
            raise RuntimeError(
                f"wavelet family '{self.name}' is no longer registered — "
                "custom callable wavelets are kept in a bounded LRU of "
                f"{_CUSTOM_MAX}; rebuild the Wavelet from its callable "
                "(Wavelet.build(fn)) to re-register") from None
        return builder(self.config)

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

    def psifn(self, w=None, *, scale=None, N=None):
        """Time-domain wavelet by spectral reversal and inverse FFT (host
        numpy, complex). With `w` given, inverts psih(w) (its even-length
        Nyquist bin halved); else samples at (scale, N), defaults scale=1,
        N=self.N."""
        if w is not None:
            psih = np.asarray(self(w), dtype=np.complex128).copy()
            M = psih.shape[-1]
            if M % 2 == 0:
                psih[..., M // 2] /= 2
            pn = (-1.0) ** np.arange(M)
            return np.fft.ifft(psih * pn, axis=-1)
        scale = 1.0 if scale is None else scale
        N = self.N if N is None else int(N)
        out = np.asarray(self.psi_time(float(scale), N, xp=np))
        return out[0] if out.ndim == 2 else out

    def xifn(self, scale=None, N=None):
        """Radian frequencies `scale * xi(1, N)` (numpy). A 1D `scale`
        broadcasts to a (n_scales, N) grid; defaults scale=1, N=self.N."""
        if N is None and scale is None:
            return self.xi
        N = self.N if N is None else int(N)
        scale = 1.0 if scale is None else scale
        scale = np.asarray(scale, dtype=np.float64)
        if scale.ndim > 1 and scale.squeeze().ndim > 1:
            raise ValueError("2D `scale` unsupported")
        if scale.ndim >= 1 and scale.size > 1:
            scale = scale.reshape(-1, 1)
        return scale * xifn(1, N, xp=np)

    def Psih(self, scale=None, N=None, nohalf=True):
        """Filterbank memo (host numpy): recomputed only when (scale, N)
        changed since the last call; both None returns the previous
        result. Kept outside the dataclass fields, so ==/hash are
        unaffected."""
        d = self.__dict__
        pN, ps = d.get("_Psih_N"), d.get("_Psih_scale")
        N_is_None = N is None
        N = N or self.N
        if "_Psih" in d:
            if scale is None and N_is_None:
                return d["_Psih"]
            if (N == pN and scale is not None and ps is not None and
                    np.shape(scale) == np.shape(ps) and
                    np.allclose(np.asarray(scale, dtype=np.float64), ps)):
                return d["_Psih"]
        if scale is None:
            scale = 1.0
        out = self.sample(np.asarray(scale, dtype=np.float64), int(N),
                          xp=np, nohalf=nohalf)
        d["_Psih"] = out
        d["_Psih_N"] = int(N)
        d["_Psih_scale"] = np.asarray(scale, dtype=np.float64)
        return out

    def sample(self, scales, N: int, xp=np, nohalf: bool = False,
               half: bool = False, device=None):
        """Filterbank `psih(scales[:, None] * xi(1, N))`, shape
        (len(scales), N), or (N,) for a scalar scale: host numpy, or torch
        when `xp` is torch or a `device` is given (on `device`, default
        the CPU; the grid in the scales' float type: float32 for float32
        scales, as the JAX package's traced sampling). `nohalf=False`
        halves the even-N Nyquist bin. `half=True` samples only the bins
        k = 0..N/2 (shape (..., N/2 + 1), even N; exact for analytic
        wavelets, psih = 0 for w < 0), whose last bin is the Nyquist
        bin."""
        if half and N % 2:
            raise ValueError(f"half=True needs an even N (got {N})")
        nyq = N // 2 if (half or N % 2 == 0) else None
        scalar = np.ndim(scales) == 0
        if device is None and xp is np:
            xi = xifn(1, N)[:N // 2 + 1] if half else xifn(1, N)
            w = np.asarray(scales).reshape(-1, 1) * xi[None, :]
            psih = np.array(self.psih(w, np))
        else:
            sc = torch.as_tensor(np.asarray(scales), device=device)
            xi = torch.as_tensor(xifn(1, N, dtype=np.float32 if sc.dtype ==
                                      torch.float32 else np.float64),
                                 device=sc.device)
            if half:
                xi = xi[:N // 2 + 1]
            psih = self.psih(sc.reshape(-1, 1) * xi[None, :], torch)
            if not nohalf and nyq is not None:
                psih = psih.clone()
        if not nohalf and nyq is not None:
            psih[..., nyq] /= 2
        return psih[0] if scalar else psih

    def psi_time(self, scale, N: int, xp=np):
        """Centred time-domain wavelet: the inverse FFT of the filterbank
        (Nyquist bin halved) with its spectrum reversed by (-1)^n; complex
        host numpy, or a torch tensor with `xp` torch."""
        psih = self.sample(scale, N, xp=xp, nohalf=False)
        if xp is np:
            return np.fft.ifft(psih * (-1.0) ** np.arange(N), axis=-1)
        pn = 1.0 - 2.0 * (torch.arange(N, device=psih.device) % 2)
        return torch.fft.ifft(psih * pn, dim=-1)

    # -- properties (host-side, cached) -------------------------------------
    @cached_property
    def wc_ct(self) -> float:
        """Continuous-time radian peak frequency (kind='peak-ct')."""
        from .props import find_maximum
        return float(find_maximum(self)[0])

    @cached_property
    def scalec_ct(self) -> float:
        """The scale that puts the peak at pi/4."""
        return (4 / np.pi) * self.wc_ct

    @property
    def wc(self) -> float:
        """Energy center frequency at scale=scalec_ct, N=self.N
        [(radians*cycles)/samples]. Cached; `reset_properties()`
        recomputes it for the current `self.N`."""
        if self.__dict__.get("_wc") is None:
            self.__dict__["_wc"] = float(self.center_frequency(
                scale=self.scalec_ct, N=self.N, kind="energy"))
        return self.__dict__["_wc"]

    TF_PROPS = ("wc", "wc_ct", "scalec_ct")

    def reset_properties(self):
        """Recompute the cached time-frequency properties (`TF_PROPS`) for
        the current `self.N`; the std_t / std_w family is computed on
        demand, so it never goes stale."""
        for name in ("_wc", "wc_ct", "scalec_ct", "_Psih", "_Psih_N",
                     "_Psih_scale"):
            self.__dict__.pop(name, None)
        _ = (self.wc_ct, self.scalec_ct, self.wc)

    def center_frequency(self, scale=None, N=1024, kind="energy",
                         force_int=None):
        from .props import center_frequency
        return center_frequency(self, scale=scale, N=N, kind=kind,
                                force_int=force_int)

    def std_t(self, scale=None, N=1024, nondim=True):
        from .props import time_resolution
        scale = self.scalec_ct if scale is None else scale
        return time_resolution(self, scale=scale, N=N, nondim=nondim)

    def std_w(self, scale=None, N=1024, nondim=True):
        from .props import freq_resolution
        scale = self.scalec_ct if scale is None else scale
        return freq_resolution(self, scale=scale, N=N, nondim=nondim)

    def harea(self, scale=None, N=1024):
        return self.std_t(scale, N) * self.std_w(scale, N)

    # std_f: the cyclic frequency resolution; *_d: dimensional (samples)
    def std_f(self, scale=None, N=1024, nondim=True):
        return self.std_w(scale, N, nondim=nondim) / (2 * np.pi)

    def std_t_d(self, scale=None, N=1024):
        return self.std_t(scale, N, nondim=False)

    def std_w_d(self, scale=None, N=1024):
        return self.std_w(scale, N, nondim=False)

    def std_f_d(self, scale=None, N=1024):
        return self.std_w_d(scale, N) / (2 * np.pi)

    VISUALS = ("heatmap", "waveforms", "filterbank", "harea", "std_t",
               "std_w", "time-frequency", "anim:time-frequency")

    def viz(self, name="overview", **kw):
        """Plot one of `Wavelet.VISUALS` (`visuals`' wavelet views);
        'overview' plots the heatmap, harea sweep, filterbank and
        time-frequency views."""
        from .. import visuals
        if name == "overview":
            for nm in ("heatmap", "harea", "filterbank", "time-frequency"):
                self.viz(nm, **kw)
            return
        if name not in Wavelet.VISUALS:
            raise ValueError(f"visual '{name}' not supported; must be one "
                             "of: " + ", ".join(Wavelet.VISUALS))
        fn = {
            "heatmap": visuals.wavelet_heatmap,
            "waveforms": visuals.wavelet_waveforms,
            "filterbank": visuals.wavelet_filterbank,
            "harea": visuals.sweep_harea,
            "std_t": visuals.sweep_std_t,
            "std_w": visuals.sweep_std_w,
            "time-frequency": visuals.wavelet_tf,
            "anim:time-frequency": visuals.wavelet_tf_anim,
        }[name]
        fn(self, **kw)

    def info(self, nondim=True, N=1024):
        """Print a time & frequency resolution summary."""
        if nondim:
            std_t, std_w = self.std_t(N=N), self.std_w(N=N)
            wc, wc_txt = self.wc_ct, "wc_ct, (cycles*radians)"
            dim_t = dim_w = "non-dimensional"
        else:
            std_t = self.std_t(N=N, nondim=False)
            std_w = self.std_w(N=N, nondim=False)
            from .props import center_frequency
            wc = center_frequency(self, scale=self.scalec_ct, N=N,
                                  kind="energy")
            wc_txt = f"wc, (cycles*radians)/samples; scale={self.scalec_ct:.2f}"
            dim_t = "samples/(cycles*radians)"
            dim_w = "(cycles*radians)/samples"
        cfg = self.config_str
        print(f"{self.name} wavelet\n\t{cfg}\n"
              f"\tCenter frequency: {wc:<10.6f} [{wc_txt}]\n"
              f"\tTime resolution:  {std_t:<10.6f} [std_t, {dim_t}]\n"
              f"\tFreq resolution:  {std_w:<10.6f} [std_w, {dim_w}]\n"
              f"\tHeisenberg area:  {std_t * std_w:.12f}")


# `wavelet.N = value`: the frozen dataclass's __setattr__ rejects every
# assignment (and a frozen dataclass may not define its own), so route
# just the default length around it. The value lands in the instance
# __dict__, not a field: ==/hash stay (name, params).
_frozen_setattr = Wavelet.__setattr__


def _wavelet_setattr(self, name, value):
    if name == "N":
        self.__dict__["_default_N"] = int(value)
        self.__dict__.pop("_wc", None)      # wc is tied to N
        return
    _frozen_setattr(self, name, value)


Wavelet.__setattr__ = _wavelet_setattr


def isinstance_by_name(obj, ref):
    """Class-identity check robust to module reloads: compares the fully
    qualified class names instead of the class objects."""
    def _class_name(o):
        name = getattr(o, "__qualname__", getattr(o, "__name__", ""))
        return (getattr(o, "__module__", "") + "." + name).lstrip(".")
    return _class_name(type(obj)) == _class_name(ref)
