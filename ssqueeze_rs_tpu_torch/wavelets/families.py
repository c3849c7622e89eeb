"""Analytic wavelet families: morlet, bump, cmhat, hhhat (counterpart of
``ssqueeze_rs_tpu/wavelets/families.py``). Each builder returns
`fn(w, xp) -> psih`, evaluating with numpy or torch; `morlet`, `bump`,
`cmhat` and `hhhat` are the reference's `lambda w: psih(w)` factories
(`base.factory_psih`: host numpy, or torch on a tensor's device)."""
from __future__ import annotations

import numpy as np

from .base import factory_psih, register_family

pi = np.pi


@register_family("morlet")
def _build_morlet(cfg):
    """psih(w) = sqrt(2)*cs*pi^(1/4) * (exp(-(w-mu)^2/2) - ks*exp(-w^2/2))"""
    mu = float(cfg.get("mu", 13.4))
    cs = (1 + np.exp(-mu**2) - 2 * np.exp(-3 / 4 * mu**2)) ** (-0.5)
    ks = np.exp(-0.5 * mu**2)
    C = np.sqrt(2) * cs * pi**0.25

    def fn(w, xp):
        return C * (xp.exp(-0.5 * (w - mu) ** 2) - ks * xp.exp(-0.5 * w**2))

    return fn


@register_family("bump")
def _build_bump(cfg):
    mu = float(cfg.get("mu", 5.0))
    s = float(cfg.get("s", 1.0))
    om = float(cfg.get("om", 0.0))
    K = 0.443993816053287

    def fn(w, xp):
        _w = (w - mu) / s
        inside = xp.abs(_w) < 0.999
        _wc = _w * inside  # zero outside to avoid nan in exp
        bump = inside * xp.exp(-1.0 / (1.0 - _wc**2)) / K / s
        if om != 0.0:
            return xp.exp(2j * pi * om * w) * bump
        return bump

    return fn


@register_family("cmhat")
def _build_cmhat(cfg):
    mu = float(cfg.get("mu", 1.0))
    s = float(cfg.get("s", 1.0))
    C = 2 * np.sqrt(2 / 3) * pi ** (-1 / 4)

    def fn(w, xp):
        _w = w - mu
        return C * (s**2.5 * _w**2 * xp.exp(-(s**2) * _w**2 / 2) * (_w >= 0))

    return fn


@register_family("hhhat")
def _build_hhhat(cfg):
    mu = float(cfg.get("mu", 5.0))
    C = 2 / np.sqrt(5) * pi ** (-1 / 4)

    def fn(w, xp):
        _w = w - mu
        return C * (_w * (1 + _w) * xp.exp(-0.5 * _w**2)) * (1 + xp.sign(_w))

    return fn


# -- factory API: `lambda w: psih(w)` -----------------------------------------
def _factory(name, dtype, **cfg):
    builder = {"morlet": _build_morlet, "bump": _build_bump,
               "cmhat": _build_cmhat, "hhhat": _build_hhhat}[name]
    return factory_psih(
        builder({k: v for k, v in cfg.items() if v is not None}), dtype)


def morlet(mu=None, dtype="float64"):
    """`lambda w: psih(w)` of the Morlet wavelet."""
    return _factory("morlet", dtype, mu=mu)


def bump(mu=None, s=None, om=None, dtype="float64"):
    """`lambda w: psih(w)` of the bump wavelet."""
    return _factory("bump", dtype, mu=mu, s=s, om=om)


def cmhat(mu=None, s=None, dtype="float64"):
    """`lambda w: psih(w)` of the complex Mexican hat."""
    return _factory("cmhat", dtype, mu=mu, s=s)


def hhhat(mu=None, dtype="float64"):
    """`lambda w: psih(w)` of the Hilbert analytic Hermitian hat."""
    return _factory("hhhat", dtype, mu=mu)
