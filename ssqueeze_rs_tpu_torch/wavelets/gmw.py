"""Generalized Morse Wavelets (counterpart of ``ssqueeze_rs_tpu/wavelets/gmw.py``).

  L1 (bandpass): psih(w) = 2*exp(-beta*ln(wc) + wc^gamma + beta*ln(w) - w^gamma)
  L2 (energy):   psih(w) = sqrt(2*pi*gamma*2^r / Gamma(r)) * w^beta * exp(-w^gamma),
                 r = (2*beta+1)/gamma
  order k > 0:   multiplied by the generalized Laguerre polynomial in 2*w^gamma.

Constants are computed on the host (scipy); `fn(w, xp)` evaluates with
numpy or torch. The morsewave family generator and the factory API wait
for ROADMAP Queue 1 item 2 (wavelets remainder).
"""
from __future__ import annotations

import numpy as np
from scipy.special import gammaln as gammaln_fn, gamma as gamma_fn

from .base import register_family

pi = np.pi


def morsefreq(gamma: float, beta: float):
    """GMW radian peak frequency."""
    return (beta / gamma) ** (1 / gamma)


def gmw_k_constants(gamma: float, beta: float, k: int, norm: str = "bandpass"):
    """Laguerre-polynomial + normalization constants for order-k GMWs."""
    r = (2 * beta + 1) / gamma
    c = r - 1
    if norm == "bandpass":
        coeff = np.sqrt(np.exp(gammaln_fn(r) + gammaln_fn(k + 1) -
                               gammaln_fn(k + r)))
    else:
        coeff = np.sqrt(2 * pi * gamma * (2**r) *
                        np.exp(gammaln_fn(k + 1) - gammaln_fn(k + r)))
    L = np.zeros(k + 1)
    for m in range(k + 1):
        fact = np.exp(gammaln_fn(k + c + 1) - gammaln_fn(c + m + 1) -
                      gammaln_fn(k - m + 1))
        L[m] = (-1) ** m * fact / gamma_fn(m + 1)
    k_consts = L * coeff
    if norm == "bandpass":
        k_consts = k_consts * 2
    return k_consts


@register_family("gmw")
def _build_gmw(cfg):
    gamma = float(cfg.get("gamma", 3.0))
    beta = float(cfg.get("beta", 60.0))
    norm = cfg.get("norm", "bandpass")
    order = int(cfg.get("order", 0))
    centered_scale = bool(cfg.get("centered_scale", False))
    if gamma <= 0:
        raise ValueError(f"`gamma` must be positive (got {gamma})")
    if beta <= 0:
        raise ValueError(f"`beta` must be positive (got {beta}); "
                         "use morsewave for beta=0")
    if norm not in ("bandpass", "energy"):
        raise ValueError(f"`norm` must be 'bandpass' or 'energy' (got {norm})")

    wc = morsefreq(gamma, beta)
    wcl = np.log(wc)

    if order == 0:
        if norm == "bandpass":
            def fn(w, xp):
                if centered_scale:
                    w = w * wc
                wp = w * (w >= 0)
                wl = xp.log(xp.where(w > 0, wp, 1.0))
                return 2 * xp.exp(-beta * wcl + wc**gamma
                                  + beta * wl - wp**gamma) * (w > 0)
        else:
            r = (2 * beta + 1) / gamma
            A = np.sqrt(2.0 * pi * gamma * 2.0**r / gamma_fn(r))

            def fn(w, xp):
                if centered_scale:
                    w = w * wc
                wp = w * (w >= 0)
                return A * wp**beta * xp.exp(-(wp**gamma)) * (w >= 0)
    else:
        k_consts = gmw_k_constants(gamma, beta, order, norm)

        def fn(w, xp):
            if centered_scale:
                w = w * wc
            wp = w * (w >= 0)
            C = k_consts[0] * xp.ones_like(wp)
            for m in range(1, len(k_consts)):
                C = C + k_consts[m] * (2 * wp**gamma) ** m
            wl = xp.log(xp.where(w > 0, wp, 1.0))
            if norm == "bandpass":
                return C * xp.exp(-beta * wcl + wc**gamma
                                  + beta * wl - wp**gamma) * (w > 0)
            return C * xp.exp(beta * wl - wp**gamma) * (w > 0)

    return fn
