"""Generalized Morse Wavelets (counterpart of ``ssqueeze_rs_tpu/wavelets/gmw.py``).

  L1 (bandpass): psih(w) = 2*exp(-beta*ln(wc) + wc^gamma + beta*ln(w) - w^gamma)
  L2 (energy):   psih(w) = sqrt(2*pi*gamma*2^r / Gamma(r)) * w^beta * exp(-w^gamma),
                 r = (2*beta+1)/gamma
  order k > 0:   multiplied by the generalized Laguerre polynomial in 2*w^gamma.

Constants are computed on the host (scipy); `fn(w, xp)` evaluates with
numpy or torch. The morsewave family generator and the factory API wait
for ROADMAP Queue 1 item 2 (wavelets remainder); `morsefreq` and
`morseafun` are whole.
"""
from __future__ import annotations

import numpy as np
from scipy.special import gammaln as gammaln_fn, gamma as gamma_fn

from .base import register_family

pi = np.pi


def morsefreq(gamma: float, beta: float, n_out: int = 1):
    """GMW frequency measures (radian): peak, energy, instantaneous, and
    (n_out=4) the curvature of the instantaneous frequency at the wavelet
    centre, from the 2nd and 3rd frequency cumulants. Returns wm, or the
    tuple (wm, we), (wm, we, wi) or (wm, we, wi, cwi) for n_out 2-4."""
    wm = (beta / gamma) ** (1 / gamma)
    if n_out == 1:
        return wm
    we = (1 / 2 ** (1 / gamma)) * (gamma_fn((2 * beta + 2) / gamma) /
                                   gamma_fn((2 * beta + 1) / gamma))
    if n_out == 2:
        return wm, we
    wi = gamma_fn((beta + 2) / gamma) / gamma_fn((beta + 1) / gamma)
    if n_out == 3:
        return wm, we, wi
    k2 = _cumulant(2, gamma, beta)
    k3 = _cumulant(3, gamma, beta)
    return wm, we, wi, -(k3 / k2 ** 1.5)


def morseafun(gamma: float, beta: float, k: int = 1, norm: str = "bandpass"):
    """GMW peak amplitude."""
    if norm == "energy":
        r = (2 * beta + 1) / gamma
        return np.sqrt(2 * pi * gamma * (2**r) *
                       np.exp(gammaln_fn(k) - gammaln_fn(k + r - 1)))
    if beta == 0:
        return 2.0
    wc = morsefreq(gamma, beta)
    return 2.0 / np.exp(beta * np.log(wc) - wc**gamma)


def _cumulant(p: int, gamma: float, beta: float):
    """The p-th cumulant of the frequency-domain moments M0..Mp of the
    order-1 GMW under bandpass normalization, Mq = A(gamma, beta) *
    Gamma((beta + q + 1) / gamma) / (2 pi gamma), from the recurrence
    K0 = ln M0, Kn = Mn/M0 - sum_{k=1}^{n-1} C(n-1, k-1) Kk M(n-k)/M0."""
    from math import comb
    a = morseafun(gamma, beta, k=1)
    m = [a * (gamma_fn((beta + q + 1) / gamma) / (2 * pi * gamma))
         for q in range(p + 1)]
    kc = [np.log(m[0])]
    for n in range(1, p + 1):
        kc.append(m[n] / m[0] - sum(comb(n - 1, k - 1) * kc[k] *
                                    (m[n - k] / m[0]) for k in range(1, n)))
    return kc[p]


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
