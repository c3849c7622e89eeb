"""Generalized Morse Wavelets (counterpart of ``ssqueeze_rs_tpu/wavelets/gmw.py``).

  L1 (bandpass): psih(w) = 2*exp(-beta*ln(wc) + wc^gamma + beta*ln(w) - w^gamma)
  L2 (energy):   psih(w) = sqrt(2*pi*gamma*2^r / Gamma(r)) * w^beta * exp(-w^gamma),
                 r = (2*beta+1)/gamma
  order k > 0:   multiplied by the generalized Laguerre polynomial in 2*w^gamma.

Constants are computed on the host (scipy); `fn(w, xp)` evaluates with
numpy or torch. `morsewave` (the first K orders) and `compute_gmw` are
host numpy, as in the JAX package; the `gmw*` factories evaluate on the
host or on a tensor's device.
"""
from __future__ import annotations

import numpy as np
from scipy.special import gammaln as gammaln_fn, gamma as gamma_fn

from .base import factory_psih, register_family
from ..utils.common import assert_is_one_of

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


# -- the first-K-orders family generator (host numpy) -----------------------
def laguerre(x, k: int, c: float):
    """Generalized Laguerre polynomial L_k^c(x)."""
    x = np.atleast_1d(np.asarray(x, dtype=np.float64).squeeze())
    y = np.zeros(x.shape)
    for m in range(k + 1):
        fact = np.exp(gammaln_fn(k + c + 1) - gammaln_fn(c + m + 1) -
                      gammaln_fn(k - m + 1))
        y += (-1) ** m * fact * x**m / gamma_fn(m + 1)
    return y


def morsewave(N: int, freqs, gamma: float = 3, beta: float = 60, K: int = 1,
              norm: str = "bandpass"):
    """First-K orthogonal GMWs at (radian) peak frequencies `freqs`.

    Host numpy. Returns (psih, psi), each of shape (N, len(freqs), K)
    with length-1 dims squeezed. `beta=0` raises ZeroDivisionError (the
    peak frequency is 0), as in the JAX package.
    """
    if gamma <= 0:
        raise ValueError(f"`gamma` must be positive (got {gamma})")
    if beta < 0:
        raise ValueError(f"`beta` must be non-negative (got {beta})")
    assert_is_one_of(norm, "norm", ("bandpass", "energy"))
    if not isinstance(freqs, (list, tuple, np.ndarray)):
        freqs = [freqs]
    psi = np.zeros((N, len(freqs), K), dtype="complex128")
    psif = np.zeros((N, len(freqs), K))

    for n, f in enumerate(freqs):
        X, x = _morse_family(N, abs(f), gamma, beta, K, norm)
        psif[:, n:n + 1, :], psi[:, n:n + 1, :] = X, x
        if f < 0:
            # negative frequency: conjugate time wavelet / mirror spectrum
            psi[:, n:n + 1, :] = psi[:, n, :].conj()[:, None]
            psif[1:, n:n + 1, :] = np.flip(psif[1:, n, :], axis=0)[:, None]

    return psif.squeeze(), psi.squeeze()


def _morse_order_coeffs(gamma, beta, K, norm, fact):
    """Normalization coefficient per order k = 0..K-1 (vectorized)."""
    if norm == "energy":
        return np.array([np.sqrt(1.0 / fact) *
                         morseafun(gamma, beta, k + 1, norm="energy")
                         for k in range(K)])
    if beta == 0:
        return np.ones(K)
    r = (2 * beta + 1) / gamma
    ks = np.arange(K, dtype=np.float64)
    return np.sqrt(np.exp(gammaln_fn(r) + gammaln_fn(ks + 1) -
                          gammaln_fn(ks + r)))


def _morse_family(N, f, gamma, beta, K, norm):
    """Spectrum + centered time wavelets of the first K orders at peak
    frequency `f`. The spectrum is analytic: only bins 0..N//2 are
    nonzero, so everything is computed on the half grid and placed into
    a zero full-length array."""
    fo = morsefreq(gamma, beta)
    fact = f / fo
    nhalf = N // 2 + 1
    # digital radian grid, peak moved to bin index N*f/(2*pi*fact)
    w = (2 * pi * np.linspace(0, 1, N, endpoint=False)[:nhalf] / fact)

    with np.errstate(divide="ignore", invalid="ignore"):
        if beta == 0:
            envelope = np.exp(-(w ** gamma))
            base = envelope if norm == "energy" else 2 * envelope
        elif norm == "energy":
            base = np.exp(beta * np.log(w) - w ** gamma)
        else:
            # log-domain form, cancels the wc**beta blowup
            base = 2 * np.exp(-beta * np.log(fo) + fo ** gamma
                              + beta * np.log(w) - w ** gamma)
    if beta == 0:
        base[0] /= 2            # unit-step halving for the lowpass
    base[~np.isfinite(base)] = 0.0

    coeffs = _morse_order_coeffs(gamma, beta, K, norm, fact)
    c = (2 * beta + 1) / gamma - 1
    lag = np.stack([laguerre(2 * (w ** gamma), k, c) for k in range(K)],
                   axis=-1)                                   # (nhalf, K)
    half = coeffs * base[:, None] * lag
    half[np.isinf(half)] = 0.0

    psif = np.zeros((N, 1, K))
    psif[:nhalf, 0, :] = half

    # time domain: alternate spectral signs (= centering shift by N/2),
    # halve the even-N Nyquist bin, invert
    spec = psif.copy()
    spec[1::2] = -spec[1::2]
    if N % 2 == 0:
        spec[N // 2] /= 2
    return psif, np.fft.ifft(spec, axis=0)


# -- factory / array API ----------------------------------------------------
def gmw(gamma=3.0, beta=60.0, norm="bandpass", order=0,
        centered_scale=False, dtype="float64"):
    """`lambda w: psih(w)` factory (`base.factory_psih`: host numpy, or
    torch on a tensor's device)."""
    if norm == "energy" and str(np.dtype(dtype)) == "float32":
        # wp**beta overflows float32 -> inf*0 NaNs across entire Wx rows
        raise ValueError("`norm='energy'` w/ `dtype='float32'` is "
                         "unsupported; use 'float64' instead.")
    fn = _build_gmw(dict(gamma=gamma, beta=beta, norm=norm, order=order,
                         centered_scale=centered_scale))
    return factory_psih(fn, dtype)


def gmw_l1(gamma=3.0, beta=60.0, centered_scale=False, dtype="float64"):
    """First-order L1 (bandpass) GMW factory."""
    return gmw(gamma, beta, "bandpass", 0, centered_scale, dtype)


def gmw_l2(gamma=3.0, beta=60.0, centered_scale=False, dtype="float64"):
    """First-order L2 (energy) GMW factory."""
    return gmw(gamma, beta, "energy", 0, centered_scale, dtype)


def gmw_l1_k(gamma=3.0, beta=60.0, k=1, centered_scale=False,
             dtype="float64"):
    """k-th order L1 GMW factory."""
    return gmw(gamma, beta, "bandpass", k, centered_scale, dtype)


def gmw_l2_k(gamma=3.0, beta=60.0, k=1, centered_scale=False,
             dtype="float64"):
    """k-th order L2 GMW factory."""
    return gmw(gamma, beta, "energy", k, centered_scale, dtype)


def compute_gmw(N, scale, gamma=3.0, beta=60.0, time=False,
                norm="bandpass", order=0, centered_scale=False,
                norm_scale=True, dtype="float64"):
    """Sampled GMW arrays (host numpy): psih [N] (+ psi [N] if `time`)."""
    from ..utils.fft import xifn

    fn = gmw(gamma, beta, norm, order, centered_scale, dtype)
    w = xifn(scale, N)
    X = np.zeros(N, dtype)
    X[:N // 2 + 1] = fn(w[:N // 2 + 1])
    if norm == "energy" and norm_scale:
        wc = float(np.atleast_1d(morsefreq(gamma, beta))[0])
        X *= np.sqrt(wc * scale) if centered_scale else np.sqrt(scale)
    X[np.isinf(X) | np.isnan(X)] = 0.0
    if time:
        Xr = X.copy()
        if N % 2 == 0:
            Xr[N // 2] /= 2  # halve the even-N Nyquist bin
        x = np.fft.ifft(Xr * (-1.0) ** np.arange(N))
        return X, x
    return X
