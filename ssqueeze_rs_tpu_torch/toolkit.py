"""Small user toolkit (host numpy; counterpart of
``ssqueeze_rs_tpu/toolkit.py``)."""
from __future__ import annotations

import numpy as np

from .utils.common import _host, mad_rms  # noqa: F401 (mad_rms)

__all__ = ["lin_band", "cos_f", "sin_f", "mad_rms", "where_amax"]


def _t(tmin, tmax, N, endpoint=False):
    return np.linspace(tmin, tmax, N, endpoint=endpoint)


def lin_band(Tx, slope, offset, bw=0.025, viz=False, **kw):
    """Linear curve band (centres and widths, int32 numpy) over the TF
    plane, for component inversion. Reads only Tx's shape, so a tensor on
    the card is not fetched unless `viz=True` plots |Tx| with the band's
    edges (`visuals`; `kw` goes to its imshow)."""
    na, N = Tx.shape[-2:]
    tcs = np.linspace(0, 1, N)
    Cs = slope * (tcs + offset) * na
    freqband = bw * na * np.ones(N)
    Cs, freqband = Cs.astype("int32"), freqband.astype("int32")
    if viz:
        from .visuals import imshow, plot
        imshow(Tx, abs=1, aspect="auto", show=0, **kw)
        plot(Cs + freqband, color="r")
        plot(Cs - freqband, color="r", show=1)
    return Cs, freqband


def cos_f(freqs, N=128, phi=0, endpoint=False):
    """Adjacent different-frequency cosines."""
    return np.concatenate(
        [np.cos(2 * np.pi * f * (_t(i, i + 1, N, endpoint) + phi))
         for i, f in enumerate(freqs)])


def sin_f(freqs, N=128, phi=0, endpoint=False):
    """Adjacent different-frequency sines."""
    return np.concatenate(
        [np.sin(2 * np.pi * f * (_t(i, i + 1, N, endpoint) + phi))
         for i, f in enumerate(freqs)])


def where_amax(x):
    """N-dim indices where |x| == max|x| (host numpy; a tensor is
    fetched)."""
    x = _host(x)
    return np.where(np.abs(x) == np.abs(x).max())
