"""Host planning of halo-chunked CWTs (counterpart of the host numpy part
of ``ssqueeze_rs_tpu/parallel/chunked.py``): the default halo and the
per-row tail mass that bounds a chunked row's error. The sharded
transforms of that module (`chunked_*`) wait for ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

import numpy as np

from ..wavelets.base import Wavelet
from ..wavelets.props import time_resolution

__all__ = ["default_cwt_halo", "overlap_save_tail_mass"]


def default_cwt_halo(wavelet: Wavelet, max_scale: float, n_std: float = 4.0,
                     N: int = 4096) -> int:
    """Halo sized from the wavelet's time std at the largest scale:
    std_t(scale) ~ scale * std_t(scale_ref) / scale_ref samples, and the
    halo covers `n_std` standard deviations."""
    sc = wavelet.scalec_ct
    std_ref = time_resolution(wavelet, scale=sc, N=N, nondim=False)
    return int(np.ceil(n_std * std_ref * max_scale / sc))


def overlap_save_tail_mass(wavelet: Wavelet, scales, halo: int, M: int):
    """Per-scale L1 mass fraction of the discrete wavelet kernel outside
    +-halo samples, at circular length M: the bound on the overlap-save
    error of a chunked CWT row (host numpy). The kernel is the filter the
    transform applies (the inverse FFT of the sampled psih), so this sees
    both the large scales' support and the slow tails of near-Nyquist
    rows."""
    scales = np.asarray(scales, np.float64).reshape(-1)
    out = np.empty(len(scales))
    block = max(1, (1 << 22) // max(M, 1))
    pn = (-1.0) ** np.arange(M)
    c = M // 2
    lo, hi = max(0, c - halo), min(M, c + halo + 1)
    for i0 in range(0, len(scales), block):
        sc = scales[i0:i0 + block]
        psih = np.atleast_2d(wavelet.sample(sc, M))
        a = np.abs(np.fft.ifft(psih * pn, axis=-1))
        tot = np.maximum(a.sum(-1), 1e-300)
        out[i0:i0 + len(sc)] = 1.0 - a[:, lo:hi].sum(-1) / tot
    return out
