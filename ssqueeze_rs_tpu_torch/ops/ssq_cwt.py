"""Synchrosqueezed CWT, forward and inverse (counterpart of
``ssqueeze_rs_tpu/ops/ssq_cwt.py``).

Forward pipeline, all on the input's device:
    pad -> rfft -> psih on the half-band grid -> kernel A (CWT planes and
    the phase plane w) -> host planning -> kernel B (Tx)

Options outside this slice raise NotImplementedError naming the ROADMAP
item that ports them; none of them takes another route silently.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULTS, EPS32
from ..scales import process_scales, process_fs_and_t
from ..utils.common import as_signal, unported as _unported
from ..utils.pad import padsignal
from ..wavelets.adm import adm_ssq
from ..wavelets.base import Wavelet
from .cwt import cwt_core
from .fft_cuda import best_split
from .ssqueeze import ssqueeze, check_ssqueezing_args

__all__ = ["ssq_cwt", "issq_cwt"]


def _check_slice(dtype, order, get_w, get_dWx, difftype, squeezing):
    if str(dtype or DEFAULTS["dtype"]) != "float32":
        _unported(f"dtype={dtype!r}", "Queue 1 item 3, float64 route")
    if isinstance(order, (tuple, list, range)) or order != 0:
        _unported(f"order={order!r}", "Queue 1 item 6, cwt_higher_order")
    if get_w or get_dWx:
        _unported("get_w / get_dWx",
                  "Queue 1 item 3 and Queue 2 D, the dWx planes")
    if difftype in ("phase", "numeric"):
        _unported(f"difftype={difftype!r}",
                  "Queue 1 item 3, phase.py and diff.py")
    if callable(squeezing) or squeezing in ("lebesgue", "abs"):
        _unported(f"squeezing={squeezing!r}",
                  "Queue 1 item 3 and Queue 2 D, the dWx planes")


def _as_signal(x, device):
    """x as a float32 tensor on `device` (default: x's own device, or the
    CPU for array input), with non-finite samples zeroed."""
    x = torch.nan_to_num(as_signal(x, device), nan=0.0, posinf=0.0,
                         neginf=0.0)
    return x.to(torch.float32)


def ssq_cwt(x, wavelet="gmw", scales="log-piecewise", nv=None, fs=None,
            t=None, ssq_freqs=None, padtype="reflect", squeezing="sum",
            maprange="peak", difftype="trig", gamma=None, flipud=True,
            dtype=None, device=None, order=0, get_w=False, get_dWx=False):
    """Synchrosqueezed CWT of `x` ((N,) or (..., N)).

    Returns (Tx, Wx, ssq_freqs, scales): Tx (..., nf, N) and Wx
    (..., na, N) complex64 tensors on `device` (default: x's device, or
    the CPU for array input); ssq_freqs and scales numpy arrays.
    `order`, `get_w` and `get_dWx` exist only to refuse them."""
    _check_slice(dtype, order, get_w, get_dWx, difftype, squeezing)
    check_ssqueezing_args(squeezing, maprange, wavelet, difftype,
                          transform="cwt")
    x = _as_signal(x, device)
    N = x.shape[-1]
    dt, fs, _ = process_fs_and_t(fs, t, N)
    if nv is None and isinstance(scales, str):
        nv = 32

    wavelet = Wavelet.build(wavelet, l1_norm=True)
    if not wavelet.psih_is_real:
        _unported("a complex-valued psih",
                  "Queue 1 item 3, the complex half-band route")
    scales, cwt_scaletype, *_ = process_scales(scales, N, wavelet, nv=nv,
                                               get_params=True)
    if padtype is not None:
        xp, _, n1, _ = padsignal(x, padtype, get_params=True)
    elif best_split(N) is not None:
        xp, n1 = x, 0
    else:
        _unported("padtype=None with N not a power of 2",
                  "Queue 1 item 3, the full-length route")
    gamma = float(gamma if gamma is not None else 10 * EPS32)

    wxr, wxi, w = cwt_core(xp, np.asarray(scales).squeeze(-1), dt,
                           wavelet=wavelet, N=N, n1=n1, gamma=gamma)
    if ssq_freqs is None:
        ssq_freqs = cwt_scaletype
    Wx = torch.complex(wxr, wxi)
    Tx, ssq_freqs = ssqueeze(Wx, None, ssq_freqs, scales, fs=fs,
                             maprange=maprange, wavelet=wavelet, gamma=gamma,
                             was_padded=padtype is not None, flipud=flipud,
                             wx_planes=(wxr, wxi), w_plane=w)
    return Tx, Wx, ssq_freqs, np.asarray(scales).squeeze()


# -- inverse ----------------------------------------------------------------
def _process_component_inversion_args(cc, cw):
    if cc is None and cw is None:
        return None, None, True
    cc = torch.as_tensor(np.asarray(cc), dtype=torch.int64)
    cw = torch.as_tensor(np.asarray(cw), dtype=torch.int64)
    if cc.ndim == 1:
        cc = cc[:, None]
    if cw.ndim == 1:
        cw = cw[:, None]
    return cc, cw, False


def _invert_components(Tx, cc, cw):
    """Sum Re Tx over the band [cc - cw, cc + cw] of each of the K curves
    (cc, cw: (n_times, K); cc = -1 where a curve is absent); the last
    output row is the residual, the rows no curve claims. Tx may have
    leading batch dims: output (..., K + 1, n_times)."""
    n_freqs = Tx.shape[-2]
    cc = cc.to(Tx.device).T                       # (K, n_times)
    cw = cw.to(Tx.device).T
    rows = torch.arange(n_freqs, device=Tx.device)[None, :, None]

    upper = torch.clamp(cc + cw, 0, n_freqs)
    lower = torch.clamp(cc - cw, 0, n_freqs)
    no_curve = cc == -1
    upper = torch.where(no_curve, torch.zeros_like(upper), upper)
    lower = torch.where(no_curve, torch.ones_like(lower), lower)
    # (K, n_freqs, n_times) band masks
    mask = (rows >= lower[:, None, :]) & (rows <= upper[:, None, :])

    Txr = Tx.real
    comps = torch.einsum("...fn,kfn->...kn", Txr, mask.to(Txr.dtype))
    remainder = ~mask.any(dim=0)
    resid = (Txr * remainder.to(Txr.dtype)).sum(dim=-2)
    return torch.cat([comps, resid[..., None, :]], dim=-2)


def issq_cwt(Tx, wavelet="gmw", cc=None, cw=None):
    """Inverse synchrosqueezed CWT. Full inversion:
    x = (2/Css) * sum over frequency rows of Re Tx; with `cc`/`cw`, one
    row per curve band plus the residual (`_invert_components`)."""
    cc, cw, full_inverse = _process_component_inversion_args(cc, cw)
    Tx = torch.as_tensor(Tx)
    x = Tx.real.sum(dim=-2) if full_inverse else _invert_components(Tx, cc,
                                                                    cw)
    Css = adm_ssq(Wavelet.build(wavelet))
    return x * (2 / Css)
