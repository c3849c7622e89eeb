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
from ..utils.pad import padsignal
from ..wavelets.adm import adm_ssq
from ..wavelets.base import Wavelet
from .cwt import cwt_core
from .fft_cuda import best_split
from .ssqueeze import ssqueeze, check_ssqueezing_args

__all__ = ["ssq_cwt", "issq_cwt"]


def _unported(what, item):
    raise NotImplementedError(f"{what} is not ported to the torch package "
                              f"yet (ROADMAP {item})")


def _check_slice(dtype, order, get_w, get_dWx, difftype, squeezing):
    if str(dtype or DEFAULTS["dtype"]) != "float32":
        _unported(f"dtype={dtype!r}", "Queue 1 item 3, float64 route")
    if isinstance(order, (tuple, list, range)) or order != 0:
        _unported(f"order={order!r}", "Queue 1 item 6, cwt_higher_order")
    if get_w or get_dWx:
        _unported("get_w / get_dWx", "Queue 1 item 3, phase.py and diff.py")
    if difftype in ("phase", "numeric"):
        _unported(f"difftype={difftype!r}",
                  "Queue 1 item 3, phase.py and diff.py")
    if callable(squeezing) or squeezing in ("lebesgue", "abs"):
        _unported(f"squeezing={squeezing!r}",
                  "Queue 1 item 3 and Queue 2 B, the 4-plane contract")


def _as_signal(x, device):
    """x as a float32 tensor on `device` (default: x's own device, or the
    CPU for array input), with non-finite samples zeroed."""
    if isinstance(x, torch.Tensor):
        device = torch.device(device) if device is not None else x.device
    else:
        x = torch.as_tensor(np.asarray(x))
        device = torch.device(device if device is not None else "cpu")
    if x.requires_grad and device.type == "cuda":
        _unported("requires_grad input on CUDA",
                  "Queue 1 item 5 and Queue 2 C, the backward kernel")
    x = torch.nan_to_num(x.to(device), nan=0.0, posinf=0.0, neginf=0.0)
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
    Tx, ssq_freqs = ssqueeze((wxr, wxi), w, ssq_freqs, scales, fs=fs,
                             maprange=maprange, wavelet=wavelet,
                             was_padded=padtype is not None, flipud=flipud)
    return Tx, torch.complex(wxr, wxi), ssq_freqs, np.asarray(scales).squeeze()


def issq_cwt(Tx, wavelet="gmw", cc=None, cw=None):
    """Inverse synchrosqueezed CWT, full inversion:
    x = (2/Css) * sum over frequency rows of Re Tx."""
    if cc is not None or cw is not None:
        _unported("component inversion (cc/cw)", "Queue 1 item 3")
    Tx = torch.as_tensor(Tx)
    Css = adm_ssq(Wavelet.build(wavelet))
    return Tx.real.sum(dim=-2) * (2 / Css)
