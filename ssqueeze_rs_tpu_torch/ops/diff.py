"""Trigonometric (frequency-domain) differentiation of TF arrays
(counterpart of ``ssqueeze_rs_tpu/ops/diff.py``), used by higher-order
synchrosqueezing. Plain torch FFTs on the array's device."""
from __future__ import annotations

import numpy as np
import torch

from ..utils.common import as_signal
from ..utils.fft import xifn
from ..utils.pad import padsignal, p2up

__all__ = ["trigdiff"]


def trigdiff(A, fs=1.0, padtype=None, rpadded=None, N=None, n1=None,
             transform="cwt", device=None):
    """Differentiate rows of `A` along time via ifft(fft(A) * i*xi * fs),
    on A's device (`utils.common.as_signal`: array input goes to the CUDA
    device unless `device` says otherwise).

    If `rpadded`, `A` is already padded and will be trimmed to
    `[..., n1:n1+N]`; else `A` is reflect-padded first.
    """
    if transform == "stft":
        raise NotImplementedError("`transform='stft'` is currently not "
                                  "supported.")
    if rpadded and N is None:
        raise ValueError("must pass `N` if `rpadded`")
    rpadded = rpadded or False
    padtype = padtype or ("reflect" if not rpadded else None)

    A = as_signal(A, device)
    if padtype is not None:
        A, _, n1, _ = padsignal(A, padtype, get_params=True)

    rdtype = np.float64 if A.dtype in (torch.float64, torch.complex128) \
        else np.float32
    xi = torch.as_tensor(xifn(1, A.shape[-1], dtype=rdtype), device=A.device)
    A_diff = torch.fft.ifft(torch.fft.fft(A, dim=-1) * 1j * xi * fs, dim=-1)

    if rpadded or padtype is not None:
        if N is None:
            N = A.shape[-1]
        if n1 is None:
            _, n1, _ = p2up(N)
        A_diff = A_diff[..., n1:n1 + N]
    return A_diff
