"""Signal padding (counterpart of ``ssqueeze_rs_tpu/utils/pad.py``).

`p2up(n)` pads to the power of 2 nearest in log2 (not next-higher):
up = 2**(1 + round(log2(n))), and the left pad gets the extra sample.

The pad itself is one gather along the last axis, with the source index
of every output sample computed on x's device (torch has no 'symmetric'
mode, and its 'reflect' wants a channel dim), so all five modes share one
code path on any number of leading dims and nothing is copied from the
host. The index rules are numpy's `np.pad` modes, for any pad length.
"""
from __future__ import annotations

import numpy as np
import torch

from .common import assert_is_one_of

PAD_MODES = {
    "reflect": "reflect",
    "symmetric": "symmetric",
    "replicate": "edge",
    "wrap": "wrap",
    "zero": "constant",
}


def _source_index(padtype, N, n1, n2, device):
    """Index into x[..., :N] of each padded sample (np.pad semantics)."""
    i = torch.arange(-n1, N + n2, device=device)
    if padtype == "reflect":            # edge sample not repeated
        period = max(2 * N - 2, 1)
        m = torch.remainder(i, period)
        return torch.where(m < N, m, period - m)
    if padtype == "symmetric":          # edge sample repeated
        m = torch.remainder(i, 2 * N)
        return torch.where(m < N, m, 2 * N - 1 - m)
    if padtype == "replicate":
        return torch.clamp(i, 0, N - 1)
    return torch.remainder(i, N)        # wrap


def p2up(n: int):
    """(up, n1, n2): power-of-2 target and left/right pad lengths."""
    up = int(2 ** (1 + np.round(np.log2(n))))
    n2 = (up - n) // 2
    n1 = up - n - n2
    return up, n1, n2


def pad_params(N: int, padlength: int | None = None):
    """(n_up, n1, n2) for `padsignal` semantics."""
    if padlength is None:
        return p2up(N)
    n_up = int(padlength)
    if abs(n_up - N) % 2 == 0:
        n1 = n2 = (n_up - N) // 2
    else:
        n2 = (n_up - N) // 2
        n1 = n2 + 1
    return n_up, n1, n2


def padsignal(x: torch.Tensor, padtype: str = "reflect",
              padlength: int | None = None, get_params: bool = False):
    """Pad `x` (time = last axis) to `padlength` (default: p2up), centered."""
    assert_is_one_of(padtype, "padtype", tuple(PAD_MODES))
    N = x.shape[-1]
    n_up, n1, n2 = pad_params(N, padlength)
    if padtype == "zero":
        xp = torch.nn.functional.pad(x, (n1, n2))
    else:
        xp = x[..., _source_index(padtype, N, n1, n2, x.device)]
    return (xp, n_up, n1, n2) if get_params else xp
