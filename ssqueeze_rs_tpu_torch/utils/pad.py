"""Signal padding (counterpart of ``ssqueeze_rs_tpu/utils/pad.py``).

`p2up(n)` pads to the power of 2 nearest in log2 (not next-higher):
up = 2**(1 + round(log2(n))), and the left pad gets the extra sample.

The pad itself is one gather along the last axis, with the source index
of every output sample computed on x's device (torch has no 'symmetric'
mode, and its 'reflect' wants a channel dim), so the four index modes
share one code path on any number of leading dims and nothing is copied
from the host. The index rules are numpy's `np.pad` modes, for any pad
length. The gather's adjoint (`_PadFn`) adds the cotangent back run by
run: the padded signal is a few runs of consecutive source samples
(forward, backward or repeated), so the adjoint is a few slice adds in a
fixed order, deterministic on any device (autograd's own adjoint of the
gather accumulates through `index_put_`).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .common import assert_is_one_of

PAD_MODES = {
    "reflect": "reflect",
    "symmetric": "symmetric",
    "replicate": "edge",
    "wrap": "wrap",
    "zero": "constant",
}


def next_power_of_2(n: int) -> int:
    """Smallest power of 2 >= n."""
    return 1 if n <= 1 else 2 ** int(np.ceil(np.log2(n)))


def _reflect_indices(start: int, stop: int, N: int) -> np.ndarray:
    """Source sample of each index in [start, stop) of a length-N signal
    extended by reflection (edge sample not repeated), reflecting as often
    as a span wider than the signal needs: np.pad(mode='reflect') and
    `padsignal`'s rule. Host numpy, for reading halo chunks."""
    idx = np.arange(start, stop)
    if N == 1:
        return np.zeros_like(idx)
    period = 2 * (N - 1)
    idx = np.abs(idx) % period
    return np.where(idx >= N, period - idx, idx)


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


@lru_cache(maxsize=64)
def _runs(padtype, N, n1, n2):
    """The padded signal as maximal runs of source samples with one step
    (+1, -1 or 0): tuples (first output index, end, first source index,
    step), in output order."""
    idx = _source_index(padtype, N, n1, n2, "cpu").numpy()
    d = np.diff(idx)
    runs, p, M = [], 0, len(idx)
    while p < M:
        step = int(d[p]) if p + 1 < M else 1
        if abs(step) > 1:               # a jump ('wrap'): a run of one
            step, end = 1, p + 1
        else:
            off = np.flatnonzero(d[p:] != step)
            end = p + 1 + (int(off[0]) if len(off) else M - 1 - p)
        runs.append((p, end, int(idx[p]), step))
        p = end
    return tuple(runs)


def pad_adjoint(g, padtype, N, n1, n2):
    """Adjoint of the index pad: gx[s] = sum of g over the padded samples
    whose source is s, added run by run in output order."""
    gx = torch.zeros(g.shape[:-1] + (N,), dtype=g.dtype, device=g.device)
    for p, end, s, step in _runs(padtype, N, n1, n2):
        seg = g[..., p:end]
        if step == 1:
            gx[..., s:s + end - p] += seg
        elif step == -1:
            gx[..., s - (end - p) + 1:s + 1] += seg.flip(-1)
        else:
            gx[..., s] += seg.sum(-1)
    return gx


class _PadFn(torch.autograd.Function):
    """The index pad (a gather) with the deterministic `pad_adjoint`."""

    @staticmethod
    def forward(ctx, x, padtype, n1, n2):
        N = x.shape[-1]
        ctx.args = (padtype, N, n1, n2)
        return x[..., _source_index(padtype, N, n1, n2, x.device)]

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return pad_adjoint(g, *ctx.args), None, None, None


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


def padsignal(x, padtype: str = "reflect",
              padlength: int | None = None, get_params: bool = False):
    """Pad `x` (time = last axis) to `padlength` (default: p2up), centered."""
    assert_is_one_of(padtype, "padtype", tuple(PAD_MODES))
    N = x.shape[-1]
    n_up, n1, n2 = pad_params(N, padlength)
    if padtype == "zero":
        xp = torch.nn.functional.pad(x, (n1, n2))
    else:
        xp = _PadFn.apply(x, padtype, n1, n2)
    return (xp, n_up, n1, n2) if get_params else xp
