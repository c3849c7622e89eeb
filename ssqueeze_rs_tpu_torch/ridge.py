"""Ridge extraction: forward-backward dynamic programming on the
time-frequency plane (counterpart of ``ssqueeze_rs_tpu/ridge.py``).

Per ridge: a forward min-plus recursion over time with the
`penalty * (s_i - s_j)^2` matrix (log scales for transform 'cwt'), then a
backtrack that re-picks at each column the last row consistent with the
next column's choice; `n_ridges` rounds, each zeroing +-bw rows around
the ridge found. In plain torch on Tf's device: a Python loop over the
columns, each step a few launches into preallocated buffers, with no host
sync inside the loop (the running ridge row is a 0-d device tensor).
"""
from __future__ import annotations

import numpy as np
import torch

from .config import EPS32, EPS64
from .utils.common import as_signal

__all__ = ["extract_ridges"]


def _one_ridge(energy, pen_mat, eps):
    """Ridge rows (n_t,) int64 of one round, on energy's device."""
    na, n_t = energy.shape
    # the JAX package's order of operations: the backtrack compares
    # recomputed sums against eps
    e = (-torch.log(energy / energy.amax(dim=0) + eps)).T.contiguous()
    dtype = torch.promote_types(e.dtype, pen_mat.dtype)
    pen_e = torch.empty((n_t, na), dtype=dtype, device=e.device)
    pen_e[0] = e[0]
    tmp = torch.empty((na, na), dtype=dtype, device=e.device)
    m = torch.empty(na, dtype=dtype, device=e.device)
    for t in range(1, n_t):
        torch.add(pen_e[t - 1][None, :], pen_mat, out=tmp)
        torch.amin(tmp, dim=1, out=m)
        torch.add(e[t], m, out=pen_e[t])
    ridge_fw = pen_e.argmin(dim=1)

    # backtrack from t = n_t - 2 down to 0: the LAST row i with
    # |(pen_e[t+1, r] - e[t+1, r]) - (pen_e[t, i] + pen_mat[r, i])| < eps,
    # r the row at t + 1; the forward argmin where none is
    val = pen_e[1:] - e[1:]                           # (n_t - 1, na)
    rows = torch.arange(na, device=e.device)
    none = torch.full((), -1, dtype=rows.dtype, device=e.device)
    ridge = torch.empty(n_t, dtype=torch.int64, device=e.device)
    ridge[-1] = ridge_fw[-1]
    r = ridge_fw[-1]
    for t in range(n_t - 2, -1, -1):
        cond = (val[t, r] - (pen_e[t] + pen_mat[r])).abs() < eps
        last = torch.where(cond, rows, none).amax()
        r = torch.where(last >= 0, last, ridge_fw[t])
        ridge[t] = r
    return ridge


def _zero_band(energy, ridge, bw):
    """energy with rows [ridge - bw, ridge + bw) of each column zeroed
    (clamped at row 0)."""
    rows = torch.arange(energy.shape[0], device=energy.device)[:, None]
    mask = (rows >= ridge[None, :] - bw) & (rows < ridge[None, :] + bw)
    return torch.where(mask, torch.zeros((), dtype=energy.dtype,
                                         device=energy.device), energy)


def extract_ridges(Tf, scales, penalty=2.0, n_ridges=1, bw=15,
                   transform="cwt", get_params=False, parallel=True,
                   device=None):
    """Track `n_ridges` maximum-energy ridges of Tf (na, n_t) on its device
    (`utils.common.as_signal`: array input goes to the CUDA device unless
    `device` says otherwise). `scales`: the (na,) row scales or
    frequencies (log-spaced penalty for transform 'cwt'). `parallel` is
    accepted and ignored.

    Returns ridge_idxs (n_t, n_ridges) int numpy; with `get_params`, also
    (ridge_f, ridge_e), float64 numpy: the scale and |Tf|^2 of each ridge
    entry, ridge i's energies read after ridges 0..i-1 zeroed their bands.
    Only these (n_t, n_ridges) arrays leave the device.

    The +-bw zeroing clamps at row 0, as in the JAX package: rows
    0..ridx+bw-1 are zeroed near the bottom edge.
    """
    Tf = as_signal(Tf, device)
    dtype = torch.float64 if Tf.dtype == torch.complex128 else torch.float32
    eps = EPS64 if Tf.dtype == torch.complex128 else EPS32
    scales_arr = np.asarray(scales, dtype=np.float64).squeeze()

    s = torch.as_tensor(np.ascontiguousarray(scales_arr),
                        device=Tf.device).to(dtype)
    if transform == "cwt":
        s = torch.log(s)
    pen_mat = (torch.tensor(float(penalty), device=Tf.device).to(dtype) *
               (s[:, None] - s[None, :]) ** 2)

    energy0 = energy = Tf.abs() ** 2
    ridges = []
    for _ in range(int(n_ridges)):
        ridge = _one_ridge(energy, pen_mat, eps)
        ridges.append(ridge)
        energy = _zero_band(energy, ridge, int(bw))
    ridge_t = torch.stack(ridges, dim=1)
    ridge_idxs = ridge_t.cpu().numpy().astype(int)
    if not get_params:
        return ridge_idxs

    # ridge i's energy is read from |Tf|^2 as zeroed by ridges 0..i-1
    cols = torch.arange(ridge_t.shape[0], device=Tf.device)
    energy, ridge_e = energy0, []
    for i in range(ridge_t.shape[1]):
        ridge_e.append(energy[ridge_t[:, i], cols])
        energy = _zero_band(energy, ridge_t[:, i], int(bw))
    ridge_e = torch.stack(ridge_e, dim=1).cpu().numpy().astype(np.float64)
    ridge_f = scales_arr[ridge_idxs]
    return ridge_idxs, ridge_f, ridge_e
