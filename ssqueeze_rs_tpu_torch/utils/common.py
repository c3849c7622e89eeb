"""Small shared host helpers (counterpart of ``ssqueeze_rs_tpu/utils/common.py``)."""
from __future__ import annotations

import logging

import numpy as np
import torch

_logger = logging.getLogger("ssqueeze_rs_tpu_torch")
if not _logger.handlers:        # never touch the host app's root logger
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(message)s"))
    _logger.addHandler(_h)
    _logger.propagate = False


def WARN(msg: str):
    _logger.warning("WARNING: %s", msg)


def NOTE(msg: str):
    _logger.warning("NOTE: %s", msg)


def assert_is_one_of(x, name, supported, e=ValueError):
    if x not in supported:
        raise e(f"`{name}` must be one of: {', '.join(map(str, supported))} (got {x})")


def array_device(device=None) -> torch.device:
    """The device array input runs on: `device` if given, else the CUDA
    device; with no CUDA device and no `device`, raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "array input runs on the CUDA device by default and none is "
            "available: pass device='cpu' (or a CPU tensor) to run on "
            "the CPU")
    return torch.device("cuda")


def as_signal(x, device=None):
    """x as a tensor on `device`. By default a tensor stays on its own
    device (a CPU tensor is the caller asking for the CPU) and array input
    goes to the CUDA device (`array_device`). A tensor stays in its
    autograd graph."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(torch.device(device))
    a = np.asarray(x)
    x = torch.as_tensor(a if a.flags.writeable else a.copy())
    return x.to(array_device(device))


def _host(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def mad(data, axis=None):
    """Mean absolute deviation (host numpy; tensors are copied to the
    host)."""
    data = _host(data)
    return np.mean(np.abs(data - np.mean(data, axis)), axis)


def mad_rms(x, xrec):
    """Reconstruction error metric of the inversion checks:
    mean|x - xrec| / rms(x) (host numpy; tensors are copied to the host)."""
    x, xrec = _host(x), _host(xrec)
    return float(np.mean(np.abs(x - xrec)) / np.sqrt(np.mean(x**2)))


def warn_hbm_budget(N, na, batch=1, derivative=False, what="cwt"):
    """A warning before an opaque device out-of-memory error: the working
    set of a single-shot CWT is ~20 arrays of (na, padded_len) float32
    per channel. Reads the CUDA device's memory; silent on the CPU."""
    from .pad import p2up
    if not torch.cuda.is_available():
        return
    est = (20 * int(na) * p2up(int(N))[0] * 4 * int(batch) *
           (2 if derivative else 1))
    total = torch.cuda.get_device_properties(
        torch.cuda.current_device()).total_memory
    if est > 0.9 * total:
        WARN(f"single-shot {what} needs ~{est / 1e9:.0f} GB of device "
             f"memory at N={N}, na={na}, batch={batch} (the device has "
             f"{total / 1e9:.0f} GB); consider parallel.process_recording")


def est_riskshrink_thresh(Wx, nv):
    """RiskShrink hard-threshold estimate from the first `nv` rows of Wx:
    1.4826 * sqrt(2 ln N) * mad(|Wx[..., :nv, :]|). A tensor is reduced on
    its device (a 0-d tensor back), an array on the host."""
    if isinstance(Wx, torch.Tensor):
        fine = Wx[..., :nv, :].abs()
        m = (fine - fine.mean()).abs().mean()
        return 1.4826 * np.sqrt(2 * np.log(Wx.shape[-1])) * m
    Wx = np.asarray(Wx)
    N = Wx.shape[-1]
    Wx_fine = np.abs(Wx[..., :nv, :])
    return 1.4826 * np.sqrt(2 * np.log(N)) * mad(Wx_fine)


# -- replacers: `where` on the input's own array module, no in-place write
def _where(cond, replacement, x):
    if isinstance(x, torch.Tensor):
        return torch.where(cond, torch.as_tensor(replacement, dtype=x.dtype,
                                                 device=x.device), x)
    return np.where(cond, replacement, x)


def _ref(x, ref):
    ref = x if ref is None else ref
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(ref, device=x.device)
    return np.asarray(ref)


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else np


def replace_at_inf_or_nan(x, ref=None, replacement=0.):
    """x[isinf(ref) | isnan(ref)] = replacement (ref defaults to x)."""
    ref, xp = _ref(x, ref), _xp(x)
    return _where(xp.isinf(ref) | xp.isnan(ref), replacement, x)


def replace_at_inf(x, ref=None, replacement=0.):
    ref, xp = _ref(x, ref), _xp(x)
    return _where(xp.isinf(ref), replacement, x)


def replace_at_nan(x, ref=None, replacement=0.):
    ref, xp = _ref(x, ref), _xp(x)
    return _where(xp.isnan(ref), replacement, x)


def replace_at_value(x, ref=None, value=0., replacement=0.):
    """Note: `value=np.nan` won't match (use `replace_at_nan`)."""
    return _where(_ref(x, ref) == value, replacement, x)


def replace_under_abs(x, ref=None, value=0., replacement=0., parallel=None):
    """x[|ref| < value] = replacement; `parallel` is accepted and ignored."""
    return _where(abs(_ref(x, ref)) < value, replacement, x)


def find_closest_parallel_is_faster(shape, dtype="float32", trials=7,
                                    verbose=1):
    """Times `find_closest` on a random (shape) array for information and
    returns False: there is one host implementation, no parallel toggle
    to choose."""
    from timeit import timeit

    from .closest import find_closest

    a = np.abs(np.random.randn(*shape).astype(dtype))
    v = np.random.uniform(0, len(a), len(a)).astype(dtype)
    t = timeit(lambda: find_closest(a, v), number=int(trials))
    if verbose:
        NOTE(f"find_closest: {t / trials:.3g} s/call on {shape} {dtype}; "
             "no parallel toggle exists, returning False")
    return False
