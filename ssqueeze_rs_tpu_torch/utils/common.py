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


def unported(what, item):
    """Refuse an option the port does not have yet, naming the ROADMAP
    item that ports it."""
    raise NotImplementedError(f"{what} is not ported to the torch package "
                              f"yet (ROADMAP {item})")


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
