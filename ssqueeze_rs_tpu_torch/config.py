"""Library defaults, numeric constants and the dtype helpers.

Counterpart of ``ssqueeze_rs_tpu/config.py``: the defaults the wavelets
and the scale planner read, and `use_x64`, `default_dtype`,
`complex_dtype` and `gamma_default` with the JAX signatures, returning
torch dtypes. The ``configs.ini`` loader is not ported (ROADMAP Queue 1
item 9).
"""
from __future__ import annotations

import os

import numpy as np

pi = np.pi
EPS32 = float(np.finfo(np.float32).eps)
EPS64 = float(np.finfo(np.float64).eps)

DEFAULTS = {
    "morlet": {"mu": 13.4},
    "bump": {"mu": 5.0, "s": 1.0, "om": 0.0},
    "cmhat": {"mu": 1.0, "s": 1.0},
    "hhhat": {"mu": 5.0},
    "gmw": {"gamma": 3.0, "beta": 60.0, "norm": "bandpass", "order": 0},
    "make_scales": {"downsample": 4},
    "dtype": "float32",
}


def _is_double(dtype) -> bool:
    """Whether `dtype` (torch, numpy or a name) is float64 or complex128."""
    return str(dtype).split(".")[-1] in ("float64", "complex128", "double",
                                         "cdouble")


def real_dtype(dtype):
    """'float32' or 'float64' from a transform's `dtype` argument (a name,
    a numpy or torch dtype; None: `DEFAULTS["dtype"]`); anything else
    raises."""
    dtype = dtype or DEFAULTS["dtype"]
    try:
        name = (str(dtype).split(".")[-1] if str(dtype).startswith("torch.")
                else str(np.dtype(dtype)))
    except TypeError:
        name = str(dtype)
    if name not in ("float32", "float64"):
        raise ValueError(f"`dtype` must be float32 or float64 (got {dtype})")
    return name


def use_x64() -> bool:
    """Whether float64 paths are requested (env flag ``SSQ_TPU_X64=1``)."""
    return os.environ.get("SSQ_TPU_X64", "0") == "1"


def default_dtype():
    """torch.float64 under `use_x64()`, else torch.float32."""
    import torch

    return torch.float64 if use_x64() else torch.float32


def complex_dtype(real_dtype):
    """torch.complex128 for float64, torch.complex64 for float32."""
    import torch

    return torch.complex128 if _is_double(real_dtype) else torch.complex64


def gamma_default(cdtype) -> float:
    """Default phase-transform threshold: 10 * eps of the real dtype of a
    complex dtype (EPS64 for complex128, else EPS32)."""
    return 10 * (EPS64 if str(cdtype).split(".")[-1] in
                 ("complex128", "cdouble") else EPS32)
