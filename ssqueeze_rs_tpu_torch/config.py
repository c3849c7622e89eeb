"""Library defaults, numeric constants and the dtype helpers.

Counterpart of ``ssqueeze_rs_tpu/config.py``: the defaults the wavelets
and the scale planner read, in three tiers: the values below, an ini file
loaded at import (the file named by ``SSQ_TPU_CONFIG``, else the shipped
``configs.ini``; `load_config_ini` loads another), and per-call keyword
arguments, which always win (`gdefaults` fills the ones left None). Also
`use_x64`, `default_dtype`, `complex_dtype` and `gamma_default` with the
JAX signatures, returning torch dtypes.
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


def _parse_ini_value(v: str):
    if v in ("True", "true"):
        return True
    if v in ("False", "false"):
        return False
    try:
        return float(v) if "." in v or "e" in v.lower() else int(v)
    except ValueError:
        return v.strip("'\"")


def _parse_reference_ini(text: str) -> dict:
    """Parse ssqueezepy's sectionless configs.ini dialect: '# name'
    comment lines open an object section, 'key=value' lines fill it,
    '## module' lines and everything past '#### END' are ignored.
    Returns {section: {k: v}}."""
    out, cur = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("####"):
            break
        if line.startswith("##") or not line:
            continue
        if line.startswith("#"):
            cur = line.lstrip("# ").strip()
            continue
        if "=" in line and cur is not None:
            k, _, v = line.partition("=")
            out.setdefault(cur, {})[k.strip()] = _parse_ini_value(v.strip())
    return out


def load_config_ini(path) -> dict:
    """Load defaults overrides from an ini file into `DEFAULTS`.

    Two dialects are accepted:
      * the shipped format (``configs.ini``): sections are DEFAULTS keys
        ('morlet', 'gmw', 'make_scales', ...); a [global] section may set
        'dtype';
      * ssqueezepy's configs.ini ('# name' comment headers, flat
        key=value); per-object 'dtype' keys land in that object's section.

    A missing file raises. Returns the updated DEFAULTS.
    """
    import configparser

    path = os.path.expanduser(str(path))
    cp = configparser.ConfigParser()
    try:
        found = cp.read(path)
        sections = {s: dict(cp.items(s)) for s in cp.sections()}
    except configparser.MissingSectionHeaderError:
        with open(path) as f:
            found, sections = True, _parse_reference_ini(f.read())
    if not found:
        # configparser.read() skips unreadable paths without a word
        raise FileNotFoundError(f"config ini not found: {path}")
    for section, items in sections.items():
        if section == "global":
            if "dtype" in items:
                DEFAULTS["dtype"] = str(items["dtype"])
            continue
        tgt = DEFAULTS.setdefault(section, {})
        for k, v in items.items():
            tgt[k] = _parse_ini_value(v) if isinstance(v, str) else v
    return DEFAULTS


def _autoload_ini():
    """Load the file named by ``SSQ_TPU_CONFIG`` if set (a missing file
    raises), else the shipped ``configs.ini``."""
    env = os.environ.get("SSQ_TPU_CONFIG")
    if env:
        return load_config_ini(env)
    shipped = os.path.join(os.path.dirname(__file__), "configs.ini")
    if os.path.exists(shipped):
        return load_config_ini(shipped)
    return DEFAULTS


_autoload_ini()


def gdefaults(module_and_obj=None, get_all=False, as_dict=None,
              default_order=False, **kw):
    """Fill None-valued kwargs from DEFAULTS.

    The last dotted component of `module_and_obj` selects the section
    (e.g. 'wavelets.gmw' or 'gmw'). With `get_all=True` every default of
    the section is included (explicit kwargs kept). `default_order` orders
    the result by the section's keys, kwargs it lacks last. Returns a dict
    when `as_dict` (default for get_all), else the filled values (a
    tuple, or the value when there is one).
    """
    if as_dict is None:
        as_dict = bool(get_all)
    section = {}
    if module_and_obj is not None:
        section = DEFAULTS.get(str(module_and_obj).split(".")[-1], {})
        if not isinstance(section, dict) or not section:
            # missing, or a scalar DEFAULTS entry like 'dtype'
            if not isinstance(section, dict):
                section = {}
            from .utils.common import WARN
            WARN(f"'{module_and_obj}' not found in DEFAULTS "
                 "(see config.DEFAULTS / load_config_ini)")
    out = dict(kw)
    for k, v in section.items():
        if get_all:
            if out.get(k) is None:
                out[k] = v
        elif k in out and out[k] is None:
            out[k] = v
    if default_order and section:
        out = {**{k: out[k] for k in section if k in out},
               **{k: v for k, v in out.items() if k not in section}}
    if as_dict:
        return out
    vals = tuple(out.values())
    return vals[0] if len(vals) == 1 else vals


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
