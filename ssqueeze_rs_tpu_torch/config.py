"""Library defaults and numeric constants.

Counterpart of ``ssqueeze_rs_tpu/config.py``: only the defaults the
wavelets and the scale planner read. The ``configs.ini`` loader is not
ported (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

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
