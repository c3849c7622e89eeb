"""Small shared host helpers (counterpart of ``ssqueeze_rs_tpu/utils/common.py``)."""
from __future__ import annotations

import logging

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
