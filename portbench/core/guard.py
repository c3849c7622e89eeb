"""The run's own check that neither JAX nor the JAX package was loaded:
top-level module names (the part before the first dot) compared whole,
so the port, `ssqueeze_rs_tpu_torch`, passes and `ssqueeze_rs_tpu` does
not."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ssqueeze_rs_tpu"})


def forbidden(modules=None):
    """Sorted top-level names of `modules` (sys.modules by default) that
    are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
