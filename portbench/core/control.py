"""The control of the comparison: the reference in bfloat16 (the nearest
precision below the configurations' float32) put in the program's place,
on the items a run of the cell at that seed checks, at the cell's own
sizes. Its numbers must fail the limits; they set the upper readings the
limits were placed under."""
from __future__ import annotations

import numpy as np
import torch

from . import check


def _bf16(a):
    return np.asarray(torch.as_tensor(np.array(a, np.float64))
                      .to(torch.bfloat16).to(torch.float64))


def readings(bench, cfg, traffic, seed, device):
    """The comparison's numbers with the control's outputs (bfloat16
    planes, and its planning outputs rounded to bfloat16) in the program's
    place."""
    system = bench.module("systems", cfg["transform"])
    loop = bench.module("loops", traffic["loop"])
    chk = check.Check(system, cfg, device)
    its = loop.check_inputs(system, cfg, traffic, seed, device)
    for it in its:
        exp, ref = chk.expected(it, "bfloat16")
        it["out"] = dict(exp, **{k: _bf16(v) for k, v in ref.host().items()})
    return chk.numbers(its)
