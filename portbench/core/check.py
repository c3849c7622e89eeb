"""The comparison that decides `correct`: each kept output of the window
against the reference's, channel by channel or request by request. The
system of the configuration's transform (`systems/<transform>.py`) says
which numbers it compares (`compare(out, expected, ref, device)`, built
from the helpers here); each number is the worst over the items, and the
configuration's `limits` holds a limit for each: a number with no limit,
or a limit with no number, fails. An output of the wrong shape, a missing
one, or a NaN reads as infinite."""
from __future__ import annotations

import math

import numpy as np
import torch

from reference.transforms import reflect_pad


def _t(a, device):
    return (a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(a))).to(device)


def rel_max(a, r, device):
    """max |a - r| / max |r| (r a tensor on `device`)."""
    a = _t(a, device)
    if tuple(a.shape) != tuple(r.shape):
        return math.inf
    return float((a.to(r.dtype) - r).abs().max() / r.abs().max())


def rel_l1(a, r, device):
    """sum |a - r| / sum |r|: an entry on a bin's edge that rounding
    alone may move to the next bin counts by its weight."""
    a = _t(a, device)
    if tuple(a.shape) != tuple(r.shape):
        return math.inf
    return float((a.to(r.dtype) - r).abs().sum() / r.abs().sum())


def host_rel(out, host):
    """The worst max |a - r| / max |r| over the reference's planning
    outputs `host` ({name: numpy array}) against the same names in out."""
    worst = 0.0
    for k, r in host.items():
        a, r = np.asarray(out[k], np.float64), np.asarray(r)
        worst = max(worst, math.inf if a.shape != r.shape else
                    float(np.abs(a - r).max() / np.abs(r).max()))
    return worst


class Check:
    """References by signal length (one per batch length or bucket), and
    the comparison of items against them on `device`."""

    def __init__(self, system, cfg, device):
        self.system, self.cfg, self.device = system, cfg, device
        self.refs = {}

    def reference(self, n, served=False):
        key = (n, served)
        if key not in self.refs:
            self.refs[key] = self.system.Reference(self.cfg, n, served)
        return self.refs[key]

    def expected(self, item, precision="float64"):
        """The reference's outputs for one item (the control's with
        precision='bfloat16'), and the reference itself."""
        ref = self.reference(item["n"], item.get("served", False))
        x = item["x"].to(self.device)
        if x.shape[-1] < item["n"]:
            x = reflect_pad(x, 0, item["n"] - x.shape[-1])
        return ref(x, precision, item["cols"]), ref

    def numbers(self, items):
        """{number: worst value over the items}; every number of the
        configuration's limits infinite for a missing item."""
        worst = {}

        def put(k, v):
            worst[k] = max(worst.get(k, 0.0), v if v == v else math.inf)

        for item in items:
            if "missing" in item:
                for k in self.cfg["limits"]:
                    put(k, math.inf)
                continue
            exp, ref = self.expected(item)
            for k, v in self.system.compare(item["out"], exp, ref,
                                            self.device).items():
                put(k, v)
            del exp
        return worst


def verdict(numbers, limits):
    """(correct, {number: {"value", "limit"}}): correct where every number
    has a limit and every limit a number, each number at most its limit."""
    table = {k: {"value": numbers.get(k, math.inf),
                 "limit": float(limits.get(k, -math.inf))}
             for k in sorted(set(limits) | set(numbers))}
    return all(v["value"] <= v["limit"] for v in table.values()), table
