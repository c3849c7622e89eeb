"""Traffic loop "batch": back-to-back calls, one caller, on a (batch,
length) float32 array made on the device, a new signal each call. Each
call's latency runs from its start until its outputs are complete on the
device (a CUDA event waited on), its enqueue time until the call returns.

The window keeps, for the check, the last call whole and a block of
`check_cols` columns of `check_calls` calls drawn from the seed among the
first `check_from`."""
from __future__ import annotations

import time

import torch

from core import signals
from core.trace import Span
from core.window import Window, draw, peak, reset_peak, sync


def picks(traffic, seed):
    """The calls whose column blocks a window keeps: [(call, cols)]."""
    w = int(traffic["check_cols"])
    calls = draw(seed, 1, int(traffic["check_calls"]),
                 int(traffic["check_from"]))
    c0s = draw(seed, 2, len(calls), int(traffic["length"]) - w)
    return [(i, slice(c, c + w)) for i, c in zip(calls, c0s)]


def _shape(traffic):
    return (int(traffic["batch"]), int(traffic["length"]))


def _input(traffic, seed, index, device):
    return signals.make(traffic["signal"], seed, index, _shape(traffic),
                        device)


def _items(n, x, cols, out=None):
    """One item a channel of call input x (and its outputs)."""
    items = []
    for c in range(x.shape[0]):
        it = dict(n=n, x=x[c], cols=cols)
        if out is not None:
            it["out"] = {k: (v[c] if isinstance(v, torch.Tensor) else v)
                         for k, v in out.items()}
        items.append(it)
    return items


def check_inputs(system, cfg, traffic, seed, device, last=100):
    """Every channel of call `last` whole and of the calls drawn from the
    seed in their column blocks."""
    n = _shape(traffic)[1]
    out = []
    for j, cols in [(last, slice(0, n))] + picks(traffic, seed):
        out += _items(n, _input(traffic, seed, j, device), cols)
    return out


class Loop:
    def __init__(self, system, cfg, traffic, seed, device):
        self.system, self.traffic = system, traffic
        self.seed, self.device = seed, device
        self.shape = _shape(traffic)
        self.prep = system.prepare(cfg, self.shape[1], device)
        for i in (-2, -1):
            system.call(self._input(i), self.prep)
        sync(device)

    def _input(self, index):
        return _input(self.traffic, self.seed, index, self.device)

    def shapes(self, chk):
        return dict(batch=self.shape[0], n=self.shape[1],
                    **chk.reference(self.shape[1]).shapes())

    def window(self, seconds, traced):
        win, dev, sysm = Window(), self.device, self.system
        want = dict(picks(self.traffic, self.seed))
        kept = {}
        out = x = None
        reset_peak(dev)
        t0 = time.perf_counter()
        i = 0
        while True:
            with Span("portbench.input", traced):
                x = self._input(i)
            out = None
            with Span("portbench.call", traced):
                ts = time.perf_counter()
                try:
                    out = sysm.call(x, self.prep)
                except RuntimeError:
                    win.failed += 1
                te = time.perf_counter()
                sync(dev)
                tc = time.perf_counter()
            win.attempted += 1
            win.records["call_latency_s"].append(tc - ts)
            win.records["call_enqueue_s"].append(te - ts)
            if out is not None:
                win.samples += x.numel()
                if i in want:
                    with Span("portbench.keep", traced):
                        cols = want[i]
                        kept[i] = (cols, {
                            k: (v[..., cols].clone()
                                if isinstance(v, torch.Tensor) else v)
                            for k, v in out.items()})
            i += 1
            if tc - t0 >= seconds:
                break
        win.window_s = tc - t0
        win.peak_bytes = peak(dev)
        n = self.shape[1]
        if out is not None:
            win.items += _items(n, x, slice(0, n), out)
        for j, (cols, o) in kept.items():
            win.items += _items(n, self._input(j), cols, o)
        if len(kept) < len(want) or out is None:
            win.items.append(dict(missing=f"calls {sorted(want)} and the "
                                          "last not all made"))
        return win

    def close(self):
        self.prep = None
