"""Traffic loop "serve": single 1-D requests, one caller, through the
transform's server with the traffic file's `buckets`, each request's
signal made on the host as its client hands it over. The lengths are the
file's `lengths`, served in an order drawn from the seed and repeated as
the window needs. A request's latency runs from the server's call until
its numpy outputs are returned.

The window keeps, for the check, `check_requests` requests drawn from the
seed among the first `check_from`, and the first of the longest length
there. The reference plans each at its bucket, chosen from the traffic
file's own copy of the buckets, not from the server."""
from __future__ import annotations

import time

import numpy as np
import torch

from core import signals
from core.trace import Span
from core.window import Window, draw, peak, reset_peak, sync


def request_lengths(traffic, seed):
    """The lengths of one pass, in the seed's order."""
    lengths = [int(n) for n in traffic["lengths"]]
    rng = np.random.default_rng([int(seed) % (1 << 64), 3])
    return [lengths[k] for k in rng.permutation(len(lengths))]


def bucket_of(traffic, n):
    """The smallest of the traffic's buckets that holds n samples."""
    return min(b for b in traffic["buckets"] if b >= n)


def request_signal(traffic, seed, index, lengths):
    """Request `index`'s signal, a float32 numpy array."""
    n = lengths[index % len(lengths)]
    return signals.make_host(traffic["signal"], seed, index, (n,))


def picks(traffic, seed, lengths):
    """The requests whose outputs a window keeps."""
    first = int(traffic["check_from"])
    lens = [lengths[i % len(lengths)] for i in range(first)]
    return sorted(set(draw(seed, 4, int(traffic["check_requests"]), first))
                  | {int(np.argmax(lens))})


def _item(traffic, x, out=None):
    it = dict(n=bucket_of(traffic, len(x)), x=torch.as_tensor(x),
              cols=slice(0, len(x)), served=True)
    if out is not None:
        it["out"] = out
    return it


def check_inputs(system, cfg, traffic, seed, device):
    lengths = request_lengths(traffic, seed)
    return [_item(traffic, request_signal(traffic, seed, j, lengths))
            for j in picks(traffic, seed, lengths)]


class Loop:
    def __init__(self, system, cfg, traffic, seed, device):
        self.system, self.traffic = system, traffic
        self.seed, self.device = seed, device
        self.lengths = request_lengths(traffic, seed)
        self.server = system.server(cfg, traffic["buckets"], device)
        # two requests into each bucket the traffic reaches, and no other:
        # the planning, the kernels, the trim and the fetch have all run
        first = {}
        for n in self.lengths:
            first.setdefault(bucket_of(traffic, n), n)
        for k, n in enumerate(first.values()):
            for j in (-1 - 2 * k, -2 - 2 * k):
                self.server(request_signal(traffic, seed, j, [n]))
        sync(device)

    def shapes(self, chk):
        return dict(lengths=self.lengths)

    def window(self, seconds, traced):
        win, dev = Window(), self.device
        want = picks(self.traffic, self.seed, self.lengths)
        kept = []
        reset_peak(dev)
        t0 = time.perf_counter()
        i = 0
        while True:
            with Span("portbench.input", traced):
                x = request_signal(self.traffic, self.seed, i, self.lengths)
            res = None
            with Span("portbench.request", traced):
                ts = time.perf_counter()
                try:
                    res = self.server(x)
                except RuntimeError:
                    win.failed += 1
                tc = time.perf_counter()
            win.attempted += 1
            win.records["request_latency_s"].append(tc - ts)
            if res is not None:
                win.samples += x.size
                if i in want:
                    kept.append((x, res))
            i += 1
            if tc - t0 >= seconds:
                break
        win.window_s = tc - t0
        win.peak_bytes = peak(dev)
        win.items = [_item(self.traffic, x, self.system.served(res))
                     for x, res in kept]
        if len(kept) < len(want):
            win.items.append(dict(missing=f"requests {want} not all "
                                          "served"))
        return win

    def close(self):
        self.server = None
