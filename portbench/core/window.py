"""What the loops (`loops/<name>.py`, one file each, found by the traffic
file's "loop") share: the window's record, the device's synchronise and
peak, and the draws of the items the check compares.

A loop module has `Loop(system, cfg, traffic, seed, device)`, whose
constructor makes everything the window needs and warms the cell's own
shapes (set-up); `Loop.window(seconds, traced)`, which runs for `seconds`
(the last call or request ends it) and returns a `Window` holding the
outputs the check compares; `Loop.shapes(check)`, the shapes the roofline
counts read; `Loop.close()`; and `check_inputs(system, cfg, traffic, seed,
device)`, the items a run at `seed` compares, without their outputs, for
the control. An item is a dict: `n`, the length the reference is planned
at; `x`, the input (padded by reflection to `n` where shorter); `cols`,
the output columns compared; `served`, true for a server's request; and
after a run `out`, the program's outputs, or `missing` with the reason
where an output the check needs was not made."""
from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch


def sync(device):
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()


def reset_peak(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak(device):
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)


def draw(seed, salt, count, below):
    """`count` distinct whole numbers under `below`, sorted, drawn from
    (seed, salt): the same for the same seed on any run."""
    rng = np.random.default_rng([int(seed) % (1 << 64), salt])
    return sorted(rng.choice(below, size=min(count, below), replace=False)
                  .tolist())


class Window:
    """What a window leaves: host-clock records by name, the calls or
    requests attempted and failed, the samples transformed, the window's
    seconds, the device's peak bytes and the items the check compares."""

    def __init__(self):
        self.records = defaultdict(list)
        self.attempted = self.failed = self.samples = 0
        self.window_s = self.peak_bytes = None
        self.items = []
