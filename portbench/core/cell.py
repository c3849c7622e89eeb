"""One run of one cell: set-up (timed as setup_s), the window, the check
against the reference, the cell's metrics from their readers, and the
result line."""
from __future__ import annotations

import gc
import subprocess
import sys
import time

import torch

from . import check, guard, peaks
from .trace import Trace

BIG = sys.float_info.max        # what an infinite number reads as in JSON


class Ctx:
    """What a metric's reader reads: the cell's configuration, traffic and
    shapes, the window's host-clock records, the trace of a traced run
    (None otherwise), and the card."""

    def __init__(self, bench, cfg, traffic, shapes, win, trace, setup_s,
                 device_name):
        self.bench, self.cfg, self.traffic = bench, cfg, traffic
        self.shapes, self.trace, self.setup_s = shapes, trace, setup_s
        self.records, self.window_s = win.records, win.window_s
        self.calls, self.samples = win.attempted, win.samples
        self.peak_bytes, self.device_name = win.peak_bytes, device_name

    def roofline_pct(self, kernel, match):
        """100 x the least seconds of `kernel`'s work a call (its
        roofline/<kernel>.py count at the cell's shapes, over the card's
        peaks) / the device seconds a call of the operations `match`
        accepts; None without a trace, a launch or the card's peaks."""
        if self.trace is None or not self.calls:
            return None
        dev = self.trace.device_s(match) / self.calls
        if dev <= 0:
            return None
        nbytes, flops = self.bench.module("roofline", kernel).count(self.shapes)
        least = peaks.least_seconds(self.device_name, nbytes, flops)
        return None if least is None else 100.0 * least / dev


def power_limit():
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else None


def _finite(v):
    return BIG if v == float("inf") else v


def run(bench, name, seed, seconds, trace, t_start, device=None):
    """(result, forbidden modules loaded): one run of cell `name`. `device`
    None is the card, which the cell's chips must be there for (else
    SystemExit); the tests pass the CPU."""
    w, cfg, traffic = bench.cell(name)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(w["chips"]):
            raise SystemExit(f"cell {name} needs {w['chips']} CUDA device(s); "
                             f"found {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    system = bench.module("systems", cfg["transform"])
    loop = bench.module("loops", traffic["loop"])
    state = loop.Loop(system, cfg, traffic, seed, device)
    setup_s = time.perf_counter() - t_start

    tr = Trace() if trace else None
    if tr is not None:
        with tr:
            win = state.window(seconds, True)
    else:
        win = state.window(seconds, False)
    state.close()
    gc.collect()
    if tr is not None:
        print(f"trace: {len(tr.device)} device operations of the program, "
              f"{len(tr.harness)} of the benchmark's own set apart "
              f"({tr.harness_s()} s)", file=sys.stderr)

    chk = check.Check(system, cfg, device)
    shapes = state.shapes(chk)
    numbers = chk.numbers(win.items)
    win.items = None
    correct, table = check.verdict(numbers, cfg["limits"])
    correct = correct and win.failed == 0

    name_dev = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
    ctx = Ctx(bench, cfg, traffic, shapes, win, tr, setup_s, name_dev)
    kind, folder = (("per_layer", "metrics") if trace else
                    ("end_to_end", "e2e"))
    metrics = {}
    for m in bench.metrics(kind, name):
        v = bench.module(folder, m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": name_dev, "count": int(w["chips"]),
           "memory_peak_bytes": win.peak_bytes,
           "power_limit": power_limit() if device.type == "cuda" else None}
    result = {"correct": bool(correct), "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s(), win.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["check"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                       for k, v in table.items()}
    return result, guard.forbidden()
