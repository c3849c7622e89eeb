"""The comparison fails its control, and fails a run whose timed path is
broken underneath: the reference in bfloat16 in the program's place; an
output left stale from an earlier call; half of a batch left out; an
answer altered where it is produced; a NaN in an output. Every cell at a CPU size, with the
chip check skipped. (The control at the cells' own sizes runs on the card:
`python3 portbench/control.py --workload <cell> --seeds ...`.)"""
import time

import numpy as np
import pytest
import torch

from conftest import SMALL
from core import bench, cell, check, control

CELLS = ["ssq_cwt.b8_160k", "ssq_stft.b8_160k", "ssq_cwt.serve_numpy",
         "ssq_stft.serve_numpy"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(small_bench, name):
    w, cfg, traffic = small_bench.cell(name)
    nums = control.readings(small_bench, cfg, traffic, 12345,
                            torch.device("cpu"))
    correct, table = check.verdict(nums, cfg["limits"])
    assert not correct, table
    # the control fails every number, each by a wide margin
    assert all(v["value"] > 3 * v["limit"] for v in table.values()), table


def stale(call):
    first = {}

    def f(x, prep):
        out = call(x, prep)
        return first.setdefault("out", out)
    return f


def half(call):
    def f(x, prep):
        b = x.shape[0] // 2
        out = call(x[:b], prep)
        return {k: (torch.cat([v, v]) if isinstance(v, torch.Tensor) else v)
                for k, v in out.items()}
    return f


def altered(call):
    def f(x, prep):
        out = call(x, prep)
        out["Tx"][-1] = torch.roll(out["Tx"][-1], 1, dims=-2)
        return out
    return f


def poisoned(call):
    def f(x, prep):
        out = call(x, prep)
        out["Tx"][0, 0, 0] = float("nan")
        return out
    return f


def stale_served(server):
    first = {}

    def f(x):
        return first.setdefault("res", server(x))
    return f


def altered_served(server):
    def f(x):
        res = server(x)
        res["Tx"] = np.roll(res["Tx"], 1, axis=-2)
        return res
    return f


@pytest.mark.parametrize("name", CELLS[:2])
@pytest.mark.parametrize("fault", [stale, half, altered, poisoned])
def test_broken_batch_path_is_not_correct(small_bench, monkeypatch, name,
                                          fault):
    _, cfg, _ = small_bench.cell(name)
    system = small_bench.module("systems", cfg["transform"])
    monkeypatch.setattr(system, "call", fault(system.call))
    res, _ = cell.run(small_bench, name, 99, 1.0, False,
                      time.perf_counter(), device="cpu")
    assert not res["correct"], res["check"]


def wrong_bucket(server):
    """A server that pads every request to its largest bucket."""
    server.bucket_for = lambda n: server.buckets[-1]
    return server


class Broken:
    """A server whose calls go through `fault`."""

    def __init__(self, srv, fault):
        self.srv, self.call = srv, fault(srv)

    def __call__(self, x):
        return self.call(x)

    def __getattr__(self, k):
        return getattr(self.srv, k)


@pytest.mark.parametrize("name", CELLS[2:])
@pytest.mark.parametrize("fault", [stale_served, altered_served])
def test_broken_served_path_is_not_correct(small_bench, monkeypatch, name,
                                           fault):
    _, cfg, _ = small_bench.cell(name)
    system = small_bench.module("systems", cfg["transform"])
    make = system.server
    monkeypatch.setattr(system, "server",
                        lambda c, b, d: Broken(make(c, b, d), fault))
    res, _ = cell.run(small_bench, name, 99, 1.5, False,
                      time.perf_counter(), device="cpu")
    assert not res["correct"], res["check"]


def test_served_at_the_wrong_bucket_is_not_correct(small_bench, monkeypatch):
    """The reference plans a request at the bucket of the traffic's own
    copy of the buckets, not at the one the server chose. (The STFT's
    output does not depend on the bucket, so only the CWT's can be wrong
    by it.)"""
    name = "ssq_cwt.serve_numpy"
    _, cfg, _ = small_bench.cell(name)
    system = small_bench.module("systems", cfg["transform"])
    make = system.server
    monkeypatch.setattr(system, "server",
                        lambda c, b, d: Broken(make(c, b, d), wrong_bucket))
    res, _ = cell.run(small_bench, name, 99, 1.5, False,
                      time.perf_counter(), device="cpu")
    assert not res["correct"], res["check"]


def test_small_traffic_has_the_cells_keys():
    b = bench.Bench()
    for name in SMALL:
        assert set(b.json("traffic", name)) == set(SMALL[name]), name
