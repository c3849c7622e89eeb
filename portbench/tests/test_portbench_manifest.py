"""BENCHMARK.json against its contract's form, every piece it names found
by name, and a cell, a configuration, a per-layer metric and a roofline
count added as new files beside the benchmark's, without an edit."""
import json
import math
import os
import re
import time

import pytest

from conftest import PB, SMALL, write_json

ROOT = os.path.dirname(PB)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_keys_and_names():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["portbench"] and m["command"][1] == "portbench/run.py"
    assert 1 <= m["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for e in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])


def test_every_cell_finds_its_pieces():
    from core import bench
    b = bench.Bench()
    m = manifest()
    e2e = {e["name"]: e for e in m["end_to_end"]}
    for w in m["workloads"]:
        _, cfg, traffic = b.cell(w["name"])
        assert os.path.exists(os.path.join(ROOT, "portbench", "configs",
                                           w["config"] + ".json"))
        assert callable(b.module("loops", traffic["loop"]).Loop)
        assert callable(b.module("systems", cfg["transform"]).call)
        reported = [e["name"] for e in b.metrics("end_to_end", w["name"])]
        assert "setup_s" in reported and len(reported) >= 2
        layer = b.metrics("per_layer", w["name"])
        assert layer
        for p in layer:
            # the metric it moves is one this cell reports
            assert p["moves"] in reported
            assert e2e[p["moves"]]
    for e in m["end_to_end"]:
        assert callable(b.module("e2e", e["name"]).read)
    for p in m["per_layer"]:
        assert callable(b.module("metrics", p["name"]).read)


def test_scratch_cell_from_new_files(tmp_path):
    """A configuration, a traffic mix, a cell, a per-layer metric and a
    roofline count, each a new file in a folder of its own, plus manifest
    entries: the harness runs the cell and reports the metric."""
    from core import bench, cell
    d = str(tmp_path)
    m = manifest()
    with open(os.path.join(PB, "configs", "ssq_stft_598.json")) as f:
        cfg = json.load(f)
    cfg["n_fft"] = 254
    write_json(d, "configs", "ssq_stft_254", cfg)
    write_json(d, "traffic", "b2_4k", SMALL["b8_160k"])
    os.makedirs(os.path.join(d, "metrics"))
    with open(os.path.join(d, "metrics", "scratch.bytes_ms.py"), "w") as f:
        f.write("def read(ctx):\n"
                "    b, f = ctx.bench.module('roofline', 'scratch')"
                ".count(ctx.shapes)\n"
                "    return b / 1e6\n")
    os.makedirs(os.path.join(d, "roofline"))
    with open(os.path.join(d, "roofline", "scratch.py"), "w") as f:
        f.write("def count(s):\n"
                "    return 4 * s['batch'] * s['n'] * s['nf'], 0.0\n")
    m["configs"].append({"name": "ssq_stft_254", "source": "scratch",
                         "file": "portbench/configs/ssq_stft_254.json",
                         "reduced": ["n_fft"], "why": "scratch"})
    m["workloads"].append({"name": "ssq_stft.scratch", "config":
                           "ssq_stft_254", "traffic": "b2_4k", "chips": 1,
                           "why": "scratch"})
    m["per_layer"].append({"name": "scratch.bytes_ms", "unit": "MB",
                           "better": "lower", "source": "program_counter",
                           "layer": "kernels", "moves": "throughput_msps",
                           "workloads": ["ssq_stft.scratch"]})
    b = bench.Bench(manifest=m, dirs=(d, PB))
    res, found = cell.run(b, "ssq_stft.scratch", 5, 0.5, True,
                          time.perf_counter(), device="cpu")
    assert res["correct"] and found == []
    assert res["metrics"]["scratch.bytes_ms"]["value"] == \
        4 * 2 * 4096 * 128 / 1e6
    assert list(res)[-1] == "check"


SCRATCH_SYSTEM = '''
"""A transform with numbers of its own and no Tx: the real FFT."""
import numpy as np
import torch

from core import check


def call(x, prep):
    return {"X": torch.fft.rfft(x)}


def compare(out, exp, ref, device):
    return {"x_rel": check.rel_max(out["X"], exp["X"], device)}


class Reference:
    def __init__(self, cfg, n, served=False):
        self.n = n

    def __call__(self, x, precision="float64", cols=None):
        X = np.fft.rfft(np.asarray(x.cpu(), np.float64))
        return {"X": torch.as_tensor(X).to(x.device)}

    def host(self):
        return {}

    def shapes(self):
        return dict(nf=self.n // 2 + 1)
'''

SCRATCH_LOOP = '''
"""One call a step on a fixed batch; the last call is checked."""
import time

from core import signals
from core.window import Window


def check_inputs(system, cfg, traffic, seed, device):
    x = signals.make(traffic["signal"], seed, 0, (2, traffic["n"]), device)
    return [dict(n=traffic["n"], x=x[c], cols=None) for c in range(2)]


class Loop:
    def __init__(self, system, cfg, traffic, seed, device):
        self.system, self.n = system, traffic["n"]
        self.x = signals.make(traffic["signal"], seed, 0, (2, self.n), device)

    def shapes(self, chk):
        return dict(n=self.n, **chk.reference(self.n).shapes())

    def window(self, seconds, traced):
        win = Window()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            ts = time.perf_counter()
            out = self.system.call(self.x, None)
            win.records["step_s"].append(time.perf_counter() - ts)
            win.attempted += 1
            win.samples += self.x.numel()
        win.window_s = time.perf_counter() - t0
        win.items = [dict(n=self.n, x=self.x[c], cols=None,
                          out={"X": out["X"][c]}) for c in range(2)]
        return win

    def close(self):
        pass
'''


@pytest.mark.parametrize("broken", [False, True])
def test_scratch_transform_and_loop_from_new_files(tmp_path, broken):
    """A new transform that compares a number of its own (no Tx), on a new
    traffic loop, with a new end-to-end metric: only new files and
    manifest entries. Its own number decides `correct`."""
    from core import bench, cell
    d = str(tmp_path)
    m = manifest()
    write_json(d, "configs", "rfft_4k", {"transform": "scratch_rfft",
                                         "limits": {"x_rel": 1e-5}})
    write_json(d, "traffic", "steps_4k", {"loop": "scratch_steps", "n": 4096,
                                          "signal": SMALL["b8_160k"]["signal"]})
    system = SCRATCH_SYSTEM
    if broken:
        system = system.replace("torch.fft.rfft(x)", "torch.fft.rfft(x) * 1.01")
    for kind, name, text in [
            ("systems", "scratch_rfft", system),
            ("loops", "scratch_steps", SCRATCH_LOOP),
            ("e2e", "steps_per_s", "def read(ctx):\n"
             "    return ctx.calls / ctx.window_s\n")]:
        os.makedirs(os.path.join(d, kind))
        with open(os.path.join(d, kind, name + ".py"), "w") as f:
            f.write(text)
    m["configs"].append({"name": "rfft_4k", "source": "scratch",
                         "file": "portbench/configs/rfft_4k.json",
                         "reduced": [], "why": "scratch"})
    m["workloads"].append({"name": "rfft.steps", "config": "rfft_4k",
                           "traffic": "steps_4k", "chips": 1,
                           "why": "scratch"})
    m["end_to_end"].append({"name": "steps_per_s", "unit": "1/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["rfft.steps"]})
    b = bench.Bench(manifest=m, dirs=(d, PB))
    res, found = cell.run(b, "rfft.steps", 5, 0.3, False,
                          time.perf_counter(), device="cpu")
    assert found == []
    assert res["correct"] is (not broken), res["check"]
    assert list(res["check"]) == ["x_rel"]
    assert set(res["metrics"]) == {"steps_per_s", "setup_s"}
    assert res["metrics"]["steps_per_s"]["value"] > 0


@pytest.mark.parametrize("name", ["ssq_cwt.b8_160k", "ssq_stft.serve_numpy"])
def test_result_line_keys(small_bench, name):
    from core import cell
    res, found = cell.run(small_bench, name, 2 ** 31 + 7, 1.5, False,
                          time.perf_counter(), device="cpu")
    assert found == []
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert "setup_s" in res["metrics"]
    for v in res["check"].values():
        assert math.isfinite(v["value"]) and v["value"] <= v["limit"]
