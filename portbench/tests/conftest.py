"""CPU tests of the benchmark's harness: `python -m pytest portbench/tests`.
Tests marked `card` need a CUDA device and skip without one."""
import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
sys.path[:0] = [PB, os.path.dirname(PB)]

SIGNAL = {"noise": 1.0, "tones": 2, "amp": [0.5, 4.0], "freq": [0.002, 0.45]}
# the cells' traffic at a size a CPU test holds: the same loops, two
# channels of 4096 samples, requests of 3000 and 16000 samples into two
# buckets
SMALL = {
    "b8_160k": {"loop": "batch", "batch": 2, "length": 4096, "signal": SIGNAL,
                "check_calls": 2, "check_from": 3, "check_cols": 512},
    "serve_numpy": {"loop": "serve", "signal": SIGNAL, "check_requests": 3,
                    "check_from": 3, "lengths": [3000, 16000],
                    "buckets": [4096, 16384]},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


def write_json(folder, kind, name, obj):
    os.makedirs(os.path.join(folder, kind), exist_ok=True)
    with open(os.path.join(folder, kind, name + ".json"), "w") as f:
        json.dump(obj, f)


@pytest.fixture
def small_bench(tmp_path):
    """The benchmark with its cells' traffic cut to CPU size (a folder
    searched before the benchmark's own)."""
    from core import bench
    for name, traffic in SMALL.items():
        write_json(str(tmp_path), "traffic", name, traffic)
    return bench.Bench(dirs=(str(tmp_path), PB))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
