"""The control of the benchmark's comparison at a cell's own sizes: the
reference in bfloat16 in the program's place, on the items that a run of
the cell at each seed checks. One JSON line a seed with the comparison's
numbers, which must exceed the configuration's limits.

    python3 portbench/control.py --workload ssq_cwt.b8_160k --seeds 1 2 3
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

from core import bench, check, control  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    b = bench.Bench()
    _, cfg, traffic = b.cell(args.workload)
    dev = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums = control.readings(b, cfg, traffic, seed, dev)
        correct, _ = check.verdict(nums, cfg["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": nums, "correct": correct,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
