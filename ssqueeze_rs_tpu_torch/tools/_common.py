"""What the probes share: the command line, the device rule, timing,
bounds and the card line.

A probe runs on the CUDA device unless `--device cpu` is given, and
raises without one; on the CPU it runs the kernels' plain versions at a
small shape, and its times are host times of those, never a device
time.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

# The card's published rates (NVIDIA H100 SXM data sheet, at 700 W; the
# tensor cores' dense rates): the least time for a piece of work is the
# larger of its bytes (each input read once, each output written once)
# over the memory rate and its operations over the rate of the unit they
# run on: the CUDA cores' float32 peak, or the tensor cores' bf16 or TF32
# rate (a 3xTF32 product counts its three TF32 products).
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_FLOP_S = 989e12
TF32_FLOP_S = 495e12
# the card's spin ahead of timed runs, 10 ms at the H100's top clock
# (1.98 GHz) and longer below it: far longer than the host takes to queue
# a few runs of any probe's kernel
SPIN_CYCLES = 20_000_000


def parse_args(argv, description, flags=()):
    """`[K] [--device DEV]`: K timed runs of each variant (median, after
    one warm-up), the device (default: the CUDA device); `flags`: (name,
    help) of further on/off options."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("K", nargs="?", type=int, default=5,
                   help="timed runs of each variant (default 5)")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain versions at a small shape; "
                        "default: the CUDA device")
    for name, text in flags:
        p.add_argument(name, action="store_true", help=text)
    args = p.parse_args(argv)
    if args.K < 1:
        p.error("K must be at least 1")
    return args


def pick_device(name):
    """The device a probe runs on: CUDA unless `name` says otherwise; no
    CUDA device and no `name` raises."""
    if name is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the probe times the kernels "
                               "on the card; pass --device cpu to run their "
                               "plain versions at a small shape")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(name)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    return device


def card_line(device):
    """The card's name and power limit as nvidia-smi gives them, or the
    note that the numbers are host times of the plain versions."""
    if device.type != "cuda":
        return "cpu: plain versions, host ms (no device time)"
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader",
                              f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=60)
        if res.returncode == 0 and res.stdout.strip():
            return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(device)}, power limit not read"


def time_ms(fn, device, reps):
    """Median ms of fn() over `reps` runs after one warm-up. On the card:
    CUDA events around each run, the runs queued behind a spin of the card
    (`torch.cuda._sleep(SPIN_CYCLES)`) that outlasts the host's enqueueing,
    so each pair of events holds the card's time for the run alone, not
    the host's launch work (a run shorter than that work would otherwise
    time the host; runs of more launches than the card's queue holds make
    the host wait on the card, which stays fed); on the CPU: the host
    clock."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda._sleep(SPIN_CYCLES)
        events = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize(device)
        times = [a.elapsed_time(b) for a, b in events]
    else:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def wall_ms(fn, device, reps):
    """Host wall ms a call of fn() over `reps` calls enqueued back to back
    and ended by one synchronize (after one warm-up): what the TPU probes'
    `timed` measured, launch and dispatch included. On the CPU the host
    clock over the same calls."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3 / reps


def generator(device, seed=0):
    """A torch.Generator on `device` set to `seed`: the probes' inputs are
    made from it on the device they run on."""
    return torch.Generator(device=device).manual_seed(seed)


def randn(g, *shape, scale=1.0):
    """Standard normal float32 times `scale`, on g's device."""
    return torch.randn(shape, generator=g, device=g.device) * scale


def randint(g, high, *shape):
    """int32 integers in [0, high), on g's device."""
    return torch.randint(0, high, shape, generator=g, device=g.device,
                         dtype=torch.int32)


def bound(nbytes, flops, rate=F32_FLOP_S):
    """(bound_ms, 'bytes' or 'operations') of work that moves `nbytes`
    and does `flops` operations on a unit of `rate` operations a
    second."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row(name, ms, nbytes, flops, rate=F32_FLOP_S, **extra):
    """One variant's result: its time, bytes, operations and bound."""
    b = bound(nbytes, flops, rate)
    return dict(name=name, ms=ms, bytes=nbytes, flops=flops, bound_ms=b[0],
                bound_by=b[1], **extra)


def print_rows(rows, card, width=12, digits=3):
    """One line a row, its times to `digits` decimals of a ms."""
    for r in rows:
        per = ""
        if "per_transform_ms" in r:
            per = f" ({r['per_transform_ms']:.3f} a transform)"
        if "past_floor_ms" in r:
            per += f" (past the floor {r['past_floor_ms']:.{digits}f})"
        if "wall_ms" in r:
            per += f" (wall {r['wall_ms']:.{digits}f})"
        if "note" in r:
            per += f" {r['note']}"
        print(f"{r['name']:<{width}s} {r['ms']:9.{digits}f} ms{per}  bound "
              f"{r['bound_ms']:.4g} ms ({r['bound_by']})  | {card}",
              flush=True)
