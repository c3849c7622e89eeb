"""The cost per block and per launch: probe J8 (``csrc/grid_slope.cu``), the
counterpart of the TPU probe ``tools/grid_slope_probe.py``.

    python -m ssqueeze_rs_tpu_torch.tools.grid_slope_probe [K] [--device cpu]

The TPU probe timed one trivial kernel, out = x + 1 on a (rows, L) float32
tile a grid step, at three grid sizes, and read the cost of a step from
the slope of time against the grid. Here a grid step is one thread
block; the configurations are the TPU probe's:

  tiny const    (8, 128) at grid 64, 256, 1024; every block writes the same
                (8, 128) output (identical values)
  tiny vary     the same tile, block i writing rows [8i, 8i + 8) of an
                (8 grid, 128) output
  row-out vary  (1, 163 840) at grid 37, 148, 293, varying: 655 KB a
                block, about one cwt row at the headline

Each row has the device time (CUDA events, median of K after a warm-up,
the runs queued ahead of the card so that the events hold its time
alone) and the host wall time a call over K calls enqueued back to back
and ended by one synchronize (what the TPU probe timed, launch
included); the slopes (ms(g_max) - ms(g_min)) / (g_max - g_min) follow
from each clock. The function is exact: the plain version
(`grid_slope_plain`) gives the same bits.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs its plain version. `LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import torch

from ..ops import fft_cuda
from . import _common

__all__ = ["CONFIGS", "grid_slope", "grid_slope_plain", "config_cost",
           "slopes", "run", "main", "LAUNCHES"]

LAUNCHES = 0

# (name, rows, L, vary_out, grids): tools/grid_slope_probe.py:73-96
CONFIGS = (("tiny const", 8, 128, False, (64, 256, 1024)),
           ("tiny vary", 8, 128, True, (64, 256, 1024)),
           ("row-out vary", 1, 163_840, True, (37, 148, 293)))
SMALL = (("tiny const", 8, 128, False, (2, 4, 8)),
         ("tiny vary", 8, 128, True, (2, 4, 8)),
         ("row-out vary", 1, 1024, True, (2, 3, 5)))


def _check(x, grid):
    if x.dim() != 2:
        raise ValueError(f"x must be a (rows, L) tile (got {tuple(x.shape)})")
    if int(grid) < 1:
        raise ValueError(f"grid must be at least 1 (got {grid})")


def grid_slope_plain(x, grid, vary_out):
    """Plain-torch J8: x + 1, repeated `grid` times down the rows when
    `vary_out`, else once."""
    _check(x, grid)
    y = x.to(torch.float32) + 1.0
    return y.repeat(grid, 1) if vary_out else y


def grid_slope(x, grid, vary_out):
    """J8: `grid` blocks each computing x + 1 for the (rows, L) tile x and
    writing it to the same (rows, L) output, or with `vary_out` to block
    i's rows of a (grid * rows, L) output. A CUDA tensor launches the
    kernel, a CPU tensor runs `grid_slope_plain`."""
    _check(x, grid)
    if x.device.type == "cpu":
        return grid_slope_plain(x, grid, vary_out)
    if x.device.type != "cuda":
        raise ValueError(f"grid_slope: unsupported device {x.device}")
    from .. import _build
    global LAUNCHES
    x = x.to(torch.float32).contiguous()
    rows = x.shape[0] * (grid if vary_out else 1)
    out = torch.empty((rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    err = _build.lib().ssq_grid_slope(x.data_ptr(), out.data_ptr(), x.numel(),
                                      int(grid), int(bool(vary_out)),
                                      fft_cuda._stream(x.device))
    _build.check(err, "grid_slope kernel")
    LAUNCHES += 1
    return out


def config_cost(rows, L, vary_out, grid):
    """(bytes, float32 operations): the tile read once, the output written
    once, one add an element a block."""
    out_rows = rows * (grid if vary_out else 1)
    return 4 * (rows * L + out_rows * L), float(grid * rows * L)


def run(device, reps=5, configs=None, seed=0):
    """Time every configuration on `device` (the TPU probe's on CUDA,
    `SMALL` on the CPU unless `configs` is given): rows (name, ms,
    wall_ms, bytes, flops, bound_ms, bound_by, grid)."""
    configs = configs or (CONFIGS if device.type == "cuda" else SMALL)
    g = _common.generator(device, seed)
    rows = []
    for name, r, L, vary, grids in configs:
        x = _common.randn(g, r, L)
        for grid in grids:
            fn = lambda: grid_slope(x, grid, vary)
            rows.append(_common.row(
                f"{name} g={grid}", _common.time_ms(fn, device, reps),
                *config_cost(r, L, vary, grid), grid=grid,
                wall_ms=_common.wall_ms(fn, device, reps)))
    return rows


def slopes(rows):
    """{config: (events, wall) us a block}: the slope between each
    configuration's smallest and largest grid on each clock."""
    out = {}
    for name in dict.fromkeys(r["name"].rsplit(" g=", 1)[0] for r in rows):
        mine = [r for r in rows if r["name"].rsplit(" g=", 1)[0] == name]
        lo, hi = mine[0], mine[-1]
        span = hi["grid"] - lo["grid"]
        out[name] = tuple((hi[k] - lo[k]) / span * 1e3
                          for k in ("ms", "wall_ms"))
    return out


def main(argv=None):
    a = _common.parse_args(argv, "Cost per block and per launch (probe J8)")
    device = _common.pick_device(a.device)
    rows = run(device, a.K)
    card = _common.card_line(device)
    _common.print_rows(rows, card, width=20)
    clocks = ("events", "wall") if device.type == "cuda" else ("host",
                                                                 "wall")
    for name, us in slopes(rows).items():
        print(f"per-block cost ({name}): " + ", ".join(
            f"{u:.4f} us {c}" for u, c in zip(us, clocks)) + f"  | {card}",
            flush=True)
    return rows


if __name__ == "__main__":
    main()
