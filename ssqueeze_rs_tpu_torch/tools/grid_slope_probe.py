"""The cost per block, per step and per launch: probe J8
(``csrc/grid_slope.cu``), the counterpart of the TPU probe
``tools/grid_slope_probe.py``.

    python -m ssqueeze_rs_tpu_torch.tools.grid_slope_probe [K] [--device cpu]

The TPU probe timed one trivial kernel, out = x + 1 on a (rows, L) float32
tile a grid step, at three grid sizes, and read the cost of a step from
the slope of time against the grid. The configurations are the TPU
probe's:

  tiny const    (8, 128) at grid 64, 256, 1024; every step writes the same
                (8, 128) output (identical values)
  tiny vary     the same tile, step i writing rows [8i, 8i + 8) of an
                (8 grid, 128) output
  row-out vary  (1, 163 840) at grid 37, 148, 293, varying: 655 KB a
                step, about one cwt row at the headline (at 293 steps one
                float32 plane of the headline ssq_cwt, 192 MB)

Two designs of the same function (`mode`):

  persistent  (the default) the tile cut into chunks of at most 32 KB, a
              (step, chunk) pair a work item, a static plan (`plan`) of at
              most two blocks an SM (fewer where the shared memory allows
              fewer) times the SMs: each block owns one chunk and a
              contiguous range of its steps, loads the chunk of x once by
              TMA and does each step's adds itself. A varying output is
              written a step by 16-byte streaming stores from registers
              (`store="regs"`) or by one bulk store (TMA) from a staging
              slot in shared memory (`store="bulk"`); the constant output
              is added into a resident chunk in shared memory each step and
              stored once, by the block that owns the chunk's last step, as
              the TPU writes its resident block back once.
  blocks      one CUDA block a step, each reading the whole tile; with a
              constant output all blocks write the same rows: the GPU's
              own question, the cost of a block, comparable with the
              probe's earlier rows.

`main` times every configuration in `blocks` mode and in `persistent`
mode by both store routes, and the `launch floor`: the persistent kernel
at grid 1 on a (1, 4) tile. Each row has the device time (CUDA events,
median of K after a warm-up, the runs queued ahead of the card so that
the events hold its time alone), the same past the floor
(`past_floor_ms`), and the host wall time a call over K calls enqueued
back to back and ended by one synchronize (what the TPU probe timed,
launch included); the slopes (ms(g_max) - ms(g_min)) / (g_max - g_min)
follow from each clock, a block's cost in `blocks` mode and a step's in
`persistent` mode. The function is exact: the plain version
(`grid_slope_plain`) gives the same bits.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs its plain version. `LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import torch

from ..ops import fft_cuda
from . import _common

__all__ = ["CONFIGS", "SMALL", "FLOOR", "MODES", "STORES", "STORE",
           "VARIANTS", "grid_slope", "grid_slope_plain", "plan",
           "kernel_plan", "config_cost", "slopes", "run", "main",
           "LAUNCHES"]

LAUNCHES = 0

# (name, rows, L, vary_out, grids): tools/grid_slope_probe.py:73-96
CONFIGS = (("tiny const", 8, 128, False, (64, 256, 1024)),
           ("tiny vary", 8, 128, True, (64, 256, 1024)),
           ("row-out vary", 1, 163_840, True, (37, 148, 293)))
SMALL = (("tiny const", 8, 128, False, (2, 4, 8)),
         ("tiny vary", 8, 128, True, (2, 4, 8)),
         ("row-out vary", 1, 1024, True, (2, 3, 5)))
# the launch floor: (name, rows, L, vary_out, grid)
FLOOR = ("launch floor", 1, 4, True, 1)

MODES = ("persistent", "blocks")
STORES = ("regs", "bulk")
STORE = "regs"      # the persistent mode's default store route
# what `main` times: (mode, store)
VARIANTS = (("persistent", "regs"), ("persistent", "bulk"), ("blocks", None))

# csrc/grid_slope.cu: the persistent kernel's chunk (floats), threads a
# block, staging slots (bulk route) and blocks an SM at most
CHUNK = 8192
THREADS = 256
SLOTS = 2
PER_SM = 2
# the H100's shared memory an SM and the system's share of each block, and
# its SMs: what the occupancy is computed from where the card is not asked
SMEM_PER_SM = 233_472
SMEM_RESERVED = 1024
SMS = 132


def _check(x, grid, mode="persistent", store=None):
    if x.dim() != 2:
        raise ValueError(f"x must be a (rows, L) tile (got {tuple(x.shape)})")
    if int(grid) < 1:
        raise ValueError(f"grid must be at least 1 (got {grid})")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES} (got {mode!r})")
    if store is not None and store not in STORES:
        raise ValueError(f"store must be one of {STORES} or None (got "
                         f"{store!r})")
    if store is not None and mode != "persistent":
        raise ValueError(f"store is a route of mode='persistent' (got "
                         f"mode={mode!r}, store={store!r})")


def grid_slope_plain(x, grid, vary_out):
    """Plain-torch J8: x + 1, repeated `grid` times down the rows when
    `vary_out`, else once."""
    _check(x, grid)
    y = x.to(torch.float32) + 1.0
    return y.repeat(grid, 1) if vary_out else y


def _store(store):
    """The store route `store` names (STORE for None)."""
    store = STORE if store is None else store
    if store not in STORES:
        raise ValueError(f"store must be one of {STORES} (got {store!r})")
    return store


def _fit(smem):
    """Blocks an SM at `smem` bytes of shared memory a block: PER_SM, or
    fewer where the shared memory runs out."""
    return min(PER_SM, SMEM_PER_SM // (smem + SMEM_RESERVED))


def plan(rows, L, grid, vary_out, store=None, sms=SMS):
    """The persistent kernel's launch (`plan` in csrc/grid_slope.cu) for a
    (rows, L) tile at `grid` steps on `sms` SMs: chunks of at most CHUNK
    floats (`chunk`, the last shorter), `per_sm` blocks an SM (PER_SM, or
    fewer where the block's shared memory `smem` allows fewer),
    `per_chunk` = min(grid, per_sm sms / chunks) blocks a chunk, `blocks`
    in all. `work`
    lists each block's (chunk, first step, end step); `loads` the chunk
    loads of x (one a block) and `stores` the chunk stores of the output
    (one a work item, or one a chunk for a constant output)."""
    tile = int(rows) * int(L)
    if tile < 4 or tile % 4:
        raise ValueError(f"the persistent kernel takes a tile of a multiple "
                         f"of 4 floats (got {rows} x {L})")
    store = _store(store)
    cf = min(tile, CHUNK)
    chunks = -(-tile // cf)
    bufs = 1 + ((SLOTS if store == "bulk" else 0) if vary_out else 1)
    smem = bufs * cf * 4 + 16
    per_sm = _fit(smem)
    most = per_sm * sms
    if chunks > most:
        raise ValueError(f"a tile of {chunks} chunks is more than the "
                         f"{most} blocks the card holds at once")
    per_chunk = min(int(grid), most // chunks)
    blocks = chunks * per_chunk
    work = [(b // per_chunk, b % per_chunk * grid // per_chunk,
             (b % per_chunk + 1) * grid // per_chunk) for b in range(blocks)]
    return dict(chunk=cf, chunks=chunks, per_chunk=per_chunk, blocks=blocks,
                smem=smem, per_sm=per_sm, sms=sms, loads=blocks,
                stores=chunks * grid if vary_out else chunks, work=work)


def kernel_plan(rows, L, grid, vary_out, store=None):
    """The persistent kernel's own plan on the current CUDA device
    (`ssq_grid_slope_plan`): chunk, chunks, per_chunk, blocks, smem,
    per_sm and sms."""
    import ctypes
    from .. import _build
    store = _store(store)
    v = (ctypes.c_int * 7)()
    _build.check(_build.lib().ssq_grid_slope_plan(
        int(rows) * int(L), int(grid), int(bool(vary_out)),
        STORES.index(store), v), "grid_slope plan")
    return dict(zip(("chunk", "chunks", "per_chunk", "blocks", "smem",
                     "per_sm", "sms"), list(v)))


def grid_slope(x, grid, vary_out, mode="persistent", store=None):
    """J8: x + 1 for the (rows, L) tile x at each of `grid` steps, written
    to the same (rows, L) output, or with `vary_out` to step i's rows of a
    (grid * rows, L) output, by `mode` ('persistent' with the store route
    `store`, STORE when None; or 'blocks'). A CUDA tensor launches the
    kernel, a CPU tensor runs `grid_slope_plain`."""
    _check(x, grid, mode, store)
    if x.device.type == "cpu":
        return grid_slope_plain(x, grid, vary_out)
    if x.device.type != "cuda":
        raise ValueError(f"grid_slope: unsupported device {x.device}")
    from .. import _build
    global LAUNCHES
    x = x.to(torch.float32).contiguous()
    if mode == "persistent":
        if x.numel() % 4:
            raise ValueError(f"the persistent kernel takes a tile of a "
                             f"multiple of 4 floats (got "
                             f"{tuple(x.shape)}); mode='blocks' takes any")
        if x.data_ptr() % 16:
            x = x.clone()
    rows = x.shape[0] * (grid if vary_out else 1)
    out = torch.empty((rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    err = _build.lib().ssq_grid_slope(
        x.data_ptr(), out.data_ptr(), x.numel(), int(grid),
        int(bool(vary_out)), 1 if mode == "persistent" else 0,
        STORES.index(_store(store)),
        fft_cuda._stream(x.device))
    _build.check(err, "grid_slope kernel")
    LAUNCHES += 1
    return out


def config_cost(rows, L, vary_out, grid):
    """(bytes, float32 operations): the tile read once, the output written
    once, one add an element a step."""
    out_rows = rows * (grid if vary_out else 1)
    return 4 * (rows * L + out_rows * L), float(grid * rows * L)


def _label(mode, store):
    return f"{mode} {store}" if store else mode


def run(device, reps=5, configs=None, seed=0):
    """Time the launch floor, then every configuration in every variant
    (`VARIANTS`) on `device` (the TPU probe's configurations on CUDA,
    `SMALL` on the CPU unless `configs` is given): rows (name, ms,
    past_floor_ms, wall_ms, bytes, flops, bound_ms, bound_by, config,
    mode, store, grid)."""
    configs = configs or (CONFIGS if device.type == "cuda" else SMALL)
    g = _common.generator(device, seed)

    def one(name, config, r, L, vary, grid, mode, store):
        x = _common.randn(g, r, L)
        fn = lambda: grid_slope(x, grid, vary, mode, store)
        return _common.row(name, _common.time_ms(fn, device, reps),
                           *config_cost(r, L, vary, grid), config=config,
                           mode=mode, store=store or None, grid=grid,
                           wall_ms=_common.wall_ms(fn, device, reps))

    name, r, L, vary, grid = FLOOR
    rows = [one(name, name, r, L, vary, grid, "persistent", STORE)]
    for name, r, L, vary, grids in configs:
        for grid in grids:
            for mode, store in VARIANTS:
                rows.append(one(f"{name} g={grid} {_label(mode, store)}",
                                name, r, L, vary, grid, mode, store))
    for row in rows:
        row["past_floor_ms"] = row["ms"] - rows[0]["ms"]
    return rows


def slopes(rows):
    """{config (and variant): (events, wall) us a step}: the slope between
    each configuration's smallest and largest grid on each clock, for each
    variant (`blocks`: a block's cost). Rows without a grid (the floor)
    are left out."""
    def key(r):
        config, rest = r["name"].rsplit(" g=", 1)
        label = rest.partition(" ")[2]
        return f"{config} {label}" if label else config

    mine = {}
    for r in rows:
        if " g=" in r["name"]:
            mine.setdefault(key(r), []).append(r)
    out = {}
    for k, rs in mine.items():
        lo, hi = rs[0], rs[-1]
        span = hi["grid"] - lo["grid"]
        out[k] = tuple((hi[c] - lo[c]) / span * 1e3 for c in ("ms", "wall_ms"))
    return out


def main(argv=None):
    a = _common.parse_args(argv, "Cost per block, per step and per launch "
                                 "(probe J8)")
    device = _common.pick_device(a.device)
    rows = run(device, a.K)
    card = _common.card_line(device)
    _common.print_rows(rows, card, width=36, digits=5)
    clocks = ("events", "wall") if device.type == "cuda" else ("host",
                                                                 "wall")
    print(f"launch floor past which each row's past_floor_ms is read: "
          f"{rows[0]['ms']:.5f} ms  | {card}", flush=True)
    for name, us in slopes(rows).items():
        what = ("per-block cost ({})".format(name[:-len(" blocks")])
                if name.endswith(" blocks") else f"per-step cost ({name})")
        print(f"{what}: " + ", ".join(
            f"{u:.4f} us {c}" for u, c in zip(us, clocks)) + f"  | {card}",
            flush=True)
    return rows


if __name__ == "__main__":
    main()
