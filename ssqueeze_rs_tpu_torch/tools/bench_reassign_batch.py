"""A batch of scatters three ways: the counterpart of the TPU probe
``tools/bench_reassign_batch.py`` (its `grid3d`), as the grid modes of
probe P4 (`ablate_reassign.ablate_reassign`, ``csrc/ablate_reassign.cu``).

    python -m ssqueeze_rs_tpu_torch.tools.bench_reassign_batch [K] [--device cpu]

Kernel B''s scatter (P4's `full`, B' bit for bit) over a (B, na, n)
batch at na = nf = 293, n = 160 000 and
B = 4 and 8, random planes from a seed, the TPU probe's log plan
(vlmin = -9, dvl = 0.035), gamma 1e-8, transform 'cwt', flipud:

  batch2d   B''s own launch: the batch on blockIdx.y
  grid1d    one 1-D grid of B x ceil(n / cols) blocks
  flat+T    one call over (na, B * n) columns, the relayout of the
            planes in and of Tx out timed with it
  flat_pre  the same call on planes relaid beforehand (the kernel alone)

The scatter is column-local, so every mode gives the same bits. Each
line gives the call's ms and ms per transform (per signal).
"""
from __future__ import annotations

from . import _common
from . import ablate_reassign as ar

__all__ = ["BATCHES", "MODE", "PARAMS", "run", "main"]

BATCHES = (4, 8)
MODE = "log"
PARAMS = dict(vlmin=-9.0, dvl=0.035)


def run(device, reps=5, batches=BATCHES, size=None, seed=0):
    """Time the four modes at each batch on `device` (the headline on
    CUDA, `ablate_reassign.SMALL` on the CPU unless `size` is given):
    rows (name, batch, ms, per_transform_ms, bytes, flops,
    bound_ms, bound_by)."""
    size = size or (ar.HEADLINE if device.type == "cuda" else ar.SMALL)
    na, nf, n = size["na"], size["nf"], size["n"]
    rest = (ar.GAMMA, PARAMS, MODE, True, nf, "cwt")
    rows = []
    for B in batches:
        planes = ar.make_planes(device, B, na, n, seed)
        cost = ar.variant_cost("full", B, na, nf, n)

        def add(name, fn):
            ms = _common.time_ms(fn, device, reps)
            rows.append(_common.row(f"{name} B={B}", ms, *cost, batch=B,
                                    per_transform_ms=ms / B))

        for grid in ar.GRIDS:
            add("flat+T" if grid == "flat" else grid,
                lambda: ar.ablate_reassign(*planes, *rest, grid=grid))
        flat = [ar._to_flat(p) for p in planes[:4]]
        add("flat_pre", lambda: ar.ablate_reassign(*flat, *planes[4:],
                                                   *rest))
        del planes, flat
    return rows


def main(argv=None):
    a = _common.parse_args(argv, "A batch of B' scatters three ways "
                                 "(probe P4's grid modes)")
    device = _common.pick_device(a.device)
    rows = run(device, a.K)
    _common.print_rows(rows, _common.card_line(device), width=14)
    return rows


if __name__ == "__main__":
    main()
