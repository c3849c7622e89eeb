"""Where the time of kernels B and B' goes: probe P4
(``csrc/ablate_reassign.cu``), the counterpart of the TPU probe
``tools/ablate_reassign.py``.

    python -m ssqueeze_rs_tpu_torch.tools.ablate_reassign [K] [--device cpu]

P4 instantiates B''s own scatter (``csrc/reassign.cuh``: 16 lanes a
column, each entry binned and added by its own lane, the lanes of one
(bin, column) in rounds by row) with ablation flags, in its 4-plane form
(B') at na = nf = 293, n = 160 000, random planes from a seed, const 1,
the TPU probe's log-piecewise plan (`PARAMS`), transform 'cwt', flipud.
Every variant but `full`, `serial`, `noprefetch` and `walk` computes wrong
math by design and keeps the memory traffic of what it does not remove:

  full        B' itself (`reassign_cuda.reassign4` bit for bit), at 32,
              16 and 8 columns a block (B's own are 32 and 8)
  dmaonly     the four planes read, zero Tx planes written
  binonly     w and the bin of every entry, no accumulation; one row out:
              the sum of the unmasked bins (Txr) and their count (Txi)
  addonly     Wx * const added into row i % nf in the rounds by row: no
              phase, bin or mask (the dWx planes still read): the
              accumulate alone
  chains2     even and odd rows into two accumulators, summed at the end
  serial      16 rounds a step, one row group a round, no
              `__match_any_sync` / `__reduce_max_sync`: full bit for bit;
              what the match buys
  noprefetch  the next step's loads issued after the adds: full bit for
              bit; what the overlap buys
  nostore     Tx of one column a block stored, (..., nf, ceil(n / cols)):
              full's Tx[..., ::cols]; what the Tx store costs
  dmarows     dmaonly with thread (c, g) = (tid % cols, tid / cols): a
              warp load reads whole rows of the block's columns (one
              128-byte line at 32 columns) where B's lane map reads 8
              bytes of each of 16 lines; the load floor without that
  walk        the row walk B and B' ran before their redesign
              (``csrc/reassign_walk.cuh``, one thread a column): full bit
              for bit by another design

Every variant runs at full's shared memory (chains2 twice), so at its
blocks an SM. The TPU's `cmponly`, `groupG` and `overlap` time its
one-hot compare and its VMEM traffic, which this kernel does not have: no
counterpart.

`ablate_reassign` also runs `full` over a batch three ways (`GRIDS`; the
probe of ``bench_reassign_batch.py``): the batch on blockIdx.y (as B and
B' take it), one 1-D grid of batch x column tiles, or one call over the
columns of all signals side by side (the planes relaid to (na, batch * n)
and back).

`ablate_reassign3` is the scatter at 3 planes (Wx and the w plane): `full`
is B bit for bit, `walk` the row walk's B.

On a CUDA tensor the wrappers launch the kernel or raise; on a CPU
tensor they run their plain versions (`ablate_reassign_plain`, the same
function in plain torch; `reassign_cuda.reassign_plain` for
`ablate_reassign3`). `LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import fft_cuda, reassign_cuda
from . import _common

__all__ = ["VARIANTS", "VARIANTS3", "GRIDS", "PARAMS", "ablate_reassign",
           "ablate_reassign_plain", "ablate_reassign3", "make_planes",
           "variant_cost", "run", "main", "LAUNCHES"]

LAUNCHES = 0

VARIANTS = ("full", "dmaonly", "binonly", "addonly", "chains2", "serial",
            "noprefetch", "nostore", "dmarows", "walk")
VARIANTS3 = ("full", "walk")
GRIDS = ("batch2d", "grid1d", "flat")
HEADLINE = dict(na=293, nf=293, n=160_000)
SMALL = dict(na=12, nf=10, n=1024)
# the log-piecewise plan of tools/ablate_reassign.py:57-59
MODE = "log-piecewise"
PARAMS = dict(vlmin0=-9.0, vlmin1=-5.0, dvl0=0.02, dvl1=0.05, idx1=160.0)
GAMMA = 1e-8              # gamma^2 = 1e-16, as the TPU probe's GAMMA2
# float32 operations per entry: w and its bin (16, as chip_smoke's B'),
# the accumulate alone (addonly: a product and two adds), the reads alone
_FLOPS = dict.fromkeys(VARIANTS, 16) | {"addonly": 3, "dmaonly": 4,
                                        "dmarows": 4}


def make_planes(device, batch, na, n, seed=0):
    """Four standard normal planes (batch, na, n) (no batch dim when
    batch is None), const of ones and Sfs of zeros (na,), made on
    `device` from `seed`."""
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (na, n) if batch is None else (batch, na, n)
    planes = [torch.randn(shape, generator=g, device=device)
              for _ in range(4)]
    return (*planes, torch.ones(na, device=device),
            torch.zeros(na, device=device))


def _to_flat(p):
    """(..., na, n) -> (na, batch * n): the signals' columns side by side."""
    na, n = p.shape[-2:]
    return p.reshape(-1, na, n).transpose(0, 1).reshape(na, -1)


def _from_flat(t, batch, n):
    """(rows, batch * n) -> batch + (rows, n)."""
    rows = t.shape[0]
    return t.reshape(rows, -1, n).transpose(0, 1).reshape(batch + (rows, n))


def _check(variant, grid):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS} (got "
                         f"{variant!r})")
    if grid not in GRIDS:
        raise ValueError(f"grid must be one of {GRIDS} (got {grid!r})")
    if grid != "batch2d" and variant != "full":
        raise ValueError(f"grid {grid!r} runs the 'full' variant only")


def _cols(nf, variant, cols):
    """Columns a block: `cols`, or the largest of 32, 16, 8 whose
    accumulators (full's, which every variant allocates; two for chains2)
    fit."""
    sets = 2 if variant == "chains2" else 1
    for c in (32, 16, 8) if cols is None else (cols,):
        if c not in (32, 16, 8):
            raise ValueError(f"cols must be 32, 16 or 8 (got {c})")
        if sets * 2 * nf * c * 4 <= reassign_cuda.MAX_SMEM:
            return c
    raise ValueError(f"nf={nf}: the {variant} accumulators do not fit "
                     "shared memory")


def _check_f32(wr):
    """The probe's kernels take float32 planes, as the TPU probe's."""
    if wr.dtype != torch.float32:
        raise ValueError(f"the P4 kernels take float32 planes (got "
                         f"{wr.dtype})")


# -- plain version --------------------------------------------------------------
def ablate_reassign_plain(wr, wi, dr, di, const, Sfs, gamma, plan_params,
                          mode, flipud, nf, transform, variant="full",
                          grid="batch2d", cols=None):
    """Plain-torch P4 (the arguments of `reassign_cuda.reassign4`): 'full',
    'serial', 'noprefetch' and 'walk' are `reassign4_plain`; 'dmaonly' and
    'dmarows' zero planes; 'binonly' the sum and count of the unmasked
    bins of each column, (..., 1, n); 'addonly' the rows Wx * const summed
    into row i % nf; 'chains2' B' of the even rows plus B' of the odd rows;
    'nostore' full's Tx[..., ::cols] (`cols` as `ablate_reassign` picks
    it). `grid` 'flat' runs on the relaid planes and relays the result
    back. Returns (Txr, Txi)."""
    _check(variant, grid)
    reassign_cuda._check_transform(transform)
    _, wr, wi, dr, di, const, Sfs = reassign_cuda._prepare4(wr, wi, dr, di,
                                                            const, Sfs)
    rest = (gamma, plan_params, mode, flipud, nf, transform)
    batch, (na, n) = wr.shape[:-2], wr.shape[-2:]
    if grid == "flat":
        out = reassign_cuda.reassign4_plain(
            *(_to_flat(p) for p in (wr, wi, dr, di)), const, Sfs, *rest)
        return tuple(_from_flat(o, batch, n) for o in out)
    if variant in ("full", "serial", "noprefetch", "walk"):
        return reassign_cuda.reassign4_plain(wr, wi, dr, di, const, Sfs,
                                             *rest)
    if variant == "nostore":
        step = _cols(nf, variant, cols)
        return tuple(t[..., ::step].contiguous() for t in
                     reassign_cuda.reassign4_plain(wr, wi, dr, di, const,
                                                   Sfs, *rest))
    if variant in ("dmaonly", "dmarows"):
        z = torch.zeros(batch + (nf, n), dtype=torch.float32,
                        device=wr.device)
        return z, z.clone()
    if variant == "binonly":
        w = reassign_cuda.phase_w(wr, wi, dr, di, Sfs, gamma, transform)
        k = reassign_cuda.bin_indices(w, mode, plan_params, flipud, nf)
        used = k >= 0
        kbins = torch.where(used, k, torch.zeros_like(k)).sum(-2, keepdim=True)
        return (kbins.to(torch.float32),
                used.sum(-2, keepdim=True).to(torch.float32))
    if variant == "addonly":
        rows = torch.arange(na, device=wr.device) % nf
        c = const[:, None]
        out = []
        for p in (wr, wi):
            t = torch.zeros(batch + (nf, n), dtype=torch.float32,
                            device=wr.device)
            out.append(t.index_add_(-2, rows, p * c))
        return tuple(out)
    even = reassign_cuda.reassign4_plain(
        wr[..., 0::2, :], wi[..., 0::2, :], dr[..., 0::2, :],
        di[..., 0::2, :], const[0::2], Sfs[0::2], *rest)
    if na < 2:
        return even
    odd = reassign_cuda.reassign4_plain(
        wr[..., 1::2, :], wi[..., 1::2, :], dr[..., 1::2, :],
        di[..., 1::2, :], const[1::2], Sfs[1::2], *rest)
    return even[0] + odd[0], even[1] + odd[1]


# -- the kernel -----------------------------------------------------------------
def _cuda(wr, wi, dr, di, const, Sfs, gamma, plan_params, mode, flipud, nf,
          transform, variant, cols, grid):
    from .. import _build
    global LAUNCHES
    batch, n = wr.shape[:-2], wr.shape[-1]
    if grid == "flat":
        out = _cuda(*(_to_flat(p) for p in (wr, wi, dr, di)), const, Sfs,
                    gamma, plan_params, mode, flipud, nf, transform, variant,
                    cols, "batch2d")
        return tuple(_from_flat(o, batch, n) for o in out)
    na = wr.shape[-2]
    B = int(np.prod(batch)) if batch else 1
    planes = [t.contiguous() for t in (wr, wi, dr, di, const, Sfs)]
    cols = _cols(nf, variant, cols)
    shape = ((1, n) if variant == "binonly" else
             (nf, -(-n // cols)) if variant == "nostore" else (nf, n))
    outs = [torch.empty(batch + shape, dtype=torch.float32,
                        device=wr.device) for _ in range(2)]
    plan = reassign_cuda._plan_floats(mode, plan_params)
    err = _build.lib().ssq_ablate_reassign(
        *(t.data_ptr() for t in planes), B, na, n, nf,
        reassign_cuda.TRANSFORMS[transform], reassign_cuda.MODES[mode],
        int(bool(flipud)), reassign_cuda._gamma2(gamma), *plan, cols,
        VARIANTS.index(variant),
        int(grid == "grid1d"), *(o.data_ptr() for o in outs),
        fft_cuda._stream(wr.device))
    _build.check(err, f"ablate_reassign kernel ({variant}, {grid})")
    LAUNCHES += 1
    return tuple(outs)


def ablate_reassign(wr, wi, dr, di, const, Sfs, gamma, plan_params, mode,
                    flipud, nf, transform, variant="full", cols=None,
                    grid="batch2d"):
    """P4: B''s scatter (the arguments of `reassign_cuda.reassign4`) as
    `variant`, at `cols` columns a block (default: the most whose
    accumulators fit), over its batch on `grid` ('batch2d', 'grid1d' or
    'flat'; the last two with 'full' only). Returns (Txr, Txi), each
    (..., nf, n) ('binonly': (..., 1, n); 'nostore': (..., nf, ceil(n /
    cols))). A CUDA tensor launches the kernel, a CPU tensor runs
    `ablate_reassign_plain`."""
    _check(variant, grid)
    reassign_cuda._check_transform(transform)
    device, wr, wi, dr, di, const, Sfs = reassign_cuda._prepare4(
        wr, wi, dr, di, const, Sfs)
    args = (wr, wi, dr, di, const, Sfs, gamma, plan_params, mode, flipud, nf,
            transform)
    if device.type == "cpu":
        return ablate_reassign_plain(*args, variant, grid,
                                     _cols(nf, variant, cols))
    if device.type != "cuda":
        raise ValueError(f"ablate_reassign: unsupported device {device}")
    _check_f32(wr)
    return _cuda(*args, variant, cols, grid)


def ablate_reassign3(wr, wi, w, const, plan_params, mode, flipud, nf,
                     cols=None, variant="full"):
    """P4 at 3 planes (the arguments of `reassign_cuda.reassign`): 'full'
    is B's scatter (B bit for bit), 'walk' the row walk's B, at `cols`
    columns a block (default: the most whose accumulator fits). Returns
    (Txr, Txi), each (..., nf, n). A CUDA tensor launches the kernel, a
    CPU tensor runs `reassign_cuda.reassign_plain`."""
    global LAUNCHES
    if variant not in VARIANTS3:
        raise ValueError(f"variant must be one of {VARIANTS3} (got "
                         f"{variant!r})")
    device, wr, wi, w, const = reassign_cuda._prepare(wr, wi, w, const)
    cols = _cols(nf, "full", cols)
    if device.type == "cpu":
        return reassign_cuda.reassign_plain(wr, wi, w, const, plan_params,
                                            mode, flipud, nf)
    if device.type != "cuda":
        raise ValueError(f"ablate_reassign3: unsupported device {device}")
    _check_f32(wr)
    out = reassign_cuda._launch(
        "ssq_ablate_reassign3", [wr, wi, w], [const],
        [reassign_cuda.MODES[mode], int(bool(flipud))],
        reassign_cuda._plan_floats(mode, plan_params), nf,
        f"ablate_reassign3 kernel ({variant})",
        per_block=[cols, VARIANTS3.index(variant)])
    LAUNCHES += 1
    return out


# -- the probe ------------------------------------------------------------------
def variant_cost(variant, B, na, nf, n, cols=32):
    """(bytes, float32 operations) of a variant over a batch of B: the four
    planes and the two row vectors read once, the Tx planes (one row for
    binonly, one column of `cols` for nostore) written once."""
    out = (n if variant == "binonly" else
           nf * -(-n // cols) if variant == "nostore" else nf * n)
    nbytes = 4 * B * na * n * 4 + 2 * na * 4 + 2 * B * out * 4
    return nbytes, float(_FLOPS[variant] * B * na * n)


def run(device, reps=5, size=None, seed=0):
    """Time `full` at 32, 16 and 8 columns a block and every other variant
    at the most columns its accumulators allow (B''s own at the headline)
    on `device` (the headline on CUDA, `SMALL` on the CPU unless `size` is
    given): rows (name, ms, bytes, flops, bound_ms, bound_by)."""
    size = size or (HEADLINE if device.type == "cuda" else SMALL)
    na, nf, n = size["na"], size["nf"], size["n"]
    planes = make_planes(device, None, na, n, seed)
    rest = (GAMMA, PARAMS, MODE, True, nf, "cwt")
    cases = [(f"full/{c}", "full", c) for c in (32, 16, 8)]
    cases += [(v, v, _cols(nf, v, None)) for v in VARIANTS[1:]]
    rows = []
    for name, v, c in cases:
        ms = _common.time_ms(lambda: ablate_reassign(*planes, *rest, v, c),
                             device, reps)
        rows.append(_common.row(name, ms, *variant_cost(v, 1, na, nf, n,
                                                        c)))
    return rows


def main(argv=None):
    a = _common.parse_args(argv, "Ablation of kernels B and B' (probe P4)")
    device = _common.pick_device(a.device)
    rows = run(device, a.K)
    _common.print_rows(rows, _common.card_line(device))
    return rows


if __name__ == "__main__":
    main()
