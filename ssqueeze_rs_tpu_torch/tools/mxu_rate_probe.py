"""The in-kernel tensor-core rate by shape and precision, with independent
chains, and the shared-memory rate: probe J5 (``csrc/rate_probe.cu``), the
counterpart of the TPU probe ``tools/mxu_rate_probe.py``.

    python -m ssqueeze_rs_tpu_torch.tools.mxu_rate_probe [K] [--chains] [--device cpu]

Functions, with A_s the s-th (m, k) slice of A's rows (float32 in,
float32 out):

  dot_probe         out = sum_{i<R} A_{i % 2} @ B, with the operands in
                    `precision`: 'bf16' (rounded to nearest even), 'tf32'
                    (cvt.rna), '3xtf32' (hi = tf32(v), lo = tf32(v - hi);
                    hi lo + lo hi + hi hi: the card's accurate float32
                    product on the tensor cores; the TPU probe's 'f32')
  copy_probe        out = sum_{i<R} A_{i % 2}, through shared memory
  dot_probe_chains  out_c = sum_{i<R} A_{(i + c) % (C + 1)} @ B for c < C,
                    bf16: the chains in pairs, one a warpgroup

The TPU ran GRID sequential steps, each computing the whole output again;
here they are GRID copies of the grid, each writing the same values, so
the rate is GRID * R * 2mkn over the time (the shared-memory rate GRID *
R * 3 * m * n * 4 bytes over it). The shapes are the TPU probe's: nine
(m, k, n) for the dots in each precision, four (m, n) for the copy, C in
1, 2, 4, 8, 16, 24 at two shapes for the chains (`--chains`).

Each row has the device time (CUDA events, median of K after a warm-up)
and the host wall time a call over K back-to-back calls ended by one
synchronize (what the TPU probe timed), with the rate reached; the dots
and chains also the time of their operand pre-pass alone (`prep_ms`, in
the call's time too).

On the card a dot or chains call is two launches: the pre-pass
(`prepass`, modelled by `prepass_plain`) writes A's slices and B
transposed, K-major and rounded to the precision, k padded with zeros to
`_prep_layout`'s kp, into scratch the wrapper allocates; the products
then read them through TMA (`csrc/rate_probe.cu`).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain version (`*_plain`). `LAUNCHES_DOT`,
`LAUNCHES_COPY` and `LAUNCHES_CHAINS` count kernel launches.
"""
from __future__ import annotations

import torch

from ..ops import fft_cuda
from . import _common

__all__ = ["PRECISIONS", "CHAINS", "SHAPES", "COPY_SHAPES", "CHAIN_SHAPES",
           "round_tf32", "prepass", "prepass_plain", "dot_probe",
           "dot_probe_plain", "copy_probe",
           "copy_probe_plain", "dot_probe_chains", "dot_probe_chains_plain",
           "dot_cost", "copy_cost", "chains_cost", "operand_bytes", "run",
           "run_chains",
           "main", "LAUNCHES_DOT", "LAUNCHES_COPY", "LAUNCHES_CHAINS"]

LAUNCHES_DOT = 0
LAUNCHES_COPY = 0
LAUNCHES_CHAINS = 0

GRID = 32
R = 8
PRECISIONS = ("bf16", "tf32", "3xtf32")
CHAINS = (1, 2, 4, 8, 16, 24)
# tools/mxu_rate_probe.py:98-105, 123, 173
SHAPES = ((256, 256, 256), (512, 512, 512), (1024, 1024, 1024),
          (1024, 512, 512), (512, 1024, 640), (1024, 1536, 512),
          (1024, 512, 1536), (128, 512, 512), (2048, 512, 512))
COPY_SHAPES = ((512, 512), (1024, 512), (512, 4096), (1024, 4096))
CHAIN_SHAPES = ((512, 512, 512), (1024, 512, 512))
SMALL = dict(shapes=((16, 32, 16), (32, 64, 48)), copy=((16, 32), (24, 64)),
             chains=((16, 32, 16),), C=(1, 2, 4), grid=2)
_RATE = {"bf16": _common.BF16_FLOP_S, "tf32": _common.TF32_FLOP_S,
         "3xtf32": _common.TF32_FLOP_S}


def round_tf32(x):
    """x (float32) rounded to TF32 as cvt.rna.tf32.f32 does: 10 mantissa
    bits, to nearest with ties away from zero, the low 13 bits zero."""
    u = x.to(torch.float32).contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def _product(a, b, precision):
    """a @ b (float32 sums) of the operands in `precision`."""
    if precision == "bf16":
        f = lambda t: t.to(torch.bfloat16).to(torch.float32)
        return f(a) @ f(b)
    ah, bh = round_tf32(a), round_tf32(b)
    if precision == "tf32":
        return ah @ bh
    return ah @ round_tf32(b - bh) + round_tf32(a - ah) @ bh + ah @ bh


def _check(A, B, m, slices, precision):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS} (got "
                         f"{precision!r})")
    if A.dim() != 2 or (B is not None and B.dim() != 2):
        raise ValueError("A and B must be matrices")
    if m < 1 or A.shape[0] != slices * m:
        raise ValueError(f"A must have {slices} x m = {slices * m} rows (got "
                         f"{A.shape[0]})")
    if B is not None and A.shape[1] != B.shape[0]:
        raise ValueError(f"A's columns ({A.shape[1]}) must be B's rows "
                         f"({B.shape[0]})")
    if B is not None and B.device != A.device:
        raise ValueError("A and B must be on one device")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {A.device}")


def _sum_slices(parts, R, offset=0):
    """sum_{i<R} parts[(i + offset) % len(parts)], summed in order from 0."""
    acc = torch.zeros_like(parts[0])
    for i in range(R):
        acc = acc + parts[(i + offset) % len(parts)]
    return acc


# -- plain versions ------------------------------------------------------------
def dot_probe_plain(A, B, m, precision="bf16", R=R):
    """Plain-torch dot_probe: the two slices' products, summed R times."""
    _check(A, B, m, 2, precision)
    A, B = A.to(torch.float32), B.to(torch.float32)
    return _sum_slices([_product(A[s * m:(s + 1) * m], B, precision)
                        for s in (0, 1)], R)


def copy_probe_plain(A, m, R=R):
    """Plain-torch copy_probe: the two slices summed R times in order."""
    _check(A, None, m, 2, "bf16")
    A = A.to(torch.float32)
    return _sum_slices([A[:m], A[m:]], R)


def dot_probe_chains_plain(A, B, m, C, R=R):
    """Plain-torch dot_probe_chains: (C, m, n)."""
    _check(A, B, m, C + 1, "bf16")
    A, B = A.to(torch.float32), B.to(torch.float32)
    prods = [_product(A[s * m:(s + 1) * m], B, "bf16") for s in range(C + 1)]
    return torch.stack([_sum_slices(prods, R, c) for c in range(C)])


def _prep_layout(m, k, n, precision, C=1):
    """(slices, kp, bytes) of the products' operands: A's slices (slices,
    m, kp) and B^T (n, kp), bf16 or float32, k padded to kp, a multiple of
    the TMA box (one 128-byte line: 64 bf16 or 32 float); 3xtf32 keeps hi
    and lo of both. The scratch holds A hi, B hi, A lo, B lo in turn."""
    slices = 2 if C == 1 else C + 1
    size = 2 if precision == "bf16" else 4
    kp = -(-k // (128 // size)) * (128 // size)
    parts = 2 if precision == "3xtf32" else 1
    return slices, kp, parts * (slices * m + n) * kp * size


def _split_scratch(scratch, m, k, n, precision, C):
    """The views (A hi, B hi, A lo, B lo) of a pre-pass's scratch (the lo
    ones None but for 3xtf32)."""
    slices, kp, _ = _prep_layout(m, k, n, precision, C)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    size = 2 if precision == "bf16" else 4
    views, at = [], 0
    for shape in ((slices, m, kp), (n, kp)) * (1 + (precision == "3xtf32")):
        nbytes = size * shape[0] * shape[1] * (kp if len(shape) == 3 else 1)
        views.append(scratch[at:at + nbytes].view(dtype).view(shape))
        at += nbytes
    return tuple(views + [None, None])[:4]


def prepass_plain(A, B, m, precision="bf16", C=1):
    """Plain-torch model of the products' operand pre-pass: (A hi, B hi,
    A lo, B lo), A's (slices, m, kp), B's transposed (n, kp), k padded
    with zeros to `_prep_layout`'s kp; bf16 by `.to(torch.bfloat16)`,
    tf32 by `round_tf32`, 3xtf32 as hi = round_tf32(v) and lo =
    round_tf32(v - hi) (lo None otherwise)."""
    slices, kp, _ = _prep_layout(m, B.shape[0], B.shape[1], precision, C)
    _check(A, B, m, slices, precision)
    pad = lambda t: torch.nn.functional.pad(t.to(torch.float32),
                                            (0, kp - t.shape[-1]))
    a, b = pad(A).view(slices, m, kp), pad(B.t())
    if precision == "bf16":
        return a.to(torch.bfloat16), b.to(torch.bfloat16), None, None
    ah, bh = round_tf32(a), round_tf32(b)
    if precision == "tf32":
        return ah, bh, None, None
    return ah, bh, round_tf32(a - ah), round_tf32(b - bh)


# -- the kernels ---------------------------------------------------------------
def _operands(A, B, m, precision, C):
    """A and B as contiguous float32, and the scratch the pre-pass writes
    the products' operands into."""
    A = A.to(torch.float32).contiguous()
    B = B.to(torch.float32).contiguous()
    scratch = torch.empty(_prep_layout(m, *B.shape, precision, C)[2],
                          dtype=torch.uint8, device=A.device)
    return A, B, scratch


def _dot_cuda(A, B, m, R, grid, precision, C):
    from .. import _build
    A, B, scratch = _operands(A, B, m, precision, C)
    k, n = B.shape
    out = torch.empty((C, m, n), dtype=torch.float32, device=A.device)
    err = _build.lib().ssq_rate_dot(
        A.data_ptr(), B.data_ptr(), scratch.data_ptr(), out.data_ptr(), m, k,
        n, int(R), int(grid), PRECISIONS.index(precision), C,
        fft_cuda._stream(A.device))
    _build.check(err, f"rate_dot kernel ({precision}, C={C})")
    return out


def prepass(A, B, m, precision="bf16", C=1):
    """The products' operand pre-pass alone (its own launch, not counted
    as a dot): (A hi, B hi, A lo, B lo) as `prepass_plain` gives them. A
    CUDA tensor launches the kernel, a CPU tensor runs `prepass_plain`."""
    if C not in CHAINS or (C > 1 and precision != "bf16"):
        raise ValueError(f"C must be one of {CHAINS}, chains in bf16 (got "
                         f"C={C}, {precision!r})")
    _check(A, B, m, 2 if C == 1 else C + 1, precision)
    if A.device.type == "cpu":
        return prepass_plain(A, B, m, precision, C)
    from .. import _build
    A, B, scratch = _operands(A, B, m, precision, C)
    k, n = B.shape
    err = _build.lib().ssq_rate_prep(
        A.data_ptr(), B.data_ptr(), scratch.data_ptr(), m, k, n,
        PRECISIONS.index(precision), C, fft_cuda._stream(A.device))
    _build.check(err, f"rate_dot pre-pass ({precision}, C={C})")
    return _split_scratch(scratch, m, k, n, precision, C)


def dot_probe(A, B, m, precision="bf16", R=R, grid=GRID):
    """J5 dot: A (2m, k), B (k, n) -> (m, n), the product in `precision`,
    computed by `grid` copies of the grid. A CUDA tensor launches the
    kernel, a CPU tensor runs `dot_probe_plain`."""
    global LAUNCHES_DOT
    _check(A, B, m, 2, precision)
    if A.device.type == "cpu":
        return dot_probe_plain(A, B, m, precision, R)
    out = _dot_cuda(A, B, m, R, grid, precision, 1)[0]
    LAUNCHES_DOT += 1
    return out


def copy_probe(A, m, R=R, grid=GRID):
    """J5 copy: A (2m, n) -> (m, n), the slices summed R times through
    shared memory by `grid` copies of the grid. A CUDA tensor launches the
    kernel, a CPU tensor runs `copy_probe_plain`."""
    global LAUNCHES_COPY
    _check(A, None, m, 2, "bf16")
    if A.device.type == "cpu":
        return copy_probe_plain(A, m, R)
    from .. import _build
    n = A.shape[1]
    if (m * n) % 4:
        raise ValueError(f"copy_probe on CUDA needs m * n a multiple of 4 "
                         f"(got {m} x {n})")
    A = A.to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=A.device)
    err = _build.lib().ssq_rate_copy(A.data_ptr(), out.data_ptr(), m, n,
                                     int(R), int(grid),
                                     fft_cuda._stream(A.device))
    _build.check(err, "rate_copy kernel")
    LAUNCHES_COPY += 1
    return out


def dot_probe_chains(A, B, m, C, R=R, grid=GRID):
    """J5 chains: A ((C + 1) m, k), B (k, n) -> (C, m, n), bf16 operands,
    C in `CHAINS`. A CUDA tensor launches the kernel, a CPU tensor runs
    `dot_probe_chains_plain`."""
    global LAUNCHES_CHAINS
    if C not in CHAINS:
        raise ValueError(f"C must be one of {CHAINS} (got {C})")
    _check(A, B, m, C + 1, "bf16")
    if A.device.type == "cpu":
        return dot_probe_chains_plain(A, B, m, C, R)
    out = _dot_cuda(A, B, m, R, grid, "bf16", C)
    LAUNCHES_CHAINS += 1
    return out


# -- the probe -----------------------------------------------------------------
def dot_cost(m, k, n, precision, grid=GRID, R=R, C=1):
    """(bytes, operations, rate): A's slices, B and out once; the grid's
    GRID * R * C products (3xtf32: three TF32 products each) at the
    tensor cores' rate of the precision."""
    slices = 2 if C == 1 else C + 1
    nbytes = 4 * (slices * m * k + k * n + C * m * n)
    per = 3 if precision == "3xtf32" else 1
    return nbytes, float(grid * R * C * 2 * m * k * n * per), _RATE[precision]


def operand_bytes(m, k, n, precision, C=1, grid=GRID, R=R):
    """Bytes the product kernel's blocks read into shared memory in one
    call (not the bound's: every block reads its own). A block takes a
    128 x 128 output tile of the dot (128 x 64 in 3xtf32) or a 64 x 128
    tile of a chain pair; at each of its R steps it reads two 64-row A
    boxes and the B box over kp (hi and lo in 3xtf32), for every tile,
    chain pair and copy."""
    kp = _prep_layout(m, k, n, precision, C)[1]
    size = 2 if precision == "bf16" else 4
    parts = 2 if precision == "3xtf32" else 1
    bn = 64 if precision == "3xtf32" else 128
    bm = 128 if C == 1 else 64
    blocks = -(-m // bm) * -(-n // bn) * (1 if C == 1 else C // 2) * grid
    return blocks * R * (128 + bn) * kp * size * parts


def copy_cost(m, n, grid=GRID, R=R):
    """(bytes, float32 operations): A and out once; one add an element a
    pass of each copy."""
    return 4 * 3 * m * n, float(grid * R * m * n)


def chains_cost(m, k, n, C, grid=GRID, R=R):
    return dot_cost(m, k, n, "bf16", grid, R, C)


def _note(device, text):
    """The rate reached, printed for a device run only (a CPU run's host
    times are no device rate)."""
    return dict(note=text) if device.type == "cuda" else {}


def _timed(fn, device, reps):
    return _common.time_ms(fn, device, reps), _common.wall_ms(fn, device,
                                                                reps)


def _prep_ms(A, B, m, precision, C, device, reps, ms, grid, R):
    """The pre-pass's own time in a dot or chains call, and the rate the
    product blocks read their operands at (a device run only)."""
    if device.type != "cuda":
        return {}
    k, n = B.shape
    return dict(prep_ms=_common.time_ms(
        lambda: prepass(A, B, m, precision, C), device, reps),
        operand_tb_s=operand_bytes(m, k, n, precision, C, grid, R) / ms /
        1e9)


def run(device, reps=5, shapes=None, copy_shapes=None, grid=None, R=R,
        seed=0):
    """Time dot_probe at each shape in each precision, then copy_probe at
    each of its shapes (the TPU probe's on CUDA, `SMALL` on the CPU unless
    given): rows (name, ms, wall_ms, bytes, flops, bound_ms, bound_by,
    tflop_s or smem_tb_s)."""
    small = device.type != "cuda"
    shapes = shapes or (SMALL["shapes"] if small else SHAPES)
    copy_shapes = copy_shapes or (SMALL["copy"] if small else COPY_SHAPES)
    grid = grid or (SMALL["grid"] if small else GRID)
    g = _common.generator(device, seed)
    rows = []
    for m, k, n in shapes:
        A, B = _common.randn(g, 2 * m, k), _common.randn(g, k, n)
        for p in PRECISIONS:
            ms, wall = _timed(lambda: dot_probe(A, B, m, p, R, grid), device,
                              reps)
            nbytes, flops, rate = dot_cost(m, k, n, p, grid, R)
            tf = flops / (3 if p == "3xtf32" else 1) / ms / 1e9
            rows.append(_common.row(
                f"dot {p} ({m},{k},{n})", ms, nbytes, flops, rate,
                wall_ms=wall, tflop_s=tf,
                us_per_dot=ms * 1e3 / (grid * R),
                **_prep_ms(A, B, m, p, 1, device, reps, ms, grid, R),
                **_note(device, f"{tf:.1f} TFLOP/s")))
    for m, n in copy_shapes:
        A = _common.randn(g, 2 * m, n)
        ms, wall = _timed(lambda: copy_probe(A, m, R, grid), device, reps)
        tb = grid * R * 3 * m * n * 4 / ms / 1e9
        rows.append(_common.row(f"copy f32 ({m},{n})", ms,
                                *copy_cost(m, n, grid, R), wall_ms=wall,
                                smem_tb_s=tb,
                                **_note(device, f"{tb:.2f} TB/s on chip")))
    return rows


def run_chains(device, reps=5, shapes=None, chains=None, grid=None, R=R,
               seed=0):
    """Time dot_probe_chains for each C at each shape: rows with the time
    a dot (us) and the rate."""
    small = device.type != "cuda"
    shapes = shapes or (SMALL["chains"] if small else CHAIN_SHAPES)
    chains = chains or (SMALL["C"] if small else CHAINS)
    grid = grid or (SMALL["grid"] if small else GRID)
    g = _common.generator(device, seed)
    rows = []
    for m, k, n in shapes:
        B = _common.randn(g, k, n)
        for C in chains:
            A = _common.randn(g, (C + 1) * m, k)
            ms, wall = _timed(lambda: dot_probe_chains(A, B, m, C, R, grid),
                              device, reps)
            nbytes, flops, rate = chains_cost(m, k, n, C, grid, R)
            tf = flops / ms / 1e9
            rows.append(_common.row(
                f"chains C={C} ({m},{k},{n})", ms, nbytes, flops, rate,
                wall_ms=wall, tflop_s=tf,
                us_per_dot=ms * 1e3 / (grid * R * C),
                **_prep_ms(A, B, m, "bf16", C, device, reps, ms, grid, R),
                **_note(device, f"{ms * 1e3 / (grid * R * C):.3f} us a dot, "
                                f"{tf:.1f} TFLOP/s")))
    return rows


def main(argv=None):
    a = _common.parse_args(
        argv, "Tensor-core and shared-memory rates (probe J5)",
        flags=(("--chains", "time C independent chains "
                            "(dot_probe_chains) instead"),))
    device = _common.pick_device(a.device)
    rows = (run_chains if a.chains else run)(device, a.K)
    _common.print_rows(rows, _common.card_line(device), width=28)
    return rows


if __name__ == "__main__":
    main()
