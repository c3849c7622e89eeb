"""Does a copy from device memory overlap a serial tensor-core chain? Probe
J7 (``csrc/dma_overlap.cu``), the counterpart of the TPU probe
``tools/dma_overlap_probe.py``.

    python -m ssqueeze_rs_tpu_torch.tools.dma_overlap_probe [K] [--device cpu]

Function (x (M, M) float32):

  x = f32(bf16(a))
  R times:  dots:   D times  x = (bf16(x) @ bf16(b)) * 1e-3  (float32 sums)
            copies: the chunk src[r CH : (r + 1) CH] (CH x M float32, 8 MB
                    at the probe's shape) copied on chip, issued before the
                    dots and waited on after them; x = x + src[r CH, 0] 1e-30
  out = x[:8]

as `copies`, `dots` or `both` (R = 64, CH = 4096, D = 3, M = 512: 512 MB
of copies racing 192 serial (512, 512, 512) bf16 products). The verdict
is the TPU probe's: `both` under 0.75 times the sum of the two floors is
an overlap, else the two add up.

The TPU probe's b is standard normal, which shrinks x by ~2e-2 a product
until after 192 of them only the copy term is left (about 1e-30). The
inputs here (`make_inputs`) scale b by 1e3 / sqrt(M) so that x stays of
order 1 through the chain; the function is the same.

The kernel runs each group of 64 rows of x as a thread-block cluster of
`cluster` blocks (8, or 16 where M is a multiple of 128), block c owning
M / cluster columns of x and of bf16(b): `wgmma` products on its
resident columns of b, the rounded columns sent to the cluster's other
blocks through their shared memory after each product. Every block copies
its 16-byte-aligned share of each chunk by TMA. `plan` mirrors the
launch (blocks, columns, copy shares, ring slots, shared memory);
`kernel_plan` reads the kernel's own on the card.

Each row has the device time (CUDA events, median of K after a warm-up)
and the host wall time a call over K back-to-back calls ended by one
synchronize (what the TPU probe timed). On a CUDA tensor the wrapper
launches the kernel or raises; on a CPU tensor it runs its plain version
(`dma_overlap_plain`). `LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from ..ops import fft_cuda
from . import _common

__all__ = ["VARIANTS", "HEADLINE", "SMALL", "CLUSTER", "CLUSTERS",
           "b_operand", "dma_overlap", "dma_overlap_plain", "plan",
           "kernel_plan", "make_inputs", "variant_cost", "verdict", "run",
           "main", "LAUNCHES"]

LAUNCHES = 0

VARIANTS = ("copies", "dots", "both")
# tools/dma_overlap_probe.py:41-44
HEADLINE = dict(R=64, CH=4096, D=3, M=512)
SMALL = dict(R=3, CH=8, D=3, M=128)
CLUSTERS = (8, 16)
CLUSTER = 8          # the kernel's default (csrc/dma_overlap.cu kCluster)
# the kernel's constants (csrc/dma_overlap.cu)
_ROWS, _PIECE, _MAX_SLOTS, _SMEM_MAX, _BARS = 64, 8192, 8, 232448, 12


def _check(src, a, b, variant, R, CH):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS} (got "
                         f"{variant!r})")
    M = a.shape[0]
    if a.shape != (M, M) or b.shape != (M, M):
        raise ValueError(f"a and b must be (M, M) (got {tuple(a.shape)}, "
                         f"{tuple(b.shape)})")
    if src.dim() != 2 or src.shape[1] != M or src.shape[0] < R * CH:
        raise ValueError(f"src must be (>= R * CH = {R * CH}, {M}) (got "
                         f"{tuple(src.shape)})")
    if M < 8:
        raise ValueError("M must be at least 8 (out is x[:8])")
    dev = a.device
    if src.device != dev or b.device != dev:
        raise ValueError("src, a and b must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def dma_overlap_plain(src, a, b, variant="both", R=64, CH=4096, D=3):
    """Plain-torch J7: the loop as written, (8, M)."""
    _check(src, a, b, variant, R, CH)
    x, b16 = _bf16(a.to(torch.float32)), _bf16(b.to(torch.float32))
    scale = torch.tensor(1e-3, dtype=torch.float32, device=a.device)
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=a.device)
    for r in range(R):
        if variant != "copies":
            for _ in range(D):
                x = (_bf16(x) @ b16) * scale
        if variant != "dots":
            x = x + src[r * CH, 0].to(torch.float32) * tiny
    return x[:8].clone()


def b_operand(b):
    """The kernel's operand: bf16(b) transposed, (M, M) bfloat16 with
    [n, k] = bf16(b[k, n]). `dma_overlap` makes it from b at each call
    unless it is given, as `run` does so that a timed call is the probe
    kernel alone."""
    return b.to(torch.bfloat16).t().contiguous()


def _kernel_shape(M, cluster):
    if M % 64 or not 64 <= M <= 512:
        raise ValueError(f"the kernel takes M a multiple of 64 up to 512 "
                         f"(got {M})")
    if cluster not in CLUSTERS:
        raise ValueError(f"cluster must be one of {CLUSTERS} (got "
                         f"{cluster!r})")


def plan(M, CH, cluster=CLUSTER):
    """The kernel's launch for (M, CH) at `cluster` (`plan` in
    csrc/dma_overlap.cu): `cluster` blocks a group of 64 rows (taken down
    to 8 where M is not a multiple of 8 * cluster), `n` columns a block
    (block c: columns [c n, (c + 1) n)), `blocks` in all, each block's
    share [lo, hi) of a chunk's CH M 4 bytes (16-byte units split evenly),
    its ring `slots` of 8 KB and its dynamic shared memory `smem`."""
    _kernel_shape(M, cluster)
    C = cluster
    while M % (8 * C):
        C //= 2
    n, G = M // C, M // _ROWS * C
    fixed = 1024 + M * n * 2 + 2 * _ROWS * M * 2 + _BARS * 8
    slots = min(_MAX_SLOTS, (_SMEM_MAX - fixed) // _PIECE)
    units = CH * M * 4 // 16
    shares = [(b * units // G * 16, (b + 1) * units // G * 16)
              for b in range(G)]
    return dict(cluster=C, n=n, blocks=G, groups=M // _ROWS, slots=slots,
                smem=fixed + slots * _PIECE,
                columns=[(c * n, (c + 1) * n) for c in range(C)],
                shares=shares)


def kernel_plan(M, cluster=CLUSTER):
    """The kernel's own plan on the current CUDA device
    (`ssq_dma_overlap_plan`): cluster, n, blocks, slots, smem and `fit`,
    the clusters the card holds at once."""
    import ctypes
    from .. import _build
    _kernel_shape(M, cluster)
    v = (ctypes.c_int * 6)()
    _build.check(_build.lib().ssq_dma_overlap_plan(M, int(cluster), v),
                 "dma_overlap plan")
    return dict(zip(("cluster", "n", "blocks", "slots", "smem", "fit"),
                    list(v)))


def _aligned(t):
    """t float32 and contiguous at a 16-byte aligned address (TMA)."""
    t = t.to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def dma_overlap(src, a, b, variant="both", R=64, CH=4096, D=3, bT=None,
                cluster=CLUSTER):
    """J7: the copies racing the chain, as `variant`; src (>= R CH, M), a,
    b (M, M) -> (8, M). A CUDA tensor launches the kernel (M a multiple of
    64 up to 512) on `bT`, `b_operand(b)` when not given, in clusters of
    `cluster` blocks (`plan`); a CPU tensor runs `dma_overlap_plain`."""
    _check(src, a, b, variant, R, CH)
    if a.device.type == "cpu":
        return dma_overlap_plain(src, a, b, variant, R, CH, D)
    M = a.shape[0]
    _kernel_shape(M, cluster)
    bT = b_operand(b) if bT is None else bT
    if (bT.shape != (M, M) or bT.dtype != torch.bfloat16
            or bT.device != a.device or not bT.is_contiguous()
            or bT.data_ptr() % 16):
        raise ValueError("bT must be b_operand(b): contiguous (M, M) "
                         "bfloat16 on a's device, 16-byte aligned")
    from .. import _build
    global LAUNCHES
    src, a = _aligned(src), a.to(torch.float32).contiguous()
    out = torch.empty((8, M), dtype=torch.float32, device=a.device)
    err = _build.lib().ssq_dma_overlap_cluster(
        src.data_ptr(), a.data_ptr(), bT.data_ptr(), out.data_ptr(), M,
        int(R), int(D), int(CH), VARIANTS.index(variant) + 1, int(cluster),
        fft_cuda._stream(a.device))
    _build.check(err, f"dma_overlap kernel ({variant})")
    LAUNCHES += 1
    return out


def make_inputs(device, R, CH, M, seed=0):
    """src (R CH, M), a (M, M) standard normal and b (M, M) normal of
    standard deviation 1e3 / sqrt(M) (x stays of order 1), made on
    `device` from `seed`."""
    g = _common.generator(device, seed)
    return (_common.randn(g, R * CH, M), _common.randn(g, M, M),
            _common.randn(g, M, M, scale=1e3 / math.sqrt(M)))


def variant_cost(variant, R, CH, D, M):
    """(bytes, operations, rate): a, b and out once, and the chunks
    (copies, both); the R D products at the tensor cores' bf16 rate
    (dots, both)."""
    nbytes = 4 * (2 * M * M + 8 * M)
    if variant != "dots":
        nbytes += 4 * R * CH * M
    flops = 0.0 if variant == "copies" else float(R * D * 2 * M ** 3)
    return nbytes, flops, _common.BF16_FLOP_S


def verdict(ms):
    """The TPU probe's reading of {variant: ms}: (sum of the floors, their
    max, 'OVERLAPPABLE' if both < 0.75 sum else 'ADDITIVE')."""
    s = ms["copies"] + ms["dots"]
    return (s, max(ms["copies"], ms["dots"]),
            "OVERLAPPABLE" if ms["both"] < 0.75 * s else "ADDITIVE")


def run(device, reps=5, size=None, seed=0):
    """Time the three variants on `device` (HEADLINE on CUDA, SMALL on the
    CPU unless `size` is given): rows (name, ms, wall_ms, bytes, flops,
    bound_ms, bound_by)."""
    size = size or (HEADLINE if device.type == "cuda" else SMALL)
    R, CH, D, M = (size[k] for k in ("R", "CH", "D", "M"))
    src, a, b = make_inputs(device, R, CH, M, seed)
    bT = b_operand(b) if device.type == "cuda" else None
    rows = []
    for v in VARIANTS:
        fn = lambda: dma_overlap(src, a, b, v, R, CH, D, bT)
        ms = _common.time_ms(fn, device, reps)
        rows.append(_common.row(v, ms, *variant_cost(v, R, CH, D, M),
                                wall_ms=_common.wall_ms(fn, device, reps)))
    return rows


def main(argv=None):
    a = _common.parse_args(argv, "Copy / tensor-core overlap (probe J7)")
    device = _common.pick_device(a.device)
    rows = run(device, a.K)
    card = _common.card_line(device)
    _common.print_rows(rows, card)
    for clock in ("ms", "wall_ms"):
        s, m, word = verdict({r["name"]: r[clock] for r in rows})
        both = rows[-1][clock]
        print(f"{clock}: sum(floors) {s:.3f} ms, max(floors) {m:.3f} ms, "
              f"both {both:.3f} ms -> {word}  | {card}", flush=True)
    return rows


if __name__ == "__main__":
    main()
