"""Where kernel D's time goes: probes P1-P3 (``csrc/ablate_cwt.cu``), the
counterparts of the TPU probe ``tools/ablate_cwt_kernel.py``.

    python -m ssqueeze_rs_tpu_torch.tools.ablate_cwt_kernel [K] [--device cpu]

Kernel D with the derivative as the card runs it (its launch pair
``cwt_d_stage1`` / ``cwt_d_stage2`` of ``csrc/cwt_pair.cuh`` on the
register-radix core ``fft_radix.cuh``, rows in chunks whose intermediate
Y stays in L2) at the cwt headline: 293 rows, M = 2^18 = 512 x 512,
160 000 kept columns, random Pw, x, xig and Nyquist values from a seed.
Every variant below but full and nochunk computes wrong math by design
and keeps the memory traffic of what it does not remove, so (full -
variant) is the cost of what it removed:

  P1 `ablate_cwt` (the TPU `_make_kernel(R, off, ablate)`): D's launches
  with parts taken out (the loader's, the store's and the core's flags).
    full       D itself: `fft_cuda.cwt_fused(..., derivative=True)` bit
               for bit
    nostage1   launch 1's radix passes skipped (load, twiddle, Y store
               kept)
    nostage2   launch 2's radix passes skipped
    nofft      both (the TPU `nodots`)
    notwiddle  Y stored without the twiddle multiply
    noexch     every pass on its lane's own registers, the shared-memory
               exchanges between passes skipped, the barriers kept (the
               TPU `nolayout`)
    yonly      launch 1 copies Z and dZ to Y, launch 2 copies Y to the
               planes: the launch pair's memory floor, Y in L2
    noout      full compute, one column of each row stored
    overlap    full compute with Pw read once a block
    nochunk    full over one chunk of all rows: Y (1.23 GB at the
               headline) through device memory; D's planes bit for bit
  P2 `copy_floor` (the TPU `run_dma`): every Pw row read once into the
  first K columns of 4 (`dmaonly`) or 1 (`dma1`) planes of (rows, L), the
  rest zero; `dmanoin` writes zero planes and reads nothing; `dmarb8`
  takes 8 rows a work item. A persistent kernel moves every byte by TMA
  bulk copies (Pw rows into a shared-memory ring, bulk stores to the
  planes, the zero tails from a zeroed tile). Beside it `copy_`, one
  `torch.Tensor.copy_` moving the same bytes (half read, half written),
  and `copy_floor_library`, one PyTorch call of the same function:
  `F.pad` of Pw viewed (rows, K) to width L (`dma1`), of its 4-fold
  `expand` (`dmaonly`).
  P3 `cwt_staged` (the TPU `_make_manual_kernel`): D's launch 1 as a
  persistent kernel fed by TMA (a producer warp, a ring of two slots of
  8-column boxes of Pw, xr, xi and xig, two consumer groups running D's
  column code), launch 2 D's: P1 full's planes bit for bit.
  `staged_plan` reads its blocks an SM and registers a thread.

The plain versions model the stages the way the kernels run them: an
inverse DFT over k1 of the half band (launch 1), the twiddle, an inverse
DFT over k2 (launch 2), each part present or not; `noexch` replaces each
launch's DFT by `noexch_columns`, a torch mirror of the core's pass
schedule (radices, strides, lane order) with every pass reading and
writing its lane's registers. The TPU's `nosplit` and `ksplitC` time its
bf16x3 dot splits, which the port does not have (ROADMAP, North star): no
counterpart.

Each wrapper dispatches on its inputs' device: on a CUDA tensor it
launches the kernel or raises, on a CPU tensor it runs its plain version
(`*_plain`, the same wrong math in plain torch). The kernels are built
for M1 and M2 in 512..1024 (P3: M1 = 512). `LAUNCHES` (P1),
`LAUNCHES_COPY` (P2) and `LAUNCHES_STAGED` (P3) count kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import fft_cuda
from . import _common

__all__ = ["VARIANTS", "COPY_VARIANTS", "ablate_cwt", "ablate_cwt_plain",
           "copy_floor", "copy_floor_plain", "copy_floor_library",
           "cwt_staged", "cwt_staged_plain",
           "staged_plan", "noexch_columns", "make_inputs", "run", "main",
           "LAUNCHES", "LAUNCHES_COPY", "LAUNCHES_STAGED"]

LAUNCHES = 0
LAUNCHES_COPY = 0
LAUNCHES_STAGED = 0

# the cwt headline (tools/ablate_cwt_kernel.py:55-59) and the CPU's shape
HEADLINE = dict(na=293, M=1 << 18, L=160_000)
SMALL = dict(na=4, M=1 << 12, L=3000)

# P1's variants in the kernel's order, with the parts each keeps of
# (launch 1's passes, launch 2's passes, twiddle, exchanges between passes)
VARIANTS = ("full", "nostage1", "nostage2", "nofft", "notwiddle", "noexch",
            "yonly", "noout", "overlap", "nochunk")
_FULL = (True, True, True, True)
_PARTS = {"full": _FULL,
          "nostage1": (False, True, True, True),
          "nostage2": (True, False, True, True),
          "nofft": (False, False, True, True),
          "notwiddle": (True, True, False, True),
          "noexch": (True, True, True, False),
          "yonly": (False, False, False, True),
          "noout": _FULL, "overlap": _FULL, "nochunk": _FULL}
# the log2 M1 and M2 the kernels are built for (csrc/ablate_cwt.cu
# kLogLo, kLogHi); P3 takes M1 = 2^9 alone
_LOG_RANGE = (9, 10)
# P2: (planes written, rows a block, Pw read)
COPY_VARIANTS = {"dmaonly": (4, 1, True), "dma1": (1, 1, True),
                 "dmanoin": (4, 1, False), "dmarb8": (4, 8, True)}


def make_inputs(device, na, M, L, seed=0):
    """Seeded inputs of D with the derivative at (na, M): Pw (na, K1, M2)
    and x planes (1, K1, M2) standard normal, xig uniform in [0, 3),
    Nyquist values standard normal, 1/dt = 1, the centred keep window of
    L columns. Made on `device`. Returns (args, keep), args as
    `fft_cuda.cwt_fused` takes them."""
    M1, M2 = fft_cuda.best_split(M)
    K1 = M1 // 2
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    Pw, xr, xi = normal(na, K1, M2), normal(1, K1, M2), normal(1, K1, M2)
    xig = 3 * torch.rand((K1, M2), generator=g, device=device)
    nyq = [normal(na) for _ in range(4)]
    args = (Pw, xr, xi, xig, 1.0, (nyq[0], nyq[1]), (nyq[2], nyq[3]))
    return args, ((M - L) // 2, L)


# -- plain versions -------------------------------------------------------------
def _schedule(P):
    """The register-radix core's passes for columns of P points
    (fftr::Shape): [(R, Ns), ...], radix E (16 where radix-16 passes take
    fewer passes than radix 8, else min(8, P)) then one smaller radix for
    the rest, Ns the product of the earlier radices."""
    log = P.bit_length() - 1
    le = 4 if -(-log // 4) < -(-log // 3) else min(3, log)
    radices = [1 << le] * (log // le) + ([1 << (log % le)] if log % le
                                        else [])
    plan, ns = [], 1
    for R in radices:
        plan.append((R, ns))
        ns *= R
    return plan


def noexch_columns(x, sign=1):
    """The core's passes over the last axis of x (complex, P points) with
    no exchange between them (fftr::kNoExch): pass (R, Ns) takes point
    b + r P/R (b < P/R) of the lane's registers, multiplies it by
    e^{sign 2 pi i (b % Ns) r / (Ns R)}, runs the radix-R DFT over r and
    writes output r' back to point b + r' P/R."""
    P = x.shape[-1]
    lead = x.shape[:-1]
    cur = x
    for R, ns in _schedule(P):
        PR = P // R
        t = cur.reshape(*lead, R, PR)             # t[.., r, b] = x[b + r PR]
        if ns > 1:
            m = np.outer(np.arange(R), np.arange(PR) % ns)
            w = np.exp(sign * 2j * np.pi * m / (ns * R))
            t = t * torch.as_tensor(w, dtype=t.dtype, device=t.device)
        t = (torch.fft.ifft(t, dim=-2, norm="forward") if sign > 0 else
             torch.fft.fft(t, dim=-2))
        cur = t.reshape(*lead, P)
    return cur


def _stages(Z, M1, M2, fft1, fft2, twiddle, exch):
    """The unscaled outputs of D's two launches for half-band rows Z
    (rows, M1/2 * M2) complex, with the parts given: (rows, M), output
    n = n1 + M1 * n2. Launch 1 transforms each k2 column over k1 (the
    inverse DFT, or `noexch_columns` without the exchanges; nothing
    without its passes), then the twiddle e^{2 pi i n1 k2 / M}; launch 2
    each n1 row over k2 likewise."""
    rows, device = Z.shape[0], Z.device
    K1, M = M1 // 2, M1 * M2
    A = torch.zeros((rows, M1, M2), dtype=torch.complex64, device=device)
    A[:, :K1] = Z.reshape(rows, K1, M2)

    def columns(x, dim):
        if exch:
            return torch.fft.ifft(x, dim=dim, norm="forward")
        return noexch_columns(x.transpose(dim, -1)).transpose(dim, -1)

    B = columns(A, 1) if fft1 else A
    if twiddle:
        t = np.outer(np.arange(M1), np.arange(M2)) * (2 * np.pi / M)
        B = B * torch.as_tensor(np.exp(1j * t), dtype=torch.complex64,
                                device=device)
    C = columns(B, 2) if fft2 else B
    return C.transpose(1, 2).reshape(rows, M)


def ablate_cwt_plain(Pw, xr, xi, xig, inv_dt, nyq_w, nyq_d, keep,
                     variant="full"):
    """Plain-torch P1: the spectra of `fft_cuda._cwt_spectra` (with
    'overlap', Pw replaced by each row's first value), `_stages` with
    the variant's parts, then the epilogue of kernel D: v / M plus the
    Nyquist value times (-1)^n / M, kept at [start, start + L) ('noout':
    the first kept column). Returns (Wxr, Wxi, dWxr, dWxi), each
    (b*na, L) or (b*na, 1)."""
    _check_variant(variant)
    _, Pw, xr, xi, xig, (nwr, nwi, ndr, ndi) = fft_cuda._prepare(
        Pw, xr, xi, xig, nyq_w, nyq_d)
    na, K1, M2 = Pw.shape
    M1, M = fft_cuda._check_split(K1, M2, keep)
    if variant == "overlap":
        Pw = Pw[:, :1, :1].expand(na, K1, M2)
    Zr, Zi = fft_cuda._cwt_spectra(Pw, xr, xi, xig, inv_dt, True)
    V = _stages(torch.complex(Zr, Zi), M1, M2, *_PARTS[variant])
    start, L = keep
    if variant == "noout":
        L = 1
    n = torch.arange(start, start + L, device=Pw.device)
    inv_m = float(np.float32(1.0 / M))
    alt = torch.where(n % 2 == 1, -inv_m, inv_m).to(torch.float32)
    V = V[:, start:start + L]
    nr, ni = torch.cat([nwr, ndr])[:, None], torch.cat([nwi, ndi])[:, None]
    out_r = V.real * inv_m + nr * alt
    out_i = V.imag * inv_m + ni * alt
    rows = Zr.shape[0] // 2
    return (out_r[:rows].contiguous(), out_i[:rows].contiguous(),
            out_r[rows:].contiguous(), out_i[rows:].contiguous())


def cwt_staged_plain(Pw, xr, xi, xig, inv_dt, nyq_w, nyq_d, keep):
    """Plain-torch P3: D's planes (`ablate_cwt_plain`, 'full')."""
    return ablate_cwt_plain(Pw, xr, xi, xig, inv_dt, nyq_w, nyq_d, keep)


def copy_floor_plain(Pw, L, variant="dmaonly"):
    """Plain-torch P2: planes (rows, L) holding each Pw row (flattened to
    K values) in their first min(K, L) columns and zeros after ('dmanoin':
    zeros); 4 planes, or 1 for 'dma1'."""
    nplanes, _, read = _copy_variant(variant)
    Pw = _copy_input(Pw)
    rows, K = Pw.shape[0], Pw[0].numel()
    out = torch.zeros((rows, L), dtype=torch.float32, device=Pw.device)
    if read:
        w = min(K, L)
        out[:, :w] = Pw.reshape(rows, K)[:, :w]
    return tuple(out.clone() for _ in range(nplanes))


def copy_floor_library(Pw, L, variant="dmaonly"):
    """P2's function as one PyTorch call (the library yardstick, used
    nowhere in the port): `torch.nn.functional.pad` of Pw viewed (rows,
    K), 4-fold expanded but for 'dma1', to width L ('dmanoin': one
    `torch.zeros` of the planes). Returns the planes as
    `copy_floor_plain` does, views of one (nplanes, rows, L) tensor."""
    nplanes, _, read = _copy_variant(variant)
    Pw = _copy_input(Pw)
    rows, K = Pw.shape[0], Pw[0].numel()
    if not read:
        return tuple(torch.zeros((nplanes, rows, L), dtype=torch.float32,
                                 device=Pw.device))
    src = Pw.reshape(1, rows, K).expand(nplanes, rows, K)
    return tuple(torch.nn.functional.pad(src[..., :L], (0, max(L - K, 0))))


# -- the kernels ----------------------------------------------------------------
def _check_variant(variant):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS} (got "
                         f"{variant!r})")


def _copy_variant(variant):
    if variant not in COPY_VARIANTS:
        raise ValueError(f"variant must be one of {tuple(COPY_VARIANTS)} "
                         f"(got {variant!r})")
    return COPY_VARIANTS[variant]


def _copy_input(Pw):
    Pw = fft_cuda._f32(Pw, fft_cuda._device_of(Pw))
    if Pw.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {Pw.device}")
    return Pw


def _planes_cuda(entry, what, Pw, xr, xi, xig, inv_dt, nyq, keep, *mid,
                 cols=None, one_chunk=False, m1_logs=_LOG_RANGE):
    """One launch of the entry point with D's arguments (the derivative
    on), `mid` the ints after the keep window, Y in D's chunks of rows
    (`one_chunk`: one chunk of all rows); returns the four planes (rows,
    cols or L). log2 M1 must lie in `m1_logs`, log2 M2 in _LOG_RANGE."""
    from .. import _build
    na, K1, M2 = Pw.shape
    rows = xr.shape[0] * na
    M1, M = fft_cuda._check_split(K1, M2, keep)
    l1, l2 = M1.bit_length() - 1, M2.bit_length() - 1
    if not (m1_logs[0] <= l1 <= m1_logs[1] and
            _LOG_RANGE[0] <= l2 <= _LOG_RANGE[1]):
        raise ValueError(f"{what}: built for M1 = 2^{m1_logs[0]}..2^"
                         f"{m1_logs[1]} and M2 = 2^{_LOG_RANGE[0]}..2^"
                         f"{_LOG_RANGE[1]} (got {M1} x {M2})")
    start, L = keep
    Pw, xr, xi, xig = (t.contiguous() for t in (Pw, xr, xi, xig))
    nyq = [v.contiguous() for v in nyq]
    ychunk = rows if one_chunk else fft_cuda.d_chunk_rows(M, 2, rows)
    Y = torch.empty((2, ychunk, M, 2), dtype=torch.float32, device=Pw.device)
    out = [torch.empty((rows, cols or L), dtype=torch.float32,
                       device=Pw.device) for _ in range(4)]
    err = entry(_build.lib())(
        Pw.data_ptr(), xr.data_ptr(), xi.data_ptr(), xig.data_ptr(),
        fft_cuda._f32_scalar(inv_dt), *(v.data_ptr() for v in nyq), rows,
        na, l1, l2, start, L, *mid, Y.data_ptr(), ychunk,
        *(o.data_ptr() for o in out),
        fft_cuda._stream(Pw.device))
    _build.check(err, what)
    return tuple(out)


def ablate_cwt(Pw, xr, xi, xig, inv_dt, nyq_w, nyq_d, keep, variant="full"):
    """P1: kernel D (with the derivative) with the parts of `variant`
    taken out, on D's inputs (`fft_cuda.cwt_fused`). Returns (Wxr, Wxi,
    dWxr, dWxi), each (b*na, L) ('noout': (b*na, 1)). A CUDA tensor
    launches the kernel, a CPU tensor runs `ablate_cwt_plain`."""
    global LAUNCHES
    _check_variant(variant)
    device, Pw, xr, xi, xig, nyq = fft_cuda._prepare(Pw, xr, xi, xig, nyq_w,
                                                     nyq_d)
    keep = tuple(keep)
    if device.type == "cpu":
        return ablate_cwt_plain(Pw, xr, xi, xig, inv_dt, nyq[:2], nyq[2:],
                                keep, variant)
    out = _planes_cuda(lambda lib: lib.ssq_ablate_cwt,
                       f"ablate_cwt kernel ({variant})", Pw, xr, xi, xig,
                       inv_dt, nyq, keep, VARIANTS.index(variant),
                       cols=1 if variant == "noout" else None,
                       one_chunk=variant == "nochunk")
    LAUNCHES += 1
    return out


def cwt_staged(Pw, xr, xi, xig, inv_dt, nyq_w, nyq_d, keep):
    """P3: kernel D (with the derivative) whose launch 1 is persistent and
    fed by TMA. Returns D's planes. A CUDA tensor launches the kernel, a
    CPU tensor runs `cwt_staged_plain`."""
    global LAUNCHES_STAGED
    device, Pw, xr, xi, xig, nyq = fft_cuda._prepare(Pw, xr, xi, xig, nyq_w,
                                                     nyq_d)
    keep = tuple(keep)
    if device.type == "cpu":
        return cwt_staged_plain(Pw, xr, xi, xig, inv_dt, nyq[:2], nyq[2:],
                                keep)
    out = _planes_cuda(lambda lib: lib.ssq_cwt_staged, "cwt_staged kernel",
                       Pw, xr, xi, xig, inv_dt, nyq, keep,
                       m1_logs=(_LOG_RANGE[0],) * 2)
    LAUNCHES_STAGED += 1
    return out


def staged_plan():
    """P3's launch 1 as built on the current CUDA device: its blocks an
    SM, registers a thread, dynamic shared memory (bytes), threads a
    block, slots of its ring and k2 columns a box."""
    import ctypes
    from .. import _build
    out = (ctypes.c_int * 6)()
    _build.check(_build.lib().ssq_cwt_staged_plan(out), "cwt_staged plan")
    return dict(zip(("blocks_per_sm", "registers", "smem_bytes", "threads",
                     "stages", "box_cols"), out))


def copy_floor(Pw, L, variant="dmaonly"):
    """P2: the copy floor of D's bytes. Pw (rows, ...) flattened to K
    values a row; returns 4 planes (1 for 'dma1') of (rows, L). A CUDA
    tensor launches the kernel, a CPU tensor runs `copy_floor_plain`."""
    global LAUNCHES_COPY
    _copy_variant(variant)
    Pw = _copy_input(Pw)
    if Pw.device.type == "cpu":
        return copy_floor_plain(Pw, L, variant)
    out = _copy_cuda(Pw, L, variant)
    LAUNCHES_COPY += 1
    return out


def _copy_cuda(Pw, L, variant):
    from .. import _build
    nplanes, rb, read = COPY_VARIANTS[variant]
    rows, K = Pw.shape[0], Pw[0].numel()
    if K % 4 or L % 4:
        raise ValueError(f"copy_floor takes K and L multiples of 4 (got K = "
                         f"{K}, L = {L})")
    Pw = Pw.contiguous()
    out = [torch.empty((rows, L), dtype=torch.float32, device=Pw.device)
           for _ in range(nplanes)]
    ptrs = [o.data_ptr() for o in out] + [None] * (4 - nplanes)
    err = _build.lib().ssq_cwt_copy_floor(
        Pw.data_ptr(), K, rows, L, nplanes, rb, int(read), *ptrs,
        fft_cuda._stream(Pw.device))
    _build.check(err, f"cwt_copy_floor kernel ({variant})")
    return tuple(out)


# -- the probe ------------------------------------------------------------------
def variant_cost(variant, args, keep):
    """(bytes, float32 operations) of the work a P1 or P3 variant does on
    D's inputs `args`: the inputs it reads once (Pw once a row for
    'overlap') and the planes it writes once, and for 'nochunk' the
    intermediate Y (two pipelines x rows x M complex floats) written once
    and read once, since it no longer fits in L2; the butterflies'
    5 P log2 P a column of P points, 5 M log2 M1 a row and pipeline for
    launch 1 and 5 M log2 M2 for launch 2, for the launches whose passes
    it keeps."""
    Pw, xr, xi, xig = args[:4]
    na, K1, M2 = Pw.shape
    rows, M = xr.shape[0] * na, 2 * K1 * M2
    pw_bytes = rows * 4 if variant == "overlap" else Pw.numel() * 4
    cols = 1 if variant == "noout" else keep[1]
    nbytes = (pw_bytes + (xr.numel() + xi.numel() + xig.numel()) * 4 +
              4 * rows * 4 + 4 * rows * cols * 4)
    if variant == "nochunk":
        nbytes += 2 * (2 * rows * M * 8)
    fft1, fft2 = _PARTS.get(variant, _FULL)[:2]
    M1 = 2 * K1
    levels = (M1.bit_length() - 1) * fft1 + (M2.bit_length() - 1) * fft2
    return nbytes, 5.0 * 2 * rows * M * levels


def copy_cost(variant, rows, K, L):
    nplanes, _, read = COPY_VARIANTS[variant]
    return (rows * min(K, L) * 4 * read + nplanes * rows * L * 4, 0.0)


def run(device, reps=5, size=None, seed=0):
    """Time every P1 variant, P2 variant, `copy_`, the library's P2
    (`F.pad`, for dmaonly and dma1) and P3 on `device` (the headline on
    CUDA, `SMALL` on the CPU unless `size` is given): a list of rows
    (name, ms, bytes, flops, bound_ms, bound_by)."""
    size = size or (HEADLINE if device.type == "cuda" else SMALL)
    args, keep = make_inputs(device, size["na"], size["M"], size["L"], seed)
    rows = []
    for v in VARIANTS:
        ms = _common.time_ms(lambda: ablate_cwt(*args, keep, v), device, reps)
        rows.append(_common.row(v, ms, *variant_cost(v, args, keep)))
    Pw, L = args[0], keep[1]
    na, K = Pw.shape[0], Pw[0].numel()
    for v in COPY_VARIANTS:
        ms = _common.time_ms(lambda: copy_floor(Pw, L, v), device, reps)
        rows.append(_common.row(v, ms, *copy_cost(v, na, K, L)))
    nbytes = copy_cost("dmaonly", na, K, L)[0]
    src = torch.zeros(nbytes // 8, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    ms = _common.time_ms(lambda: dst.copy_(src), device, reps)
    rows.append(_common.row("copy_", ms, nbytes, 0.0))
    del src, dst
    for v in ("dmaonly", "dma1"):
        ms = _common.time_ms(lambda: copy_floor_library(Pw, L, v), device,
                             reps)
        rows.append(_common.row(f"F.pad ({v})", ms,
                                *copy_cost(v, na, K, L)))
    ms = _common.time_ms(lambda: cwt_staged(*args, keep), device, reps)
    rows.append(_common.row("staged", ms, *variant_cost("full", args, keep)))
    return rows


def main(argv=None):
    a = _common.parse_args(argv, "Ablation of kernel D (probes P1-P3)")
    device = _common.pick_device(a.device)
    rows = run(device, a.K)
    _common.print_rows(rows, _common.card_line(device))
    return rows


if __name__ == "__main__":
    main()
