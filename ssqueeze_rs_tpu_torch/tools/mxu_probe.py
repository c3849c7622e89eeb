"""The costs around a digit-split one-hot product: probe J6
(``csrc/mxu_probe.cu``), the counterpart of the TPU probe
``tools/mxu_probe.py`` (and, with ``mxu_probe2``, of its second round).

    python -m ssqueeze_rs_tpu_torch.tools.mxu_probe [K] [--device cpu]

Each question is one small kernel whose GRID steps (and NG groups) are a
loop in every block; an accumulator starts at zero and runs on over all
GRID * NG steps (the TPU kernels left theirs unset). At NA = 296, T =
512, NG = 64, G = 8, F1 = 19, M = F1 G = 152, NL = 768, GRID = 16:

  q_dots      GRID NG products (M, NA) @ (NA, NL), bf16, summed
  q_bigdot    one (M, NA NG) @ (NA NG, NL) product a step
  q_trans     an (NA, T) int32 transposed to float32 a step
  q_repeat    (NA, 16T): v where klo equals the lane mod 16, else 0
  q_slice128  the NG 128-column slices of an (NA, 16T) plane summed
  q_slice8s   the A-operand build: counts of KHT[8-row group] == row / G
  q_strided   the G stride-G row slices of an (M, 128) block summed
  q_batch     a batch of G (32, NA) @ (NA, 128) products a step

Each row has the device time (CUDA events, median of K after a warm-up)
and the host wall time a call over K back-to-back calls ended by one
synchronize (what the TPU probe timed), beside its bound. The element
questions are exact against their plain versions; the dots within 1e-5
of the largest value (the sums' order).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain version (`*_plain`). `LAUNCHES` counts kernel
launches of every question (``mxu_probe2``'s too).
"""
from __future__ import annotations

import torch

from ..ops import fft_cuda
from . import _common

__all__ = ["QUESTIONS", "HEADLINE", "SMALL", "dots", "dots_plain", "trans",
           "trans_plain", "repeat", "repeat_plain", "bcast", "bcast_plain",
           "slice128", "slice128_plain", "abuild", "abuild_plain", "strided",
           "strided_plain", "bbuild", "bbuild_plain", "make_inputs",
           "question", "cost", "run_questions", "run", "main",
           "dots_plan", "dots_units", "dots_shape", "dots_kernel_plan",
           "LAUNCHES"]

LAUNCHES = 0

QUESTIONS = ("q_dots", "q_bigdot", "q_trans", "q_repeat", "q_slice128",
             "q_slice8s", "q_strided", "q_batch")
# tools/mxu_probe.py:32-35, 51
HEADLINE = dict(NA=296, T=512, NG=64, G=8, F1=19, NL=768, GRID=16)
SMALL = dict(NA=40, T=32, NG=4, G=8, F1=19, NL=768, GRID=2)
_ELEM = {"trans": 0, "repeat": 1, "bcast": 2, "slice128": 3, "abuild": 4,
         "strided": 5, "bbuild": 6}


def _steps(steps):
    if int(steps) < 1:
        raise ValueError(f"steps must be at least 1 (got {steps})")
    return int(steps)


def _device(*ts):
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("the operands must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


# -- the dots ------------------------------------------------------------------
def _check_dots(A, B):
    if A.dim() != B.dim() or A.dim() not in (2, 3):
        raise ValueError("A and B must be two matrices or two batches")
    if A.shape[-1] != B.shape[-2] or A.shape[:-2] != B.shape[:-2]:
        raise ValueError(f"A {tuple(A.shape)} and B {tuple(B.shape)} do not "
                         "multiply")


def dots_plain(A, B, steps, accumulate=True):
    """Plain-torch dots: bf16(A) @ bf16(B) in float32, summed over `steps`
    (or one step's product)."""
    _check_dots(A, B)
    P = _bf16(A) @ _bf16(B)
    if not accumulate:
        _steps(steps)
        return P
    acc = torch.zeros_like(P)
    for _ in range(_steps(steps)):
        acc = acc + P
    return acc


def dots(A, B, steps, accumulate=True):
    """J6 dots: `steps` products bf16(A) @ bf16(B) ((M, K) @ (K, N), or a
    batch of them), float32 sums, accumulated over the steps or each
    step's alone. A CUDA tensor launches the kernel, a CPU tensor runs
    `dots_plain`."""
    _check_dots(A, B)
    if _device(A, B).type == "cpu":
        return dots_plain(A, B, steps, accumulate)
    from .. import _build
    global LAUNCHES
    A = A.to(torch.bfloat16).contiguous()
    B = B.to(torch.bfloat16).contiguous()
    batch = A.shape[0] if A.dim() == 3 else 1
    M, K = A.shape[-2:]
    N = B.shape[-1]
    out = torch.empty(A.shape[:-1] + (N,), dtype=torch.float32,
                      device=A.device)
    err = _build.lib().ssq_mxu_dots(A.data_ptr(), B.data_ptr(), out.data_ptr(),
                                    batch, M, K, N, _steps(steps),
                                    int(bool(accumulate)),
                                    fft_cuda._stream(A.device))
    _build.check(err, "mxu_probe dots kernel")
    LAUNCHES += 1
    return out


# The dots' unit plan (csrc/mxu_probe.cu `plan_dots`), mirrored: the
# transposed product out^T = B^T A^T, each unit one warpgroup's m64 slab
# of out's columns by a chunk of out's rows (the wgmma N); operands
# resident (the slab in registers) while K fits in DOT_MAX_KT k16 tiles,
# else streamed through a TMA ring; without `accumulate` copies of every
# tile take the independent steps in turn.
DOT_SLAB = 64            # out's columns a unit
DOT_UNIT_N = 16          # out's rows a resident unit (the last 8 or 16)
DOT_MAX_KT = 19          # k16 tiles held in registers: K <= 304 resident
DOT_STREAM_MAX_N = 128   # out's rows a streamed unit, at most
DOT_STREAM_BLOCKS = 2    # streamed blocks an SM (their rings)
DOT_SMS = 132            # SMs of an NVIDIA H100 SXM


def _ceil(a, b):
    return -(-a // b)


def dots_plan(batch, M, K, N, steps, accumulate=True, sms=DOT_SMS):
    """The kernel's plan for `dots` at these shapes on a card of `sms`
    SMs: route ('resident' or 'streamed'), width (a unit's rows of out,
    its wgmma N), slabs (of 64 columns), chunks (of `width` rows), tiles
    (batch x slabs x chunks), copies and units (tiles x copies)."""
    route = ("resident" if _ceil(K, 16) <= DOT_MAX_KT else "streamed")
    if route == "resident":
        width = DOT_UNIT_N
    else:
        width = _ceil(_ceil(M, _ceil(M, DOT_STREAM_MAX_N)), 16) * 16
    chunks, slabs = _ceil(M, width), _ceil(N, DOT_SLAB)
    tiles = batch * slabs * chunks
    copies = 1
    if not accumulate and steps > 1:
        slots = sms * (DOT_STREAM_BLOCKS if route == "streamed" else 1)
        copies = min(max(slots // tiles, 1), steps)
    return dict(route=route, width=width, slabs=slabs, chunks=chunks,
                tiles=tiles, copies=copies, units=tiles * copies)


def dots_units(batch, M, K, N, steps, accumulate=True, sms=DOT_SMS):
    """Every unit of `dots_plan` in launch order, as (entry, first column,
    first row, rows it computes (its wgmma N), copy, its steps): a
    resident tail chunk rounded up to 8 rows, a streamed one computed at
    the full width (the rows past M are TMA's zeros)."""
    P = dots_plan(batch, M, K, N, steps, accumulate, sms)
    W, copies = P["width"], P["copies"]
    for u in range(P["units"]):
        copy, t = u % copies, u // copies
        chunk, t = t % P["chunks"], t // P["chunks"]
        m0 = chunk * W
        width = W
        if P["route"] == "resident" and M - m0 < W:
            width = _ceil(M - m0, 8) * 8
        yield (t // P["slabs"], (t % P["slabs"]) * DOT_SLAB, m0, width, copy,
               range(copy, steps, copies))


def dots_shape(name, size):
    """(batch, M, K, N, steps, accumulate) of dot question `name` at `size`
    (HEADLINE's keys): what `question` hands `dots`."""
    NA, NG, G, NL, grid = (size[k] for k in ("NA", "NG", "G", "NL", "GRID"))
    M = size["F1"] * G
    shapes = {"q_dots": (1, M, NA, NL, grid * NG, True),
              "q_dots4": (1, M, NA, 512, grid * NG, True),
              "q_bigdot": (1, M, NA * NG, NL, grid, False),
              "q_batch": (G, 32, NA, 128, grid, False)}
    if name not in shapes:
        raise ValueError(f"{name!r} is not a dot question")
    return shapes[name]


def dots_kernel_plan(batch, M, K, N, steps, accumulate=True):
    """The plan the kernel takes on the current CUDA device
    (`ssq_mxu_dots_plan`): `dots_plan`'s keys from the card, with the
    blocks launched and the warpgroups an SM (`per_sm`)."""
    import ctypes
    from .. import _build
    v = (ctypes.c_int * 8)()
    _build.check(_build.lib().ssq_mxu_dots_plan(batch, M, K, N, int(steps),
                                                int(bool(accumulate)), v),
                 "mxu_probe dots plan")
    keys = ("route", "width", "slabs", "chunks", "copies", "units",
            "blocks", "per_sm")
    plan = dict(zip(keys, list(v)))
    plan["route"] = ("resident", "streamed")[plan["route"]]
    plan["tiles"] = plan["units"] // plan["copies"]
    return plan


# -- the element questions -----------------------------------------------------
def _elem(name, ins, out_shape, dims, steps):
    from .. import _build
    global LAUNCHES
    in0 = ins[0].contiguous()
    in1 = ins[1].contiguous() if len(ins) > 1 else None
    out = torch.empty(out_shape, dtype=torch.float32, device=in0.device)
    d = list(dims) + [0] * (4 - len(dims))
    err = _build.lib().ssq_mxu_elem(
        _ELEM[name], in0.data_ptr(), None if in1 is None else in1.data_ptr(),
        out.data_ptr(), *d, _steps(steps), 0, fft_cuda._stream(in0.device))
    _build.check(err, f"mxu_probe {name} kernel")
    LAUNCHES += 1
    return out


def _ints(t):
    if t.dtype != torch.int32:
        raise ValueError(f"expected int32 (got {t.dtype})")
    return t


def _floats(t):
    if t.dtype != torch.float32:
        raise ValueError(f"expected float32 (got {t.dtype})")
    return t


def trans_plain(K32, steps):
    """(T, NA) float32 = K32.T."""
    _steps(steps)
    return _ints(K32).t().to(torch.float32).contiguous()


def trans(K32, steps):
    """J6 q_trans: the (NA, T) int32 K32 transposed to float32, `steps`
    times."""
    _ints(K32)
    if _device(K32).type == "cpu":
        return trans_plain(K32, steps)
    NA, T = K32.shape
    return _elem("trans", [K32], (T, NA), (NA, T), steps)


def repeat_plain(KLO, V, steps):
    """(NA, 16T): V where KLO equals the column mod 16, each entry
    repeated 16 times along the row, else 0."""
    _steps(steps)
    kr = _ints(KLO).repeat_interleave(16, dim=1)
    vr = _floats(V).repeat_interleave(16, dim=1)
    f0 = torch.arange(kr.shape[1], device=kr.device) % 16
    return torch.where(kr == f0, vr, torch.zeros_like(vr))


def repeat(KLO, V, steps):
    """J6 q_repeat (jnp.repeat of the digit and value, 16 lanes each, and
    the one-hot select), `steps` times."""
    _ints(KLO), _floats(V)
    if KLO.shape != V.shape:
        raise ValueError("KLO and V must have one shape")
    if _device(KLO, V).type == "cpu":
        return repeat_plain(KLO, V, steps)
    NA, T = KLO.shape
    return _elem("repeat", [KLO, V], (NA, 16 * T), (NA, T), steps)


def _check_bcast(V, G):
    if _floats(V).shape[1] % G:
        raise ValueError(f"T ({V.shape[1]}) must be a multiple of G ({G})")


def bcast_plain(V, G, steps):
    """(NA, 16T): each group of G columns repeated 16 times
    (broadcast_to + reshape)."""
    _check_bcast(V, G)
    _steps(steps)
    NA, T = V.shape
    return (V.reshape(NA, T // G, 1, G).expand(NA, T // G, 16, G)
            .reshape(NA, 16 * T))


def bcast(V, G, steps):
    """J6 q_bcast (mxu_probe2), `steps` times."""
    _check_bcast(V, G)
    if _device(V).type == "cpu":
        return bcast_plain(V, G, steps)
    NA, T = V.shape
    return _elem("bcast", [V], (NA, 16 * T), (NA, T, G), steps)


def _check_slice128(BALL, NG):
    if _floats(BALL).shape[1] < 128 * NG:
        raise ValueError(f"BALL needs {128 * NG} columns")


def slice128_plain(BALL, NG, steps):
    """(NA, 128): the NG 128-column slices of BALL summed in order, the sum
    running on over the steps."""
    _check_slice128(BALL, NG)
    NA = BALL.shape[0]
    parts = BALL[:, :128 * NG].reshape(NA, NG, 128)
    acc = torch.zeros((NA, 128), dtype=torch.float32, device=BALL.device)
    for _ in range(_steps(steps)):
        for g in range(NG):
            acc = acc + parts[:, g]
    return acc


def slice128(BALL, NG, steps):
    """J6 q_slice128: a dynamic 128-column slice a group, summed."""
    _check_slice128(BALL, NG)
    if _device(BALL).type == "cpu":
        return slice128_plain(BALL, NG, steps)
    NA, W = BALL.shape
    return _elem("slice128", [BALL], (NA, 128), (NA, W, NG), steps)


def _check_abuild(KHT, NG, G):
    if _ints(KHT).shape[0] < NG * G:
        raise ValueError(f"KHT needs {NG * G} rows")


def abuild_plain(KHT, NG, G, F1, steps):
    """(F1 G, NA): at row r, the count over the steps and the NG groups of
    KHT[G g + r % G] == r // G (the one-hot A operand, tiled F1 times)."""
    _check_abuild(KHT, NG, G)
    r = torch.arange(F1 * G, device=KHT.device)
    rows = torch.arange(NG, device=KHT.device)[:, None] * G + r % G
    hits = (KHT[rows] == (r // G)[None, :, None]).sum(0)
    return hits.to(torch.float32) * _steps(steps)


def abuild(KHT, NG, G, F1, steps):
    """J6 q_slice8s / q_abuild: a dynamic G-row slice, tiled F1 times and
    compared with the row's digit, the 0/1 result summed."""
    _check_abuild(KHT, NG, G)
    if _device(KHT).type == "cpu":
        return abuild_plain(KHT, NG, G, F1, steps)
    NA = KHT.shape[1]
    return _elem("abuild", [KHT], (F1 * G, NA), (NA, NG, G, F1), steps)


def _check_strided(D, G):
    if _floats(D).shape[0] % G:
        raise ValueError(f"D's rows ({D.shape[0]}) must be a multiple of G "
                         f"({G})")


def strided_plain(D, G, NG, steps):
    """(M / G, L): the G stride-G row slices summed (from 0, in order),
    that sum added over the steps and the NG groups."""
    _check_strided(D, G)
    Mr, L = D.shape
    s = torch.zeros((Mr // G, L), dtype=torch.float32, device=D.device)
    for r in range(G):
        s = s + D[r::G]
    acc = torch.zeros_like(s)
    for _ in range(_steps(steps) * NG):
        acc = acc + s
    return acc


def strided(D, G, NG, steps):
    """J6 q_strided: stride-G row slices (the diagonal extraction)."""
    _check_strided(D, G)
    if _device(D).type == "cpu":
        return strided_plain(D, G, NG, steps)
    Mr, L = D.shape
    return _elem("strided", [D], (Mr // G, L), (Mr, L, G, NG), steps)


def _split3(x):
    """x as three bf16 terms, hi + mid + lo (tools/mxu_probe2.py:157-161)."""
    h = _bf16(x)
    r1 = x - h
    m = _bf16(r1)
    return h, m, _bf16(r1 - m)


def _check_bbuild(KLR, VRR, NG):
    if _floats(VRR).shape != _ints(KLR).shape or KLR.shape[1] < 128 * NG:
        raise ValueError(f"KLR and VRR must be (NA, >= {128 * NG})")


def bbuild_plain(KLR, VRR, NG, G, steps):
    """(NA, 768): for each group the B operand of the digit-split product
    (select by KLR == column // G, Br = v, Bi = v / 2, each split into
    three bf16 terms, six 128-column pieces), summed over the steps and
    groups."""
    _check_bbuild(KLR, VRR, NG)
    NA = KLR.shape[0]
    kl = KLR[:, :128 * NG].reshape(NA, NG, 128)
    v = VRR[:, :128 * NG].reshape(NA, NG, 128)
    sel = kl == torch.arange(128, device=KLR.device) // G
    zero = torch.zeros_like(v)
    Bg = torch.cat(_split3(torch.where(sel, v, zero)) +
                   _split3(torch.where(sel, v * 0.5, zero)), dim=-1)
    acc = torch.zeros((NA, 768), dtype=torch.float32, device=KLR.device)
    for _ in range(_steps(steps)):
        for g in range(NG):
            acc = acc + Bg[:, g]
    return acc


def bbuild(KLR, VRR, NG, G, steps):
    """J6 q_bbuild (mxu_probe2): the whole B-operand build a group."""
    _check_bbuild(KLR, VRR, NG)
    if _device(KLR, VRR).type == "cpu":
        return bbuild_plain(KLR, VRR, NG, G, steps)
    NA, W = KLR.shape
    return _elem("bbuild", [KLR, VRR], (NA, 768), (NA, W, NG, G), steps)


# -- the probe -----------------------------------------------------------------
def make_inputs(device, size, seed=0):
    """The questions' operands at `size` (HEADLINE's keys), made on
    `device` from `seed`: the TPU probe's distributions (A one-hot with
    density 0.05, normals, digits in their ranges)."""
    g = _common.generator(device, seed)
    NA, T, NG, G, F1, NL = (size[k] for k in ("NA", "T", "NG", "G", "F1",
                                                "NL"))
    M = F1 * G
    bf = torch.bfloat16
    bern = lambda *s: (torch.rand(s, generator=g, device=device) < 0.05).to(bf)
    return dict(
        A=bern(M, NA), B=_common.randn(g, NA, NL).to(bf),
        A2=bern(M, NA * NG), B2=_common.randn(g, NA * NG, NL).to(bf),
        K32=_common.randint(g, 293, NA, T), KLO=_common.randint(g, 16, NA, T),
        V=_common.randn(g, NA, T), BALL=_common.randn(g, NA, 16 * T),
        KHT=_common.randint(g, F1, T, NA), D=_common.randn(g, M, 128),
        Ab=_common.randn(g, G, 32, NA).to(bf),
        Bb=_common.randn(g, G, NA, 128).to(bf))


def question(name, inp, size, plain=False):
    """Question `name` on the operands of `make_inputs`: through its
    wrapper (the kernel on CUDA) or, with `plain`, its plain version."""
    S = size
    grid, NG, G = S["GRID"], S["NG"], S["G"]
    if name == "q_dots":
        return (dots_plain if plain else dots)(inp["A"], inp["B"], grid * NG)
    if name == "q_bigdot":
        return (dots_plain if plain else dots)(inp["A2"], inp["B2"], grid,
                                               False)
    if name == "q_trans":
        return (trans_plain if plain else trans)(inp["K32"], grid)
    if name == "q_repeat":
        return (repeat_plain if plain else repeat)(inp["KLO"], inp["V"], grid)
    if name == "q_slice128":
        return (slice128_plain if plain else slice128)(inp["BALL"], NG, grid)
    if name == "q_slice8s":
        return (abuild_plain if plain else abuild)(inp["KHT"], NG, G,
                                                   S["F1"], grid)
    if name == "q_strided":
        return (strided_plain if plain else strided)(inp["D"], G, NG, grid)
    if name == "q_batch":
        return (dots_plain if plain else dots)(inp["Ab"], inp["Bb"], grid,
                                               False)
    raise ValueError(f"question must be one of {QUESTIONS} (got {name!r})")


def cost(name, size):
    """(bytes, operations, rate) of a question: its operands read once and
    its output written once; its steps' operations (the dots' at the
    tensor cores' bf16 rate, the rest float32 element operations)."""
    S = size
    NA, T, NG, G, F1, NL, grid = (S[k] for k in ("NA", "T", "NG", "G", "F1",
                                                  "NL", "GRID"))
    M, F32, BF16 = F1 * G, _common.F32_FLOP_S, _common.BF16_FLOP_S
    table = {
        "q_dots": (2 * (M * NA + NA * NL) + 4 * M * NL,
                   grid * NG * 2 * M * NA * NL, BF16),
        "q_dots4": (2 * (M * NA + NA * 512) + 4 * M * 512,
                    grid * NG * 2 * M * NA * 512, BF16),
        "q_bigdot": (2 * (M * NA * NG + NA * NG * NL) + 4 * M * NL,
                     grid * 2 * M * NA * NG * NL, BF16),
        "q_trans": (8 * NA * T, 0, F32),
        "q_repeat": (8 * NA * T + 4 * NA * 16 * T, grid * NA * 16 * T, F32),
        "q_bcast": (4 * NA * T + 4 * NA * 16 * T, 0, F32),
        "q_slice128": (4 * NA * 16 * T + 4 * NA * 128, grid * NG * NA * 128,
                       F32),
        "q_slice8s": (4 * T * NA + 4 * M * NA, grid * NG * M * NA * 2, F32),
        "q_strided": (4 * M * 128 + 4 * F1 * 128, grid * NG * M * 128, F32),
        "q_batch": (2 * (G * 32 * NA + G * NA * 128) + 4 * G * 32 * 128,
                    grid * 2 * G * 32 * NA * 128, BF16),
        # select, halve, two three-way splits (5 operations each), 6 adds
        "q_bbuild": (8 * NA * 16 * T + 4 * NA * 768,
                     grid * NG * NA * 128 * 19, F32),
    }
    table["q_abuild"] = table["q_slice8s"]
    nbytes, flops, rate = table[name]
    return nbytes, float(flops), rate


def run_questions(device, names, question_fn, cost_fn, inp, size, reps):
    """Rows (name, ms, wall_ms, bytes, flops, bound_ms, bound_by) of each
    question in `names`, run by question_fn(name, inp, size)."""
    rows = []
    for name in names:
        fn = lambda: question_fn(name, inp, size)
        ms = _common.time_ms(fn, device, reps)
        rows.append(_common.row(name, ms, *cost_fn(name, size),
                                wall_ms=_common.wall_ms(fn, device, reps)))
    return rows


def run(device, reps=5, size=None, seed=0):
    """Time every question on `device` (HEADLINE on CUDA, SMALL on the
    CPU unless `size` is given)."""
    size = size or (HEADLINE if device.type == "cuda" else SMALL)
    return run_questions(device, QUESTIONS, question, cost,
                         make_inputs(device, size, seed), size, reps)


def main(argv=None):
    a = _common.parse_args(argv, "Costs around the digit-split product "
                                 "(probe J6, round 1)")
    device = _common.pick_device(a.device)
    rows = run(device, a.K)
    _common.print_rows(rows, _common.card_line(device))
    return rows


if __name__ == "__main__":
    main()
