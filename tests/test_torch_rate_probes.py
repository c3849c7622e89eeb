"""The last TPU probes' counterparts (`ssqueeze_rs_tpu_torch.tools`: J5
`mxu_rate_probe`, J6 `mxu_probe` and `mxu_probe2`, J7 `dma_overlap_probe`,
J8 `grid_slope_probe`) on the CPU: each plain version against the TPU
probe's own Pallas kernel, run in interpret mode.

The TPU probes are loaded from ``tools/`` by path, their module constants
patched to a small size (GRID 2, R 3, NG 2, T = 8 NG, CH 8, M 128) and
their mains or jitted functions run under `jax.disable_jit()` in TPU
interpret mode with uninitialized memory zeroed (their VMEM accumulators
are never set; zeroed is the port's definition). Their `pl` is a proxy
whose `pallas_call` records every kernel's inputs and output, and their
`timed` runs a function once, so whole output arrays are compared:

  element operations, the copy, J8, J7 `copies`   exact
  bf16 dots and chains                             1e-5 of max|out|
  JAX f32 against the port's 3xtf32 / tf32         2e-5 / 5e-3 (TF32 keeps
                                                   ~3 digits)
  J7 `dots` / `both` (R = 3, b scaled by 1e3 /     1e-2 of max|out| (bf16
  sqrt(M) so that x stays of order 1)              re-rounds every product)

J6's dots also have a unit plan (`mxu_probe.dots_plan`, the mirror of the
kernel's `plan_dots`), held here to cover every output element once; the
variants tool's source edits (`mxu_dots_variants`) are applied to the
source as it stands.
"""
import contextlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ssqueeze_rs_tpu_torch.tools import (_common, dma_overlap_probe as dop,
                                         grid_slope_probe as gsp,
                                         mxu_dots_variants as mdv,
                                         mxu_probe as mp, mxu_probe2 as mp2,
                                         mxu_rate_probe as mrp)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools")
MODULES = [gsp, mrp, mp, mp2, dop]


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


class _Recorder:
    """Stands in for a probe's `pl`: `pallas_call` records (inputs,
    output) of every kernel it builds, as numpy arrays."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(pl, name)

    def pallas_call(self, kernel, **kw):
        f = pl.pallas_call(kernel, **kw)

        def call(*args):
            out = f(*args)
            self.calls.append(([np.asarray(a) for a in args],
                               jax.tree_util.tree_map(np.asarray, out)))
            return out
        return call


@contextlib.contextmanager
def _jax_probe(name, **consts):
    """The TPU probe tools/<name>.py, loaded by path (a private copy), its
    constants set, its `pl` a recorder and its `timed` one call, inside
    TPU interpret mode with jit off: yields (module, recorder)."""
    spec = importlib.util.spec_from_file_location(
        f"_tpu_probe_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rec = _Recorder()
    with pytest.MonkeyPatch.context() as mpatch:
        for k, v in consts.items():
            assert hasattr(mod, k), k
            mpatch.setattr(mod, k, v)
        mpatch.setattr(mod, "pl", rec)
        if name in ("mxu_probe", "mxu_probe2", "grid_slope_probe"):
            mpatch.setattr(mod, "timed", lambda fn, args, *a, **kw:
                           fn(*args, 0))
        with pltpu.force_tpu_interpret_mode(
                pltpu.InterpretParams(uninitialized_memory="zero")), \
                jax.disable_jit():
            yield mod, rec


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _t(a):
    """A recorded JAX array as a torch tensor: int32 stays, the rest (bf16,
    float32) becomes float32."""
    a = np.asarray(a)
    return torch.from_numpy(a.copy() if a.dtype == np.int32 else
                            a.astype(np.float32))


# -- J8 ------------------------------------------------------------------------
@pytest.mark.parametrize("rows, L, vary, grid", [
    (8, 128, False, 2), (8, 128, True, 4), (1, 1024, True, 3)])
def test_grid_slope_matches_jax(rows, L, vary, grid):
    x = np.random.default_rng(grid).standard_normal((rows, L)).astype(
        np.float32)
    with _jax_probe("grid_slope_probe") as (mod, rec):
        mod.build(grid, rows, L, vary)(jnp.asarray(x), 0)
    (ins, out), = rec.calls
    got = gsp.grid_slope(torch.as_tensor(x), grid, vary)
    assert got.shape == out.shape
    assert np.array_equal(got.numpy(), out)


# -- J5 ------------------------------------------------------------------------
SMALL_J5 = dict(GRID=2, R=3)


@pytest.fixture(scope="module")
def jax_dots():
    """The JAX dot_probe at (16, 32, 16) and (32, 64, 48) in bf16 and f32:
    {(shape, dt): (A, B, out)}."""
    rng = np.random.default_rng(0)
    res = {}
    with _jax_probe("mxu_rate_probe", **SMALL_J5) as (mod, rec):
        for m, k, n in ((16, 32, 16), (32, 64, 48)):
            for dt, dtype in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
                A = jnp.asarray(rng.standard_normal((2 * m, k)), dtype)
                B = jnp.asarray(rng.standard_normal((k, n)), dtype)
                mod.dot_probe(A, B, jnp.float32(0), m=m, k=k, n=n, dt=dt)
                ins, out = rec.calls[-1]
                res[(m, k, n), dt] = (ins[0].astype(np.float32),
                                      ins[1].astype(np.float32), out)
    return res


@pytest.mark.parametrize("shape", [(16, 32, 16), (32, 64, 48)])
@pytest.mark.parametrize("dt, precision, bar", [
    ("bf16", "bf16", 1e-5), ("f32", "3xtf32", 2e-5), ("f32", "tf32", 5e-3)])
def test_dot_probe_matches_jax(jax_dots, shape, dt, precision, bar):
    A, B, out = jax_dots[shape, dt]
    got = mrp.dot_probe(torch.as_tensor(A), torch.as_tensor(B), shape[0],
                        precision, R=SMALL_J5["R"])
    assert got.shape == out.shape == (shape[0], shape[2])
    assert _rel(got.numpy(), out) < bar


def test_tf32_is_coarser_than_3xtf32(jax_dots):
    """TF32 keeps ~3 digits: its error against the float32 product is far
    above 3xTF32's."""
    A, B, out = jax_dots[(32, 64, 48), "f32"]
    args = (torch.as_tensor(A), torch.as_tensor(B), 32)
    e_tf = _rel(mrp.dot_probe(*args, "tf32", R=3).numpy(), out)
    e_3x = _rel(mrp.dot_probe(*args, "3xtf32", R=3).numpy(), out)
    assert e_tf > 1e-5 and e_3x < e_tf / 20


def test_copy_probe_matches_jax():
    m, n = 16, 256
    A = np.random.default_rng(1).standard_normal((2 * m, n)).astype(
        np.float32)
    with _jax_probe("mxu_rate_probe", **SMALL_J5) as (mod, rec):
        mod.copy_probe(jnp.asarray(A), jnp.float32(0), m=m, n=n)
    (ins, out), = rec.calls
    got = mrp.copy_probe(torch.as_tensor(A), m, R=SMALL_J5["R"])
    assert np.array_equal(got.numpy(), out)


def test_copy_probe_matches_jax_at_a_second_shape():
    """A second shape and R (GRID 2, R 5; m n not a multiple of the
    kernel's tile): bitwise the TPU probe."""
    m, n = 40, 96
    A = np.random.default_rng(4).standard_normal((2 * m, n)).astype(
        np.float32)
    with _jax_probe("mxu_rate_probe", GRID=2, R=5) as (mod, rec):
        mod.copy_probe(jnp.asarray(A), jnp.float32(0), m=m, n=n)
    (ins, out), = rec.calls
    got = mrp.copy_probe(torch.as_tensor(A), m, R=5)
    assert got.shape == (m, n) and np.array_equal(got.numpy(), out)


@pytest.mark.parametrize("shape", mrp.COPY_SHAPES)
def test_copy_walk_covers_every_element_once(shape):
    """The copy kernel's persistent walk (`copy_walk`, at 132 SMs and at
    a card of 7) takes every output element once, in whole tiles of
    COPY_TILE floats but the last, each block's tiles in increasing
    order."""
    m, n = shape
    for sms in (132, 7):
        blocks, walk = mrp.copy_walk(m, n, sms)
        assert blocks == min(-(-m * n // mrp.COPY_TILE),
                             mrp.COPY_BLOCKS_PER_SM * sms)
        hits = np.zeros(m * n, np.int32)
        last = {}
        for b, start, count in walk:
            assert 0 <= b < blocks and start % mrp.COPY_TILE == 0
            assert count == mrp.COPY_TILE or start + count == m * n
            assert start > last.get(b, -1)
            last[b] = start
            hits[start:start + count] += 1
        assert (hits == 1).all()
        assert len(last) == blocks


def test_copy_walk_mirrors_the_kernel():
    """The mirror's constants are the kernel's."""
    import re
    consts = dict(re.findall(r"constexpr int (k\w+) = (\w+);",
                             _source("rate_probe.cu")))
    assert int(consts["kCopyThreads"]) * int(consts["kCopyPer"]) == \
        mrp.COPY_TILE
    assert int(consts["kCopyBlocksPerSM"]) == mrp.COPY_BLOCKS_PER_SM


@pytest.mark.parametrize("C", [2, 4])
def test_chains_match_jax(C):
    m, k, n = 16, 32, 16
    rng = np.random.default_rng(C)
    A = jnp.asarray(rng.standard_normal(((C + 1) * m, k)), jnp.bfloat16)
    B = jnp.asarray(rng.standard_normal((k, n)), jnp.bfloat16)
    with _jax_probe("mxu_rate_probe", **SMALL_J5) as (mod, rec):
        mod.dot_probe_chains(A, B, jnp.float32(0), m=m, k=k, n=n, C=C)
    (ins, outs), = rec.calls
    got = mrp.dot_probe_chains(_t(ins[0]), _t(ins[1]), m, C, R=SMALL_J5["R"])
    assert got.shape == (C, m, n) and len(outs) == C
    for c in range(C):
        assert _rel(got[c].numpy(), outs[c]) < 1e-5


# the products' operand pre-pass (csrc/rate_probe.cu rate_prep_kernel) as
# its plain model gives it: rounding, B transposed, k padded with zeros to
# a whole 128-byte line, the hi/lo split, and the scratch layout
PREP_CASES = [(p, shape) for p in mrp.PRECISIONS
              for shape in ((16, 32, 16, 1), (5, 72, 7, 1), (4, 129, 33, 1))
              ] + [("bf16", (3, 40, 9, 2)), ("bf16", (4, 129, 33, 4))]


def _bits(t):
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.int32)


@pytest.mark.parametrize("precision, shape", PREP_CASES,
                         ids=[f"{p}-{'x'.join(map(str, s))}"
                              for p, s in PREP_CASES])
def test_prepass_model(precision, shape):
    m, k, n, C = shape
    slices, kp, nbytes = mrp._prep_layout(m, k, n, precision, C)
    size = 2 if precision == "bf16" else 4
    assert slices == (2 if C == 1 else C + 1)
    assert kp % (128 // size) == 0 and k <= kp < k + 128 // size
    g = torch.Generator().manual_seed(m * k + n)
    A = torch.randn(slices * m, k, generator=g)
    B = torch.randn(k, n, generator=g)
    ah, bh, al, bl = mrp.prepass(A, B, m, precision, C)
    assert ah.shape == (slices, m, kp) and bh.shape == (n, kp)
    if precision == "bf16":
        rnd = lambda t: t.to(torch.bfloat16)
    else:
        rnd = mrp.round_tf32
    assert ah.dtype == bh.dtype == (torch.bfloat16 if precision == "bf16"
                                    else torch.float32)
    a3 = A.view(slices, m, k)
    assert torch.equal(_bits(ah[..., :k]), _bits(rnd(a3)))
    assert torch.equal(_bits(bh[:, :k]), _bits(rnd(B.t())))
    assert not ah[..., k:].any() and not bh[:, k:].any()
    if precision == "3xtf32":
        assert torch.equal(_bits(al[..., :k]),
                           _bits(mrp.round_tf32(a3 - ah[..., :k])))
        assert torch.equal(_bits(bl[:, :k]),
                           _bits(mrp.round_tf32(B.t() - bh[:, :k])))
        assert not al[..., k:].any() and not bl[:, k:].any()
        assert float((ah[..., :k] + al[..., :k] - a3).abs().max()) < 1e-5
    else:
        assert al is None and bl is None
    # the scratch holds A hi, B hi (then A lo, B lo) in turn, nbytes in all
    parts = [t for t in (ah, bh, al, bl) if t is not None]
    flat = torch.cat([t.contiguous().view(torch.uint8).flatten()
                      for t in parts])
    assert flat.numel() == nbytes
    for got, want in zip(mrp._split_scratch(flat, m, k, n, precision, C),
                         (ah, bh, al, bl)):
        assert (got is None and want is None) or torch.equal(got, want)
    # the products on the padded operands are the plain version's
    f = lambda t: t.to(torch.float32)
    prods = []
    for s_ in range(slices):
        p = f(ah[s_]) @ f(bh).t()
        if precision == "3xtf32":
            p = f(ah[s_]) @ f(bl).t() + f(al[s_]) @ f(bh).t() + p
        prods.append(p)
    if C == 1:
        want = mrp.dot_probe_plain(A, B, m, precision, R=3)
        got = mrp._sum_slices(prods, 3)
    else:
        want = mrp.dot_probe_chains_plain(A, B, m, C, R=3)
        got = torch.stack([mrp._sum_slices(prods, 3, c) for c in range(C)])
    assert got.shape == want.shape
    assert _rel(got.numpy(), want.numpy()) < 1e-6


@pytest.mark.parametrize("bad, match", [
    (dict(precision="f32"), "precision"), (dict(m=3), "rows"),
    (dict(B=torch.zeros(5, 3)), "columns"),
    (dict(C=2, precision="bf16"), "rows"), (dict(C=3), "C must")])
def test_prepass_refuses_what_dot_probe_refuses(bad, match):
    """The pre-pass takes the dot's arguments and refuses what dot_probe
    refuses, with the same message."""
    args = dict(A=torch.zeros(8, 4), B=torch.zeros(4, 3), m=4,
                precision="bf16", C=1)
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        mrp.prepass(args["A"], args["B"], args["m"], args["precision"],
                    args["C"])
    if args["C"] == 1:
        with pytest.raises(ValueError, match=match):
            mrp.dot_probe(args["A"], args["B"], args["m"],
                          args["precision"])
    else:
        with pytest.raises(ValueError, match=match):
            mrp.dot_probe_chains(args["A"], args["B"], args["m"], args["C"])


def test_round_tf32_is_rna():
    """Ties go away from zero, the low 13 bits are cleared, and the
    result has at most 11 significant bits."""
    bits = np.array([0x3F801000, 0xBF801000, 0x3F800FFF, 0x3F803000,
                     0x40490FDB], np.uint32)
    want = np.array([0x3F802000, 0xBF802000, 0x3F800000, 0x3F804000,
                     0x40490000], np.uint32)
    x = torch.as_tensor(bits.view(np.float32))
    got = mrp.round_tf32(x).numpy().view(np.uint32)
    assert np.array_equal(got, want)
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    r = mrp.round_tf32(y)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    assert ((r - y).abs() <= y.abs() * 2.0 ** -11).all()


# -- J7 ------------------------------------------------------------------------
SMALL_J7 = dict(R=3, CH=8, M=128)


@pytest.fixture(scope="module")
def jax_overlap():
    R, CH, M = SMALL_J7["R"], SMALL_J7["CH"], SMALL_J7["M"]
    rng = np.random.default_rng(7)
    src = rng.standard_normal((R * CH, M)).astype(np.float32)
    a = rng.standard_normal((M, M)).astype(np.float32)
    b = (rng.standard_normal((M, M)) * 1e3 / np.sqrt(M)).astype(np.float32)
    with _jax_probe("dma_overlap_probe", **SMALL_J7) as (mod, rec):
        for v in dop.VARIANTS:
            mod.run(jnp.asarray(src), jnp.asarray(a), jnp.asarray(b), v)
    return (src, a, b), {v: c[1] for v, c in zip(dop.VARIANTS, rec.calls)}


@pytest.mark.parametrize("variant", dop.VARIANTS)
def test_dma_overlap_matches_jax(jax_overlap, variant):
    (src, a, b), outs = jax_overlap
    out = outs[variant]
    got = dop.dma_overlap(*(torch.as_tensor(t) for t in (src, a, b)),
                          variant, R=3, CH=8, D=3).numpy()
    assert got.shape == out.shape == (8, 128)
    if variant == "copies":
        assert np.array_equal(got, out)
    else:
        # the scaled b keeps the chain of order 1 (the probe's own b
        # underflows it to the 1e-30 copy term)
        assert 0.1 < np.abs(out).max() < 100
        assert _rel(got, out) < 1e-2


def test_b_operand_is_bf16_b_transposed():
    """The kernel's operand, made once by the caller: [n, k] = bf16(b[k,
    n]), contiguous, which the plain version's bf16(b) equals."""
    b = torch.randn(64, 64, generator=torch.Generator().manual_seed(3))
    bT = dop.b_operand(b)
    assert bT.dtype == torch.bfloat16 and bT.is_contiguous()
    assert torch.equal(bT.t().float(), b.to(torch.bfloat16).float())


def test_dma_overlap_plain_is_exact_on_a_scaled_permutation():
    """With b = 1000 P each product is one exact term, so the chain has one
    rounding: the plain loop equals the columns permuted by hand, which is
    what lets the card hold its kernel to plain bitwise at any R."""
    src, a, _ = dop.make_inputs(torch.device("cpu"), 3, 8, 128)
    perm = torch.randperm(128, generator=torch.Generator().manual_seed(5))
    bp = torch.zeros(128, 128)
    bp[perm, torch.arange(128)] = 1000.0
    scale, tiny = torch.tensor(1e-3), torch.tensor(1e-30)
    for v in dop.VARIANTS:
        x = a.to(torch.bfloat16).float()
        for r in range(3):
            for _ in range(3 if v != "copies" else 0):
                x = x.to(torch.bfloat16).float()[:, perm] * 1000.0 * scale
            if v != "dots":
                x = x + src[r * 8, 0] * tiny
        assert torch.equal(dop.dma_overlap_plain(src, a, bp, v, 3, 8, 3),
                           x[:8]), v


def test_dma_overlap_copies_match_jax_at_a_second_r():
    """`copies` at R = 5 (the fixture runs R = 3), with src's rows of
    order 1e29 so that each copy term (src[r CH, 0] 1e-30) moves x:
    bitwise the TPU probe, its own rounding at every iteration."""
    R, CH, M = 5, 8, 128
    rng = np.random.default_rng(12)
    src = (rng.standard_normal((R * CH, M)) * 1e29).astype(np.float32)
    a = rng.standard_normal((M, M)).astype(np.float32)
    b = rng.standard_normal((M, M)).astype(np.float32)
    with _jax_probe("dma_overlap_probe", R=R, CH=CH, M=M) as (mod, rec):
        mod.run(jnp.asarray(src), jnp.asarray(a), jnp.asarray(b), "copies")
    (ins, out), = rec.calls
    got = dop.dma_overlap(*(torch.as_tensor(t) for t in (src, a, b)),
                          "copies", R=R, CH=CH, D=3).numpy()
    start = torch.as_tensor(a[:8]).to(torch.bfloat16).float().numpy()
    assert np.array_equal(got, out) and not np.array_equal(got, start)


@pytest.mark.parametrize("size", ["HEADLINE", "SMALL"])
@pytest.mark.parametrize("cluster", dop.CLUSTERS)
def test_dma_overlap_plan_copies_every_chunk_byte_once(size, cluster):
    """The kernel's launch (`plan`): groups of 64 rows, each a cluster of
    `cluster` blocks (8 where M is not a multiple of 8 cluster) whose
    column slices cover x's columns once, N a wgmma width (a multiple of
    8 up to 64); every block's share of a chunk 16-byte aligned, the
    shares covering the chunk's bytes exactly once and differing by at
    most 16 bytes; the shared memory within a block's 227 KB."""
    S = dop.HEADLINE if size == "HEADLINE" else dop.SMALL
    M, CH = S["M"], S["CH"]
    P = dop.plan(M, CH, cluster)
    C = P["cluster"]
    assert C == (cluster if M % (8 * cluster) == 0 else 8)
    assert P["groups"] == M // 64 and P["blocks"] == P["groups"] * C
    assert P["n"] * C == M and P["n"] % 8 == 0 and P["n"] <= 64
    cols = np.zeros(M, np.int32)
    for c0, c1 in P["columns"]:
        cols[c0:c1] += 1
    assert (cols == 1).all()
    chunk = CH * M * 4
    got = np.zeros(chunk // 16, np.int32)
    sizes = []
    for lo, hi in P["shares"]:
        assert lo % 16 == 0 and hi % 16 == 0 and lo <= hi
        got[lo // 16:hi // 16] += 1
        sizes.append(hi - lo)
    assert len(P["shares"]) == P["blocks"] and (got == 1).all()
    assert max(sizes) - min(sizes) <= 16
    assert 1 <= P["slots"] <= 8 and P["smem"] <= 232448
    if (size, cluster) == ("HEADLINE", 8):
        assert (P["n"], P["blocks"], P["slots"]) == (64, 64, 4)
    if (size, cluster) == ("HEADLINE", 16):
        assert (P["n"], P["blocks"], P["slots"]) == (32, 128, 8)


def test_dma_overlap_plan_mirrors_the_kernel():
    """The mirror's constants are the kernel's, and its default cluster
    size is the kernel's."""
    import re
    text = _source("dma_overlap.cu")
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", text))
    assert int(consts["kRows"]) == dop._ROWS
    assert eval(consts["kPiece"]) == dop._PIECE
    assert int(consts["kMaxSlots"]) == dop._MAX_SLOTS
    assert int(consts["kSmemMax"]) == dop._SMEM_MAX
    assert int(consts["kCluster"]) == dop.CLUSTER
    assert consts["kBars"] == "4 + kMaxSlots" and dop._BARS == 12
    for M in (64, 128, 192, 512):
        for cl in dop.CLUSTERS:
            with pytest.raises(ValueError):
                dop.plan(M + 32, 8, cl)
            assert dop.plan(M, 8, cl)["slots"] >= 1


def test_dma_overlap_inputs_keep_the_chain_alive():
    src, a, b = dop.make_inputs(torch.device("cpu"), 2, 4, 128)
    out = dop.dma_overlap(src, a, b, "dots", R=2, CH=4)
    assert 0.05 < float(out.abs().max()) < 50


# -- J6 ------------------------------------------------------------------------
SMALL_J6 = dict(GRID=2, NG=2, T=16)


def _j6_calls(name, questions):
    with _jax_probe(name, **SMALL_J6) as (mod, rec):
        mod.main()
        S = dict(GRID=mod.GRID, NG=mod.NG, G=mod.G, F1=mod.F1)
    assert len(rec.calls) == len(questions), "a question failed in JAX"
    return S, dict(zip(questions, rec.calls))


@pytest.fixture(scope="module")
def jax_j6a():
    return _j6_calls("mxu_probe", mp.QUESTIONS)


@pytest.fixture(scope="module")
def jax_j6b():
    return _j6_calls("mxu_probe2", mp2.QUESTIONS)


def _port_question(q, ins, S):
    """The port's plain version of question q on the JAX kernel's inputs,
    with the probe's constants S."""
    grid, NG, G = S["GRID"], S["NG"], S["G"]
    x = [_t(a) for a in ins]
    if q in ("q_dots", "q_dots4"):
        return mp.dots(x[0], x[1], grid * NG)
    if q in ("q_bigdot", "q_batch"):
        return mp.dots(x[0], x[1], grid, accumulate=False)
    if q == "q_trans":
        return mp.trans(x[0], grid)
    if q == "q_repeat":
        return mp.repeat(x[0], x[1], grid)
    if q == "q_slice128":
        return mp.slice128(x[0], NG, grid)
    if q in ("q_slice8s", "q_abuild"):
        return mp.abuild(x[0], NG, G, S["F1"], grid)
    if q == "q_strided":
        return mp.strided(x[0], G, NG, grid)
    if q == "q_bcast":
        return mp.bcast(x[0], G, grid)
    if q == "q_bbuild":
        return mp.bbuild(x[0], x[1], NG, G, grid)
    if q == "q_floor":
        return gsp.grid_slope(x[0], grid, False)
    raise AssertionError(q)


DOTS = ("q_dots", "q_dots4", "q_bigdot", "q_batch")


def _check_question(S, calls, q):
    ins, out = calls[q]
    got = _port_question(q, ins, S).numpy()
    assert got.shape == out.shape, q
    if q in DOTS:
        assert _rel(got, out) < 1e-5, q
    else:
        assert np.array_equal(got, out.astype(np.float32)), q


@pytest.mark.parametrize("q", mp.QUESTIONS)
def test_mxu_probe_matches_jax(jax_j6a, q):
    _check_question(*jax_j6a, q)


@pytest.mark.parametrize("q", mp2.QUESTIONS)
def test_mxu_probe2_matches_jax(jax_j6b, q):
    _check_question(*jax_j6b, q)


def test_jax_dots_accumulate_over_every_step(jax_j6a):
    """With the accumulator zeroed, q_dots is GRID * NG products."""
    S, calls = jax_j6a
    (A, B), out = calls["q_dots"]
    P = A.astype(np.float32) @ B.astype(np.float32)
    assert _rel(out, S["GRID"] * S["NG"] * P) < 1e-6


def test_question_helpers_match_the_wrappers():
    """`question(..., plain=True)` and the wrapper agree on the CPU, and the
    inputs follow the probe's distributions."""
    size = mp2.SMALL
    inp = mp2.make_inputs(torch.device("cpu"), size)
    assert set(inp["A"].unique().tolist()) <= {0.0, 1.0}
    assert int(inp["KHT"].max()) < size["F1"] and int(inp["KLR"].max()) < 16
    for q in mp2.QUESTIONS:
        assert torch.equal(mp2.question(q, inp, size),
                           mp2.question(q, inp, size, plain=True)), q


# -- J6's dots: the kernel's unit plan -------------------------------------------
DOT_CASES = {
    **{f"{q} {name}": mp.dots_shape(q, size)
       for name, size in (("headline", mp.HEADLINE), ("small", mp.SMALL))
       for q in ("q_dots", "q_bigdot", "q_batch")},
    **{f"{q} {name}": mp.dots_shape(q, size)
       for name, size in (("headline", mp2.HEADLINE), ("small", mp2.SMALL))
       for q in ("q_dots", "q_dots4")},
    # chip_smoke.py's edge shapes (J6_EDGES) and one output element
    "edge accumulate": (1, 200, 72, 136, 3, True),
    "edge batch": (3, 33, 40, 24, 3, False),
    "edge streamed": (1, 200, 1000, 136, 3, True),
    "edge resident, K and N odd": (2, 33, 45, 30, 3, False),
    "edge streamed, K odd": (1, 70, 333, 50, 2, True),
    "one element": (1, 1, 1, 1, 1, True),
}


@pytest.mark.parametrize("shape", list(DOT_CASES.values()),
                         ids=list(DOT_CASES))
def test_dots_units_cover_every_output_once(shape):
    """Each copy's units cover every output element of every batch entry
    exactly once, each unit's wgmma N a multiple of 8 (a resident one at
    most 16, padded past M by fewer than 8 rows; a streamed one at most
    128), and a tile's copies take every step once."""
    batch, M, K, N, steps, accumulate = shape
    P = mp.dots_plan(*shape)
    units = list(mp.dots_units(*shape))
    assert len(units) == P["units"] == P["tiles"] * P["copies"]
    resident = P["route"] == "resident"
    assert resident == (K <= 16 * mp.DOT_MAX_KT)
    hits = np.zeros((P["copies"], batch, M, N), np.int32)
    taken = {}
    for bat, n0, m0, width, copy, ss in units:
        assert width % 8 == 0 and n0 < N and m0 < M
        if resident:
            assert width <= mp.DOT_UNIT_N and m0 + width - M < 8
        else:
            assert width == P["width"] <= mp.DOT_STREAM_MAX_N
        hits[copy, bat, m0:m0 + width, n0:n0 + mp.DOT_SLAB] += 1
        taken.setdefault((bat, n0, m0), []).extend(ss)
    assert (hits == 1).all()
    assert len(taken) == P["tiles"]
    assert all(sorted(s) == list(range(steps)) for s in taken.values())
    if accumulate:
        assert P["copies"] == 1


def test_dots_plan_at_the_headline():
    """The plans the kernel's header names: q_dots 12 slabs x 10 chunks
    (nine n16, one n8), q_dots4 8 x 10, q_batch 32 tiles x 4 copies,
    q_bigdot streamed in two chunks of 80 rows, 24 tiles x 11 copies."""
    plan = lambda q, size: mp.dots_plan(*mp.dots_shape(q, size))
    assert plan("q_dots", mp.HEADLINE) == dict(
        route="resident", width=16, slabs=12, chunks=10, tiles=120, copies=1,
        units=120)
    assert plan("q_dots", mp2.HEADLINE)["units"] == 120
    assert plan("q_dots4", mp2.HEADLINE)["units"] == 80
    assert plan("q_batch", mp.HEADLINE) == dict(
        route="resident", width=16, slabs=2, chunks=2, tiles=32, copies=4,
        units=128)
    assert plan("q_bigdot", mp.HEADLINE) == dict(
        route="streamed", width=80, slabs=12, chunks=2, tiles=24, copies=11,
        units=264)
    assert [u[3] for u in mp.dots_units(*mp.dots_shape(
        "q_dots", mp.HEADLINE))][-1:] == [8]


def test_dots_plan_mirrors_the_kernel():
    """The mirror's constants are the kernel's."""
    import re
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);",
                             _mxu_probe_source()))
    assert {k: int(consts[k]) for k in ("kSlab", "kUnitN", "kMaxKT",
                                        "kStreamMaxN", "kStreamBlocks")} == \
        dict(kSlab=mp.DOT_SLAB, kUnitN=mp.DOT_UNIT_N, kMaxKT=mp.DOT_MAX_KT,
             kStreamMaxN=mp.DOT_STREAM_MAX_N,
             kStreamBlocks=mp.DOT_STREAM_BLOCKS)


@pytest.mark.parametrize("mod", [mp, mp2], ids=["mxu_probe", "mxu_probe2"])
def test_dots_shape_is_what_question_hands_dots(mod, monkeypatch):
    got = {}

    def record(A, B, steps, accumulate=True):
        got[name] = ((A.shape[0] if A.dim() == 3 else 1,) +
                     tuple(A.shape[-2:]) + (B.shape[-1], steps, accumulate))
        return mp.dots_plain(A, B, steps, accumulate)
    monkeypatch.setattr(mod, "dots", record)
    size = mod.SMALL
    inp = mod.make_inputs(torch.device("cpu"), size)
    names = [q for q in mod.QUESTIONS if q in DOTS]
    for name in names:
        mod.question(name, inp, size)
        assert got[name] == mp.dots_shape(name, size), name
    with pytest.raises(ValueError, match="not a dot question"):
        mp.dots_shape("q_trans", size)


def _source(name):
    with open(os.path.join(os.path.dirname(mp.__file__), os.pardir, "csrc",
                           name)) as f:
        return f.read()


def _mxu_probe_source():
    with open(os.path.join(os.path.dirname(mp.__file__), os.pardir, "csrc",
                           "mxu_probe.cu")) as f:
        return f.read()


@pytest.mark.parametrize("name", list(mdv.VARIANTS))
def test_dots_variants_apply_to_the_source(name):
    """tools/mxu_dots_variants.py edits mxu_probe.cu at anchors that are in
    the source once each, and each variant changes it."""
    text = _mxu_probe_source()
    for anchor, _ in mdv.VARIANTS[name]:
        assert text.count(anchor) == 1, anchor[:60]
    assert mdv.variant_source(text, name) != text
    with pytest.raises(ValueError, match="anchor"):
        mdv.variant_source(text.replace(mdv.VARIANTS[name][0][0], ""), name)


def test_dots_variants_read_ptxas_and_need_the_card(monkeypatch):
    fn = "_ZN3_GLOBAL__N_113dots_residentEv"
    report = (f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'\n"
              f"ptxas info    : Function properties for {fn}\n"
              "    0 bytes stack frame, 0 bytes spill stores\n"
              "ptxas info    : Used 160 registers, used 1 barriers\n"
              "ptxas info    : (C7514) Potential Performance Loss: wgmma."
              f"mma_async instructions are serialized in the function '{fn}'\n")
    assert mdv.ptxas_notes(report) == (160, ["C7514"])
    with pytest.raises(RuntimeError, match="no CPU mode"):
        mdv.main(["1", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        mdv.main(["1"])


# -- the entry points ------------------------------------------------------------
def _names(mod, argv):
    if mod is gsp:
        return [f"{n} g={g}" for n, _, _, _, gs in gsp.SMALL for g in gs]
    if mod is mrp and "--chains" in argv:
        return [f"chains C={C} ({m},{k},{n})"
                for m, k, n in mrp.SMALL["chains"] for C in mrp.SMALL["C"]]
    if mod is mrp:
        return ([f"dot {p} ({m},{k},{n})" for m, k, n in mrp.SMALL["shapes"]
                 for p in mrp.PRECISIONS] +
                [f"copy f32 ({m},{n})" for m, n in mrp.SMALL["copy"]])
    if mod in (mp, mp2):
        return list(mod.QUESTIONS)
    return list(dop.VARIANTS)


@pytest.mark.parametrize("mod, extra", [
    (gsp, []), (mrp, []), (mrp, ["--chains"]), (mp, []), (mp2, []),
    (dop, [])], ids=["grid_slope", "rate", "rate_chains", "mxu_probe",
                     "mxu_probe2", "dma_overlap"])
def test_main_on_cpu(mod, extra, capsys):
    counts = (gsp.LAUNCHES, mrp.LAUNCHES_DOT, mrp.LAUNCHES_COPY,
              mrp.LAUNCHES_CHAINS, mp.LAUNCHES, dop.LAUNCHES)
    rows = mod.main(["2", "--device", "cpu"] + extra)
    names = _names(mod, extra)
    assert [r["name"] for r in rows] == names
    assert all(r["ms"] > 0 and r["wall_ms"] > 0 and r["bound_ms"] > 0 and
               r["bound_by"] in ("bytes", "operations") for r in rows)
    lines = capsys.readouterr().out.strip().splitlines()
    assert all("host ms" in line for line in lines)
    assert sum("bound" in line for line in lines) == len(names)
    assert "TFLOP/s" not in "".join(lines) and "TB/s" not in "".join(lines)
    if mod is gsp:
        assert sum("per-block cost" in line for line in lines) == 3
    if mod is dop:
        assert sum("sum(floors)" in line for line in lines) == 2
    # CPU runs launch nothing
    assert counts == (gsp.LAUNCHES, mrp.LAUNCHES_DOT, mrp.LAUNCHES_COPY,
                      mrp.LAUNCHES_CHAINS, mp.LAUNCHES, dop.LAUNCHES)


@pytest.mark.parametrize("mod", MODULES,
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_main_needs_cuda_or_device_cpu(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main(["1"])


def test_wrappers_refuse_bad_arguments():
    A, B = torch.zeros(8, 4), torch.zeros(4, 3)
    with pytest.raises(ValueError, match="precision"):
        mrp.dot_probe(A, B, 4, "f32")
    with pytest.raises(ValueError, match="rows"):
        mrp.dot_probe(A, B, 3)
    with pytest.raises(ValueError, match="columns"):
        mrp.dot_probe(A, torch.zeros(5, 3), 4)
    with pytest.raises(ValueError, match="C must"):
        mrp.dot_probe_chains(torch.zeros(16, 4), B, 4, 3)
    with pytest.raises(ValueError, match="rows"):
        mrp.copy_probe(torch.zeros(7, 4), 4)
    src, a, b = torch.zeros(16, 64), torch.zeros(64, 64), torch.zeros(64, 64)
    with pytest.raises(ValueError, match="variant"):
        dop.dma_overlap(src, a, b, "dma", R=2, CH=8)
    with pytest.raises(ValueError, match="src"):
        dop.dma_overlap(src, a, b, "both", R=3, CH=8)
    with pytest.raises(ValueError, match="grid"):
        gsp.grid_slope(torch.zeros(8, 128), 0, True)
    with pytest.raises(ValueError, match="int32"):
        mp.trans(torch.zeros(4, 8), 1)
    with pytest.raises(ValueError, match="multiple"):
        mp.bcast(torch.zeros(4, 12), 8, 1)
    with pytest.raises(ValueError, match="columns"):
        mp.slice128(torch.zeros(4, 200), 2, 1)
    with pytest.raises(ValueError, match="steps"):
        mp.dots(torch.zeros(4, 8), torch.zeros(8, 2), 0)
    with pytest.raises(ValueError, match="question"):
        mp.question("q_nothing", {}, mp.SMALL)


def test_bounds_take_the_unit_rate():
    """A dot's operations go at the tensor cores' rate of its precision,
    and 3xtf32 counts three TF32 products."""
    nb, fl, rate = mrp.dot_cost(1024, 512, 512, "bf16")
    assert rate == _common.BF16_FLOP_S
    assert _common.bound(nb, fl, rate) == (fl / rate * 1e3, "operations")
    assert mrp.dot_cost(1024, 512, 512, "3xtf32")[1] == 3 * mrp.dot_cost(
        1024, 512, 512, "tf32")[1]
    assert _common.bound(1e9, 1e9) == (1e9 / _common.HBM_BYTES_S * 1e3,
                                       "bytes")
    nb, fl, _ = dop.variant_cost("copies", 64, 4096, 3, 512)
    assert nb >= 64 * 4096 * 512 * 4 and fl == 0


@pytest.mark.parametrize("precision, C, per_step", [
    ("bf16", 1, 256 * 1024), ("tf32", 1, 512 * 1024),
    ("3xtf32", 1, 768 * 1024), ("bf16", 8, 256 * 1024)])
def test_operand_bytes_count_every_block(precision, C, per_step):
    """The product blocks' operand reads: at (1024,512,512) a block step
    reads 256 KiB in bf16 (two 64-row A boxes and a 128-row B box over
    k = 512), twice that in float, three times in 3xtf32 (hi and lo at
    128 x 64); the blocks are tiles x chain pairs x copies, and their
    reads are far above the bound's bytes (each input once)."""
    tiles = (1024 // 128) * (512 // (64 if precision == "3xtf32" else 128))
    if C > 1:
        tiles = (1024 // 64) * (512 // 128) * (C // 2)
    got = mrp.operand_bytes(1024, 512, 512, precision, C, grid=32, R=8)
    assert got == tiles * 32 * 8 * per_step
    assert got > 100 * mrp.dot_cost(1024, 512, 512, precision, C=C)[0]


def test_time_ms_queues_the_runs_behind_a_spin(monkeypatch):
    """On the card the timed runs, after one warm-up, are queued behind one
    fixed spin of the card, each between its own pair of events, and the
    median of their times stands."""
    log, times = [], iter([0.5, 0.25, 0.75])

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            log.append("event")

        def elapsed_time(self, other):
            return next(times)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: log.append("sync"))
    monkeypatch.setattr(torch.cuda, "_sleep",
                        lambda cycles: log.append(("spin", cycles)))
    dev = torch.device("cuda", 0)
    assert _common.time_ms(lambda: log.append("run"), dev, 3) == 0.5
    assert log == (["run", "sync", ("spin", _common.SPIN_CYCLES)] +
                   ["event", "run", "event"] * 3 + ["sync"])


def test_slopes_and_verdict():
    rows = [dict(name="tiny g=64", grid=64, ms=1.0, wall_ms=2.0),
            dict(name="tiny g=1024", grid=1024, ms=1.96, wall_ms=2.96)]
    assert gsp.slopes(rows) == {"tiny": pytest.approx((1.0, 1.0))}
    assert dop.verdict(dict(copies=1.0, dots=1.0, both=1.1))[2] == \
        "OVERLAPPABLE"
    assert dop.verdict(dict(copies=1.0, dots=1.0, both=1.9)) == (2.0, 1.0,
                                                                 "ADDITIVE")
