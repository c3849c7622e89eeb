"""Kernel I (the digit-split tensor-core reassignment) of the torch port
on the CPU: its plain version `reassign_mxu_plain`, which the port runs
under SSQ_TPU_REASSIGN_IMPL=mxu on CPU tensors, against the JAX
package's `reassign_pallas` under the same selector (the MXU Pallas kernel
in interpret mode), and against the port's plain B'. Inputs: the chirp
CWT planes of tests/test_reassign_pallas.py (`_setup`), made by the JAX
package from a seeded numpy signal and handed to both.

Tolerances. Within the port, the JAX package's own bar for I against B'
(tests/test_reassign_pallas.py::test_mxu_impl_matches_vpu): sum over
entries of |I - B'| / sum |B'| < 2e-5 (the two sum the same float32
products in other orders) and nonzero patterns equal on >= 99.99 % of
entries. Across the packages the log modes' bins themselves differ: an
ulp of log2 between torch and XLA moves ~0.01 % of the values to the
neighbouring bin (4.5e-5 sum-relative here, for B' as much as for I), so
the port's I is held to the JAX I with the B' parity bars of
tests/test_torch_reassign.py (>= 99.99 % of entries within 1e-6 of
max|Tx|, column sums within 1e-6), and what I changes against B' must be
the same in both packages: sum |(I - B')_port - (I - B')_jax| / sum |B'|
< 2e-5. The gradient through I is the gradient through B' bit for bit:
both backwards are the same gather C' over the same bins.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ssqueeze_rs_tpu import cwt
from ssqueeze_rs_tpu.ops.reassign_pallas import reassign_pallas
from ssqueeze_rs_tpu.ops.ssqueeze import bin_params
from ssqueeze_rs_tpu_torch.ops import reassign_cuda
from ssqueeze_rs_tpu_torch.trace import COUNTS

GAMMA = 1e-5
FREQS = {
    "log": np.geomspace(0.05, 50.0, 200),
    "log-piecewise": np.hstack([np.geomspace(0.05, 1.0, 150, endpoint=False),
                                np.geomspace(1.0, 50.0, 50)]),
    "lin": np.linspace(0.05, 50.0, 200),
}


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def planes():
    """tests/test_reassign_pallas.py::_setup: a chirp's CWT and dWx."""
    N = 1024
    rng = np.random.default_rng(0)
    t = np.linspace(0, 10, N, endpoint=False)
    x = np.cos(2 * np.pi * 3 * np.exp(t / 3)) + 0.1 * rng.standard_normal(N)
    Wx, _, dWx = cwt(x, ("gmw", {"beta": 8.0}), scales="log", fs=N / 10,
                     derivative=True, dtype="float32")
    Wx, dWx = np.asarray(Wx).astype(np.complex64), np.asarray(dWx)
    return (Wx.real.copy(), Wx.imag.copy(), dWx.real.astype(np.float32),
            dWx.imag.astype(np.float32))


def _case(planes, mode_expect, flipud, transform="cwt"):
    C, D, A, B = planes
    na = C.shape[0]
    freqs = FREQS[mode_expect]
    mode, params = bin_params(freqs, mode_expect != "lin")
    assert mode == mode_expect
    const = np.full(na, 0.021, np.float32)
    Sfs = (np.linspace(0.0, 40.0, na) if transform == "stft"
           else np.zeros(na)).astype(np.float32)
    return (C, D, A, B, const, Sfs, GAMMA, params, mode, flipud, len(freqs),
            transform)


def _held(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.abs(out - ref).sum() / np.abs(ref).sum() < 2e-5
    assert ((np.abs(out) > 0) == (np.abs(ref) > 0)).mean() >= 0.9999


def _tx(pair):
    return (pair[0] + 1j * pair[1]).numpy()


@pytest.mark.parametrize("flipud", [False, True])
@pytest.mark.parametrize("mode_expect", list(FREQS))
def test_mxu_matches_jax_mxu(monkeypatch, planes, mode_expect, flipud):
    """The port under SSQ_TPU_REASSIGN_IMPL=mxu (plain I on the CPU)
    against the JAX package's MXU kernel under the same selector."""
    a = _case(planes, mode_expect, flipud)
    C, D, A, B, const, Sfs = a[:6]

    def both(impl):
        monkeypatch.setenv("SSQ_TPU_REASSIGN_IMPL", impl)
        before = (COUNTS["launch.ssq_reassign4"],
                  COUNTS["launch.ssq_reassign_mxu"])
        out = _tx(reassign_cuda.reassign4(*a))
        assert (COUNTS["launch.ssq_reassign4"],
                COUNTS["launch.ssq_reassign_mxu"]) == before
        ref = np.asarray(reassign_pallas(
            (jnp.asarray(C), jnp.asarray(D)), (jnp.asarray(A), jnp.asarray(B)),
            jnp.asarray(const), GAMMA, jnp.asarray(Sfs), a[7], mode=a[8],
            flipud=flipud, transform="cwt", nf=a[10], interpret=True))
        return out, ref

    mxu, mxu_jax = both("mxu")
    vpu, vpu_jax = both("vpu")
    assert mxu.shape == mxu_jax.shape == (a[10], C.shape[1])
    top = np.abs(mxu_jax).max()
    assert (np.abs(mxu - mxu_jax) <= 1e-6 * top).mean() >= 0.9999
    cs, cs_jax = mxu.sum(0), mxu_jax.sum(0)
    assert np.abs(cs - cs_jax).max() <= 1e-6 * np.abs(cs_jax).max()
    _held(mxu, vpu)
    assert (np.abs((mxu - vpu) - (mxu_jax - vpu_jax)).sum() /
            np.abs(vpu_jax).sum()) < 2e-5


@pytest.mark.parametrize("transform", ["cwt", "stft"])
@pytest.mark.parametrize("mode_expect", list(FREQS))
def test_mxu_plain_matches_b4_plain(planes, mode_expect, transform):
    """Plain I against the port's plain B' on the same planes, with a
    batch of two (the second planes doubled)."""
    a = _case(planes, mode_expect, transform == "cwt", transform)
    two = tuple(np.stack([p, 2 * p]) for p in a[:4])
    out = reassign_cuda.reassign_mxu_plain(*two, *a[4:])
    ref = reassign_cuda.reassign4_plain(*two, *a[4:])
    assert out[0].shape == (2, a[10], a[0].shape[1])
    for b in range(2):
        _held(_tx((out[0][b], out[1][b])), _tx((ref[0][b], ref[1][b])))


def test_gradient_through_mxu_is_b4s(monkeypatch, planes):
    """reassign4's gradient under 'mxu' equals the one under 'vpu' bit for
    bit (the shared backward C' over the same bins), with zero to dWx."""
    a = _case(planes, "log-piecewise", True)
    g = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (a[10], a[0].shape[1])).astype(np.float32))

    def grads(impl):
        monkeypatch.setenv("SSQ_TPU_REASSIGN_IMPL", impl)
        leaves = [torch.tensor(p, requires_grad=True) for p in a[:4]]
        txr, txi = reassign_cuda.reassign4(*leaves, *a[4:])
        (txr * g + txi * g.flip(0)).sum().backward()
        return [p.grad for p in leaves]

    vpu, mxu = grads("vpu"), grads("mxu")
    for gv, gm in zip(vpu, mxu):
        assert torch.equal(gv, gm)
    assert float(vpu[0].abs().max()) > 0
    assert not vpu[2].any() and not vpu[3].any()


def test_selector(monkeypatch, planes):
    """An unknown SSQ_TPU_REASSIGN_IMPL raises (the JAX package would run
    'vpu'); the 3-plane route (kernel B) ignores the variable; `'vpu'` and
    no value run B'; 'mxu' runs plain I on CPU tensors."""
    a = _case(planes, "log", True)
    monkeypatch.setenv("SSQ_TPU_REASSIGN_IMPL", "MXU")
    with pytest.raises(ValueError, match="SSQ_TPU_REASSIGN_IMPL"):
        reassign_cuda.reassign4(*a)
    C, D, A, B, const, Sfs = a[:6]
    w = reassign_cuda.phase_w(*(torch.as_tensor(p) for p in (C, D, A, B)),
                              torch.as_tensor(Sfs), GAMMA, "cwt")
    three = (C, D, w, const, a[7], a[8], True, a[10])
    got = reassign_cuda.reassign(*three)
    monkeypatch.delenv("SSQ_TPU_REASSIGN_IMPL")
    ref = reassign_cuda.reassign(*three)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    b4 = reassign_cuda.reassign4(*a)
    monkeypatch.setenv("SSQ_TPU_REASSIGN_IMPL", "vpu")
    assert all(torch.equal(x, y) for x, y in
               zip(reassign_cuda.reassign4(*a), b4))
    monkeypatch.setenv("SSQ_TPU_REASSIGN_IMPL", "mxu")
    assert all(torch.equal(x, y) for x, y in
               zip(reassign_cuda.reassign4(*a),
                   reassign_cuda.reassign_mxu_plain(*a)))


EDGES = [1, 8, 255, 256, 257, 293, 300, 512, 513, 1024, 1025, 2048, 2049,
         2688, 2689, 3632, reassign_cuda.MXU_MAX_NF]


@pytest.mark.parametrize("nf", EDGES)
def test_mxu_plan(nf):
    """Kernel I's host plan at every edge of its digit split: the
    smallest low-digit width that keeps the high digit under the wgmma's
    64 rows; N = 6 * f0 rounded up to 8 (16 past 128, 32 past 256) and
    shared by 1, 2 or 4 of a block's four warpgroups, at most 128 each;
    each warpgroup's accumulators within 64 registers a thread and at
    most 32 columns a block; whole k16 steps of 16 rows a stage and at
    most two entries a thread; shared memory within Hopper's 232 448
    bytes a block; one pass over the planes."""
    p = reassign_cuda._mxu_plan(nf)
    assert p.f0 == -(-nf // 64) and 64 * p.f0 >= nf > 64 * (p.f0 - 1)
    assert p.f1 == -(-nf // p.f0) <= 64
    step = 8 if 6 * p.f0 <= 128 else 16 if 6 * p.f0 <= 256 else 32
    assert p.n_tile % step == 0 and 0 <= p.n_tile - 6 * p.f0 < step
    assert p.split == min(s for s in (1, 2, 4) if p.n_tile // s <= 128)
    share = p.n_tile // p.split
    assert share % 8 == 0 and share <= 128
    per_group = p.cols * p.split // reassign_cuda.MXU_GROUPS
    assert per_group >= 1 and per_group * share // 2 <= 64 and p.cols <= 32
    assert p.cols == 32 or (per_group + 1) * share // 2 > 64
    assert p.rows % 16 == 0 and 16 <= p.rows <= 128
    assert p.rows * p.cols <= 2 * 128 * reassign_cuda.MXU_GROUPS or \
        p.rows == 16
    assert p.stages == 3
    assert p.smem == reassign_cuda._mxu_smem(p.n_tile, p.cols, p.rows)
    assert p.smem <= 232448
    assert p.passes == 1


def test_mxu_plan_shapes():
    """The plan at the timed shapes and where its width changes, and its
    range: every nf from 1 to 4096 in one pass; beyond, it raises, as B'
    does beyond its own limit (3632)."""
    plan = reassign_cuda._mxu_plan
    assert [tuple(plan(nf)[:6]) for nf in
            (8, 256, 257, 293, 300, 1025, 2048, 2688, 2689)] == \
        [(1, 8, 8, 1, 32, 32), (4, 64, 24, 1, 20, 48),
         (5, 52, 32, 1, 16, 48), (5, 59, 32, 1, 16, 48),
         (5, 60, 32, 1, 16, 48), (17, 61, 104, 1, 4, 128),
         (32, 64, 192, 2, 2, 128), (42, 64, 256, 2, 2, 112),
         (43, 63, 288, 4, 1, 128)]
    widths = {plan(nf).n_tile for nf in range(1, 4097)}
    assert widths == (set(range(8, 129, 8)) | set(range(144, 257, 16)) |
                      {288, 320, 352, 384})
    assert all(plan(nf).passes == 1 and plan(nf).smem <= 232448
               for nf in range(1, 4097))
    for nf in (0, 4097):
        with pytest.raises(ValueError, match="kernel I takes"):
            plan(nf)


def test_mxu_kernel_dispatches_every_width():
    """csrc/reassign_mxu.cu instantiates the kernel at every wgmma width
    the plan hands it, and its constants are the plan's."""
    import os
    import re
    from ssqueeze_rs_tpu_torch import _build
    with open(os.path.join(_build.CSRC, "reassign_mxu.cu")) as f:
        text = f.read()
    cases = {int(c) for c in re.findall(r"SSQ_MXU_CASE\((\d+)\)", text)}
    assert cases == {reassign_cuda._mxu_plan(nf).n_tile
                     for nf in range(1, 4097)}
    for const, value in (("kMaxNf", reassign_cuda.MXU_MAX_NF),
                         ("kStages", reassign_cuda.MXU_STAGES),
                         ("kGroups", reassign_cuda.MXU_GROUPS),
                         ("kAccRegs", reassign_cuda._MXU_ACC),
                         ("kMaxCols", reassign_cuda._MXU_MAX_COLS),
                         ("kMaxEntries", reassign_cuda._MXU_ENTRIES),
                         ("kMaxRows", reassign_cuda._MXU_MAX_ROWS)):
        assert f"constexpr int {const} = {value};" in text, const
    assert "atomicAdd" not in text and "blockIdx.z" not in text


def _at(k, row):
    """Byte of element (k, row) of a K-major, unswizzled bf16 tile
    (csrc/wgmma.cuh: LBO 128, SBO 256)."""
    return (row & 7) * 16 + (k & 7) * 2 + (k >> 3) * 128 + (row >> 3) * 256


def _tiles_model(khi, klo, parts, f0, n_tile):
    """numpy model of one column of kernel I through the layouts of
    csrc/reassign_mxu.cu: for each step of 16 rows the A tile (64 x 16,
    a one at (row e, khi)) and the B tile (16 x n_tile, the parts of the
    real then the imaginary value at e, (3 c + p) * f0 + klo) written as
    bf16 slots at `_at`'s bytes, read back through the descriptor's
    layout, D += A @ B; then Tx[c][f1 * f0 + g] = (D[f1, 3c f0 + g] +
    D[f1, (3c+1) f0 + g]) + D[f1, (3c+2) f0 + g] in float32, as the
    store sums it. khi/klo (rows,), parts (rows, 2, 3) float32; returns
    (2, 64 * f0)."""
    rows = len(khi)
    D = np.zeros((64, n_tile))
    for s0 in range(0, rows, 16):
        ta = np.zeros(1024, np.float32)
        tb = np.zeros(16 * n_tile, np.float32)
        for e in range(16):
            i = s0 + e
            if i >= rows or khi[i] < 0:
                continue
            ta[_at(e, khi[i]) // 2] = 1.0
            for z in range(6):
                tb[_at(e, z * f0 + klo[i]) // 2] = parts[i, z // 3, z % 3]
        A = np.array([[ta[_at(k, m) // 2] for k in range(16)]
                      for m in range(64)])
        B = np.array([[tb[_at(k, c) // 2] for c in range(n_tile)]
                      for k in range(16)])
        D += A @ B
    D = D.astype(np.float32)
    out = np.zeros((2, 64 * f0), np.float32)
    for c in range(2):
        for f1 in range(64):
            for g in range(f0):
                out[c, f1 * f0 + g] = (D[f1, 3 * c * f0 + g] +
                                       D[f1, (3 * c + 1) * f0 + g]) + \
                    D[f1, (3 * c + 2) * f0 + g]
    return out


@pytest.mark.parametrize("nf", [8, 293, 1025])
def test_kernel_layout_model(nf):
    """The kernel's index arithmetic, modelled in numpy on a seeded
    column (a third of its rows masked, several rows a bin, a row count
    that leaves a partial step): the A and B tile bytes, the descriptor's
    reading of them and the store's bins give the scatter sum_i v_i at
    bin k_i, as the plain version does."""
    rng = np.random.default_rng(nf)
    p = reassign_cuda._mxu_plan(nf)
    rows = 45
    k = rng.integers(0, nf, rows)
    k[: rows // 4] = k[rows // 4: 2 * (rows // 4)]       # shared bins
    k[rng.random(rows) < 0.3] = -1
    v = rng.standard_normal((rows, 2)).astype(np.float32)
    parts = np.stack([np.stack([q.numpy() for q in reassign_cuda._split3(
        torch.as_tensor(v[:, z]))], 1) for z in range(2)], 1)
    assert np.array_equal(parts.astype(np.float64).sum(2),
                          v.astype(np.float64))
    khi = np.where(k >= 0, k // p.f0, -1)
    klo = np.where(k >= 0, k % p.f0, 0)
    got = _tiles_model(khi, klo, parts, p.f0, p.n_tile)[:, :nf]
    want = np.zeros((2, nf))
    for i in np.flatnonzero(k >= 0):
        want[:, k[i]] += v[i]
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert np.array_equal(got != 0, want != 0)


def test_phase_probe_edits_apply():
    """tools/reassign_mxu_phases.py edits the kernel's source at fixed
    anchors (its clocks around every phase, its two ablations): each
    anchor is in reassign_mxu.cu once, the clocks cover its phases, and
    without a card the tool raises."""
    import os
    from ssqueeze_rs_tpu_torch import _build
    from ssqueeze_rs_tpu_torch.tools import reassign_mxu_phases as probe
    with open(os.path.join(_build.CSRC, "reassign_mxu.cu")) as f:
        text = f.read()
    clocked = probe.clocked_source(text)
    assert clocked.count("pr[") == len(probe.PHASES) + 2
    assert "ssq_mxu_phase_clocks" in clocked
    for name in ("no_products", "no_bins"):
        assert probe.ablated_source(text, name).count("N < 0") == 1
    with pytest.raises(ValueError, match="anchor"):
        probe.clocked_source(text.replace("__syncthreads();", ""))
    with pytest.raises(RuntimeError):
        probe.main(["1", "--device", "cpu"])
