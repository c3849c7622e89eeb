"""Kernel B's plain-torch versions against the JAX package's
reassignment kernel (`reassign_pallas`, Pallas in interpret mode), both
fed the SAME planes, for the log, log-piecewise and lin bin modes:
`reassign_plain` (B) against its 3-plane contract (`w_plane`), flipud on
and off, and `reassign4_plain` (B') against its 4-plane contract (Wx and
dWx), for the CWT and the STFT phase transforms.

Tolerances: log2 may differ by an ulp between torch and XLA, which can
move a value across a rounding tie, so the bin indices must agree on
>= 99.99 % of unmasked entries (not all); the per-column sum over bins,
which does not depend on the bins, must agree to 1e-6 of the largest
column sum (the two sum the same float32 products in other orders).
For B', the bins of the torch phase plane and of the JAX binning code run
eagerly agree on >= 99.99 % of unmasked entries; the Tx entries agree to
1e-6 of max|Tx| on >= 99.99 % of entries (the JAX kernel's fused XLA
code rounds w in its own way, so its bins can differ from the eager ones
too, and each bin that moves changes two entries); column sums as for B.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ssqueeze_rs_tpu import cwt
from ssqueeze_rs_tpu.ops.reassign_pallas import _bin_indices, reassign_pallas
from ssqueeze_rs_tpu.ops.ssqueeze import bin_params
from ssqueeze_rs_tpu_torch.ops import reassign_cuda

GAMMA = 1e-6

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
    """A chirp's CWT planes and its w plane (the fused-phase formula, +inf
    where |Wx|^2 <= gamma^2), with sub-gamma rows so the mask is used;
    then the dWx planes."""
    N = 1024
    rng = np.random.default_rng(0)
    t = np.linspace(0, 10, N, endpoint=False)
    x = np.cos(2 * np.pi * 3 * np.exp(t / 3)) + 0.1 * rng.standard_normal(N)
    Wx, _, dWx = cwt(x, ("gmw", {"beta": 8.0}), scales="log", fs=N / 10,
                     derivative=True, dtype="float32")
    Wx, dWx = np.asarray(Wx).copy(), np.asarray(dWx)
    Wx[40:45] *= 1e-9
    C, D = Wx.real, Wx.imag
    A, B = dWx.real, dWx.imag
    mag2 = C * C + D * D
    w = np.abs((B * C - A * D) / (mag2 * np.float32(6.283185307179586)))
    w = np.where(mag2 > np.float32(GAMMA ** 2), w, np.inf).astype(np.float32)
    const = np.linspace(0.01, 0.05, Wx.shape[0]).astype(np.float32)
    return C, D, w, const, A.astype(np.float32), B.astype(np.float32)


def _jax_tx(C, D, w, const, mode, params, flipud, nf):
    out = reassign_pallas((jnp.asarray(C), jnp.asarray(D)), None,
                          jnp.asarray(const), GAMMA,
                          jnp.zeros((C.shape[0],), jnp.float32), params,
                          mode=mode, flipud=flipud, transform="cwt", nf=nf,
                          interpret=True, w_plane=jnp.asarray(w))
    return np.asarray(out)


@pytest.mark.parametrize("flipud", [False, True])
@pytest.mark.parametrize("mode_expect", list(FREQS))
def test_plain_matches_jax_kernel(planes, mode_expect, flipud):
    C, D, w, const = planes[:4]
    freqs = FREQS[mode_expect]
    mode, params = bin_params(freqs, mode_expect != "lin")
    assert mode == mode_expect
    nf = len(freqs)

    k_jax, _ = _bin_indices(mode, dict(params), GAMMA, flipud, "cwt", nf,
                            w.shape[1], w.shape[1], None, None, None, None,
                            None, w_pre=jnp.asarray(w))
    k_jax = np.asarray(k_jax)
    k_t = reassign_cuda.bin_indices(torch.as_tensor(w), mode, params,
                                    flipud, nf).numpy()
    assert np.array_equal(k_jax < 0, k_t < 0)
    unmasked = k_jax >= 0
    assert unmasked.mean() > 0.9 and not unmasked.all()
    assert (k_jax == k_t)[unmasked].mean() >= 0.9999

    txr, txi = reassign_cuda.reassign_plain(C, D, w, const, params, mode,
                                            flipud, nf)
    tx = (txr + 1j * txi).numpy()
    tx_jax = _jax_tx(C, D, w, const, mode, params, flipud, nf)
    assert tx.shape == tx_jax.shape == (nf, C.shape[1])
    cs, cs_jax = tx.sum(0), tx_jax.sum(0)
    assert np.abs(cs - cs_jax).max() <= 1e-6 * np.abs(cs_jax).max()


def test_batch_and_cpu_dispatch(planes):
    """(2, na, n) planes give each signal's own Tx; a CPU call never
    launches the kernel; numpy input lands on the CPU."""
    C, D, w, const = planes[:4]
    mode, params = bin_params(FREQS["log"], True)
    nf = len(FREQS["log"])
    one = reassign_cuda.reassign_plain(C, D, w, const, params, mode, True, nf)
    C2 = np.stack([C, 2 * C])
    D2 = np.stack([D, 2 * D])
    w2 = np.stack([w, w])
    before = reassign_cuda.LAUNCHES
    two = reassign_cuda.reassign(C2, D2, w2, const, params, mode, True, nf)
    assert reassign_cuda.LAUNCHES == before
    assert two[0].device.type == "cpu" and two[0].shape == (2, nf, C.shape[1])
    for a, b in zip(two, one):
        assert torch.equal(a[0], b)
        assert torch.equal(a[1], 2 * b)


def test_width_and_const_checks(planes):
    """Plane widths are checked up front (the JAX wrapper only fails in
    a reshape)."""
    C, D, w, const = planes[:4]
    mode, params = bin_params(FREQS["log"], True)
    with pytest.raises(ValueError, match="share one"):
        reassign_cuda.reassign(C, D, w[:, :-1], const, params, mode, True, 200)
    with pytest.raises(ValueError, match="const"):
        reassign_cuda.reassign(C, D, w, const[:-1], params, mode, True, 200)
    with pytest.raises(ValueError, match="mode"):
        reassign_cuda.reassign(C, D, w, const, params, "nope", True, 200)


@pytest.mark.parametrize("transform", ["cwt", "stft"])
@pytest.mark.parametrize("mode_expect", list(FREQS))
def test_plain4_matches_jax_kernel(planes, mode_expect, transform):
    """B' (4 planes, w and mask formed from Wx and dWx) against the JAX
    kernel's 4-plane contract."""
    C, D, _, const, A, B = planes
    na, n = C.shape
    freqs = FREQS[mode_expect]
    mode, params = bin_params(freqs, mode_expect != "lin")
    nf = len(freqs)
    Sfs = np.linspace(0.0, 40.0, na).astype(np.float32)
    flipud = transform == "cwt"

    k_jax, mask = _bin_indices(mode, dict(params), GAMMA, flipud, transform,
                               nf, n, n, jnp.asarray(C), jnp.asarray(D),
                               jnp.asarray(A), jnp.asarray(B),
                               jnp.asarray(Sfs)[:, None])
    k_jax = np.asarray(k_jax)
    w = reassign_cuda.phase_w(*(torch.as_tensor(a) for a in (C, D, A, B)),
                              torch.as_tensor(Sfs), GAMMA, transform)
    k_t = reassign_cuda.bin_indices(w, mode, params, flipud, nf).numpy()
    assert np.array_equal(k_jax < 0, k_t < 0)
    unmasked = k_jax >= 0
    assert unmasked.mean() > 0.9 and not unmasked.all()
    agree = k_jax == k_t
    assert agree[unmasked].mean() >= 0.9999

    before = reassign_cuda.LAUNCHES4
    txr, txi = reassign_cuda.reassign4(C, D, A, B, const, Sfs, GAMMA, params,
                                       mode, flipud, nf, transform)
    assert reassign_cuda.LAUNCHES4 == before
    tx = (txr + 1j * txi).numpy()
    tx_jax = np.asarray(reassign_pallas(
        (jnp.asarray(C), jnp.asarray(D)), (jnp.asarray(A), jnp.asarray(B)),
        jnp.asarray(const), GAMMA, jnp.asarray(Sfs), params, mode=mode,
        flipud=flipud, transform=transform, nf=nf, interpret=True))
    assert tx.shape == tx_jax.shape == (nf, n)
    top = np.abs(tx_jax).max()
    assert (np.abs(tx - tx_jax) <= 1e-6 * top).mean() >= 0.9999
    cs, cs_jax = tx.sum(0), tx_jax.sum(0)
    assert np.abs(cs - cs_jax).max() <= 1e-6 * np.abs(cs_jax).max()


def test_block_cols_repair():
    """Columns per block of csrc/reassign.cu chosen from nf: the (2, nf,
    cols) accumulator stays within 227 KB of shared memory. With the fixed
    32 columns, nf = 909 and above (the STFT's 1025 rows at n_fft = 2048)
    were refused. Since the kernel has 16 lanes a column, 8 columns
    follow 32 (16 were slower on the card at nf = 1025)."""
    assert reassign_cuda._block_cols(300) == 32
    assert reassign_cuda._block_cols(908) == 32
    assert reassign_cuda._block_cols(909) == 8
    assert reassign_cuda._block_cols(1025) == 8
    assert reassign_cuda._block_cols(3632) == 8
    with pytest.raises(ValueError, match="shared-memory"):
        reassign_cuda._block_cols(3633)


# -- the lane walk of csrc/reassign.cu -------------------------------------------
LANES = 16          # lanes a column (csrc/reassign.cuh kLanes): rows a step
COLS = (32, 8)      # the columns a block the entry points dispatch


def _lane_map(cols):
    """Thread t of a block -> (column c, row group g): lane l of warp w
    covers column 2 * w + l % 2 and row group l / 2."""
    t = np.arange(cols * LANES)
    lane = t % 32
    return (t // 32) * 2 + lane % 2, lane // 2


def _add_once(acc, b, ti, ks, cs, rs, is_):
    """acc[:, b, ti, ks, cs] += (rs, is_), asserting that no (bin,
    column) of a block takes two adds at once."""
    key = np.stack([b, ti, ks, cs])
    assert np.unique(key, axis=1).shape[1] == key.shape[1]
    acc[0, b, ti, ks, cs] += rs
    acc[1, b, ti, ks, cs] += is_


def _lanes_model(vr, vi, k, nf, cols):
    """numpy model of the walk of csrc/reassign.cu over (B, na, n) float32
    products vr, vi and int bins k (-1 masked): per block of `cols`
    columns, at the step of rows i0 .. i0 + 15, thread (c, g) loads row
    i0 + g of its column and adds its own entry; the lanes of a warp whose
    entries share a (bin, column) key go in rounds by rank, the count of
    lower lanes with the key. Asserts that no (bin, column) takes two adds
    at once."""
    B, na, n = k.shape
    c, g = _lane_map(cols)
    lane = np.arange(cols * LANES) % 32
    tiles = -(-n // cols)
    pad = ((0, 0), (0, 0), (0, tiles * cols - n))

    def blocks(a, fill):
        a = np.pad(a, pad, constant_values=fill)
        return a.reshape(B, na, tiles, cols).transpose(0, 2, 1, 3)

    kb, rb, ib = blocks(k, -1), blocks(vr, 0), blocks(vi, 0)
    acc = np.zeros((2, B, tiles, nf, cols), np.float32)
    lower = np.tril(np.ones((32, 32), bool), -1)     # [l, l']: l' < l
    for i0 in range(0, na, LANES):
        rows = i0 + g
        r = np.minimum(rows, na - 1)
        kl = np.where(rows < na, kb[:, :, r, c], -1)  # (B, tiles, T)
        rl, il = rb[:, :, r, c], ib[:, :, r, c]
        key = np.where(kl >= 0, kl * cols + c, -1 - lane)
        kw = key.reshape(B, tiles, -1, 32)
        same = kw[..., :, None] == kw[..., None, :]
        rank = (same & lower).sum(-1).reshape(kl.shape)
        for rnd in range(int(rank.max()) + 1):
            bi, ti, th = np.nonzero((rank == rnd) & (kl >= 0))
            _add_once(acc, bi, ti, kl[bi, ti, th], c[th], rl[bi, ti, th],
                      il[bi, ti, th])
    out = acc.transpose(0, 1, 3, 2, 4).reshape(2, B, nf, tiles * cols)
    return out[..., :n]


def _ordered_sum(vr, vi, k, nf):
    """Tx[k(i, j), j] += v[i, j] in float32, rows in increasing order."""
    B, na, n = k.shape
    out = np.zeros((2, B, nf, n), np.float32)
    for i in range(na):
        b, j = np.nonzero(k[:, i] >= 0)
        out[0, b, k[b, i, j], j] += vr[b, i, j]
        out[1, b, k[b, i, j], j] += vi[b, i, j]
    return out


def _walk_inputs(nf, mode, seed, na=24, n=70):
    """Seeded (2, na, n) Wx and dWx planes with masked entries, const,
    Sfs and the plan of `mode` at nf bins."""
    rng = np.random.default_rng(seed)
    wr, wi, dr, di = (rng.standard_normal((2, na, n)).astype(np.float32)
                      for _ in range(4))
    wr[:, 1, :9] = wi[:, 1, :9] = 0          # |Wx|^2 <= gamma^2: masked
    dr *= np.float32(0.05)
    di *= np.float32(0.05)
    const = rng.uniform(0.01, 0.05, na).astype(np.float32)
    Sfs = np.linspace(0.0, 0.5, na).astype(np.float32)
    if nf == 1:
        return (wr, wi, dr, di, const, Sfs), "lin", dict(vmin=0.0, dv=0.25)
    freqs = {"log": np.geomspace(0.005, 0.5, nf),
             "lin": np.linspace(0.0, 0.5, nf),
             "log-piecewise": np.hstack([
                 np.geomspace(0.005, 0.1, int(0.7 * nf), endpoint=False),
                 np.geomspace(0.1, 0.5, nf - int(0.7 * nf))])}[mode]
    got, params = bin_params(freqs, mode != "lin")
    assert got == mode
    return (wr, wi, dr, di, const, Sfs), mode, params


WALK_CASES = [(1, "lin"), (7, "log"), (7, "lin"), (293, "log"),
              (293, "log-piecewise"), (293, "lin"), (1025, "lin"),
              (1025, "log-piecewise")]


@pytest.mark.parametrize("flipud", [False, True])
@pytest.mark.parametrize("nf, mode", WALK_CASES)
def test_lane_walk_model(nf, mode, flipud):
    """The model of the kernel's lane walk, at the planner's columns a
    block and at every dispatched one that fits, gives the float32 ordered
    sum bit for bit, for the 3-plane (B, w given) and 4-plane (B', w
    formed from Wx and dWx) contracts; and the plain versions within 1e-6
    of max|Tx|."""
    (wr, wi, dr, di, const, Sfs), mode, params = _walk_inputs(
        nf, mode, seed=nf + len(mode))
    T = [torch.as_tensor(a) for a in (wr, wi, dr, di, const, Sfs)]
    w4 = reassign_cuda.phase_w(*T[:4], T[5], GAMMA, "stft")
    w3 = torch.where(T[0].abs() > 2.0, torch.full_like(w4, float("inf")),
                     w4)                    # a w plane with its own mask
    plain = {
        3: reassign_cuda.reassign_plain(T[0], T[1], w3, T[4], params, mode,
                                        flipud, nf),
        4: reassign_cuda.reassign4_plain(*T, GAMMA, params, mode, flipud, nf,
                                         "stft")}
    widths = {reassign_cuda._block_cols(nf)} | {
        c for c in COLS if 2 * nf * c * 4 <= reassign_cuda.MAX_SMEM}
    for planes, w in ((3, w3), (4, w4)):
        k = reassign_cuda.bin_indices(w, mode, params, flipud, nf).numpy()
        assert (k < 0).any() and (k >= 0).mean() > 0.5
        vr, vi = wr * const[:, None], wi * const[:, None]
        ref = _ordered_sum(vr, vi, k, nf)
        top = np.abs(ref).max()
        for i in range(2):
            assert np.abs(plain[planes][i].numpy() - ref[i]).max() <= \
                1e-6 * top
        for cols in sorted(widths):
            got = _lanes_model(vr, vi, k, nf, cols)
            assert np.array_equal(got, ref), (planes, cols)


def test_plans_fit_and_own_every_bin_once():
    """For every nf the kernel takes (1..3632), the planner's columns a
    block are dispatched, fit 227 KB of shared memory and give at least
    128 threads a block; 32 columns wherever they fit. Every (column,
    group) is one thread's, and the 16 lanes of a column lie in one warp,
    so each (bin, column) of a block is one warp's, whose rounds order
    its adds; the accumulator's swizzle (column c of bin k at c ^ (k mod
    COLS)) gives every (bin, column) its own word."""
    for nf in range(1, 3633):
        cols = reassign_cuda._block_cols(nf)
        assert cols in COLS, nf
        assert 2 * nf * cols * 4 <= 227 * 1024, nf
        assert cols * LANES >= 128 and cols * LANES % 32 == 0, nf
        assert (cols == 32) == (2 * nf * 32 * 4 <= 227 * 1024), nf
    for cols in COLS:
        c, g = _lane_map(cols)
        assert len(set(zip(c, g))) == cols * LANES
        assert set(c) == set(range(cols)) and set(g) == set(range(LANES))
        warp = np.arange(cols * LANES) // 32
        for col in range(cols):
            assert len(set(warp[c == col])) == 1, (cols, col)
        nf = (227 * 1024) // (2 * cols * 4)
        kk, cc = np.meshgrid(np.arange(nf), np.arange(cols), indexing="ij")
        at = kk * cols + (cc ^ (kk & (cols - 1)))
        assert np.unique(at).size == nf * cols
        assert at.min() == 0 and at.max() == nf * cols - 1
