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
from ssqueeze_rs_tpu_torch.trace import COUNTS

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
    before = COUNTS["launch.ssq_reassign"]
    two = reassign_cuda.reassign(C2, D2, w2, const, params, mode, True, nf)
    assert COUNTS["launch.ssq_reassign"] == before
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

    before = COUNTS["launch.ssq_reassign4"]
    txr, txi = reassign_cuda.reassign4(C, D, A, B, const, Sfs, GAMMA, params,
                                       mode, flipud, nf, transform)
    assert COUNTS["launch.ssq_reassign4"] == before
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
    """Tx[k(i, j), j] += v[i, j] in v's type, rows in increasing order."""
    B, na, n = k.shape
    out = np.zeros((2, B, nf, n), vr.dtype)
    for i in range(na):
        b, j = np.nonzero(k[:, i] >= 0)
        out[0, b, k[b, i, j], j] += vr[b, i, j]
        out[1, b, k[b, i, j], j] += vi[b, i, j]
    return out


def _walk_inputs(nf, mode, seed, na=24, n=70, dtype=np.float32):
    """Seeded (2, na, n) Wx and dWx planes of `dtype` with masked entries,
    const, Sfs and the plan of `mode` at nf bins."""
    rng = np.random.default_rng(seed)
    wr, wi, dr, di = (rng.standard_normal((2, na, n)).astype(dtype)
                      for _ in range(4))
    wr[:, 1, :9] = wi[:, 1, :9] = 0          # |Wx|^2 <= gamma^2: masked
    dr *= dtype(0.05)
    di *= dtype(0.05)
    const = rng.uniform(0.01, 0.05, na).astype(dtype)
    Sfs = np.linspace(0.0, 0.5, na).astype(dtype)
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


# -- the walk of csrc/reassign64.cu (B and B' in double) --------------------------
def _stage_at64(r, c, cols):
    """Word of row r, column c in a stage plane of reassign64.cu: the TMA
    box, dense, 16-byte chunks of each 128-byte line permuted by the
    line's row bits (swizzle 64, 32 bytes at 8, 4 columns)."""
    off = (r * cols + c) * 8
    mask = {8: 3, 4: 1, 2: 0}[cols]
    return (off ^ (((off >> 7) & mask) << 4)) // 8


def _acc_at64(k, c, cols):
    """Word of bin k, column c in an accumulator plane of reassign64.cu:
    the (nf, cols) TMA box of the Tx store, with the stage's swizzle."""
    return _stage_at64(k, c, cols)


def _lane_map64(cols, groups):
    """Thread t of a block of reassign64.cu -> (row group h, column c,
    stage row g, warp): lane l of warp w is column 2 (w mod cols/2) +
    l mod 2 and row 16 h + l / 2 of the stage, h = w / (cols/2)."""
    t = np.arange(16 * cols * groups)
    lane, warp = t % 32, t // 32
    h = warp // (cols // 2)
    return h, (warp % (cols // 2)) * 2 + lane % 2, h * 16 + lane // 2, warp


def _lanes_model64(vr, vi, k, nf, cols, groups, grid=3):
    """numpy model of the walk of csrc/reassign64.cu over (B, na, n)
    float64 products vr, vi and int bins k (-1 masked): `grid` persistent
    blocks, block b taking tiles (cols columns of one batch item) b,
    b + grid, ... with one accumulator; a tile in stages of 16 groups
    rows; at each stage every thread takes its entry, then the row groups
    add in turn, in a group the lanes of a warp sharing a (bin, column)
    key in rounds by rank (the lower lanes with the key); after a tile's
    last stage its Tx columns are read out of the swizzled accumulator,
    which is zeroed. Asserts that no word of a block takes two adds at
    once."""
    B, na, n = k.shape
    h, c, g, _ = _lane_map64(cols, groups)
    lane = np.arange(h.size) % 32
    rows = 16 * groups
    T = max(1, -(-na // rows))
    tiles_row = -(-n // cols)
    tiles = B * tiles_row
    grid = min(grid, tiles)
    out = np.full((2, B, nf, n), np.nan)
    acc = np.zeros((2, grid, nf * cols))
    lower = np.tril(np.ones((32, 32), bool), -1)     # [l, l']: l' < l
    kk, cc = np.meshgrid(np.arange(nf), np.arange(cols), indexing="ij")
    words = _acc_at64(kk, cc, cols)
    for it in range(-(-tiles // grid)):
        tile = np.arange(grid) + it * grid
        alive = tile < tiles
        bat = np.where(alive, tile // tiles_row, 0)
        j0 = (tile % tiles_row) * cols
        for s in range(T):
            i = s * rows + g
            j = j0[:, None] + c
            live = alive[:, None] & (i < na) & (j < n)
            at = (bat[:, None], np.minimum(i, na - 1), np.minimum(j, n - 1))
            kl = np.where(live, k[at], -1)
            pr, pi = vr[at], vi[at]
            key = np.where(kl >= 0, kl * cols + c, -1 - lane)
            kw = key.reshape(grid, -1, 32)
            same = kw[..., :, None] == kw[..., None, :]
            rank = (same & lower).sum(-1).reshape(key.shape)
            for grp in range(groups):
                for rnd in range(int(rank.max()) + 1):
                    bi, th = np.nonzero((rank == rnd) & (kl >= 0) &
                                        (h == grp))
                    a = _acc_at64(kl[bi, th], c[th], cols)
                    assert np.unique(np.stack([bi, a]), axis=1).shape[1] \
                        == a.size
                    acc[0, bi, a] += pr[bi, th]
                    acc[1, bi, a] += pi[bi, th]
        for b in np.nonzero(alive)[0]:
            ok = j0[b] + cc < n
            out[:, bat[b], kk[ok], j0[b] + cc[ok]] = acc[:, b, words[ok]]
        acc[:] = 0.0
    return out


WALK64_CASES = WALK_CASES + [(490, "log-piecewise"), (2000, "log")]


@pytest.mark.parametrize("flipud", [False, True])
@pytest.mark.parametrize("nf, mode", WALK64_CASES)
def test_lane_walk_model_f64(nf, mode, flipud):
    """The model of the double kernel's walk, at the plan's columns and
    row groups for 3 and 4 planes, over three stages of rows (the last
    ragged) and ragged tiles, gives the float64 row-ordered sum bit for
    bit, for the 3-plane (B, w given) and 4-plane (B', w formed from Wx
    and dWx) contracts; the plain versions agree to 1e-12 of max|Tx|."""
    rows = {p: reassign_cuda._f64_plan(nf, p).rows for p in (3, 4)}
    (wr, wi, dr, di, const, Sfs), mode, params = _walk_inputs(
        nf, mode, seed=nf + len(mode), na=2 * max(rows.values()) + 5,
        dtype=np.float64)
    T = [torch.as_tensor(a) for a in (wr, wi, dr, di, const, Sfs)]
    w4 = reassign_cuda.phase_w(*T[:4], T[5], GAMMA, "stft")
    w3 = torch.where(T[0].abs() > 2.0, torch.full_like(w4, float("inf")),
                     w4)
    plain = {
        3: reassign_cuda.reassign_plain(T[0], T[1], w3, T[4], params, mode,
                                        flipud, nf),
        4: reassign_cuda.reassign4_plain(*T, GAMMA, params, mode, flipud, nf,
                                         "stft")}
    for planes, w in ((3, w3), (4, w4)):
        plan = reassign_cuda._f64_plan(nf, planes)
        k = reassign_cuda.bin_indices(w, mode, params, flipud, nf).numpy()
        assert (k < 0).any() and (k >= 0).mean() > 0.5
        vr, vi = wr * const[:, None], wi * const[:, None]
        ref = _ordered_sum(vr, vi, k, nf)
        top = np.abs(ref).max()
        for i in range(2):
            assert plain[planes][i].dtype == torch.float64
            assert np.abs(plain[planes][i].numpy() - ref[i]).max() <= \
                1e-12 * top
        got = _lanes_model64(vr, vi, k, nf, plan.cols, plan.groups)
        assert np.array_equal(got, ref), (planes, plan)


@pytest.mark.parametrize("shape", sorted(
    (c, g) for c, gs in reassign_cuda.F64_SHAPES.items() for g in gs))
def test_lane_walk_model_f64_every_shape(shape):
    """Every instantiated (columns, row groups) of reassign64.cu walks to
    the float64 row-ordered sum bit for bit (log-piecewise bins at nf =
    293 over 2.5 stages of rows, ragged tiles, a batch of two)."""
    cols, groups = shape
    (wr, wi, dr, di, const, Sfs), mode, params = _walk_inputs(
        293, "log-piecewise", seed=cols * 100 + groups,
        na=40 * groups + 3, n=37, dtype=np.float64)
    T = [torch.as_tensor(a) for a in (wr, wi, dr, di, const, Sfs)]
    w = reassign_cuda.phase_w(*T[:4], T[5], GAMMA, "stft")
    k = reassign_cuda.bin_indices(w, mode, params, True, 293).numpy()
    vr, vi = wr * const[:, None], wi * const[:, None]
    got = _lanes_model64(vr, vi, k, 293, cols, groups, grid=2)
    assert np.array_equal(got, _ordered_sum(vr, vi, k, 293))


def test_f64_plans_fit_and_own_every_bin_once():
    """For every nf the double kernels take (1..3632) and 3 or 4 planes:
    the plan's accumulator, ring and alignment slack fit a block's 227 KB
    and its blocks
    the SM's 228 KB (less 1 KB a block), at least F64_MIN_FLIGHT plane
    bytes are in flight an SM, 16 to 32 warps an SM, 8 columns (64-byte
    plane row runs) wherever their accumulator leaves a ring, and the
    plan takes the instantiated shapes, every one of them. Per shape:
    the column pairs' row-group barriers fit the block's 15 named ones;
    every (column, stage row) is one
    thread's; in each row group a column's lanes lie in one warp (a (bin,
    column) takes its adds from one warp at a time, the groups in turn);
    the stage's swizzle (the TMA box's) permutes its words and gives a
    half-warp's reads 16 bank pairs; the accumulator (the Tx store's TMA
    box, swizzled alike) gives every (bin, column) its own word within
    its 1024-byte-rounded plane, and a half-warp's adds (8 bins that
    differ in their low three bits, in each of its 2 columns) 16 bank
    pairs."""
    R = reassign_cuda
    used = set()
    for nf in range(1, 3633):
        for planes in (3, 4):
            p = R._f64_plan(nf, planes)
            stage = R._f64_stage(p.cols, p.groups, planes)
            assert p.groups in R.F64_SHAPES[p.cols], (nf, p)
            assert p.rows == 16 * p.groups and 2 <= p.stages <= 16
            assert p.smem == 1024 + R._f64_acc(nf, p.cols) + \
                p.stages * stage
            assert p.smem <= R.MAX_SMEM, (nf, p)
            assert p.blocks * (p.smem + R.BLOCK_RESERVE) <= R.SM_SMEM
            # the kernel's dispatch finds the blocks an SM from smem
            assert min(4, R.SM_SMEM // (p.smem + R.BLOCK_RESERVE)) == \
                p.blocks or p.groups > 2, (nf, p)
            assert p.flight == p.blocks * (p.stages - 1) * (stage - 8)
            assert p.flight >= R.F64_MIN_FLIGHT, (nf, p)
            assert 512 <= p.blocks * 16 * p.cols * p.groups <= 1024
            st8 = R._f64_stage(8, 4, planes)      # one block at 8 columns
            need = max(2, 1 + -(-R.F64_MIN_FLIGHT // (st8 - 8)))
            assert p.cols == 8 or R._f64_smem(nf, 8, 4, planes, need) > \
                R.MAX_SMEM, (nf, p)                   # 64-byte runs
            used.add((p.cols, p.groups))
    with pytest.raises(ValueError, match="1 to 3632"):
        R._f64_plan(3633)
    shapes = {(c, g) for c, gs in R.F64_SHAPES.items() for g in gs}
    assert used == shapes
    for cols, groups in shapes:
        assert cols // 2 * (groups - 1) <= 15
        h, c, g, warp = _lane_map64(cols, groups)
        assert len(set(zip(c, g))) == c.size == 16 * cols * groups
        for grp in range(groups):
            for col in range(cols):
                assert len(set(warp[(h == grp) & (c == col)])) == 1
        words = _stage_at64(g, c, cols)
        assert np.unique(words).size == c.size        # a permutation
        assert words.max() == c.size - 1
        for half in range(0, c.size, 16):
            assert np.unique(words[half:half + 16] % 16).size == 16, \
                (cols, groups)
        for nf in (1, 7, 293, 1025, R.MAX_SMEM // (16 * cols)):
            kk, cc = np.meshgrid(np.arange(nf), np.arange(cols),
                                 indexing="ij")
            at = _acc_at64(kk, cc, cols)
            assert np.unique(at).size == nf * cols
            assert at.min() == 0 and 8 * (at.max() + 1) <= \
                R._f64_acc(nf, cols) // 2
        for m in range(cols // 2):
            for k0 in (0, 8, 288, 1021):
                kk = np.arange(k0, k0 + 8)
                words = np.concatenate([_acc_at64(kk, 2 * m, cols),
                                        _acc_at64(kk, 2 * m + 1, cols)])
                assert np.unique(words % 16).size == 16, (cols, m, k0)


# -- the bin screen of csrc/reassign64.cu ------------------------------------------
F32 = np.float32


def _screen_cell(qs, eq):
    """reassign64.cu screen_cell: (m, decided) with [qs - eq, qs + eq]
    inside (m - 1/2, m + 1/2), in double."""
    lo, hi = np.floor(qs - eq + 0.5), np.floor(qs + eq + 0.5)
    ok = (eq < 0.25) & (np.abs(qs) < 1e9) & (lo == hi)
    return np.where(ok, lo, 0).astype(np.int64), ok


def _bin_screen(wf, rel, mode, prm, nf, lf):
    """reassign64.cu bin_screen in numpy (unflipped bins and whether each
    is decided) for float32 wf known to rel wf, with lf the float32 log2
    of wf as given."""
    top = nf - 1
    rel = F32(rel)
    pre = (wf > F32(1e-30)) & (wf < F32(1e30)) & (rel <= F32(9.765625e-4))

    def eq(el, r, qs):
        return 2.0 * el * abs(r) + 1e-9 + 1e-12 * np.abs(qs)

    if mode == "lin":
        r1 = 1.0 / prm["dv"]
        qs = (wf.astype(np.float64) - prm["vmin"]) * r1
        m, ok = _screen_cell(qs, eq((rel * wf).astype(F32).astype(
            np.float64), r1, qs))
        return np.where(m <= 0, 0, np.minimum(m, top)), ok & pre
    el = (F32(1.1920929e-7) * np.abs(lf) + F32(1.445) * rel).astype(
        np.float64) + 1e-12 * (np.abs(lf).astype(np.float64) + 1.0)
    ld = lf.astype(np.float64)
    if mode == "log":
        r1 = 1.0 / prm["dvl"]
        qs = (ld - prm["vlmin"]) * r1
        m, ok = _screen_cell(qs, eq(el, r1, qs))
        return np.where(m <= 0, 0, np.minimum(m, top)), ok & pre
    r2, r3 = 1.0 / prm["dvl0"], 1.0 / prm["dvl1"]
    side = ld - prm["vlmin1"]
    sok = np.abs(side) > 2.0 * el + 1e-12
    qh = side * r3
    mh, okh = _screen_cell(qh, eq(el, r3, qh))
    kh = np.minimum(mh + prm["idx1"], float(top)).astype(np.int64)
    ql = (ld - prm["vlmin0"]) * r2
    ml, okl = _screen_cell(ql, eq(el, r2, ql))
    hi = side > 0
    return (np.where(hi, kh, np.maximum(ml, 0)),
            pre & sok & np.where(hi, okh, okl))


def _near_ties(mode, prm, nf, rng, size):
    """Phase values whose bin quotient lies 1e-12 .. 1e-2 from a rounding
    tie (and, log-piecewise, from the split), with random ones."""
    m = rng.integers(0, nf, size)
    d = rng.choice([-1.0, 1.0], size) * 10 ** rng.uniform(-12, -2, size)
    if mode == "lin":
        w = [prm["vmin"] + (m + 0.5 + d) * prm["dv"]]
    elif mode == "log":
        w = [2 ** (prm["vlmin"] + (m + 0.5 + d) * prm["dvl"])]
    else:
        w = [2 ** (prm["vlmin0"] + (m + 0.5 + d) * prm["dvl0"]),
             2 ** (prm["vlmin1"] + (m - prm["idx1"] + 0.5 + d) *
                   prm["dvl1"]),
             2 ** (prm["vlmin1"] * (1 + d))]
    w = np.concatenate(w)
    return np.concatenate([w[(w > 0) & np.isfinite(w)], np.exp(
        rng.uniform(np.log(1e-5), np.log(2.0), size))])


@pytest.mark.parametrize("nf", [7, 293, 1025, 3632])
@pytest.mark.parametrize("mode", ["log", "log-piecewise", "lin"])
def test_bin_screen_model(mode, nf):
    """The bin screen of the double kernels decides a bin only where it is
    the exact (double, plain) bin: on phase values at and near every
    rounding tie and the log-piecewise split, for log2f off by up to an
    ulp either way and w known in float to 2^-23 (B) or 2^-21 (B'); it
    decides all but half a percent of random values (the rest take the
    exact path)."""
    rng = np.random.default_rng(nf + len(mode))
    freqs = {"log": np.geomspace(0.003, 0.5, nf),
             "lin": np.linspace(0.0, 0.5, nf),
             "log-piecewise": np.hstack([
                 np.geomspace(0.003, 0.1, int(0.7 * nf), endpoint=False),
                 np.geomspace(0.1, 0.5, nf - int(0.7 * nf))])}[mode]
    got, prm = bin_params(freqs, mode != "lin")
    assert got == mode
    w = torch.as_tensor(_near_ties(mode, prm, nf, rng, 60_000))
    exact = reassign_cuda.bin_indices(w, mode, prm, False, nf).numpy()
    w = w.numpy()
    wf = w.astype(F32)
    for rel in (1.1920929e-7, 4.76837158e-7):
        lf0 = np.log2(wf.astype(np.float64)).astype(F32)
        for lf in (lf0, np.nextafter(lf0, F32(np.inf)),
                   np.nextafter(lf0, F32(-np.inf))):
            k, ok = _bin_screen(wf, rel, mode, prm, nf, lf.astype(F32))
            assert np.array_equal(k[ok], exact[ok]), (rel, mode, nf)
        assert ok[-60_000:].mean() > 0.995     # the random values


# -- bin ranges: any nf on the card ------------------------------------------------
@pytest.mark.parametrize("nf", [1, 3632, 3633, 4097, 20000])
def test_range_plan_covers_nf(nf):
    """The ranges a call over nf bins splits into cover [0, nf) once, in
    order, each at most the kernel's bins a launch, every one but the
    last full; and each range's rows have a plan: `_block_cols` (float32
    B, B'), `_f64_plan` at 3 and 4 planes (double B, B'), `_mxu_plan`
    (I)."""
    R = reassign_cuda
    for most, plans in ((R.F32_MAX_NF, [R._block_cols]),
                        (R.F64_MAX_NF, [lambda r: R._f64_plan(r, 3),
                                        lambda r: R._f64_plan(r, 4)]),
                        (R.MXU_MAX_NF, [R._mxu_plan])):
        ranges = R._ranges(nf, most)
        assert ranges[0][0] == 0 and sum(r for _, r in ranges) == nf
        assert all(a + r == b for (a, r), (b, _) in zip(ranges, ranges[1:]))
        assert all(r == most for _, r in ranges[:-1])
        assert 1 <= ranges[-1][1] <= most
        assert len(ranges) == -(-nf // most)
        for _, rows in ranges:
            for plan in plans:
                plan(rows)
    assert R.F32_MAX_NF == R.F64_MAX_NF == 3632 and R.MXU_MAX_NF == 4096
    with pytest.raises(ValueError):
        R._ranges(0, 3632)


@pytest.mark.parametrize("dtype, planes, impl", [
    (torch.float32, 3, "vpu"), (torch.float32, 4, "vpu"),
    (torch.float64, 3, "vpu"), (torch.float64, 4, "vpu"),
    (torch.float32, 4, "mxu")])
def test_range_launches_plumbing(monkeypatch, dtype, planes, impl):
    """On the CUDA route a call past the bins one launch takes makes one
    launch a range, each with its range's launch shape and (k0, rows)
    after it, all into one Tx pair, and its counter moves by the ranges
    (launches stand in for the kernel here, and a library whose entry
    points return 0 for the kernels)."""
    from ssqueeze_rs_tpu_torch import _build
    R = reassign_cuda
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    def fake(entry, pl, vecs, ints, plan, nf, what, grads=None,
             per_block=None, out=None):
        calls.append(list(per_block))
        _build.launch(entry, what=what)
        shape = pl[0].shape[:-2] + (nf, pl[0].shape[-1])
        return out or (torch.zeros(shape, dtype=dtype),
                       torch.zeros(shape, dtype=dtype))

    monkeypatch.setattr(R, "_launch", fake)
    monkeypatch.setattr(_build, "lib", Lib)
    monkeypatch.setenv("SSQ_TPU_REASSIGN_IMPL", impl)
    nf, na, n = 5000, 6, 16
    mode, params = bin_params(np.geomspace(0.05, 50.0, nf), True)
    p = [torch.ones(na, n, dtype=dtype) for _ in range(4)]
    const = torch.ones(na, dtype=dtype)
    cuda = torch.device("cuda")
    counters = ("ssq_reassign", "ssq_reassign4", "ssq_reassign_mxu",
                "ssq_reassign_f64", "ssq_reassign4_f64")
    before = {c: COUNTS["launch." + c] for c in counters}
    if planes == 3:
        out = R._reassign_dispatch(cuda, p[0], p[1], p[2], const, params,
                                   mode, True, nf)
    else:
        out = R._reassign4_dispatch(cuda, *p, const, const, 1e-6, params,
                                    mode, True, nf, "cwt")
    assert out[0].shape == (nf, n)
    most = (R.MXU_MAX_NF if impl == "mxu" else
            R.F64_MAX_NF if dtype == torch.float64 else R.F32_MAX_NF)

    def shape(rows):
        if impl == "mxu":
            return [R._mxu_plan(rows).n_tile]
        if dtype == torch.float64:
            return list(R._f64_shape(dtype, rows, planes))
        return [R._block_cols(rows)]

    assert calls == [shape(r) + [k0, r] for k0, r in R._ranges(nf, most)]
    name = ("ssq_reassign_mxu" if impl == "mxu" else
            R._entry("ssq_reassign" + ("4" if planes == 4 else ""), dtype))
    moved = {c: COUNTS["launch." + c] - before[c] for c in counters}
    assert moved == {c: (2 if c == name else 0) for c in counters}


def test_mxu_plain_ranges_match_b_prime(planes):
    """Plain I past 4096 bins, in kernel I's ranges (each its own digit
    split), against plain B': the JAX package's bar for I."""
    C, D, w, const, A, B = planes
    nf = 4500
    mode, params = bin_params(np.geomspace(0.05, 50.0, nf), True)
    zeros = np.zeros(C.shape[0], np.float32)
    args = (C, D, A, B, const, zeros, GAMMA, params, mode, True, nf, "cwt")
    ti = torch.complex(*reassign_cuda.reassign_mxu_plain(*args))
    tb = torch.complex(*reassign_cuda.reassign4_plain(*args))
    assert ti.shape == (nf, C.shape[1])
    assert float((ti - tb).abs().sum() / tb.abs().sum()) < 2e-5
    assert torch.equal(ti != 0, tb != 0) or \
        float(((ti != 0) == (tb != 0)).float().mean()) >= 0.9999


# -- ops.ssqueeze.reassign: the JAX package's arguments ------------------------------
@pytest.mark.parametrize("nf", [200, 4000])
@pytest.mark.parametrize("fused", [False, True])
def test_ops_reassign_matches_jax(planes, fused, nf):
    """`ops.ssqueeze.reassign` (complex Wx in, complex Tx out) against the
    JAX package's XLA `reassign`, on the same planes and float32 plan
    constants: fused (B' forms the phase from dWx) and from the w plane
    (B), at 200 bins and past the 3632 one launch takes (the plain
    version here). Tolerances as for B' above."""
    from ssqueeze_rs_tpu.ops.ssqueeze import reassign as j_reassign
    from ssqueeze_rs_tpu_torch.ops.ssqueeze import reassign
    C, D, w, const, A, B = planes
    mode, params = bin_params(np.geomspace(0.05, 50.0, nf), True)
    prm = {k: np.float32(v) for k, v in params.items()}
    Wx = (C + 1j * D).astype(np.complex64)
    other = (A + 1j * B).astype(np.complex64) if fused else w
    Sfs = np.zeros(C.shape[0], np.float32)
    kw = dict(mode=mode, flipud=True, fused=fused, transform="cwt", nf=nf)
    tx = reassign(torch.as_tensor(Wx), torch.as_tensor(other), const,
                  GAMMA, Sfs, prm, **kw)
    assert tx.dtype == torch.complex64 and tx.shape == (nf, C.shape[1])
    tj = np.asarray(j_reassign(
        jnp.asarray(Wx), jnp.asarray(other), jnp.asarray(const),
        jnp.asarray(GAMMA, jnp.float32), jnp.asarray(Sfs),
        {k: jnp.asarray(v) for k, v in prm.items()}, **kw))
    tx = tx.numpy()
    top = np.abs(tj).max()
    assert (np.abs(tx - tj) <= 1e-6 * top).mean() >= 0.9999
    cs, cs_j = tx.sum(0), tj.sum(0)
    assert np.abs(cs - cs_j).max() <= 1e-6 * np.abs(cs_j).max()
