"""The TPU probes' counterparts (`ssqueeze_rs_tpu_torch.tools`, kernels
P1-P4) on the CPU: their plain twins against the JAX package where they
compute its functions, and every ablated variant against its defining
property. Inputs are seeded numpy arrays handed to both packages.

  P1 full, P3     kernel D with the derivative: against the JAX fused CWT
                  kernel (`cwt_halfband_fused`, Pallas in interpret mode, at
                  its smallest M = 2^14) within 1e-5 of max|Wx|, as
                  tests/test_torch_cwt.py holds D; against the port's
                  `cwt_fused_plain` within 1e-6 (two float32 FFT orders)
  P1 variants     against a float64 numpy model of fft4.cuh's two stages
                  with the variant's parts, within 1e-5 of the largest
                  value (M = 2^12 and the unequal split 2^13 = 64 x 128)
  P2              exact: Pw rows copied, zeros elsewhere
  P4 full, grids  against the JAX scatter (`reassign_pallas` in interpret
                  mode) on a (3, na, n) batch at the bars of
                  tests/test_torch_reassign_mxu.py: >= 99.99 % of entries
                  within 1e-6 of max|Tx|, column sums within 1e-6; the
                  three grid modes' plain twins bitwise equal
  P4 variants     exact (zeros, bin sums and counts, row sums at i % nf)
                  or, for chains2, within 1e-6 of full's max (two partial
                  sums added)
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ssqueeze_rs_tpu import cwt
from ssqueeze_rs_tpu.ops.fft_pallas import cwt_halfband_fused
from ssqueeze_rs_tpu.ops.reassign_pallas import reassign_pallas
from ssqueeze_rs_tpu.ops.ssqueeze import bin_params
from ssqueeze_rs_tpu_torch.ops import fft_cuda, reassign_cuda
from ssqueeze_rs_tpu_torch.tools import (ablate_cwt_kernel as acw,
                                         ablate_reassign as ar,
                                         bench_reassign_batch as brb,
                                         cwt_kernel_probe as ckp)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _cwt_inputs(na, M, L, seed=0):
    """numpy float32 inputs of kernel D with the derivative: (args, keep)
    as `fft_cuda.cwt_fused` takes them."""
    rng = np.random.default_rng(seed)
    M1, M2 = fft_cuda.best_split(M)
    K1 = M1 // 2
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    xig = (3 * rng.random((K1, M2))).astype(np.float32)
    nyq = [f32(na) for _ in range(4)]
    args = (f32(na, K1, M2), f32(1, K1, M2), f32(1, K1, M2), xig,
            np.float32(2.0), (nyq[0], nyq[1]), (nyq[2], nyq[3]))
    return args, ((M - L) // 2, L)


# -- P1 full and P3 against the JAX package ------------------------------------
def test_full_and_staged_plain_match_jax_fused_cwt():
    args, keep = _cwt_inputs(3, 1 << 14, 12_000, seed=1)
    ref = cwt_halfband_fused(
        *(jnp.asarray(a) for a in args[:5]), tuple(map(jnp.asarray, args[5])),
        tuple(map(jnp.asarray, args[6])), keep=keep, derivative=True,
        interpret=True)
    ref = [np.asarray(o) for o in ref]
    d = [o.numpy() for o in fft_cuda.cwt_fused_plain(*args, keep=keep)]
    for fn in (acw.ablate_cwt_plain, acw.cwt_staged_plain):
        out = [o.numpy() for o in fn(*args, keep)]
        assert len(out) == 4
        for p in (0, 2):
            scale = np.abs(ref[p] + 1j * ref[p + 1]).max()
            for q in (p, p + 1):
                assert out[q].shape == (3, keep[1])
                assert np.abs(out[q] - ref[q]).max() / scale < 1e-5
                assert _rel(out[q], d[q]) < 1e-6


# -- P1 variants against a float64 model ----------------------------------------
def _bitrev(P):
    bits = P.bit_length() - 1
    return np.array([int(format(i, f"0{bits}b")[::-1], 2) for i in range(P)])


def _model(args, keep, variant):
    """float64 numpy model of the two stages of fft4.cuh. Stage 1 places
    the half-band column k1 at bitrev(k1) (natural order without the
    reversal), runs the length-M1 inverse DFT of the column read back in
    bit-reversed order (or nothing), multiplies by e^{2 pi i n1 k2 / M};
    stage 2 likewise over k2; output n = n1 + M1 n2 scaled by 1/M, plus
    the Nyquist value times (-1)^n / M."""
    Pw, xr, xi, xig, inv_dt, (nwr, nwi), (ndr, ndi) = args
    na, K1, M2 = Pw.shape
    M1, M = 2 * K1, 2 * K1 * M2
    fft1, fft2, twiddle, rev = acw._PARTS[variant]
    P = Pw.astype(np.float64)
    if variant == "overlap":
        P = np.broadcast_to(P[:, :1, :1], P.shape)
    Z = P * (xr[0] + 1j * xi[0].astype(np.float64))
    Z = np.concatenate([Z, 1j * Z * (xig * np.float64(inv_dt))])
    A = np.zeros((2 * na, M1, M2), complex)
    A[:, :K1] = Z
    b1, b2 = _bitrev(M1), _bitrev(M2)
    B = A[:, b1] if rev else A
    if fft1:
        B = np.fft.ifft(B[:, b1], axis=1) * M1
    if twiddle:
        B = B * np.exp(2j * np.pi * np.outer(np.arange(M1), np.arange(M2)) / M)
    C = B[:, :, b2] if rev else B
    if fft2:
        C = np.fft.ifft(C[:, :, b2], axis=2) * M2
    V = C.transpose(0, 2, 1).reshape(2 * na, M)
    start, L = keep
    L = 1 if variant == "noout" else L
    n = np.arange(start, start + L)
    nyq = np.concatenate([nwr + 1j * nwi, ndr + 1j * ndi])
    out = (V[:, start:start + L] + nyq[:, None] * (-1.0) ** n) / M
    return out[:na].real, out[:na].imag, out[na:].real, out[na:].imag


@pytest.mark.parametrize("M", [1 << 12, 1 << 13])
@pytest.mark.parametrize("variant", acw.VARIANTS)
def test_variant_plain_matches_its_model(variant, M):
    args, keep = _cwt_inputs(3, M, M - 1000, seed=2)
    out = acw.ablate_cwt(*args, keep, variant)      # CPU: the plain twin
    ref = _model(args, keep, variant)
    cols = 1 if variant == "noout" else keep[1]
    for o, r in zip(out, ref):
        assert o.shape == (3, cols)
        assert _rel(o.numpy(), r) < 1e-5


def test_nofft_is_the_twiddled_transposed_spectrum():
    """nofft: Y = bit-reversed spectrum columns times the twiddles; the
    planes read Y's rows n1 at bit-reversed n2, i.e. the (M1, M2) grid
    transposed into n = n1 + M1 n2."""
    args, keep = _cwt_inputs(2, 1 << 12, 4096, seed=3)
    Pw, xr, xi = args[:3]
    K1, M2 = Pw.shape[1:]
    M1, M = 2 * K1, 2 * K1 * M2
    Wr, Wi = acw.ablate_cwt(*args, keep, "nofft")[:2]
    Z = np.zeros((2, M1, M2), complex)
    Z[:, :K1] = Pw * (xr[0] + 1j * xi[0])
    b1, b2 = _bitrev(M1), _bitrev(M2)
    n1, n2 = np.meshgrid(np.arange(M1), np.arange(M2), indexing="ij")
    Y = Z[:, b1[n1], b2[n2]] * np.exp(2j * np.pi * n1 * b2[n2] / M)
    W = Y.transpose(0, 2, 1).reshape(2, M) / M
    W += (args[5][0] + 1j * args[5][1])[:, None] * (-1.0) ** np.arange(M) / M
    assert _rel(Wr.numpy(), W.real) < 1e-6 and _rel(Wi.numpy(), W.imag) < 1e-6


def test_noout_and_overlap():
    args, keep = _cwt_inputs(3, 1 << 12, 3000, seed=4)
    full = acw.ablate_cwt(*args, keep)
    noout = acw.ablate_cwt(*args, keep, "noout")
    for a, b in zip(noout, full):
        assert a.shape == (3, 1) and torch.equal(a[:, 0], b[:, 0])
    Pw = args[0]
    flat = (np.broadcast_to(Pw[:, :1, :1], Pw.shape).copy(),) + args[1:]
    for a, b in zip(acw.ablate_cwt(*args, keep, "overlap"),
                    acw.ablate_cwt(*flat, keep)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", list(acw.COPY_VARIANTS))
def test_copy_floor_plain(variant):
    rng = np.random.default_rng(5)
    Pw = torch.as_tensor(rng.standard_normal((5, 32, 64)).astype(np.float32))
    L = 3000
    out = acw.copy_floor(Pw, L, variant)
    assert len(out) == (1 if variant == "dma1" else 4)
    want = torch.zeros((5, L))
    if variant != "dmanoin":
        want[:, :2048] = Pw.reshape(5, -1)
    for o in out:
        assert torch.equal(o, want)
    assert acw.copy_floor(Pw, 1000, "dmaonly")[0].equal(Pw.reshape(5, -1)
                                                         [:, :1000])


def test_cpu_runs_count_no_launch():
    args, keep = _cwt_inputs(2, 1 << 12, 3000)
    before = (acw.LAUNCHES, acw.LAUNCHES_COPY, acw.LAUNCHES_STAGED,
              ar.LAUNCHES)
    acw.ablate_cwt(*args, keep, "nostage1")
    acw.cwt_staged(*args, keep)
    acw.copy_floor(args[0], 3000)
    planes = ar.make_planes(torch.device("cpu"), None, 8, 64)
    ar.ablate_reassign(*planes, ar.GAMMA, ar.PARAMS, ar.MODE, True, 8, "cwt",
                       "addonly")
    assert (acw.LAUNCHES, acw.LAUNCHES_COPY, acw.LAUNCHES_STAGED,
            ar.LAUNCHES) == before


def test_wrappers_refuse_bad_arguments():
    args, keep = _cwt_inputs(2, 1 << 12, 3000)
    with pytest.raises(ValueError, match="variant"):
        acw.ablate_cwt(*args, keep, "nodots")
    with pytest.raises(ValueError, match="variant"):
        acw.copy_floor(args[0], 3000, "dma")
    planes = ar.make_planes(torch.device("cpu"), 2, 8, 64)
    rest = (ar.GAMMA, ar.PARAMS, ar.MODE, True, 8, "cwt")
    with pytest.raises(ValueError, match="full"):
        ar.ablate_reassign(*planes, *rest, "addonly", grid="grid1d")
    with pytest.raises(ValueError, match="cols"):
        ar.ablate_reassign(*planes, *rest, cols=64)
    with pytest.raises(ValueError, match="fit"):
        ar.ablate_reassign(*planes[:4], torch.ones(8), torch.zeros(8),
                           ar.GAMMA, ar.PARAMS, ar.MODE, True, 4000, "cwt",
                           "chains2")


def test_full3_plain():
    """P4's 3-plane full (the row walk's B) runs B's plain version on the
    CPU (no launch), and refuses a column count it is not built for or
    whose accumulator does not fit."""
    planes = ar.make_planes(torch.device("cpu"), 2, 8, 64)
    w = reassign_cuda.phase_w(*planes[:4], planes[5], ar.GAMMA, "cwt")
    args3 = (planes[0], planes[1], w, planes[4], ar.PARAMS, ar.MODE, True, 8)
    before = ar.LAUNCHES
    assert all(torch.equal(a, b) for a, b in zip(
        ar.ablate_reassign3(*args3), reassign_cuda.reassign_plain(*args3)))
    assert ar.LAUNCHES == before
    with pytest.raises(ValueError, match="cols"):
        ar.ablate_reassign3(*args3, cols=4)
    with pytest.raises(ValueError, match="fit"):
        ar.ablate_reassign3(*args3[:-1], 3000, cols=32)


# -- P4 against the JAX package --------------------------------------------------
GAMMA = 1e-5
FREQS = np.hstack([np.geomspace(0.05, 1.0, 150, endpoint=False),
                   np.geomspace(1.0, 50.0, 50)])


@pytest.fixture(scope="module")
def batch():
    """tests/test_reassign_pallas.py::_setup's chirp CWT and dWx (N =
    1024), as a batch of three: the planes, doubled, negated."""
    N = 1024
    rng = np.random.default_rng(0)
    t = np.linspace(0, 10, N, endpoint=False)
    x = np.cos(2 * np.pi * 3 * np.exp(t / 3)) + 0.1 * rng.standard_normal(N)
    Wx, _, dWx = cwt(x, ("gmw", {"beta": 8.0}), scales="log", fs=N / 10,
                     derivative=True, dtype="float32")
    Wx, dWx = np.asarray(Wx).astype(np.complex64), np.asarray(dWx)
    one = [Wx.real, Wx.imag, dWx.real.astype(np.float32),
           dWx.imag.astype(np.float32)]
    planes = [np.ascontiguousarray(np.stack([p, 2 * p, -p])) for p in one]
    na = planes[0].shape[1]
    mode, params = bin_params(FREQS, True)
    assert mode == "log-piecewise"
    const = np.full(na, 0.021, np.float32)
    Sfs = np.zeros(na, np.float32)
    return (*planes, const, Sfs, GAMMA, params, mode, True, len(FREQS),
            "cwt")


@pytest.fixture(scope="module")
def jax_tx(batch):
    C, D, A, B, const, Sfs, gamma, params, mode, flipud, nf, _ = batch
    return np.asarray(reassign_pallas(
        (jnp.asarray(C), jnp.asarray(D)), (jnp.asarray(A), jnp.asarray(B)),
        jnp.asarray(const), gamma, jnp.asarray(Sfs), params, mode=mode,
        flipud=flipud, transform="cwt", nf=nf, interpret=True))


@pytest.mark.parametrize("grid", ar.GRIDS)
def test_full_and_grid_modes_match_jax(batch, jax_tx, grid):
    out = ar.ablate_reassign(*batch, grid=grid)
    tx = (out[0] + 1j * out[1]).numpy()
    assert tx.shape == jax_tx.shape == (3, batch[10], batch[0].shape[-1])
    for b in range(3):
        top = np.abs(jax_tx[b]).max()
        assert (np.abs(tx[b] - jax_tx[b]) <= 1e-6 * top).mean() >= 0.9999
        cs, cs_jax = tx[b].sum(0), jax_tx[b].sum(0)
        assert np.abs(cs - cs_jax).max() <= 1e-6 * np.abs(cs_jax).max()


def test_grid_modes_plain_bitwise_equal(batch):
    outs = [ar.ablate_reassign_plain(*batch, grid=g) for g in ar.GRIDS]
    ref = reassign_cuda.reassign4_plain(*batch)
    for o in outs:
        assert torch.equal(o[0], ref[0]) and torch.equal(o[1], ref[1])


def test_reassign_variants_plain(batch):
    C, D, A, B, const, Sfs, gamma, params, mode, flipud, nf, tr = batch
    na, n = C.shape[1:]
    full = ar.ablate_reassign(*batch)
    z = ar.ablate_reassign(*batch, "dmaonly")
    assert all(t.shape == (3, nf, n) and not t.any() for t in z)
    kb, cnt = ar.ablate_reassign(*batch, "binonly")
    assert kb.shape == cnt.shape == (3, 1, n)
    mask = (C.astype(np.float64) ** 2 + D.astype(np.float64) ** 2 >
            np.float32(gamma) ** 2)
    assert np.array_equal(cnt[:, 0].numpy(), mask.sum(1))
    w = reassign_cuda.phase_w(*(torch.as_tensor(p) for p in (C, D, A, B)),
                              torch.as_tensor(Sfs), gamma, tr)
    k = reassign_cuda.bin_indices(w, mode, params, flipud, nf).numpy()
    assert np.array_equal(kb[:, 0].numpy(), np.where(k >= 0, k, 0).sum(1))
    # the full scatter's nonzero rows are the bins counted here
    assert (full[0].abs().sum(-1) > 0).sum() <= (k >= 0).sum()
    ar_r, ar_i = ar.ablate_reassign(*batch, "addonly")
    want = np.zeros((3, nf, n), np.float32)
    for i in range(na):
        want[:, i % nf] += C[:, i] * const[i]
    assert np.abs(ar_r.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    assert ar_i.shape == (3, nf, n)
    ch = ar.ablate_reassign(*batch, "chains2")
    for a, b in zip(ch, full):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()


# -- the entry points -----------------------------------------------------------
@pytest.mark.parametrize("mod, names", [
    (acw, list(acw.VARIANTS) + list(acw.COPY_VARIANTS) + ["copy_", "staged"]),
    (ckp, [f"{m} ({v})" for m, v in ckp.MODES.items()]),
    (ar, ["full/32", "full/16", "full/8"] + list(ar.VARIANTS[1:])),
    (brb, [f"{g} B={b}" for b in brb.BATCHES
           for g in ("batch2d", "grid1d", "flat+T", "flat_pre")]),
], ids=["ablate_cwt_kernel", "cwt_kernel_probe", "ablate_reassign",
        "bench_reassign_batch"])
def test_main_on_cpu(mod, names, capsys):
    rows = mod.main(["2", "--device", "cpu"])
    assert [r["name"] for r in rows] == names
    assert all(r["ms"] > 0 and r["bound_ms"] > 0 for r in rows)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(names)
    assert all("host ms" in line and "bound" in line for line in lines)


@pytest.mark.parametrize("mod", [acw, ckp, ar, brb],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_main_needs_cuda_or_device_cpu(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main(["1"])
