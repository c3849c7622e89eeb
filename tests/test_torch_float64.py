"""The port's float64 routes against the JAX package's, on the CPU: the
STFT family (`stft`, `istft`, `ssq_stft`, `issq_stft`), the CWT family
(`cwt`, `ssq_cwt`, `issq_cwt`), `algos` and the streamers with
`dtype='float64'` on the same seeded numpy signal (N = 2048), the plain
kernels B'/C' in double against the JAX kernel B' in float64 (interpret
mode) and the XLA route, the float64 gradients, the repaired precision
fault of `reassign`/`reassign4`, and the launch plumbing of the double
kernels (`_f64_plan`, the plan constants).

Tolerances, and why:
  transforms  max|d| < 1e-10 of max|ref| (float64 FFTs in other orders:
              the bar the float64 `cwt` already meets)
  ssq_freqs   equal (the same host float64 planning)
  Tx          the bins equal on >= 99.999 % of the entries (log2 and the
              phase of the two packages may round an ulp apart at a tie),
              and max|d| <= 1e-9 of sum|Tx| (a bin moved elsewhere would
              show as a whole entry)
  gradients   < 5e-3 end to end (a bin that flips between the packages
              moves an isolated contribution: the bar of
              tests/test_torch_grad.py), C' of a given cotangent EQUAL to
              JAX's wherever the bins agree (one float64 product an entry)
  kernels     the plain B' against the JAX float64 kernel: entries within
              1e-12 of max|Tx| on >= 99.999 %, column sums within 1e-12
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import ssqueeze_rs_tpu as J
import ssqueeze_rs_tpu.streaming as JS
import ssqueeze_rs_tpu_torch as T
from ssqueeze_rs_tpu import algos as ja
from ssqueeze_rs_tpu.ops.reassign_pallas import _bin_indices, reassign_pallas
from ssqueeze_rs_tpu.ops.ssqueeze import reassign as j_reassign
from ssqueeze_rs_tpu_torch import algos as ta, config as tconfig
from ssqueeze_rs_tpu_torch.ops import reassign_cuda as R
from ssqueeze_rs_tpu_torch.ops.ssqueeze import bin_params

N = 2048
F64 = dict(dtype="float64")


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _signal(n=N, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / n
    return rng.standard_normal(n) + np.cos(2 * np.pi * (50 * t + 100 * t * t))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _close(ours, theirs, bar=1e-10):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    assert _rel(ours, theirs) < bar


def _tx_close(ours, theirs):
    """Tx at the float64 bars: the same nonzero pattern (a bin moved to
    another row) on >= 99.999 % of entries, max|d| <= 1e-9 sum|Tx|."""
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    assert ((ours != 0) == (theirs != 0)).mean() >= 0.99999
    assert np.abs(ours - theirs).max() <= 1e-9 * np.abs(theirs).sum()


# -- the STFT family ------------------------------------------------------------
@pytest.mark.parametrize("n_fft,hop", [(256, 1), (255, 3), (4096 // 8, 1)])
def test_stft_float64_matches_jax(n_fft, hop):
    x = _signal()
    kw = dict(n_fft=n_fft, hop_len=hop, derivative=True, fs=100.0, **F64)
    Sx, dSx = T.stft(torch.as_tensor(x), **kw)
    Sj, dSj = J.stft(x, **kw)
    assert Sx.dtype == torch.complex128
    _close(Sx, Sj)
    _close(dSx, dSj)
    # unmodulated, as compat.stft runs it
    _close(T.stft(torch.as_tensor(x), n_fft=n_fft, modulated=False, **F64),
           J.stft(x, n_fft=n_fft, modulated=False, **F64))


@pytest.mark.parametrize("n_fft,hop,win_exp", [(256, 1, 1), (255, 4, 1),
                                               (256, 1, 0), (128, 2, 2)])
def test_istft_float64_matches_jax(n_fft, hop, win_exp):
    x = _signal()
    Sx = np.array(J.stft(x, n_fft=n_fft, hop_len=hop, **F64))
    xr = T.istft(torch.as_tensor(Sx), n_fft=n_fft, hop_len=hop, N=N,
                 win_exp=win_exp)
    xj = J.istft(Sx, n_fft=n_fft, hop_len=hop, N=N, win_exp=win_exp)
    assert xr.dtype == torch.float64
    _close(xr, xj)
    if win_exp == 1:
        assert _rel(xr.numpy(), x) < 1e-12


@pytest.mark.parametrize("opts", [{}, {"squeezing": "lebesgue"},
                                  {"get_w": True, "get_dWx": True},
                                  {"hop_len": 2, "flipud": True}],
                         ids=["sum", "lebesgue", "get_w", "hop2"])
def test_ssq_stft_float64_matches_jax(opts):
    x = _signal()
    kw = dict(n_fft=256, fs=100.0, **F64, **opts)
    out = T.ssq_stft(torch.as_tensor(x), **kw)
    ref = J.ssq_stft(x, **kw)
    assert len(out) == len(ref)
    _tx_close(out[0], ref[0])
    _close(out[1], ref[1])
    assert np.array_equal(out[2], ref[2]) and np.array_equal(out[3], ref[3])
    for a, b in zip(out[4:], ref[4:]):
        if a.is_complex():
            _close(a, b)
        else:      # w: the same +inf mask, finite values at 1e-10
            a, b = a.numpy(), np.asarray(b)
            assert np.array_equal(np.isinf(a), np.isinf(b))
            _close(np.where(np.isinf(a), 0, a), np.where(np.isinf(b), 0, b))
    if opts:
        return
    _close(T.issq_stft(out[0]), J.issq_stft(ref[0]))


# -- the CWT family -------------------------------------------------------------
@pytest.mark.parametrize("opts", [{}, {"squeezing": "abs"},
                                  {"get_w": True, "get_dWx": True},
                                  {"scales": "log", "maprange": "maximal",
                                   "wavelet": "morlet"}],
                         ids=["default", "abs", "get_w", "morlet"])
def test_ssq_cwt_float64_matches_jax(opts):
    x = _signal()
    opts = dict(opts)
    wav = opts.pop("wavelet", "gmw")
    out = T.ssq_cwt(torch.as_tensor(x), wav, **F64, **opts)
    ref = J.ssq_cwt(x, wav, **F64, **opts)
    assert len(out) == len(ref) and out[0].dtype == torch.complex128
    _tx_close(out[0], ref[0])
    _close(out[1], ref[1])
    assert np.array_equal(out[2], ref[2]) and np.array_equal(out[3], ref[3])
    if not opts:
        _close(T.issq_cwt(out[0]), J.issq_cwt(ref[0]))
        W, _, dW = T.cwt(torch.as_tensor(x), derivative=True, **F64)
        Wj, _, dWj = J.cwt(x, derivative=True, **F64)
        _close(W, Wj)
        _close(dW, dWj)


def test_ssq_cwt_float64_bins_match_jax():
    """The bins the port's B' (plain) gives Tx against the JAX float64
    kernel's binning (`_bin_indices`) on the same float64 planes."""
    x = _signal()
    Wx, scales, dWx = J.cwt(x, derivative=True, **F64)
    Wx, dWx = np.asarray(Wx), np.asarray(dWx)
    ssq_freqs = J.ssq_cwt(x, **F64)[2][::-1].copy()
    mode, params = bin_params(ssq_freqs, True)
    nf, gamma = len(ssq_freqs), 10 * tconfig.EPS64
    k_j = np.asarray(_bin_indices(mode, dict(params), gamma, True, "cwt", nf,
                                  N, N, *(jnp.asarray(p) for p in (
                                      Wx.real, Wx.imag, dWx.real, dWx.imag)),
                                  None)[0])
    w = R.phase_w(*(torch.as_tensor(p) for p in (Wx.real, Wx.imag, dWx.real,
                                                 dWx.imag)),
                  torch.zeros(len(Wx), dtype=torch.float64), gamma, "cwt")
    k_t = R.bin_indices(w, mode, params, True, nf).numpy()
    assert np.array_equal(k_j < 0, k_t < 0) and (k_j >= 0).mean() > 0.5
    assert (k_j == k_t).mean() >= 0.99999


# -- kernels B' and C' in double: plain versions against the JAX kernel --------
NA, NC = 24, 300


def _planes64(seed=3):
    rng = np.random.default_rng(seed)
    planes = [rng.standard_normal((NA, NC)) for _ in range(4)]
    planes[0][5:7] *= 1e-9            # rows under gamma: masked
    planes[1][5:7] *= 1e-9
    return planes, np.linspace(0.01, 0.05, NA)


@pytest.mark.parametrize("transform", ["cwt", "stft"])
def test_plain_b4_float64_matches_jax_kernel(monkeypatch, transform):
    """B' (4 planes) in float64 against `reassign_pallas` with float64
    planes in interpret mode (SSQ_TPU_KERNELS=1) and the XLA route."""
    planes, const = _planes64()
    if transform == "cwt":
        freqs, flipud, Sfs = np.geomspace(0.01, 1.0, NA), True, np.zeros(NA)
    else:
        freqs, flipud = np.linspace(0.0, 1.0, NA), False
        Sfs = np.linspace(0.0, 1.0, NA)
    mode, params = bin_params(freqs, transform == "cwt")
    gamma = 1e-6
    txr, txi = R.reassign4(*planes, const, Sfs, gamma, params, mode, flipud,
                           NA, transform)
    assert txr.dtype == torch.float64
    tx = (txr + 1j * txi).numpy()
    monkeypatch.setenv("SSQ_TPU_KERNELS", "1")
    tx_k = np.asarray(reassign_pallas(
        tuple(jnp.asarray(p) for p in planes[:2]),
        tuple(jnp.asarray(p) for p in planes[2:]), jnp.asarray(const),
        gamma, jnp.asarray(Sfs), params, mode=mode, flipud=flipud,
        transform=transform, nf=NA, interpret=True))
    params_j = {k: (jnp.asarray(v) if k != "idx1" else
                    jnp.asarray(v, jnp.int32)) for k, v in params.items()}
    tx_x = np.asarray(j_reassign(
        jnp.asarray(planes[0] + 1j * planes[1]),
        jnp.asarray(planes[2] + 1j * planes[3]), jnp.asarray(const),
        jnp.asarray(gamma), jnp.asarray(Sfs), params_j, mode=mode,
        flipud=flipud, fused=True, transform=transform, nf=NA))
    for ref in (tx_k, tx_x):
        assert ref.dtype == np.complex128
        top = np.abs(ref).max()
        assert (np.abs(tx - ref) <= 1e-12 * top).mean() >= 0.99999
        cs, cs_ref = tx.sum(0), ref.sum(0)
        assert np.abs(cs - cs_ref).max() <= 1e-12 * np.abs(cs_ref).max()


@pytest.mark.parametrize("transform", ["cwt", "stft"])
def test_plain_c4_float64_matches_jax_grad(transform):
    """C' in double against jax.grad of the JAX float64 kernel B'."""
    planes, const = _planes64(4)
    rng = np.random.default_rng(5)
    freqs = (np.geomspace(0.01, 1.0, NA) if transform == "cwt" else
             np.linspace(0.0, 1.0, NA))
    Sfs = np.zeros(NA) if transform == "cwt" else np.linspace(0, 1.0, NA)
    flipud = transform == "cwt"
    mode, params = bin_params(freqs, transform == "cwt")
    R1, R2 = (rng.standard_normal((NA, NC)) for _ in range(2))
    gamma = 1e-6

    def j_loss(wr, wi, dr, di):
        Tx = reassign_pallas((wr, wi), (dr, di), jnp.asarray(const), gamma,
                             jnp.asarray(Sfs), params, mode=mode,
                             flipud=flipud, transform=transform, nf=NA,
                             interpret=True)
        return jnp.sum(Tx.real * R1 + Tx.imag * R2)

    gj = [np.asarray(g) for g in jax.grad(j_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(p) for p in planes))]
    leaves = [torch.tensor(p, requires_grad=True) for p in planes]
    txr, txi = R.reassign4(*leaves, const, Sfs, gamma, params, mode, flipud,
                           NA, transform)
    ((txr * torch.as_tensor(R1) + txi * torch.as_tensor(R2)).sum()
     ).backward()
    gt = [t.grad for t in leaves]
    k_j = np.asarray(_bin_indices(mode, dict(params), gamma, flipud,
                                  transform, NA, NC, NC,
                                  *(jnp.asarray(p) for p in planes),
                                  jnp.asarray(Sfs)[:, None])[0])
    w = R.phase_w(*(torch.as_tensor(p) for p in planes),
                  torch.as_tensor(Sfs), gamma, transform)
    agree = k_j == R.bin_indices(w, mode, params, flipud, NA).numpy()
    assert agree.mean() >= 0.99999 and (k_j < 0).any()
    for a, b in zip(gt[:2], gj[:2]):
        assert a.dtype == torch.float64
        assert np.array_equal(a.numpy()[agree], b[agree])
    assert not any(g.any() for g in gt[2:])


def test_reassign_keeps_float64_repaired():
    """The repaired fault: float64 planes into `reassign`/`reassign4` give
    float64 Tx (they were cast to float32), equal to the float64 plain
    versions; planes of mixed precision raise."""
    planes, const = _planes64(6)
    mode, params = bin_params(np.geomspace(0.01, 1.0, NA), True)
    a4 = (*planes, const, np.zeros(NA), 1e-6, params, mode, True, NA, "cwt")
    out = R.reassign4(*a4)
    ref = R.reassign4_plain(*a4)
    assert all(o.dtype == torch.float64 for o in out)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    w = R.phase_w(*(torch.as_tensor(p) for p in planes), torch.zeros(NA),
                  1e-6, "cwt")
    assert w.dtype == torch.float64
    a3 = (planes[0], planes[1], w, const, params, mode, True, NA)
    out3 = R.reassign(*a3)
    assert all(o.dtype == torch.float64 for o in out3)
    assert all(torch.equal(a, b) for a, b in zip(out3, R.reassign_plain(*a3)))
    mixed = [planes[0], planes[1].astype(np.float32), *planes[2:]]
    with pytest.raises(ValueError, match="mixed"):
        R.reassign4(*mixed, *a4[4:])
    with pytest.raises(ValueError, match="mixed"):
        R.reassign(planes[0], planes[1], w.float(), *a3[3:])
    with pytest.raises(ValueError, match="cotangent"):
        R.reassign_bwd(w, const, torch.zeros(NA, NC, dtype=torch.float32),
                       torch.zeros(NA, NC, dtype=torch.float32), params,
                       mode, True, NA)


def test_double_launch_plumbing():
    """_f64_plan, the launch plan of csrc/reassign64.cu in place of
    _block_cols(nf, 8): 8 columns (64-byte plane row runs) and 2 row
    groups in 4, 3 or 2 blocks an SM while each keeps a ring of 2 or more
    stages with 32 KB in flight an SM (B' to nf = 688), then one block of
    512 threads at 8 columns (to 1408), 4 (to 2816) and 2 (to 3632), then
    raises; the shapes timed on the card; float32 _block_cols unchanged.
    The float64 plan constants and gamma^2 are unrounded, the float32
    ones rounded once; the dispatch names the `_f64` entries and hands
    them (columns, row groups, stages)."""
    plan = R._f64_plan
    shape = lambda nf, planes=4: plan(nf, planes)[:4] + (  # noqa: E731
        plan(nf, planes).blocks,)
    # (columns, row groups, rows a stage, stages, blocks an SM)
    assert shape(293) == (8, 2, 32, 2, 4)          # the ssq_cwt headline
    assert shape(293, 3) == (8, 2, 32, 5, 3)
    assert shape(490) == (8, 2, 32, 6, 2)          # compat.ssq_cwt
    assert shape(1025) == (8, 4, 64, 5, 1)
    assert shape(2000) == (4, 8, 128, 6, 1)
    assert shape(3632) == (2, 16, 256, 6, 1)
    assert [plan(nf).blocks for nf in (304, 305, 384, 385, 688)] == \
        [4, 3, 3, 2, 2]
    assert [plan(nf).cols for nf in (688, 689, 1408, 1409, 2816, 2817)] == \
        [8, 8, 8, 4, 4, 2]
    for nf in (1, 293, 490, 1025, 3632):
        for planes in (3, 4):
            p = plan(nf, planes)
            assert p.smem == R._f64_smem(nf, p.cols, p.groups, planes,
                                         p.stages) <= R.MAX_SMEM
            assert p.flight >= 32 * 1024
    for nf in (0, 3633):
        with pytest.raises(ValueError, match="1 to 3632"):
            plan(nf)
    assert R._f64_shape(torch.float64, 1025, 4) == (8, 4, 5)
    assert R._f64_shape(torch.float32, 1025, 4) is None
    assert [R._block_cols(n) for n in (908, 909, 3632)] == [32, 8, 8]
    mode, params = bin_params(np.geomspace(0.013, 0.77, 300), True)
    p64 = R._plan_floats(mode, params, torch.float64)
    p32 = R._plan_floats(mode, params)
    assert p64[:2] == [params["vlmin"], params["dvl"]]
    assert p32[:2] == [float(np.float32(params["vlmin"])),
                       float(np.float32(params["dvl"]))]
    assert p64[:2] != p32[:2]
    assert R._gamma2(0.1, torch.float64) == 0.1 ** 2
    assert R._gamma2(0.1) == float(np.float32(0.1 ** 2))

    assert R._entry("ssq_reassign4", torch.float64) == "ssq_reassign4_f64"
    assert R._entry("ssq_reassign_bwd", torch.float32) == "ssq_reassign_bwd"


# -- gradients ------------------------------------------------------------------
def test_ssq_cwt_float64_grad_matches_jax():
    """tests/test_torch_grad.py's end-to-end setup in float64: loss
    sum|Tx|^2 + sum|Wx|^2 (the backward runs C' in double)."""
    x = np.cos(2 * np.pi * 50 * np.arange(1024) / 1024)
    kw = dict(scales="log", nv=16, fs=1024.0, **F64)
    wav = ("gmw", {"beta": 8.0})

    def loss(Tx, Wx, xp):
        return xp.sum(xp.abs(Tx) ** 2) + xp.sum(xp.abs(Wx) ** 2)

    gj = np.asarray(jax.grad(lambda x: loss(
        *J.ssq_cwt(x, wav, **kw)[:2], jnp))(jnp.asarray(x)))
    x_t = torch.tensor(x, requires_grad=True)
    Tx, Wx, *_ = T.ssq_cwt(x_t, wav, **kw)
    loss(Tx, Wx, torch).backward()
    assert x_t.grad.dtype == torch.float64
    assert np.isfinite(x_t.grad.numpy()).all()
    assert _rel(x_t.grad.numpy(), gj) < 5e-3


def test_ssq_stft_float64_grad_matches_jax():
    rng = np.random.default_rng(8)
    t = np.arange(1500) / 500.0
    x = np.cos(2 * np.pi * 60 * t) + 0.1 * rng.standard_normal(1500)
    kw = dict(n_fft=128, fs=500.0, **F64)

    def j_loss(x):
        Tx, Sx, *_ = J.ssq_stft(x, **kw)
        return jnp.sum(jnp.abs(Tx) ** 2) + jnp.sum(jnp.abs(Sx) ** 2)

    gj = np.asarray(jax.grad(j_loss)(jnp.asarray(x)))
    x_t = torch.tensor(x, requires_grad=True)
    Tx, Sx, *_ = T.ssq_stft(x_t, **kw)
    ((Tx.abs() ** 2).sum() + (Sx.abs() ** 2).sum()).backward()
    assert x_t.grad.dtype == torch.float64
    assert _rel(x_t.grad.numpy(), gj) < 5e-3


# -- algos, streamers, config ---------------------------------------------------
def test_algos_float64_matches_jax():
    x = _signal(1024)
    Wx, scales, dWx = (np.array(a) for a in J.cwt(
        x, ("gmw", {"beta": 8.0}), scales="log", derivative=True, **F64))
    freqs = np.geomspace(0.01, 0.5, len(Wx))
    w = np.array(ja.phase_cwt_cpu(Wx, dWx, 1e-8))
    on = ta.indexed_sum_onfly(torch.as_tensor(Wx), torch.as_tensor(w), freqs,
                              0.02, logscale=True, flipud=True)
    fast = ta.ssqueeze_fast(torch.as_tensor(Wx), torch.as_tensor(dWx), freqs,
                            0.02, logscale=True, flipud=True)
    _tx_close(on, ja.indexed_sum_onfly(Wx, w, freqs, 0.02, logscale=True,
                                       flipud=True))
    _tx_close(fast, ja.ssqueeze_fast(Wx, dWx, freqs, 0.02, logscale=True,
                                     flipud=True))
    with pytest.raises(ValueError, match="mixed"):
        ta.ssqueeze_fast(torch.as_tensor(Wx), torch.as_tensor(dWx).to(
            torch.complex64), freqs, 0.02)


def test_streaming_float64_matches_jax():
    """StreamingSSQSTFT and StreamingSSQCWT in float64, in ragged chunks,
    against the JAX package's float64 streamers."""
    x = _signal(6000)
    sizes = [700, 1300, 2500]

    def run(s):
        outs, i, k = [], 0, 0
        while i < len(x):
            outs.append(s.feed(x[i:i + sizes[k % 3]]))
            i += sizes[k % 3]
            k += 1
        outs.append(s.flush())
        return [np.concatenate(p, axis=-1) for p in zip(*outs)]

    kw = dict(block=2048, n_fft=128, fs=100.0, dtype="float64")
    ours = run(T.StreamingSSQSTFT(device="cpu", **kw))
    theirs = run(JS.StreamingSSQSTFT(**kw))
    _tx_close(ours[0], theirs[0])
    _close(ours[1], theirs[1])
    kw = dict(block=2048, nv=8, plan_N=6000, dtype="float64")
    ours = run(T.StreamingSSQCWT(device="cpu", **kw))
    theirs = run(JS.StreamingSSQCWT(**kw))
    assert ours[0].dtype == np.complex128
    _close(ours[1], theirs[1])
    assert np.abs(ours[0] - theirs[0]).max() <= 1e-9 * np.abs(theirs[0]).sum()


def test_config_dtype_helpers_match_jax():
    from ssqueeze_rs_tpu import config as jc
    for cd in ("complex64", "complex128"):
        assert tconfig.gamma_default(getattr(torch, cd)) == \
            jc.gamma_default(cd)
    assert tconfig.complex_dtype(torch.float64) == torch.complex128
    assert tconfig.complex_dtype("float32") == torch.complex64
    assert tconfig.use_x64() == jc.use_x64()
    assert tconfig.default_dtype() == (torch.float64 if jc.use_x64()
                                       else torch.float32)
    assert T.DEFAULTS["dtype"] == "float32"
