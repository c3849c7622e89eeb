"""Host planning of the torch port against the JAX package: pad, scales,
ssq frequency grid, normalization constants, bin constants, the half-band
grid and the filterbank. Planning is numpy in both packages, so it must
agree exactly (float64 grids: rtol 1e-12)."""
import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ssqueeze_rs_tpu.ops import fft_mxu as j_fft
from ssqueeze_rs_tpu.ops.cwt import _xi_grid_np
from ssqueeze_rs_tpu.scales import process_scales as j_process_scales
from ssqueeze_rs_tpu.utils import pad as j_pad
from ssqueeze_rs_tpu.wavelets import Wavelet as JWavelet, adm_ssq as j_adm_ssq
from ssqueeze_rs_tpu_torch.ops import fft_cuda as t_fft
from ssqueeze_rs_tpu_torch.ops.cwt import xi_grid
from ssqueeze_rs_tpu_torch.scales import process_scales as t_process_scales
from ssqueeze_rs_tpu_torch.utils import pad as t_pad
from ssqueeze_rs_tpu_torch.wavelets import Wavelet as TWavelet, adm_ssq as t_adm_ssq

# the packages' `ops.ssqueeze` attribute is the function, not the module
j_ssq = importlib.import_module("ssqueeze_rs_tpu.ops.ssqueeze")
t_ssq = importlib.import_module("ssqueeze_rs_tpu_torch.ops.ssqueeze")

WAVELETS = ["gmw", ("gmw", {"beta": 8.0}), ("gmw", {"order": 2}), "morlet",
            "bump"]


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _both(spec):
    return JWavelet.build(spec, l1_norm=True), TWavelet.build(spec, l1_norm=True)


@pytest.mark.parametrize("N", [100, 1000, 9000, 2 ** 14, 160000])
def test_pad_params(N):
    assert t_pad.p2up(N) == j_pad.p2up(N)
    assert t_pad.pad_params(N, N + 37) == j_pad.pad_params(N, N + 37)


@pytest.mark.parametrize("padlength", [None, 200])
@pytest.mark.parametrize("padtype", list(t_pad.PAD_MODES))
def test_padsignal(padtype, padlength):
    """Default p2up pads and pads longer than the signal (repeated
    reflection / wrap)."""
    x = np.random.default_rng(0).standard_normal((2, 3, 37))
    got = t_pad.padsignal(torch.as_tensor(x), padtype, padlength,
                          get_params=True)
    want = j_pad.padsignal(jnp.asarray(x), padtype, padlength,
                           get_params=True)
    assert got[1:] == want[1:]
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("scaletype,N,nv", [
    ("log", 9000, 4), ("log-piecewise", 9000, 4), ("linear", 9000, 4),
    ("log-piecewise", 160000, 32)])
@pytest.mark.parametrize("wavelet", WAVELETS[:3])
def test_process_scales(scaletype, N, nv, wavelet):
    jw, tw = _both(wavelet)
    want = j_process_scales(scaletype, N, jw, nv=nv, get_params=True)
    got = t_process_scales(scaletype, N, tw, nv=nv, get_params=True)
    assert np.array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    # array input is introspected (type and per-row voices) identically
    want_a = j_process_scales(want[0], N, get_params=True)
    got_a = t_process_scales(got[0], N, get_params=True)
    assert got_a[1:3] == want_a[1:3]
    assert np.array_equal(np.asarray(got_a[3]), np.asarray(want_a[3]))


@pytest.mark.parametrize("maprange,scaletype", [
    ("peak", "log-piecewise"), ("energy", "log-piecewise"), ("peak", "log"),
    ("maximal", "log"), ((5.0, 400.0), "linear")])
def test_ssq_freqs_and_reassignment_plan(maprange, scaletype):
    N, nv, fs = 9000, 4, 1000.0
    jw, tw = _both("gmw")
    scales, st, na, nv_s = j_process_scales(scaletype, N, jw, nv=nv,
                                            get_params=True)
    _, _, _, nv_a = j_process_scales(scales, N, get_params=True)
    want = j_ssq.compute_associated_frequencies(scales, N, jw, scaletype,
                                                maprange, True, 1 / fs)
    got = t_ssq.compute_associated_frequencies(scales, N, tw, scaletype,
                                               maprange, True, 1 / fs)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    kw = dict(transform="cwt", cwt_scaletype=st, nv=nv_a, scales=scales)
    c_w, m_w, p_w = j_ssq.plan_reassignment(want, na, scaletype != "linear",
                                            **kw)
    c_g, m_g, p_g = t_ssq.plan_reassignment(want, na, scaletype != "linear",
                                            **kw)
    assert m_g == m_w and p_g == p_w
    assert np.array_equal(c_g, c_w)


@pytest.mark.parametrize("freqs,logscale", [
    (np.geomspace(0.05, 50.0, 200), True),
    (np.linspace(0.05, 50.0, 200), False),
    (np.hstack([np.geomspace(1, 10, 50)[:-1], np.geomspace(10, 400, 20)]),
     True)])
def test_bin_params(freqs, logscale):
    assert t_ssq.bin_params(freqs, logscale) == j_ssq.bin_params(freqs,
                                                                 logscale)


@pytest.mark.parametrize("M", [4, 2 ** 10, 2 ** 14, 2 ** 15, 2 ** 18, 2 ** 22])
def test_split_and_grid(M):
    assert t_fft.best_split(M) == j_fft.best_split(M)
    if M >= 2 ** 10:
        assert np.array_equal(xi_grid(M).numpy(), _xi_grid_np(M))


@pytest.mark.parametrize("wavelet", WAVELETS)
def test_filterbank_and_admissibility(wavelet):
    """Pw sampled on the host is the same numpy code in both packages:
    exact. Sampled on the device (torch vs XLA, float32), the exp/log/pow
    of two libraries differ by an ulp, and the GMW exponent
    (beta*ln w - w^gamma, ~1e2) amplifies that to ~1e-5 relative, so the
    device filterbanks are held to 2e-5 of max|Pw|, and torch's to 1e-5 of
    the float64 filterbank."""
    jw, tw = _both(wavelet)
    sc = j_process_scales("log-piecewise", 9000, jw, nv=4).squeeze(-1)
    sc = sc.astype(np.float32)
    xig = _xi_grid_np(2 ** 14)
    w = sc[:, None, None] * xig[None]
    assert np.array_equal(tw.psih(w, np), jw.psih(w, np))
    assert t_adm_ssq(tw) == j_adm_ssq(jw)

    pw_t = tw.psih(torch.as_tensor(sc)[:, None, None] *
                   torch.as_tensor(xig)[None], torch).to(torch.float32)
    pw_j = jw.psih(jnp.asarray(sc)[:, None, None] * jnp.asarray(xig)[None],
                   jnp).astype(jnp.float32)
    pw_64 = jw.psih(sc[:, None, None].astype(np.float64) *
                    xig[None].astype(np.float64), np)
    scale = np.abs(pw_64).max()
    assert np.abs(pw_t.numpy() - np.asarray(pw_j)).max() < 2e-5 * scale
    assert np.abs(pw_t.numpy() - pw_64).max() < 1e-5 * scale


@pytest.mark.parametrize("wavelet", ["gmw", ("gmw", {"beta": 8.0}),
                                     ("gmw", {"order": 2})])
def test_gmw_filterbank_does_not_depend_on_threads(wavelet):
    """The float32 GMW filterbank of `test_filterbank_and_admissibility`,
    sampled by torch on the CPU 20 times on one intra-op thread and 20
    times on six: every sample bitwise the same (a thread's share of the
    grid must not change its bits)."""
    jw, tw = _both(wavelet)
    sc = j_process_scales("log-piecewise", 9000, jw, nv=4).squeeze(-1)
    w = (torch.as_tensor(sc.astype(np.float32))[:, None, None] *
         torch.as_tensor(_xi_grid_np(2 ** 14))[None])
    before = torch.get_num_threads()
    try:
        runs = []
        for threads in (1, 6):
            torch.set_num_threads(threads)
            runs += [tw.psih(w, torch).to(torch.float32) for _ in range(20)]
    finally:
        torch.set_num_threads(before)
    assert all(torch.equal(r, runs[0]) for r in runs[1:])
