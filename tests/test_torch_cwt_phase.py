"""Kernel A's plain-torch version (`cwt_phase_plain`) against the JAX
package's fused CWT + phase kernel (`cwt_halfband_fused(phase_gamma=...)`,
Pallas in interpret mode), both fed the same JAX-planned inputs: white
noise, N = 9000 (M = 2^14, the smallest M the JAX kernel builds for),
GMW log-piecewise scales at nv = 4.

The JAX kernel multiplies in bf16x3, about 5e-6 of max|Wx| off the exact
transform on this input, while the torch version is a float32 FFT; so
each is also held to a float64 transform of the same inputs.

Tolerances:
  Wx      max|dWx| / max|Wx|: JAX vs torch < 1e-5; torch vs float64 < 1e-6
  w       where |Wx|^2 > 1e4 gamma^2: torch vs float64 relative error
          < 1e-4 on >= 99.99 % of entries (w is ill-conditioned near 0,
          so no max bar); JAX vs torch: the gamma mask agrees on >= 99.9 %
          of entries and the frequency bins of the two w planes (the
          slice's log-piecewise plan) agree on >= 99.99 % of unmasked ones
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ssqueeze_rs_tpu.ops.cwt import _xi_grid_np
from ssqueeze_rs_tpu.ops.fft_pallas import cwt_halfband_fused
from ssqueeze_rs_tpu.scales import process_scales
from ssqueeze_rs_tpu.utils.pad import padsignal
from ssqueeze_rs_tpu.wavelets import Wavelet
from ssqueeze_rs_tpu_torch.ops import fft_cuda
from ssqueeze_rs_tpu_torch.ops.reassign_cuda import bin_indices
from ssqueeze_rs_tpu_torch.ops.ssqueeze import plan_ssqueeze

N, NV, FS = 9000, 4, 1000.0
GAMMA = 10 * float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def case():
    """JAX-planned kernel inputs for white noise, both pipelines run."""
    wav = Wavelet.build("gmw", l1_norm=True)
    scales = process_scales("log-piecewise", N, wav, nv=NV)
    sc = scales.squeeze(-1).astype(np.float32)
    x = np.random.default_rng(11).standard_normal(N).astype(np.float32)
    xp, M, n1, _ = padsignal(jnp.asarray(x), "reflect", get_params=True)
    xh = jnp.fft.rfft(xp)
    xig = _xi_grid_np(M)
    K1, M2 = xig.shape
    Pw = np.asarray(wav.psih(jnp.asarray(sc)[:, None, None] *
                             jnp.asarray(xig)[None], jnp), np.float32)
    pnyq = np.asarray(wav.psih(jnp.asarray(sc) * np.float32(np.pi), jnp) / 2,
                      np.float32)
    znyq = np.asarray(xh[-1].real, np.float32) * pnyq
    zeros = np.zeros_like(znyq)
    dt32 = np.float32(1 / FS)
    inv_dt, pi_dt = np.float32(1) / dt32, np.float32(np.pi) / dt32
    xr = np.asarray(xh.real[:M // 2], np.float32).reshape(1, K1, M2)
    xi = np.asarray(xh.imag[:M // 2], np.float32).reshape(1, K1, M2)
    args = (Pw, xr, xi, xig, inv_dt, (znyq, zeros), (zeros, znyq * pi_dt))
    jax_out = cwt_halfband_fused(
        *(jnp.asarray(a) for a in args[:5]),
        tuple(map(jnp.asarray, args[5])), tuple(map(jnp.asarray, args[6])),
        keep=(n1, N), derivative=True, phase_gamma=GAMMA, interpret=True)
    jax_out = [np.asarray(o) for o in jax_out]
    torch_out = [o.numpy() for o in fft_cuda.cwt_phase_plain(
        *args, keep=(n1, N), gamma=GAMMA)]

    # float64 transform of the same float32 inputs
    Z = (Pw.astype(np.float64) * (xr[0] + 1j * xi[0].astype(np.float64))
         ).reshape(len(sc), -1)
    s = xig.astype(np.float64).reshape(-1) * np.float64(inv_dt)
    spec = np.zeros((2, len(sc), M), complex)
    spec[0, :, :M // 2], spec[1, :, :M // 2] = Z, 1j * Z * s
    spec[0, :, M // 2] = znyq
    spec[1, :, M // 2] = 1j * znyq.astype(np.float64) * np.float64(pi_dt)
    W, dW = np.fft.ifft(spec)[..., n1:n1 + N]
    w64 = np.abs(np.imag(dW * np.conj(W))) / (np.abs(W) ** 2 * 2 * np.pi)
    return dict(args=args, keep=(n1, N), jax=jax_out, torch=torch_out,
                W64=W, w64=w64, scales=scales)


def test_wx_planes(case):
    (jr, ji, _), (tr, ti, _) = case["jax"], case["torch"]
    scale = np.abs(jr + 1j * ji).max()
    for a, b in ((tr, jr), (ti, ji)):
        assert np.abs(a - b).max() / scale < 1e-5
    W = case["W64"]
    for a, b in ((tr, W.real), (ti, W.imag)):
        assert np.abs(a - b).max() / np.abs(W).max() < 1e-6


def test_phase_plane(case):
    (jr, ji, jw), (tr, ti, tw) = case["jax"], case["torch"]
    strong = jr ** 2 + ji ** 2 > 1e4 * GAMMA ** 2
    assert strong.mean() > 0.99
    rel64 = np.abs(tw - case["w64"]) / case["w64"]
    assert (rel64[strong] < 1e-4).mean() >= 0.9999

    assert (np.isinf(jw) == np.isinf(tw)).mean() >= 0.999
    freqs, _, mode, params = plan_ssqueeze(
        N, jw.shape[0], None, case["scales"], fs=FS, maprange="peak",
        wavelet="gmw")
    kj, kt = (bin_indices(torch.as_tensor(np.array(w)), mode, params,
                          True, len(freqs)) for w in (jw, tw))
    unmasked = (kj >= 0) & (kt >= 0)
    assert float((kj == kt)[unmasked].double().mean()) >= 0.9999


def test_cpu_dispatch_takes_plain_route(case):
    """A CPU tensor (or numpy input) runs the plain version and never the
    kernel: the launch counter stays put and the result is identical."""
    before = fft_cuda.LAUNCHES
    got = fft_cuda.cwt_phase(*case["args"], keep=case["keep"], gamma=GAMMA)
    assert fft_cuda.LAUNCHES == before
    for a, b in zip(got, case["torch"]):
        assert a.device.type == "cpu"
        assert np.array_equal(a.numpy(), b)


def test_gamma_mask_and_keep_window(case):
    """w is +inf exactly where |Wx|^2 <= gamma^2; a narrower keep window
    returns the same columns."""
    big = 1e-2
    _, _, w = fft_cuda.cwt_phase_plain(*case["args"], keep=case["keep"],
                                       gamma=big)
    tr, ti, _ = case["torch"]
    masked = tr ** 2 + ti ** 2 <= np.float32(big ** 2)
    assert masked.any() and not masked.all()
    assert np.array_equal(np.isinf(w.numpy()), masked)
    n1, _ = case["keep"]
    sub = fft_cuda.cwt_phase_plain(*case["args"], keep=(n1 + 100, 512),
                                   gamma=GAMMA)
    for a, b in zip(sub, case["torch"]):
        np.testing.assert_allclose(a.numpy(), b[:, 100:612], rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())


def test_shape_checks():
    Pw = np.zeros((3, 4, 8), np.float32)
    x = np.zeros((4, 8), np.float32)
    nyq = (np.zeros(3, np.float32),) * 2
    with pytest.raises(ValueError, match="shape mismatch"):
        fft_cuda.cwt_phase(Pw, x, x[:, :4], np.zeros((4, 8)), 1.0, nyq, nyq,
                           (0, 16), GAMMA)
    with pytest.raises(ValueError, match="Nyquist"):
        fft_cuda.cwt_phase(Pw, x, x, np.zeros((4, 8)), 1.0, nyq[:1] * 2,
                           (np.zeros(2),) * 2, (0, 16), GAMMA)
    # a tensor on another device than Pw is refused, not moved
    with pytest.raises(ValueError, match="one device"):
        fft_cuda.cwt_phase(torch.zeros((3, 4, 8), device="meta"),
                           torch.zeros((4, 8)), x, x, 1.0, nyq, nyq,
                           (0, 16), GAMMA)
