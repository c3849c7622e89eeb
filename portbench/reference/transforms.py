"""The plain synchrosqueezed transforms the benchmark holds the program
to: full-length FFTs in torch, float64 by default, computed in blocks of
rows or frames so that one 160 000-sample channel fits beside little else.

`precision="bfloat16"` is the control: every stored intermediate (the
signal, the filters or window, the spectra, the planes) rounded to
bfloat16, arithmetic and accumulation in float32, as a bfloat16 kernel
would run. The benchmark's comparison must fail it.

Both transforms follow ssqueezepy's definitions (`ssq_cwt.py`,
`ssq_stft.py`, `ssqueezing.py`): reflect padding, the phase transform
w = |Im(dW / W)| / 2 pi (the STFT's |Sfs - Im(dS / S) / 2 pi|), entries
with |W| <= gamma = 10 * eps(float32) left out, each entry's bin in closed
form with round-half-even, and Tx[bin] += W * const.
"""
from __future__ import annotations

import numpy as np
import torch

from . import planning as P

GAMMA = 10 * P.EPS32


def _types(precision):
    if precision == "float64":
        return torch.float64, torch.complex128, None
    if precision == "bfloat16":
        return torch.float32, torch.complex64, torch.bfloat16
    raise ValueError(f"precision must be float64 or bfloat16 ({precision})")


def _store(t, low):
    """t as stored in the control's low type (real and imaginary parts
    rounded apart), or t itself."""
    if low is None:
        return t
    if t.is_complex():
        return torch.complex(t.real.to(low).to(t.real.dtype),
                             t.imag.to(low).to(t.imag.dtype))
    return t.to(low).to(t.dtype)


def reflect_pad(x, n1, n2):
    """x (..., N) extended by reflection (edge sample not repeated, as
    numpy's 'reflect' for any pad length) to n1 + N + n2 samples."""
    n = x.shape[-1]
    i = torch.arange(-n1, n + n2, device=x.device)
    period = max(2 * n - 2, 1)
    m = torch.remainder(i, period)
    return x[..., torch.where(m < n, m, period - m)]


def _scatter(tx, k, v, mask):
    """tx[k, j] += v[i, j] where mask, over one block of rows (tx: (nf, L))."""
    v = torch.where(mask, v, torch.zeros_like(v))
    k = torch.where(mask, k, torch.zeros_like(k))
    tx.real.scatter_add_(0, k, v.real)
    tx.imag.scatter_add_(0, k, v.imag)


class CwtPlan:
    """The host planning of one ssq_cwt: its scales, ssq frequencies,
    row constants and bin constants, for a signal of n samples."""

    def __init__(self, cfg, n):
        wv = cfg["wavelet"]
        if wv.get("name", "gmw") != "gmw" or wv.get("norm", "bandpass") != \
                "bandpass" or wv.get("order", 0) != 0:
            raise ValueError(f"the reference has the order-0 bandpass GMW only "
                             f"({wv})")
        if cfg.get("scales") != "log-piecewise" or cfg.get("maprange") != "peak":
            raise ValueError("the reference plans 'log-piecewise' scales and "
                             "maprange 'peak' only")
        self.n = int(n)
        self.fs = float(cfg.get("fs", 1.0))
        self.wavelet = P.GMW(wv.get("gamma", 3.0), wv.get("beta", 60.0))
        scales = P.log_piecewise_scales(self.wavelet, n, nv=int(cfg.get("nv", 32)))
        if cfg.get("rows"):
            scales = scales[:int(cfg["rows"])]
        self.scales = scales
        self.freqs = P.ssq_freqs_peak(self.wavelet, scales, n, self.fs)
        self.const = np.log(2) / P.voices(scales)
        self.bins = P.log_piecewise_bins(self.freqs)
        self.m, self.n1, _ = P.p2up(n)

    @property
    def nf(self):
        return len(self.freqs)


def cwt_bins(w, bins, nf):
    """Bin of each phase value (w finite, >= 0), flipped up-down: row 0 is
    the highest frequency."""
    vlmin0, vlmin1, dvl0, dvl1, idx1 = bins
    wl = torch.log2(torch.where(w > 0, w, torch.ones_like(w)))
    k_hi = torch.clamp(torch.round((wl - vlmin1) / dvl1) + idx1, max=nf - 1)
    k_lo = torch.clamp(torch.round((wl - vlmin0) / dvl0), min=0)
    k = torch.where(wl > vlmin1, k_hi, k_lo)
    k = torch.where(w > 0, k, torch.zeros_like(k))
    return (nf - 1) - k.to(torch.int64)


def ssq_cwt(x, plan, precision="float64", cols=None, block=32):
    """(Tx, Wx) of one channel x (N,) on x's device, columns `cols` (a
    slice, default all) of each, complex128 (complex64 for the control)."""
    rt, ct, low = _types(precision)
    cols = cols or slice(0, plan.n)
    keep = slice(plan.n1 + cols.start, plan.n1 + cols.stop)
    dev = x.device
    xp = _store(reflect_pad(x.to(rt), plan.n1, plan.m - plan.n - plan.n1), low)
    xh = _store(torch.fft.fft(xp), low)
    xi = torch.as_tensor(P.xifn(1, plan.m), dtype=rt, device=dev)
    L = keep.stop - keep.start
    tx = torch.zeros((plan.nf, L), dtype=ct, device=dev)
    wx = torch.empty((len(plan.scales), L), dtype=ct, device=dev)
    for r0 in range(0, len(plan.scales), block):
        sc = torch.as_tensor(plan.scales[r0:r0 + block], dtype=rt, device=dev)
        psih = plan.wavelet(sc[:, None] * xi[None, :], torch)
        psih[:, plan.m // 2] /= 2
        z = _store(psih, low) * xh[None, :]
        z = _store(z, low)
        w_ = _store(torch.fft.ifft(z)[:, keep], low)
        dw = _store(torch.fft.ifft(z * (1j * xi * plan.fs))[:, keep], low)
        mag2 = w_.real ** 2 + w_.imag ** 2
        ph = (dw.imag * w_.real - dw.real * w_.imag) / (mag2 * (2 * np.pi))
        ph = ph.abs()
        mask = mag2 > GAMMA ** 2
        k = cwt_bins(torch.where(mask, ph, torch.ones_like(ph)), plan.bins,
                     plan.nf)
        c = torch.as_tensor(plan.const[r0:r0 + block], dtype=rt, device=dev)
        _scatter(tx, k, w_ * c[:, None], mask)
        wx[r0:r0 + len(sc)] = w_
    return tx, wx


class StftPlan:
    """The host planning of one ssq_stft with hop 1: window, derivative
    window, Sfs (= the ssq frequencies) and its linear bin step."""

    def __init__(self, cfg, n):
        if cfg.get("window", "dpss") != "dpss" or int(cfg.get("hop_len", 1)) != 1:
            raise ValueError("the reference has the default DPSS window at "
                             "hop 1 only")
        self.n = int(n)
        self.n_fft = int(cfg["n_fft"])
        self.fs = float(cfg.get("fs", 1.0))
        self.window, self.dwindow = P.dpss_window(self.n_fft)
        self.nf = self.n_fft // 2 + 1
        self.freqs = np.linspace(0, 0.5 * self.fs, self.nf)
        self.dv = float(self.freqs[1] - self.freqs[0])
        self.n1 = self.n_fft - 1 - (self.n_fft - 1) // 2
        self.n2 = (self.n_fft - 1) // 2


def ssq_stft(x, plan, precision="float64", cols=None, block=16384):
    """(Tx, Sx) of one channel x (N,) on x's device over the frames
    `cols` (a slice, default all), complex128 (complex64 for the control):
    frames of n_fft samples at hop 1 from the reflect-padded signal, each
    rotated by -(n_fft // 2) (modulated), windowed, rfft'd."""
    rt, ct, low = _types(precision)
    cols = cols or slice(0, plan.n)
    dev = x.device
    xp = _store(reflect_pad(x.to(rt), plan.n1, plan.n2), low)
    win = _store(torch.as_tensor(plan.window, dtype=rt, device=dev), low)
    dwin = _store(torch.as_tensor(plan.dwindow, dtype=rt, device=dev), low)
    sfs = torch.as_tensor(plan.freqs, dtype=rt, device=dev)
    L = cols.stop - cols.start
    tx = torch.zeros((plan.nf, L), dtype=ct, device=dev)
    sx = torch.empty((plan.nf, L), dtype=ct, device=dev)
    for c0 in range(cols.start, cols.stop, block):
        c1 = min(c0 + block, cols.stop)
        fr = xp[c0:c1 + plan.n_fft - 1].unfold(0, plan.n_fft, 1)
        fr = torch.roll(fr, -(plan.n_fft // 2), dims=1)
        s = _store(torch.fft.rfft(fr * torch.roll(win, -(plan.n_fft // 2)))
                   .T, low)
        ds = _store(torch.fft.rfft(fr * torch.roll(dwin, -(plan.n_fft // 2)))
                    .T * plan.fs, low)
        mag2 = s.real ** 2 + s.imag ** 2
        ph = (ds.imag * s.real - ds.real * s.imag) / (mag2 * (2 * np.pi))
        ph = (sfs[:, None] - ph).abs()
        mask = mag2 > GAMMA ** 2
        k = torch.clamp(torch.round(torch.clamp(
            torch.where(mask, ph, torch.zeros_like(ph)) / plan.dv, min=0)),
            max=plan.nf - 1).to(torch.int64)
        _scatter(tx[:, c0 - cols.start:c1 - cols.start], k,
                 s * plan.dv, mask)
        sx[:, c0 - cols.start:c1 - cols.start] = s
    return tx, sx
