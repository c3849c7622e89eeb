"""Stateful streaming transforms: an unbounded signal, block by block
(counterpart of ``ssqueeze_rs_tpu/streaming.py``).

Samples arrive in chunks of any size; a host buffer carries the context
between blocks (the halo), and each full block runs one fixed-shape step
on the streamer's device (`device`: the CUDA device by default, as
`utils.common.array_device` rules). On the card a step runs the kernels
of its transform: kernel F with the derivative (STFT family) or kernel D
(CWT family), then, for the synchrosqueezing streamers, the 4-plane
reassignment `reassign_cuda.reassign4`, whose implementation
SSQ_TPU_REASSIGN_IMPL picks (kernel B' by default, kernel I with 'mxu').
On the CPU the same steps run the kernels' plain versions. Outputs come
back as numpy arrays. `dtype='float64'` runs every step in float64 (the
STFT's rfft route or the full-length CWT, then B' in double on the card),
as the JAX package's float64 streamers.

Exactness, as in the JAX package:

* STFT family: a column j of the offline transform reads exactly
  xp[j*hop : j*hop + n_fft] of the reflect-padded signal, so carrying
  n_fft - hop raw samples between blocks reproduces the offline columns;
  the left and right reflect pads are made from the first and last raw
  samples. The reassignment is column-local, so StreamingSSQSTFT is
  exact too.
* CWT family: the wavelet has infinite support; a `halo`-sample context
  bounds the error by the wavelet's L1 tail mass beyond the halo
  (`parallel.chunked.overlap_save_tail_mass`, per row in `row_tail_mass`).

Latency: a column is emitted once its right context has arrived
(`latency_samples`).

    s = StreamingSTFT(block=4096, n_fft=256)
    for chunk in source:          # any chunk sizes, any alignment
        cols = s.feed(chunk)      # (n_fft//2+1, k) ready columns, k >= 0
    tail = s.flush()              # remaining columns (right edge)
"""
from __future__ import annotations

from types import FunctionType

import numpy as np
import torch

from .config import EPS32, EPS64, real_dtype
from .ops import reassign_cuda
from .ops.cwt import cwt_core
from .ops.fft_cuda import best_split
from .ops.ssqueeze import (plan_reassignment, compute_associated_frequencies,
                           check_ssqueezing_args)
from .ops.stft import stft_core
from .parallel.chunked import default_cwt_halo, overlap_save_tail_mass
from .scales import process_scales, process_fs_and_t
from .utils.common import WARN, array_device
from .utils.pad import next_power_of_2
from .utils.windows import get_window, check_nola
from .wavelets import Wavelet

__all__ = ["StreamingSTFT", "StreamingSSQSTFT", "StreamingCWT",
           "StreamingSSQCWT"]


def _planes(z):
    """(real, imag) of a complex tensor, (z, zeros) of a real one; a plane
    tuple as it is."""
    if isinstance(z, tuple):
        return z
    return (z.real, z.imag) if z.is_complex() else (z, torch.zeros_like(z))


class _SqueezeMixin:
    """The synchrosqueezing part of a step, as `ops.ssqueeze.ssqueeze`
    does it: the squeezing transform of Wx first (with 'lebesgue', 'abs'
    or a callable, the phase comes from the transformed Wx), then the
    4-plane reassignment of the block's columns."""

    def _init_squeeze(self, squeezing, gamma, flipud, const_arr, mode,
                      params, Sfs_row, nf, transform, rdtype):
        check_ssqueezing_args(squeezing, transform=transform)
        self.squeezing = squeezing
        self.flipud = bool(flipud)
        self.nf = int(nf)
        self._transform = transform
        self._mode = mode
        self._params = dict(params)
        eps = EPS64 if rdtype == torch.float64 else EPS32
        self._gamma = float(10 * eps if gamma is None else gamma)
        self._const = torch.as_tensor(const_arr, dtype=rdtype,
                                      device=self.device)
        self._Sfs = torch.as_tensor(np.asarray(Sfs_row), dtype=rdtype,
                                    device=self.device)

    def _squeezed(self, W):
        """(the squeezed W: its planes, or itself where a real-valued
        callable made it real; W as complex)."""
        Wc = torch.complex(*W) if isinstance(W, tuple) else W
        if isinstance(self.squeezing, FunctionType):
            Wq = self.squeezing(Wc)
        elif self.squeezing == "lebesgue":
            Wq = torch.ones_like(Wc) / Wc.shape[-2]
        elif self.squeezing == "abs":
            Wq = Wc.abs().to(Wc.dtype)
        else:
            return _planes(W), Wc
        return (_planes(Wq) if Wq.is_complex() else Wq), Wc

    def _reassign_cols(self, Wq, dW):
        """Tx of the block's columns from the squeezed W (planes, or a
        real tensor) and dW (B' or I on the card, their plain versions on
        the CPU): complex, or real for a real W as the JAX package's
        scatter gives it."""
        txr, txi = reassign_cuda.reassign4(
            *_planes(Wq), *_planes(dW), self._const, self._Sfs, self._gamma,
            self._params, self._mode, self.flipud, self.nf, self._transform)
        return txr if isinstance(Wq, torch.Tensor) else torch.complex(txr, txi)


class _StreamerBase:
    """Block and buffer bookkeeping.

    Subclasses set: `_E` (step input length), `_advance` (samples consumed
    per step = block), `_cols_per_step`, `_prefix_len`/`_suffix_len`
    (the virtual pad lengths), `_hop`, `device`, `_np_dtype`, and
    implement `_step(xe) -> tuple of tensors with columns on the last
    axis`.
    """

    def _init_stream(self):
        self._staging = None        # raw samples until the prefix exists
        self._buf = None            # virtual padded stream, pending samples
        self._tail = None           # last raw samples (right reflect pad)
        self._n_raw = 0
        self._n_emitted = 0
        self._finished = False
        self._batch_shape = ()      # leading (channel) dims, set on feed

    @property
    def latency_samples(self) -> int:
        """Samples of lookahead a column waits for before it can be
        emitted (the right-context length)."""
        return self._suffix_len

    def _total_cols(self, n_raw: int) -> int:
        return 0 if n_raw == 0 else (n_raw - 1) // self._hop + 1

    @staticmethod
    def _append(buf, x):
        return x if buf is None else np.concatenate([buf, x], axis=-1)

    @staticmethod
    def _fetch(c):
        return c.detach().cpu().numpy()

    def _run(self, seg):
        xe = torch.as_tensor(np.ascontiguousarray(seg, self._np_dtype),
                             device=self.device)
        return self._step(xe)

    def _empty_out(self):
        # shape-correct empty result, so callers can concatenate blindly
        empty = tuple(np.zeros(self._batch_shape + s[:-1] + (0,), d)
                      for s, d in self._step_out_struct())
        return empty if len(empty) > 1 else empty[0]

    def _pack(self, outs):
        if not outs:
            return self._empty_out()
        cat = (outs[0] if len(outs) == 1 else
               tuple(np.concatenate(parts, axis=-1) for parts in zip(*outs)))
        return cat if len(cat) > 1 else cat[0]

    def feed(self, x):
        """Append raw samples (array or tensor, time on the last axis);
        return every column that became computable (columns on the last
        axis; several outputs as a tuple of numpy arrays)."""
        if self._finished:
            raise RuntimeError("stream already flushed; call reset()")
        x = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
             else np.asarray(x))
        if x.shape[-1]:
            if self._n_raw == 0:
                self._batch_shape = x.shape[:-1]
            elif x.shape[:-1] != self._batch_shape:
                raise ValueError(
                    f"feed() channel shape changed mid-stream: "
                    f"{x.shape[:-1]} vs {self._batch_shape}")
            self._n_raw += x.shape[-1]
            keep = self._suffix_len + 1
            t = self._append(self._tail, x)
            self._tail = t[..., -keep:] if t.shape[-1] > keep else t
            if self._buf is None:
                self._staging = self._append(self._staging, x)
                need = self._prefix_len + 1
                if self._staging.shape[-1] >= need or self._prefix_len == 0:
                    pad = [(0, 0)] * (self._staging.ndim - 1) + \
                          [(self._prefix_len, 0)]
                    self._buf = np.pad(self._staging, pad, mode="reflect")
                    self._staging = None
            else:
                self._buf = self._append(self._buf, x)

        outs = []
        while self._buf is not None and self._buf.shape[-1] >= self._E:
            cols = self._run(self._buf[..., :self._E])
            outs.append(tuple(self._fetch(c) for c in cols))
            self._buf = self._buf[..., self._advance:]
            self._n_emitted += self._cols_per_step
        return self._pack(outs)

    def flush(self):
        """Terminate the stream: make the right reflect pad, emit every
        remaining column, and freeze the streamer (reset() to reuse)."""
        if self._finished:
            raise RuntimeError("stream already flushed; call reset()")
        self._finished = True
        if self._n_raw == 0:
            return self._empty_out()
        if self._buf is None:      # stream shorter than the prefix
            pad = [(0, 0)] * (self._staging.ndim - 1) + \
                  [(self._prefix_len, 0)]
            self._buf = np.pad(self._staging, pad, mode="reflect")
            self._staging = None
        if self._suffix_len:
            t = self._tail
            # 'reflect' reflects as often as a pad wider than the tail
            # needs, as padsignal does offline, so even streams shorter
            # than the pad stay exact
            pad = [(0, 0)] * (t.ndim - 1) + [(0, self._suffix_len)]
            sfx = np.pad(t, pad, mode="reflect")[..., t.shape[-1]:]
            self._buf = self._append(self._buf, sfx)

        outs = []
        remaining = self._total_cols(self._n_raw) - self._n_emitted
        while remaining > 0:
            seg = self._buf[..., :self._E]
            if seg.shape[-1] < self._E:
                pad = [(0, 0)] * (seg.ndim - 1) + \
                      [(0, self._E - seg.shape[-1])]
                seg = np.pad(seg, pad)
            cols = self._run(seg)
            k = min(remaining, self._cols_per_step)
            outs.append(tuple(self._fetch(c[..., :k]) for c in cols))
            self._buf = self._buf[..., self._advance:]
            remaining -= k
        return self._pack(outs)

    def reset(self):
        self._init_stream()


# -- STFT family (exact) ---------------------------------------------------------
class StreamingSTFT(_StreamerBase):
    """Streaming STFT, column-exact against `ops.stft.stft`
    (padtype='reflect'), in float32 or float64, as `stft`.

    `block`: samples consumed per step (a multiple of hop_len); chunks of
    any size are buffered to blocks. `device`: where the steps run.
    """

    def __init__(self, block=4096, n_fft=None, win_len=None, hop_len=1,
                 window=None, fs=None, modulated=True, derivative=False,
                 dtype=None, device=None):
        self.block = int(block)
        self.hop_len = int(hop_len)
        if self.block % self.hop_len:
            raise ValueError("block must be a multiple of hop_len")
        self.n_fft = int(n_fft or min(self.block // self.hop_len, 512))
        if self.n_fft < self.hop_len:
            raise ValueError("n_fft must be >= hop_len")
        _, self.fs, _ = process_fs_and_t(fs, None, self.block)
        self.dtype = real_dtype(dtype)
        self._np_dtype = np.dtype(self.dtype)
        self.device = array_device(device)
        self.derivative = bool(derivative)
        self.modulated = bool(modulated)
        if win_len is None:
            win_len = (len(window)
                       if isinstance(window, (np.ndarray, torch.Tensor))
                       else self.n_fft)
        self._window, self._dwindow = get_window(
            window, win_len, self.n_fft, derivative=True, dtype=self.dtype)
        check_nola(self._window, self.hop_len)

        pad = self.n_fft - 1                     # stft's reflect pad split
        self._prefix_len = (pad + 1) // 2
        self._suffix_len = pad // 2
        self._hop = self.hop_len
        self._advance = self.block
        self._cols_per_step = self.block // self.hop_len
        self._E = self.block - self.hop_len + self.n_fft
        self._init_stream()

    def _step_out_struct(self):
        cd = "complex128" if self.dtype == "float64" else "complex64"
        s = ((self.n_fft // 2 + 1, 0), cd)
        return (s, s) if self.derivative else (s,)

    def _stft(self, xe, planar):
        """The block's STFT (and dSx with the derivative); float32 planes
        with `planar` where the matrix-product route runs."""
        planar = planar and self.n_fft <= 2048 and self.dtype == "float32"
        out = stft_core(xe, self._window, self._dwindow, self.fs,
                        n_fft=self.n_fft, hop_len=self.hop_len,
                        modulated=self.modulated,
                        derivative=self.derivative, planar_out=planar)
        if planar:
            return tuple(out[:2]), (tuple(out[2:]) if self.derivative
                                    else None)
        return out

    def _step(self, xe):
        Sx, dSx = self._stft(xe, planar=False)
        return (Sx, dSx) if self.derivative else (Sx,)


class StreamingSSQSTFT(_SqueezeMixin, _StreamerBase):
    """Streaming synchrosqueezed STFT, exact: the STFT columns are exact
    (StreamingSTFT) and the phase transform and reassignment read only
    their own column. Each step: kernel F with the derivative, then the
    4-plane reassignment (B', or I under SSQ_TPU_REASSIGN_IMPL=mxu).

    feed()/flush() return (Tx, Sx) column blocks; `ssq_freqs` / `Sfs` are
    the fixed row grids.
    """

    def __init__(self, block=4096, n_fft=None, win_len=None, hop_len=1,
                 window=None, fs=None, squeezing="sum", gamma=None,
                 flipud=False, dtype=None, device=None):
        self._stft = StreamingSTFT(block, n_fft=n_fft, win_len=win_len,
                                   hop_len=hop_len, window=window, fs=fs,
                                   modulated=True, derivative=True,
                                   dtype=dtype, device=device)
        self.device = self._stft.device
        self._np_dtype = self._stft._np_dtype
        nf = self._stft.n_fft // 2 + 1
        self.Sfs = np.linspace(0, 0.5 * self._stft.fs, nf,
                               dtype=self._np_dtype)
        const_arr, mode, params = plan_reassignment(
            self.Sfs, nf, False, transform="stft")
        self._init_squeeze(squeezing, gamma, flipud,
                           np.full(nf, float(const_arr[0])), mode, params,
                           self.Sfs, nf, "stft", getattr(torch,
                                                         self._stft.dtype))
        self.ssq_freqs = self.Sfs[::-1] if self.flipud else self.Sfs

        for a in ("_E", "_advance", "_cols_per_step", "_prefix_len",
                  "_suffix_len", "_hop"):
            setattr(self, a, getattr(self._stft, a))
        self._init_stream()

    @property
    def latency_samples(self):
        return self._stft.latency_samples

    def _step_out_struct(self):
        cd = "complex128" if self._stft.dtype == "float64" else "complex64"
        s = ((self.nf, 0), cd)
        return (s, s)

    def _step(self, xe):
        S, dS = self._stft._stft(xe, planar=True)
        Sq, Sx = self._squeezed(S)
        return self._reassign_cols(Sq, dS), Sx


# -- CWT family (halo-bounded) ---------------------------------------------------
class StreamingCWT(_StreamerBase):
    """Streaming CWT with a `halo`-sample carried context.

    Interior columns match the offline transform up to the wavelet's L1
    tail mass beyond the halo (`row_tail_mass`; the default halo comes
    from `default_cwt_halo` at the largest scale). The step length
    `block + 2*halo` is rounded up to a power of two (the planar route of
    kernel D needs one), which widens the halo for free. `plan_N` fixes
    the scale grid (default: `block`; pass the nominal recording length
    to reproduce an offline grid); the default halo is sized from that
    grid's largest scale, then capped at 3.5*block with a warning.
    """

    def __init__(self, block=8192, wavelet="gmw", scales="log-piecewise",
                 nv=32, fs=None, l1_norm=True, derivative=False, halo=None,
                 plan_N=None, dtype=None, device=None):
        self.block = int(block)
        self.dtype = real_dtype(dtype)
        self._np_dtype = np.dtype(self.dtype)
        self.device = array_device(device)
        self.derivative = bool(derivative)
        self.l1_norm = bool(l1_norm)
        self.wavelet = Wavelet.build(wavelet, l1_norm=l1_norm)
        dt, self.fs, _ = process_fs_and_t(fs, None, self.block)
        self._dt = dt

        # provisional halo -> power-of-two step length -> widened halo
        probe_N = int(plan_N or self.block)
        scales_arr, self.scaletype, _, self.nv = process_scales(
            scales, probe_N, self.wavelet, nv=nv, get_params=True)
        if halo is None:
            halo = default_cwt_halo(self.wavelet, float(scales_arr.max()))
            # the largest scales can ask for a halo many times the block;
            # the default is capped so a step stays within 8x the block
            cap = int(3.5 * self.block)
            if halo > cap:
                WARN(f"default CWT halo ({int(halo)}) exceeds 3.5*block; "
                     f"capping to {cap} — the largest scales' columns "
                     "carry extra tail-mass error (pass halo= or a larger "
                     "block to widen)")
                halo = cap
        E = next_power_of_2(self.block + 2 * int(halo))
        self._suffix_len = (E - self.block) // 2
        self._prefix_len = E - self.block - self._suffix_len
        self._E = E
        self.halo = min(self._prefix_len, self._suffix_len)
        # the grid is planned once, at plan_N, the grid the default halo
        # was sized from
        self.plan_N = probe_N
        self.scales = scales_arr.squeeze()
        self._scales_1d = np.atleast_1d(self.scales)
        self._planar = (self.dtype == "float32" and
                        self.wavelet.psih_is_real and
                        best_split(E) is not None)
        self._tail_mass = None     # lazy: row_tail_mass

        self._hop = 1
        self._advance = self.block
        self._cols_per_step = self.block
        self._init_stream()

    @property
    def row_tail_mass(self):
        """Per-scale-row L1 kernel mass outside the halo at the step
        length: the error bound of that row's streamed columns. Rows with
        mass under ~1e-6 match the offline transform to float32 rounding;
        the smallest (near-Nyquist) scales ring over the whole segment."""
        if self._tail_mass is None:
            self._tail_mass = overlap_save_tail_mass(
                self.wavelet, self._scales_1d, self.halo, self._E)
        return self._tail_mass

    def _step_out_struct(self):
        cd = "complex128" if self.dtype == "float64" else "complex64"
        s = ((len(self._scales_1d), 0), cd)
        return (s, s) if self.derivative else (s,)

    def _cwt_cols(self, xe):
        """The block's columns of Wx (and dWx): float32 planes on the
        planar route (kernel D), complex tensors otherwise."""
        xe = torch.nan_to_num(xe, nan=0.0, posinf=0.0, neginf=0.0)
        return cwt_core(xe, self._scales_1d, self._dt, wavelet=self.wavelet,
                        derivative=self.derivative, l1_norm=self.l1_norm,
                        N=self.block, n1=self._prefix_len, rpadded=False,
                        planar_out=self._planar)

    def _step(self, xe):
        Wx, dWx = self._cwt_cols(xe)
        if self._planar:
            Wx = torch.complex(*Wx)
            dWx = torch.complex(*dWx) if self.derivative else None
        return (Wx, dWx) if self.derivative else (Wx,)


class StreamingSSQCWT(_SqueezeMixin, StreamingCWT):
    """Streaming synchrosqueezed CWT: halo-bounded CWT columns, then the
    exact column-local reassignment. Each step: kernel D with the
    derivative, then the 4-plane reassignment (B', or I under
    SSQ_TPU_REASSIGN_IMPL=mxu); in float64, the full-length CWT and B' in
    double. feed()/flush() return (Tx, Wx) column blocks."""

    def __init__(self, block=8192, wavelet="gmw", scales="log-piecewise",
                 nv=32, fs=None, maprange="peak", squeezing="sum",
                 gamma=None, flipud=True, halo=None, plan_N=None,
                 dtype=None, device=None):
        super().__init__(block, wavelet=wavelet, scales=scales, nv=nv,
                         fs=fs, l1_norm=True, derivative=True, halo=halo,
                         plan_N=plan_N, dtype=dtype, device=device)
        scales_col = self._scales_1d.reshape(-1, 1)
        self.ssq_freqs = compute_associated_frequencies(
            scales_col, self.plan_N, self.wavelet, self.scaletype,
            maprange, True, self._dt, "cwt")
        na = len(scales_col)
        const_arr, mode, params = plan_reassignment(
            self.ssq_freqs, na, self.scaletype.startswith("log"),
            transform="cwt", cwt_scaletype=self.scaletype, nv=self.nv,
            scales=scales_col)
        self._init_squeeze(squeezing, gamma, flipud, const_arr, mode,
                           params, np.zeros(na), len(self.ssq_freqs), "cwt",
                           getattr(torch, self.dtype))
        # the CWT's ssq_freqs are reported flipped whatever `flipud` says
        # (scales go high -> low), as ssq_cwt reports them
        self.ssq_freqs = self.ssq_freqs[::-1]

    def _step_out_struct(self):
        na = len(self._scales_1d)
        cd = "complex128" if self.dtype == "float64" else "complex64"
        return (((self.nf, 0), cd), ((na, 0), cd))

    def _step(self, xe):
        W, dW = self._cwt_cols(xe)
        Wq, Wx = self._squeezed(W)
        return self._reassign_cols(Wq, dW), Wx
