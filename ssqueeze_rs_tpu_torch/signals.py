"""Test-signal generators (host numpy; counterpart of
``ssqueeze_rs_tpu/signals.py``). Signals return (x, t). All chirp laws
use exact closed-form phase integrals; `fmax` defaults to the anti-alias
bound N/2 over unit duration. The methods that plot (`demo`,
`test_transforms`, `wavcomp`, `cwt_vs_stft`, `ridgecomp`) draw through
`visuals`; those that transform run the port's transforms by their
device rule (array input on the CUDA device unless `device` says
otherwise).
"""
from __future__ import annotations

import numpy as np
import scipy.signal as sig

from .utils.common import WARN, _host

pi = np.pi

__all__ = ["TestSignals"]


def _t(tmin, tmax, N, endpoint=False):
    return np.linspace(tmin, tmax, N, endpoint=endpoint)


class TestSignals:
    """Signal bank for testing and demos."""

    __test__ = False  # not a pytest class

    SUPPORTED = ['cosine', 'sine', 'lchirp', 'echirp', 'echirp_pc', 'hchirp',
                 'par_lchirp', 'par_echirp', 'par_hchirp', 'jumps', 'packed',
                 'packed_poly', 'poly_cubic', 'am_cosine', 'am_sine',
                 'am_exp', 'am_gauss']

    def __init__(self, N=512, snr=None, seed=None):
        self.N = N
        self.snr = snr
        self.rng = np.random.default_rng(seed)

    # -- helpers ---------------------------------------------------------------
    DEFAULT_TKW = dict(tmin=0, tmax=1, endpoint=True)

    def _params(self, N, tkw, fmin=None, fmax=None):
        tmin = tkw.get("tmin", self.DEFAULT_TKW["tmin"])
        tmax = tkw.get("tmax", self.DEFAULT_TKW["tmax"])
        endpoint = tkw.get("endpoint", self.DEFAULT_TKW["endpoint"])
        t = _t(tmin, tmax, N, endpoint)
        if fmax is None:
            fmax = N // 2            # the anti-alias bound
        return t, tmin, tmax, fmax

    def _maybe_warn_alias(self, phi, name, tol=0.02):
        mx = np.diff(phi).max()
        if (mx - pi) > tol:
            WARN(f"`{name}` has aliased w/ max(diff(phi))={mx:.6f}>{pi:.6f}")

    def _maybe_noise(self, x):
        if self.snr is not None:
            power = np.mean(x**2)
            noise_var = power / 10 ** (self.snr / 10)
            x = x + self.rng.normal(0, np.sqrt(noise_var), len(x))
        return x

    # -- tones -----------------------------------------------------------------
    def sine(self, N=None, f=1, phi0=0, **tkw):
        N = N or self.N
        tkw.setdefault("endpoint", False)
        t, *_ = self._params(N, tkw)
        phi = 2 * pi * f * t + phi0
        self._maybe_warn_alias(phi, "sine")
        return self._maybe_noise(np.sin(phi)), t

    def cosine(self, N=None, f=1, phi0=0, **tkw):
        N = N or self.N
        tkw.setdefault("endpoint", False)
        t, *_ = self._params(N, tkw)
        phi = 2 * pi * f * t + phi0
        self._maybe_warn_alias(phi, "cosine")
        return self._maybe_noise(np.cos(phi)), t

    # -- chirps (closed-form phase laws) --------------------------------------
    @staticmethod
    def lchirp_fn(t, tmin, tmax, fmin, fmax, get_w=False):
        a = (fmin - fmax) / (tmin - tmax)
        b = (fmin * tmax - fmax * tmin) / (tmax - tmin)
        phi = 2 * pi * ((a / 2) * (t**2 - tmin**2) + b * (t - tmin))
        if get_w:
            return phi, 2 * pi * (a * t + b)
        return phi

    @staticmethod
    def echirp_fn(t, tmin, tmax, fmin, fmax, get_w=False):
        a = (fmin**tmax / fmax**tmin) ** (1 / (tmax - tmin))
        b = fmax ** (1 / tmax) * (1 / a) ** (1 / tmax)
        phi = 2 * pi * ((a / np.log(b)) * (b**t - b**tmin))
        if get_w:
            return phi, 2 * pi * (a * b**t)
        return phi

    @staticmethod
    def echirp_pc_fn(t, tmin, tmax, fmin, fmax, get_w=False):
        a, b, c, d = fmin, fmax, tmin, tmax
        A = (b - a) / (np.exp(d) - np.exp(c))
        B = (a * np.exp(d) - b * np.exp(c)) / (np.exp(d) - np.exp(c))
        phi = 2 * pi * (A * (np.exp(t) - np.exp(tmin)) + B * (t - tmin))
        if get_w:
            return phi, 2 * pi * (A * np.exp(t) + B)
        return phi

    @staticmethod
    def hchirp_fn(t, tmin, tmax, fmin, fmax, get_w=False):
        a, b, c, d = fmin, fmax, tmin, tmax
        AN = (2 * np.sqrt(a**3 * b**3 * (c - d) ** 4)
              + a**2 * b * (c - d) ** 2 + a * b**2 * (c - d) ** 2)
        AD = (a - b) ** 2
        BN = (np.sqrt(a**3 * b**3 * (c - d) ** 4) + a**2 * b * c * (c - d)
              + a * b**2 * d * (d - c))
        BD = a * b * (a - b) * (c - d)
        A, B = AN / AD, BN / BD
        phi = 2 * pi * (A * (1 / (B - t) + 1 / (tmin - B)))
        if get_w:
            return phi, 2 * pi * (A / (B - t) ** 2)
        return phi

    def _chirp(self, fn, N, fmin, fmax, name, **tkw):
        N = N or self.N
        t, tmin, tmax, fmax = self._params(N, tkw, fmin, fmax)
        phi = fn(t, tmin, tmax, fmin, fmax)
        self._maybe_warn_alias(phi, name)
        return self._maybe_noise(np.cos(phi)), t

    def lchirp(self, N=None, fmin=0, fmax=None, **tkw):
        return self._chirp(self.lchirp_fn, N, fmin, fmax, "lchirp", **tkw)

    def echirp(self, N=None, fmin=1, fmax=None, **tkw):
        return self._chirp(self.echirp_fn, N, fmin, fmax, "echirp", **tkw)

    def echirp_pc(self, N=None, fmin=0, fmax=None, **tkw):
        return self._chirp(self.echirp_pc_fn, N, fmin, fmax, "echirp_pc",
                           **tkw)

    def hchirp(self, N=None, fmin=0.1, fmax=None, **tkw):
        return self._chirp(self.hchirp_fn, N, fmin, fmax, "hchirp", **tkw)

    # -- parallel chirp pairs ----------------------------------------------------
    def par_lchirp(self, N=None, fmin1=None, fmax1=None, fmin2=None,
                   fmax2=None, **tkw):
        N = N or self.N
        fdiff = N / 10
        fmin1 = 0 if fmin1 is None else fmin1
        fmin2 = fmin1 + fdiff if fmin2 is None else fmin2
        if fmax1 is None:
            fmax2 = N / 2
            fmax1 = fmax2 - fdiff
        elif fmax2 is None:
            fmax2 = min(N / 2, fmax1 + fdiff)
        x1, t = self.lchirp(N, fmin1, fmax1, **tkw)
        x2, _ = self.lchirp(N, fmin2, fmax2, **tkw)
        return x1 + x2, t

    def par_echirp(self, N=None, fmin1=None, fmax1=None, fmin2=None,
                   fmax2=None, **tkw):
        N = N or self.N
        fratio = 1.5
        fmin1 = 1 if fmin1 is None else fmin1
        fmin2 = fmin1 * fratio if fmin2 is None else fmin2
        if fmax1 is None:
            fmax2 = N / 2
            fmax1 = fmax2 / fratio
        elif fmax2 is None:
            fmax2 = min(N / 2, fmax1 * fratio)
        x1, t = self.echirp(N, fmin1, fmax1, **tkw)
        x2, _ = self.echirp(N, fmin2, fmax2, **tkw)
        return x1 + x2, t

    def par_hchirp(self, N=None, fmin1=None, fmax1=None, fmin2=None,
                   fmax2=None, **tkw):
        N = N or self.N
        fratio = 3
        fmin1 = 1 if fmin1 is None else fmin1
        fmin2 = fmin1 * fratio if fmin2 is None else fmin2
        if fmax1 is None:
            fmax2 = N / 2
            fmax1 = fmax2 / fratio
        elif fmax2 is None:
            fmax2 = min(N / 2, fmax1 * fratio)
        x1, t = self.hchirp(N, fmin1, fmax1, **tkw)
        x2, _ = self.hchirp(N, fmin2, fmax2, **tkw)
        return x1 + x2, t

    # -- amplitude modulations -----------------------------------------------
    def am_sine(self, N=None, f=1, amin=0, amax=1, phi=0, **tkw):
        N = N or self.N
        _A, t = self.sine(N, f, phi, **tkw)
        return amin + (amax - amin) * (_A + 1) / 2, t

    def am_cosine(self, N=None, f=1, amin=0, amax=1, phi=0, **tkw):
        N = N or self.N
        _A, t = self.cosine(N, f, phi, **tkw)
        return amin + (amax - amin) * (_A + 1) / 2, t

    def am_exp(self, N=None, amin=0.1, amax=1, **tkw):
        N = N or self.N
        t, tmin, tmax, _ = self._params(N, tkw)
        _, w = self.echirp_fn(t, tmin, tmax, amin, amax, get_w=True)
        return w / (2 * pi), t

    def am_gauss(self, N=None, amin=0.1, amax=1, **tkw):
        N = N or self.N
        t = _t(-1, 1, N)
        _A = np.exp(-((t - t.mean()) ** 2 * 5))
        return amin + (amax - amin) * _A, t

    # -- composites -------------------------------------------------------------
    def jumps(self, N=None, freqs=None, **tkw):
        N = N or self.N
        t, tmin, tmax, _ = self._params(N, tkw)
        n_freqs = len(freqs) if freqs is not None else 4
        M = N // n_freqs
        if freqs is None:
            freqs = [1, M / 4, M / 2, M / 16]
        tdiff = tmax - tmin
        endpoint = tkw.get("endpoint", False)
        t_all = _t(tmin, tdiff * len(freqs), M * len(freqs), endpoint)
        parts = [np.cos(2 * pi * f * t_all[i * M:(i + 1) * M])
                 for i, f in enumerate(freqs)]
        return self._maybe_noise(np.hstack(parts)), t_all

    def packed(self, N=None, freqs=None, overlap=0.8, **tkw):
        N = N or self.N
        t, *_ = self._params(N, tkw)
        if freqs is None:
            freqs = [.5, 1, 2, N / 10, N / 10 + N / 50, N / 10 + N / 25,
                     N / 5, N / 4, N / 3, N / 3 + N / 10]
        N_overlap = int(overlap * len(t))
        x = np.zeros(len(t))
        for i, f in enumerate(freqs):
            idxs = (slice(0, N_overlap) if i % 2 == 0 else
                    slice(-N_overlap, None))
            x[idxs] += np.cos(2 * pi * f * t[idxs])
        return self._maybe_noise(x), t

    def packed_poly(self, N=None, **tkw):
        N = N or self.N
        t = np.linspace(0, 10, N)
        adj = N / 512
        k1, k2, k3 = 10 * adj, 2.4 * adj, 4.8 * adj
        x1 = (1 + .3 * np.cos(t)) * np.cos(
            2 * pi * (k1 * t - 0.3 * adj * np.sin(t) - 1.8 * adj * t**1.5))
        x2 = (1 + .2 * np.cos(2 * t)) * np.exp(-t / 15) * np.cos(
            2 * pi * (k2 * t + 0.5 * adj * t**1.2 + .3 * np.sin(t)))
        x3 = np.cos(2 * pi * (k3 * t + .2 * adj * t**1.3))
        return self._maybe_noise(x1 + x2 + x3), t

    def poly_cubic(self, N=None, **tkw):
        N = N or self.N
        t = np.linspace(0, 10, N, endpoint=True)
        p1 = np.poly1d([0.025, -0.36, 1.25, 2.0]) * (N / 256)
        p3 = np.poly1d([0.01, -0.25, 1.5, 4.0]) * (N / 256)
        x1 = sig.sweep_poly(t, p1)
        x3 = sig.sweep_poly(t, p3)
        x2 = np.sin(2 * pi * (.5 * N / 256) * t)
        return self._maybe_noise(x1 + x2 + x3), t

    # -- batch makers -------------------------------------------------------------
    # reference-bank defaults applied by make_signals/demo when the
    # caller passes no kwargs (reference DEFAULT_ARGS,
    # _test_signals.py:62-75; names normalized '-' -> '_')
    DEFAULT_ARGS = {
        "cosine": dict(f=64, phi0=0),
        "sine": dict(f=64, phi0=0),
        "lchirp": dict(tmin=0, tmax=1, fmin=0, fmax=None),
        "echirp": dict(tmin=0, tmax=1, fmin=1, fmax=None),
        "hchirp": dict(tmin=0, tmax=1, fmin=1, fmax=None),
        "am_cosine": dict(amin=.1),
        "am_sine": dict(amin=.1),
        "am_exp": dict(amin=.1),
        "am_gauss": dict(amin=.01),
    }

    def make_signals(self, signals="all", N=None, get_params=False):
        """Generate the requested signals: names may use '-' or '_', may be
        (name, kwargs) pairs, and may compose a carrier with an
        amplitude modulator as 'carrier:am-name'. Bank defaults
        (`DEFAULT_ARGS`) fill unspecified kwargs. Returns a list of
        signals `[x0, x1, ...]` (bare `x` for a single one); with
        `get_params`, a dict `{name: (x, t, (fparams, aparams))}`.
        """
        def is_spec(t):   # (name, kwargs) pair vs a tuple of names
            return (isinstance(t, tuple) and len(t) == 2 and
                    isinstance(t[0], str) and isinstance(t[1], dict))

        if signals == "all":
            signals = list(self.SUPPORTED)
        elif isinstance(signals, str) or is_spec(signals):
            signals = [signals]
        out = {}
        for spec in signals:
            name, kw = spec if is_spec(spec) else (spec, {})
            fname, _, aname = name.replace("-", "_").partition(":")
            aname = aname.replace("-", "_").lstrip(":")
            fkw = dict(self.DEFAULT_ARGS.get(fname, {})) if not kw else {}
            fkw.update(kw)
            x, t = getattr(self, fname)(N=N, **fkw)
            akw = {}
            if aname:
                akw = dict(self.DEFAULT_ARGS.get(aname, {}))
                x = x * getattr(self, aname)(len(x), **akw)[0]
            out[name] = (x, t, (fkw, akw))
        if get_params:
            return out
        data = [v[0] for v in out.values()]
        return data[0] if len(data) == 1 else data

    @staticmethod
    def _title(name, N, fparams, aparams):
        fp = ", ".join(f"{k}={v}" for k, v in fparams.items())
        return f"{name} | N={N}" + (f" | {fp}" if fp else "")

    def demo(self, signals="all", N=None, dft=None):
        """Plot signal waveforms, optionally with their DFTs ('rows' or
        'cols')."""
        from . import visuals
        if dft not in (None, "rows", "cols"):
            raise ValueError(f"`dft` must be 'rows', 'cols', or None "
                             f"(got {dft})")
        data = self.make_signals(signals, N, get_params=True)
        for name, (x, t, (fparams, aparams)) in data.items():
            title = self._title(name, len(x), fparams, aparams)
            visuals.plot(t, x, title=title, show=True)
            if dft:
                axrf = np.abs(np.fft.rfft(np.asarray(x)))
                visuals.plot(axrf, title=f"rDFT({name})", show=True)

    def test_transforms(self, fn, signals="all", N=None):
        """Run `fn(x, t, (name, fparams, aparams))` over the signal bank
        and imshow the (Tf, imshow kwargs) it returns (Tf one transform
        or a list of them; None plots nothing)."""
        from . import visuals
        data = self.make_signals(signals, N, get_params=True)
        for name, (x, t, (fparams, aparams)) in data.items():
            out = fn(x, t, (name, fparams, aparams))
            if out is None:
                continue
            Tf, pkw = out
            pkw = dict(pkw)
            pkw.setdefault("abs", True)
            pkw.setdefault("show", True)
            pkw.setdefault("title", self._title(name, len(x), fparams,
                                                aparams))
            for o in (Tf if isinstance(Tf, (tuple, list)) else [Tf]):
                visuals.imshow(o, **pkw)

    def wavcomp(self, wavelets, signals="all", N=None, w=1.2, h=None,
                tight_kw=None, device=None):
        """Plot |CWT| and |SSQ_CWT| of each signal for several wavelets
        side by side. `w`/`h` scale the panels; `tight_kw` is accepted
        for the JAX signature (each panel is its own figure)."""
        from .ops.ssq_cwt import ssq_cwt
        from .wavelets.base import Wavelet
        if not isinstance(wavelets, (list, tuple)):
            wavelets = [wavelets]
        wavs = [Wavelet.build(wv) for wv in wavelets]
        h = h or 0.45 * len(wavs)

        def fn(x, t, params):
            outs = []
            for wv in wavs:
                Tx, Wx, *_ = ssq_cwt(x, wv, t=t, device=device)
                outs += [np.abs(_host(Wx)), np.abs(_host(Tx))]
            return outs, dict(w=w, h=h)

        self.test_transforms(fn, signals=signals, N=N)

    def cwt_vs_stft(self, wavelet, window, signals="all", N=None,
                    win_len=None, n_fft=None, window_name=None,
                    config_str="", w=1.2, h=0.9, tight_kw=None,
                    device=None):
        """Plot |CWT| / |SSQ_CWT| and |STFT| / |SSQ_STFT| of each signal.
        `window_name`/`config_str` label the STFT panels; `w`/`h` scale
        the panels; `tight_kw` is accepted for the JAX signature."""
        from . import visuals
        from .ops.ssq_cwt import ssq_cwt
        from .ops.ssq_stft import ssq_stft

        data = self.make_signals(signals, N, get_params=True)
        for name, (x, t, (fparams, aparams)) in data.items():
            Txc, Wx, *_ = ssq_cwt(x, wavelet, t=t, device=device)
            Txs, Sx, *_ = ssq_stft(x, window=window, win_len=win_len,
                                   n_fft=n_fft, t=t, device=device)
            base = self._title(name, len(x), fparams, aparams)
            twin = "{} window | win_len={}, n_fft={} {}".format(
                window_name or "", win_len, n_fft, config_str).strip()
            for A, ttl in [(Wx, "abs(CWT)"), (Txc, "abs(SSQ_CWT)"),
                           (Sx, f"abs(STFT) | {twin}"),
                           (Txs, "abs(SSQ_STFT)")]:
                visuals.imshow(np.abs(_host(A)), abs=True, show=True,
                               w=w, h=h, title=base + "\n" + ttl)

    def ridgecomp(self, signals="all", N=None, penalty=20, n_ridges=2,
                  bw=None, transform="cwt", w=1.2, h=0.4, **transform_kw):
        """Plot the ridges extracted from each signal's transform and from
        its synchrosqueezing over the two. `transform_kw` goes to
        ssq_cwt / ssq_stft (`device` among them)."""
        from . import visuals
        from .ops.ssq_cwt import ssq_cwt
        from .ops.ssq_stft import ssq_stft
        from .ridge import extract_ridges

        if bw is None:
            tf_bw, ssq_bw = 10, 2
        elif isinstance(bw, tuple):
            tf_bw, ssq_bw = bw
        else:
            tf_bw = ssq_bw = bw

        data = self.make_signals(signals, N, get_params=True)
        tfn = ssq_cwt if transform == "cwt" else ssq_stft
        for name, (x, t, (fparams, aparams)) in data.items():
            Tfs, Tf, ssq_freqs, scales, *_ = tfn(x, t=t, **transform_kw)
            rkw = dict(penalty=penalty, n_ridges=n_ridges,
                       transform=transform)
            ridges = _host(extract_ridges(Tf, scales, bw=tf_bw, **rkw))
            ssq_ridges = _host(extract_ridges(Tfs, ssq_freqs, bw=ssq_bw,
                                              **rkw))
            Tf, Tfs = _host(Tf), _host(Tfs)
            if transform == "cwt":       # display: low frequencies down
                Tf = np.flipud(Tf)
                ridges = len(Tf) - ridges
            base = self._title(name, len(x), fparams, aparams)
            sub = (f" ridges | penalty={penalty}, n_ridges={n_ridges}, "
                   f"bw=({tf_bw},{ssq_bw})")
            for A, R, ttl in [(Tf, ridges, f"abs({transform.upper()})"),
                              (Tfs, ssq_ridges,
                               f"abs(SSQ_{transform.upper()})")]:
                plt = visuals._plt()
                visuals.imshow(np.abs(A), abs=True, show=False, w=w, h=h,
                               title=base + "\n" + ttl + sub)
                for r in range(R.shape[-1]):
                    plt.plot(np.arange(R.shape[0]), R[:, r], "k--", lw=1)
                plt.show()
