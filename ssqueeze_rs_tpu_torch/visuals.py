"""Visualization helpers (counterpart of ``ssqueeze_rs_tpu/visuals.py``).

Generic imshow / plot / plots / scat / plotscat / hist with ticks,
borders, norm and complex controls, vhlines, and the wavelet views:
filterbank, waveforms, heatmap, time-frequency summary, property sweeps,
GMW orders, the scale bounds, higher-order CWTs and a gif-exporting
`wavelet_tf_anim`. Data may be numpy or tensors on any device: a tensor
is moved to the host once, where matplotlib draws it. matplotlib is
imported at the first plot (`_plt`), so importing the package never
needs it.
"""
from __future__ import annotations

import numpy as np

from .utils.common import _host

__all__ = ["imshow", "plot", "scat", "plotscat", "hist", "plots",
           "vhlines", "wavelet_filterbank", "wavelet_waveforms",
           "wavelet_heatmap", "wavelet_tf", "wavelet_tf_anim",
           "sweep_std_t", "sweep_std_w", "sweep_harea", "viz_gmw_orders",
           "viz_cwt_higher_order", "viz_cwt_scalebounds"]


def _plt():
    import matplotlib.pyplot as plt
    return plt


def _title(ax, title):
    if title:
        ax.set_title(title, weight="bold", fontsize=14, loc="left")


def _apply_ticklabels(ax, xticks, yticks):
    """Label axes by value arrays, subsampled to ~8 labels."""
    def fmt(ticks):
        if all(isinstance(h, str) for h in ticks):
            return "%s"
        return ("%d" if all(float(h).is_integer() for h in ticks)
                else "%.2f")

    for vals, setter, lsetter in ((yticks, ax.set_yticks,
                                   ax.set_yticklabels),
                                  (xticks, ax.set_xticks,
                                   ax.set_xticklabels)):
        if vals is None:
            continue
        if not hasattr(vals, "__len__"):
            if not vals:          # falsy scalar (0 / False): hide ticks
                setter([])
                continue
            vals = np.atleast_1d(vals)   # truthy scalar: single tick
        vals = _host(vals)
        idxs = np.linspace(0, len(vals) - 1, min(8, len(vals))).astype(int)
        setter(idxs)
        lsetter([fmt(vals) % v for v in vals[idxs]])


def vhlines(lines, kind="v", ax=None):
    """Draw vertical/horizontal lines; `lines` is a scalar, a list, or a
    (lines, style_dict) tuple."""
    plt = _plt()
    ax = ax or plt.gca()
    lfn = ax.axvline if kind == "v" else ax.axhline
    lkw = {}
    if isinstance(lines, tuple):
        lines, lkw = lines
    if not isinstance(lines, (list, np.ndarray)):
        lines = [lines]
    for ln in lines:
        lfn(ln, **(lkw if isinstance(lkw, dict) else {}))


def _scale_plot(fig, ax, w=None, h=None, xlims=None, ylims=None,
                ax_equal=False, xlabel=None, ylabel=None):
    if w or h:
        fig.set_size_inches(12 * (w or 1), 12 * (h or 1))
    if xlims:
        ax.set_xlim(*xlims)
    if ylims:
        ax.set_ylim(*ylims)
    if ax_equal:
        ax.set_aspect("equal")
    if xlabel is not None:
        ax.set_xlabel(xlabel, weight="bold", fontsize=13)
    if ylabel is not None:
        ax.set_ylabel(ylabel, weight="bold", fontsize=13)


def imshow(data, title=None, show=True, cmap=None, norm=None, complex=None,
           abs=False, w=None, h=None, ridge=False, ticks=True, borders=True,
           aspect="auto", ax=None, fig=None, yticks=None, xticks=None,
           xlabel=None, ylabel=None, norm_scaling=1, **kw):
    """2D heatmap.

    `norm`: (vmin, vmax); `abs`: plot |data|; `complex`: side-by-side
    real/imag panels; `ridge`: mark per-column maxima; `ticks`/`borders`:
    False to hide; `norm_scaling` multiplies the (possibly default) norm.
    """
    plt = _plt()
    data = _host(data)
    if norm is None:
        mx = np.max(np.abs(data))
        vmin, vmax = (0, mx) if abs else (-mx, mx)
    else:
        vmin, vmax = norm
    vmin, vmax = vmin * norm_scaling, vmax * norm_scaling
    if cmap is None:
        cmap = "turbo" if abs else "bwr"
    _kw = dict(cmap=cmap, vmin=vmin, vmax=vmax, aspect=aspect, **kw)

    if complex:
        fig, axes = plt.subplots(1, 2, figsize=(12 * (w or 1), 6 * (h or 1)))
        axes[0].imshow(data.real, **_kw)
        axes[1].imshow(data.imag, **_kw)
        main_ax = axes[0]
        for a in axes:
            if not ticks:
                a.set_xticks([])
                a.set_yticks([])
    else:
        if ax is None:
            fig, ax = plt.subplots(figsize=(10 * (w or 1), 6 * (h or 1)))
        elif fig is None:
            fig = ax.figure
        main_ax = ax
        shown = np.abs(data) if abs else data.real
        im = main_ax.imshow(shown, **_kw)
        fig.colorbar(im, ax=main_ax)
        ridge = None if ridge is None else _host(ridge)
        ridge_on = (ridge is not None and
                    (np.ndim(ridge) > 0 or bool(ridge)))
        if ridge_on:
            if np.ndim(ridge) > 0:
                main_ax.plot(np.arange(data.shape[-1]), ridge, "r",
                             linewidth=1)
            else:  # ridge=True/1: mark per-column maxima
                mi = np.abs(data).argmax(axis=0)
                main_ax.scatter(np.arange(data.shape[-1]), mi, color="r",
                                s=4)
        if not ticks:
            main_ax.set_xticks([])
            main_ax.set_yticks([])
        _apply_ticklabels(main_ax, xticks, yticks)
        if not borders:
            for sp in main_ax.spines.values():
                sp.set_visible(False)
    if xlabel is not None:
        main_ax.set_xlabel(xlabel, weight="bold", fontsize=13)
    if ylabel is not None:
        main_ax.set_ylabel(ylabel, weight="bold", fontsize=13)
    _title(main_ax, title)
    if show:
        plt.show()
    return fig, main_ax


def plot(x, y=None, title=None, show=False, ax_equal=False, complex=0,
         abs=False, c_annot=False, w=None, h=None, dx1=False, xlims=None,
         ylims=None, vert=False, vlines=None, hlines=None, xlabel=None,
         ylabel=None, xticks=None, yticks=None, ax=None, fig=None,
         ticks=True, squeeze=True, color=None, **kw):
    """1D line plot.

    `complex`: plot real & imag (2 -> also |y|); `vert` swaps axes;
    `vlines`/`hlines`: scalar | list | (lines, style_dict);
    `ticks` may be a (x, y) pair of bools.
    """
    plt = _plt()
    ax = ax or plt.gca()
    fig = fig or plt.gcf()

    if x is None and y is None:
        raise ValueError("`x` and `y` cannot both be None")
    if x is None:
        y = _host(y)
        y = y if not squeeze else y.squeeze()
        x = np.arange(len(y))
    elif y is None:
        x = _host(x)
        x = x if not squeeze else x.squeeze()
        y = x
        x = np.arange(len(x))
    else:
        x, y = _host(x), _host(y)
        if squeeze:
            x, y = x.squeeze(), y.squeeze()
    if not complex and not abs and np.iscomplexobj(y):
        complex = 1
    if vert:
        x, y = y, x

    if complex:
        ax.plot(x, y.real, color="tab:blue", **kw)
        ax.plot(x, y.imag, color="tab:orange", **kw)
        if complex == 2:
            ax.plot(x, np.abs(y), color="k", linestyle="--", **kw)
        if c_annot:
            akw = dict(fontsize=14, xycoords="axes fraction", weight="bold")
            ax.annotate("real", xy=(.93, .95), color="tab:blue", **akw)
            ax.annotate("imag", xy=(.93, .90), color="tab:orange", **akw)
    else:
        if abs:
            y = np.abs(y)
        ax.plot(x, y, color=color, **kw)
    if dx1:
        ax.set_xticks(np.arange(len(x)))

    if vlines is not None:
        vhlines(vlines, kind="v", ax=ax)
    if hlines is not None:
        vhlines(hlines, kind="h", ax=ax)

    tx, ty = ticks if isinstance(ticks, (list, tuple)) else (ticks, ticks)
    if not tx:
        ax.set_xticks([])
    if not ty:
        ax.set_yticks([])
    _apply_ticklabels(ax, xticks, yticks)
    _title(ax, title)
    _scale_plot(fig, ax, w=w, h=h, xlims=xlims, ylims=ylims,
                ax_equal=ax_equal, xlabel=xlabel, ylabel=ylabel)
    if show:
        plt.show()


def plots(X, Y=None, nrows=None, ncols=None, tight=True, sharex=False,
          sharey=False, skw=None, pkw=None, _scat=0, show=True, titles=None,
          **kw):
    """Grid of line plots. `X`/`Y` are
    lists (entries may themselves be lists to overlay); `pkw` is a list
    of per-plot kwarg dicts; `skw` goes to plt.subplots."""
    plt = _plt()
    X = X if isinstance(X, list) else [X]
    if Y is None:
        X, Y = [None] * len(X), X
    Y = Y if isinstance(Y, list) else [Y]
    skw = skw or {}
    pkw = pkw or [{}] * len(Y)

    if nrows is None and ncols is None:
        nrows, ncols = len(Y), 1
    elif nrows is None:
        nrows = max(len(Y) // ncols, 1)
    elif ncols is None:
        ncols = max(len(Y) // nrows, 1)

    fig, axes = plt.subplots(nrows, ncols, sharex=sharex, sharey=sharey,
                             **skw)
    axes = np.atleast_1d(axes)
    for i, (ax, x, y, _pkw) in enumerate(zip(axes.flat, X, Y, pkw)):
        if isinstance(y, list):
            # overlay entry: per-overlay kwargs may be one shared dict
            # or a list of dicts
            over_kw = (_pkw if isinstance(_pkw, (list, tuple))
                       else [_pkw] * len(y))
            for _x, _y, __pkw in zip(x or [None] * len(y), y, over_kw):
                plot(_x, _y, ax=ax, fig=fig, **__pkw, **kw)
                if _scat:
                    scat(_x, _y, ax=ax, fig=fig, **__pkw, **kw)
        else:
            plot(x, y, ax=ax, fig=fig, **_pkw, **kw)
            if _scat:
                scat(x, y, ax=ax, fig=fig, **_pkw, **kw)
        if titles:
            _title(ax, titles[i])
    if tight:
        default = dict(left=0.05, right=0.98, bottom=0.05, top=0.95,
                       hspace=.2, wspace=.1)
        if isinstance(tight, dict):
            default.update(tight)
        plt.subplots_adjust(**default)
    if show:
        plt.show()


def scat(x, y=None, title=None, show=False, ax_equal=False, s=18, w=None,
         h=None, xlims=None, ylims=None, vlines=None, hlines=None,
         ticks=True, complex=False, abs=False, xlabel=None, ylabel=None,
         ax=None, fig=None, color=None, **kw):
    """Scatter."""
    plt = _plt()
    ax = ax or plt.gca()
    fig = fig or plt.gcf()
    if x is None and y is None:
        raise ValueError("`x` and `y` cannot both be None")
    if y is None:
        y = _host(x).squeeze()
        x = np.arange(len(np.atleast_1d(y)))
    x, y = _host(x), _host(y)
    if complex:
        ax.scatter(x, y.real, s=s, **kw)
        ax.scatter(x, y.imag, s=s, **kw)
    else:
        if abs:
            y = np.abs(y)
        ax.scatter(x, y, s=s, color=color, **kw)
    if not ticks:
        ax.set_xticks([])
        ax.set_yticks([])
    if vlines is not None:
        vhlines(vlines, kind="v", ax=ax)
    if hlines is not None:
        vhlines(hlines, kind="h", ax=ax)
    _title(ax, title)
    _scale_plot(fig, ax, w=w, h=h, xlims=xlims, ylims=ylims,
                ax_equal=ax_equal, xlabel=xlabel, ylabel=ylabel)
    if show:
        plt.show()


def plotscat(*args, **kw):
    """plot + scat overlay."""
    show = kw.pop("show", False)
    plot(*args, **kw)
    scat(*args, **kw)
    if show:
        _plt().show()


def hist(x, bins=500, title=None, show=True, stats=False, ax=None, fig=None,
         w=1, h=1, xlims=None, ylims=None, xlabel=None, ylabel=None):
    """Histogram; `stats=True` prints and returns (mean, std, min, max)."""
    plt = _plt()
    ax = ax or plt.gca()
    fig = fig or plt.gcf()
    x = _host(x)
    ax.hist(x.ravel(), bins=bins)
    _title(ax, title)
    _scale_plot(fig, ax, w=w, h=h, xlims=xlims, ylims=ylims,
                xlabel=xlabel, ylabel=ylabel)
    if show:
        plt.show()
    if stats:
        def fmt(n):
            return (("%.3e" % n) if (np.abs(n) > 1e3 or np.abs(n) < 1e-3)
                    else ("%.3f" % n))
        mu, std, mn, mx = x.mean(), x.std(), x.min(), x.max()
        print("(mean, std, min, max) = ({}, {}, {}, {})".format(
            *[fmt(v) for v in (mu, std, mn, mx)]))
        return mu, std, mn, mx


# -- wavelet visuals -------------------------------------------------------
def wavelet_filterbank(wavelet, N=1024, scales="log", skips=0,
                       title_append=None, show=True):
    """Overlay of freq-domain wavelets across scales. `skips`: plot every (skips+1)-th
    row; `title_append`: extra title text."""
    from .wavelets.base import Wavelet
    from .scales import process_scales
    plt = _plt()
    plt.figure()
    wavelet = Wavelet.build(wavelet)
    scales = process_scales(scales, N, wavelet)
    Psih = np.asarray(wavelet.sample(scales.squeeze(-1), N, xp=np))
    step = skips + 1     # skips=0 shows ALL
    for p in Psih[::step]:
        plt.plot(p[:N // 2])
    t = f"{wavelet.name} filterbank | N={N}"
    if title_append:
        t += " " + str(title_append)
    plt.title(t, weight="bold", loc="left")
    if show:
        plt.show()


def wavelet_waveforms(wavelet, N=1024, scale=10.0, zoom=True, show=True):
    """Time & freq domain waveforms at one scale. `zoom`: crop the time view to the
    wavelet's effective support."""
    from .wavelets.base import Wavelet
    plt = _plt()
    wavelet = Wavelet.build(wavelet)
    psih = np.asarray(wavelet.sample(float(scale), N, xp=np))
    # psi_time is already centered (spectral (-1)^n reversal); a second
    # fftshift un-centered every time-domain plot (code-review r3)
    psi = np.asarray(wavelet.psi_time(float(scale), N, xp=np))
    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    axes[0].plot(psih[:N // 2])
    axes[0].set_title("freq domain (pos half)")
    t = np.arange(N) - N // 2
    if zoom:
        a = np.abs(psi)
        nz = np.where(a > a.max() * 1e-3)[0]
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, N)
        t, psi = t[lo:hi], psi[lo:hi]
    axes[1].plot(t, psi.real)
    axes[1].plot(t, psi.imag)
    axes[1].set_title(f"time domain | scale={float(scale):.2f}")
    if show:
        plt.show()


def wavelet_heatmap(wavelet, N=1024, scales="log", show=True):
    """All-scales heatmaps."""
    from .wavelets.base import Wavelet
    from .scales import process_scales
    wavelet = Wavelet.build(wavelet)
    scales = process_scales(scales, N, wavelet)
    Psih = np.asarray(wavelet.sample(scales.squeeze(-1), N, xp=np))
    imshow(Psih[:, :N // 2], abs=True, show=show,
           title=f"{wavelet.name} filterbank heatmap")


def wavelet_tf(wavelet, N=1024, scale=None, notext=False, show=True):
    """Time-frequency joint summary of a wavelet."""
    from .wavelets.base import Wavelet
    wavelet = Wavelet.build(wavelet)
    scale = scale or wavelet.scalec_ct
    wavelet_waveforms(wavelet, N, scale, show=show)
    if not notext:
        try:
            wavelet.info(N=N)
        except Exception:
            pass


def _sweep(wavelet, prop, N=1024, scales="log", get=False, show=True):
    """Plot a wavelet property (std_t / std_w / harea) across scales. `get=True` also returns
    (scales, values)."""
    from .wavelets.base import Wavelet
    from .scales import process_scales
    plt = _plt()
    wavelet = Wavelet.build(wavelet)
    plt.figure()
    sc_all = process_scales(scales, N, wavelet).squeeze(-1)
    sc, vals = [], []
    for s in sc_all[::max(1, len(sc_all) // 64)]:
        try:
            vals.append(getattr(wavelet, prop)(float(s), N))
            sc.append(float(s))
        except Exception:
            continue  # scale's support exceeds N: no decay span exists
    plt.plot(sc, vals)
    plt.xscale("log")
    plt.xlabel("scale")
    plt.title(f"{wavelet.name} {prop} vs scale | N={N}", weight="bold",
              loc="left")
    if show:
        plt.show()
    if get:
        return np.asarray(sc), np.asarray(vals)


def sweep_std_t(wavelet, N=1024, scales="log", get=False, show=True):
    """Time resolution (std_t) across scales."""
    return _sweep(wavelet, "std_t", N, scales, get, show)


def sweep_std_w(wavelet, N=1024, scales="log", get=False, show=True):
    """Frequency resolution (std_w) across scales."""
    return _sweep(wavelet, "std_w", N, scales, get, show)


def sweep_harea(wavelet, N=1024, scales="log", get=False, show=True):
    """Heisenberg area (std_t * std_w) across scales."""
    return _sweep(wavelet, "harea", N, scales, get, show)


def wavelet_tf_anim(wavelet, N=1024, scales=None, n_frames=20,
                    savepath="wavanim.gif", fps=8, testing=False,
                    show=False):
    """Animated time-frequency view across scales, exported as a gif.

    Returns the saved path. If `savepath` exists, a numeric suffix is
    appended. With
    `savepath=None`, renders static frames instead (headless-safe).
    """
    import os
    from .wavelets.base import Wavelet
    plt = _plt()
    wavelet = Wavelet.build(wavelet)
    if scales is None:
        sc = np.logspace(np.log10(2.0), np.log10(N / 8),
                         3 if testing else n_frames)
    else:
        scales = _host(scales).squeeze()
        step = max(1, len(scales) // n_frames)
        sc = scales[::step]

    if savepath is None:
        for s in sc:
            wavelet_waveforms(wavelet, N, float(s), show=show)
        return None

    # unique path: wavanim.gif -> wavanim1.gif -> ...
    base, ext = os.path.splitext(str(savepath))
    k, path = 0, str(savepath)
    while os.path.exists(path):
        k += 1
        path = f"{base}{k}{ext}"

    from matplotlib import animation
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    (line_f,) = axes[0].plot([], [])
    (line_r,) = axes[1].plot([], [])
    (line_i,) = axes[1].plot([], [])
    axes[0].set_title("freq domain (pos half)")
    axes[1].set_title("time domain")
    xs = np.arange(N // 2)
    t = np.arange(N) - N // 2

    psihs = [np.asarray(wavelet.sample(float(s), N, xp=np)) for s in sc]
    psis = [np.asarray(wavelet.psi_time(float(s), N, xp=np))
            for s in sc]   # psi_time is already centered
    fmax = max(p[:N // 2].max() for p in psihs)
    tmax = max(np.abs(p).max() for p in psis)
    axes[0].set_xlim(0, N // 2)
    axes[0].set_ylim(0, 1.05 * fmax)
    axes[1].set_xlim(t[0], t[-1])
    axes[1].set_ylim(-1.05 * tmax, 1.05 * tmax)

    def animate(i):
        line_f.set_data(xs, psihs[i][:N // 2])
        line_r.set_data(t, psis[i].real)
        line_i.set_data(t, psis[i].imag)
        return line_f, line_r, line_i

    anim = animation.FuncAnimation(fig, animate, frames=len(sc),
                                   blit=True)
    anim.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return path


def viz_cwt_higher_order(Wx_k, scales=None, wavelet=None, **imshow_kw):
    """Heatmaps of higher-order GMW CWTs.
    `Wx_k`: list/array of per-order transforms."""
    if not isinstance(Wx_k, (list, tuple)):
        Wx_k = _host(Wx_k)
        # a single 2D transform is ONE order — atleast_3d appends the
        # new axis at the END and iterated na bogus (n, 1) "orders"
        Wx_k = Wx_k[None] if Wx_k.ndim == 2 else Wx_k
    for k, Wx in enumerate(Wx_k):
        name = wavelet if isinstance(wavelet, str) else "gmw"
        imshow(_host(Wx), abs=True,
               title=f"|CWT| {name} order {k}", **imshow_kw)


def viz_cwt_scalebounds(wavelet, N=1024, min_scale=None, max_scale=None,
                        cutoff=1.0, stdevs=2, show=True):
    """Visualize why the scale bounds were chosen: the frequency-domain
    wavelet at `min_scale` against its cutoff, and the time-domain
    wavelet at `max_scale` against its stdev span."""
    from .wavelets.base import Wavelet
    from .scales import cwt_scalebounds
    plt = _plt()
    wavelet = Wavelet.build(wavelet)
    if min_scale is None or max_scale is None:
        mn, mx = cwt_scalebounds(wavelet, N)
        min_scale = min_scale or mn
        max_scale = max_scale or mx

    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    psih = np.asarray(wavelet.sample(float(min_scale), N, xp=np))
    axes[0].plot(psih[:N // 2])
    axes[0].axhline(cutoff * psih.max(), color="r", linestyle="--",
                    linewidth=1)
    axes[0].set_title(f"min_scale={float(min_scale):.3f} | "
                      f"cutoff={cutoff}")
    psi = np.asarray(wavelet.psi_time(float(max_scale), N, xp=np))
    # (already centered — no fftshift)
    t = np.arange(N) - N // 2
    axes[1].plot(t, psi.real)
    axes[1].plot(t, psi.imag)
    try:
        from .wavelets.props import time_resolution
        std = time_resolution(wavelet, scale=float(max_scale), N=N,
                              nondim=False)
        for sgn in (-1, 1):
            axes[1].axvline(sgn * stdevs * std, color="r",
                            linestyle="--", linewidth=1)
    except Exception:
        pass
    axes[1].set_title(f"max_scale={float(max_scale):.3f} | "
                      f"{stdevs} stdevs")
    if show:
        plt.show()


def viz_gmw_orders(N=1024, n_orders=3, orders=None, gamma=3.0, beta=60.0,
                   scale=10.0, show=True):
    """Frequency-domain GMW wavelets of several orders at one scale."""
    from .wavelets.base import Wavelet
    plt = _plt()
    plt.figure()
    if orders is None:
        orders = range(int(n_orders))
    for k in orders:
        wav = Wavelet.build(("gmw", dict(gamma=gamma, beta=beta,
                                         order=int(k))))
        psih = np.asarray(wav.sample(float(scale), N, xp=np))
        plt.plot(psih[:N // 2], label=f"order {k}")
    plt.legend()
    plt.title("GMW orders", weight="bold", loc="left")
    if show:
        plt.show()
