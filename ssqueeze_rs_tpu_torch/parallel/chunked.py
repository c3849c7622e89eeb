"""Sharded long-signal transforms with halo exchange (counterpart of
``ssqueeze_rs_tpu/parallel/chunked.py``).

The time axis is split over a mesh axis ('time') and the batch, where
asked, over another ('data'); each mesh entry this process holds runs its
shard program on its device: it takes window or wavelet halo samples
from its neighbours (`halo_extend`; copies between the entries of one
process, point-to-point transfers between processes), transforms its
extended segment with the port's own per-shard transforms (so the
kernels run on each shard: F in `chunked_stft`, D or E in `chunked_cwt`
and `chunked_ssq_cwt`, H in `chunked_istft`, B' or I in the squeezes)
and trims the halo. The global signal edges reflect-pad locally.

Exactness:
  * `chunked_stft` equals the full-signal `stft` bit for bit: a frame
    needs n_fft - 1 neighbouring samples, all in the halo.
  * `chunked_istft` equals the full-signal `istft` bit for bit: each
    shard takes neighbouring FRAME columns, so every kept sample adds the
    frames the full transform adds, in its order. Kernel H sums frames in
    blocks of 64 (`stft_cuda._H_FRAMES`) and then the blocks in order, so
    on H's route a shard's left frame halo is widened until its first
    frame starts a block of the full transform.
  * `chunked_cwt` / `chunked_ssq_cwt` default to the HYBRID scheme
    (`exact=True`): each scale row's discrete kernel L1 tail mass beyond
    the halo is measured on the host (`overlap_save_tail_mass`); rows
    whose tail exceeds `exact_tol` are recomputed from the FULL signal:
    every shard gathers the signal, computes its block of those rows
    with the same globally padded CWT the unsharded transform runs, and
    an all-to-all moves the rows to their columns. Those rows match the
    full transform to float rounding; overlap-save rows are bounded by
    their tail mass. With `exact=False`: pure overlap-save.

Reassignment is column-local (each time column scatters independently),
so squeezing the trimmed local columns is exact given the CWT columns;
the squeeze is planned once, on the host, for all shards.

Results come back whole: in one process on the mesh's first device,
across processes in every process (on its first device). Inputs are
arrays, tensors or `mesh.Sharded` values (`shard_batch`,
`distributed.global_from_local`).
"""
from __future__ import annotations

from types import FunctionType

import numpy as np
import torch

from ..config import EPS32, EPS64, real_dtype
from ..scales import process_scales, process_fs_and_t
from ..utils.common import WARN
from ..utils.pad import pad_params, padsignal
from ..utils.windows import get_window, window_norm, check_nola
from ..wavelets.base import Wavelet
from ..wavelets.props import time_resolution
from .distributed import exchange
from .mesh import Mesh, PartitionSpec, Sharded, block_of

__all__ = ["chunked_stft", "chunked_cwt", "chunked_ssq_cwt",
           "chunked_ssq_stft", "chunked_istft", "chunked_icwt",
           "chunked_issq_cwt", "chunked_issq_stft", "default_cwt_halo",
           "halo_extend", "overlap_save_tail_mass"]


def _clip_halo(halo, S):
    """Clip a halo to the shard length; WARN when a user-meaningful halo
    is silently reduced (the overlap-save error bound loosens)."""
    H = int(min(halo, S - 1))
    if H < int(halo):
        WARN(f"requested halo ({int(halo)}) exceeds shard length - 1 "
             f"({S - 1}); clipping to {H} — overlap-save accuracy for the "
             "largest scales degrades (use fewer/larger shards, or "
             "exact=True which globalizes the affected rows)")
    return H


def _squeeze_Wx(squeezing, Wx):
    """The squeezing transform of Wx applied before the fused scatter (with
    'lebesgue'/'abs' the phase derives from the transformed Wx, as in the
    unsharded `ssqueeze`)."""
    if isinstance(squeezing, FunctionType):
        return squeezing(Wx)
    if squeezing == "lebesgue":
        return torch.ones(Wx.shape, dtype=Wx.dtype,
                          device=Wx.device) / Wx.shape[-2]
    if squeezing == "abs":
        return Wx.abs().to(Wx.dtype)
    return Wx


def _reassign_local(Wx, dWx, const_arr, gamma, Sfs, params, *, mode, flipud,
                    transform, nf):
    """Shard-local fused reassignment: `ops.ssqueeze.reassign` with
    fused=True, so B' (or I under SSQ_TPU_REASSIGN_IMPL=mxu) on a CUDA
    shard and its plain version on a CPU one."""
    from ..ops.ssqueeze import reassign
    return reassign(Wx, dWx, const_arr, gamma, Sfs, params, mode=mode,
                    flipud=flipud, fused=True, transform=transform, nf=nf)


# -- the shard program's exchanges ---------------------------------------------
def _neighbour(idx, ax, t):
    return idx[:ax] + (t,) + idx[ax + 1:]


def _halo(mesh, blocks, axis_name, left, right, boundary):
    """Each local block (..., S) extended to (..., L + S + right) with its
    neighbours' edge samples on the mesh axis `axis_name`; L = left(entry)
    or `left`. Where no neighbour exists (the globally first / last
    entry): 'reflect' mirrors the block's own samples (excluding the edge
    sample), 'zero' pads zeros."""
    ax = mesh.axis(axis_name)
    n = mesh.devices.shape[ax]
    L = left if callable(left) else (lambda i: left)
    pairs = []
    for i in mesh.entries():
        if i[ax] > 0 and L(i) > 0:
            pairs.append((_neighbour(i, ax, i[ax] - 1), i))
        if i[ax] < n - 1 and right > 0:
            pairs.append((_neighbour(i, ax, i[ax] + 1), i))
    some = next(iter(blocks.values()))

    def width(src, dst):
        return L(dst) if src[ax] < dst[ax] else right

    def send(src, dst):
        b = blocks[src]
        return b[..., b.shape[-1] - L(dst):] if src[ax] < dst[ax] else \
            b[..., :right]

    got = exchange(mesh, pairs, send,
                   lambda s, d: (some.shape[:-1] + (width(s, d),),
                                 some.dtype))
    out = {}
    for i, xs in blocks.items():
        t, parts, Li = i[ax], [xs], L(i)
        if Li > 0:
            if t > 0:
                edge = got[(_neighbour(i, ax, t - 1), i)]
            elif boundary == "reflect":
                edge = xs[..., 1:Li + 1].flip(-1)
            else:
                edge = xs.new_zeros(xs.shape[:-1] + (Li,))
            parts.insert(0, edge)
        if right > 0:
            if t < n - 1:
                edge = got[(_neighbour(i, ax, t + 1), i)]
            elif boundary == "reflect":
                edge = xs[..., -right - 1:-1].flip(-1)
            else:
                edge = xs.new_zeros(xs.shape[:-1] + (right,))
            parts.append(edge)
        out[i] = torch.cat(parts, dim=-1)
    return out


def halo_extend(xs, axis_name: str, n_shards: int, Hl: int, Hr: int,
                boundary: str = "reflect"):
    """Extend each local time shard with `Hl`/`Hr` halo samples from its
    neighbours. xs: a `Sharded` whose last dimension is split over
    `axis_name` ((..., S) blocks) -> blocks (..., Hl + S + Hr).
    `boundary`: what the globally first/last shard uses where no neighbour
    exists — 'reflect' (signal pads, matching the dask scripts'
    boundary='reflect') or 'zero' (frame halos of chunked_istft: no frames
    exist beyond the signal)."""
    mesh = xs.mesh
    if xs.spec[-1] != axis_name or len(xs.spec) != xs.ndim:
        raise ValueError(f"halo_extend: the last dimension must be split "
                         f"over {axis_name!r} (spec {xs.spec!r})")
    if mesh.shape[axis_name] != n_shards:
        raise ValueError(f"n_shards={n_shards} but mesh axis {axis_name!r} "
                         f"has {mesh.shape[axis_name]} entries")
    S = xs.shape[-1] // n_shards
    if max(Hl, Hr) > S - 1 and boundary == "reflect" or max(Hl, Hr) > S:
        raise ValueError(f"halo ({Hl}, {Hr}) exceeds the shard length {S}")
    ext = _halo(mesh, xs.blocks, axis_name, int(Hl), int(Hr), boundary)
    return Sharded(mesh, xs.spec, xs.shape[:-1] + (
        xs.shape[-1] + n_shards * (int(Hl) + int(Hr)),), ext)


def _gather_axis(mesh, blocks, axis_name):
    """Each local entry's whole row along `axis_name`: the blocks of the
    entries that differ from it only there, concatenated in axis order
    (the all_gather)."""
    ax = mesh.axis(axis_name)
    n = mesh.devices.shape[ax]
    some = next(iter(blocks.values()))
    pairs = [(_neighbour(i, ax, u), i) for i in mesh.entries()
             for u in range(n) if u != i[ax]]
    got = exchange(mesh, pairs, lambda s, d: blocks[s],
                   lambda s, d: (some.shape, some.dtype))
    return {i: torch.cat([b if u == i[ax] else got[(_neighbour(i, ax, u), i)]
                          for u in range(n)], dim=-1)
            for i, b in blocks.items()}


def _rows_to_columns(mesh, blocks, axis_name, S):
    """The all_to_all of the hybrid CWT: entry u holds a block of rows over
    every column (..., rows, n S); entry t gets, from every u in axis
    order, u's rows at its own columns [t S, (t + 1) S), stacked along
    rows: (..., n rows, S)."""
    ax = mesh.axis(axis_name)
    n = mesh.devices.shape[ax]
    some = next(iter(blocks.values()))
    pairs = [(_neighbour(i, ax, u), i) for i in mesh.entries()
             for u in range(n)]
    got = exchange(mesh, pairs,
                   lambda s, d: blocks[s][..., d[ax] * S:(d[ax] + 1) * S],
                   lambda s, d: (some.shape[:-1] + (S,), some.dtype))
    return {i: torch.cat([got[(_neighbour(i, ax, u), i)] for u in range(n)],
                         dim=-2)
            for i in blocks}


# -- laying values out and back --------------------------------------------------
def _spec(ndim, axis_name, batch_axis_name=None):
    spec = [None] * ndim
    spec[-1] = axis_name
    if batch_axis_name is not None:
        spec[0] = batch_axis_name
    return PartitionSpec(*spec)


def _blocks(x, mesh, spec, dtype=None):
    """{local entry: block on its device} of x (array, tensor or
    `Sharded`) laid out by `spec`, in `dtype` (a torch dtype) if given."""
    if isinstance(x, Sharded):
        if x.mesh is mesh and tuple(x.spec) == tuple(spec):
            out = dict(x.blocks)
        elif x.mesh.group is None and mesh.group is None:
            return _blocks(_assemble(x.mesh, x.blocks, x.spec), mesh, spec,
                           dtype)
        else:
            raise ValueError(f"a value sharded as {x.spec!r} over another "
                             f"mesh; this transform takes {spec!r}")
    else:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.array(x))
        out = {i: block_of(t, mesh, spec, i).to(mesh.devices[i])
               for i in mesh.local()}
    if dtype is not None:
        out = {i: b.to(dtype) for i, b in out.items()}
    return out


def _shape_of(x):
    return tuple(x.shape) if isinstance(x, Sharded) else tuple(np.shape(x))


def _assemble(mesh, blocks, spec):
    """The whole value from the blocks {entry: tensor} laid out by `spec`:
    the blocks at position 0 of every mesh axis `spec` does not split
    (the others are replicas), concatenated along the dimensions it
    splits, on `mesh.first_local_device()`. Across processes each process
    first receives the blocks it lacks, at its first entry."""
    splits = [(d, mesh.axis(a)) for d, a in enumerate(spec) if a is not None]
    split_axes = {ax for _, ax in splits}
    need = [i for i in mesh.entries()
            if all(i[a] == 0 for a in range(len(i)) if a not in split_axes)]
    have = {i: blocks[i] for i in need if i in blocks}
    # every process sends each needed block it holds to every other
    # process's first entry (the same pairs in every process)
    firsts = {}
    for i in mesh.entries():
        firsts.setdefault(int(mesh.ranks[i]), i)
    pairs = [(i, firsts[r]) for i in need for r in sorted(firsts)
             if int(mesh.ranks[i]) != r]
    if pairs:
        some = next(iter(blocks.values()))
        got = exchange(mesh, pairs, lambda s, d: blocks[s],
                       lambda s, d: (some.shape, some.dtype))
        have.update({s: t for (s, _), t in got.items()})
    target = mesh.first_local_device()

    def cat(k, idx):
        if k == len(splits):
            return have[tuple(idx)].to(target)
        d, ax = splits[k]
        parts = []
        for p in range(mesh.devices.shape[ax]):
            idx[ax] = p
            parts.append(cat(k + 1, idx))
        idx[ax] = 0
        return torch.cat(parts, dim=d)

    return cat(0, [0] * mesh.devices.ndim)


def _check_divisible(N, n_shards, what="signal length"):
    if N % n_shards:
        raise ValueError(
            f"{what} ({N}) must be divisible by the time-mesh size "
            f"({n_shards}); pad or trim the signal")


# -- STFT ------------------------------------------------------------------
def _stft_shards(x, mesh, window, n_fft, win_len, hop_len, fs, modulated,
                 derivative, dtype, axis_name, batch_axis_name):
    """The shard program of `chunked_stft`: ({entry: (Sx, dSx or None)},
    ndim of x, fs, n_fft)."""
    from ..ops.stft import stft_core
    shape = _shape_of(x)
    N = shape[-1]
    n_shards = mesh.shape[axis_name]
    _check_divisible(N, n_shards)
    S = N // n_shards
    if S % hop_len:
        raise ValueError(f"shard length ({S}) must be divisible by hop_len "
                         f"({hop_len})")
    _, fs, _ = process_fs_and_t(fs, None, N)
    n_fft = int(n_fft or min(N // hop_len, 512))
    if win_len is None:
        win_len = (len(window) if isinstance(window, (np.ndarray,
                                                      torch.Tensor))
                   else n_fft)
    dtype = real_dtype(dtype)
    window, diff_window = get_window(window, win_len, n_fft, derivative=True,
                                     dtype=dtype)
    # global padlength = N + n_fft - 1 -> n1 = ceil((n_fft-1)/2)
    _, Hl, Hr = pad_params(N, N + n_fft - 1)
    if max(Hl, Hr) > S - 1:
        # the halo (reflect pad + frame overlap) would need samples from
        # beyond the NEIGHBOR shard; capping would break the bit-exactness
        # contract, so refuse loudly
        raise ValueError(
            f"n_fft={n_fft} needs a {max(Hl, Hr)}-sample halo but each of "
            f"the {n_shards} time shards holds only {S} samples; lower "
            f"n_fft, use fewer time shards, or process a longer signal")
    blocks = _blocks(x, mesh, _spec(len(shape), axis_name, batch_axis_name),
                     getattr(torch, dtype))
    ext = _halo(mesh, blocks, axis_name, Hl, Hr, "reflect")
    out = {i: stft_core(xe, window, diff_window, float(fs), n_fft=n_fft,
                        hop_len=hop_len, modulated=modulated,
                        derivative=derivative)
           for i, xe in ext.items()}
    return out, len(shape), fs, n_fft


def chunked_stft(x, mesh: Mesh, window=None, n_fft=None, win_len=None,
                 hop_len=1, fs=None, modulated=True, derivative=False,
                 dtype=None, axis_name="time", batch_axis_name=None):
    """Time-sharded STFT, bit-exact vs `ops.stft` (reflect padtype).

    Halo = the global centered pad split: left n_fft//2, right
    n_fft-1-n_fft//2 — every frame sees exactly the samples the
    full-signal transform sees. Kernel F runs once a shard (float32, hop
    1, n_fft <= 2048)."""
    out, ndim, _, _ = _stft_shards(x, mesh, window, n_fft, win_len, hop_len,
                                   fs, modulated, derivative, dtype,
                                   axis_name, batch_axis_name)
    spec = _spec(ndim + 1, axis_name, batch_axis_name)
    Sx = _assemble(mesh, {i: o[0] for i, o in out.items()}, spec)
    if derivative:
        return Sx, _assemble(mesh, {i: o[1] for i, o in out.items()}, spec)
    return Sx


# -- CWT ---------------------------------------------------------------------
def default_cwt_halo(wavelet: Wavelet, max_scale: float, n_std: float = 4.0,
                     N: int = 4096) -> int:
    """Halo sized from the wavelet's time std at the largest scale:
    std_t(scale) ~ scale * std_t(scale_ref) / scale_ref samples, and the
    halo covers `n_std` standard deviations."""
    sc = wavelet.scalec_ct
    std_ref = time_resolution(wavelet, scale=sc, N=N, nondim=False)
    return int(np.ceil(n_std * std_ref * max_scale / sc))


def overlap_save_tail_mass(wavelet: Wavelet, scales, halo: int, M: int):
    """Per-scale L1 mass fraction of the discrete wavelet kernel outside
    +-halo samples, at circular length M: the bound on the overlap-save
    error of a chunked CWT row (host numpy). The kernel is the filter the
    transform applies (the inverse FFT of the sampled psih), so this sees
    both the large scales' support and the slow tails of near-Nyquist
    rows."""
    scales = np.asarray(scales, np.float64).reshape(-1)
    out = np.empty(len(scales))
    block = max(1, (1 << 22) // max(M, 1))
    pn = (-1.0) ** np.arange(M)
    c = M // 2
    lo, hi = max(0, c - halo), min(M, c + halo + 1)
    for i0 in range(0, len(scales), block):
        sc = scales[i0:i0 + block]
        psih = np.atleast_2d(wavelet.sample(sc, M))
        a = np.abs(np.fft.ifft(psih * pn, axis=-1))
        tot = np.maximum(a.sum(-1), 1e-300)
        out[i0:i0 + len(sc)] = 1.0 - a[:, lo:hi].sum(-1) / tot
    return out


_EXACT_ROWS_CACHE: dict = {}


def _exact_rows(wavelet: Wavelet, scales_arr, H: int, M_seg: int,
                tol: float):
    """(g0, g1): the longest contiguous scale-row run whose overlap-save
    tail mass is <= tol — safe to compute from local segments. Rows
    outside [g0, g1) take the replicated global-FFT path."""
    key = (wavelet, scales_arr.tobytes(), int(H), int(M_seg), float(tol))
    if key not in _EXACT_ROWS_CACHE:
        tails = overlap_save_tail_mass(wavelet, scales_arr, H, M_seg)
        ok = tails <= tol
        best = (0, 0)
        i, n = 0, len(ok)
        while i < n:
            if ok[i]:
                j = i
                while j < n and ok[j]:
                    j += 1
                if j - i > best[1] - best[0]:
                    best = (i, j)
                i = j
            else:
                i += 1
        _EXACT_ROWS_CACHE[key] = best
    return _EXACT_ROWS_CACHE[key]


def _hybrid_cwt(mesh, blocks, wavelet: Wavelet, scales_arr, dt, *, l1_norm,
                derivative, H, S, axis_name, exact, exact_tol):
    """The per-shard CWT: overlap-save for the rows whose kernel fits the
    halo, the replicated global FFT (signal all_gather + this entry's
    block of the global rows + all_to_all of rows to columns) for the
    rest. Returns ({entry: (Wx, dWx or None)}, (g0, g1))."""
    from ..ops.cwt import cwt_core
    na = len(scales_arr)
    Se = S + 2 * H
    n_up, p1, _ = pad_params(Se)
    n_shards = mesh.shape[axis_name]
    ax = mesh.axis(axis_name)
    N = S * n_shards
    g0, g1 = (_exact_rows(wavelet, scales_arr, H, n_up, exact_tol) if exact
              else (0, na))
    scales_loc = scales_arr[g0:g1].reshape(-1)
    sc_glob = np.concatenate([scales_arr[:g0], scales_arr[g1:]]).reshape(-1)
    nag = len(sc_glob)
    _, n1g, _ = pad_params(N)
    kw = dict(wavelet=wavelet, derivative=derivative, l1_norm=l1_norm,
              rpadded=False)

    local = {}
    if g1 > g0:
        for i, xe in _halo(mesh, blocks, axis_name, H, H, "reflect").items():
            xp = padsignal(xe, "reflect")
            ol = cwt_core(xp, scales_loc, dt, N=Se, n1=p1, **kw)
            local[i] = tuple(o[..., H:H + S] if o is not None else None
                             for o in ol)
    glob = {}
    if nag:
        # gather the (small) signal, run the SAME globally-padded CWT the
        # unsharded transform runs — but only this shard's block of the
        # global rows (the list padded to a multiple of the shards with
        # its last row) — then all_to_all rows -> columns
        pad_rows = (-nag) % n_shards
        sc_pad = np.concatenate([sc_glob, np.repeat(sc_glob[-1:], pad_rows)])
        nag_s = len(sc_pad) // n_shards
        og = {}
        for i, xg in _gather_axis(mesh, blocks, axis_name).items():
            xpg = padsignal(xg, "reflect")
            k = i[ax]
            og[i] = cwt_core(xpg, sc_pad[k * nag_s:(k + 1) * nag_s], dt,
                             N=N, n1=n1g, **kw)
        Wg = _rows_to_columns(mesh, {i: o[0] for i, o in og.items()},
                              axis_name, S)
        dg = (_rows_to_columns(mesh, {i: o[1] for i, o in og.items()},
                               axis_name, S) if derivative else None)
        glob = {i: (Wg[i][..., :nag, :],
                    dg[i][..., :nag, :] if derivative else None)
                for i in blocks}

    def combine(loc, g):
        if g is None:
            return loc
        parts = [p for p in (g[..., :g0, :], loc, g[..., g0:, :])
                 if p is not None and p.shape[-2]]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)

    out = {}
    for i in blocks:
        lw, ld = local.get(i, (None, None))
        gw, gd = glob.get(i, (None, None))
        out[i] = (combine(lw, gw),
                  combine(ld, gd) if derivative else None)
    return out, (g0, g1)


def _plan_cwt(x_shape, wavelet, scales, nv, fs, l1_norm=True):
    N = x_shape[-1]
    dt, fs, _ = process_fs_and_t(fs, None, N)
    wavelet = Wavelet.build(wavelet, l1_norm=l1_norm)
    scales_arr, scaletype, _, nv_out = process_scales(scales, N, wavelet,
                                                      nv=nv, get_params=True)
    return wavelet, scales_arr, scaletype, nv_out, dt, fs


def _cwt_shards(x, mesh, wavelet, scales, nv, fs, l1_norm, derivative, halo,
                exact, exact_tol, dtype, axis_name, batch_axis_name):
    """The CWT of `chunked_cwt` and `chunked_ssq_cwt` over the shards:
    ({entry: (Wx, dWx)}, ndim, wavelet, scales_arr, scaletype, nv, dt)."""
    shape = _shape_of(x)
    N = shape[-1]
    n_shards = mesh.shape[axis_name]
    _check_divisible(N, n_shards)
    S = N // n_shards
    dtype = real_dtype(dtype)
    wavelet, scales_arr, scaletype, nv, dt, fs = _plan_cwt(
        shape, wavelet, scales, nv, fs, l1_norm=l1_norm)
    if halo is None:
        halo = default_cwt_halo(wavelet, float(scales_arr.max()))
    H = _clip_halo(halo, S)
    blocks = _blocks(x, mesh, _spec(len(shape), axis_name, batch_axis_name),
                     getattr(torch, dtype))
    out, _ = _hybrid_cwt(mesh, blocks, wavelet, scales_arr, dt,
                         l1_norm=l1_norm, derivative=derivative, H=H, S=S,
                         axis_name=axis_name, exact=exact,
                         exact_tol=exact_tol)
    return out, len(shape), wavelet, scales_arr, scaletype, nv, dt


def chunked_cwt(x, mesh: Mesh, wavelet="gmw", scales="log-piecewise", nv=32,
                fs=None, l1_norm=True, derivative=False, halo=None,
                exact=True, exact_tol=1e-6, dtype=None, axis_name="time",
                batch_axis_name=None):
    """Time-sharded CWT. Scales are planned from the GLOBAL signal length
    so rows match the full-signal transform.

    `exact=True` (default): hybrid scheme — overlap-save for rows whose
    kernel tail beyond the halo is <= `exact_tol` (L1 fraction), the
    replicated global-FFT path for the rest (see module docstring);
    `exact=False`: pure overlap-save for every row."""
    out, ndim, _, scales_arr, *_ = _cwt_shards(
        x, mesh, wavelet, scales, nv, fs, l1_norm, derivative, halo, exact,
        exact_tol, dtype, axis_name, batch_axis_name)
    spec = _spec(ndim + 1, axis_name, batch_axis_name)
    Wx = _assemble(mesh, {i: o[0] for i, o in out.items()}, spec)
    if derivative:
        dWx = _assemble(mesh, {i: o[1] for i, o in out.items()}, spec)
        return Wx, scales_arr.squeeze(), dWx
    return Wx, scales_arr.squeeze()


# -- synchrosqueezed, chunked ---------------------------------------------------
def chunked_ssq_cwt(x, mesh: Mesh, wavelet="gmw", scales="log-piecewise",
                    nv=32, fs=None, maprange="peak", squeezing="sum",
                    gamma=None, flipud=True, halo=None, exact=True,
                    exact_tol=1e-6, dtype=None, axis_name="time",
                    batch_axis_name=None):
    """Time-sharded synchrosqueezed CWT.

    CWT+derivative per shard with halo exchange (hybrid global-FFT path
    for rows exceeding the halo when `exact=True` — see chunked_cwt);
    the reassignment scatter is per-time-column, so squeezing the trimmed
    local columns is exact given local CWT columns. All planning
    (scales, ssq_freqs, const, gamma) is global so shards agree."""
    from ..ops.ssqueeze import (check_ssqueezing_args,
                                compute_associated_frequencies,
                                plan_reassignment)
    shape = _shape_of(x)
    N = shape[-1]
    wavelet_b, scales_arr, scaletype, nv_p, dt, _ = _plan_cwt(
        shape, wavelet, scales, nv, fs)
    check_ssqueezing_args(squeezing, maprange, wavelet=wavelet_b,
                          transform="cwt")
    if ((maprange == "maximal" or isinstance(maprange, tuple)) and
            scaletype == "log-piecewise"):
        # same guard as the unsharded ssqueeze
        raise ValueError("can't have `ssq_scaletype = log-piecewise` or "
                         f"tuple with `maprange = 'maximal'` (got "
                         f"{maprange})")
    # global ssq planning, once on the host for every shard
    ssq_freqs = compute_associated_frequencies(
        scales_arr, N, wavelet_b, scaletype, maprange, True, dt, "cwt")
    na = len(scales_arr)
    const_arr, mode, params = plan_reassignment(
        ssq_freqs, na, scaletype.startswith("log"), transform="cwt",
        cwt_scaletype=scaletype, nv=nv_p, scales=scales_arr)
    rdtype = real_dtype(dtype)
    if gamma is None:
        gamma = 10 * (EPS64 if rdtype == "float64" else EPS32)
    nf = len(ssq_freqs)

    out, ndim, *_ = _cwt_shards(x, mesh, wavelet, scales, nv, fs, True, True,
                                halo, exact, exact_tol, dtype, axis_name,
                                batch_axis_name)
    Tx = {i: _reassign_local(_squeeze_Wx(squeezing, Wx), dWx, const_arr,
                             gamma, None, params, mode=mode, flipud=flipud,
                             transform="cwt", nf=nf)
          for i, (Wx, dWx) in out.items()}
    spec = _spec(ndim + 1, axis_name, batch_axis_name)
    Wx = _assemble(mesh, {i: o[0] for i, o in out.items()}, spec)
    Tx = _assemble(mesh, Tx, spec)
    return Tx, Wx, ssq_freqs[::-1], scales_arr.squeeze()


def chunked_ssq_stft(x, mesh: Mesh, window=None, n_fft=None, win_len=None,
                     hop_len=1, fs=None, squeezing="sum", gamma=None,
                     flipud=False, dtype=None, axis_name="time",
                     batch_axis_name=None):
    """Time-sharded synchrosqueezed STFT (bit-exact STFT stage; column-local
    reassignment, planned once on the host)."""
    from ..ops.ssqueeze import check_ssqueezing_args, plan_reassignment

    check_ssqueezing_args(squeezing, transform="stft")
    N = _shape_of(x)[-1]
    _, fs, _ = process_fs_and_t(fs, None, N)
    rdtype = real_dtype(dtype)
    n_fft = int(n_fft or min(N // hop_len, 512))
    nf = n_fft // 2 + 1
    # row grid == make_Sfs(Sx, fs) of the unsharded path
    Sfs = np.linspace(0, 0.5 * fs, nf, dtype=np.dtype(rdtype))
    const_arr, mode, params = plan_reassignment(Sfs, nf, False,
                                                transform="stft")
    const = np.full(nf, float(const_arr[0]))
    if gamma is None:
        gamma = 10 * (EPS64 if rdtype == "float64" else EPS32)

    out, ndim, _, _ = _stft_shards(x, mesh, window, n_fft, win_len, hop_len,
                                   fs, True, True, dtype, axis_name,
                                   batch_axis_name)
    Tx = {i: _reassign_local(_squeeze_Wx(squeezing, Sx), dSx, const, gamma,
                             Sfs, params, mode=mode, flipud=flipud,
                             transform="stft", nf=nf)
          for i, (Sx, dSx) in out.items()}
    spec = _spec(ndim + 1, axis_name, batch_axis_name)
    Sx = _assemble(mesh, {i: o[0] for i, o in out.items()}, spec)
    Tx = _assemble(mesh, Tx, spec)
    ssq_freqs = Sfs[::-1] if flipud else Sfs
    return Tx, Sx, ssq_freqs, Sfs


# -- inverse transforms, sharded ------------------------------------------------
def chunked_istft(Sx, mesh: Mesh, window=None, n_fft=None, win_len=None,
                  hop_len=1, N=None, modulated=True, win_exp=1,
                  axis_name="time", batch_axis_name=None):
    """Time-sharded inverse STFT, BIT-EXACT vs `ops.stft.istft`.

    Each shard holds S frame columns; it takes Hl/Hr neighbour FRAME
    columns (zero columns at the global edges — no frames exist beyond
    the signal), runs the unsharded istft's own route (kernel H for
    complex64 at hop 1, else the irfft product and the ordered
    overlap-add) on them and keeps its own S*hop output samples. A frame
    halo rather than exchanged overlap-add partial sums, because every
    kept sample must add the frames the unsharded transform adds, in its
    order; kernel H adds frames in blocks of `stft_cuda._H_FRAMES` and
    then the blocks in order, so on its route a shard's left halo is
    widened until its first frame starts one of the unsharded
    transform's blocks. Frames beyond the signal add +0. The window-norm
    denominator is planned globally."""
    from ..ops.stft import (_irfft_mats, _irfft_mats_weighted, _irfft_spec,
                            _win_bytes, overlap_add, MATMUL_NFFT_MAX)
    from ..ops.stft_cuda import _H_FRAMES, istft_ola, istft_ola_ok

    shape = _shape_of(Sx)
    n_fft = int(n_fft or (shape[-2] - 1) * 2)
    win_len = int(win_len or n_fft)
    n_frames = shape[-1]
    hop = int(hop_len)
    N = int(N or hop * n_frames)
    if N != hop * n_frames:
        # each shard owns exactly S*hop output samples; a ragged N would
        # mis-size the sharded window_norm
        raise ValueError(
            f"chunked_istft requires N == hop_len * n_frames "
            f"(= {hop * n_frames}); got N={N}. For a ragged tail use the "
            "unsharded ops.stft.istft, or trim the result.")
    n_shards = mesh.shape[axis_name]
    _check_divisible(n_frames, n_shards, "frame count")
    S = n_frames // n_shards
    Sh = S * hop
    blocks = _blocks(Sx, mesh, _spec(len(shape), axis_name, batch_axis_name))
    double = next(iter(blocks.values())).dtype in (torch.complex128,
                                                   torch.float64)
    cdt = torch.complex128 if double else torch.complex64
    blocks = {i: b.to(cdt) for i, b in blocks.items()}
    dtype = "float64" if double else "float32"

    window = get_window(window, win_len, n_fft=n_fft, dtype=dtype)
    check_nola(window, hop)
    wn = window_norm(window, hop, n_fft, N, win_exp)     # (N + n_fft - 1,)
    h = n_fft // 2
    # frame halos: output sample j needs frames f with f*hop in
    # (j + h - n_fft, j + h]
    Hl = -(-(n_fft - 1 - h) // hop)
    Hr = -(-h // hop)
    if max(Hl, Hr) > S:
        raise ValueError(
            f"n_fft={n_fft} needs a {max(Hl, Hr)}-frame halo but each of "
            f"the {n_shards} time shards holds only {S} frames; lower "
            f"n_fft or use fewer time shards")
    ax = mesh.axis(axis_name)
    use_h = not double and hop == 1 and istft_ola_ok(n_fft)
    if use_h:
        def left(i):
            return Hl + (i[ax] * S - Hl) % _H_FRAMES
        too_wide = [t for t in range(1, n_shards)
                    if left((0,) * ax + (t,)) > S]
        if too_wide:
            raise ValueError(
                f"n_fft={n_fft}: kernel H's block-aligned frame halo "
                f"exceeds the {S} frames of a shard; use fewer time shards")
    else:
        left = Hl
    ext = _halo(mesh, blocks, axis_name, left, Hr, "zero")
    L = left if callable(left) else (lambda i: left)

    tiny = float(np.finfo(dtype).tiny)
    out = {}
    for i, Se in ext.items():
        dev = Se.device
        Sr, Si = Se.real, Se.imag
        if use_h:
            mats = (n_fft, bool(modulated), _win_bytes(window), int(win_exp))
            Fr, Fs = _irfft_mats_weighted(*mats, dev)
            ola = istft_ola(Sr, Si, Fr, Fs, n_fft, adjoint=_irfft_spec(*mats))
        else:
            if not double and n_fft <= MATMUL_NFFT_MAX:
                Fr, Fs = (torch.as_tensor(F, device=dev)
                          for F in _irfft_mats(n_fft, bool(modulated)))
                xbuf = torch.matmul(Fr, Sr) - torch.matmul(Fs, Si)
            else:
                xbuf = torch.fft.irfft(Se, n=n_fft, dim=-2)
                if modulated:
                    xbuf = torch.fft.fftshift(xbuf, dim=-2)
            n_loc = Se.shape[-1]
            ola = overlap_add(xbuf, window, hop, n_fft,
                              (n_loc - 1) * hop + n_fft, win_exp)
        a = L(i) * hop + h
        x_l = ola[..., a:a + Sh]
        t0 = i[ax] * Sh
        wn_l = torch.as_tensor(wn[h + t0:h + t0 + Sh], device=dev)
        ok = wn_l > tiny
        out[i] = torch.where(ok, x_l / torch.where(ok, wn_l,
                                                   torch.ones_like(wn_l)),
                             x_l)
    return _assemble(mesh, out, _spec(len(shape) - 1, axis_name,
                                      batch_axis_name))


def chunked_icwt(Wx, mesh: Mesh, wavelet="gmw", scales="log-piecewise",
                 nv=None, one_int=True, x_len=None, x_mean=0,
                 l1_norm=True, axis_name="time", batch_axis_name=None):
    """Time-sharded inverse CWT (one-integral form).

    The one-integral iCWT is COLUMN-LOCAL — x[j] = (2/Cpsi) * const *
    sum_rows Re(Wx[:, j])/norm(scale) — so each shard inverts its own
    time columns with globally planned scales and admissibility
    constants; no halo exchange is needed and the result equals the
    unsharded `ops.cwt.icwt`. The two-integral form convolves per scale
    and would need the CWT halo machinery; use the unsharded `icwt` for
    it."""
    if not one_int:
        raise NotImplementedError(
            "chunked_icwt supports the one-integral form only (the "
            "two-integral form needs per-scale convolution halos); use "
            "ops.cwt.icwt(one_int=False) unsharded")
    from ..ops.cwt import icwt

    shape = _shape_of(Wx)
    N = int(x_len or shape[-1])
    if N != shape[-1]:
        raise ValueError("chunked_icwt requires x_len == Wx.shape[-1] "
                         "(trimming is not time-shardable)")
    blocks = _blocks(Wx, mesh, _spec(len(shape), axis_name, batch_axis_name))
    out = {i: icwt(W, wavelet, scales=scales, nv=nv, one_int=True, x_len=N,
                   x_mean=x_mean, l1_norm=l1_norm)
           for i, W in blocks.items()}
    return _assemble(mesh, out, _spec(len(shape) - 1, axis_name,
                                      batch_axis_name))


def chunked_issq_cwt(Tx, mesh: Mesh, wavelet="gmw", cc=None, cw=None,
                     axis_name="time", batch_axis_name=None):
    """Time-sharded inverse synchrosqueezed CWT.

    x[j] = (2/Css) * sum_rows Re(Tx[:, j]) is column-local: shards invert
    independently, matching the unsharded `issq_cwt`. Component inversion
    (cc/cw curve bands, (n_times, K)) is column-local too — band masks
    are built per time column — so cc/cw shard along time with Tx."""
    from ..ops.ssq_cwt import issq_cwt

    shape = _shape_of(Tx)
    blocks = _blocks(Tx, mesh, _spec(len(shape), axis_name, batch_axis_name))
    out_spec = _spec(len(shape) - 1, axis_name, batch_axis_name)
    if cc is None and cw is None:
        out = {i: issq_cwt(T, wavelet) for i, T in blocks.items()}
        return _assemble(mesh, out, out_spec)
    cc = np.asarray(cc, np.int64)
    cw = np.asarray(cw, np.int64)
    if cc.ndim == 1:
        cc, cw = cc[:, None], cw[:, None]
    cc, cw = torch.as_tensor(cc), torch.as_tensor(cw)
    curve = PartitionSpec(axis_name, None)
    out = {i: issq_cwt(T, wavelet, cc=block_of(cc, mesh, curve, i),
                       cw=block_of(cw, mesh, curve, i))
           for i, T in blocks.items()}
    # component inversion adds a (K+1) axis before time
    return _assemble(mesh, out, PartitionSpec(*out_spec[:-1], None,
                                              out_spec[-1]))


def chunked_issq_stft(Tx, mesh: Mesh, window=None, win_len=None, n_fft=None,
                      axis_name="time", batch_axis_name=None):
    """Time-sharded inverse synchrosqueezed STFT (hop_len=1, modulated —
    the reference's invertible configuration). Column-local: x[j] =
    sum_rows Re(Tx[:, j]) * 2 / window[center]."""
    from ..ops.ssq_stft import issq_stft

    shape = _shape_of(Tx)
    blocks = _blocks(Tx, mesh, _spec(len(shape), axis_name, batch_axis_name))
    out = {i: issq_stft(T, window=window, win_len=win_len, n_fft=n_fft)
           for i, T in blocks.items()}
    return _assemble(mesh, out, _spec(len(shape) - 1, axis_name,
                                      batch_axis_name))


# -- collective byte accounting (host-side planning) ---------------------------
def comm_report(transform: str, N: int, n_shards: int, *, batch: int = 1,
                wavelet="gmw", scales="log-piecewise", nv=32, fs=None,
                n_fft=None, win_len=None, hop_len=1, window=None,
                derivative=None, halo=None, exact=True, exact_tol=1e-6,
                dtype="float32"):
    """Bytes each mesh entry SENDS per collective for one chunked
    transform call, named by the JAX package's collectives (`ppermute`:
    the halo exchange; `all_gather`: the signal of the hybrid CWT's
    global rows; `all_to_all`: those rows to their columns), whose
    counterparts the port runs (`_halo`, `_gather_axis`,
    `_rows_to_columns`).

    Pure host-side planning: the byte counts are deterministic functions
    of the transform config (the same planning code the transforms run).
    Ring-algorithm accounting: an all_gather sends (n-1) shard copies per
    device; an all_to_all sends (n-1)/n of the local block.

    Returns a dict: per-collective entries (op, what, calls,
    bytes_per_device) + totals."""
    item = np.dtype(dtype).itemsize
    citem = 2 * item
    n = int(n_shards)
    if N % n:
        raise ValueError(f"N={N} not divisible by n_shards={n}")
    S = N // n
    ent = []

    def add(op, what, calls, bytes_per_device):
        ent.append(dict(op=op, what=what, calls=int(calls),
                        bytes_per_device=int(bytes_per_device)))

    info = dict(transform=transform, N=int(N), n_shards=n, S=S,
                batch=int(batch), dtype=str(dtype))

    if transform in ("stft", "ssq_stft"):
        n_fft = int(n_fft or min(N // hop_len, 512))
        _, n1, n2 = pad_params(N, N + n_fft - 1)
        Hl, Hr = n1, n2
        add("ppermute", "signal halo (left+right)", 2,
            (Hl + Hr) * batch * item)
        info.update(halo=(Hl, Hr))
    elif transform == "istft":
        n_fft = int(n_fft)
        h = n_fft // 2
        hop = int(hop_len)
        Hl = -(-(n_fft - 1 - h) // hop)
        Hr = -(-h // hop)
        n_freqs = n_fft // 2 + 1
        add("ppermute", "frame-column halo (left+right)", 2,
            (Hl + Hr) * n_freqs * batch * citem)
        info.update(halo=(Hl, Hr))
    elif transform in ("cwt", "ssq_cwt"):
        if derivative is None:
            derivative = transform == "ssq_cwt"
        wavelet_b, scales_arr, scaletype, nv, dt, fs = _plan_cwt(
            (batch, N), wavelet, scales, nv, fs)
        if halo is None:
            halo = default_cwt_halo(wavelet_b, float(scales_arr.max()))
        H = int(min(halo, S - 1))
        na = len(scales_arr)
        Se = S + 2 * H
        n_up = pad_params(Se)[0]
        if exact:
            g0, g1 = _exact_rows(wavelet_b, scales_arr, H, n_up, exact_tol)
        else:
            g0, g1 = 0, na
        nag = na - (g1 - g0)
        nag_s = -(-nag // n) if nag else 0
        npipes = 2 if derivative else 1
        if g1 > g0:
            add("ppermute", "signal halo (left+right)", 2,
                2 * H * batch * item)
        if nag:
            add("all_gather", "full signal for global-path rows",
                1, (n - 1) * S * batch * item)
            add("all_to_all", "global-path rows -> local columns",
                npipes, ((n - 1) * nag_s * N * batch * citem) // n)
        info.update(halo=H, rows_local=g1 - g0, rows_global=nag,
                    derivative=bool(derivative))
    else:
        raise ValueError(f"unknown transform {transform!r}")

    info["collectives"] = ent
    info["total_bytes_per_device"] = sum(e["calls"] * e["bytes_per_device"]
                                         for e in ent)
    info["total_calls"] = sum(e["calls"] for e in ent)
    return info
