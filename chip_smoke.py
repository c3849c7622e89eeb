#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `ssqueeze_rs_tpu_torch.ssq_cwt` (and `issq_cwt`) at the headline
configuration: N = 160 000 float32 samples, default GMW, log-piecewise
scales cut to the first 300 (293 rows), maprange='peak', trig phase,
sum squeezing; then the STFT family (`stft`, `ssq_stft`, `istft`,
`issq_stft`) at the benchmark's STFT width: N = 160 000, n_fft = 598
(300 frequency rows), hop 1, the default window. Phases, one line each:

  1. the card (name and power limit from nvidia-smi); no CUDA -> exit 1
  2. build every kernel from csrc/ with nvcc, or load the library the
     sources' hash names (ptxas report copied to
     chiprun_out/chip_smoke_build.txt)
  3. kernel A (cwt_phase) against its plain-torch version at the headline
     shape, and bitwise against itself with its rows in chunks; timed with CUDA events (median of 10 after 2 warm-ups)
  4. kernel B (reassign) against its plain version on the same w plane:
     every Tx entry (so every bin) and the column sums, plus bitwise
     equality of two kernel runs; timed the same way
  5. three requests through ssq_cwt (white noise, a 100 Hz sine at
     fs = 1000, a linear chirp): each kernel launched once per request,
     finite Tx, the sine's peak within 1 % of 100 Hz, issq_cwt of the
     sine, end-to-end time; then the device result against the CPU
     (plain-torch) result for a batch of two signals at N = 20 000
  6. kernels B and B' at nf = 1025 (STFT planes at n_fft = 2048,
     N = 20 000; 16 columns per block) against their plain versions:
     every entry within 1e-5 max|Tx|, bitwise repeat
  7. kernel F (stft_dft) against plain F at the STFT width, derivative off
     (600 rows) and on (1200 rows): max|dS| / max|S| < 2e-6; timed
  8. kernel B' (reassign4, lin bins, nf = 300) on F's planes against plain
     B': every entry within 1e-5 max|Tx|, column sums within 1e-5,
     bitwise repeat; timed
  9. kernel G (ssq_stft): Sx against F's within 2e-6 relative; Tx against
     kernel B' on F's planes (>= 99.9 % of entries within 1e-5 max|Tx|,
     column sums within 1e-5) and against plain G (the same bars);
     bitwise repeat; timed against plain G
 10. kernel H (istft_ola) against plain H within 2e-6 of the largest
     sample; istft(stft(x)) with mad_rms < 1e-5; timed
 11. three requests (noise, a 100 Hz sine at fs = 1000, a chirp) through
     stft (kernel F once), ssq_stft (G once), ssq_stft with given
     ssq_freqs (F and B' once each) and istft (H once); outputs finite on
     the GPU; the sine's ssq_stft peak within 1 % of 100 Hz; issq_stft of
     the sine at fs = 1; steady stft and ssq_stft times; the device
     results against the CPU results for two signals at N = 20 000
 12. kernels C and C' (the reassignment's VJP gather): C on the headline
     w plane (nf = 293), C' on F's STFT planes (lin, nf = 300) and at
     nf = 1025, each with a seeded Tx cotangent, against the plain gather
     entry by entry (one product per entry: equal), bitwise repeat; timed
 13. the gradient of ssq_cwt at the headline width, loss sum|Tx|^2 +
     sum|Wx|^2, for the three requests of phase 5: kernels A, B and C once
     per call, finite, bitwise repeat; forward+backward time and peak
     device memory; the device gradient against the CPU gradient for two
     signals at N = 20 000 (< 5e-3; the Wx-only loss < 1e-4)
 14. the STFT family's gradients at N = 160 000, n_fft = 598: F's and H's
     adjoints (kernels H and F) against autograd of their plain versions
     (< 2e-6); stft (F forward, H backward), istft (H, then F), ssq_stft
     (G, then F, C', H) and ssq_stft with given ssq_freqs (F and B', then
     C' and H), each with its launch counts, finite and bitwise repeated,
     timed with its peak memory; device against CPU at N = 20 000

Any failed check raises and exits non-zero. The last three lines are a
JSON object of the kernels' numbers, the card's name and power limit, and
`{"ok": true, "device": ...}`.
Full results also go to chiprun_out/chip_smoke.json.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
N = 160_000
N_SMALL = 20_000    # M = 2^15 = 128 x 256: an unequal split
N_FFT = 598         # the benchmark's STFT width (bench.py): 300 rows


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, warmup=2, iters=10):
    """Median device time of fn() in ms over `iters` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def rel(torch, a, b):
    """max|a - b| / max|b|"""
    return float((a - b).abs().max() / b.abs().max())


def host_ms(torch, fn, n=5):
    """Median host time of fn() in ms over n calls, each ending in a
    synchronize (after one untimed call)."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2], times


def entry_metrics(torch, Tk, Tp):
    """(max|Tk - Tp| / max|Tp|, share of entries within 1e-5 max|Tp|,
    max column-sum difference / max|column sum|, max|Tk - Tp|)."""
    d = (Tk - Tp).abs()
    top = float(Tp.abs().max())
    cs_k, cs_p = Tk.sum(-2), Tp.sum(-2)
    col = float((cs_k - cs_p).abs().max() / cs_p.abs().max())
    return (float(d.max()) / top, float((d <= 1e-5 * top).float().mean()),
            col, float(d.max()))


def tx_metrics(np, Tx, Tx_ref):
    """(mean per-column relative error of sum_k |Tx|, |d sum Tx| over
    sum |Tx|): the bin-flip-tolerant comparison of two Tx."""
    cs, cs_ref = np.abs(Tx).sum(-2), np.abs(Tx_ref).sum(-2)
    col = float(np.mean(np.abs(cs - cs_ref) / cs_ref))
    tot = float(abs(Tx.sum() - Tx_ref.sum()) / np.abs(Tx_ref).sum())
    return col, tot


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    if not os.path.isdir(os.path.join(HERE, "ssqueeze_rs_tpu_torch")):
        raise SmokeFailure("ssqueeze_rs_tpu_torch/ not found beside the script")
    sys.path.insert(0, HERE)
    from ssqueeze_rs_tpu_torch import _build, ssq_cwt, issq_cwt
    from ssqueeze_rs_tpu_torch.ops import fft_cuda, reassign_cuda
    from ssqueeze_rs_tpu_torch.ops.cwt import cwt_phase_args
    from ssqueeze_rs_tpu_torch.ops.ssqueeze import plan_ssqueeze
    from ssqueeze_rs_tpu_torch.scales import process_scales
    from ssqueeze_rs_tpu_torch.utils.pad import padsignal
    from ssqueeze_rs_tpu_torch.wavelets import Wavelet
    from ssqueeze_rs_tpu_torch.config import EPS32

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    results = {"n": N}

    # 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    results["card"] = card
    print(f"[1] card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()}")

    # 2. build
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    built = bool(_build.BUILD_LOG)
    results["build_s"] = time.perf_counter() - t0
    with open(_build.report_path(path)) as src, \
            open(os.path.join(OUT_DIR, "chip_smoke_build.txt"), "w") as dst:
        dst.write(src.read())
    print(f"[2] build: {results['build_s']:.1f} s "
          f"({'compiled' if built else 'cached'}) -> "
          f"{os.path.relpath(path, HERE)}")

    # 3. kernel A against plain A at the headline shape
    wavelet = Wavelet.build("gmw", l1_norm=True)
    scales = process_scales("log-piecewise", N, wavelet)[:300]
    sc = scales.squeeze(-1)
    rng = np.random.default_rng(0)
    x_noise = torch.as_tensor(rng.standard_normal(N), dtype=torch.float32,
                              device=dev)
    gamma = 10 * EPS32
    xp, _, n1, _ = padsignal(x_noise, "reflect", get_params=True)
    args = cwt_phase_args(xp, sc, 1.0, wavelet)
    keep = (n1, N)
    kA = fft_cuda.cwt_phase(*args, keep=keep, gamma=gamma)
    pA = fft_cuda.cwt_phase_plain(*args, keep=keep, gamma=gamma)
    torch.cuda.synchronize()
    errA = max(rel(torch, kA[0], pA[0]), rel(torch, kA[1], pA[1]))
    absA = float(max((kA[0] - pA[0]).abs().max(), (kA[1] - pA[1]).abs().max()))
    # w is ill-conditioned where it nears 0 (its relative error is
    # unbounded there), so it is held by the share of entries with
    # |Wx|^2 > 1e4 gamma^2 whose relative error is below 1e-4
    mag2 = pA[0] ** 2 + pA[1] ** 2
    strong = mag2 > 1e4 * gamma ** 2
    w_rel = ((kA[2] - pA[2]).abs() / pA[2].abs())[strong]
    w_err = float(w_rel.max())
    w_ok = float((w_rel < 1e-4).float().mean())
    mask_agree = float((torch.isinf(kA[2]) == torch.isinf(pA[2]))
                       .float().mean())
    # rows through the intermediate in chunks (here 100, 100, 93) give
    # the same bits as one chunk: each row's work does not depend on them
    y_bytes, M = fft_cuda._Y_BYTES, xp.shape[-1]
    fft_cuda._Y_BYTES = 100 * 2 * M * 8
    try:
        kA_chunked = fft_cuda.cwt_phase(*args, keep=keep, gamma=gamma)
    finally:
        fft_cuda._Y_BYTES = y_bytes
    chunks_equal = all(torch.equal(a, b) for a, b in zip(kA, kA_chunked))
    msA = cuda_ms(torch, lambda: fft_cuda.cwt_phase(*args, keep=keep,
                                                    gamma=gamma))
    msA_plain = cuda_ms(torch, lambda: fft_cuda.cwt_phase_plain(
        *args, keep=keep, gamma=gamma))
    results["A"] = dict(wx_rel=errA, wx_abs=absA, w_rel_max=w_err,
                        w_within_1e4=w_ok, mask_agree=mask_agree,
                        chunks_equal=chunks_equal, ms=msA,
                        plain_ms=msA_plain, rows=int(args[0].shape[0]))
    print(f"[3] kernel A: rows={args[0].shape[0]} M={xp.shape[-1]} "
          f"Wx rel={errA:.3e} w within 1e-4: {w_ok:.6f} (max rel "
          f"{w_err:.3e}) mask agree={mask_agree:.6f} chunked-equal="
          f"{chunks_equal} | {msA:.3f} ms vs "
          f"plain {msA_plain:.3f} ms ({card})")
    check(errA < 1e-5, f"kernel A Wx rel error {errA:.3e} >= 1e-5")
    check(w_ok >= 0.999, f"kernel A w: only {w_ok:.6f} within 1e-4")
    check(mask_agree >= 0.999, f"kernel A mask agreement {mask_agree}")
    check(chunks_equal, "kernel A differs when its rows go in chunks")

    # 4. kernel B against plain B on the same w plane
    nf_freqs, const_arr, mode, params = plan_ssqueeze(
        N, len(sc), None, scales, fs=1.0, maprange="peak", wavelet=wavelet)
    nf = len(nf_freqs)
    const = torch.as_tensor(const_arr, dtype=torch.float32, device=dev)
    bargs = (kA[0], kA[1], kA[2], const, params, mode, True, nf)
    kB = reassign_cuda.reassign(*bargs)
    kB2 = reassign_cuda.reassign(*bargs)
    pB = reassign_cuda.reassign_plain(*bargs)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(kB[0], kB2[0]) and torch.equal(kB[1], kB2[1]))
    Tk, Tp = torch.complex(*kB), torch.complex(*pB)
    cs_k, cs_p = Tk.sum(-2), Tp.sum(-2)
    errB = float((cs_k - cs_p).abs().max() / cs_p.abs().max())
    absB = float((Tk - Tp).abs().max())
    # same w, same bin code: entries differ only by the plain version's
    # atomic sum order, so a bin sent elsewhere (a column sum cannot see
    # that) shows as a whole entry's difference
    relB = absB / float(Tp.abs().max())
    same = float((Tk == Tp).float().mean())
    msB = cuda_ms(torch, lambda: reassign_cuda.reassign(*bargs))
    msB_plain = cuda_ms(torch, lambda: reassign_cuda.reassign_plain(*bargs))
    results["B"] = dict(colsum_rel=errB, tx_abs=absB, tx_rel=relB,
                        equal_frac=same,
                        bitwise=bitwise, ms=msB, plain_ms=msB_plain, nf=nf,
                        mode=mode)
    print(f"[4] kernel B: nf={nf} mode={mode} Tx rel={relB:.3e} column-sum "
          f"rel={errB:.3e} Tx equal={same:.6f} bitwise-repeat={bitwise} | {msB:.3f} ms vs "
          f"plain {msB_plain:.3f} ms ({card})")
    check(bitwise, "kernel B differs between two runs")
    check(errB < 1e-5, f"kernel B column-sum rel error {errB:.3e} >= 1e-5")
    check(relB <= 1e-5, f"kernel B Tx rel error {relB:.3e} > 1e-5: "
          "entries in other bins than the plain version's")

    # 5. the slice end to end: three requests through ssq_cwt
    t = np.arange(N) / 1000.0
    requests = {
        "noise": (x_noise, 1.0),
        "sine100": (torch.as_tensor(np.cos(2 * np.pi * 100 * t),
                                    dtype=torch.float32, device=dev), 1000.0),
        "chirp": (torch.as_tensor(np.cos(2 * np.pi * (5 * t + 1.5 * t * t)),
                                  dtype=torch.float32, device=dev), 1000.0),
    }
    fft_cuda.LAUNCHES = reassign_cuda.LAUNCHES = 0
    outs, req_ms = {}, {}
    for name, (x, fs) in requests.items():
        before = (fft_cuda.LAUNCHES, reassign_cuda.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ssq_cwt(x, wavelet, scales=scales, fs=fs)
        torch.cuda.synchronize()
        req_ms[name] = (time.perf_counter() - t0) * 1e3
        moved = (fft_cuda.LAUNCHES - before[0],
                 reassign_cuda.LAUNCHES - before[1])
        check(moved == (1, 1), f"{name}: kernel launches moved by {moved}")
        check(out[0].is_cuda and out[1].is_cuda, f"{name}: output left the GPU")
        check(tuple(out[0].shape) == (nf, N) and tuple(out[1].shape) ==
              (len(sc), N), f"{name}: shapes {out[0].shape} {out[1].shape}")
        check(bool(torch.isfinite(out[0]).all()), f"{name}: Tx not finite")
        outs[name] = out
    launches = {"cwt_phase": fft_cuda.LAUNCHES,
                "reassign": reassign_cuda.LAUNCHES}

    Tx, _, ssq_freqs, _ = outs["sine100"]
    f_peak = float(ssq_freqs[int(Tx.abs().mean(-1).argmax())])
    xrec = issq_cwt(Tx, wavelet)
    x_sine = requests["sine100"][0]
    mad_rms = float((x_sine - xrec).abs().mean() / x_sine.pow(2).mean().sqrt())
    steady = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ssq_cwt(x_noise, wavelet, scales=scales, fs=1.0)
        torch.cuda.synchronize()
        steady.append((time.perf_counter() - t0) * 1e3)
    steady.sort()
    e2e_ms = steady[len(steady) // 2]

    # the device result against the CPU plain-torch result, small batch
    xs = np.random.default_rng(1).standard_normal((2, N_SMALL))
    xs = xs.astype(np.float32)
    g = ssq_cwt(torch.as_tensor(xs, device=dev), wavelet, fs=1000.0, nv=8)
    c = ssq_cwt(torch.as_tensor(xs), wavelet, fs=1000.0, nv=8)
    wx_small = rel(torch, g[1].cpu(), c[1])
    col_small, tot_small = tx_metrics(np, g[0].cpu().numpy(), c[0].numpy())

    results["e2e"] = dict(request_ms=req_ms, steady_ms=steady, ms=e2e_ms,
                          msamples_s=N / e2e_ms / 1e3, sine_peak_hz=f_peak,
                          issq_mad_rms=mad_rms, launches=launches,
                          small_wx_rel=wx_small, small_col_rel=col_small,
                          small_total_rel=tot_small)
    print(f"[5] ssq_cwt N={N}: requests {', '.join(f'{k} {v:.1f} ms' for k, v in req_ms.items())}; "
          f"steady {e2e_ms:.2f} ms = {N / e2e_ms / 1e3:.2f} MSamples/s ({card}); "
          f"launches {launches}; sine peak {f_peak:.3f} Hz; issq mad_rms "
          f"{mad_rms:.3e}; GPU vs CPU at N={N_SMALL}: Wx rel {wx_small:.2e}, "
          f"col rel {col_small:.2e}, total rel {tot_small:.2e}")
    check(abs(f_peak - 100.0) <= 1.0, f"sine peak at {f_peak} Hz, not 100")
    check(launches == {"cwt_phase": 3, "reassign": 3},
          f"launch counts {launches}")
    check(wx_small < 1e-5, f"GPU vs CPU Wx rel {wx_small:.2e}")
    check(col_small < 1e-4 and tot_small < 1e-5,
          f"GPU vs CPU Tx: col {col_small:.2e}, total {tot_small:.2e}")

    stft_kernels = stft_phases(np, torch, dev, card, results)
    grad_kernels = grad_phases(np, torch, dev, card, results, dict(
        requests=requests, wavelet=wavelet, scales=scales, w=kA[2],
        const=const, params=params, mode=mode, nf=nf))

    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    kernels = [
        {"name": "cwt_phase", "route": "cuda",
         "source": "ssqueeze_rs_tpu_torch/csrc/cwt_phase.cu",
         "replaces": "ssqueeze_rs_tpu/ops/fft_pallas.py:646",
         "launches": launches["cwt_phase"], "max_abs_err": absA,
         "ms": msA, "plain_ms": msA_plain},
        {"name": "reassign", "route": "cuda",
         "source": "ssqueeze_rs_tpu_torch/csrc/reassign.cu",
         "replaces": "ssqueeze_rs_tpu/ops/reassign_pallas.py:175",
         "launches": launches["reassign"], "max_abs_err": absB,
         "ms": msB, "plain_ms": msB_plain},
    ] + stft_kernels + grad_kernels
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


def stft_phases(np, torch, dev, card, results):
    """Phases 6-11: kernels B at nf = 1025, F, B', G, H, and the STFT family
    end to end. Returns the four new kernels' entries of the JSON line."""
    from ssqueeze_rs_tpu_torch import (stft, istft, ssq_stft, issq_stft,
                                       mad_rms)
    from ssqueeze_rs_tpu_torch.ops import reassign_cuda, stft_cuda
    from ssqueeze_rs_tpu_torch.ops.stft import (_k_t, _win_bytes,
                                                _irfft_mats_weighted)
    from ssqueeze_rs_tpu_torch.ops.ssqueeze import plan_reassignment
    from ssqueeze_rs_tpu_torch.utils.pad import padsignal
    from ssqueeze_rs_tpu_torch.utils.windows import get_window
    from ssqueeze_rs_tpu_torch.config import EPS32

    gamma = 10 * EPS32
    rng = np.random.default_rng(2)

    def lin_plan(nf, fs):
        Sfs = np.linspace(0, 0.5 * fs, nf, dtype=np.float32)
        const, mode, params = plan_reassignment(Sfs, nf, False,
                                                transform="stft")
        return (torch.as_tensor(Sfs, device=dev),
                torch.as_tensor(const, dtype=torch.float32, device=dev),
                mode, params)

    # 6. kernels B and B' at nf = 1025 (16 columns per block)
    x20 = torch.as_tensor(rng.standard_normal(N_SMALL), dtype=torch.float32,
                          device=dev)
    (sr, si), (dr, di) = stft(x20, n_fft=2048, derivative=True,
                              planar_out=True)
    nf6 = sr.shape[-2]
    Sfs6, const6, mode6, params6 = lin_plan(nf6, 1.0)
    a4 = (sr, si, dr, di, const6, Sfs6, gamma, params6, mode6, False, nf6,
          "stft")
    w6 = reassign_cuda.phase_w(sr, si, dr, di, Sfs6, gamma, "stft")
    a3 = (sr, si, w6, const6, params6, mode6, False, nf6)
    line = []
    for name, fn, plain, args in (
            ("B", reassign_cuda.reassign, reassign_cuda.reassign_plain, a3),
            ("B'", reassign_cuda.reassign4, reassign_cuda.reassign4_plain,
             a4)):
        k1, k2, p = fn(*args), fn(*args), plain(*args)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(k1, k2))
        r6, _, col, _ = entry_metrics(torch, torch.complex(*k1),
                                      torch.complex(*p))
        results[f"nf1025_{name}"] = dict(tx_rel=r6, colsum_rel=col,
                                         bitwise=bitwise)
        line.append(f"{name} Tx rel={r6:.3e} col rel={col:.3e} "
                    f"bitwise-repeat={bitwise}")
        check(bitwise, f"kernel {name} at nf={nf6} differs between two runs")
        check(r6 <= 1e-5, f"kernel {name} at nf={nf6}: Tx rel {r6:.3e}")
    cols = reassign_cuda._block_cols(nf6)
    print(f"[6] nf={nf6} ({cols} columns per block): {'; '.join(line)}")
    check(nf6 == 1025 and cols == 16, f"nf={nf6}, {cols} columns")
    del sr, si, dr, di, w6, a3, a4

    # 7. kernel F against plain F at the STFT width
    x = torch.as_tensor(rng.standard_normal(N), dtype=torch.float32,
                        device=dev)
    win, dwin = get_window(None, N_FFT, N_FFT, derivative=True,
                           dtype="float32")
    K2 = _k_t(_win_bytes(win), None, N_FFT, True, dev)
    K4 = _k_t(_win_bytes(win), _win_bytes(dwin), N_FFT, True, dev)
    xp = padsignal(x, "reflect", padlength=N + N_FFT - 1)
    F = {}
    for K, fs in ((K2, None), (K4, 1.0)):
        rows = K.shape[0]
        kF = stft_cuda.stft_dft(xp, K, N_FFT, N, fs=fs)
        pF = stft_cuda.stft_dft_plain(xp, K, N_FFT, N, fs=fs)
        torch.cuda.synchronize()
        d = (kF - pF).abs()
        F[rows] = dict(rel=float(d.max() / pF.abs().max()),
                       abs=float(d.max()),
                       ms=cuda_ms(torch, lambda: stft_cuda.stft_dft(
                           xp, K, N_FFT, N, fs=fs)),
                       plain_ms=cuda_ms(torch, lambda: stft_cuda.stft_dft_plain(
                           xp, K, N_FFT, N, fs=fs)))
        del pF
        if rows == K4.shape[0]:
            planes = kF
    results["F"] = F
    print("[7] kernel F: " + "; ".join(
        f"{r} rows rel={v['rel']:.3e} | {v['ms']:.3f} ms vs plain "
        f"{v['plain_ms']:.3f} ms" for r, v in F.items()) + f" ({card})")
    for r, v in F.items():
        check(v["rel"] < 2e-6, f"kernel F ({r} rows) rel {v['rel']:.3e}")

    # 8. kernel B' on F's planes (lin bins, nf = 300)
    nf = N_FFT // 2 + 1
    Sfs, const, mode, params = lin_plan(nf, 1.0)
    sr, si, dr, di = planes.split(nf, dim=-2)
    a4 = (sr, si, dr, di, const, Sfs, gamma, params, mode, False, nf, "stft")
    k1, k2 = reassign_cuda.reassign4(*a4), reassign_cuda.reassign4(*a4)
    p4 = reassign_cuda.reassign4_plain(*a4)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(k1, k2))
    Tb = torch.complex(*k1)
    rel4, _, col4, abs4 = entry_metrics(torch, Tb, torch.complex(*p4))
    ms4 = cuda_ms(torch, lambda: reassign_cuda.reassign4(*a4))
    ms4_plain = cuda_ms(torch, lambda: reassign_cuda.reassign4_plain(*a4))
    results["B4"] = dict(tx_rel=rel4, colsum_rel=col4, tx_abs=abs4,
                         bitwise=bitwise, ms=ms4, plain_ms=ms4_plain, nf=nf)
    print(f"[8] kernel B': nf={nf} mode={mode} Tx rel={rel4:.3e} column-sum "
          f"rel={col4:.3e} bitwise-repeat={bitwise} | {ms4:.3f} ms vs plain "
          f"{ms4_plain:.3f} ms ({card})")
    check(bitwise, "kernel B' differs between two runs")
    check(rel4 <= 1e-5 and col4 < 1e-5,
          f"kernel B' Tx rel {rel4:.3e}, column sums {col4:.3e}")
    del p4, k2

    # 9. kernel G
    ga = (xp, K4, N_FFT, N, 1.0, Sfs, const, gamma, params, mode, False)
    Tg, Sg = stft_cuda.ssq_stft_fused(*ga)
    Tg2, Sg2 = stft_cuda.ssq_stft_fused(*ga)
    torch.cuda.synchronize()
    bitwise = torch.equal(Tg, Tg2) and torch.equal(Sg, Sg2)
    del Tg2, Sg2
    Sf = torch.complex(sr, si)
    sx_rel = float((Sg - Sf).abs().max() / Sf.abs().max())
    sx_equal = bool(torch.equal(Sg, Sf))
    relG, withinG, colG, _ = entry_metrics(torch, Tg, Tb)
    Tp, Sp = stft_cuda.ssq_stft_fused_plain(*ga)
    torch.cuda.synchronize()
    relP, withinP, colP, absG = entry_metrics(torch, Tg, Tp)
    sx_plain = float((Sg - Sp).abs().max() / Sp.abs().max())
    del Tp, Sp
    msG = cuda_ms(torch, lambda: stft_cuda.ssq_stft_fused(*ga))
    msG_plain = cuda_ms(torch, lambda: stft_cuda.ssq_stft_fused_plain(*ga))
    results["G"] = dict(sx_rel_F=sx_rel, sx_equal_F=sx_equal,
                        tx_within_vs_B4=withinG, tx_rel_vs_B4=relG,
                        colsum_vs_B4=colG, sx_rel_plain=sx_plain,
                        tx_within_vs_plain=withinP, colsum_vs_plain=colP,
                        tx_abs_vs_plain=absG, bitwise=bitwise, ms=msG,
                        plain_ms=msG_plain)
    print(f"[9] kernel G: Sx vs F rel={sx_rel:.3e} (bitwise {sx_equal}); Tx "
          f"vs B'(F) within 1e-5: {withinG:.6f} (rel {relG:.3e}, col "
          f"{colG:.3e}); vs plain G: Sx rel {sx_plain:.3e}, Tx within "
          f"{withinP:.6f}, col {colP:.3e}; bitwise-repeat={bitwise} | "
          f"{msG:.3f} ms vs plain {msG_plain:.3f} ms ({card})")
    check(bitwise, "kernel G differs between two runs")
    check(sx_rel < 2e-6 and sx_plain < 2e-6,
          f"kernel G Sx rel {sx_rel:.3e} / {sx_plain:.3e}")
    check(withinG >= 0.999 and colG < 1e-5,
          f"kernel G Tx vs B'(F): {withinG:.6f} within, col {colG:.3e}")
    check(withinP >= 0.999 and colP < 1e-5,
          f"kernel G Tx vs plain: {withinP:.6f} within, col {colP:.3e}")
    del Tg, Sg, Tb, k1, planes, sr, si, dr, di, Sf

    # 10. kernel H
    S = stft(x, n_fft=N_FFT)
    Fr, Fs = _irfft_mats_weighted(N_FFT, True, _win_bytes(win), 1, dev)
    ha = (S.real, S.imag, Fr, Fs, N_FFT)
    kH, pH = stft_cuda.istft_ola(*ha), stft_cuda.istft_ola_plain(*ha)
    torch.cuda.synchronize()
    relH = float((kH - pH).abs().max() / pH.abs().max())
    absH = float((kH - pH).abs().max())
    xr = istft(S, n_fft=N_FFT, N=N)
    madH = mad_rms(x, xr)
    msH = cuda_ms(torch, lambda: stft_cuda.istft_ola(*ha))
    msH_plain = cuda_ms(torch, lambda: stft_cuda.istft_ola_plain(*ha))
    results["H"] = dict(rel=relH, abs=absH, roundtrip_mad_rms=madH, ms=msH,
                        plain_ms=msH_plain)
    print(f"[10] kernel H: rel={relH:.3e}; istft(stft(x)) mad_rms "
          f"{madH:.3e} | {msH:.3f} ms vs plain {msH_plain:.3f} ms ({card})")
    check(relH < 2e-6, f"kernel H rel {relH:.3e}")
    check(madH < 1e-5, f"istft(stft(x)) mad_rms {madH:.3e}")
    del kH, pH, S, xr

    # 11. the STFT family end to end: three requests
    t = np.arange(N) / 1000.0
    requests = {
        "noise": (x, 1.0),
        "sine100": (torch.as_tensor(np.cos(2 * np.pi * 100 * t),
                                    dtype=torch.float32, device=dev), 1000.0),
        "chirp": (torch.as_tensor(np.cos(2 * np.pi * (5 * t + 1.5 * t * t)),
                                  dtype=torch.float32, device=dev), 1000.0),
    }
    counts = lambda: dict(stft_cuda.LAUNCHES,
                          reassign4=reassign_cuda.LAUNCHES4,
                          reassign=reassign_cuda.LAUNCHES)
    for key in stft_cuda.LAUNCHES:
        stft_cuda.LAUNCHES[key] = 0
    reassign_cuda.LAUNCHES4 = reassign_cuda.LAUNCHES = 0
    req_ms, peak = {}, None
    for name, (xq, fs) in requests.items():
        nf_fs = np.linspace(0, 0.5 * fs, nf, dtype=np.float32)
        calls = (
            ("stft", lambda: (stft(xq, n_fft=N_FFT, fs=fs),),
             dict(stft_dft=1)),
            ("ssq_stft", lambda: ssq_stft(xq, n_fft=N_FFT, fs=fs),
             dict(ssq_stft=1)),
            ("ssq_stft(ssq_freqs)", lambda: ssq_stft(
                xq, n_fft=N_FFT, fs=fs, ssq_freqs=nf_fs),
             dict(stft_dft=1, reassign4=1)),
        )
        for cname, call, expect in calls:
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            req_ms[f"{name} {cname}"] = (time.perf_counter() - t0) * 1e3
            moved = {k: v - before[k] for k, v in counts().items()
                     if v != before[k]}
            check(moved == expect, f"{name} {cname}: launches moved by "
                  f"{moved}, expected {expect}")
            check(out[0].is_cuda and tuple(out[0].shape) == (nf, N),
                  f"{name} {cname}: {out[0].device} {tuple(out[0].shape)}")
            check(bool(torch.isfinite(out[0]).all()),
                  f"{name} {cname}: output not finite")
            if cname == "ssq_stft" and name == "sine100":
                peak = float(out[2][int(out[0].abs().mean(-1).argmax())])
            if cname == "stft":
                Sq = out[0]
        before = counts()
        xr = istft(Sq, n_fft=N_FFT, N=N)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in counts().items()
                 if v != before[k]}
        check(moved == dict(istft_ola=1), f"{name} istft: launches moved "
              f"by {moved}")
        check(xr.is_cuda and tuple(xr.shape) == (N,) and
              bool(torch.isfinite(xr).all()), f"{name} istft output")
    launches = counts()
    check(launches == dict(stft_dft=6, ssq_stft=3, istft_ola=3, reassign4=3,
                           reassign=0), f"launch counts {launches}")

    Tx1 = ssq_stft(requests["sine100"][0], n_fft=N_FFT)[0]
    issq_mad = mad_rms(requests["sine100"][0],
                       issq_stft(Tx1, n_fft=N_FFT))
    del Tx1
    stft_ms, stft_all = host_ms(torch, lambda: stft(x, n_fft=N_FFT))
    ssq_ms, ssq_all = host_ms(torch, lambda: ssq_stft(x, n_fft=N_FFT))

    # the device results against the CPU (plain-torch) results
    xs = np.random.default_rng(1).standard_normal((2, N_SMALL))
    xs = xs.astype(np.float32)
    g = ssq_stft(torch.as_tensor(xs, device=dev), n_fft=N_FFT, fs=1000.0)
    c = ssq_stft(torch.as_tensor(xs), n_fft=N_FFT, fs=1000.0)
    sx_small = rel(torch, g[1].cpu(), c[1])
    col_small, tot_small = tx_metrics(np, g[0].cpu().numpy(), c[0].numpy())
    xg = istft(g[1], n_fft=N_FFT, N=N_SMALL).cpu()
    xc = istft(c[1], n_fft=N_FFT, N=N_SMALL)
    x_small = rel(torch, xg, xc)

    results["stft_e2e"] = dict(
        request_ms=req_ms, launches=launches, sine_peak_hz=peak,
        issq_mad_rms_fs1=issq_mad, stft_ms=stft_ms, stft_steady=stft_all,
        stft_msamples_s=N / stft_ms / 1e3, ssq_stft_ms=ssq_ms,
        ssq_stft_steady=ssq_all, ssq_stft_msamples_s=N / ssq_ms / 1e3,
        small_sx_rel=sx_small, small_col_rel=col_small,
        small_total_rel=tot_small, small_istft_rel=x_small)
    print(f"[11] STFT family N={N} n_fft={N_FFT}: launches {launches}; sine "
          f"ssq peak {peak:.3f} Hz; issq_stft mad_rms (fs=1) "
          f"{issq_mad:.3e}; steady stft {stft_ms:.2f} ms = "
          f"{N / stft_ms / 1e3:.2f} MSamples/s, ssq_stft {ssq_ms:.2f} ms = "
          f"{N / ssq_ms / 1e3:.2f} MSamples/s ({card}); GPU vs CPU at "
          f"N={N_SMALL}: Sx rel {sx_small:.2e}, Tx col rel {col_small:.2e}, "
          f"total rel {tot_small:.2e}, istft rel {x_small:.2e}")
    check(abs(peak - 100.0) <= 1.0, f"ssq_stft sine peak at {peak} Hz")
    check(issq_mad < 0.1, f"issq_stft mad_rms {issq_mad:.3e}")
    check(sx_small < 1e-5 and x_small < 1e-5,
          f"GPU vs CPU Sx rel {sx_small:.2e}, istft rel {x_small:.2e}")
    check(col_small < 1e-4 and tot_small < 1e-5,
          f"GPU vs CPU Tx: col {col_small:.2e}, total {tot_small:.2e}")

    src = "ssqueeze_rs_tpu_torch/csrc/"
    tpu = "ssqueeze_rs_tpu/ops/"
    return [
        {"name": "reassign4", "route": "cuda", "source": src + "reassign.cu",
         "replaces": tpu + "reassign_pallas.py:175",
         "launches": launches["reassign4"], "max_abs_err": abs4,
         "ms": ms4, "plain_ms": ms4_plain},
        {"name": "stft_dft", "route": "cuda", "source": src + "stft_dft.cu",
         "replaces": tpu + "stft_pallas.py:188",
         "launches": launches["stft_dft"], "max_abs_err": F[1200]["abs"],
         "ms": F[1200]["ms"], "plain_ms": F[1200]["plain_ms"]},
        {"name": "ssq_stft", "route": "cuda", "source": src + "ssq_stft.cu",
         "replaces": tpu + "stft_pallas.py:537",
         "launches": launches["ssq_stft"], "max_abs_err": absG,
         "ms": msG, "plain_ms": msG_plain},
        {"name": "istft_ola", "route": "cuda", "source": src + "istft_ola.cu",
         "replaces": tpu + "stft_pallas.py:338",
         "launches": launches["istft_ola"], "max_abs_err": absH,
         "ms": msH, "plain_ms": msH_plain},
    ]


def peak_gb(torch, fn):
    """(fn(), peak device memory during fn in GB, memory allocated before
    it in GB)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 1e9, base / 1e9


def grad_phases(np, torch, dev, card, results, cwt):
    """Phases 12-14: kernels C and C', the gradient of ssq_cwt, the STFT
    family's gradients. Returns C's and C''s entries of the JSON line."""
    from ssqueeze_rs_tpu_torch import ssq_cwt, stft, istft, ssq_stft
    from ssqueeze_rs_tpu_torch.ops import fft_cuda, reassign_cuda, stft_cuda
    from ssqueeze_rs_tpu_torch.ops.ssqueeze import plan_reassignment
    from ssqueeze_rs_tpu_torch.ops.stft import (_k_t, _win_bytes,
                                                _irfft_mats_weighted)
    from ssqueeze_rs_tpu_torch.utils.pad import padsignal
    from ssqueeze_rs_tpu_torch.utils.windows import get_window
    from ssqueeze_rs_tpu_torch.config import EPS32

    gamma = 10 * EPS32
    rng = np.random.default_rng(3)
    f32 = torch.float32
    x = cwt["requests"]["noise"][0]

    def seeded(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=f32,
                               device=dev)

    def lin_planes(xs, n_fft):
        planes = stft(xs, n_fft=n_fft, derivative=True, planar_out=True)
        nf = planes[0][0].shape[-2]
        Sfs = np.linspace(0, 0.5, nf, dtype=np.float32)
        const, mode, params = plan_reassignment(Sfs, nf, False,
                                                transform="stft")
        return (*planes[0], *planes[1], torch.as_tensor(const, dtype=f32,
                                                        device=dev),
                torch.as_tensor(Sfs, device=dev)), mode, params, nf

    # 12. kernels C and C' against the plain gather
    cases = {}
    cases["C"] = (reassign_cuda.reassign_bwd, reassign_cuda.reassign_bwd_plain,
                  lambda gr, gi: (cwt["w"], cwt["const"], gr, gi,
                                  cwt["params"], cwt["mode"], True,
                                  cwt["nf"]), cwt["nf"], x.shape[-1])
    for key, xs, n_fft in (("C' nf=300", x, N_FFT),
                           ("C' nf=1025", seeded(N_SMALL), 2048)):
        a4, mode4, params4, nf4 = lin_planes(xs, n_fft)
        cases[key] = (reassign_cuda.reassign4_bwd,
                      reassign_cuda.reassign4_bwd_plain,
                      lambda gr, gi, a4=a4, m=mode4, p=params4, n=nf4:
                      (*a4, gr, gi, gamma, p, m, False, n, "stft"),
                      nf4, xs.shape[-1])
    C, line = {}, []
    for key, (fn, plain, args, nfc, n) in cases.items():
        a = args(seeded((nfc, n)), seeded((nfc, n)))
        k1, k2, p = fn(*a), fn(*a), plain(*a)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(u, v) for u, v in zip(k1, k2))
        equal = all(torch.equal(u, v) for u, v in zip(k1, p))
        err = max(float((u - v).abs().max()) for u, v in zip(k1, p))
        C[key] = dict(equal=equal, max_abs_err=err, bitwise=bitwise, nf=nfc,
                      masked=float((p[0] == 0).float().mean()),
                      ms=cuda_ms(torch, lambda: fn(*a)),
                      plain_ms=cuda_ms(torch, lambda: plain(*a)))
        line.append(f"{key} equal={equal} (max abs {err:.2e}) "
                    f"bitwise-repeat={bitwise} | {C[key]['ms']:.3f} ms vs "
                    f"plain {C[key]['plain_ms']:.3f} ms")
        check(bitwise, f"kernel {key} differs between two runs")
        check(equal, f"kernel {key} differs from the plain gather "
              f"(max abs {err:.3e})")
        del a, k1, k2, p
    results["C"] = C
    print(f"[12] {'; '.join(line)} ({card})")

    # 13. the gradient of ssq_cwt at the headline width
    wavelet, scales = cwt["wavelet"], cwt["scales"]
    counts = lambda: dict(stft_cuda.LAUNCHES, cwt_phase=fft_cuda.LAUNCHES,
                          reassign=reassign_cuda.LAUNCHES,
                          reassign4=reassign_cuda.LAUNCHES4,
                          reassign_bwd=reassign_cuda.LAUNCHES_BWD,
                          reassign4_bwd=reassign_cuda.LAUNCHES4_BWD)

    def zero_counts():
        for key in stft_cuda.LAUNCHES:
            stft_cuda.LAUNCHES[key] = 0
        fft_cuda.LAUNCHES = reassign_cuda.LAUNCHES = 0
        reassign_cuda.LAUNCHES4 = reassign_cuda.LAUNCHES_BWD = 0
        reassign_cuda.LAUNCHES4_BWD = 0

    def moved_by(fn):
        before = counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v - before[k] for k, v in counts().items()
                     if v != before[k]}

    def sq(z):
        return (z.abs() ** 2).sum()

    def cwt_grad(x0, fs, nv=None, wx_only=False):
        xg = x0.detach().clone().requires_grad_()
        kw = dict(nv=nv) if nv else dict(scales=scales)
        Tx, Wx, *_ = ssq_cwt(xg, wavelet, fs=fs, **kw)
        (sq(Wx) if wx_only else sq(Tx) + sq(Wx)).backward()
        return xg.grad

    zero_counts()
    grads = {}
    for name, (xq, fs) in cwt["requests"].items():
        grads[name], moved = moved_by(lambda: cwt_grad(xq, fs))
        check(moved == dict(cwt_phase=1, reassign=1, reassign_bwd=1),
              f"ssq_cwt grad {name}: launches moved by {moved}")
        check(bool(torch.isfinite(grads[name]).all()),
              f"ssq_cwt grad {name}: not finite")
    launches_c = counts()["reassign_bwd"]
    repeat = torch.equal(cwt_grad(x, 1.0), grads["noise"])
    ms_cwt, all_cwt = host_ms(torch, lambda: cwt_grad(x, 1.0))
    _, peak, base = peak_gb(torch, lambda: cwt_grad(x, 1.0))
    xs = np.random.default_rng(1).standard_normal((2, N_SMALL))
    xs = xs.astype(np.float32)
    small = {}
    for wx_only in (False, True):
        g = cwt_grad(torch.as_tensor(xs, device=dev), 1000.0, 8, wx_only)
        c = cwt_grad(torch.as_tensor(xs), 1000.0, 8, wx_only)
        small["wx" if wx_only else "ssq"] = rel(torch, g.cpu(), c)
    results["grad_ssq_cwt"] = dict(launches_per_call=moved, bitwise=repeat,
                                   ms=ms_cwt, steady_ms=all_cwt,
                                   peak_gb=peak, base_gb=base,
                                   small_rel=small)
    print(f"[13] ssq_cwt grad N={N}: launches per call {moved}; "
          f"bitwise-repeat={repeat}; forward+backward {ms_cwt:.2f} ms, peak "
          f"{peak:.2f} GB (of which {base:.2f} GB held before) ({card}); "
          f"GPU vs CPU at N={N_SMALL}: rel {small['ssq']:.2e}, Wx-only "
          f"{small['wx']:.2e}")
    check(repeat, "ssq_cwt gradient differs between two runs")
    check(small["ssq"] < 5e-3 and small["wx"] < 1e-4,
          f"ssq_cwt gradient GPU vs CPU: {small}")

    # 14. the STFT family's gradients
    win, dwin = get_window(None, N_FFT, N_FFT, derivative=True,
                           dtype="float32")
    xp = padsignal(x, "reflect", padlength=N + N_FFT - 1)
    adj = {}
    for rows, K, fs in ((600, _k_t(_win_bytes(win), None, N_FFT, True, dev),
                         None),
                        (1200, _k_t(_win_bytes(win), _win_bytes(dwin), N_FFT,
                                    True, dev), 1.0)):
        g = seeded((rows, N))
        xk, xq = (xp.detach().clone().requires_grad_() for _ in range(2))
        gk, = torch.autograd.grad(stft_cuda.stft_dft(xk, K, N_FFT, N, fs=fs),
                                  xk, g)
        gq, = torch.autograd.grad(stft_cuda.stft_dft_plain(
            xq, K, N_FFT, N, fs=fs), xq, g)
        adj[f"F {rows} rows"] = rel(torch, gk, gq)
    S = stft(x, n_fft=N_FFT)
    Fr, Fs = _irfft_mats_weighted(N_FFT, True, _win_bytes(win), 1, dev)
    g = seeded((N + N_FFT - 1,))
    hk = [S.real.contiguous().requires_grad_(),
          S.imag.contiguous().requires_grad_()]
    hq = [t.detach().clone().requires_grad_() for t in hk]
    gk = torch.autograd.grad(stft_cuda.istft_ola(*hk, Fr, Fs, N_FFT), hk, g)
    gq = torch.autograd.grad(stft_cuda.istft_ola_plain(*hq, Fr, Fs, N_FFT),
                             hq, g)
    adj["H"] = max(rel(torch, a, b) for a, b in zip(gk, gq))
    del g, hk, hq, gk, gq, xk, xq
    for key, r in adj.items():
        check(r < 2e-6, f"{key} adjoint vs plain: rel {r:.3e}")

    nf = N_FFT // 2 + 1
    ssq_freqs = np.linspace(0, 0.5, nf, dtype=np.float32)

    def stft_grad(x0):
        xg = x0.detach().clone().requires_grad_()
        sq(stft(xg, n_fft=N_FFT)).backward()
        return xg.grad

    def istft_grad(S0):
        Sg = S0.detach().clone().requires_grad_()
        (istft(Sg, n_fft=N_FFT, N=S0.shape[-1]) ** 2).sum().backward()
        return torch.view_as_real(Sg.grad)

    def ssq_grad(x0, **kw):
        xg = x0.detach().clone().requires_grad_()
        Tx, Sx, *_ = ssq_stft(xg, n_fft=N_FFT, **kw)
        (sq(Tx) + sq(Sx)).backward()
        return xg.grad

    # inputs: (at N, two signals at N_SMALL on the GPU, the same on the CPU)
    sig = (x, torch.as_tensor(xs, device=dev), torch.as_tensor(xs))
    S_small = stft(sig[2], n_fft=N_FFT)
    spec = (S, S_small.to(dev), S_small)
    entries = {
        "stft": (stft_grad, sig, dict(stft_dft=1, istft_ola=1), 1e-4),
        "istft": (istft_grad, spec, dict(istft_ola=1, stft_dft=1), 1e-4),
        "ssq_stft": (ssq_grad, sig, dict(ssq_stft=1, stft_dft=1,
                                         reassign4_bwd=1, istft_ola=1), 5e-3),
        "ssq_stft(ssq_freqs)": (lambda x0: ssq_grad(x0, ssq_freqs=ssq_freqs),
                                sig, dict(stft_dft=1, reassign4=1,
                                          reassign4_bwd=1, istft_ola=1),
                                5e-3),
    }
    zero_counts()
    fam, line = {}, []
    for key, (fn, inputs, expect, bar) in entries.items():
        g1, moved = moved_by(lambda: fn(inputs[0]))
        check(moved == expect, f"{key} grad: launches moved by {moved}, "
              f"expected {expect}")
        check(bool(torch.isfinite(g1).all()), f"{key} grad: not finite")
        fam[key] = dict(launches=moved)
    launches_c4 = counts()["reassign4_bwd"]
    for key, (fn, inputs, expect, bar) in entries.items():
        g1 = fn(inputs[0])
        repeat = torch.equal(fn(inputs[0]), g1)
        del g1
        ms, steady = host_ms(torch, lambda: fn(inputs[0]))
        _, peak, base = peak_gb(torch, lambda: fn(inputs[0]))
        small_rel = rel(torch, fn(inputs[1]).cpu(), fn(inputs[2]))
        fam[key].update(bitwise=repeat, ms=ms, steady_ms=steady, peak_gb=peak,
                        base_gb=base, small_rel=small_rel)
        line.append(f"{key} {ms:.2f} ms peak {peak:.2f} GB repeat={repeat} "
                    f"GPU vs CPU {small_rel:.2e}")
        check(repeat, f"{key} gradient differs between two runs")
        check(small_rel < bar, f"{key} gradient GPU vs CPU rel "
              f"{small_rel:.2e} >= {bar}")
    results["grad_stft"] = dict(adjoint_rel=adj, entries=fam)
    print(f"[14] STFT family grads N={N} n_fft={N_FFT}: adjoints vs plain "
          + ", ".join(f"{k} {v:.2e}" for k, v in adj.items()) + "; "
          + "; ".join(line) + f"; launches "
          + ", ".join(f"{k} {v['launches']}" for k, v in fam.items())
          + f" ({card})")

    src = "ssqueeze_rs_tpu_torch/csrc/reassign_bwd.cu"
    tpu = "ssqueeze_rs_tpu/ops/reassign_pallas.py:485"
    return [
        {"name": "reassign_bwd", "route": "cuda", "source": src,
         "replaces": tpu, "launches": launches_c,
         "max_abs_err": C["C"]["max_abs_err"], "ms": C["C"]["ms"],
         "plain_ms": C["C"]["plain_ms"]},
        {"name": "reassign4_bwd", "route": "cuda", "source": src,
         "replaces": tpu, "launches": launches_c4,
         "max_abs_err": C["C' nf=300"]["max_abs_err"],
         "ms": C["C' nf=300"]["ms"], "plain_ms": C["C' nf=300"]["plain_ms"]},
    ]


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
