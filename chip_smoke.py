#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `ssqueeze_rs_tpu_torch.ssq_cwt` (and `issq_cwt`) at the headline
configuration: N = 160 000 float32 samples, default GMW, log-piecewise
scales cut to the first 300 (293 rows), maprange='peak', trig phase,
sum squeezing. Phases, one line each:

  1. the card (name and power limit from nvidia-smi); no CUDA -> exit 1
  2. build both kernels from csrc/ with nvcc, or load the library the
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
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
