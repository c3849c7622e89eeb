#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `ssqueeze_rs_tpu_torch.ssq_cwt` (and `issq_cwt`) at the headline
configuration: N = 160 000 float32 samples, default GMW, log-piecewise
scales cut to the first 300 (293 rows), maprange='peak', trig phase,
sum squeezing; then the STFT family (`stft`, `ssq_stft`, `istft`,
`issq_stft`) at the benchmark's STFT width: N = 160 000, n_fft = 598
(300 frequency rows), hop 1, the default window; then the CWT family
(`cwt`, `icwt`, the `ssq_cwt` routes through the dWx planes) at the
ssq_cwt widths; then kernel I and the serving and long-signal entry
points (the SSQ streamers, `TransformServer`, `process_recording`); then
the TPU probes' counterparts (`ssqueeze_rs_tpu_torch.tools`), the last
of them (J5-J8) apart; then the component-separation workflow
(`ssq_cwt` -> `extract_ridges` -> `issq_cwt`) and the reference-name
kernel layer (`algos`) at the same length.
Phases, one line each:

  1. the card (name and power limit from nvidia-smi); no CUDA -> exit 1
  2. build every kernel from csrc/ with nvcc, or load the library the
     sources' hash names (ptxas report copied to
     chiprun_out/chip_smoke_build.txt)
  3. kernel A (cwt_phase: kernel D's launch pair with the derivative and
     a phase store) against its plain-torch version at the headline shape;
     its Wx bitwise kernel D's with the derivative; bitwise repeat and
     bitwise against itself with its rows in chunks of 100; its scratch
     (rows a chunk within the 40 MB L2 budget); timed with CUDA events
     (median of 10 after 2 warm-ups), and at chunk budgets of 10, 20 MB,
     the constant and one chunk of every row
  4. kernel B (reassign) against its plain version on the same w plane:
     every Tx entry (so every bin) and the column sums, plus bitwise
     equality of two kernel runs and with the row walk B ran before (probe
     P4's full at 3 planes); timed the same way beside the row walk, the
     median and spread of five such medians, with its columns a block
  5. three requests through ssq_cwt (white noise, a 100 Hz sine at
     fs = 1000, a linear chirp): each kernel launched once per request,
     finite Tx, the sine's peak within 1 % of 100 Hz, issq_cwt of the
     sine, end-to-end time; then the device result against the CPU
     (plain-torch) result for a batch of two signals at N = 20 000
  6. kernels B and B' at nf = 1025 (STFT planes at n_fft = 2048,
     N = 20 000; 8 columns x 16 lanes a block) against their plain
     versions: every entry within 1e-5 max|Tx|, bitwise repeat, bitwise
     the row walk (P4's full at 3 and 4 planes), timed beside it
  7. kernel F (stft_dft, the Bluestein transform on the register-radix
     core) against plain F at the STFT width, derivative off (600 rows)
     and on (1200 rows): max|dS| / max|S| < 2e-6, bitwise repeat, both
     against the dense product in float64; timed beside torch.stft and its
     bound (the function's real FFTs and bytes); the same checks untimed at
     n_fft = 599 (a prime)
  8. kernel B' (reassign4, lin bins, nf = 300) on F's planes against plain
     B': every entry within 1e-5 max|Tx|, column sums within 1e-5,
     bitwise repeat and bitwise the row walk (P4's full); timed beside it
  9. kernel G (ssq_stft: F's chirp-z frame routine, the phase, the bins
     and an ordered squeeze in one kernel): a call without its DftSpec
     raises; Sx bitwise F's with two windows; Tx bitwise kernel B' on F's
     planes, and against plain G (>= 99.9 % of entries within 1e-5
     max|Tx|, column sums within 1e-5; Sx within 2e-6); bitwise repeat;
     timed against plain G and its bound; the same checks untimed at
     n_fft = 599 (prime), 256 and the largest n_fft G's plan admits
 10. kernel H (istft_ola: F's chirp-z transform run backwards on F's
     tables, then an overlap-add in a fixed order) against plain H at the
     STFT width (160 000 frames) and at n_fft = 599, 256 and 2048: within
     2e-6 of the largest sample, bitwise repeat, both against the same
     function in float64; timed at 598 beside plain, its bound and
     torch.istft, and at 2048 beside torch.istft; a call without its
     DftSpec raises; istft(stft(x)) with mad_rms < 1e-5
 11. three requests (noise, a 100 Hz sine at fs = 1000, a chirp) through
     stft (kernel F once), ssq_stft (G once), ssq_stft with given
     ssq_freqs (F and B' once each) and istft (H once); outputs finite on
     the GPU; the sine's ssq_stft peak within 1 % of 100 Hz; issq_stft of
     the sine at fs = 1; steady stft and ssq_stft times; the device time
     of stft, ssq_stft and istft by kernel (torch.profiler); the device
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
 14. the STFT family's gradients at N = 160 000, n_fft = 598: F's
     adjoint (kernel H, with one window and with two) and H's (kernel F),
     and ssq_stft's backward on an Sx cotangent (F, C', H on the first
     window's structure) against autograd of their plain versions
     (< 2e-6); stft (F forward, H backward), istft (H, then F), ssq_stft
     (G, then F, C', H) and ssq_stft with given ssq_freqs (F and B', then
     C' and H), each with its launch counts, finite and bitwise repeated,
     timed with its peak memory; device against CPU at N = 20 000
 15. kernels D (cwt_fused) and E (ifft_halfband) against their plain
     versions (each plane within 1e-5 of its largest value), bitwise
     repeat, timed beside their bound and torch.fft.ifft of the same
     (rows, M) spectrum: D at the cwt headline with the derivative off
     and on, D at M = 2^21 (N = 1 000 000, the first 64 scales, with the
     derivative), E on the complex-psih headline (bump, om = 0.5, 318 rows)
     at the kept window and at keep (0, M); D's and E's rows a chunk (their
     intermediate kept in L2) and their times at budgets of 10, 20 MB, the
     constant and one chunk of every row
 16. three requests through cwt (D once), cwt(derivative) (D once), the
     bump cwt (E once), ssq_cwt(get_dWx) and ssq_cwt(squeezing='lebesgue')
     (D and B' once each): outputs finite on the GPU, the sine's cwt ridge
     (Im(dWx/Wx)/2pi on the strongest row) and ssq_cwt peak within 1 % of
     100 Hz, icwt(cwt(x)) of the sine with mad_rms < 0.02; steady times;
     cwt's and the bump cwt's device time by kernel (torch.profiler) and
     idle share; device
     against CPU for two signals at N = 20 000
 17. the gradient of cwt at the headline, loss sum|Wx|^2 + sum|dWx|^2: D
     once per call, finite, bitwise repeat, forward+backward time and peak
     memory, device against CPU at N = 20 000 within 1e-4
 18. kernel I (reassign_mxu, the digit-split tensor-core scatter, reached
     through reassign4 under SSQ_TPU_REASSIGN_IMPL=mxu) against its plain
     version and against B' on D's ssq_cwt planes (293 x 160 000, nf =
     293) and on F's STFT planes at n_fft = 598 (nf = 300) and 2048 (nf =
     1025, N = 20 000), timed beside B' and its bound (B''s: the same
     function); then untimed at n_fft = 510 (nf = 256, 1 tile a pass),
     2046 (nf = 1024, 4 tiles) and on a batch of two at n_fft = 598:
     sum |d| / sum |ref| < 2e-5 and nonzero patterns equal on >= 99.99 %,
     bitwise repeat, the gradient through I bitwise the one through B'
 19. StreamingSSQSTFT(block=16384, n_fft=598) and StreamingSSQCWT(block=
     16384, plan_N=160000) on 160 000 samples of noise, a 100 Hz sine and a
     chirp at fs = 1000 in ragged chunks of 1000-20000, under the default
     scatter and under SSQ_TPU_REASSIGN_IMPL=mxu: per step one F or D and
     one B' (or one I, B' none); against offline ssq_stft (bin-flip bars)
     and ssq_cwt (Wx on rows whose tail mass beyond the halo is < 1e-6,
     interior columns, within 1e-5), the sine's peak within 5 %; each Tx
     under 'mxu' against the same stream's Tx under 'vpu' by phase 18's
     bar; ms per step and MSamples/s
 20. TransformServer('ssq_cwt') on requests of 3000, 10 000, 100 000 and
     160 000 samples (A and B once each, equal to the direct transform of
     the padded request), batch() of 16 x 10 000 (one launch each, equal
     to singles within 1e-6), TransformServer('ssq_stft', n_fft=598) (G
     once); process_recording(ssq_cwt) over 64 channels x 600 000 samples
     at 1 kHz in chunks of 250 000 (out='energy': tone rows, channel
     sub-batches consistent, MSamples/s, peak memory) and over 8 x 60 000
     in chunks of 20 000 (out='numpy', against offline ssq_cwt per channel)
 21. the TPU probes' entry points (ssqueeze_rs_tpu_torch.tools: the
     ablation of kernel D, probes P1-P3; the coarse split of D; the
     ablation of kernel B', P4; B' over batches of 4 and 8 in three grid
     modes), each main() run as a user would, K = 5, with the launch
     counts of P1-P4 read around them; then every variant against its
     plain twin at the headline: planes within 1e-5 of their largest
     value, the copy and zero variants exact, P1's full and P3 (D's earlier
     radix-2 design) bitwise equal and within 1e-5 of D's plain version per
     plane, P4's full (the row walk B' ran before) at 32, 16 and 8
     columns a block bitwise B' (reassign4 under 'vpu'), the three grid
     modes bitwise equal on a batch of 4, every kernel bitwise repeated;
     B' timed beside the row walk at the headline
 22. the last TPU probes' entry points (J5 mxu_rate_probe and its
     --chains, J6 mxu_probe and mxu_probe2, J7 dma_overlap_probe, J8
     grid_slope_probe), each main() run as a user would, K = 5, the launch
     counts read around each; then every kernel against its plain version
     at the probes' shapes: J8, the copy, J7 copies and J6's element
     questions exact; the dots (every shape and precision), the chains
     and J6's dots within RATE_BAR of max|out|; J7 dots and both within
     1e-3 of max|out| at R = 1, 1e-2 at 3, 0.1 at 64 (there finite and
     of order 1), bitwise with b a scaled permutation at R = 3 and 64
     (each product exact); every kernel bitwise repeated; the plain versions timed
     over the kernels' GRID copies (J6: every step's product); the
     library yardsticks (torch.matmul of the same total product in bf16,
     TF32 and float32, torch.bmm, .t().contiguous(), torch.add)
 23. examples/component_separation.py at N = 160 000: a TestSignals sine
     plus a linear chirp at the example's fractions of the band, ssq_cwt
     with ('gmw', beta 6) (A and B once), extract_ridges (penalty 2, two
     ridges, bw 25) and issq_cwt over bands of 20 rows around each ridge,
     each step timed; each component recovered within mad_rms 0.5, and
     at every column but the first and last 2 % one ridge within 5 % of
     the sine's frequency and the other of the chirp's; profiles of the
     three steps (the ridge at 2048 columns). The ridge on the card
     against the CPU (one thread) on Tx's first 16 384 columns: equal
     indices, us a column on each. `algos` on the headline planes (293 x
     160 000): indexed_sum_onfly (B once) and ssqueeze_fast (B' once)
     within 1e-5 max|Tx| of their plain versions and bitwise repeated,
     timed and profiled; indexed_sum bitwise over 5 calls and within 1e-6
     of a float64 sum; a float64 CUDA input raises. tkeo and
     tkeo_modified on the card against the CPU, 5e-6 relative

A line "[t]" gives the wall seconds of each part of the script. Any
failed check raises and exits non-zero. The last three lines are a
JSON object of the twenty-two kernels' numbers (each with its launches on its
paths, B's and B''s including phase 23's, its time, its plain version's, its bound from the bytes it must
move and the operations it must do at the card's published rates, and
the time of one PyTorch call computing the same function where there is
one), the card's name and power limit, and `{"ok": true, "device": ...}`.
Full results also go to chiprun_out/chip_smoke.json.
"""
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
N = 160_000
N_SMALL = 20_000    # M = 2^15 = 128 x 256: an unequal split
N_FFT = 598         # the benchmark's STFT width (bench.py): 300 rows
N_LARGE = 1_000_000  # M = 2^21, the largest M the JAX CWT kernels took


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


LAPS = {}                         # wall seconds by part of the script
_LAP_T = [time.perf_counter()]


def lap(name):
    """Record under `name` the wall seconds since the previous lap (the
    first counts from the script's start)."""
    now = time.perf_counter()
    LAPS[name] = now - _LAP_T[0]
    _LAP_T[0] = now


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


def where_off(torch, a, b, bar=1e-5):
    """Where a is off b by more than bar * max|b| (for a failure message):
    the count, and the spans of the offending indices per dimension."""
    off = ((a - b).abs() > bar * b.abs().max()).nonzero()
    if not len(off):
        return "nowhere"
    spans = ", ".join(f"dim {d}: {int(col.min())}..{int(col.max())}"
                      for d, col in enumerate(off.T))
    return f"{len(off)} entries ({spans})"


# The card's published rates (NVIDIA H100 SXM data sheet, at 700 W): the
# least time a kernel could take is the larger of its bytes (each input
# read once, each output written once) over the memory rate and its
# float32 operations over the CUDA cores' float32 peak.
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12


def tensor_bytes(*objs):
    """Bytes of every tensor among `objs` (nested tuples/lists walked)."""
    import torch
    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            total += tensor_bytes(*o)
    return total


def bound(nbytes, flops):
    """(bound_ms, bound_by) of a kernel that must move `nbytes` and do
    `flops` float32 operations."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fft_flops(rows, M):
    """Operations of `rows` complex inverse FFTs of length M, by the
    radix-2 count 5 M log2 M."""
    return 5.0 * rows * M * (M.bit_length() - 1)


def rfft_flops(count, n):
    """Operations of `count` real FFTs of length n (any n), by the count
    2.5 n log2 n: the work of the function, not of a dense product."""
    return 2.5 * count * n * math.log2(n)


# float32 operations per entry of the binning and scatter / gather kernels
# (bin from w: a log2 or a product and a rounding; w from four planes; the
# product and the two adds of the accumulation): far below their bytes
BIN_FLOPS = 8
BIN4_FLOPS = 16


def kernel_entry(name, source, replaces, launches, max_abs_err, ms,
                 plain_ms, bnd, library_ms, root="ssqueeze_rs_tpu/ops/"):
    return {"name": name, "route": "cuda",
            "source": "ssqueeze_rs_tpu_torch/csrc/" + source,
            "replaces": root + replaces,
            "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": library_ms}


def cpu_ref(torch, fn):
    """fn() on one CPU thread: the plain-torch references the device is
    held to. With the intra-op pool, about one process in ten had one
    worker compute its share of the GMW filterbank ~4e-5 of max|Wx| off
    (in that run only: a second call agreed with the device again to
    2e-6), which the device-vs-CPU bars of 1e-5 caught."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(n)


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


def device_breakdown(torch, fn, groups, calls=3, warm=False):
    """Where the device time of fn() goes: torch.profiler over `calls`
    steady calls (after one more, unless the caller has just made it:
    `warm`), the CUDA kernels' self time summed by
    the first of `groups` (name, substrings) whose substring is in the
    kernel's name ("other" for the rest), per call in ms, with the wall
    time per call and the device's idle share. None if the profiler sees
    no device time."""
    from torch.profiler import ProfilerActivity, profile
    if not warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    split = {name: 0.0 for name, _ in groups}
    split["other"] = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = next((name for name, subs in groups
                    if any(s in e.key for s in subs)), "other")
        split[key] += e.self_device_time_total / 1e3 / calls
    device = sum(split.values())
    if device == 0:
        return None
    return dict(wall_ms=wall, device_ms=device, split_ms=split,
                idle=1 - device / wall)


# kernel-name substrings of the profiled groups (first match wins)
# A runs D's launch pair under its own loader and store (cwt_planes.cu
# ALoad, PhaseStore): K_A goes before K_D where both are listed
K_A = ("A", ("ALoad", "PhaseStore"))
K_D = ("D", ("cwt_d_stage1", "cwt_d_stage2"))
K_B = ("B", ("reassign_kernel",))
K_C = ("C", ("reassign_bwd_kernel",))
K_FFT = ("cuFFT", ("fft",))
K_CPLX = ("torch.complex", ("complex_kernel",))
K_PAD = ("pad", ("index",))


def breakdown_line(prof):
    if prof is None:
        return "not measured"
    return (f"wall {prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} "
            "ms (" + ", ".join(f"{k} {v:.2f}" for k, v in
                               prof["split_ms"].items()) +
            f"), idle {prof['idle']:.1%}")


def tx_metrics(np, Tx, Tx_ref):
    """(mean per-column relative error of sum_k |Tx|, |d sum Tx| over
    sum |Tx|): the bin-flip-tolerant comparison of two Tx."""
    cs, cs_ref = np.abs(Tx).sum(-2), np.abs(Tx_ref).sum(-2)
    col = float(np.mean(np.abs(cs - cs_ref) / cs_ref))
    tot = float(abs(Tx.sum() - Tx_ref.sum()) / np.abs(Tx_ref).sum())
    return col, tot


def spread_ms(torch, fn, runs=5):
    """(median, least, most) of `runs` cuda_ms medians of fn(): single
    timings of B and B' at the headline move by ~20 % within one run."""
    ms = sorted(cuda_ms(torch, fn) for _ in range(runs))
    return ms[len(ms) // 2], ms[0], ms[-1]


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
    from ssqueeze_rs_tpu_torch.tools import ablate_reassign as ar

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
    lap("1-2 start, card, build")

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
    # A is D's launch pair with the derivative and a phase store: its Wx is
    # D's bit for bit
    kD = fft_cuda.cwt_fused(*args, keep=keep, derivative=True)
    kA2 = fft_cuda.cwt_phase(*args, keep=keep, gamma=gamma)
    torch.cuda.synchronize()
    wx_equal_D = bool(torch.equal(kA[0], kD[0]) and torch.equal(kA[1], kD[1]))
    bitwise = all(torch.equal(a, b) for a, b in zip(kA, kA2))
    del kD, kA2
    # rows through the intermediate in chunks (here 100, 100, 93) give
    # the same bits as the L2 budget's chunks: each row's work does not
    # depend on them
    budget, M = fft_cuda._D_Y_BYTES, xp.shape[-1]
    rowsA = int(args[0].shape[0])
    chunk_rows = fft_cuda.d_chunk_rows(M, 2, rowsA)
    scratch_mb = 2 * chunk_rows * M * 8 / 2 ** 20
    fft_cuda._D_Y_BYTES = 100 * 2 * M * 8
    try:
        kA_chunked = fft_cuda.cwt_phase(*args, keep=keep, gamma=gamma)
    finally:
        fft_cuda._D_Y_BYTES = budget
    chunks_equal = all(torch.equal(a, b) for a, b in zip(kA, kA_chunked))
    msA = cuda_ms(torch, lambda: fft_cuda.cwt_phase(*args, keep=keep,
                                                    gamma=gamma))
    msA_plain = cuda_ms(torch, lambda: fft_cuda.cwt_phase_plain(
        *args, keep=keep, gamma=gamma))
    # the budget of A's row chunks (its intermediate kept in L2), as D's in
    # phase 15: the constant against 10 and 20 MB and one chunk of every row
    sweepA = {}
    try:
        for mb in (10, 20, budget >> 20, 1 << 20):
            fft_cuda._D_Y_BYTES = mb << 20
            sweepA[f"{mb} MB, {fft_cuda.d_chunk_rows(M, 2, rowsA)} rows"] = \
                cuda_ms(torch, lambda: fft_cuda.cwt_phase(
                    *args, keep=keep, gamma=gamma))
    finally:
        fft_cuda._D_Y_BYTES = budget
    boundA = bound(tensor_bytes(args, kA), 2 * fft_flops(len(sc), M))
    # A's and D's device time by launch (one loader, one store each)
    launchesA = device_breakdown(torch, lambda: fft_cuda.cwt_phase(
        *args, keep=keep, gamma=gamma), (("A launch 1", ("ALoad",)),
                                         ("A launch 2", ("PhaseStore",))))
    launchesD = device_breakdown(torch, lambda: fft_cuda.cwt_fused(
        *args, keep=keep, derivative=True), (("D launch 1", ("DLoad",)),
                                             ("D launch 2", ("PlanesStore",))))
    results["A"] = dict(wx_rel=errA, wx_abs=absA, w_rel_max=w_err,
                        w_within_1e4=w_ok, mask_agree=mask_agree,
                        wx_equal_D=wx_equal_D, bitwise=bitwise,
                        chunks_equal=chunks_equal, chunk_rows=chunk_rows,
                        scratch_mb=scratch_mb, budget_sweep_ms=sweepA,
                        by_launch=launchesA, d_by_launch=launchesD, ms=msA,
                        plain_ms=msA_plain, rows=rowsA, bound_ms=boundA[0],
                        bound_by=boundA[1])
    print(f"[3] kernel A: rows={rowsA} M={M} "
          f"Wx rel={errA:.3e} w within 1e-4: {w_ok:.6f} (max rel "
          f"{w_err:.3e}) mask agree={mask_agree:.6f} Wx == D's="
          f"{wx_equal_D} bitwise-repeat={bitwise} chunked-equal="
          f"{chunks_equal} | {msA:.3f} ms vs "
          f"plain {msA_plain:.3f} ms, bound {boundA[0]:.3f} ms "
          f"({boundA[1]}); {chunk_rows} rows a chunk, scratch "
          f"{scratch_mb:.1f} MB; budgets " + ", ".join(
              f"{b}: {t:.3f} ms" for b, t in sweepA.items()) + "; by launch: A "
          f"{breakdown_line(launchesA)}, D (derivative) "
          f"{breakdown_line(launchesD)} ({card})")
    check(errA < 1e-5, f"kernel A Wx rel error {errA:.3e} >= 1e-5")
    check(w_ok >= 0.999, f"kernel A w: only {w_ok:.6f} within 1e-4")
    check(mask_agree >= 0.999, f"kernel A mask agreement {mask_agree}")
    check(wx_equal_D, "kernel A's Wx differs from kernel D's")
    check(bitwise, "kernel A differs between two runs")
    check(chunks_equal, "kernel A differs when its rows go in chunks")
    check(scratch_mb <= 40, f"kernel A scratch {scratch_mb:.1f} MB > 40")

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
    # the design B had before (the row walk: P4's full at 3 planes) gives
    # the same bits
    kW = ar.ablate_reassign3(*bargs)
    walk_equal = all(torch.equal(a, b) for a, b in zip(kB, kW))
    del kW
    msB, *spreadB = spread_ms(torch, lambda: reassign_cuda.reassign(*bargs))
    msB_walk, *spreadW = spread_ms(torch,
                                   lambda: ar.ablate_reassign3(*bargs))
    msB_plain = cuda_ms(torch, lambda: reassign_cuda.reassign_plain(*bargs))
    colsB = reassign_cuda._block_cols(nf)
    boundB = bound(tensor_bytes(bargs, kB), BIN_FLOPS * kA[0].numel())
    results["B"] = dict(colsum_rel=errB, tx_abs=absB, tx_rel=relB,
                        equal_frac=same, walk_equal=walk_equal,
                        bitwise=bitwise, ms=msB, ms_spread=spreadB,
                        walk_ms=msB_walk, walk_ms_spread=spreadW,
                        plain_ms=msB_plain, nf=nf, cols=colsB, mode=mode,
                        bound_ms=boundB[0], bound_by=boundB[1])
    print(f"[4] kernel B: nf={nf} mode={mode} Tx rel={relB:.3e} column-sum "
          f"rel={errB:.3e} Tx equal={same:.6f} bitwise-repeat={bitwise} "
          f"== row walk (P4 full, 3 planes) {walk_equal} | {colsB}x16 "
          f"{msB:.3f} ms ({spreadB[0]:.3f}-{spreadB[1]:.3f}) vs row walk "
          f"{msB_walk:.3f} ms ({spreadW[0]:.3f}-{spreadW[1]:.3f}), plain "
          f"{msB_plain:.3f} ms, bound {boundB[0]:.3f} ms ({card})")
    check(bitwise, "kernel B differs between two runs")
    check(walk_equal, "kernel B differs from the row walk (P4 full)")
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
    prof5 = device_breakdown(torch, lambda: ssq_cwt(
        x_noise, wavelet, scales=scales, fs=1.0),
        (K_A, K_B, K_FFT, K_CPLX, K_PAD))

    # the device result against the CPU plain-torch result, small batch
    xs = np.random.default_rng(1).standard_normal((2, N_SMALL))
    xs = xs.astype(np.float32)
    g = ssq_cwt(torch.as_tensor(xs, device=dev), wavelet, fs=1000.0, nv=8)
    c = cpu_ref(torch, lambda: ssq_cwt(torch.as_tensor(xs), wavelet,
                                       fs=1000.0, nv=8))
    wx_small = rel(torch, g[1].cpu(), c[1])
    col_small, tot_small = tx_metrics(np, g[0].cpu().numpy(), c[0].numpy())

    results["e2e"] = dict(request_ms=req_ms, steady_ms=steady, ms=e2e_ms,
                          msamples_s=N / e2e_ms / 1e3, sine_peak_hz=f_peak,
                          issq_mad_rms=mad_rms, launches=launches,
                          profile=prof5,
                          small_wx_rel=wx_small, small_col_rel=col_small,
                          small_total_rel=tot_small)
    print(f"[5] ssq_cwt N={N}: requests {', '.join(f'{k} {v:.1f} ms' for k, v in req_ms.items())}; "
          f"steady {e2e_ms:.2f} ms = {N / e2e_ms / 1e3:.2f} MSamples/s ({card}); "
          f"launches {launches}; sine peak {f_peak:.3f} Hz; issq mad_rms "
          f"{mad_rms:.3e}; profile: {breakdown_line(prof5)}; GPU vs CPU at "
          f"N={N_SMALL}: Wx rel {wx_small:.2e}, "
          f"col rel {col_small:.2e}, total rel {tot_small:.2e}")
    check(abs(f_peak - 100.0) <= 1.0, f"sine peak at {f_peak} Hz, not 100")
    check(launches == {"cwt_phase": 3, "reassign": 3},
          f"launch counts {launches}")
    if wx_small >= 1e-5:
        # before failing: where, and whether each side repeats itself
        g2 = ssq_cwt(torch.as_tensor(xs, device=dev), wavelet, fs=1000.0,
                     nv=8)
        c2 = cpu_ref(torch, lambda: ssq_cwt(torch.as_tensor(xs), wavelet,
                                            fs=1000.0, nv=8))
        check(False, f"GPU vs CPU Wx rel {wx_small:.2e}, off at "
              f"{where_off(torch, g[1].cpu(), c[1])}; GPU again vs CPU "
              f"{rel(torch, g2[1].cpu(), c[1]):.2e}, GPU again vs GPU "
              f"{rel(torch, g2[1], g[1]):.2e}, CPU again vs CPU "
              f"{rel(torch, c2[1], c[1]):.2e}")
    check(col_small < 1e-4 and tot_small < 1e-5,
          f"GPU vs CPU Tx: col {col_small:.2e}, total {tot_small:.2e}")

    del kA_chunked, pB, Tk, Tp, kB2
    lap("3-5 A, B, ssq_cwt")
    stft_kernels = stft_phases(np, torch, dev, card, results)
    lap("6-11 STFT family")
    ctx = dict(requests=requests, wavelet=wavelet, scales=scales, w=kA[2],
               const=const, params=params, mode=mode, nf=nf)
    grad_kernels = grad_phases(np, torch, dev, card, results, ctx)
    lap("12-14 gradients")
    del kA, kB, args, bargs
    cwt_kernels = cwt_family_phases(np, torch, dev, card, results, ctx)
    lap("15-17 CWT family")
    serving_kernels = serving_phases(np, torch, dev, card, results, ctx)
    probe_kernels = probe_phases(np, torch, dev, card, results)
    rate_kernels = rate_probe_phases(np, torch, dev, card, results)
    sep_launches = component_phases(np, torch, dev, card, results, ctx)
    lap("23 component separation")

    results["phase_s"] = LAPS
    print("[t] wall seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in LAPS.items()) +
        f"; total {sum(LAPS.values()):.1f}")
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    kernels = [
        # A's and B's yardstick: no one PyTorch call forms Wx and the
        # phase from the filterbank, or bins and scatters
        kernel_entry("cwt_phase", "cwt_planes.cu", "fft_pallas.py:646",
                     launches["cwt_phase"], absA, msA, msA_plain, boundA,
                     None),
        kernel_entry("reassign", "reassign.cu", "reassign_pallas.py:175",
                     launches["reassign"], absB, msB, msB_plain, boundB,
                     None),
    ] + (stft_kernels + grad_kernels + cwt_kernels + serving_kernels +
         probe_kernels + rate_kernels)
    # B and B' also ran on phase 23's paths
    for entry in kernels:
        entry["launches"] += sep_launches.get(entry["name"], 0)
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
    from ssqueeze_rs_tpu_torch.ops.stft import (_k_t, _win_bytes, _dft_spec,
                                                _irfft_mats_weighted,
                                                _irfft_spec)
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

    # 6. kernels B and B' at nf = 1025 against their plain versions and
    # bitwise the row walk (P4's full at 3 and 4 planes)
    from ssqueeze_rs_tpu_torch.tools import ablate_reassign as ar
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
    for name, fn, plain, walk, args in (
            ("B", reassign_cuda.reassign, reassign_cuda.reassign_plain,
             ar.ablate_reassign3, a3),
            ("B'", reassign_cuda.reassign4, reassign_cuda.reassign4_plain,
             ar.ablate_reassign, a4)):
        k1, k2, p = fn(*args), fn(*args), plain(*args)
        kw = walk(*args)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(k1, k2))
        walk_equal = all(torch.equal(a, b) for a, b in zip(k1, kw))
        r6, _, col, _ = entry_metrics(torch, torch.complex(*k1),
                                      torch.complex(*p))
        ms6 = cuda_ms(torch, lambda: fn(*args))
        ms6_walk = cuda_ms(torch, lambda: walk(*args))
        res = dict(tx_rel=r6, colsum_rel=col, bitwise=bitwise,
                   walk_equal=walk_equal, ms=ms6, walk_ms=ms6_walk)
        results[f"nf1025_{name}"] = res
        line.append(f"{name} Tx rel={r6:.3e} col rel={col:.3e} "
                    f"bitwise-repeat={bitwise} == row walk {walk_equal} | "
                    f"{ms6:.3f} ms vs row walk {ms6_walk:.3f} ms")
        check(bitwise, f"kernel {name} at nf={nf6} differs between two runs")
        check(walk_equal, f"kernel {name} at nf={nf6} differs from the row "
              "walk (P4 full)")
        check(r6 <= 1e-5, f"kernel {name} at nf={nf6}: Tx rel {r6:.3e}")
        del k1, k2, p, kw
    cols = reassign_cuda._block_cols(nf6)
    print(f"[6] nf={nf6} ({cols} columns x 16 lanes a block): "
          f"{'; '.join(line)} ({card})")
    check(nf6 == 1025 and cols == 8, f"nf={nf6}, {cols} columns")
    del sr, si, dr, di, w6, a3, a4

    # 7. kernel F against plain F at the STFT width, both against the
    # dense product in float64; n_fft = 599 (599 is prime) checked too
    x = torch.as_tensor(rng.standard_normal(N), dtype=torch.float32,
                        device=dev)
    win, dwin = get_window(None, N_FFT, N_FFT, derivative=True,
                           dtype="float32")
    xp = padsignal(x, "reflect", padlength=N + N_FFT - 1)
    F = {}
    for n_fft, dw, fs in ((N_FFT, None, None), (N_FFT, dwin, 1.0),
                          (599, None, None), (599, dwin, 1.0)):
        w_n, dw_n = get_window(None, n_fft, n_fft, derivative=True,
                               dtype="float32")
        wins = (_win_bytes(w_n), _win_bytes(dw_n) if dw is not None else None,
                n_fft, True)
        K, spec = _k_t(*wins, dev), _dft_spec(*wins)
        rows = K.shape[0]
        xf = xp if n_fft == N_FFT else padsignal(x, "reflect",
                                                  padlength=N + n_fft - 1)
        run = lambda: stft_cuda.stft_dft(xf, K, n_fft, N, fs=fs, spec=spec)
        plain = lambda: stft_cuda.stft_dft_plain(xf, K, n_fft, N, fs=fs)
        kF, kF2, pF = run(), run(), plain()
        K64 = torch.as_tensor(spec.dense(np.float64), device=dev)
        rF = stft_cuda.stft_dft_plain(xf.double(), K64, n_fft, N, fs=fs)
        torch.cuda.synchronize()
        top = float(rF.abs().max())
        key = f"{rows} rows" + ("" if n_fft == N_FFT else f" n_fft={n_fft}")
        F[key] = dict(
            rel=float((kF - pF).abs().max() / pF.abs().max()),
            abs=float((kF - pF).abs().max()),
            rel64=float((kF.double() - rF).abs().max()) / top,
            plain_rel64=float((pF.double() - rF).abs().max()) / top,
            bitwise=bool(torch.equal(kF, kF2)), n_fft=n_fft, rows=rows,
            Q=stft_cuda.bluestein_tables(spec)[0])
        del kF2, pF, rF, K64
        if n_fft == N_FFT:
            # the function's work: W real FFTs a frame; its bytes: the
            # signal, the kernel's tables, the planes
            W = len(spec.windows)
            F[key].update(
                ms=cuda_ms(torch, run), plain_ms=cuda_ms(torch, plain),
                bound=bound(tensor_bytes(xf, stft_cuda._tables_on(spec, dev),
                                         kF), rfft_flops(W * N, n_fft)))
            if dw is not None:
                planes = kF
        del kF
    # the yardstick: torch.stft over the same padded signal and window
    # (hop 1, no centring; it does not fftshift the frames, the port's
    # modulated STFT does)
    win_t = torch.as_tensor(win, device=dev)
    F["600 rows"]["library_ms"] = cuda_ms(torch, lambda: torch.stft(
        xp, N_FFT, hop_length=1, win_length=N_FFT, window=win_t,
        center=False, return_complex=True))
    results["F"] = F
    print("[7] kernel F (Bluestein): " + "; ".join(
        f"{k}: rel={v['rel']:.3e}, vs float64 {v['rel64']:.3e} (plain "
        f"{v['plain_rel64']:.3e}), bitwise-repeat={v['bitwise']}" +
        (f" | {v['ms']:.3f} ms vs plain {v['plain_ms']:.3f} ms, bound "
         f"{v['bound'][0]:.3f} ms ({v['bound'][1]})" if "ms" in v else "")
        for k, v in F.items()) +
        f"; torch.stft (600 rows) {F['600 rows']['library_ms']:.3f} ms "
        f"({card})")
    for k, v in F.items():
        check(v["bitwise"], f"kernel F ({k}) differs between two runs")
        check(v["rel"] < 2e-6, f"kernel F ({k}) rel {v['rel']:.3e}")

    # 8. kernel B' on F's planes (lin bins, nf = 300)
    nf = N_FFT // 2 + 1
    Sfs, const, mode, params = lin_plan(nf, 1.0)
    sr, si, dr, di = planes.split(nf, dim=-2)
    a4 = (sr, si, dr, di, const, Sfs, gamma, params, mode, False, nf, "stft")
    k1, k2 = reassign_cuda.reassign4(*a4), reassign_cuda.reassign4(*a4)
    p4 = reassign_cuda.reassign4_plain(*a4)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(k1, k2))
    walk_equal = all(torch.equal(a, b) for a, b in
                     zip(k1, ar.ablate_reassign(*a4)))
    Tb = torch.complex(*k1)
    rel4, _, col4, abs4 = entry_metrics(torch, Tb, torch.complex(*p4))
    ms4, *spread4 = spread_ms(torch,
                              lambda: reassign_cuda.reassign4(*a4))
    ms4_walk, *spread4w = spread_ms(torch, lambda: ar.ablate_reassign(*a4))
    ms4_plain = cuda_ms(torch, lambda: reassign_cuda.reassign4_plain(*a4))
    bound4 = bound(tensor_bytes(a4, k1), BIN4_FLOPS * sr.numel())
    cols4 = reassign_cuda._block_cols(nf)
    results["B4"] = dict(tx_rel=rel4, colsum_rel=col4, tx_abs=abs4,
                         bitwise=bitwise, walk_equal=walk_equal, ms=ms4,
                         ms_spread=spread4, walk_ms=ms4_walk,
                         walk_ms_spread=spread4w, plain_ms=ms4_plain, nf=nf,
                         cols=cols4, bound=bound4)
    print(f"[8] kernel B': nf={nf} mode={mode} Tx rel={rel4:.3e} column-sum "
          f"rel={col4:.3e} bitwise-repeat={bitwise} == row walk "
          f"{walk_equal} | {cols4}x16 {ms4:.3f} ms ({spread4[0]:.3f}-"
          f"{spread4[1]:.3f}) vs row walk {ms4_walk:.3f} ms "
          f"({spread4w[0]:.3f}-{spread4w[1]:.3f}), plain {ms4_plain:.3f} ms "
          f"({card})")
    check(bitwise, "kernel B' differs between two runs")
    check(walk_equal, "kernel B' differs from the row walk (P4 full)")
    check(rel4 <= 1e-5 and col4 < 1e-5,
          f"kernel B' Tx rel {rel4:.3e}, column sums {col4:.3e}")
    del p4, k2

    # 9. kernel G (F's chirp-z frame routine, then the phase, the bins and
    # an ordered squeeze in the same block): Sx bitwise F's with two
    # windows, Tx bitwise B' on F's planes, both against plain G
    wins4 = (_win_bytes(win), _win_bytes(dwin), N_FFT, True)
    K4, spec4 = _k_t(*wins4, dev), _dft_spec(*wins4)
    ga = (xp, K4, N_FFT, N, 1.0, Sfs, const, gamma, params, mode, False)
    try:
        stft_cuda.ssq_stft_fused(*ga)
        raised = False
    except ValueError as e:
        raised = "DftSpec" in str(e)
    check(raised, "kernel G ran on CUDA without its DftSpec")
    run = lambda: stft_cuda.ssq_stft_fused(*ga, spec=spec4)
    Tg, Sg = run()
    Tg2, Sg2 = run()
    torch.cuda.synchronize()
    bitwise = torch.equal(Tg, Tg2) and torch.equal(Sg, Sg2)
    del Tg2, Sg2
    Sf = torch.complex(sr, si)
    sx_rel = float((Sg - Sf).abs().max() / Sf.abs().max())
    sx_equal = bool(torch.equal(Sg, Sf))
    tx_equal = bool(torch.equal(Tg, Tb))
    relG, withinG, colG, _ = entry_metrics(torch, Tg, Tb)
    Tp, Sp = stft_cuda.ssq_stft_fused_plain(*ga)
    torch.cuda.synchronize()
    relP, withinP, colP, absG = entry_metrics(torch, Tg, Tp)
    sx_plain = float((Sg - Sp).abs().max() / Sp.abs().max())
    del Tp, Sp
    msG = cuda_ms(torch, run)
    msG_plain = cuda_ms(torch, lambda: stft_cuda.ssq_stft_fused_plain(*ga))
    # G's bytes: the signal, F's tables, Sfs and const in; Tx, Sx out
    boundG = bound(tensor_bytes(xp, stft_cuda._tables_on(spec4, dev), Sfs,
                                const, Tg, Sg),
                   rfft_flops(2 * N, N_FFT) + BIN4_FLOPS * sr.numel())
    plan = stft_cuda._ssq_plan(N_FFT)
    results["G"] = dict(sx_rel_F=sx_rel, sx_equal_F=sx_equal,
                        tx_equal_B4=tx_equal, tx_within_vs_B4=withinG,
                        tx_rel_vs_B4=relG, colsum_vs_B4=colG,
                        sx_rel_plain=sx_plain, tx_within_vs_plain=withinP,
                        colsum_vs_plain=colP, tx_abs_vs_plain=absG,
                        bitwise=bitwise, ms=msG, plain_ms=msG_plain,
                        bound=boundG, plan=list(plan), no_spec_raises=raised)
    print(f"[9] kernel G (n_fft={N_FFT}, {plan[0]} frames a block): Sx == "
          f"F's {sx_equal} (rel {sx_rel:.3e}); Tx == B'(F) {tx_equal} "
          f"(within 1e-5: {withinG:.6f}, col {colG:.3e}); vs plain G: Sx rel "
          f"{sx_plain:.3e}, Tx within {withinP:.6f}, col {colP:.3e}; "
          f"bitwise-repeat={bitwise}; no spec raises | {msG:.3f} ms vs plain "
          f"{msG_plain:.3f} ms, bound {boundG[0]:.3f} ms ({boundG[1]}) "
          f"({card})")
    check(bitwise, "kernel G differs between two runs")
    check(sx_equal, f"kernel G Sx differs from F's (rel {sx_rel:.3e})")
    check(tx_equal, f"kernel G Tx differs from B' on F's planes (within "
          f"{withinG:.6f}, col {colG:.3e})")
    check(sx_plain < 2e-6, f"kernel G Sx rel {sx_plain:.3e} to plain")
    check(withinP >= 0.999 and colP < 1e-5,
          f"kernel G Tx vs plain: {withinP:.6f} within, col {colP:.3e}")
    del Tg, Sg, Tb, k1, planes, sr, si, dr, di, Sf
    # the same checks untimed at a prime n_fft, at 256 (Q = 512) and at
    # the largest n_fft G's plan admits
    n_top = max(n for n in range(2048, 4097)
                if stft_cuda.ssq_stft_fused_ok(n))
    G_more = {}
    for n_fft in (599, 256, n_top):
        w_n, dw_n = get_window(None, n_fft, n_fft, derivative=True,
                               dtype="float32")
        wins = (_win_bytes(w_n), _win_bytes(dw_n), n_fft, True)
        Kn, specn = _k_t(*wins, dev), _dft_spec(*wins)
        xn = padsignal(x, "reflect", padlength=N + n_fft - 1)
        nfn = n_fft // 2 + 1
        Sfn, cn, mn, pn = lin_plan(nfn, 1.0)
        gan = (xn, Kn, n_fft, N, 1.0, Sfn, cn, gamma, pn, mn, False)
        Fn = stft_cuda.stft_dft(xn, Kn, n_fft, N, fs=1.0, spec=specn)
        Bn = torch.complex(*reassign_cuda.reassign4(
            *Fn.split(nfn, dim=-2), cn, Sfn, gamma, pn, mn, False, nfn,
            "stft"))
        Tn, Sn = stft_cuda.ssq_stft_fused(*gan, spec=specn)
        Tn2, Sn2 = stft_cuda.ssq_stft_fused(*gan, spec=specn)
        torch.cuda.synchronize()
        rep = torch.equal(Tn, Tn2) and torch.equal(Sn, Sn2)
        del Tn2, Sn2
        sx_eq = bool(torch.equal(Sn, torch.complex(*Fn[:2 * nfn].split(
            nfn, dim=-2))))
        tx_eq = bool(torch.equal(Tn, Bn))
        del Fn, Bn
        Tq, Sq_ = stft_cuda.ssq_stft_fused_plain(*gan)
        torch.cuda.synchronize()
        _, within_n, col_n, _ = entry_metrics(torch, Tn, Tq)
        sx_n = float((Sn - Sq_).abs().max() / Sq_.abs().max())
        del Tq, Sq_, Tn, Sn, Kn, xn
        G_more[n_fft] = dict(plan=list(stft_cuda._ssq_plan(n_fft)),
                             sx_equal_F=sx_eq, tx_equal_B4=tx_eq,
                             bitwise=rep, sx_rel_plain=sx_n,
                             tx_within_vs_plain=within_n,
                             colsum_vs_plain=col_n)
    results["G"]["more"] = G_more
    print("[9] kernel G untimed: " + "; ".join(
        f"n_fft={n} ({v['plan'][0]} frames a block): Sx == F's "
        f"{v['sx_equal_F']}, Tx == B'(F) {v['tx_equal_B4']}, bitwise-repeat="
        f"{v['bitwise']}, vs plain Sx rel {v['sx_rel_plain']:.3e}, Tx within "
        f"{v['tx_within_vs_plain']:.6f}, col {v['colsum_vs_plain']:.3e}"
        for n, v in G_more.items()))
    for n, v in G_more.items():
        check(v["bitwise"] and v["sx_equal_F"] and v["tx_equal_B4"],
              f"kernel G at n_fft={n}: {v}")
        check(v["sx_rel_plain"] < 2e-6 and v["tx_within_vs_plain"] >= 0.999
              and v["colsum_vs_plain"] < 1e-5, f"kernel G at n_fft={n}: {v}")

    # 10. kernel H (F's chirp-z transform run backwards on istft's
    # structure) against plain H at the STFT width, both against the same
    # function in float64; n_fft = 599 (a prime), 256 and 2048 checked the
    # same way; timed at the STFT width and at 2048 beside torch.istft
    H = {}
    for n_fft in (N_FFT, 599, 256, 2048):
        w_n = get_window(None, n_fft, n_fft, dtype="float32")
        S = stft(x, n_fft=n_fft)
        mats = (n_fft, True, _win_bytes(w_n), 1)
        Fr, Fs = _irfft_mats_weighted(*mats, dev)
        hspec = _irfft_spec(*mats)
        ha = (S.real, S.imag, Fr, Fs, n_fft)
        run = lambda: stft_cuda.istft_ola(*ha, adjoint=hspec)
        plain = lambda: stft_cuda.istft_ola_plain(*ha)
        kH, kH2, pH = run(), run(), plain()
        K64 = hspec.dense(np.float64)
        nfn = hspec.nf
        rH = stft_cuda.istft_ola_plain(
            S.real.double(), S.imag.double(),
            torch.as_tensor(K64[:nfn].T, device=dev),
            -torch.as_tensor(K64[nfn:].T, device=dev), n_fft)
        torch.cuda.synchronize()
        top = float(rH.abs().max())
        H[n_fft] = dict(
            rel=float((kH - pH).abs().max() / pH.abs().max()),
            abs=float((kH - pH).abs().max()),
            rel64=float((kH.double() - rH).abs().max()) / top,
            plain_rel64=float((pH.double() - rH).abs().max()) / top,
            bitwise=bool(torch.equal(kH, kH2)),
            Q=stft_cuda.bluestein_tables(hspec)[0])
        del kH2, pH, rH, K64
        if n_fft in (N_FFT, 2048):
            wt = torch.as_tensor(w_n, device=dev)
            # the yardstick: torch.istft of the same spectrum at hop 1
            # (centred, so the window envelope it checks has no near-zero
            # edge)
            H[n_fft].update(ms=cuda_ms(torch, run), library_ms=cuda_ms(
                torch, lambda: torch.istft(
                    S, n_fft, hop_length=1, win_length=n_fft, window=wt,
                    center=True, length=N)))
        if n_fft == N_FFT:
            # an inverse real FFT a frame, then N_FFT adds a frame
            # (overlap-add); the bytes: the planes, H's tables, the output
            H[n_fft].update(
                plain_ms=cuda_ms(torch, plain),
                bound=bound(tensor_bytes(ha[:2], stft_cuda._tables_on(
                    hspec, dev), kH), rfft_flops(S.shape[-1], N_FFT) +
                    N_FFT * S.shape[-1]))
            try:
                stft_cuda.istft_ola(*ha)
                H["raises_without_spec"] = False
            except ValueError:
                H["raises_without_spec"] = True
            xr = istft(S, n_fft=N_FFT, N=N)
            H["roundtrip_mad_rms"] = madH = mad_rms(x, xr)
            del xr
            absH = H[n_fft]["abs"]
        del kH, S, ha
    results["H"] = H
    H6 = H[N_FFT]
    print("[10] kernel H (chirp-z adjoint): " + "; ".join(
        f"n_fft={k}: rel={v['rel']:.3e}, vs float64 {v['rel64']:.3e} "
        f"(plain {v['plain_rel64']:.3e}), bitwise-repeat={v['bitwise']}" +
        (f" | {v['ms']:.3f} ms" if "ms" in v else "") +
        (f" vs plain {v['plain_ms']:.3f} ms, bound {v['bound'][0]:.3f} ms "
         f"({v['bound'][1]})" if "plain_ms" in v else "") +
        (f", torch.istft {v['library_ms']:.3f} ms" if "library_ms" in v
         else "")
        for k, v in H.items() if isinstance(k, int)) +
        f"; without a spec raises: {H['raises_without_spec']}; "
        f"istft(stft(x)) mad_rms {madH:.3e} ({card})")
    for k, v in H.items():
        if isinstance(k, int):
            check(v["bitwise"], f"kernel H (n_fft={k}) differs between two "
                  "runs")
            check(v["rel"] < 2e-6, f"kernel H (n_fft={k}) rel {v['rel']:.3e}")
    check(H["raises_without_spec"], "kernel H ran without its DftSpec")
    check(madH < 1e-5, f"istft(stft(x)) mad_rms {madH:.3e}")
    msH, msH_plain, boundH, msH_lib = (H6["ms"], H6["plain_ms"], H6["bound"],
                                       H6["library_ms"])

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
    prof11 = {
        "stft": device_breakdown(torch, lambda: stft(x, n_fft=N_FFT), (
            ("F", ("stft_bluestein",)), K_PAD)),
        "ssq_stft": device_breakdown(torch, lambda: ssq_stft(
            x, n_fft=N_FFT), (("G", ("ssq_stft_bluestein",)), K_PAD)),
        "istft": device_breakdown(torch, lambda: istft(
            Sq, n_fft=N_FFT, N=N), (("H", ("istft_bluestein",
                                           "ola_partials")), K_PAD))}

    # the device results against the CPU (plain-torch) results
    xs = np.random.default_rng(1).standard_normal((2, N_SMALL))
    xs = xs.astype(np.float32)
    g = ssq_stft(torch.as_tensor(xs, device=dev), n_fft=N_FFT, fs=1000.0)
    c = cpu_ref(torch, lambda: ssq_stft(torch.as_tensor(xs), n_fft=N_FFT,
                                        fs=1000.0))
    sx_small = rel(torch, g[1].cpu(), c[1])
    col_small, tot_small = tx_metrics(np, g[0].cpu().numpy(), c[0].numpy())
    xg = istft(g[1], n_fft=N_FFT, N=N_SMALL).cpu()
    xc = cpu_ref(torch, lambda: istft(c[1], n_fft=N_FFT, N=N_SMALL))
    x_small = rel(torch, xg, xc)

    results["stft_e2e"] = dict(
        request_ms=req_ms, launches=launches, sine_peak_hz=peak,
        issq_mad_rms_fs1=issq_mad, stft_ms=stft_ms, stft_steady=stft_all,
        stft_msamples_s=N / stft_ms / 1e3, ssq_stft_ms=ssq_ms,
        ssq_stft_steady=ssq_all, ssq_stft_msamples_s=N / ssq_ms / 1e3,
        small_sx_rel=sx_small, small_col_rel=col_small,
        small_total_rel=tot_small, small_istft_rel=x_small, profile=prof11)
    print(f"[11] STFT family N={N} n_fft={N_FFT}: launches {launches}; sine "
          f"ssq peak {peak:.3f} Hz; issq_stft mad_rms (fs=1) "
          f"{issq_mad:.3e}; steady stft {stft_ms:.2f} ms = "
          f"{N / stft_ms / 1e3:.2f} MSamples/s, ssq_stft {ssq_ms:.2f} ms = "
          f"{N / ssq_ms / 1e3:.2f} MSamples/s ({card}); GPU vs CPU at "
          f"N={N_SMALL}: Sx rel {sx_small:.2e}, Tx col rel {col_small:.2e}, "
          f"total rel {tot_small:.2e}, istft rel {x_small:.2e}; profiles: "
          + "; ".join(f"{k} {breakdown_line(v)}" for k, v in prof11.items()))
    check(abs(peak - 100.0) <= 1.0, f"ssq_stft sine peak at {peak} Hz")
    check(issq_mad < 0.1, f"issq_stft mad_rms {issq_mad:.3e}")
    check(sx_small < 1e-5 and x_small < 1e-5,
          f"GPU vs CPU Sx rel {sx_small:.2e}, istft rel {x_small:.2e}")
    check(col_small < 1e-4 and tot_small < 1e-5,
          f"GPU vs CPU Tx: col {col_small:.2e}, total {tot_small:.2e}")

    F6 = F["600 rows"]
    return [
        # B' and G: no one PyTorch call bins and scatters
        kernel_entry("reassign4", "reassign.cu", "reassign_pallas.py:175",
                     launches["reassign4"], abs4, ms4, ms4_plain, bound4,
                     None),
        # F at 600 rows (derivative off), where torch.stft is its yardstick
        kernel_entry("stft_dft", "stft_dft.cu", "stft_pallas.py:188",
                     launches["stft_dft"], F6["abs"], F6["ms"],
                     F6["plain_ms"], F6["bound"], F6["library_ms"]),
        kernel_entry("ssq_stft", "ssq_stft.cu", "stft_pallas.py:537",
                     launches["ssq_stft"], absG, msG, msG_plain, boundG,
                     None),
        kernel_entry("istft_ola", "istft_ola.cu", "stft_pallas.py:338",
                     launches["istft_ola"], absH, msH, msH_plain, boundH,
                     msH_lib),
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
    from ssqueeze_rs_tpu_torch.ops.stft import (_k_t, _win_bytes, _dft_spec,
                                                _irfft_mats_weighted,
                                                _irfft_spec)
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
        per_entry = BIN_FLOPS if key == "C" else BIN4_FLOPS
        C[key] = dict(equal=equal, max_abs_err=err, bitwise=bitwise, nf=nfc,
                      masked=float((p[0] == 0).float().mean()),
                      ms=cuda_ms(torch, lambda: fn(*a)),
                      plain_ms=cuda_ms(torch, lambda: plain(*a)),
                      bound=bound(tensor_bytes(a, k1),
                                  per_entry * k1[0].numel()))
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
    prof13 = device_breakdown(torch, lambda: cwt_grad(x, 1.0),
                              (K_A, K_C, K_B, K_FFT, K_CPLX, K_PAD))
    xs = np.random.default_rng(1).standard_normal((2, N_SMALL))
    xs = xs.astype(np.float32)
    small = {}
    for wx_only in (False, True):
        g = cwt_grad(torch.as_tensor(xs, device=dev), 1000.0, 8, wx_only)
        c = cpu_ref(torch, lambda: cwt_grad(torch.as_tensor(xs), 1000.0, 8,
                                            wx_only))
        small["wx" if wx_only else "ssq"] = rel(torch, g.cpu(), c)
    results["grad_ssq_cwt"] = dict(launches_per_call=moved, bitwise=repeat,
                                   ms=ms_cwt, steady_ms=all_cwt,
                                   peak_gb=peak, base_gb=base,
                                   small_rel=small, profile=prof13)
    print(f"[13] ssq_cwt grad N={N}: launches per call {moved}; "
          f"bitwise-repeat={repeat}; forward+backward {ms_cwt:.2f} ms, peak "
          f"{peak:.2f} GB (of which {base:.2f} GB held before) ({card}); "
          f"GPU vs CPU at N={N_SMALL}: rel {small['ssq']:.2e}, Wx-only "
          f"{small['wx']:.2e}; profile: {breakdown_line(prof13)}")
    check(repeat, "ssq_cwt gradient differs between two runs")
    check(small["ssq"] < 5e-3 and small["wx"] < 1e-4,
          f"ssq_cwt gradient GPU vs CPU: {small}")

    # 14. the STFT family's gradients
    win, dwin = get_window(None, N_FFT, N_FFT, derivative=True,
                           dtype="float32")
    xp = padsignal(x, "reflect", padlength=N + N_FFT - 1)
    adj = {}
    for rows, dw, fs in ((600, None, None), (1200, _win_bytes(dwin), 1.0)):
        wins = (_win_bytes(win), dw, N_FFT, True)
        K = _k_t(*wins, dev)
        g = seeded((rows, N))
        xk, xq = (xp.detach().clone().requires_grad_() for _ in range(2))
        gk, = torch.autograd.grad(stft_cuda.stft_dft(
            xk, K, N_FFT, N, fs=fs, spec=_dft_spec(*wins)), xk, g)
        gq, = torch.autograd.grad(stft_cuda.stft_dft_plain(
            xq, K, N_FFT, N, fs=fs), xq, g)
        adj[f"F {rows} rows" + (" (two windows)" if dw else "")] = rel(
            torch, gk, gq)
    S = stft(x, n_fft=N_FFT)
    Fr, Fs = _irfft_mats_weighted(N_FFT, True, _win_bytes(win), 1, dev)
    g = seeded((N + N_FFT - 1,))
    hk = [S.real.contiguous().requires_grad_(),
          S.imag.contiguous().requires_grad_()]
    hq = [t.detach().clone().requires_grad_() for t in hk]
    gk = torch.autograd.grad(stft_cuda.istft_ola(
        *hk, Fr, Fs, N_FFT, adjoint=_irfft_spec(N_FFT, True, _win_bytes(win),
                                                1)), hk, g)
    gq = torch.autograd.grad(stft_cuda.istft_ola_plain(*hq, Fr, Fs, N_FFT),
                             hq, g)
    adj["H"] = max(rel(torch, a, b) for a, b in zip(gk, gq))
    # ssq_stft's backward on an Sx cotangent (F recomputes the planes, C'
    # takes a zero Tx cotangent, H the one-window structure of K_T's first
    # 2 nf rows) against autograd of the plain planes
    wins4 = (_win_bytes(win), _win_bytes(dwin), N_FFT, True)
    K4 = _k_t(*wins4, dev)
    nf4 = N_FFT // 2 + 1
    Sfs4 = np.linspace(0, 0.5, nf4, dtype=np.float32)
    const4, mode4, params4 = plan_reassignment(Sfs4, nf4, False,
                                               transform="stft")
    ssq_args = (N_FFT, N, 1.0, torch.as_tensor(Sfs4, device=dev),
                torch.as_tensor(const4, dtype=f32, device=dev), gamma,
                params4, mode4, False)
    g = seeded((nf4, N, 2))
    xk, xq = (xp.detach().clone().requires_grad_() for _ in range(2))
    Sk = stft_cuda.ssq_stft_fused(xk, K4, *ssq_args,
                                  spec=_dft_spec(*wins4))[1]
    gk, = torch.autograd.grad((torch.view_as_real(Sk) * g).sum(), xk)
    _, _, sqr, sqi = stft_cuda._ssq_stft_planes_plain(xq, K4, *ssq_args)
    gq, = torch.autograd.grad((sqr * g[..., 0] + sqi * g[..., 1]).sum(), xq)
    adj["ssq_stft (Sx)"] = rel(torch, gk, gq)
    del g, hk, hq, gk, gq, xk, xq, Sk, sqr, sqi, K4
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
        small_rel = rel(torch, fn(inputs[1]).cpu(),
                        cpu_ref(torch, lambda: fn(inputs[2])))
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

    # C and C': no one PyTorch call bins and gathers
    c, c4 = C["C"], C["C' nf=300"]
    return [
        kernel_entry("reassign_bwd", "reassign_bwd.cu",
                     "reassign_pallas.py:485", launches_c, c["max_abs_err"],
                     c["ms"], c["plain_ms"], c["bound"], None),
        kernel_entry("reassign4_bwd", "reassign_bwd.cu",
                     "reassign_pallas.py:485", launches_c4,
                     c4["max_abs_err"], c4["ms"], c4["plain_ms"],
                     c4["bound"], None),
    ]


def cwt_family_phases(np, torch, dev, card, results, ctx):
    """Phases 15-17: kernels D and E against their plain versions, the CWT
    family end to end, the cwt gradient. Returns D's and E's entries of
    the JSON line."""
    from ssqueeze_rs_tpu_torch import cwt, icwt, ssq_cwt, mad_rms
    from ssqueeze_rs_tpu_torch.ops import fft_cuda, reassign_cuda
    from ssqueeze_rs_tpu_torch.ops.cwt import cwt_phase_args
    from ssqueeze_rs_tpu_torch.scales import process_scales
    from ssqueeze_rs_tpu_torch.utils.pad import padsignal
    from ssqueeze_rs_tpu_torch.wavelets import Wavelet

    f32, c64 = torch.float32, torch.complex64
    wavelet, scales = ctx["wavelet"], ctx["scales"]
    requests = ctx["requests"]
    x = requests["noise"][0]
    rng = np.random.default_rng(4)
    bump = Wavelet.build(("bump", {"om": 0.5}), l1_norm=True)

    def spectrum(Zr, Zi, nr, ni):
        """The (rows, M) complex spectrum of half-band planes, as
        torch.fft.ifft (the yardstick) takes it."""
        rows = Zr.shape[0]
        half = Zr[0].numel()
        spec = torch.zeros((rows, 2 * half), dtype=c64, device=dev)
        spec[:, :half] = torch.complex(Zr.reshape(rows, half),
                                       Zi.reshape(rows, half))
        spec[:, half] = torch.complex(nr, ni)
        return spec

    def hold(name, kernel, plain, spec, nbytes, flops):
        """Kernel against plain (per plane, max|d| / max|plain|), bitwise
        repeat, times of kernel, plain and torch.fft.ifft of `spec`."""
        k1, k2, p = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(k1, k2))
        err = max(rel(torch, a, b) for a, b in zip(k1, p))
        err_abs = max(float((a - b).abs().max()) for a, b in zip(k1, p))
        bnd = bound(nbytes + tensor_bytes(k1), flops)
        del k2, p
        out = dict(rel=err, abs=err_abs, bitwise=bitwise,
                   rows=int(k1[0].shape[0]), planes=len(k1),
                   ms=cuda_ms(torch, kernel), plain_ms=cuda_ms(torch, plain),
                   library_ms=cuda_ms(torch, lambda: torch.fft.ifft(
                       spec, dim=-1)), bound_ms=bnd[0], bound_by=bnd[1])
        check(bitwise, f"kernel {name} differs between two runs")
        check(err < 1e-5, f"kernel {name}: rel error {err:.3e} >= 1e-5")
        return out

    # 15. kernels D and E against their plain versions
    DE = {}
    xp, _, n1, _ = padsignal(x, "reflect", get_params=True)
    M = xp.shape[-1]
    argsD = cwt_phase_args(xp, scales.squeeze(-1), 1.0, wavelet)
    x1m = torch.as_tensor(rng.standard_normal(N_LARGE), dtype=f32,
                          device=dev)
    sc1m = process_scales("log-piecewise", N_LARGE, wavelet)[:64].squeeze(-1)
    xp1m, _, n1m, _ = padsignal(x1m, "reflect", get_params=True)
    args1m = cwt_phase_args(xp1m, sc1m, 1.0, wavelet)
    for key, a, keep, d in (("D 160k", argsD, (n1, N), False),
                            ("D 160k derivative", argsD, (n1, N), True),
                            ("D 1M derivative", args1m, (n1m, N_LARGE),
                             True)):
        Pw, xr, xi, xig, inv_dt, nw, nd = a
        Zr, Zi = fft_cuda._cwt_spectra(Pw, xr[None] if xr.ndim == 2 else xr,
                                       xi[None] if xi.ndim == 2 else xi,
                                       xig, inv_dt, d)
        spec = spectrum(Zr, Zi, torch.cat([nw[0], nd[0]]) if d else nw[0],
                        torch.cat([nw[1], nd[1]]) if d else nw[1])
        del Zr, Zi
        Mk = 2 * Pw.shape[1] * Pw.shape[2]
        run = lambda: fft_cuda.cwt_fused(*a, keep=keep, derivative=d)
        DE[key] = hold(
            key, run,
            lambda: fft_cuda.cwt_fused_plain(*a, keep=keep, derivative=d),
            spec, tensor_bytes(a[:4], nw, nd if d else ()),
            fft_flops(spec.shape[0], Mk))
        pipes, rows = (2 if d else 1), spec.shape[0] // (2 if d else 1)
        # the budget of D's row chunks (its intermediate kept in L2): the
        # constant against 10 and 20 MB and one chunk of every row
        sweep, budget = {}, fft_cuda._D_Y_BYTES
        for mb in (10, 20, budget >> 20, 1 << 20):
            fft_cuda._D_Y_BYTES = mb << 20
            sweep[f"{mb} MB, {fft_cuda.d_chunk_rows(Mk, pipes, rows)} "
                  f"rows"] = cuda_ms(torch, run)
        fft_cuda._D_Y_BYTES = budget
        DE[key].update(M=Mk, keep=list(keep), budget_sweep_ms=sweep,
                       chunk_rows=fft_cuda.d_chunk_rows(Mk, pipes, rows))
        del spec
    del x1m, xp1m, args1m
    # E on the complex-psih headline: bump (om = 0.5), 318 rows
    scb = process_scales("log-piecewise", N, bump).squeeze(-1)
    M1, M2 = fft_cuda.best_split(M)
    Psih = bump.sample(scb.astype(np.float32), M, half=True,
                       device=dev).to(c64)
    Z = Psih * torch.fft.rfft(xp)[None]
    del Psih
    Zr = Z[:, :M // 2].real.reshape(-1, M1 // 2, M2).contiguous()
    Zi = Z[:, :M // 2].imag.reshape(-1, M1 // 2, M2).contiguous()
    nr, ni = Z[:, -1].real.contiguous(), Z[:, -1].imag.contiguous()
    del Z
    spec = spectrum(Zr, Zi, nr, ni)
    rowsE = Zr.shape[0]
    for key, keep in (("E 160k bump", (n1, N)), ("E 160k bump all", (0, M))):
        ea = (Zr, Zi, keep, nr, ni)
        run = lambda: fft_cuda.ifft_halfband_planar(*ea)
        DE[key] = hold(
            key, run, lambda: fft_cuda.ifft_halfband_planar_plain(*ea), spec,
            tensor_bytes(Zr, Zi, nr, ni), fft_flops(rowsE, M))
        DE[key].update(M=M, keep=list(keep),
                       chunk_rows=fft_cuda.d_chunk_rows(M, 1, rowsE))
    # E's row chunks as D's with one pipeline: the same budget sweep
    sweep, budget = {}, fft_cuda._D_Y_BYTES
    ea = (Zr, Zi, (n1, N), nr, ni)
    for mb in (10, 20, budget >> 20, 1 << 20):
        fft_cuda._D_Y_BYTES = mb << 20
        sweep[f"{mb} MB, {fft_cuda.d_chunk_rows(M, 1, rowsE)} rows"] = \
            cuda_ms(torch, lambda: fft_cuda.ifft_halfband_planar(*ea))
    fft_cuda._D_Y_BYTES = budget
    DE["E 160k bump"]["budget_sweep_ms"] = sweep
    del spec, ea, Zr, Zi
    results["DE"] = DE
    print("[15] " + "; ".join(
        f"{k}: rows={v['rows']} rel={v['rel']:.3e} bitwise-repeat="
        f"{v['bitwise']} | {v['ms']:.3f} ms vs plain {v['plain_ms']:.3f}, "
        f"bound {v['bound_ms']:.3f} ({v['bound_by']}), torch.fft.ifft "
        f"{v['library_ms']:.3f}" + (
            f", {v['chunk_rows']} rows a chunk" + ("; budgets " + ", ".join(
                f"{b}: {t:.3f} ms" for b, t in v["budget_sweep_ms"].items())
                if "budget_sweep_ms" in v else "")
            if "chunk_rows" in v else "")
        for k, v in DE.items()) + f" ({card})")

    # 16. cwt / icwt / ssq_cwt end to end: three requests
    def counts():
        return dict(cwt_phase=fft_cuda.LAUNCHES,
                    cwt_fused=fft_cuda.LAUNCHES_D,
                    ifft_halfband=fft_cuda.LAUNCHES_E,
                    reassign=reassign_cuda.LAUNCHES,
                    reassign4=reassign_cuda.LAUNCHES4)

    def zero_counts():
        fft_cuda.LAUNCHES = fft_cuda.LAUNCHES_D = fft_cuda.LAUNCHES_E = 0
        reassign_cuda.LAUNCHES = reassign_cuda.LAUNCHES4 = 0

    calls = {
        "cwt": (lambda xq, fs: cwt(xq, wavelet, scales=scales, fs=fs),
                dict(cwt_fused=1)),
        "cwt(derivative)": (lambda xq, fs: cwt(
            xq, wavelet, scales=scales, fs=fs, derivative=True),
            dict(cwt_fused=1)),
        "bump cwt": (lambda xq, fs: cwt(xq, bump, fs=fs),
                     dict(ifft_halfband=1)),
        "ssq_cwt(get_dWx)": (lambda xq, fs: ssq_cwt(
            xq, wavelet, scales=scales, fs=fs, get_dWx=True),
            dict(cwt_fused=1, reassign4=1)),
        "ssq_cwt(lebesgue)": (lambda xq, fs: ssq_cwt(
            xq, wavelet, scales=scales, fs=fs, squeezing="lebesgue"),
            dict(cwt_fused=1, reassign4=1)),
    }
    zero_counts()
    req_ms, sine = {}, {}
    for name, (xq, fs) in requests.items():
        for cname, (call, expect) in calls.items():
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = call(xq, fs)
            torch.cuda.synchronize()
            req_ms[f"{name} {cname}"] = (time.perf_counter() - t0) * 1e3
            moved = {k: v - before[k] for k, v in counts().items()
                     if v != before[k]}
            check(moved == expect, f"{name} {cname}: launches moved by "
                  f"{moved}, expected {expect}")
            for o in out:
                if isinstance(o, torch.Tensor):
                    check(o.is_cuda and o.shape[-1] == N,
                          f"{name} {cname}: {o.device} {tuple(o.shape)}")
                    check(bool(torch.isfinite(o).all()),
                          f"{name} {cname}: output not finite")
            if name == "sine100":
                sine[cname] = out
    launches = counts()
    check(launches == dict(cwt_phase=0, cwt_fused=12, ifft_halfband=3,
                           reassign=0, reassign4=6),
          f"launch counts {launches}")

    # the sine's ridge: the instantaneous frequency Im(dWx/Wx)/2pi (Hz,
    # dWx is per second) on the row of largest mean |Wx|, over the
    # middle half of the columns
    Wx, _, dWx = sine["cwt(derivative)"]
    r = int(Wx.abs().mean(-1).argmax())
    mid = slice(N // 4, 3 * N // 4)
    inst = (dWx[r, mid] * Wx[r, mid].conj()).imag / (
        Wx[r, mid].abs() ** 2 * 2 * np.pi)
    f_ridge = float(inst.median())
    Tx, _, ssq_freqs, *_ = sine["ssq_cwt(get_dWx)"]
    f_ssq = float(ssq_freqs[int(Tx.abs().mean(-1).argmax())])
    x_sine = requests["sine100"][0]
    xrec = icwt(sine["cwt"][0], wavelet, scales=scales)
    icwt_mad = mad_rms(x_sine, xrec)
    del sine, Wx, dWx, Tx, xrec
    steady = {}
    for cname, (call, _) in calls.items():
        steady[cname] = host_ms(torch, lambda: call(x, 1.0))
    # where cwt's device time goes (kernel names: D's two launches; cuFFT
    # and the psih evaluation's elementwise kernels; torch.complex)
    prof = device_breakdown(torch, lambda: calls["cwt"][0](x, 1.0),
                            (K_D, K_FFT, K_CPLX, K_PAD))
    # the bump cwt: E runs D's two launches (same kernel names)
    prof_bump = device_breakdown(
        torch, lambda: calls["bump cwt"][0](x, 1.0),
        (("E", K_D[1]), K_FFT, K_CPLX, K_PAD))

    # the device results against the CPU (plain-torch) results
    xs = np.random.default_rng(1).standard_normal((2, N_SMALL))
    xs = xs.astype(np.float32)
    gx, cx = torch.as_tensor(xs, device=dev), torch.as_tensor(xs)
    small = {}
    g = cwt(gx, wavelet, fs=1000.0, nv=8, derivative=True)
    c = cpu_ref(torch, lambda: cwt(cx, wavelet, fs=1000.0, nv=8,
                                   derivative=True))
    small["cwt Wx"] = rel(torch, g[0].cpu(), c[0])
    small["cwt dWx"] = rel(torch, g[2].cpu(), c[2])
    g, c = cwt(gx, bump, nv=8), cpu_ref(torch, lambda: cwt(cx, bump, nv=8))
    small["bump Wx"] = rel(torch, g[0].cpu(), c[0])
    g = ssq_cwt(gx, wavelet, fs=1000.0, nv=8, get_dWx=True)
    c = cpu_ref(torch, lambda: ssq_cwt(cx, wavelet, fs=1000.0, nv=8,
                                       get_dWx=True))
    small["ssq Wx"] = rel(torch, g[1].cpu(), c[1])
    col_small, tot_small = tx_metrics(np, g[0].cpu().numpy(), c[0].numpy())
    del g, c

    prof_line = breakdown_line(prof)
    results["cwt_e2e"] = dict(
        request_ms=req_ms, launches=launches, ridge_hz=f_ridge,
        cwt_profile=prof, bump_cwt_profile=prof_bump,
        ssq_peak_hz=f_ssq, icwt_mad_rms=icwt_mad,
        steady_ms={k: v[0] for k, v in steady.items()},
        steady_all={k: v[1] for k, v in steady.items()},
        small_rel=small, small_col_rel=col_small, small_total_rel=tot_small)
    print(f"[16] CWT family N={N}: launches {launches}; sine ridge "
          f"{f_ridge:.3f} Hz, ssq peak {f_ssq:.3f} Hz; icwt(cwt(x)) mad_rms "
          f"{icwt_mad:.3e}; steady " + ", ".join(
              f"{k} {v[0]:.2f} ms" for k, v in steady.items()) +
          f" ({card}); cwt profile: {prof_line}; bump cwt profile: "
          f"{breakdown_line(prof_bump)}; GPU vs CPU at "
          f"N={N_SMALL}: " + ", ".join(
              f"{k} {v:.2e}" for k, v in small.items()) +
          f", Tx col {col_small:.2e}, total {tot_small:.2e}")
    check(abs(f_ridge - 100.0) <= 1.0, f"cwt ridge at {f_ridge} Hz")
    check(abs(f_ssq - 100.0) <= 1.0, f"ssq_cwt peak at {f_ssq} Hz")
    check(icwt_mad < 0.02, f"icwt(cwt(x)) mad_rms {icwt_mad:.3e}")
    check(max(small.values()) < 1e-5, f"GPU vs CPU: {small}")
    check(col_small < 1e-4 and tot_small < 1e-5,
          f"GPU vs CPU Tx: col {col_small:.2e}, total {tot_small:.2e}")

    # 17. the gradient of cwt at the headline width
    def sq(z):
        return (z.abs() ** 2).sum()

    def cwt_grad(x0, fs, **kw):
        xg = x0.detach().clone().requires_grad_()
        Wx, _, dWx = cwt(xg, wavelet, fs=fs, derivative=True, **kw)
        (sq(Wx) + sq(dWx)).backward()
        return xg.grad

    zero_counts()
    grads = {}
    for name, (xq, fs) in requests.items():
        before = counts()
        grads[name] = cwt_grad(xq, fs, scales=scales)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in counts().items()
                 if v != before[k]}
        check(moved == dict(cwt_fused=1),
              f"cwt grad {name}: launches moved by {moved}")
        check(bool(torch.isfinite(grads[name]).all()),
              f"cwt grad {name}: not finite")
    repeat = torch.equal(cwt_grad(x, 1.0, scales=scales), grads["noise"])
    del grads
    ms_g, all_g = host_ms(torch, lambda: cwt_grad(x, 1.0, scales=scales))
    _, peak, base = peak_gb(torch, lambda: cwt_grad(x, 1.0, scales=scales))
    prof17 = device_breakdown(torch, lambda: cwt_grad(x, 1.0, scales=scales),
                              (K_D, K_FFT, K_CPLX, K_PAD))
    g_small = rel(torch, cwt_grad(gx, 1000.0, nv=8).cpu(),
                  cpu_ref(torch, lambda: cwt_grad(cx, 1000.0, nv=8)))
    results["grad_cwt"] = dict(launches_per_call=moved, bitwise=repeat,
                               ms=ms_g, steady_ms=all_g, peak_gb=peak,
                               base_gb=base, small_rel=g_small,
                               profile=prof17)
    print(f"[17] cwt grad N={N} (loss sum|Wx|^2 + sum|dWx|^2): launches per "
          f"call {moved}; bitwise-repeat={repeat}; forward+backward "
          f"{ms_g:.2f} ms, peak {peak:.2f} GB (of which {base:.2f} GB held "
          f"before) ({card}); profile: {breakdown_line(prof17)}; GPU vs CPU "
          f"at N={N_SMALL}: rel {g_small:.2e}")
    check(repeat, "cwt gradient differs between two runs")
    check(g_small < 1e-4, f"cwt gradient GPU vs CPU rel {g_small:.2e}")

    d0, e0 = DE["D 160k"], DE["E 160k bump"]
    return [
        kernel_entry("cwt_fused", "cwt_planes.cu", "fft_pallas.py:704",
                     launches["cwt_fused"], d0["abs"], d0["ms"],
                     d0["plain_ms"], (d0["bound_ms"], d0["bound_by"]),
                     d0["library_ms"]),
        kernel_entry("ifft_halfband", "cwt_planes.cu", "fft_pallas.py:296",
                     launches["ifft_halfband"], e0["abs"], e0["ms"],
                     e0["plain_ms"], (e0["bound_ms"], e0["bound_by"]),
                     e0["library_ms"]),
    ]

class scatter_impl:
    """SSQ_TPU_REASSIGN_IMPL set to `value` inside the block, restored
    after."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        self.old = os.environ.get("SSQ_TPU_REASSIGN_IMPL")
        os.environ["SSQ_TPU_REASSIGN_IMPL"] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("SSQ_TPU_REASSIGN_IMPL", None)
        else:
            os.environ["SSQ_TPU_REASSIGN_IMPL"] = self.old


def serving_phases(np, torch, dev, card, results, ctx):
    """Phases 18-20: kernel I against its plain version and B', the
    streaming transforms, the server and the recording pipeline. Returns
    I's entry of the JSON line."""
    from ssqueeze_rs_tpu_torch import (StreamingSSQSTFT, StreamingSSQCWT,
                                       TransformServer, ssq_cwt, ssq_stft,
                                       stft)
    from ssqueeze_rs_tpu_torch.parallel import process_recording
    from ssqueeze_rs_tpu_torch.ops import fft_cuda, reassign_cuda, stft_cuda
    from ssqueeze_rs_tpu_torch.ops.cwt import cwt_phase_args
    from ssqueeze_rs_tpu_torch.ops.ssqueeze import (plan_ssqueeze,
                                                    plan_reassignment)
    from ssqueeze_rs_tpu_torch.utils.pad import padsignal
    from ssqueeze_rs_tpu_torch.config import EPS32

    gamma = 10 * EPS32
    wavelet, scales = ctx["wavelet"], ctx["scales"]
    x = ctx["requests"]["noise"][0]
    R = reassign_cuda

    def counts():
        return dict(cwt_phase=fft_cuda.LAUNCHES, cwt_fused=fft_cuda.LAUNCHES_D,
                    reassign=R.LAUNCHES, reassign4=R.LAUNCHES4,
                    reassign_mxu=R.LAUNCHES_MXU, **stft_cuda.LAUNCHES)

    def zero_counts():
        fft_cuda.LAUNCHES = fft_cuda.LAUNCHES_D = fft_cuda.LAUNCHES_E = 0
        R.LAUNCHES = R.LAUNCHES4 = R.LAUNCHES_MXU = 0
        R.LAUNCHES_BWD = R.LAUNCHES4_BWD = 0
        for key in stft_cuda.LAUNCHES:
            stft_cuda.LAUNCHES[key] = 0

    def moved_since(before):
        return {k: v - before[k] for k, v in counts().items()
                if v != before[k]}

    def held(Tk, Tr):
        """(sum |Tk - Tr| / sum |Tr|, share of entries whose nonzero
        pattern agrees): the JAX package's bar for I against B'."""
        s = float((Tk - Tr).abs().sum() / Tr.abs().sum())
        nz = float(((Tk.abs() > 0) == (Tr.abs() > 0)).float().mean())
        return s, nz

    # 18. kernel I against plain I and B'
    def stft_case(xs, n_fft):
        (sr, si), (dr, di) = stft(xs, n_fft=n_fft, derivative=True,
                                  planar_out=True)
        nf = sr.shape[-2]
        Sfs = np.linspace(0, 0.5, nf, dtype=np.float32)
        const, mode, params = plan_reassignment(Sfs, nf, False,
                                                transform="stft")
        return (sr, si, dr, di,
                torch.as_tensor(const, dtype=torch.float32, device=dev),
                torch.as_tensor(Sfs, device=dev), gamma, params, mode, False,
                nf, "stft")

    def cwt_case():
        xp, _, n1, _ = padsignal(x, "reflect", get_params=True)
        planes = fft_cuda.cwt_fused(*cwt_phase_args(
            xp, scales.squeeze(-1), 1.0, wavelet), keep=(n1, N),
            derivative=True)
        na = planes[0].shape[0]
        freqs, const, mode, params = plan_ssqueeze(
            N, na, None, scales, fs=1.0, maprange="peak", wavelet=wavelet)
        return (*planes,
                torch.as_tensor(const, dtype=torch.float32, device=dev),
                torch.zeros(na, device=dev), gamma, params, mode, True,
                len(freqs), "cwt")

    x20 = torch.as_tensor(np.random.default_rng(18).standard_normal(N_SMALL),
                          dtype=torch.float32, device=dev)
    xb = torch.as_tensor(np.random.default_rng(21).standard_normal(
        (2, N_SMALL)), dtype=torch.float32, device=dev)
    # the first three are timed; the last three run I's other
    # instantiations (1 and 4 tiles a pass) and a batch of two planes
    cases = {"cwt nf=293": cwt_case,
             "stft nf=300": lambda: stft_case(x, N_FFT),
             "stft nf=1025": lambda: stft_case(x20, 2048),
             "stft nf=256": lambda: stft_case(x20, 510),
             "stft nf=1024": lambda: stft_case(x20, 2046),
             "stft nf=300 batch 2": lambda: stft_case(xb, N_FFT)}
    timed = ("cwt nf=293", "stft nf=300", "stft nf=1025")
    I = {}
    for key, make in cases.items():
        a = make()
        nf = a[10]
        with scatter_impl("mxu"):
            k1, k2 = R.reassign4(*a), R.reassign4(*a)
        p = R.reassign_mxu_plain(*a)
        with scatter_impl("vpu"):
            b4 = R.reassign4(*a)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(u, v) for u, v in zip(k1, k2))
        TI, TP, TB = (torch.complex(*o) for o in (k1, p, b4))
        sB, nzB = held(TI, TB)
        sP, nzP = held(TI, TP)
        absP = float((TI - TP).abs().max())
        del k2, p, TP
        # the gradient through I against the one through B' (both C')
        g = torch.randn((2,) + tuple(k1[0].shape), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))

        def grad(impl):
            with scatter_impl(impl):
                wr = a[0].detach().clone().requires_grad_()
                wi = a[1].detach().clone().requires_grad_()
                txr, txi = R.reassign4(wr, wi, *a[2:])
                (txr * g[0] + txi * g[1]).sum().backward()
                return wr.grad, wi.grad
        grad_equal = all(torch.equal(u, v)
                         for u, v in zip(grad("vpu"), grad("mxu")))
        del g
        I[key] = dict(nf=nf, shape=list(a[0].shape),
                      tiles_per_pass=R._mxu_tiles_per_pass(nf),
                      sum_rel_vs_B4=sB, nonzero_agree_B4=nzB,
                      sum_rel_vs_plain=sP, nonzero_agree_plain=nzP,
                      abs_vs_plain=absP, bitwise=bitwise,
                      grad_equal_B4=grad_equal)
        if key in timed:
            with scatter_impl("mxu"):
                ms = cuda_ms(torch, lambda: R.reassign4(*a))
            ms_plain = cuda_ms(torch, lambda: R.reassign_mxu_plain(*a))
            with scatter_impl("vpu"):
                ms_b4 = cuda_ms(torch, lambda: R.reassign4(*a))
            # the function is B''s scatter: B''s bound
            bnd = bound(tensor_bytes(a, k1), BIN4_FLOPS * a[0].numel())
            I[key].update(ms=ms, plain_ms=ms_plain, b4_ms=ms_b4,
                          bound_ms=bnd[0], bound_by=bnd[1])
        del a, k1, b4, TI, TB
        check(bitwise, f"kernel I ({key}) differs between two runs")
        check(sB < 2e-5 and nzB >= 0.9999, f"kernel I ({key}) against B': "
              f"sum rel {sB:.3e}, nonzero patterns {nzB:.6f}")
        check(sP < 2e-5 and nzP >= 0.9999, f"kernel I ({key}) against its "
              f"plain version: sum rel {sP:.3e}, nonzero patterns {nzP:.6f}")
        check(grad_equal, f"kernel I ({key}): gradient differs from B''s")
    results["I"] = I
    print("[18] kernel I: " + "; ".join(
        f"{k} ({v['tiles_per_pass']} tiles/pass): vs B' sum rel "
        f"{v['sum_rel_vs_B4']:.3e} nonzero {v['nonzero_agree_B4']:.6f}, vs "
        f"plain {v['sum_rel_vs_plain']:.3e}, bitwise-repeat={v['bitwise']}, "
        f"grad == B' {v['grad_equal_B4']}" +
        (f" | {v['ms']:.3f} ms vs plain {v['plain_ms']:.3f}, B' "
         f"{v['b4_ms']:.3f}, bound {v['bound_ms']:.3f} ({v['bound_by']})"
         if "ms" in v else "") for k, v in I.items()) + f" ({card})")
    lap("18 kernel I")

    # 19. the streaming transforms: three 160k-sample signals at fs = 1000
    # in ragged chunks, under each implementation of the 4-plane scatter
    fs = 1000.0
    rng = np.random.default_rng(19)
    t = np.arange(N) / fs
    sig = {"noise": rng.standard_normal(N),
           "sine100": np.cos(2 * np.pi * 100 * t),
           "chirp": np.cos(2 * np.pi * (5 * t + 1.5 * t * t))}
    sig = {k: v.astype(np.float32) for k, v in sig.items()}
    sizes = [int(s) for s in rng.integers(1000, 20001, size=64)]

    def counting(s):
        """Count the steps of streamer `s` (its `_run` calls)."""
        run, steps = s._run, [0]

        def counted(seg):
            steps[0] += 1
            return run(seg)
        s._run = counted
        return steps

    def run_stream(s, steps, xs):
        s.reset()
        steps[0] = 0
        outs, i, k = [], 0, 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while i < N:
            outs.append(s.feed(xs[i:i + sizes[k % len(sizes)]]))
            i += sizes[k % len(sizes)]
            k += 1
        outs.append(s.flush())
        wall = time.perf_counter() - t0
        return (tuple(np.concatenate(p, axis=-1) for p in zip(*outs)),
                steps[0], wall)

    offline = {}
    for name, xs in sig.items():
        xd = torch.as_tensor(xs, device=dev)
        Tq, Sq = ssq_stft(xd, n_fft=N_FFT, fs=fs)[:2]
        Tc, Wc, fc = ssq_cwt(xd, wavelet, fs=fs)[:3]
        offline[name] = (Tq, Sq, Tc, Wc, fc)
    lap("19 offline references")
    S19 = {}
    sq_stft = StreamingSSQSTFT(block=16384, n_fft=N_FFT, fs=fs)
    sq_cwt = StreamingSSQCWT(block=16384, plan_N=N, fs=fs)
    steps_stft, steps_cwt = counting(sq_stft), counting(sq_cwt)
    tight = torch.as_tensor(sq_cwt.row_tail_mass < 1e-6, device=dev)
    streamed_vpu = {}

    def against_vpu(key, Tx):
        """Under 'mxu', the streamed Tx against the same stream's Tx under
        'vpu', by the bar of phase 18 (sum-relative, nonzero patterns)."""
        if key not in streamed_vpu:
            streamed_vpu[key] = Tx
            return {}
        s, nz = held(Tx, streamed_vpu.pop(key))
        check(s < 2e-5 and nz >= 0.9999, f"{key} under 'mxu' against 'vpu': "
              f"sum rel {s:.3e}, nonzero patterns {nz:.6f}")
        return dict(tx_sum_rel_vs_vpu=s, tx_nonzero_agree_vpu=nz)

    zero_counts()
    for impl in ("vpu", "mxu"):
        with scatter_impl(impl):
            for name, xs in sig.items():
                Tq, Sq, Tc, Wc, fc = offline[name]
                before = counts()
                (Tx, Sx), steps, wall = run_stream(sq_stft, steps_stft, xs)
                moved = moved_since(before)
                scatter = "reassign4" if impl == "vpu" else "reassign_mxu"
                check(moved == {"stft_dft": steps, scatter: steps},
                      f"StreamingSSQSTFT {impl} {name}: launches {moved} "
                      f"in {steps} steps")
                # the checks run on the card (numpy took ~1 s a stream)
                Tx, Sx = (torch.as_tensor(o, device=dev) for o in (Tx, Sx))
                col, tot = tx_metrics(torch, Tx, Tq)
                sx = float((Sx - Sq).abs().max() / Sq.abs().max())
                S19[f"ssq_stft {impl} {name}"] = dict(
                    steps=steps, ms_per_step=wall * 1e3 / steps,
                    msamples_s=N / wall / 1e6, tx_col_rel=col,
                    tx_total_rel=tot, sx_rel=sx, launches=moved,
                    **against_vpu(f"StreamingSSQSTFT {name}", Tx))
                check(Tx.shape == Tq.shape and sx < 1e-5 and col < 1e-4 and
                      tot < 1e-5, f"StreamingSSQSTFT {impl} {name} against "
                      f"ssq_stft: Sx {sx:.2e}, Tx col {col:.2e}, total "
                      f"{tot:.2e}")

                before = counts()
                s = sq_cwt
                (Tx, Wx), steps, wall = run_stream(s, steps_cwt, xs)
                moved = moved_since(before)
                check(moved == {"cwt_fused": steps, scatter: steps},
                      f"StreamingSSQCWT {impl} {name}: launches {moved} "
                      f"in {steps} steps")
                Tx, Wx = (torch.as_tensor(o, device=dev) for o in (Tx, Wx))
                inner = slice(s.halo, N - s.halo)
                wx = float((Wx[:, inner][tight] - Wc[:, inner][tight]).abs()
                           .max() / Wc.abs().max())
                f_peak = float(s.ssq_freqs[int(Tx[:, inner].abs().sum(-1)
                                              .argmax())])
                S19[f"ssq_cwt {impl} {name}"] = dict(
                    steps=steps, ms_per_step=wall * 1e3 / steps,
                    msamples_s=N / wall / 1e6, E=s._E, halo=s.halo,
                    tight_rows=int(tight.sum()), wx_tight_rel=wx,
                    peak_hz=f_peak, launches=moved,
                    **against_vpu(f"StreamingSSQCWT {name}", Tx))
                check(Tx.shape == Tc.shape and bool(torch.isfinite(Tx).all())
                      and int(tight.sum()) > 0.25 * len(tight) and wx < 1e-5,
                      f"StreamingSSQCWT {impl} {name}: {int(tight.sum())} "
                      f"tight rows, Wx {wx:.2e}")
                if name == "sine100":
                    check(abs(f_peak - 100) <= 5, f"StreamingSSQCWT {impl} "
                          f"sine peak at {f_peak} Hz")
                del Tx, Wx
    launches19 = counts()
    # the references leave the card before phase 20's peak memory is read
    del offline, Tq, Sq, Tc, Wc
    lap("19 streams")
    # where a step's time goes: the step's kernels and its fetch
    K_I = ("I", ("reassign_mxu_kernel",))
    K_D2H = ("D2H", ("Memcpy DtoH",))
    K_H2D = ("H2D", ("Memcpy HtoD",))
    seg_c = np.pad(sig["chirp"], (sq_cwt._prefix_len, 0),
                   mode="reflect")[:sq_cwt._E]
    seg_q = sig["chirp"][:sq_stft._E]
    S19["profile ssq_cwt step"] = device_breakdown(torch, lambda: [
        c.cpu() for c in sq_cwt._run(seg_c)],
        (K_D, K_B, K_I, K_FFT, K_CPLX, K_D2H, K_H2D))
    S19["profile ssq_stft step"] = device_breakdown(torch, lambda: [
        c.cpu() for c in sq_stft._run(seg_q)],
        (("F", ("stft_bluestein",)), K_B, K_I, K_CPLX, K_D2H, K_H2D))
    results["streaming"] = S19
    vs_vpu = {kind: max(v["tx_sum_rel_vs_vpu"] for k, v in S19.items()
                        if k.startswith(kind + " mxu"))
              for kind in ("ssq_stft", "ssq_cwt")}
    print("[19] streaming, 160k samples in chunks of 1000-20000: " + "; ".join(
        f"{k} {v['steps']} steps {v['ms_per_step']:.1f} ms/step = "
        f"{v['msamples_s']:.2f} MSamples/s" for k, v in S19.items()
        if k.endswith("chirp")) + f"; launches {launches19} ({card}); "
        "sine peaks " + ", ".join(f"{k.split()[1]} {v['peak_hz']:.2f} Hz"
                                  for k, v in S19.items()
                                  if k.startswith("ssq_cwt") and
                                  k.endswith("sine100")) +
        "; Tx under 'mxu' vs 'vpu': sum rel max " + ", ".join(
            f"{kind} {rel_vpu:.2e}" for kind, rel_vpu in vs_vpu.items()) +
        "; one step with its fetch: " + "; ".join(
            f"{k.split()[1]} {breakdown_line(S19[k])}"
            for k in ("profile ssq_cwt step", "profile ssq_stft step")))
    lap("19 step profiles")

    # 20. the server and the recording pipeline
    S20 = {}
    zero_counts()
    srv = TransformServer("ssq_cwt", fs=fs)
    for n in (3000, 10000, 100000, 160000):
        xs = sig["chirp"][:n]
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = srv(xs)
        wall = (time.perf_counter() - t0) * 1e3
        moved = moved_since(before)
        b = srv.bucket_for(n)
        xp = np.pad(xs, (0, b - n), mode="reflect")
        Td = ssq_cwt(torch.as_tensor(xp, device=dev), wavelet,
                     fs=fs)[0][:, :n]
        To = torch.as_tensor(out["Tx"], device=dev)
        d = float((To - Td).abs().max() / Td.abs().max())
        S20[f"ssq_cwt {n}"] = dict(bucket=b, ms=wall, rows=out["Tx"].shape[0],
                                   vs_direct=d, launches=moved)
        check(moved == {"cwt_phase": 1, "reassign": 1},
              f"server ssq_cwt {n}: launches {moved}")
        check(To.shape[-1] == n and bool(torch.isfinite(To).all()) and
              d <= 1e-6, f"server ssq_cwt {n}: {tuple(To.shape)}, vs direct "
              f"{d:.2e}")
        del Td, To
    S20["ssq_cwt 10000 steady_ms"] = host_ms(
        torch, lambda: srv(sig["chirp"][:10000]), n=5)[0]
    S20["profile ssq_cwt 160000"] = device_breakdown(
        torch, lambda: srv(sig["chirp"]),
        (K_A, K_B, K_FFT, K_CPLX, K_D2H, K_H2D), calls=2, warm=True)
    xs16 = [rng.standard_normal(10000).astype(np.float32) for _ in range(16)]
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = srv.batch(xs16)
    wall_b = (time.perf_counter() - t0) * 1e3
    moved_b = moved_since(before)
    t0 = time.perf_counter()
    singles = [srv(xq) for xq in xs16]
    wall_s = (time.perf_counter() - t0) * 1e3
    d = max(float(np.abs(o["Tx"] - s1["Tx"]).max() / np.abs(s1["Tx"]).max())
            for o, s1 in zip(outs, singles))
    S20["batch 16 x 10000"] = dict(ms=wall_b, singles_ms=wall_s,
                                   vs_singles=d, launches=moved_b)
    check(moved_b == {"cwt_phase": 1, "reassign": 1},
          f"server batch: launches {moved_b}")
    check(d <= 1e-6, f"server batch against singles: {d:.2e}")
    del outs, singles
    srv2 = TransformServer("ssq_stft", n_fft=N_FFT, fs=fs)
    for n in (3000, 160000):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = srv2(sig["chirp"][:n])
        wall = (time.perf_counter() - t0) * 1e3
        moved = moved_since(before)
        S20[f"ssq_stft {n}"] = dict(ms=wall, launches=moved)
        check(moved == {"ssq_stft": 1} and out["Tx"].shape == (300, n) and
              np.isfinite(out["Tx"]).all(), f"server ssq_stft {n}: launches "
              f"{moved}, {out['Tx'].shape}")
    lap("20 server")

    # the recording pipeline: 10 minutes of 64 channels at 1 kHz, tones of
    # 10 + 7c Hz in noise (made on the card from a seed), chunks of
    # 250 000, energy per (channel, row)
    C, NR = 64, 600_000
    tr = torch.arange(NR, dtype=torch.float64, device=dev) / fs
    f_c = torch.arange(C, dtype=torch.float64, device=dev)[:, None] * 7 + 10
    noise = torch.randn((C, NR), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(20))
    rec = (torch.cos(2 * np.pi * f_c * tr) + 0.1 * noise).float().cpu().numpy()
    del tr, f_c, noise
    before = counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    en, meta = process_recording(rec, transform="ssq_cwt", fs=fs,
                                 chunk_len=250_000, out="energy")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    moved = moved_since(before)
    fr = meta["ssq_freqs"]
    tones = np.array([fr[int(np.argmax(e))] for e in en])
    tone_err = float(np.max(np.abs(tones / (10 + 7 * np.arange(C)) - 1)))
    en0, _ = process_recording(rec[[0, C - 1]], transform="ssq_cwt", fs=fs,
                               chunk_len=250_000, out="energy")
    e_sub = float(np.max(np.abs(en0 - en[[0, C - 1]]) / en[[0, C - 1]].max()))
    S20["pipeline energy 64 x 600000"] = dict(
        s=wall, msamples_s=C * NR / wall / 1e6, peak_gb=peak, rows=en.shape[1],
        launches=moved, tone_rel_err=tone_err, vs_two_channel_run=e_sub)
    check(en.shape == (C, len(fr)) and np.isfinite(en).all(),
          f"pipeline energy: {en.shape}")
    check(moved == {"cwt_phase": 3 * C, "reassign": 3 * C},
          f"pipeline energy: launches {moved}")
    check(tone_err < 0.03, f"pipeline energy: tone rows off by {tone_err:.3f}")
    check(e_sub < 1e-5, f"pipeline energy: channel sub-batches {e_sub:.2e}")
    del en, en0
    lap("20 pipeline energy")

    # out='numpy': 8 channels x 60 000 in chunks of 20 000, against the
    # offline ssq_cwt of each channel on the same scales and frequencies
    rec8 = np.ascontiguousarray(rec[:8, :60_000])
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out8, meta8 = process_recording(rec8, transform="ssq_cwt", fs=fs,
                                    chunk_len=20_000)
    wall = time.perf_counter() - t0
    moved = moved_since(before)
    fr8 = meta8["ssq_freqs"]
    cols, peaks = [], []
    for c in range(8):
        Tc = ssq_cwt(torch.as_tensor(rec8[c], device=dev), wavelet,
                     scales=meta8["scales"], ssq_freqs=fr8[::-1].copy(),
                     fs=fs)[0].cpu().numpy()
        cs, cr = np.abs(out8[c]).sum(0), np.abs(Tc).sum(0)
        cols.append(float(np.mean(np.abs(cs - cr) / cr)))
        peaks.append(float(fr8[int(np.abs(out8[c]).mean(-1).argmax())]))
    peak_err = float(np.max(np.abs(np.array(peaks) /
                                   (10 + 7 * np.arange(8)) - 1)))
    S20["pipeline numpy 8 x 60000"] = dict(
        s=wall, msamples_s=8 * 60_000 / wall / 1e6, launches=moved,
        col_rel_vs_offline=cols, tone_rel_err=peak_err)
    check(out8.shape == (8, len(fr8), 60_000) and np.isfinite(out8).all(),
          f"pipeline numpy: {out8.shape}")
    check(max(cols) < 2e-3 and peak_err < 0.03, f"pipeline numpy against "
          f"offline: column marginals {max(cols):.2e}, tones {peak_err:.3f}")
    launches20 = counts()
    lap("20 pipeline numpy")
    # the pipelines' shapes have just run (warm): one profiled call each
    S20["profile pipeline numpy 8 x 60000"] = device_breakdown(
        torch, lambda: process_recording(rec8, transform="ssq_cwt", fs=fs,
                                         chunk_len=20_000),
        (K_A, K_B, K_FFT, K_CPLX, K_D2H, K_H2D), calls=1, warm=True)
    S20["profile pipeline energy 2 x 600000"] = device_breakdown(
        torch, lambda: process_recording(rec[:2], transform="ssq_cwt", fs=fs,
                                          chunk_len=250_000, out="energy"),
        (K_A, K_B, K_FFT, K_CPLX, K_D2H, K_H2D), calls=1, warm=True)
    lap("20 pipeline profiles")
    results["serving"] = S20
    print(f"[20] server ssq_cwt: " + ", ".join(
        f"{n} samples {S20[f'ssq_cwt {n}']['ms']:.1f} ms"
        for n in (3000, 10000, 100000, 160000)) +
        f"; batch 16 x "
        f"10000 {wall_b:.1f} ms vs {wall_s:.1f} ms as singles (rel "
        f"{S20['batch 16 x 10000']['vs_singles']:.1e}); ssq_stft 160k "
        f"{S20['ssq_stft 160000']['ms']:.1f} ms; pipeline energy 64 x 600000 "
        f"{S20['pipeline energy 64 x 600000']['s']:.2f} s = "
        f"{S20['pipeline energy 64 x 600000']['msamples_s']:.2f} MSamples/s, "
        f"peak {peak:.2f} GB; numpy 8 x 60000 col rel vs offline "
        f"{max(cols):.2e}; launches {launches20} ({card}); steady 10k "
        f"request {S20['ssq_cwt 10000 steady_ms']:.1f} ms; profiles: " +
        "; ".join(f"{k[8:]} {breakdown_line(v)}" for k, v in S20.items()
                  if k.startswith("profile")))

    i0 = I["cwt nf=293"]
    return [kernel_entry("reassign_mxu", "reassign_mxu.cu",
                         "reassign_pallas.py:666",
                         launches19["reassign_mxu"], i0["abs_vs_plain"],
                         i0["ms"], i0["plain_ms"],
                         (i0["bound_ms"], i0["bound_by"]), None)]


def probe_phases(np, torch, dev, card, results):
    """Phase 21: the TPU probes' counterparts (kernels P1-P4 of
    ssqueeze_rs_tpu_torch.tools) through their entry points, then each
    kernel against its plain twin. Returns the four kernels' entries of
    the JSON line."""
    from ssqueeze_rs_tpu_torch.ops import fft_cuda, reassign_cuda
    from ssqueeze_rs_tpu_torch.tools import (ablate_cwt_kernel as acw,
                                             ablate_reassign as ar,
                                             bench_reassign_batch as brb,
                                             cwt_kernel_probe as ckp)
    reps = 5

    # the slice's path: each probe's main() as a user runs it, the
    # counts of P1 (ablate_cwt), P2 (copy floor), P3 (staged), P4 zeroed
    # just before and read just after
    acw.LAUNCHES = acw.LAUNCHES_COPY = acw.LAUNCHES_STAGED = ar.LAUNCHES = 0
    rows = {}
    for m in (acw, ckp, ar, brb):
        rows[m.__name__.rsplit(".", 1)[1]] = {r["name"]: r for r in
                                              m.main([str(reps)])}
    launches = dict(ablate_cwt=acw.LAUNCHES, cwt_copy_floor=acw.LAUNCHES_COPY,
                    cwt_staged=acw.LAUNCHES_STAGED, ablate_reassign=ar.LAUNCHES)
    calls = reps + 1          # one warm-up and `reps` timed runs a variant
    expect = dict(
        ablate_cwt=calls * (len(acw.VARIANTS) + len(ckp.MODES)),
        cwt_copy_floor=calls * len(acw.COPY_VARIANTS), cwt_staged=calls,
        ablate_reassign=calls * (len(ar.VARIANTS) + 2 +
                                 len(brb.BATCHES) * (len(ar.GRIDS) + 1)))
    check(launches == expect, f"probe launches {launches}, not {expect}")
    rows_cwt, rows_re = rows["ablate_cwt_kernel"], rows["ablate_reassign"]
    lap("21 probes' entry points")

    def planes_err(k, p):
        """max over planes of max|k - p| / max|p| (0 where both are zero),
        and max|k - p|"""
        d = [float((a - b).abs().max()) for a, b in zip(k, p)]
        top = [float(b.abs().max()) for b in p]
        return (max(x / t if t else (0.0 if x == 0 else float("inf"))
                    for x, t in zip(d, top)), max(d))

    def equal(x, y):
        return len(x) == len(y) and all(torch.equal(a, b)
                                        for a, b in zip(x, y))

    # P1, P3: every variant against its plain twin, each bitwise
    # repeated; P1 full and P3 staged (both D's earlier radix-2 design)
    # bitwise to each other and within 1e-5 of D's plain
    P = {}
    args, keep = acw.make_inputs(dev, **{k: acw.HEADLINE[k]
                                         for k in ("na", "M", "L")})
    full = None
    for v in acw.VARIANTS:
        k1, k2 = acw.ablate_cwt(*args, keep, v), acw.ablate_cwt(*args, keep, v)
        p = acw.ablate_cwt_plain(*args, keep, v)
        err, err_abs = planes_err(k1, p)
        P[v] = dict(rel=err, abs=err_abs, repeat=equal(k1, k2),
                    ms=rows_cwt[v]["ms"], bound_ms=rows_cwt[v]["bound_ms"])
        check(P[v]["repeat"], f"P1 {v} differs between two runs")
        check(err < 1e-5, f"P1 {v}: rel error {err:.3e} >= 1e-5")
        if v == "full":
            full = k1
        del k1, k2, p
    s1, s2 = acw.cwt_staged(*args, keep), acw.cwt_staged(*args, keep)
    D_plain = fft_cuda.cwt_fused_plain(*args, keep=keep, derivative=True)
    full_rel = planes_err(full, D_plain)[0]
    P["staged"] = dict(bitwise_full=equal(s1, full), repeat=equal(s1, s2),
                       rel_D_plain=planes_err(s1, D_plain)[0],
                       ms=rows_cwt["staged"]["ms"],
                       bound_ms=rows_cwt["staged"]["bound_ms"])
    P["full"]["rel_D_plain"] = full_rel
    check(P["staged"]["bitwise_full"] and P["staged"]["repeat"],
          f"P3 staged: bitwise P1 full {P['staged']['bitwise_full']}, "
          f"repeat {P['staged']['repeat']}")
    check(full_rel < 1e-5 and P["staged"]["rel_D_plain"] < 1e-5,
          f"P1 full / P3 staged vs D's plain: {full_rel:.3e} / "
          f"{P['staged']['rel_D_plain']:.3e}")
    del s1, s2, full, D_plain
    plain_full_ms = cuda_ms(torch, lambda: acw.ablate_cwt_plain(*args, keep),
                            warmup=1, iters=reps)
    Pw, xr, xi, xig, inv_dt, nw, nd = args
    Zr, Zi = fft_cuda._cwt_spectra(Pw, xr, xi, xig, inv_dt, True)
    spec = torch.zeros((Zr.shape[0], 2 * Zr.shape[1]), dtype=torch.complex64,
                       device=dev)
    spec[:, :Zr.shape[1]] = torch.complex(Zr, Zi)
    spec[:, Zr.shape[1]] = torch.complex(torch.cat([nw[0], nd[0]]),
                                         torch.cat([nw[1], nd[1]]))
    del Zr, Zi
    ifft_ms = cuda_ms(torch, lambda: torch.fft.ifft(spec, dim=-1), warmup=1,
                      iters=reps)
    del spec

    # P2: exact against the plain copy, repeated
    L = keep[1]
    for v in acw.COPY_VARIANTS:
        k1, k2 = acw.copy_floor(Pw, L, v), acw.copy_floor(Pw, L, v)
        exact = equal(k1, acw.copy_floor_plain(Pw, L, v))
        P[v] = dict(exact=exact, repeat=equal(k1, k2), ms=rows_cwt[v]["ms"],
                    bound_ms=rows_cwt[v]["bound_ms"])
        check(exact and P[v]["repeat"], f"P2 {v}: exact {exact}, repeat "
              f"{P[v]['repeat']}")
        del k1, k2
    copy_plain_ms = cuda_ms(torch, lambda: acw.copy_floor_plain(Pw, L),
                            warmup=1, iters=reps)
    del args, Pw, xr, xi, xig
    lap("21 P1-P3 against their plain twins")

    # P4: full bitwise B' at each column count, every variant against its
    # plain twin, repeated; the grid modes on a batch of 4
    R = {}
    na, nf, n = (ar.HEADLINE[k] for k in ("na", "nf", "n"))
    planes = ar.make_planes(dev, None, na, n)
    rest = (ar.GAMMA, ar.PARAMS, ar.MODE, True, nf, "cwt")
    with scatter_impl("vpu"):
        b4 = reassign_cuda.reassign4(*planes, *rest)
        # B' beside the row walk at the headline, both timed here
        R["B'"] = dict(
            ms=cuda_ms(torch, lambda: reassign_cuda.reassign4(*planes, *rest)),
            walk_ms=cuda_ms(torch, lambda: ar.ablate_reassign(*planes, *rest)),
            cols=reassign_cuda._block_cols(nf))
    for c in (32, 16, 8):
        k1 = ar.ablate_reassign(*planes, *rest, "full", c)
        R[f"full/{c}"] = dict(bitwise_b4=equal(k1, b4),
                              ms=rows_re[f"full/{c}"]["ms"],
                              bound_ms=rows_re[f"full/{c}"]["bound_ms"])
        check(R[f"full/{c}"]["bitwise_b4"],
              f"P4 full at {c} columns a block is not B' bit for bit")
        del k1
    for v in ar.VARIANTS:
        k1, k2 = (ar.ablate_reassign(*planes, *rest, v) for _ in range(2))
        p = ar.ablate_reassign_plain(*planes, *rest, v)
        err, err_abs = planes_err(k1, p)
        R.setdefault(v, {}).update(rel=err, abs=err_abs, exact=equal(k1, p),
                                   repeat=equal(k1, k2),
                                   ms=rows_re.get(v, rows_re["full/32"])["ms"])
        check(R[v]["repeat"], f"P4 {v} differs between two runs")
        check(err <= 1e-5, f"P4 {v}: rel error {err:.3e} > 1e-5")
        del k1, k2, p
    check(R["dmaonly"]["exact"], "P4 dmaonly: Tx planes not zero")
    reassign_plain_ms = cuda_ms(torch, lambda: ar.ablate_reassign_plain(
        *planes, *rest), warmup=1, iters=reps)
    del planes, b4
    pb = ar.make_planes(dev, 4, na, n, seed=1)
    with scatter_impl("vpu"):
        b4 = reassign_cuda.reassign4(*pb, *rest)
    grids = {g: ar.ablate_reassign(*pb, *rest, grid=g) for g in ar.GRIDS}
    grids_equal = all(equal(o, grids["batch2d"]) for o in grids.values())
    grid_err = planes_err(grids["batch2d"], ar.ablate_reassign_plain(
        *pb, *rest))[0]
    R["grids B=4"] = dict(equal=grids_equal, bitwise_b4=equal(
        grids["batch2d"], b4), rel=grid_err, repeat=equal(
        ar.ablate_reassign(*pb, *rest, grid="grid1d"), grids["grid1d"]))
    check(grids_equal and R["grids B=4"]["bitwise_b4"] and
          R["grids B=4"]["repeat"], f"P4 grid modes: {R['grids B=4']}")
    check(grid_err <= 1e-5, f"P4 grid modes against plain: {grid_err:.3e}")
    del pb, b4, grids
    R["batch"] = rows["bench_reassign_batch"]
    lap("21 P4 against its plain twin")

    lanes = R["B'"]
    results["probes"] = dict(launches=launches, cwt=P, reassign=R,
                             plain_ms=dict(full=plain_full_ms,
                                           copy=copy_plain_ms,
                                           reassign=reassign_plain_ms),
                             ifft_ms=ifft_ms,
                             copy_ms=rows_cwt["copy_"]["ms"])
    print("[21] probes: P1 " + ", ".join(
        f"{v} {P[v]['ms']:.3f}/{P[v]['bound_ms']:.3f}"
        for v in acw.VARIANTS) + "; P2 " + ", ".join(
        f"{v} {P[v]['ms']:.3f}/{P[v]['bound_ms']:.3f}"
        for v in acw.COPY_VARIANTS) +
        f" (copy_ {rows_cwt['copy_']['ms']:.3f}); P3 staged "
        f"{P['staged']['ms']:.3f} (ms/bound ms); P1 worst rel "
        f"{max(P[v]['rel'] for v in acw.VARIANTS):.2e}, full and staged "
        f"bitwise equal, vs D's plain {P['full']['rel_D_plain']:.2e} / "
        f"{P['staged']['rel_D_plain']:.2e}; P4 " + ", ".join(
            f"{k} {rows_re[k]['ms']:.3f}/{rows_re[k]['bound_ms']:.3f}"
            for k in rows_re) + f", worst rel "
        f"{max(R[v]['rel'] for v in ar.VARIANTS):.2e}, full bitwise B'; "
        "batches (ms a transform): " + ", ".join(
            f"{k} {r['per_transform_ms']:.3f}"
            for k, r in R["batch"].items()) +
        f", grid modes bitwise equal; launches {launches}; B' "
        f"({lanes['cols']}x16) {lanes['ms']:.3f} ms vs row walk "
        f"{lanes['walk_ms']:.3f} ms ({card})")

    full, cp, st, re = (rows_cwt["full"], rows_cwt["dmaonly"],
                        rows_cwt["staged"], rows_re["full/32"])
    tools = "tools/"
    return [
        kernel_entry("ablate_cwt", "ablate_cwt.cu",
                     "ablate_cwt_kernel.py:359", launches["ablate_cwt"],
                     P["full"]["abs"], full["ms"], plain_full_ms,
                     (full["bound_ms"], full["bound_by"]), ifft_ms,
                     root=tools),
        kernel_entry("cwt_copy_floor", "ablate_cwt.cu",
                     "ablate_cwt_kernel.py:404", launches["cwt_copy_floor"],
                     0.0, cp["ms"], copy_plain_ms,
                     (cp["bound_ms"], cp["bound_by"]),
                     rows_cwt["copy_"]["ms"], root=tools),
        kernel_entry("cwt_staged", "ablate_cwt.cu",
                     "ablate_cwt_kernel.py:311", launches["cwt_staged"],
                     P["full"]["abs"], st["ms"], plain_full_ms,
                     (st["bound_ms"], st["bound_by"]), ifft_ms, root=tools),
        kernel_entry("ablate_reassign", "ablate_reassign.cu",
                     "ablate_reassign.py:225", launches["ablate_reassign"],
                     R["full"]["abs"], re["ms"], reassign_plain_ms,
                     (re["bound_ms"], re["bound_by"]), None, root=tools),
    ]


# bars of the probes' tensor-core products against their plain versions,
# as a share of max|out| (the plain versions sum in float32 in another
# order, and the tensor cores' float32 accumulation truncates)
RATE_BAR = 1e-5


def rate_probe_phases(np, torch, dev, card, results):
    """Phase 22: the last TPU probes' counterparts (J5 mxu_rate_probe, J6
    mxu_probe and mxu_probe2, J7 dma_overlap_probe, J8 grid_slope_probe of
    ssqueeze_rs_tpu_torch.tools) through their entry points, then every
    kernel against its plain version. Returns the seven pallas_call sites'
    entries of the JSON line."""
    from ssqueeze_rs_tpu_torch.tools import (_common,
                                             dma_overlap_probe as dop,
                                             grid_slope_probe as gsp,
                                             mxu_probe as mp,
                                             mxu_probe2 as mp2,
                                             mxu_rate_probe as mrp)
    reps = 5
    calls = 2 * (reps + 1)     # CUDA events and the wall clock: a warm-up
    #                            and `reps` calls each, a case

    def counts():
        return dict(grid_slope=gsp.LAUNCHES, rate_dot=mrp.LAUNCHES_DOT,
                    rate_copy=mrp.LAUNCHES_COPY,
                    rate_chains=mrp.LAUNCHES_CHAINS, mxu_probe=mp.LAUNCHES,
                    dma_overlap=dop.LAUNCHES)

    # the slice's path: each probe's main() as a user runs it, every count
    # zeroed just before and read just after
    gsp.LAUNCHES = mrp.LAUNCHES_DOT = mrp.LAUNCHES_COPY = 0
    mrp.LAUNCHES_CHAINS = mp.LAUNCHES = dop.LAUNCHES = 0
    mains = (("grid_slope", gsp, []), ("rate", mrp, []),
             ("rate_chains", mrp, ["--chains"]), ("mxu_probe", mp, []),
             ("mxu_probe2", mp2, []), ("dma_overlap", dop, []))
    rows, moved = {}, {}
    for key, mod, extra in mains:
        before = counts()
        rows[key] = {r["name"]: r for r in mod.main([str(reps)] + extra)}
        after = counts()
        moved[key] = {k: after[k] - before[k] for k in after
                      if after[k] != before[k]}
    launches = counts()
    n_grid = sum(len(c[4]) for c in gsp.CONFIGS)
    expect = dict(
        grid_slope={"grid_slope": calls * n_grid},
        rate={"rate_dot": calls * len(mrp.SHAPES) * len(mrp.PRECISIONS),
              "rate_copy": calls * len(mrp.COPY_SHAPES)},
        rate_chains={"rate_chains": calls * len(mrp.CHAIN_SHAPES) *
                     len(mrp.CHAINS)},
        mxu_probe={"mxu_probe": calls * len(mp.QUESTIONS)},
        mxu_probe2={"mxu_probe": calls * (len(mp2.QUESTIONS) - 1),
                    "grid_slope": calls},
        dma_overlap={"dma_overlap": calls * len(dop.VARIANTS)})
    check(moved == expect, f"probe launches {moved}, not {expect}")
    lap("22 probes' entry points")

    def equal(a, b):
        return bool(torch.equal(a, b))

    def err(k, p):
        """(max|k - p| / max|p|, max|k - p|)"""
        d = float((k - p).abs().max())
        return d / float(p.abs().max()), d

    # J8: every configuration exact and repeated
    J8 = {}
    g = torch.Generator(device=dev).manual_seed(8)
    for name, r_, L, vary, grids in gsp.CONFIGS:
        x = torch.randn((r_, L), generator=g, device=dev)
        for grid in grids:
            k1, k2 = gsp.grid_slope(x, grid, vary), gsp.grid_slope(x, grid,
                                                                   vary)
            J8[f"{name} g={grid}"] = dict(
                exact=equal(k1, gsp.grid_slope_plain(x, grid, vary)),
                repeat=equal(k1, k2))
    check(all(v["exact"] and v["repeat"] for v in J8.values()),
          f"J8 grid_slope: {J8}")
    # the plain versions and library calls are timed as the probes time
    # their kernels: the runs queued ahead of the card (`_common.time_ms`),
    # so a call shorter than the host's launch work is not timed by it
    qms = lambda fn: _common.time_ms(fn, dev, reps)
    x = torch.randn((8, 128), generator=g, device=dev)
    g_last = gsp.CONFIGS[0][4][-1]
    grid_plain_ms = qms(lambda: gsp.grid_slope_plain(x, g_last, False))
    grid_lib_ms = qms(lambda: torch.add(x, 1))

    # J5: every shape and precision, the copies exact, the chains
    J5 = {}
    m, k, n = 1024, 512, 512                   # the entries' case
    for (mm, kk, nn) in mrp.SHAPES:
        A = torch.randn((2 * mm, kk), generator=g, device=dev)
        B = torch.randn((kk, nn), generator=g, device=dev)
        for p in mrp.PRECISIONS:
            k1 = mrp.dot_probe(A, B, mm, p)
            pl = mrp.dot_probe_plain(A, B, mm, p)
            e, d = err(k1, pl)
            J5[f"dot {p} ({mm},{kk},{nn})"] = dict(
                rel=e, abs=d, repeat=equal(k1, mrp.dot_probe(A, B, mm, p)))
            check(e < RATE_BAR and J5[f"dot {p} ({mm},{kk},{nn})"]
                  ["repeat"], f"J5 dot {p} ({mm},{kk},{nn}): rel {e:.3e}, "
                  f"repeat {J5[f'dot {p} ({mm},{kk},{nn})']['repeat']}")
        if (mm, kk, nn) == (m, k, n):
            # the plain version over the kernel's GRID copies, as its time,
            # bound and library call count them
            dot_plain_ms = qms(lambda: [mrp.dot_probe_plain(A, B, m, "bf16")
                                        for _ in range(mrp.GRID)])
            lib = {}
            Acat = torch.cat([A[(i % 2) * m:(i % 2 + 1) * m]
                              for i in range(mrp.R)], 1)
            Acat = Acat.repeat(mrp.GRID, 1)          # (GRID m, R k)
            Brep = B.repeat(mrp.R, 1)                # (R k, n)
            a16, b16 = Acat.to(torch.bfloat16), Brep.to(torch.bfloat16)
            lib["bf16"] = qms(lambda: torch.matmul(a16, b16))
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                lib["tf32"] = qms(lambda: torch.matmul(Acat, Brep))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            lib["f32"] = qms(lambda: torch.matmul(Acat, Brep))
            del Acat, Brep, a16, b16
    for (mm, nn) in mrp.COPY_SHAPES:
        A = torch.randn((2 * mm, nn), generator=g, device=dev)
        k1 = mrp.copy_probe(A, mm)
        J5[f"copy ({mm},{nn})"] = dict(
            exact=equal(k1, mrp.copy_probe_plain(A, mm)),
            repeat=equal(k1, mrp.copy_probe(A, mm)))
        check(J5[f"copy ({mm},{nn})"]["exact"] and
              J5[f"copy ({mm},{nn})"]["repeat"], f"J5 copy ({mm},{nn})")
    copy_plain_ms = qms(lambda: [mrp.copy_probe_plain(A, mm)
                                 for _ in range(mrp.GRID)])
    w = torch.full((1, 2), mrp.R / 2, device=dev)
    copy_lib_ms = qms(lambda: torch.matmul(w, A.view(2, -1)))
    C8 = 8
    for (mm, kk, nn) in mrp.CHAIN_SHAPES:
        B = torch.randn((kk, nn), generator=g, device=dev)
        for C in mrp.CHAINS:
            A = torch.randn(((C + 1) * mm, kk), generator=g, device=dev)
            k1 = mrp.dot_probe_chains(A, B, mm, C)
            e, d = err(k1, mrp.dot_probe_chains_plain(A, B, mm, C))
            key = f"chains C={C} ({mm},{kk},{nn})"
            J5[key] = dict(rel=e, abs=d, repeat=equal(
                k1, mrp.dot_probe_chains(A, B, mm, C)))
            check(e < RATE_BAR and J5[key]["repeat"],
                  f"J5 {key}: rel {e:.3e}, repeat {J5[key]['repeat']}")
            if (mm, kk, nn, C) == (m, k, n, C8):
                chains_plain_ms = qms(lambda: [mrp.dot_probe_chains_plain(
                    A, B, m, C8) for _ in range(mrp.GRID)])
                Acat = torch.stack([torch.cat(
                    [A[((i + c) % (C8 + 1)) * m:((i + c) % (C8 + 1) + 1) * m]
                     for i in range(mrp.R)], 1) for c in range(C8)])
                a16 = Acat.repeat(mrp.GRID, 1, 1).to(torch.bfloat16)
                b16 = B.repeat(mrp.R, 1).to(torch.bfloat16)
                chains_lib_ms = qms(lambda: torch.matmul(a16, b16))
                del Acat, a16, b16
    del A, B
    lap("22 J5, J8 against their plain versions")

    # J7 against the plain loop: within 1e-3 of max|out| at R = 1, 1e-2 at
    # R = 3 and 0.1 at R = 64 (the bf16 re-rounding of each product's input
    # parts the two chains: 2.9e-3 after 9 products, 1.5e-2 after 192),
    # there finite, of order 1 and repeated; `copies` exact throughout.
    # With b = 1000 P (P a random permutation) each product is one exact
    # term, so kernel and plain round alike: bitwise equal at R = 3 and 64,
    # which holds the state carried from one iteration to the next
    J7 = {}
    H = dop.HEADLINE
    src, a, b = dop.make_inputs(dev, H["R"], H["CH"], H["M"])
    run7 = dict(CH=H["CH"], D=H["D"])
    bp = torch.zeros_like(b)
    bp[torch.randperm(H["M"], generator=g, device=dev),
       torch.arange(H["M"], device=dev)] = 1000.0
    for v in dop.VARIANTS:
        for R_, bar in ((1, 1e-3), (3, 1e-2)):
            e_, d_ = err(dop.dma_overlap(src, a, b, v, R_, **run7),
                         dop.dma_overlap_plain(src, a, b, v, R_, **run7))
            J7.setdefault(v, {}).update({f"rel_r{R_}": e_, f"abs_r{R_}": d_})
            check(e_ == 0 if v == "copies" else e_ < bar,
                  f"J7 {v} at R = {R_}: rel {e_:.3e}")
        for R_ in (3, H["R"]):
            k1 = dop.dma_overlap(src, a, bp, v, R_, **run7)
            J7[v][f"exact_perm_r{R_}"] = equal(
                k1, dop.dma_overlap_plain(src, a, bp, v, R_, **run7))
            check(J7[v][f"exact_perm_r{R_}"] and 0.1 < float(
                k1.abs().max()) < 100, f"J7 {v}, b = 1000 P, at R = {R_}: "
                f"{J7[v]}")
        k1, k2 = (dop.dma_overlap(src, a, b, v, H["R"], **run7)
                  for _ in range(2))
        p = dop.dma_overlap_plain(src, a, b, v, H["R"], **run7)
        e, d = err(k1, p)
        top = float(k1.abs().max())
        J7[v].update(rel=e, abs=d, max=top, repeat=equal(k1, k2),
                     finite=bool(torch.isfinite(k1).all()))
        check(J7[v]["repeat"] and J7[v]["finite"] and 1e-3 < top < 1e3 and
              (e == 0 if v == "copies" else e < 0.1),
              f"J7 {v} at R = 64: {J7[v]}")
    overlap_plain_ms = qms(lambda: dop.dma_overlap_plain(
        src, a, b, "both", H["R"], **run7))
    del src, a, b
    ms = {v: rows["dma_overlap"][v]["ms"] for v in dop.VARIANTS}
    s_, m_, word = dop.verdict(ms)
    J7["verdict"] = dict(sum=s_, max=m_, word=word,
                         hidden=(s_ - ms["both"]) / ms["copies"])

    # J6: every question against its plain version at the headline
    J6 = {}
    lib6 = {}
    for tag, mod in (("a", mp), ("b", mp2)):
        size = mod.HEADLINE
        inp = mod.make_inputs(dev, size)
        for q in mod.QUESTIONS:
            k1, k2 = mod.question(q, inp, size), mod.question(q, inp, size)
            p = mod.question(q, inp, size, plain=True)
            e, d = err(k1, p) if float(p.abs().max()) else (
                float(k1.abs().max()), float(k1.abs().max()))
            J6[f"{tag} {q}"] = dict(rel=e, abs=d, exact=equal(k1, p),
                                    repeat=equal(k1, k2))
            dots = q in ("q_dots", "q_dots4", "q_bigdot", "q_batch")
            check(J6[f"{tag} {q}"]["repeat"] and
                  (e < RATE_BAR if dots else J6[f"{tag} {q}"]
                   ["exact"]), f"J6{tag} {q}: {J6[f'{tag} {q}']}")
        steps = size["GRID"] * size["NG"]
        Af, Bf = (t.to(torch.float32) for t in (inp["A"], inp["B"]))

        def every_step():
            """plain q_dots doing each step's product, as the kernel, its
            bound and the library call do"""
            acc = torch.zeros((Af.shape[0], Bf.shape[1]), device=dev)
            for _ in range(steps):
                acc = acc + Af @ Bf
            return acc
        e = err(every_step(), mod.question("q_dots", inp, size, plain=True))
        check(e[0] < RATE_BAR, f"J6{tag} q_dots: the plain loop over every "
              f"step off by {e[0]:.3e}")
        J6[f"{tag} plain_ms"] = qms(every_step)
        Arep = inp["A"].repeat(1, steps)
        Brep = inp["B"].repeat(steps, 1)
        lib6[f"{tag} q_dots"] = qms(lambda: torch.matmul(Arep, Brep))
        del Arep, Brep
        if tag == "a":
            grid = size["GRID"]
            A2 = inp["A2"].repeat(grid, 1)
            lib6["a q_bigdot"] = qms(lambda: torch.matmul(A2, inp["B2"]))
            Ab, Bb = inp["Ab"].repeat(grid, 1, 1), inp["Bb"].repeat(grid, 1,
                                                                    1)
            lib6["a q_batch"] = qms(lambda: torch.bmm(Ab, Bb))
            del A2, Ab, Bb
        lib6[f"{tag} q_trans"] = qms(lambda: inp["K32"].t().contiguous())
        del inp
    lap("22 J6, J7 against their plain versions")

    results["rate_probes"] = dict(
        launches=launches, moved=moved, J5=J5, J6=J6, J7=J7, J8=J8,
        library=dict(dot=lib, copy=copy_lib_ms, chains=chains_lib_ms,
                     grid=grid_lib_ms, j6=lib6),
        rows={k: list(v.values()) for k, v in rows.items()},
        slopes=gsp.slopes(list(rows["grid_slope"].values())))
    rr = rows["rate"]
    worst = {p: max(v["rel"] for key, v in J5.items()
                    if key.startswith(f"dot {p} ")) for p in mrp.PRECISIONS}
    chains = rows["rate_chains"]
    print("[22] rate probes: J5 (1024,512,512) " + ", ".join(
        f"{p} {rr[f'dot {p} ({m},{k},{n})']['ms']:.3f} ms "
        f"({rr[f'dot {p} ({m},{k},{n})']['tflop_s']:.1f} TFLOP/s, "
        f"worst rel {worst[p]:.1e})" for p in mrp.PRECISIONS) +
        f"; copy (1024,4096) {rr['copy f32 (1024,4096)']['ms']:.3f} ms "
        f"({rr['copy f32 (1024,4096)']['smem_tb_s']:.1f} TB/s on chip); "
        "chains (1024,512,512) us a dot " + ", ".join(
            f"C={C} {chains[f'chains C={C} ({m},{k},{n})']['us_per_dot']:.2f}"
            for C in mrp.CHAINS) + "; J6 " + ", ".join(
            f"{q} {rows['mxu_probe'][q]['ms']:.3f}" for q in mp.QUESTIONS) +
        " / " + ", ".join(f"{q} {rows['mxu_probe2'][q]['ms']:.3f}"
                          for q in mp2.QUESTIONS) +
        f" ms; J7 copies {ms['copies']:.3f}, dots {ms['dots']:.3f}, both "
        f"{ms['both']:.3f} ms -> {word} (copies hidden "
        f"{J7['verdict']['hidden']:.0%}); J8 per block (events/wall us) " +
        ", ".join(f"{k} " + "/".join(f"{u:.4f}" for u in v)
                  for k, v in results["rate_probes"]["slopes"].items()) +
        f"; element questions, copies and J8 exact; launches {launches} "
        f"({card})")

    tools = "tools/"
    rd = rr[f"dot bf16 ({m},{k},{n})"]
    rc = rr["copy f32 (1024,4096)"]
    rch = rows["rate_chains"][f"chains C={C8} ({m},{k},{n})"]
    q1, q2 = rows["mxu_probe"]["q_dots"], rows["mxu_probe2"]["q_dots"]
    ov = rows["dma_overlap"]["both"]
    gs = rows["grid_slope"][f"tiny const g={g_last}"]
    bnd = lambda r: (r["bound_ms"], r["bound_by"])
    return [
        kernel_entry("rate_dot", "rate_probe.cu", "mxu_rate_probe.py:47",
                     launches["rate_dot"],
                     J5[f"dot bf16 ({m},{k},{n})"]["abs"], rd["ms"],
                     dot_plain_ms, bnd(rd), lib["bf16"], root=tools),
        kernel_entry("rate_copy", "rate_probe.cu", "mxu_rate_probe.py:70",
                     launches["rate_copy"], 0.0, rc["ms"], copy_plain_ms,
                     bnd(rc), copy_lib_ms, root=tools),
        kernel_entry("rate_chains", "rate_probe.cu", "mxu_rate_probe.py:153",
                     launches["rate_chains"],
                     J5[f"chains C={C8} ({m},{k},{n})"]["abs"], rch["ms"],
                     chains_plain_ms, bnd(rch), chains_lib_ms, root=tools),
        kernel_entry("mxu_probe", "mxu_probe.cu", "mxu_probe.py:56",
                     moved["mxu_probe"]["mxu_probe"], J6["a q_dots"]["abs"],
                     q1["ms"], J6["a plain_ms"], bnd(q1), lib6["a q_dots"],
                     root=tools),
        kernel_entry("mxu_probe2", "mxu_probe.cu", "mxu_probe2.py:44",
                     moved["mxu_probe2"]["mxu_probe"],
                     J6["b q_dots"]["abs"], q2["ms"], J6["b plain_ms"],
                     bnd(q2), lib6["b q_dots"], root=tools),
        # no one PyTorch call races a copy against a chain of products;
        # the error is that of the timed case, R = 64
        kernel_entry("dma_overlap", "dma_overlap.cu",
                     "dma_overlap_probe.py:88", launches["dma_overlap"],
                     J7["both"]["abs"], ov["ms"], overlap_plain_ms,
                     bnd(ov), None, root=tools),
        kernel_entry("grid_slope", "grid_slope.cu", "grid_slope_probe.py:50",
                     launches["grid_slope"], 0.0, gs["ms"],
                     grid_plain_ms, bnd(gs), grid_lib_ms, root=tools),
    ]


# phase 23: the component-separation workflow at the headline length, and
# the ridge on the card against the CPU on Tx's first columns
N_SEP = N
RIDGE_COLS = 16_384
RIDGE_PROFILE_COLS = 2048
SEP_WAVELET = ("gmw", {"beta": 6.0})


def wall_ms(torch, fn):
    """(fn(), its host ms up to a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def component_phases(np, torch, dev, card, results, ctx):
    """Phase 23: examples/component_separation.py on the card (ssq_cwt ->
    extract_ridges -> issq_cwt), the ridge against the CPU, `algos` on the
    headline planes (kernels B and B') and the TKEO. Returns the launches
    of B and B' on its paths, for their entries of the JSON line."""
    from ssqueeze_rs_tpu_torch import (TestSignals, algos, cwt,
                                       extract_ridges, issq_cwt, mad_rms,
                                       ssq_cwt, tkeo, tkeo_modified)
    from ssqueeze_rs_tpu_torch.config import EPS32
    from ssqueeze_rs_tpu_torch.ops import fft_cuda, reassign_cuda as R
    from ssqueeze_rs_tpu_torch.ops.ssqueeze import plan_ssqueeze

    def zero_counts():
        fft_cuda.LAUNCHES = fft_cuda.LAUNCHES_D = fft_cuda.LAUNCHES_E = 0
        R.LAUNCHES = R.LAUNCHES4 = R.LAUNCHES_MXU = 0

    def counts():
        return dict(cwt_phase=fft_cuda.LAUNCHES, cwt_fused=fft_cuda.LAUNCHES_D,
                    ifft_halfband=fft_cuda.LAUNCHES_E, reassign=R.LAUNCHES,
                    reassign4=R.LAUNCHES4, reassign_mxu=R.LAUNCHES_MXU)

    out = {}
    path_launches = {"reassign": 0, "reassign4": 0}
    rkw = dict(penalty=2.0, n_ridges=2, bw=25)

    # (a) the workflow: a sine and a linear chirp at the example's
    # fractions of the band (its frequencies times N_SEP / 2048)
    n, k = N_SEP, N_SEP / 2048
    ts = TestSignals(n)
    x1, _ = ts.sine(n, f=64 * k)
    x2, t2 = ts.lchirp(n, fmin=128 * k, fmax=400 * k)
    f_known = (np.full(n, 64 * k / n),            # cycles a sample
               TestSignals.lchirp_fn(t2, 0, 1, 128 * k, 400 * k,
                                     get_w=True)[1] / (2 * np.pi) / (n - 1))
    x = torch.as_tensor((x1 + x2).astype(np.float32), device=dev)
    ssq_cwt(x, SEP_WAVELET)                        # plans and caches, once
    zero_counts()
    (Tx, _, ssq_freqs, scales), ms_ssq = wall_ms(
        torch, lambda: ssq_cwt(x, SEP_WAVELET))
    cc, ms_ridge = wall_ms(torch, lambda: extract_ridges(Tx, ssq_freqs,
                                                         **rkw))
    cw = np.full_like(cc, 20)
    xrec, ms_issq = wall_ms(torch, lambda: issq_cwt(Tx, SEP_WAVELET, cc, cw))
    moved = counts()
    path_launches["reassign"] += moved["reassign"]
    path_launches["reassign4"] += moved["reassign4"]
    check(moved == dict(cwt_phase=1, cwt_fused=0, ifft_halfband=0,
                        reassign=1, reassign4=0, reassign_mxu=0),
          f"component separation: launches {moved}")
    check(Tx.is_cuda and xrec.is_cuda, "component separation left the GPU")
    check(bool(torch.isfinite(Tx).all()), "component separation: Tx not "
          "finite")
    xrec = xrec.cpu().numpy()
    errs = [[mad_rms(src, xrec[j]) for j in range(2)] for src in (x1, x2)]
    pick = [int(np.argmin(e)) for e in errs]
    sep_err = [errs[0][pick[0]], errs[1][pick[1]]]
    # each interior column: one ridge within 5 % of the sine's frequency,
    # the other within 5 % of the chirp's (the two may trade places)
    edge = int(0.02 * n)
    fr = np.asarray(ssq_freqs)[cc[edge:n - edge]]
    f1, f2 = (f[edge:n - edge] for f in f_known)
    near = lambda f, g: np.abs(f - g) <= 0.05 * g          # noqa: E731
    on_ridge = ((near(fr[:, 0], f1) & near(fr[:, 1], f2)) |
                (near(fr[:, 0], f2) & near(fr[:, 1], f1)))
    rel_f = np.minimum(
        np.maximum(np.abs(fr[:, 0] - f1) / f1, np.abs(fr[:, 1] - f2) / f2),
        np.maximum(np.abs(fr[:, 0] - f2) / f2, np.abs(fr[:, 1] - f1) / f1))
    prof_ssq = device_breakdown(torch, lambda: ssq_cwt(x, SEP_WAVELET),
                                (K_A, K_B, K_FFT, K_CPLX, K_PAD))
    prof_issq = device_breakdown(torch, lambda: issq_cwt(Tx, SEP_WAVELET, cc,
                                                         cw), ())
    Tp = Tx[:, :RIDGE_PROFILE_COLS].contiguous()
    prof_ridge = device_breakdown(
        torch, lambda: extract_ridges(Tp, ssq_freqs, **rkw), (), calls=1)
    out["workflow"] = dict(
        n=n, rows=int(Tx.shape[0]), ms=dict(ssq_cwt=ms_ssq,
                                            extract_ridges=ms_ridge,
                                            issq_cwt=ms_issq),
        ridge_us_per_column=ms_ridge * 1e3 / n, mad_rms=sep_err,
        component_of=pick, freq_on_ridge=float(on_ridge.mean()),
        freq_rel_max=float(rel_f.max()), launches=moved,
        profile=dict(ssq_cwt=prof_ssq, issq_cwt=prof_issq,
                     extract_ridges_cols=RIDGE_PROFILE_COLS,
                     extract_ridges=prof_ridge))
    print(f"[23] component separation N={n} ({Tx.shape[0]} rows, "
          f"{SEP_WAVELET}): ssq_cwt {ms_ssq:.2f} ms, extract_ridges "
          f"{ms_ridge:.1f} ms ({ms_ridge * 1e3 / n:.2f} us a column, 2 "
          f"ridges), issq_cwt {ms_issq:.2f} ms; mad_rms sine "
          f"{sep_err[0]:.3f}, chirp {sep_err[1]:.3f} (components {pick}); "
          f"ridges within 5 % of both known frequencies on "
          f"{on_ridge.mean():.6f} of the interior (worst {rel_f.max():.3f}); "
          f"launches {moved}; profiles: ssq_cwt {breakdown_line(prof_ssq)}; "
          f"issq_cwt {breakdown_line(prof_issq)}; extract_ridges at "
          f"{RIDGE_PROFILE_COLS} columns {breakdown_line(prof_ridge)} ({card})")
    check(max(sep_err) < 0.5 and pick[0] != pick[1],
          f"component separation mad_rms {sep_err}, components {pick}")
    check(on_ridge.all(), f"ridges off the known frequencies on "
          f"{int((~on_ridge).sum())} interior columns (worst rel "
          f"{rel_f.max():.3f})")

    # (b) the ridge on the card against the CPU run on the same Tx's first
    # RIDGE_COLS columns
    Tc = Tx[:, :RIDGE_COLS].contiguous()
    cc_g, ms_g = wall_ms(torch, lambda: extract_ridges(Tc, ssq_freqs, **rkw))
    Tc_cpu = Tc.cpu()
    t0 = time.perf_counter()
    cc_c = cpu_ref(torch, lambda: extract_ridges(Tc_cpu, ssq_freqs, **rkw))
    ms_c = (time.perf_counter() - t0) * 1e3
    same = float((cc_g == cc_c).mean())
    out["ridge_vs_cpu"] = dict(cols=RIDGE_COLS, equal_frac=same,
                               gpu_ms=ms_g, cpu_ms=ms_c,
                               gpu_us_per_column=ms_g * 1e3 / RIDGE_COLS,
                               cpu_us_per_column=ms_c * 1e3 / RIDGE_COLS)
    print(f"[23] extract_ridges on {RIDGE_COLS} columns: card == CPU on "
          f"{same:.6f} of the indices; card {ms_g:.1f} ms "
          f"({ms_g * 1e3 / RIDGE_COLS:.2f} us a column), CPU one thread "
          f"{ms_c:.1f} ms ({ms_c * 1e3 / RIDGE_COLS:.2f} us a column) "
          f"({card})")
    if same < 1:
        diff = np.argwhere(cc_g != cc_c)
        check(False, f"ridge on the card differs from the CPU at "
              f"{len(diff)} entries (columns {diff[:, 0].min()}.."
              f"{diff[:, 0].max()}, ridges {sorted(set(diff[:, 1]))})")
    del Tx, Tc, Tp, xrec

    # (c) algos on the headline planes: indexed_sum_onfly (B) and
    # ssqueeze_fast (B') against their plain versions, bitwise repeats
    wavelet, hscales = ctx["wavelet"], ctx["scales"]
    xh = ctx["requests"]["noise"][0]
    nh = xh.shape[-1]
    Wx, _, dWx = cwt(xh, wavelet, scales=hscales, derivative=True)
    na = Wx.shape[-2]
    freqs, const_arr, mode, params = plan_ssqueeze(
        nh, na, None, hscales, fs=1.0, maprange="peak", wavelet=wavelet)
    const = torch.as_tensor(const_arr, dtype=torch.float32, device=dev)
    gamma = 10 * EPS32
    w = algos.phase_cwt_gpu(Wx, dWx, gamma)
    onfly = lambda: algos.indexed_sum_onfly(            # noqa: E731
        Wx, w, freqs, const_arr, logscale=True, flipud=True)
    fast = lambda: algos.ssqueeze_fast(                 # noqa: E731
        Wx, dWx, freqs, const_arr, logscale=True, flipud=True, gamma=gamma)
    zero_counts()
    T_on = onfly()
    T_fast = fast()
    torch.cuda.synchronize()
    moved = counts()
    path_launches["reassign"] += moved["reassign"]
    path_launches["reassign4"] += moved["reassign4"]
    check(moved == dict(cwt_phase=0, cwt_fused=0, ifft_halfband=0,
                        reassign=1, reassign4=1, reassign_mxu=0),
          f"algos: launches {moved}")
    rep_on = torch.equal(onfly(), T_on)
    rep_fast = torch.equal(fast(), T_fast)
    P_on = torch.complex(*R.reassign_plain(Wx.real, Wx.imag, w, const, params,
                                           mode, True, na))
    P_fast = torch.complex(*R.reassign4_plain(
        Wx.real, Wx.imag, dWx.real, dWx.imag, const,
        torch.zeros(na, device=dev), gamma, params, mode, True, na, "cwt"))
    rel_on, rel_fast = rel(torch, T_on, P_on), rel(torch, T_fast, P_fast)
    ms_on, ms_fast = cuda_ms(torch, onfly), cuda_ms(torch, fast)
    prof_on = device_breakdown(torch, onfly, (K_B,))
    prof_fast = device_breakdown(torch, fast, (K_B,))
    # indexed_sum: one scatter_add_ a row, in row order; bitwise over 5
    # calls, and against a float64 sum
    a = Wx.abs()
    kb = R.bin_indices(w, mode, params, True, na).clamp(min=0)
    sums = [algos.indexed_sum(a, kb) for _ in range(5)]
    rep_sum = all(torch.equal(s_, sums[0]) for s_ in sums[1:])
    ref64 = torch.zeros(a.shape, dtype=torch.float64, device=dev).scatter_add_(
        0, kb, a.double())
    rel_sum = float((sums[0].double() - ref64).abs().max() /
                    ref64.abs().max())
    ms_sum = cuda_ms(torch, lambda: algos.indexed_sum(a, kb), iters=5)
    try:
        algos.indexed_sum_onfly(Wx[:, :1000].to(torch.complex128),
                                w[:, :1000], freqs)
        raised = False
    except NotImplementedError:
        raised = True
    out["algos"] = dict(rows=na, onfly_rel=rel_on, fast_rel=rel_fast,
                        onfly_repeat=rep_on, fast_repeat=rep_fast,
                        onfly_ms=ms_on, fast_ms=ms_fast,
                        profile=dict(indexed_sum_onfly=prof_on,
                                     ssqueeze_fast=prof_fast),
                        indexed_sum_repeat=rep_sum, indexed_sum_rel64=rel_sum,
                        indexed_sum_ms=ms_sum, float64_raises=raised,
                        launches=moved)
    print(f"[23] algos on the headline planes ({na} x {nh}): "
          f"indexed_sum_onfly (B) rel {rel_on:.2e} vs plain, repeat "
          f"{rep_on}, {ms_on:.3f} ms ({breakdown_line(prof_on)}); "
          f"ssqueeze_fast (B') rel {rel_fast:.2e}, repeat {rep_fast}, "
          f"{ms_fast:.3f} ms ({breakdown_line(prof_fast)}); indexed_sum "
          f"bitwise over 5 calls {rep_sum}, vs float64 {rel_sum:.2e}, "
          f"{ms_sum:.3f} ms; float64 raises {raised}; launches {moved} "
          f"({card})")
    check(rel_on <= 1e-5 and rel_fast <= 1e-5,
          f"algos vs plain: onfly {rel_on:.2e}, fast {rel_fast:.2e}")
    check(rep_on and rep_fast and rep_sum, "algos differ between runs")
    check(rel_sum < 1e-6, f"indexed_sum vs float64 {rel_sum:.2e}")
    check(raised, "algos took a float64 CUDA input")
    del Wx, dWx, w, T_on, T_fast, P_on, P_fast, a, kb, sums, ref64

    # (d) the TKEO on the card against the CPU
    xb = torch.stack([xh, xh.flip(0)])
    tk = {}
    for name, fn in (("tkeo", tkeo), ("tkeo_modified", tkeo_modified)):
        g = fn(xb)
        c = cpu_ref(torch, lambda: fn(xb.cpu()))
        check(g.is_cuda, f"{name} left the GPU")
        tk[name] = rel(torch, g.cpu(), c)
    out["tkeo_rel"] = tk
    print(f"[23] tkeo on (2, {nh}): card vs CPU rel " + ", ".join(
        f"{k_} {v:.2e}" for k_, v in tk.items()) + f" ({card})")
    check(all(v <= 5e-6 for v in tk.values()), f"tkeo card vs CPU {tk}")
    results["components"] = out
    return path_launches


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
