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
kernel layer (`algos`) at the same length; then the float64 routes: the
drop-in `compat` API at N = 160 000 and `ssq_cwt(dtype='float64')` at the
headline, through kernels B, B', C and C' in double, and `cache_wavelet`;
last the scatter past the bins one launch takes (`ssq_stft` at n_fft =
8192, `ssq_cwt` with 5000 ssq_freqs) and the sharded `chunked_*`
transforms of `parallel` on a mesh that lists the card four times; and
then `process_recording` from a raw file through the native host
runtime (`native`: the memory-mapped reader and its C++ prefetch ring).
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
     P4's walk at 3 planes); timed the same way beside the row walk, the
     median and spread of five such medians, with its columns a block
  5. three requests through ssq_cwt (white noise, a 100 Hz sine at
     fs = 1000, a linear chirp): each kernel launched once per request,
     finite Tx, the sine's peak within 1 % of 100 Hz, issq_cwt of the
     sine, end-to-end time; then the device result against the CPU
     (plain-torch) result for a batch of two signals at N = 20 000
  6. kernels B and B' at nf = 1025 (STFT planes at n_fft = 2048,
     N = 20 000; 8 columns x 16 lanes a block) against their plain
     versions: every entry within 1e-5 max|Tx|, bitwise repeat, bitwise
     the row walk (P4's walk at 3 and 4 planes), timed beside it
  7. kernel F (stft_dft, the Bluestein transform on the register-radix
     core) against plain F at the STFT width, derivative off (600 rows)
     and on (1200 rows): max|dS| / max|S| < 2e-6, bitwise repeat, both
     against the dense product in float64; timed beside torch.stft and its
     bound (the function's real FFTs and bytes); the same checks untimed at
     n_fft = 599 (a prime)
  8. kernel B' (reassign4, lin bins, nf = 300) on F's planes against plain
     B': every entry within 1e-5 max|Tx|, column sums within 1e-5,
     bitwise repeat and bitwise the row walk (P4's walk); timed beside it
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
 18. kernel I (reassign_mxu, the digit-split wgmma scatter, reached
     through reassign4 under SSQ_TPU_REASSIGN_IMPL=mxu) against its plain
     version and against B' on D's ssq_cwt planes (293 x 160 000, nf =
     293) and on F's STFT planes at n_fft = 598 (nf = 300) and 2048 (nf =
     1025, N = 20 000), timed beside B' and its bound (B''s: the same
     function); then untimed at the edges of its plan: n_fft = 14 (nf = 8,
     the narrowest wgmma), 510 (nf = 256), 2046 (nf = 1024), seeded planes
     at nf = 2048 and 2049 (two warpgroups a column) and 2689 (four), and
     a batch of two at n_fft = 598: sum |d| / sum |ref| < 2e-5 and nonzero
     patterns equal on >= 99.99 %, bitwise repeat, the gradient through I
     bitwise the one through B'; and a line with the HGMMA count of each
     of I's instantiations in the built library's SASS (cuobjdump)
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
     ablation of kernel D's launch pair, probes P1-P3; the coarse split of
     D; the ablation of kernel B', P4; B' over batches of 4 and 8 in three
     grid modes), each main() run as a user would, K = 5, with the launch
     counts of P1-P4 read around them; then every variant against its
     plain twin at the headline: planes within 1e-5 of their largest
     value, the copy and zero variants exact, P1's full bitwise D
     (cwt_fused with the derivative) and timed beside it (within 5 %),
     nochunk and P3 (TMA-fed launch 1, its blocks an SM and registers
     read) bitwise P1 full and within 1e-5 of D's plain version per
     plane, each P1 variant's and P3's two launches timed by
     torch.profiler; P2 (TMA bulk copies) equal to its plain version,
     timed beside `copy_` at the same bytes and the same function as one
     PyTorch call (`F.pad`, the kernels line's library time); P4 (B''s
     scatter under ablation flags): full at 32, 16 and 8 columns a block
     bitwise B' (reassign4 under 'vpu') and its 3-plane full bitwise B
     (reassign), serial, noprefetch and walk bitwise full, dmaonly and
     dmarows zero, every variant within 1e-5 of its plain version and
     bitwise repeated, the three grid modes bitwise equal and bitwise B'
     on a batch of 4; B' timed beside the row walk at the headline
 22. the last TPU probes' entry points (J5 mxu_rate_probe and its
     --chains, J6 mxu_probe and mxu_probe2, J7 dma_overlap_probe, J8
     grid_slope_probe), each main() run as a user would, K = 5, the launch
     counts read around each; then every kernel against its plain version
     at the probes' shapes: J8 (every configuration, the launch floor's
     tile and three edge tiles, in both modes and both store routes), the
     copy, J7 copies and J6's element questions exact; J8's persistent
     plan on the card equal to its mirror (grid_slope_probe.plan), one
     chunk load a block, and every FADD of its four kernels inside a loop
     of their SASS (the adds are not folded across steps); the dots
     (every shape and precision, and an edge shape off every tile and
     box, (200, 72, 136), at GRID and at an odd
     grid, which runs unclustered), the chains and J6's dots within
     RATE_BAR of max|out|; J5's operand pre-pass bitwise its plain model,
     and timed alone; J5 at an odd grid (unclustered) timed beside the
     clustered rows; the copy at (1024, 4096), by its device time in
     torch.profiler: at GRID 32 at least 1.8x its time at GRID 16, both
     past its time at R = 0, and each copy between them no faster than
     the lanes add (its copies are not folded); J7 dots and both
     within 1e-3 of max|out| at R = 1, 1e-2 at 3, 0.1 at 64 (there finite
     and of order 1), bitwise with b a scaled permutation at R = 3 and 64
     (each product exact); J7's launch plan on the card equal to its
     mirror (dma_overlap_probe.plan) and its three variants checked as
     above and timed at both cluster sizes (8 and 16 blocks a group of
     rows, with the clusters the card holds at once); every kernel
     bitwise repeated; J6's dots: the kernel's unit plan equal to its
     mirror (mxu_probe.dots_plan), q_dots
     bitwise the float32 sum of one-step dots in step order (3 steps and
     each headline's GRID NG), five edge shapes (J6_EDGES) within
     RATE_BAR, units, warpgroups an SM and TFLOP/s printed; the plain
     versions timed over the kernels' GRID copies (J6: every step's
     product); the library yardsticks of the same work (torch.matmul of
     the same total product in bf16, TF32 and float32, J5's copy weights
     over its GRID copies, torch.bmm, .t().contiguous(), torch.add, the
     last equal to J8 in both modes); J8's entry carries its launch floor,
     its `blocks` time and both store routes' times, and the row-out
     plane's (293 steps) time and bound
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
     of a float64 sum; a complex128 input runs B in double (once, within
     1e-12 of its float64 plain version). tkeo and tkeo_modified on the
     card against the CPU, 5e-6 relative
 24. the float64 routes: kernels B, B', C and C' in double on the headline
     float64 planes (293 x 160 000) at the headline plan (nf = 293, 32
     columns a block) and on log grids of nf = 1025 (8) and 2000 (4)
     against their float64 plain versions on the card: Tx within 1e-12 of
     max|Tx|, the bins equal on every entry (C and C' given a cotangent
     whose row k holds k + 1 equal the plain gather), C and C' equal to
     the plain gather on a seeded cotangent, every kernel bitwise
     repeated; timed at the headline beside the plain versions and their
     bounds. Then the main path, its launches counted: compat.ssq_cwt
     (the Rust default scales: 490 rows), compat.cwt + compat.icwt,
     compat.stft and compat.ssq_stft (n_fft = 598, hop 1) at N = 160 000,
     ssq_cwt(dtype='float64') at the headline and with get_w, and the
     gradient of each (C' and C in double): B' four times, B twice, C'
     and C once, no float32 kernel; for each compat call its end-to-end
     ms, device ms, D2H ms and peak memory; each against the one-thread
     CPU at N = 16 384 (1e-10 of max; Tx 1e-9 of sum|Tx|). Last, cwt and
     ssq_cwt at the headline with cache_wavelet=True against without (Wx
     within 1e-5; Tx column sums 1e-4), their device ms with and without,
     and the cache's device bytes

 25. (a) past the bins one launch takes (B and B' 3632, I 4096; a call
     splits nf into ranges, one launch each): ssq_stft(n_fft = 8192) at
     N = 160 000 (nf = 4097: B' twice) and ssq_cwt with 5000 ssq_freqs
     (A once, B twice), each Tx bitwise the kernel on its planes and
     within 1e-5 of max|Tx| of the plain version; B and B' in double at
     nf = 4097 on the headline float64 planes bitwise the row-ordered
     sum; I at nf = 5000 on D's planes within 2e-5 (sum-relative) of
     B'; each bitwise repeated and timed beside its plain version and
     its bound (each range reads every plane); at nf = 293 the split
     forced into ranges of 150 through `_launch_ranges` against one
     launch (B, B', B and B' in double bitwise; I by its bar). (b)
     chunked_stft, chunked_istft (n_fft = 598), chunked_cwt,
     chunked_ssq_cwt, chunked_ssq_stft, chunked_icwt and
     chunked_issq_cwt at N = 160 000 with the headline settings, on a
     mesh whose 'time' axis lists the card four times and on a (1, 1)
     mesh, against the unsharded transforms (stft, istft and ssq_stft's
     Sx bitwise; see `chunked_phases` for the other bars), the kernels'
     launches counted per shard program, the wall and device ms of each
     (torch.profiler, and CUDA events around calls queued behind a spin)
     beside the unsharded transform's
 26. the native host runtime: (a) the library built from
     native/ssq_native.cpp with native/Makefile's flags into _build/
     (seconds on its own line; it must load); (b) phase 20's recording (64
     x 600 000 float32) as a channel-major raw file: read_chunk at the
     first and last chunk with halos of 250 000 bitwise the reflect gather
     of the array, the prefetch ring (depth 3) bitwise iter_chunks; (c)
     process_recording(ssq_cwt) from that file with prefetch on and off,
     out='energy' in chunks of 250 000 and out='numpy' on its first 8 x
     60 000 in chunks of 20 000: each bitwise phase 20's array-source
     result, with phase 20's launches of A and B (3 x 64 for the energy),
     its wall time, MSamples/s, peak memory and (one more call, the
     device traced) device idle share, beside the array source run again
     warm (also bitwise); (d) tkeo_cpu / tkeo_modified_cpu on 4 x 160 000
     against numpy's formulas (each output numpy's, or numpy's with one
     product fused: g++ -march=native contracts a*b - c*d to an FMA), and
     reassign_cpu on the float64 planes of a 2048-sample cwt within 1e-12
     of max|Tx| of the port's plain float64 reassign

A line "[t]" gives the wall seconds of each part of the script. Any
failed check raises and exits non-zero. The last three lines are a
JSON object of the twenty-six kernels' numbers (each with its launches on
its paths, including phase 23's and phase 25's end-to-end and sharded
calls and phase 26's pipelines, its time, its
plain version's, its bound from the bytes it must
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


# the kernels by the names this script reports -> the C entry points whose
# calls ssqueeze_rs_tpu_torch.trace.COUNTS counts as "launch.<entry>"
ENTRIES = {"cwt_phase": "ssq_cwt_phase", "cwt_fused": "ssq_cwt_planes",
           "ifft_halfband": "ssq_ifft_halfband", "reassign": "ssq_reassign",
           "reassign4": "ssq_reassign4", "reassign_mxu": "ssq_reassign_mxu",
           "reassign_bwd": "ssq_reassign_bwd",
           "reassign4_bwd": "ssq_reassign4_bwd",
           "reassign_f64": "ssq_reassign_f64",
           "reassign4_f64": "ssq_reassign4_f64",
           "reassign_bwd_f64": "ssq_reassign_bwd_f64",
           "reassign4_bwd_f64": "ssq_reassign4_bwd_f64",
           "stft_dft": "ssq_stft_dft", "ssq_stft": "ssq_stft_fused",
           "istft_ola": "ssq_istft_ola"}


def counted_launches(*names):
    """{name: launches counted} of the kernels `names`."""
    from ssqueeze_rs_tpu_torch.trace import COUNTS
    return {n: COUNTS["launch." + ENTRIES[n]] for n in names}


def zero_launch_counts(*names):
    """Set the launch counts of the kernels `names` to 0."""
    from ssqueeze_rs_tpu_torch.trace import COUNTS
    for n in names:
        COUNTS["launch." + ENTRIES[n]] = 0


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


def kernel_device_ms(torch, fns, name, calls=7, tries=3):
    """{key: median device time in ms} of the CUDA kernel whose name holds
    `name`, over `calls` calls of each of `fns` (after one more) traced by
    torch.profiler: the kernel's own run, without the launch and event
    work around it. The profiler has at times recorded none of a session's
    kernels: a session that does not record one a call is traced again, up
    to `tries` times, and then the check fails."""
    from torch.profiler import ProfilerActivity, profile

    def traced(key, fn):
        fn()
        for _ in range(tries):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            times = sorted(e.device_time for e in prof.events()
                           if name in e.name)
            if len(times) == calls:
                return times[calls // 2] / 1e3
        check(False, f"torch.profiler recorded {len(times)} of {calls} "
              f"launches of {name} ({key}) in each of {tries} sessions")

    return {key: traced(key, fn) for key, fn in fns.items()}


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


def device_breakdown(torch, fn, groups, calls=3, warm=False, cpu=True):
    """Where the device time of fn() goes: torch.profiler over `calls`
    steady calls (after one more, unless the caller has just made it:
    `warm`), the CUDA kernels' self time summed by
    the first of `groups` (name, substrings) whose substring is in the
    kernel's name ("other" for the rest), per call in ms, with the wall
    time per call and the device's idle share. None if the profiler sees
    no device time. `cpu=False` traces the device only (a call of tens
    of thousands of host ops otherwise takes the profiler ~20 s to
    gather)."""
    from torch.profiler import ProfilerActivity, profile
    if not warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu +
                 [ProfilerActivity.CUDA]) as prof:
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
    # the design B had before (the row walk: P4's walk at 3 planes) gives
    # the same bits
    kW = ar.ablate_reassign3(*bargs, variant="walk")
    walk_equal = all(torch.equal(a, b) for a, b in zip(kB, kW))
    del kW
    msB, *spreadB = spread_ms(torch, lambda: reassign_cuda.reassign(*bargs))
    msB_walk, *spreadW = spread_ms(torch,
                                   lambda: ar.ablate_reassign3(
                                       *bargs, variant="walk"))
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
          f"== row walk (P4 walk, 3 planes) {walk_equal} | {colsB}x16 "
          f"{msB:.3f} ms ({spreadB[0]:.3f}-{spreadB[1]:.3f}) vs row walk "
          f"{msB_walk:.3f} ms ({spreadW[0]:.3f}-{spreadW[1]:.3f}), plain "
          f"{msB_plain:.3f} ms, bound {boundB[0]:.3f} ms ({card})")
    check(bitwise, "kernel B differs between two runs")
    check(walk_equal, "kernel B differs from the row walk (P4 walk)")
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
    zero_launch_counts("cwt_phase", "reassign")
    outs, req_ms = {}, {}
    for name, (x, fs) in requests.items():
        before = tuple(counted_launches("cwt_phase", "reassign").values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ssq_cwt(x, wavelet, scales=scales, fs=fs)
        torch.cuda.synchronize()
        req_ms[name] = (time.perf_counter() - t0) * 1e3
        now = tuple(counted_launches("cwt_phase", "reassign").values())
        moved = (now[0] - before[0], now[1] - before[1])
        check(moved == (1, 1), f"{name}: kernel launches moved by {moved}")
        check(out[0].is_cuda and out[1].is_cuda, f"{name}: output left the GPU")
        check(tuple(out[0].shape) == (nf, N) and tuple(out[1].shape) ==
              (len(sc), N), f"{name}: shapes {out[0].shape} {out[1].shape}")
        check(bool(torch.isfinite(out[0]).all()), f"{name}: Tx not finite")
        outs[name] = out
    launches = counted_launches("cwt_phase", "reassign")

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
    f64_kernels = float64_phases(np, torch, dev, card, results, ctx)
    range_launches = range_phases(np, torch, dev, card, results, ctx)
    lap("25a bins past one launch")
    chunk_launches = chunked_phases(np, torch, dev, card, results, ctx)
    lap("25b chunked transforms")
    native_launches = native_pipeline_phases(np, torch, dev, card, results,
                                             ctx)

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
         probe_kernels + rate_kernels + f64_kernels)
    # B and B' (and B in double) also ran on phase 23's paths, the
    # kernels of phase 25's end-to-end and sharded calls on theirs, and A
    # and B on phase 26's pipelines from a raw file
    for entry in kernels:
        entry["launches"] += (sep_launches.get(entry["name"], 0) +
                              range_launches.get(entry["name"], 0) +
                              chunk_launches.get(entry["name"], 0) +
                              native_launches.get(entry["name"], 0))
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
    # bitwise the row walk (P4's walk at 3 and 4 planes)
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
             lambda *a: ar.ablate_reassign3(*a, variant="walk"), a3),
            ("B'", reassign_cuda.reassign4, reassign_cuda.reassign4_plain,
             lambda *a: ar.ablate_reassign(*a, "walk"), a4)):
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
              "walk (P4 walk)")
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
                     zip(k1, ar.ablate_reassign(*a4, "walk")))
    Tb = torch.complex(*k1)
    rel4, _, col4, abs4 = entry_metrics(torch, Tb, torch.complex(*p4))
    ms4, *spread4 = spread_ms(torch,
                              lambda: reassign_cuda.reassign4(*a4))
    ms4_walk, *spread4w = spread_ms(torch,
                                    lambda: ar.ablate_reassign(*a4, "walk"))
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
    check(walk_equal, "kernel B' differs from the row walk (P4 walk)")
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
    names11 = ("stft_dft", "ssq_stft", "istft_ola", "reassign4", "reassign")
    counts = lambda: counted_launches(*names11)
    zero_launch_counts(*names11)
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
    from ssqueeze_rs_tpu_torch.ops import reassign_cuda, stft_cuda
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
    names13 = ("stft_dft", "ssq_stft", "istft_ola", "cwt_phase", "reassign",
               "reassign4", "reassign_bwd", "reassign4_bwd")
    counts = lambda: counted_launches(*names13)

    def zero_counts():
        zero_launch_counts(*names13)

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
    from ssqueeze_rs_tpu_torch.ops import fft_cuda
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
    names16 = ("cwt_phase", "cwt_fused", "ifft_halfband", "reassign",
               "reassign4")

    def counts():
        return counted_launches(*names16)

    def zero_counts():
        zero_launch_counts(*names16)

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
    from ssqueeze_rs_tpu_torch.ops import fft_cuda, reassign_cuda
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
        return counted_launches("cwt_phase", "cwt_fused", "reassign",
                                "reassign4", "reassign_mxu", "stft_dft",
                                "ssq_stft", "istft_ola")

    def zero_counts():
        zero_launch_counts("cwt_phase", "cwt_fused", "ifft_halfband",
                           "reassign", "reassign4", "reassign_mxu",
                           "reassign_bwd", "reassign4_bwd", "stft_dft",
                           "ssq_stft", "istft_ola")

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

    def planes_case(nf, n):
        """Seeded normal planes of nf rows with the STFT's linear plan, for
        widths past the STFT's float32 route (n_fft <= 2048)."""
        g = torch.Generator(device=dev).manual_seed(nf)
        planes = [torch.randn((nf, n), device=dev, generator=g)
                  for _ in range(4)]
        Sfs = np.linspace(0, 0.5, nf, dtype=np.float32)
        const, mode, params = plan_reassignment(Sfs, nf, False,
                                                transform="stft")
        return (*planes,
                torch.as_tensor(const, dtype=torch.float32, device=dev),
                torch.as_tensor(Sfs, device=dev), gamma, params, mode, False,
                nf, "stft")

    x20 = torch.as_tensor(np.random.default_rng(18).standard_normal(N_SMALL),
                          dtype=torch.float32, device=dev)
    xb = torch.as_tensor(np.random.default_rng(21).standard_normal(
        (2, N_SMALL)), dtype=torch.float32, device=dev)
    # the first three are timed; the rest run I at the edges of its plan
    # (the narrowest N, one and two warpgroups a column, the first of four)
    # and a batch of two planes
    cases = {"cwt nf=293": cwt_case,
             "stft nf=300": lambda: stft_case(x, N_FFT),
             "stft nf=1025": lambda: stft_case(x20, 2048),
             "stft nf=8": lambda: stft_case(x20, 14),
             "stft nf=256": lambda: stft_case(x20, 510),
             "stft nf=1024": lambda: stft_case(x20, 2046),
             "planes nf=2048": lambda: planes_case(2048, 6000),
             "planes nf=2049": lambda: planes_case(2049, 6000),
             "planes nf=2689": lambda: planes_case(2689, 4001),
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
        plan = R._mxu_plan(nf)
        I[key] = dict(nf=nf, shape=list(a[0].shape),
                      plan=dict(f0=plan.f0, n_tile=plan.n_tile,
                                split=plan.split, cols=plan.cols,
                                rows=plan.rows),
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
    results["I_sass"] = sass = hgmma_count()
    print("[18] kernel I's SASS (cuobjdump -sass of the built library): " +
          (", ".join(f"{k} {v} HGMMA" for k, v in sass.items())
           if isinstance(sass, dict) else sass))
    check(not isinstance(sass, dict) or all(sass.values()),
          f"kernel I's SASS lacks HGMMA: {sass}")
    print("[18] kernel I: " + "; ".join(
        f"{k} (N {v['plan']['n_tile']}, {v['plan']['cols']} columns a "
        f"block): vs B' sum rel "
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
    del out
    # the fetch into page-locked blocks at N: the arrays pinned and bitwise
    # a pageable copy of the same views, both rates over a warm block, and
    # the pinned pool's reuse over 4 requests whose results are dropped
    from ssqueeze_rs_tpu_torch.serve import _fetch
    from ssqueeze_rs_tpu_torch.trace import COUNTS
    fetch_keys = ("serve.fetch_bytes", "serve.fetch_pinned",
                  "serve.fetch_pinned_new")
    for name, fsrv in (("ssq_cwt", srv), ("ssq_stft", srv2)):
        fb = fsrv.bucket_for(N)
        fxp = np.pad(sig["chirp"][:N], (0, fb - N), mode="reflect")[None]
        views = {k: v[..., :N] for k, v in fsrv._run(fxp).items()}
        _fetch(views)                     # the blocks' first allocation
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pinned = _fetch(views)
        t_pin = time.perf_counter() - t0
        t0 = time.perf_counter()
        pageable = {k: v.cpu().numpy() for k, v in views.items()}
        t_page = time.perf_counter() - t0
        nbytes = sum(a.nbytes for a in pinned.values())
        same = all(np.array_equal(pinned[k], pageable[k]) for k in views)
        locked = all(torch.from_numpy(a).is_pinned()
                     for a in pinned.values())
        del views, pinned, pageable
        before = {k: COUNTS[k] for k in fetch_keys}
        for _ in range(4):
            out = fsrv(sig["chirp"][:N])
            del out
        moved = {k: COUNTS[k] - before[k] for k in fetch_keys}
        reuse = 1 - moved["serve.fetch_pinned_new"] / moved[
            "serve.fetch_pinned"]
        S20[f"fetch {name} {N}"] = dict(
            bytes=nbytes, pinned_gb_s=nbytes / t_pin / 1e9,
            pageable_gb_s=nbytes / t_page / 1e9, reuse_share=reuse,
            counts=moved, host_peak_gb=torch.cuda.host_memory_stats()[
                "allocated_bytes.peak"] / 1e9)
        check(same and locked, f"fetch {name}: pinned {locked}, bitwise "
              f"the pageable copy {same}")
        check(moved["serve.fetch_pinned"] == 8 and reuse == 1 and
              moved["serve.fetch_bytes"] == 4 * nbytes,
              f"fetch {name}: counts {moved}")
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
    # phase 26 reads the same recording from a raw file
    ctx["pipeline20"] = dict(rec=rec, fs=fs, chunk=250_000, en=en,
                             en_launches=moved, en_s=wall, en_peak_gb=peak)
    del en0
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
    ctx["pipeline20"].update(out8=out8, chunk8=20_000, out8_launches=moved,
                             out8_s=wall)
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
        f"{S20['ssq_stft 160000']['ms']:.1f} ms; fetch " + ", ".join(
            f"{k[6:]} {v['bytes'] / 1e6:.0f} MB pinned {v['pinned_gb_s']:.1f} "
            f"GB/s, pageable {v['pageable_gb_s']:.2f} GB/s, reuse "
            f"{v['reuse_share']:.2f}" for k, v in S20.items()
            if k.startswith("fetch")) + "; pipeline energy 64 x 600000 "
        f"{S20['pipeline energy 64 x 600000']['s']:.2f} s = "
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
    from ssqueeze_rs_tpu_torch.tools import (_common,
                                             ablate_cwt_kernel as acw,
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
    # repeated; P1 full bitwise D (fft_cuda.cwt_fused with the
    # derivative: the same launches), nochunk and P3 staged bitwise P1
    # full, all within 1e-5 of D's plain
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
        elif v == "nochunk":
            P[v]["bitwise_full"] = equal(k1, full)
            check(P[v]["bitwise_full"], "P1 nochunk is not full bit for bit")
        del k1, k2, p
    D = fft_cuda.cwt_fused(*args, keep=keep, derivative=True)
    P["full"]["bitwise_D"] = equal(full, D)
    check(P["full"]["bitwise_D"], "P1 full is not D's planes bit for bit")
    s1, s2 = acw.cwt_staged(*args, keep), acw.cwt_staged(*args, keep)
    D_plain = fft_cuda.cwt_fused_plain(*args, keep=keep, derivative=True)
    full_rel = planes_err(full, D_plain)[0]
    P["staged"] = dict(bitwise_full=equal(s1, full), repeat=equal(s1, s2),
                       rel_D_plain=planes_err(s1, D_plain)[0],
                       ms=rows_cwt["staged"]["ms"],
                       bound_ms=rows_cwt["staged"]["bound_ms"],
                       plan=acw.staged_plan())
    P["full"]["rel_D_plain"] = full_rel
    check(P["staged"]["bitwise_full"] and P["staged"]["repeat"],
          f"P3 staged: bitwise P1 full {P['staged']['bitwise_full']}, "
          f"repeat {P['staged']['repeat']}")
    check(full_rel < 1e-5 and P["staged"]["rel_D_plain"] < 1e-5,
          f"P1 full / P3 staged vs D's plain: {full_rel:.3e} / "
          f"{P['staged']['rel_D_plain']:.3e}")
    del s1, s2, full, D, D_plain
    # D itself timed as P1 full is (the same launches: within 5 %), and
    # each launch of every P1 variant and of P3 in torch.profiler
    D_ms = _common.time_ms(lambda: fft_cuda.cwt_fused(
        *args, keep=keep, derivative=True), dev, reps)
    check(abs(rows_cwt["full"]["ms"] / D_ms - 1) <= 0.05,
          f"P1 full {rows_cwt['full']['ms']:.4f} ms is not within 5 % of "
          f"D's {D_ms:.4f} ms")
    launch_groups = [("launch 1", ("cwt_d_stage1", "staged_stage1")),
                     ("launch 2", ("cwt_d_stage2",))]
    for v in acw.VARIANTS + ("staged",):
        fn = ((lambda: acw.cwt_staged(*args, keep)) if v == "staged" else
              (lambda: acw.ablate_cwt(*args, keep, v)))
        prof = device_breakdown(torch, fn, launch_groups, cpu=False)
        P[v]["launch_ms"] = None if prof is None else prof["split_ms"]
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

    # P2: exact against the plain copy, repeated; the same function as
    # one PyTorch call (F.pad of Pw, 4-fold expanded for dmaonly) exact too
    L = keep[1]
    for v in acw.COPY_VARIANTS:
        k1, k2 = acw.copy_floor(Pw, L, v), acw.copy_floor(Pw, L, v)
        want = acw.copy_floor_plain(Pw, L, v)
        exact = equal(k1, want)
        P[v] = dict(exact=exact, repeat=equal(k1, k2), ms=rows_cwt[v]["ms"],
                    bound_ms=rows_cwt[v]["bound_ms"])
        check(exact and P[v]["repeat"], f"P2 {v}: exact {exact}, repeat "
              f"{P[v]['repeat']}")
        if f"F.pad ({v})" in rows_cwt:
            P[v]["library_exact"] = equal(acw.copy_floor_library(Pw, L, v),
                                          want)
            P[v]["library_ms"] = rows_cwt[f"F.pad ({v})"]["ms"]
            check(P[v]["library_exact"], f"P2 {v}: F.pad differs from "
                  "the plain version")
        del k1, k2, want
    copy_plain_ms = cuda_ms(torch, lambda: acw.copy_floor_plain(Pw, L),
                            warmup=1, iters=reps)
    del args, Pw, xr, xi, xig
    lap("21 P1-P3 against their plain twins")

    # P4 (B''s scatter under ablation flags): full bitwise B' and the
    # 3-plane full bitwise B at each column count; serial, noprefetch and
    # walk bitwise full; every variant against its plain twin, repeated;
    # the grid modes on a batch of 4
    R = {}
    na, nf, n = (ar.HEADLINE[k] for k in ("na", "nf", "n"))
    planes = ar.make_planes(dev, None, na, n)
    rest = (ar.GAMMA, ar.PARAMS, ar.MODE, True, nf, "cwt")
    w3 = reassign_cuda.phase_w(*planes[:4], planes[5], ar.GAMMA, "cwt")
    a3 = (planes[0], planes[1], w3, planes[4], ar.PARAMS, ar.MODE, True, nf)
    with scatter_impl("vpu"):
        b4 = reassign_cuda.reassign4(*planes, *rest)
        # B' beside the row walk at the headline, both timed here
        R["B'"] = dict(
            ms=cuda_ms(torch, lambda: reassign_cuda.reassign4(*planes, *rest)),
            walk_ms=cuda_ms(torch, lambda: ar.ablate_reassign(
                *planes, *rest, "walk")),
            cols=reassign_cuda._block_cols(nf))
    b3 = reassign_cuda.reassign(*a3)
    R["B"] = dict(ms=cuda_ms(torch, lambda: reassign_cuda.reassign(*a3)),
                  walk_equal=equal(ar.ablate_reassign3(*a3, variant="walk"),
                                   b3))
    check(R["B"]["walk_equal"], "P4 walk at 3 planes is not B bit for bit")
    for c in (32, 16, 8):
        k1 = ar.ablate_reassign(*planes, *rest, "full", c)
        k3 = ar.ablate_reassign3(*a3, cols=c)
        R[f"full/{c}"] = dict(bitwise_b4=equal(k1, b4),
                              bitwise_b3=equal(k3, b3),
                              ms=rows_re[f"full/{c}"]["ms"],
                              bound_ms=rows_re[f"full/{c}"]["bound_ms"])
        check(R[f"full/{c}"]["bitwise_b4"],
              f"P4 full at {c} columns a block is not B' bit for bit")
        check(R[f"full/{c}"]["bitwise_b3"],
              f"P4 3-plane full at {c} columns a block is not B bit for bit")
        del k1, k3
    del w3, a3, b3
    for v in ar.VARIANTS:
        k1, k2 = (ar.ablate_reassign(*planes, *rest, v) for _ in range(2))
        p = ar.ablate_reassign_plain(*planes, *rest, v)
        err, err_abs = planes_err(k1, p)
        R.setdefault(v, {}).update(rel=err, abs=err_abs, exact=equal(k1, p),
                                   repeat=equal(k1, k2),
                                   ms=rows_re.get(v, rows_re["full/32"])["ms"])
        check(R[v]["repeat"], f"P4 {v} differs between two runs")
        check(err <= 1e-5, f"P4 {v}: rel error {err:.3e} > 1e-5")
        if v in ("serial", "noprefetch", "walk"):
            R[v]["bitwise_full"] = equal(k1, b4)
            check(R[v]["bitwise_full"], f"P4 {v} is not full bit for bit")
        del k1, k2, p
    check(R["dmaonly"]["exact"] and R["dmarows"]["exact"],
          "P4 dmaonly / dmarows: Tx planes not zero")
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
                             ifft_ms=ifft_ms, D_ms=D_ms,
                             copy_ms=rows_cwt["copy_"]["ms"],
                             pad_ms={v: P[v]["library_ms"]
                                     for v in ("dmaonly", "dma1")})

    def by_launch(v):
        t = P[v]["launch_ms"]
        return ("" if t is None else
                f" ({t['launch 1']:.3f} + {t['launch 2']:.3f})")

    plan = P["staged"]["plan"]
    print("[21] probes: P1 (ms/bound ms, launch 1 + launch 2 by the "
          "profiler) " + ", ".join(
              f"{v} {P[v]['ms']:.4f}/{P[v]['bound_ms']:.3f}{by_launch(v)}"
              for v in acw.VARIANTS) +
          f"; D (cwt_fused) {D_ms:.4f}, torch.fft.ifft {ifft_ms:.4f}; P2 " +
          ", ".join(f"{v} {P[v]['ms']:.3f}/{P[v]['bound_ms']:.3f}"
                    for v in acw.COPY_VARIANTS) +
          f" (library: F.pad (dmaonly) {P['dmaonly']['library_ms']:.3f}, "
          f"F.pad (dma1) {P['dma1']['library_ms']:.3f}; copy_ "
          f"{rows_cwt['copy_']['ms']:.3f} at dmaonly's bytes); P3 staged "
          f"{P['staged']['ms']:.4f}{by_launch('staged')} ({plan['blocks_per_sm']}"
          f" block(s) an SM of {plan['threads']} threads, "
          f"{plan['registers']} registers a thread, {plan['smem_bytes']} "
          f"bytes, {plan['stages']} slots of {plan['box_cols']}-column "
          f"boxes); P1 worst rel "
          f"{max(P[v]['rel'] for v in acw.VARIANTS):.2e}, full bitwise D, "
          f"nochunk and staged bitwise full, vs D's plain "
          f"{P['full']['rel_D_plain']:.2e} / "
          f"{P['staged']['rel_D_plain']:.2e}; P4 " + ", ".join(
            f"{k} {rows_re[k]['ms']:.3f}/{rows_re[k]['bound_ms']:.3f}"
            for k in rows_re) + f", worst rel "
        f"{max(R[v]['rel'] for v in ar.VARIANTS):.2e}, full bitwise B' "
        "and 3-plane full bitwise B at 32/16/8 columns, serial, noprefetch "
        f"and walk bitwise full; B {R['B']['ms']:.3f} ms; "
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
                     P["dmaonly"]["library_ms"], root=tools),
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
# J5's edge shape: no multiple of an output tile or of a TMA box along k
J5_EDGE = (200, 72, 136)
# J6's dots at edge shapes, (name, (batch, M, K, N, steps, accumulate),
# route): M, K and N off the unit (16 rows, a 64-column slab) and the box
# (64 along k), one for each operand mode, then K or N not a multiple of 8
# (no 16-byte loads, no TMA map: the operands loaded element by element)
J6_EDGES = (("accumulate", (1, 200, 72, 136, 3, True), "resident"),
            ("batch", (3, 33, 40, 24, 3, False), "resident"),
            ("streamed", (1, 200, 1000, 136, 3, True), "streamed"),
            ("resident, K and N odd", (2, 33, 45, 30, 3, False), "resident"),
            ("streamed, K odd", (1, 70, 333, 50, 2, True), "streamed"))


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
    # J8's main: the launch floor, then every configuration in every mode
    # and store route
    n_grid = sum(len(c[4]) for c in gsp.CONFIGS) * len(gsp.VARIANTS) + 1
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

    # J8: every configuration, and the plan's edges (the launch floor's
    # tile below one chunk, chunks whose last is shorter, a tile of 40
    # chunks), in both modes and both store routes, exact and repeated;
    # the persistent plan equal to its mirror
    J8, plans = {}, {}
    g = torch.Generator(device=dev).manual_seed(8)
    cases = [(f"{name} g={grid}", r_, L, vary, grid)
             for name, r_, L, vary, grids in gsp.CONFIGS for grid in grids]
    cases += [(f"{gsp.FLOOR[0]} g=1", *gsp.FLOOR[1:]),
              ("edge (3,5000) vary g=7", 3, 5000, True, 7),
              ("edge (3,5000) const g=7", 3, 5000, False, 7),
              ("edge (40,8192) const g=3", 40, 8192, False, 3)]
    for key, r_, L, vary, grid in cases:
        x = torch.randn((r_, L), generator=g, device=dev)
        plain = gsp.grid_slope_plain(x, grid, vary)
        for mode, store in gsp.VARIANTS:
            k1 = gsp.grid_slope(x, grid, vary, mode, store)
            k2 = gsp.grid_slope(x, grid, vary, mode, store)
            J8[f"{key} {mode} {store or ''}".rstrip()] = dict(
                exact=equal(k1, plain), repeat=equal(k1, k2))
            if store:
                kp = gsp.kernel_plan(r_, L, grid, vary, store)
                mine = gsp.plan(r_, L, grid, vary, store, sms=kp["sms"])
                plans[f"{key} {store}"] = dict(
                    kp, equal={k: mine[k] for k in kp} == kp,
                    loads=mine["loads"], stores=mine["stores"])
        del x, plain, k1, k2
    check(all(v["exact"] and v["repeat"] for v in J8.values()),
          f"J8 grid_slope: {J8}")
    check(all(p["equal"] and p["loads"] == p["blocks"] <= p["per_sm"] *
              p["sms"] for p in plans.values()),
          f"J8's plan is not its mirror's: {plans}")
    # each step's adds stay in the step loop of every persistent kernel
    sass8 = fadd_count()
    check(isinstance(sass8, dict) and len(sass8) == 4 and all(
        n >= 4 and inside == n for n, inside in sass8.values()),
        f"J8: the persistent kernels' adds are not all in a loop: {sass8}")
    # the plain versions and library calls are timed as the probes time
    # their kernels: the runs queued ahead of the card (`_common.time_ms`),
    # so a call shorter than the host's launch work is not timed by it
    qms = lambda fn: _common.time_ms(fn, dev, reps)
    # the entry's case, `tiny vary` at the largest grid: the kernel's work
    # is the grid's copies of the tile, and so is that of the plain version
    # and of the library call, whose output is the kernel's bit for bit
    x = torch.randn((8, 128), generator=g, device=dev)
    g_last = gsp.CONFIGS[1][4][-1]
    grid_plain_ms = qms(lambda: gsp.grid_slope_plain(x, g_last, True))
    grid_lib = lambda: torch.add(x.expand(g_last, *x.shape), 1)
    J8["library equal"] = dict(exact=all(equal(
        grid_lib().reshape(-1, x.shape[1]),
        gsp.grid_slope(x, g_last, True, mode, store))
        for mode, store in gsp.VARIANTS), repeat=True)
    check(J8["library equal"]["exact"],
          "J8: torch.add over the grid's copies is not the kernel's output")
    grid_lib_ms = qms(grid_lib)

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
    # an edge shape that is no multiple of a tile (128 rows, 128 columns)
    # or a TMA box along k (64 bf16, 32 float), at GRID (clusters of two
    # copies) and at an odd grid (unclustered); the pre-pass bitwise its
    # plain model
    me, ke, ne = J5_EDGE
    A = torch.randn((2 * me, ke), generator=g, device=dev)
    B = torch.randn((ke, ne), generator=g, device=dev)
    for p in mrp.PRECISIONS:
        pl = mrp.dot_probe_plain(A, B, me, p)
        for grid in (mrp.GRID, 3):
            key = f"dot {p} ({me},{ke},{ne}) grid {grid}"
            k1 = mrp.dot_probe(A, B, me, p, grid=grid)
            e, d = err(k1, pl)
            J5[key] = dict(rel=e, abs=d, repeat=equal(
                k1, mrp.dot_probe(A, B, me, p, grid=grid)))
            check(e < RATE_BAR and J5[key]["repeat"],
                  f"J5 {key}: rel {e:.3e}, repeat {J5[key]['repeat']}")
        got = mrp.prepass(A, B, me, p)
        want = mrp.prepass_plain(A, B, me, p)
        J5[f"prepass {p} ({me},{ke},{ne})"] = ok = all(
            (x is None and y is None) or equal(x, y) for x, y in zip(got, want))
        check(ok, f"J5 pre-pass {p} ({me},{ke},{ne}) is not its plain model")
    for (mm, nn) in mrp.COPY_SHAPES:
        A = torch.randn((2 * mm, nn), generator=g, device=dev)
        k1 = mrp.copy_probe(A, mm)
        J5[f"copy ({mm},{nn})"] = dict(
            exact=equal(k1, mrp.copy_probe_plain(A, mm)),
            repeat=equal(k1, mrp.copy_probe(A, mm)))
        check(J5[f"copy ({mm},{nn})"]["exact"] and
              J5[f"copy ({mm},{nn})"]["repeat"], f"J5 copy ({mm},{nn})")
    # A is the last of COPY_SHAPES, (1024, 4096). The copy's GRID copies run
    # in registers on operands loaded once, so they must not fold into
    # fewer: past its time at R = 0 (the loads, the stores, the launch and
    # the copy loop without its adds), GRID 32 must take at least 1.8x the
    # time of GRID 16, and each of the 16 copies between them no less than
    # its R m n adds take at one `__fadd_rn` a lane a clock (half the
    # card's float32 rate, which counts an FMA as two). The kernel's own
    # device time: the ~5 us of launch and event work around one timed
    # call would stand for a sixth of the GRID 16 call
    half = mrp.GRID // 2
    runs = {"R = 0": dict(R=0), f"GRID {half}": dict(grid=half),
            f"GRID {mrp.GRID}": {}}
    copy_grid_ms = kernel_device_ms(
        torch, {key: (lambda kw=kw: mrp.copy_probe(A, mm, **kw))
                for key, kw in runs.items()}, "rate_copy_kernel")
    t0, t_half, t_grid = copy_grid_ms.values()
    net = (t_grid - t0) / (t_half - t0) if t_half > t0 else 0.0
    copy_us = (t_grid - t_half) / half * 1e3
    lanes_us = mrp.R * mm * nn / (F32_FLOP_S / 2) * 1e6
    # (no " grid " in these keys: that marks the dots' edge cases)
    J5["copy kernel ms (1024,4096)"] = copy_grid_ms
    J5["copy GRID ratio past R = 0"] = net
    J5["copy us a copy (lanes' floor)"] = (copy_us, lanes_us)
    check(net >= 1.8, f"J5 copy at GRID {mrp.GRID} is not 1.8x its time at "
          f"GRID {half} past its time at R = 0: {copy_grid_ms} ms")
    check(copy_us >= lanes_us, f"J5 copy: {copy_us:.3f} us a copy between "
          f"GRID {half} and {mrp.GRID}, under the {lanes_us:.3f} us its adds "
          "take at the lanes' rate: copies were folded")
    copy_plain_ms = qms(lambda: [mrp.copy_probe_plain(A, mm)
                                 for _ in range(mrp.GRID)])
    # the library call over the kernel's GRID copies, as its plain version
    # is timed (one call forms the output once; the kernel's copies each
    # form it again)
    w = torch.full((1, 2), mrp.R / 2, device=dev)
    copy_lib_ms = qms(lambda: [torch.matmul(w, A.view(2, -1))
                               for _ in range(mrp.GRID)])
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
                got = mrp.prepass(A, B, m, "bf16", C8)
                J5[f"prepass chains C={C8} ({m},{k},{n})"] = ok = all(
                    (x is None and y is None) or equal(x, y) for x, y in
                    zip(got, mrp.prepass_plain(A, B, m, "bf16", C8)))
                check(ok, f"J5 chains pre-pass C={C8} is not its plain model")
                chains_plain_ms = qms(lambda: [mrp.dot_probe_chains_plain(
                    A, B, m, C8) for _ in range(mrp.GRID)])
                Acat = torch.stack([torch.cat(
                    [A[((i + c) % (C8 + 1)) * m:((i + c) % (C8 + 1) + 1) * m]
                     for i in range(mrp.R)], 1) for c in range(C8)])
                a16 = Acat.repeat(mrp.GRID, 1, 1).to(torch.bfloat16)
                b16 = B.repeat(mrp.R, 1).to(torch.bfloat16)
                chains_lib_ms = qms(lambda: torch.matmul(a16, b16))
                del Acat, a16, b16
    # an even GRID runs the two copies of a tile as a cluster of two
    # blocks; an odd one runs unclustered: the same work a copy at GRID - 1
    # copies, scaled to GRID, against the probes' rows
    odd = mrp.GRID - 1
    A = torch.randn((2 * m, k), generator=g, device=dev)
    B = torch.randn((k, n), generator=g, device=dev)
    unclustered = {p: qms(lambda: mrp.dot_probe(A, B, m, p, grid=odd)) *
                   mrp.GRID / odd for p in mrp.PRECISIONS}
    A = torch.randn(((C8 + 1) * m, k), generator=g, device=dev)
    unclustered["chains"] = qms(lambda: mrp.dot_probe_chains(
        A, B, m, C8, grid=odd)) * mrp.GRID / odd
    del A, B
    lap("22 J5, J8 against their plain versions")

    # J7 against the plain loop, at each cluster size: within 1e-3 of
    # max|out| at R = 1, 1e-2 at R = 3 and 0.1 at R = 64 (the bf16
    # re-rounding of each product's input parts the two chains: 2.9e-3
    # after 9 products, 1.5e-2 after 192), there finite, of order 1 and
    # repeated; `copies` exact throughout. With b = 1000 P (P a random
    # permutation) each product is one exact term, so kernel and plain
    # round alike: bitwise equal at R = 3 and 64, which holds the state
    # carried from one iteration to the next
    H = dop.HEADLINE
    src, a, b = dop.make_inputs(dev, H["R"], H["CH"], H["M"])
    run7 = dict(CH=H["CH"], D=H["D"])
    bp = torch.zeros_like(b)
    bp[torch.randperm(H["M"], generator=g, device=dev),
       torch.arange(H["M"], device=dev)] = 1000.0
    bT, bpT = dop.b_operand(b), dop.b_operand(bp)
    plain7 = {(v, R_, perm): dop.dma_overlap_plain(src, a, bp if perm else b,
                                                   v, R_, **run7)
              for v in dop.VARIANTS for R_, perm in
              ((1, False), (3, False), (H["R"], False), (3, True),
               (H["R"], True))}

    def j7_checks(cl):
        """{variant: every J7 check's reading} in clusters of `cl`"""
        out7 = {}
        for v in dop.VARIANTS:
            run = lambda perm, R_: dop.dma_overlap(
                src, a, bp if perm else b, v, R_, bT=bpT if perm else bT,
                cluster=cl, **run7)
            r7 = out7[v] = {}
            for R_, bar in ((1, 1e-3), (3, 1e-2)):
                e_, d_ = err(run(False, R_), plain7[v, R_, False])
                r7.update({f"rel_r{R_}": e_, f"abs_r{R_}": d_})
                check(e_ == 0 if v == "copies" else e_ < bar,
                      f"J7 {v} in clusters of {cl} at R = {R_}: rel "
                      f"{e_:.3e}")
            for R_ in (3, H["R"]):
                k1 = run(True, R_)
                r7[f"exact_perm_r{R_}"] = equal(k1, plain7[v, R_, True])
                check(r7[f"exact_perm_r{R_}"] and 0.1 < float(
                    k1.abs().max()) < 100, f"J7 {v} in clusters of {cl}, "
                    f"b = 1000 P, at R = {R_}: {r7}")
            k1, k2 = run(False, H["R"]), run(False, H["R"])
            e, d = err(k1, plain7[v, H["R"], False])
            top = float(k1.abs().max())
            r7.update(rel=e, abs=d, max=top, repeat=equal(k1, k2),
                      finite=bool(torch.isfinite(k1).all()))
            check(r7["repeat"] and r7["finite"] and 1e-3 < top < 1e3 and
                  (e == 0 if v == "copies" else e < 0.1),
                  f"J7 {v} in clusters of {cl} at R = 64: {r7}")
        return out7

    J7 = j7_checks(dop.CLUSTER)
    overlap_plain_ms = qms(lambda: dop.dma_overlap_plain(
        src, a, b, "both", H["R"], **run7))
    # the kernel's plan on the card against its mirror, and the three
    # variants at both cluster sizes, each size held to every check above
    # (the entry's times are main()'s, at the default)
    J7["clusters"] = {}
    for cl in dop.CLUSTERS:
        kp = dop.kernel_plan(H["M"], cl)
        mirror = dop.plan(H["M"], H["CH"], cl)
        check(all(kp[k] == mirror[k] for k in ("cluster", "n", "blocks",
                                                "slots", "smem")),
              f"J7 plan at cluster {cl}: kernel {kp}, mirror {mirror}")
        entry = J7["clusters"][cl] = dict(plan=kp)
        if cl != dop.CLUSTER:                  # the default's are J7's own
            entry["checks"] = j7_checks(cl)
        cms = {v: qms(lambda: dop.dma_overlap(src, a, b, v, H["R"], bT=bT,
                                              cluster=cl, **run7))
               for v in dop.VARIANTS}
        cs, cm, cw = dop.verdict(cms)
        entry.update(ms=cms, word=cw,
                     hidden=(cs - cms["both"]) / cms["copies"])
    del src, a, b, bT, bpT, plain7
    ms = {v: rows["dma_overlap"][v]["ms"] for v in dop.VARIANTS}
    s_, m_, word = dop.verdict(ms)
    J7["verdict"] = dict(sum=s_, max=m_, word=word,
                         hidden=(s_ - ms["both"]) / ms["copies"])

    # J6: every question against its plain version at the headline; the
    # dots' unit plan on the card against its mirror (`dots_plan`)
    J6 = {}
    lib6 = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for tag, mod, key in (("a", mp, "mxu_probe"), ("b", mp2, "mxu_probe2")):
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
            if dots:
                shape = mp.dots_shape(q, size)
                plan = mp.dots_kernel_plan(*shape)
                mirror = mp.dots_plan(*shape, sms=sms)
                check(all(plan[k_] == v_ for k_, v_ in mirror.items()),
                      f"J6{tag} {q}: the kernel's plan {plan} is not its "
                      f"mirror {mirror}")
                r = rows[key][q]
                J6[f"{tag} {q}"].update(
                    route=plan["route"], width=plan["width"],
                    units=plan["units"], per_sm=plan["per_sm"],
                    tflop_s=r["flops"] / r["ms"] / 1e9)
        steps = size["GRID"] * size["NG"]
        # the running sum in step order: bitwise the float32 sum of one-step
        # dots taken in order, at 3 steps and at the headline's GRID NG
        for S in (3, steps):
            k1 = mp.dots(inp["A"], inp["B"], S)
            acc = torch.zeros_like(k1)
            for _ in range(S):
                acc = acc + mp.dots(inp["A"], inp["B"], 1)
            J6[f"{tag} order S={S}"] = ok = equal(k1, acc)
            check(ok, f"J6{tag} q_dots at {S} steps is not the float32 sum "
                  f"of {S} one-step dots in step order")
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
    # the edge shapes, one for each operand mode and the element loads
    for name, shape, route in J6_EDGES:
        b_, M_, K_, N_, S_, acc_ = shape
        A = torch.randn((b_, M_, K_), generator=g, device=dev)
        B = torch.randn((b_, K_, N_), generator=g, device=dev)
        if b_ == 1:
            A, B = A[0], B[0]
        k1, k2 = mp.dots(A, B, S_, acc_), mp.dots(A, B, S_, acc_)
        e, d = err(k1, mp.dots_plain(A, B, S_, acc_))
        plan = mp.dots_kernel_plan(*shape)
        J6[f"edge {name}"] = dict(shape=shape, rel=e, abs=d,
                                  repeat=equal(k1, k2), route=plan["route"],
                                  units=plan["units"])
        check(e < RATE_BAR and equal(k1, k2) and plan["route"] == route,
              f"J6 edge {name} {shape}: {J6[f'edge {name}']}")
    del A, B
    lap("22 J6, J7 against their plain versions")

    results["rate_probes"] = dict(
        launches=launches, moved=moved, J5=J5, J6=J6, J7=J7, J8=J8,
        J8_plans=plans, J8_fadds=sass8,
        j5_unclustered_ms=unclustered,
        library=dict(dot=lib, copy=copy_lib_ms, chains=chains_lib_ms,
                     grid=grid_lib_ms, j6=lib6),
        rows={k: list(v.values()) for k, v in rows.items()},
        slopes=gsp.slopes(list(rows["grid_slope"].values())))
    rr = rows["rate"]
    rg = rows["grid_slope"]
    floor8 = rg[gsp.FLOOR[0]]
    labels8 = [f"{m} {st}".rstrip() if st else m for m, st in gsp.VARIANTS]
    worst = {p: max(v["rel"] for key, v in J5.items()
                    if key.startswith(f"dot {p} ")) for p in mrp.PRECISIONS}
    chains = rows["rate_chains"]
    print("[22] rate probes: J5 (1024,512,512) " + ", ".join(
        f"{p} {rr[f'dot {p} ({m},{k},{n})']['ms']:.4f} ms "
        f"({rr[f'dot {p} ({m},{k},{n})']['tflop_s']:.1f} TFLOP/s, "
        f"pre-pass {rr[f'dot {p} ({m},{k},{n})']['prep_ms']:.4f} ms, "
        f"operands {rr[f'dot {p} ({m},{k},{n})']['operand_tb_s']:.1f} TB/s "
        "into shared memory, "
        f"worst rel {worst[p]:.1e})" for p in mrp.PRECISIONS) +
        f"; copy (1024,4096) {rr['copy f32 (1024,4096)']['ms']:.4f} ms "
        f"({rr['copy f32 (1024,4096)']['smem_tb_s']:.1f} TB/s on chip; "
        "kernel " + ", ".join(
            f"{k} {v:.4f}" for k, v in copy_grid_ms.items()) +
        f" ms, {net:.2f}x past R = 0, {copy_us:.3f} us a copy against "
        f"the lanes' {lanes_us:.3f}); "
        "chains (1024,512,512) us a dot " + ", ".join(
            f"C={C} {chains[f'chains C={C} ({m},{k},{n})']['us_per_dot']:.3f}"
            for C in mrp.CHAINS) + f" (C={C8} "
        f"{chains[f'chains C={C8} ({m},{k},{n})']['ms']:.4f} ms, pre-pass "
        f"{chains[f'chains C={C8} ({m},{k},{n})']['prep_ms']:.4f} ms, "
        f"operands {chains[f'chains C={C8} ({m},{k},{n})']['operand_tb_s']:.1f}"
        " TB/s); "
        f"edge ({J5_EDGE[0]},{J5_EDGE[1]},{J5_EDGE[2]}) worst rel " + "{:.1e}".format(
            max(v["rel"] for key, v in J5.items() if " grid " in key)) +
        "; unclustered (GRID - 1 copies, scaled to GRID) " + ", ".join(
            f"{key} {v:.4f}" for key, v in unclustered.items()) + " ms" +
        "; J6 " + ", ".join(
            f"{q} {rows['mxu_probe'][q]['ms']:.3f}" for q in mp.QUESTIONS) +
        " / " + ", ".join(f"{q} {rows['mxu_probe2'][q]['ms']:.3f}"
                          for q in mp2.QUESTIONS) +
        " ms; J6 dots (route, units, warpgroups an SM, TFLOP/s) " + ", ".join(
            f"{key} {v['route']} {v['units']} {v['per_sm']} "
            f"{v['tflop_s']:.1f}" for key, v in J6.items()
            if isinstance(v, dict) and "tflop_s" in v) +
        "; order bitwise at " + ", ".join(
            key.replace(" order S=", " ") for key, v in J6.items()
            if " order S=" in key and v) +
        " steps; edges worst rel {:.1e}".format(max(
            v["rel"] for key, v in J6.items() if key.startswith("edge "))) +
        f"; J7 copies {ms['copies']:.3f}, dots {ms['dots']:.3f}, both "
        f"{ms['both']:.3f} ms -> {word} (copies hidden "
        f"{J7['verdict']['hidden']:.0%}; by cluster size " + ", ".join(
            f"{cl}: " + "/".join(f"{c['ms'][v]:.4f}" for v in dop.VARIANTS) +
            f" ms {c['word']} hidden {c['hidden']:.0%}, "
            f"{c['plan']['blocks']} blocks, {c['plan']['fit']} clusters at "
            "once" for cl, c in J7["clusters"].items()) +
        f"); J8 launch floor {floor8['ms']:.5f} ms; " + ", ".join(
            f"{c} (" + ", ".join(
                f"{lab} {rg[f'{c} {lab}']['ms']:.5f}"
                for lab in labels8) + ")"
            for c in (f"tiny const g={g_last}", f"tiny vary g={g_last}",
                      "row-out vary g=37", "row-out vary g=293")) +
        " ms; J8 per block (blocks) or step (persistent), events/wall us " +
        ", ".join(f"{k} " + "/".join(f"{u:.4f}" for u in v)
                  for k, v in results["rate_probes"]["slopes"].items()) +
        "; J8 FADDs (in the step loop) " + ", ".join(
            f"{k} {n} ({i})" for k, (n, i) in sass8.items()) +
        f"; element questions, copies and J8 exact, J8's plan its mirror's;"
        f" launches {launches} ({card})")

    tools = "tools/"
    rd = rr[f"dot bf16 ({m},{k},{n})"]
    rc = rr["copy f32 (1024,4096)"]
    rch = rows["rate_chains"][f"chains C={C8} ({m},{k},{n})"]
    q1, q2 = rows["mxu_probe"]["q_dots"], rows["mxu_probe2"]["q_dots"]
    ov = rows["dma_overlap"]["both"]
    gs = rg[f"tiny vary g={g_last} persistent {gsp.STORE}"]
    ro = rg[f"row-out vary g={gsp.CONFIGS[2][4][-1]} persistent {gsp.STORE}"]
    bnd = lambda r: (r["bound_ms"], r["bound_by"])
    # the operand pre-pass is the first of a dot's two launches: its time
    # alone is in the entries beside the call's
    return [
        dict(kernel_entry("rate_dot", "rate_probe.cu", "mxu_rate_probe.py:47",
                          launches["rate_dot"],
                          J5[f"dot bf16 ({m},{k},{n})"]["abs"], rd["ms"],
                          dot_plain_ms, bnd(rd), lib["bf16"], root=tools),
             prepass_ms=rd["prep_ms"]),
        kernel_entry("rate_copy", "rate_probe.cu", "mxu_rate_probe.py:70",
                     launches["rate_copy"], 0.0, rc["ms"], copy_plain_ms,
                     bnd(rc), copy_lib_ms, root=tools),
        dict(kernel_entry("rate_chains", "rate_probe.cu",
                          "mxu_rate_probe.py:153", launches["rate_chains"],
                          J5[f"chains C={C8} ({m},{k},{n})"]["abs"],
                          rch["ms"], chains_plain_ms, bnd(rch), chains_lib_ms,
                          root=tools),
             prepass_ms=rch["prep_ms"]),
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
        # the persistent kernel by its default store route; beside it the
        # launch floor, the other routes and the row-out plane
        dict(kernel_entry("grid_slope", "grid_slope.cu",
                          "grid_slope_probe.py:50", launches["grid_slope"],
                          0.0, gs["ms"], grid_plain_ms, bnd(gs), grid_lib_ms,
                          root=tools),
             store=gsp.STORE, floor_ms=floor8["ms"],
             past_floor_ms=gs["past_floor_ms"],
             blocks_ms=rg[f"tiny vary g={g_last} blocks"]["ms"],
             store_ms={st: rg[f"tiny vary g={g_last} persistent {st}"]["ms"]
                       for st in gsp.STORES},
             rowout_ms=ro["ms"], rowout_bound_ms=ro["bound_ms"],
             rowout_store_ms={
                 st: rg[ro["name"].replace(gsp.STORE, st)]["ms"]
                 for st in gsp.STORES},
             rowout_blocks_ms=rg[ro["name"].replace(
                 f"persistent {gsp.STORE}", "blocks")]["ms"]),
    ]


# phase 23: the component-separation workflow at the headline length, and
# the ridge on the card against the CPU on Tx's first columns
N_SEP = N
RIDGE_COLS = 16_384
RIDGE_PROFILE_COLS = 2048
SEP_WAVELET = ("gmw", {"beta": 6.0})


_SASS = {}


def library_functions():
    """[SASS of each function] of the built library (cuobjdump -sass, read
    once a process), or why it could not be read."""
    import re
    import shutil
    from ssqueeze_rs_tpu_torch import _build
    if "fns" not in _SASS:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        if not os.path.exists(tool):
            return "cuobjdump not found"
        res = subprocess.run([tool, "-sass", _build.library_path()],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            return f"cuobjdump failed ({res.returncode})"
        _SASS["fns"] = re.split(r"\n\s*Function : ", res.stdout)[1:]
    return _SASS["fns"]


def hgmma_count():
    """HGMMA instructions in each instantiation of kernel I (by its wgmma
    width N) in the built library's SASS (cuobjdump -sass), or why they
    could not be counted."""
    import re
    fns = library_functions()
    if isinstance(fns, str):
        return fns
    counts = {}
    for fn in fns:
        m = re.match(r"\S*reassign_mxu_kernelILi(\d+)E", fn)
        if m:
            counts[int(m.group(1))] = fn.count("HGMMA")
    return dict(sorted(counts.items())) or "no kernel I in the SASS"


def loop_fadds(fn):
    """(FADDs, FADDs inside a loop) of one function's SASS: a loop is the
    span from a backward branch's target to the branch."""
    import re
    insts, labels, pending = [], {}, []
    for line in fn.splitlines():
        text = line.strip()
        m = re.match(r"(\.L_x_\d+):", text)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"/\*([0-9a-f]{4,})\*/\s+(.*)", text)
        if m:
            addr = int(m.group(1), 16)
            labels.update((p, addr) for p in pending)
            pending = []
            insts.append((addr, m.group(2)))
    loops = []
    for addr, text in insts:
        m = re.search(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))",
                      text)
        if m:
            to = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
            if to is not None and to <= addr:
                loops.append((to, addr))
    fadds = [a for a, text in insts if re.search(r"\bFADD\b", text)]
    return len(fadds), sum(any(lo <= a <= hi for lo, hi in loops)
                           for a in fadds)


def fadd_count():
    """{J8's persistent kernel by store route and output: (FADDs, FADDs
    inside a loop)} in the built library's SASS, or why they could not be
    counted."""
    import re
    from ssqueeze_rs_tpu_torch.tools import grid_slope_probe as gsp
    fns = library_functions()
    if isinstance(fns, str):
        return fns
    counts = {}
    for fn in fns:
        m = re.match(r"\S*grid_slope_persistentILi(\d)ELi(\d)E", fn)
        if m:
            counts[f"{gsp.STORES[int(m.group(1))]} "
                   f"{'vary' if m.group(2) == '1' else 'const'}"] = \
                loop_fadds(fn)
    return dict(sorted(counts.items())) or "no J8 kernel in the SASS"


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
    from ssqueeze_rs_tpu_torch.ops import reassign_cuda as R
    from ssqueeze_rs_tpu_torch.ops.ssqueeze import plan_ssqueeze

    names23 = ("cwt_phase", "cwt_fused", "ifft_halfband", "reassign",
               "reassign4", "reassign_mxu")

    def zero_counts():
        zero_launch_counts(*names23)

    def counts():
        return counted_launches(*names23)

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
    # a complex128 input runs B in double (its planes kept float64)
    zero_launch_counts("reassign_f64")
    W64, w64 = Wx.to(torch.complex128), w.double()
    T64 = algos.indexed_sum_onfly(W64, w64, freqs, const_arr, logscale=True,
                                  flipud=True)
    moved64 = counted_launches("reassign_f64")["reassign_f64"]
    path_launches["reassign_f64"] = moved64
    P64 = torch.complex(*R.reassign_plain(
        W64.real, W64.imag, w64, torch.as_tensor(const_arr, device=dev),
        params, mode, True, na))
    rel64 = rel(torch, T64, P64)
    del W64, w64, T64, P64
    out["algos"] = dict(rows=na, onfly_rel=rel_on, fast_rel=rel_fast,
                        onfly_repeat=rep_on, fast_repeat=rep_fast,
                        onfly_ms=ms_on, fast_ms=ms_fast,
                        profile=dict(indexed_sum_onfly=prof_on,
                                     ssqueeze_fast=prof_fast),
                        indexed_sum_repeat=rep_sum, indexed_sum_rel64=rel_sum,
                        indexed_sum_ms=ms_sum, float64_rel=rel64,
                        float64_launches=moved64, launches=moved)
    print(f"[23] algos on the headline planes ({na} x {nh}): "
          f"indexed_sum_onfly (B) rel {rel_on:.2e} vs plain, repeat "
          f"{rep_on}, {ms_on:.3f} ms ({breakdown_line(prof_on)}); "
          f"ssqueeze_fast (B') rel {rel_fast:.2e}, repeat {rep_fast}, "
          f"{ms_fast:.3f} ms ({breakdown_line(prof_fast)}); indexed_sum "
          f"bitwise over 5 calls {rep_sum}, vs float64 {rel_sum:.2e}, "
          f"{ms_sum:.3f} ms; complex128 indexed_sum_onfly (B in double) rel "
          f"{rel64:.2e}, {moved64} launch; launches {moved} "
          f"({card})")
    check(rel_on <= 1e-5 and rel_fast <= 1e-5,
          f"algos vs plain: onfly {rel_on:.2e}, fast {rel_fast:.2e}")
    check(rep_on and rep_fast and rep_sum, "algos differ between runs")
    check(rel_sum < 1e-6, f"indexed_sum vs float64 {rel_sum:.2e}")
    check(moved64 == 1 and rel64 <= 1e-12,
          f"algos on complex128: {moved64} double launches, rel {rel64:.2e}")
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



# The card's published float64 rate outside the tensor cores (NVIDIA H100
# SXM data sheet, at 700 W): the operations bound of the double kernels.
F64_FLOP_S = 34e12
N_F64_CPU = 16_384      # the float64 transforms against the one-thread CPU
F64_BAR = 1e-10         # float64 transforms: max|d| / max|ref|
F64_TX_BAR = 1e-9       # float64 Tx: max|d| / sum|Tx|


def bound64(nbytes, flops):
    """`bound` for a kernel doing float64 operations."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / F64_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def row_ordered(torch, R, wr, wi, w, const, prm, mode, flipud, nf):
    """Tx of the 3-plane contract summed in increasing row order on the
    card: the plain bins and products, then one `scatter_add_` a row. No
    two entries of one row share a (bin, column), so every add is one
    IEEE add, in row order: the sums the double kernels B and B' must
    equal bit for bit (masked entries add 0 to bin 0)."""
    k = R.bin_indices(w, mode, prm, flipud, nf)
    mask = k >= 0
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    vr = torch.where(mask, wr * const[:, None], zero)
    vi = torch.where(mask, wi * const[:, None], zero)
    k = torch.where(mask, k, torch.zeros_like(k))
    txr = torch.zeros((nf,) + w.shape[1:], dtype=w.dtype, device=w.device)
    txi = torch.zeros_like(txr)
    for i in range(w.shape[0]):
        txr.scatter_add_(0, k[i:i + 1], vr[i:i + 1])
        txi.scatter_add_(0, k[i:i + 1], vi[i:i + 1])
    return txr, txi


FP64_OPS = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX")   # the FP64 pipe's


def sass_fp64(path, symbol):
    """{template arguments: (FP64 instructions of the main body, of the
    whole function)} of each instantiation of the kernel `symbol` with
    int template arguments in the cubin or library at path, counted in
    `cuobjdump -sass` (FP64_OPS). The main body ends at the last EXIT
    before the first RET: after it come the out-of-line subroutines (the
    bins' exact path, the divisions' slow paths), which few entries run.
    Static counts: every branch once."""
    import re
    from ssqueeze_rs_tpu_torch import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr[-300:]}")
    ops, key = {}, None
    for line in res.stdout.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            m = re.search(symbol + r"I((?:Li\d+E)+)E", fn.group(1))
            key = (tuple(int(x) for x in re.findall(r"Li(\d+)E", m.group(1)))
                   if m else None)
            if key:
                ops[key] = []
            continue
        op = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                       line)
        if key and op:
            ops[key].append(op.group(1).split(".")[0])
    check(bool(ops), f"no {symbol} in the SASS of {path}")
    counts = {}
    for key, seq in ops.items():
        ret = seq.index("RET") if "RET" in seq else len(seq)
        end = max((i for i in range(ret) if seq[i] == "EXIT"), default=ret)
        counts[key] = (sum(o in FP64_OPS for o in seq[:end + 1]),
                       sum(o in FP64_OPS for o in seq))
    return counts


def entry_path_fp64():
    """{(planes, bin mode, transform): FP64 instructions an entry} of the
    double B/B' kernels' screened path: the main body of
    tools/reassign64_path.cu's entry_path, built here into a cubin."""
    import tempfile
    from ssqueeze_rs_tpu_torch import _build
    src = os.path.join(HERE, "ssqueeze_rs_tpu_torch", "tools",
                       "reassign64_path.cu")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        cubin = os.path.join(work, "path.cubin")
        res = subprocess.run([_build._nvcc()] + _build.ARCH +
                             ["-std=c++17", "-O3", "-cubin", "-o", cubin,
                              src], capture_output=True, text=True,
                             timeout=300)
        check(res.returncode == 0, f"nvcc {src}: {res.stdout[-500:]}"
              f"{res.stderr[-500:]}")
        return {k: v[0] for k, v in sass_fp64(cubin, "entry_path").items()}


def float64_phases(np, torch, dev, card, results, ctx):
    """Phase 24: kernels B, B', C and C' in double against their float64
    plain versions at the headline (293 x 160 000) and at nf = 1025 and
    2000; the drop-in `compat` API at N = 160 000 in float64 (ssq_cwt with
    the Rust default scales, cwt + icwt, stft and ssq_stft at n_fft = 598)
    with device ms, D2H ms and peak memory, each against the one-thread CPU
    at N = 16 384; ssq_cwt(dtype='float64') at the headline and its
    gradients (C' and C in double); cwt and ssq_cwt with cache_wavelet.
    Returns the four double kernels' entries of the JSON line."""
    from ssqueeze_rs_tpu_torch import (_build, compat, cwt, icwt, ssq_cwt,
                                       ssq_stft, stft)
    from ssqueeze_rs_tpu_torch.config import EPS32, EPS64
    from ssqueeze_rs_tpu_torch.ops import reassign_cuda as R
    from ssqueeze_rs_tpu_torch.ops.cwt import _FB_CACHE
    from ssqueeze_rs_tpu_torch.ops.ssqueeze import bin_params, plan_ssqueeze

    f64 = torch.float64
    out = {}
    wavelet, scales = ctx["wavelet"], ctx["scales"]
    x64 = ctx["requests"]["noise"][0].to(f64)
    n = x64.shape[-1]
    rng = np.random.default_rng(24)

    def zero_counts():
        zero_launch_counts(*ENTRIES)

    def counts():
        return counted_launches(*ENTRIES)

    def only(**nonzero):
        want = {k: 0 for k in counts()}
        want.update(nonzero)
        return want

    # (a) the double kernels on float64 planes: the headline (293 x 160
    # 000) at its own plan (nf = 293) and at log grids over the same band
    # (nf = 1025 and 2000), and compat.ssq_cwt's planes (the Rust default
    # scales, 490 x 160 000) at their own plan (nf = 490)
    fp64 = sass_fp64(_build.library_path(), "reassign_kernel_f64")
    path64 = entry_path_fp64()
    out["sass_fp64"] = {str(k): v for k, v in fp64.items()}
    out["entry_fp64"] = {str(k): v for k, v in path64.items()}
    print("[24] FP64 instructions (DADD DMUL DFMA DSETP DMNMX, cuobjdump "
          "-sass, static) of the double B/B' kernels: an entry on the "
          "screened path (tools/reassign64_path.cu) by (planes, bin mode, "
          "transform): " + ", ".join(f"{k} {v}" for k, v in
                                     sorted(path64.items())) +
          "; each kernel by (columns, row groups, blocks an SM, planes), "
          "main body (every mode and transform once) / whole function (with "
          "the exact path and the divisions' slow paths): " + ", ".join(
              f"{k} {v[0]} / {v[1]}" for k, v in sorted(fp64.items())))
    torch.cuda.empty_cache()
    out["allocated_at_start_gb"] = torch.cuda.memory_allocated() / 1e9
    rust = compat._default_rust_scales(n)
    K = {}
    lines = []

    def same(a, b):
        return all(torch.equal(u, v) for u, v in zip(a, b))

    def tx_off(k, p):
        """(max|k - p| / max|p|, max|k - p|) over the complex entries of two
        (real, imag) plane pairs."""
        d = float(torch.hypot(k[0] - p[0], k[1] - p[1]).max())
        return d / float(torch.hypot(*p).max()), d

    def fp64_bound(nbytes, planes, mode, entries):
        """bound64 with the SASS count of an entry's FP64 instructions on
        the screened path, for the entries the mask leaves (each
        instruction one slot of the 64-lane pipe: 2 of the rate's
        operations)."""
        key = (planes, R.MODES[mode], R.TRANSFORMS["cwt"])
        return bound64(nbytes, 2 * path64[key] * entries)

    for set_name, sc in (("headline", scales), ("compat", rust)):
        Wx, _, dWx = cwt(x64, wavelet, scales=sc, derivative=True,
                         dtype="float64")
        planes = [p.contiguous() for p in (Wx.real, Wx.imag, dWx.real,
                                           dWx.imag)]
        del Wx, dWx
        na = planes[0].shape[0]
        freqs, const_arr, mode, params = plan_ssqueeze(
            n, na, None, sc, fs=1.0, maprange="peak", wavelet=wavelet)
        const = torch.as_tensor(const_arr, dtype=f64, device=dev)
        zeros = torch.zeros(na, dtype=f64, device=dev)
        gamma = 10 * EPS64
        w = R.phase_w(*planes, zeros, gamma, "cwt")
        plans = {len(freqs): (mode, params)}
        if set_name == "headline":
            for nfx in (1025, 2000):
                plans[nfx] = bin_params(np.geomspace(
                    float(freqs.min()), float(freqs.max()), nfx), True)
        # one plan at a time, each output checked and freed before the
        # next (at nf = 2000 a Tx plane pair in float64 is 5.1 GB)
        for nfx, (m, prm) in plans.items():
            head = nfx == len(freqs) and set_name == "headline"
            # timed: the headline (nf = 293), compat.ssq_cwt's plan (nf =
            # 490) and nf = 1025 on the headline planes
            timed = head or set_name == "compat" or nfx == 1025
            a4 = (*planes, const, zeros, gamma, prm, m, True, nfx, "cwt")
            a3 = (planes[0], planes[1], w, const, prm, m, True, nfx)
            row = dict(planes=set_name, na=na, nf=nfx, mode=m, tx_rel={},
                       plan={p: R._f64_plan(nfx, p)._asdict() for p in (3, 4)},
                       masked=float(torch.isinf(w).double().mean()))
            ordered = row_ordered(torch, R, planes[0], planes[1], w, const,
                                  prm, m, True, nfx)
            fwd = {"reassign_f64": ("B", R.reassign, R.reassign_plain, a3,
                                    3),
                   "reassign4_f64": ("B'", R.reassign4, R.reassign4_plain,
                                     a4, 4)}
            for name, (key, fn, plain, args, n_in) in fwd.items():
                k1 = fn(*args)
                row[key + " repeat"] = same(k1, fn(*args))
                row[key + " row-ordered"] = same(k1, ordered)
                row["out_dtype"] = str(k1[0].dtype)
                p1 = plain(*args)
                row["tx_rel"][key], err = tx_off(k1, p1)
                if timed:
                    bnd = fp64_bound(tensor_bytes(args[:n_in + 1], k1),
                                     n_in, m, w.numel() * (1 - row["masked"]))
                    row[key + " ms"] = cuda_ms(torch, lambda: fn(*args))
                    row[key + " plain_ms"] = cuda_ms(
                        torch, lambda: plain(*args), warmup=1, iters=5)
                    row[key + " bound"] = bnd
                    if head:
                        K[name] = dict(max_abs_err=err, bound=bnd,
                                       ms=row[key + " ms"],
                                       plain_ms=row[key + " plain_ms"])
                del k1, p1
            del ordered
            bwd = {"reassign_bwd_f64": ("C", R.reassign_bwd,
                                        R.reassign_bwd_plain,
                                        lambda g: (w, const, *g, prm, m,
                                                   True, nfx), (w, const),
                                        BIN_FLOPS),
                   "reassign4_bwd_f64": ("C'", R.reassign4_bwd,
                                         R.reassign4_bwd_plain,
                                         lambda g: (*planes, const, zeros,
                                                    *g, gamma, prm, m, True,
                                                    nfx, "cwt"),
                                         (planes, const, zeros),
                                         BIN4_FLOPS)}
            # a cotangent that names its bin (row k holds k + 1): C's and
            # C''s outputs are then (k + 1) * const[i], equal to the plain
            # gather's exactly where every entry's bin is the plain bin
            g = (torch.arange(1, nfx + 1, dtype=f64, device=dev)[:, None]
                 .expand(nfx, n).contiguous(),
                 torch.zeros(nfx, n, dtype=f64, device=dev))
            for key, fn, plain, args, _, _ in bwd.values():
                row[key + " bins equal"] = same(fn(*args(g)), plain(*args(g)))
            g = tuple(torch.as_tensor(rng.standard_normal((nfx, n)),
                                      dtype=f64, device=dev)
                      for _ in range(2))
            for name, (key, fn, plain, args, ins, flops) in bwd.items():
                k1, p1 = fn(*args(g)), plain(*args(g))
                row[key + " equal"] = same(k1, p1)
                row[key + " repeat"] = same(k1, fn(*args(g)))
                if head:
                    K[name] = dict(
                        max_abs_err=max(float((u - v).abs().max())
                                        for u, v in zip(k1, p1)),
                        bound=bound64(tensor_bytes(ins, g, k1),
                                      flops * w.numel()),
                        ms=cuda_ms(torch, lambda: fn(*args(g))),
                        plain_ms=cuda_ms(torch, lambda: plain(*args(g)),
                                         warmup=1, iters=5))
                del k1, p1
            del g
            if head:
                # float32 B and B' on the same planes rounded to float32:
                # their kernels are not changed by the double ones
                p32 = [p.float() for p in planes]
                w32 = R.phase_w(*p32, zeros.float(), 10 * EPS32, "cwt")
                a32 = {"B": (R.reassign, (p32[0], p32[1], w32,
                                          const.float(), prm, m, True, nfx)),
                       "B'": (R.reassign4, (*p32, const.float(),
                                            zeros.float(), 10 * EPS32, prm,
                                            m, True, nfx, "cwt"))}
                row["float32_ms"] = {k: cuda_ms(torch, lambda: fn(*args))
                                     for k, (fn, args) in a32.items()}
                del p32, w32, a32
                # the launch's other inputs: n odd (8-byte copies and
                # stores in place of the TMA) and a batch of two (the TMA
                # maps' item axis), each to the row-ordered sums
                half = n // 2
                for tag, cut in (("odd n", lambda t: t[..., :n - 1]),
                                 ("batch of 2", lambda t: torch.stack(
                                     [t[..., :half], t[..., half:2 * half]]))):
                    pl = [cut(p).contiguous() for p in planes]
                    wc = cut(w).contiguous()
                    items = pl[0].reshape(-1, na, pl[0].shape[-1])
                    wi_ = wc.reshape(-1, na, wc.shape[-1])
                    ims = pl[1].reshape(items.shape)
                    refs = [row_ordered(torch, R, items[b], ims[b], wi_[b],
                                        const, prm, m, True, nfx)
                            for b in range(items.shape[0])]
                    ref = tuple(torch.stack([r[z] for r in refs]).reshape(
                        pl[0].shape[:-2] + (nfx, pl[0].shape[-1]))
                        for z in (0, 1))
                    got3 = R.reassign(pl[0], pl[1], wc, const, prm, m, True,
                                      nfx)
                    got4 = R.reassign4(*pl, const, zeros, gamma, prm, m, True,
                                       nfx, "cwt")
                    row[f"B {tag} row-ordered"] = same(got3, ref)
                    row[f"B' {tag} row-ordered"] = same(got4, ref)
                    del pl, wc, items, wi_, ims, refs, ref, got3, got4
            out[f"nf{nfx}"] = row
            rel_b, rel_b4 = row["tx_rel"]["B"], row["tx_rel"]["B'"]
            flags = {k: v for k, v in row.items() if isinstance(v, bool)}
            plan4 = row["plan"][4]
            lines.append(
                f"{set_name} {na} rows, nf={nfx} ({m}; B' plan "
                f"{plan4['cols']} columns x {plan4['groups']} row groups, "
                f"{plan4['stages']} stages, {plan4['blocks']} block(s) an SM, "
                f"{plan4['flight'] / 1024:.0f} KB in flight an SM): B Tx rel "
                f"{rel_b:.2e}, B' {rel_b4:.2e}; " +
                ", ".join(f"{k} {v}" for k, v in flags.items()) +
                "".join(f"; {k} {row[k + ' ms']:.3f} ms (plain "
                        f"{row[k + ' plain_ms']:.3f}, bound "
                        f"{row[k + ' bound'][0]:.3f} by "
                        f"{row[k + ' bound'][1]})"
                        for k in ("B", "B'") if k + " ms" in row) +
                ("; float32 on these planes: " + ", ".join(
                    f"{k} {v:.3f} ms" for k, v in row["float32_ms"].items())
                 if "float32_ms" in row else ""))
            check(row["out_dtype"] == "torch.float64", f"nf={nfx}: Tx in "
                  f"{row['out_dtype']}")
            check(max(rel_b, rel_b4) <= 1e-12,
                  f"double B/B' at nf={nfx}: Tx rel {row['tx_rel']}")
            check(all(flags.values()), f"double kernels at nf={nfx}: {flags}")
        del planes, w
        torch.cuda.empty_cache()
    times = ", ".join(f"{k} {v['ms']:.3f} ms (plain {v['plain_ms']:.3f}, "
                      f"bound {v['bound'][0]:.3f})" for k, v in K.items())
    print(f"[24] double kernels on float64 planes: " + "; ".join(lines) +
          f" | at the headline: {times} ({card})")
    lap("24 double kernels")

    # (b) the main path: compat at N = 160 000, ssq_cwt(float64) at the
    # headline and its gradients, with every launch counted
    t = np.arange(n) / 1000.0
    xs_np = (np.random.default_rng(2).standard_normal(n) +
             np.cos(2 * np.pi * (5 * t + 1.5 * t * t)))
    xs = torch.as_tensor(xs_np, dtype=f64, device=dev)
    win = np.hanning(N_FFT + 1)[:-1]
    # the compat calls as a user makes them, in order (icwt inverts the
    # numpy Wx that cwt returned), and the device part of each (the same
    # transforms, their outputs left on the card)
    calls = {
        "ssq_cwt": lambda x, d: compat.ssq_cwt(x, device=d),
        "cwt": lambda x, d: compat.cwt(x, device=d),
        "icwt": lambda Wx, d: compat.icwt(Wx, device=d),
        "stft": lambda x, d: compat.stft(x, N_FFT, 1, win, device=d),
        "ssq_stft": lambda x, d: compat.ssq_stft(x, win, n_fft=N_FFT,
                                                 device=d),
    }

    def run_calls(x, d):
        """{name: first output} of the compat calls on x (device d), with
        their host ms (each to a synchronize)."""
        res, ms = {}, {}
        for name, fn in calls.items():
            arg = res["cwt"] if name == "icwt" else x
            r, ms[name] = wall_ms(torch, lambda: fn(arg, d))
            res[name] = r[0] if isinstance(r, tuple) else r
            if name.startswith("ssq"):
                res[name + " freqs"] = r[1]
        return res, ms

    wx_dev = {}
    dev_calls = {
        "ssq_cwt": lambda: ssq_cwt(xs, "gmw", scales=rust, nv=32,
                                   dtype="float64")[0],
        "cwt": lambda: wx_dev.setdefault("Wx", cwt(
            xs, "gmw", scales=rust, dtype="float64")[0]),
        "icwt": lambda: icwt(wx_dev["Wx"], "gmw", scales=rust),
        "stft": lambda: stft(xs, window=win, n_fft=N_FFT, win_len=N_FFT,
                             modulated=False, dtype="float64"),
        "ssq_stft": lambda: ssq_stft(xs, window=win, n_fft=N_FFT, fs=1.0,
                                     dtype="float64")[0],
    }
    groups = (("B'", ("reassign_kernel",)), K_FFT)
    user = None if dev.type == "cuda" else dev    # the device rule's default
    zero_counts()
    res, e2e = run_calls(xs, user)
    C = {name: dict(e2e_ms=e2e[name], shape=list(res[name].shape))
         for name in calls}
    for name in calls:
        check(isinstance(res[name], np.ndarray) and
              np.isfinite(res[name]).all(),
              f"compat.{name}: not a finite host array")
    del res
    # ssq_cwt(float64) at the headline (B'), through its w route (B), and
    # the gradient of each (C', C): loss sum|Tx|^2 + sum|Wx|^2
    head = lambda get_w=False: ssq_cwt(                      # noqa: E731
        xs, wavelet, scales=scales, dtype="float64", get_w=get_w)
    (Tx_h, *_), ms_h = wall_ms(torch, head)
    _, ms_w = wall_ms(torch, lambda: head(True))
    xg = xs.clone().requires_grad_(True)

    def grad(get_w=False):
        Tg, Wg, *_ = ssq_cwt(xg, wavelet, scales=scales, dtype="float64",
                             get_w=get_w)
        ((Tg.abs() ** 2).sum() + (Wg.abs() ** 2).sum()).backward()
        gx = xg.grad
        xg.grad = None
        return gx

    (gx, peak_g, base_g), ms_g = wall_ms(torch, lambda: peak_gb(torch, grad))
    gx_w, ms_gw = wall_ms(torch, lambda: grad(True))
    moved = counts()
    path = dict(reassign_f64=moved["reassign_f64"],
                reassign4_f64=moved["reassign4_f64"],
                reassign_bwd_f64=moved["reassign_bwd_f64"],
                reassign4_bwd_f64=moved["reassign4_bwd_f64"])
    out["path_launches"] = moved
    check(moved == only(reassign_f64=2, reassign4_f64=4, reassign_bwd_f64=1,
                        reassign4_bwd_f64=1),
          f"float64 main path: launches {moved}")
    check(Tx_h.dtype == torch.complex128 and Tx_h.is_cuda and
          bool(torch.isfinite(Tx_h).all()), "ssq_cwt(float64) at the "
          "headline: Tx not finite complex128 on the card")
    check(bool(torch.isfinite(gx).all()) and gx.dtype == f64 and
          bool(torch.isfinite(gx_w).all()), "float64 gradients not finite")
    rows_h = list(Tx_h.shape)
    del Tx_h, gx, gx_w
    # steady times of the same (median of 3 after one more call)
    steady = dict(ssq_cwt=host_ms(torch, head, n=3)[0],
                  ssq_cwt_get_w=host_ms(torch, lambda: head(True), n=3)[0],
                  grad=host_ms(torch, grad, n=3)[0],
                  grad_get_w=host_ms(torch, lambda: grad(True), n=3)[0])
    out["headline"] = dict(first_ms=dict(ssq_cwt=ms_h, ssq_cwt_get_w=ms_w,
                                         grad=ms_g, grad_get_w=ms_gw),
                           steady_ms=steady, grad_peak_gb=peak_g,
                           grad_base_gb=base_g, rows=rows_h)
    del xg
    # each compat call: its device part (ms, device ms, peak memory) and
    # the fetch of its output to the host
    for name, fn in dev_calls.items():
        r, peak, base = peak_gb(torch, fn)
        _, ms_d2h = wall_ms(torch, lambda: r.cpu().numpy())
        nbytes = r.numel() * r.element_size()
        C[name].update(
            out_bytes=nbytes, d2h_ms=ms_d2h, d2h_gb_s=nbytes / ms_d2h / 1e6,
            device_part_ms=cuda_ms(torch, fn, warmup=1, iters=3),
            peak_gb=peak, base_gb=base,
            profile=device_breakdown(torch, fn, groups, calls=2))
        del r
    wx_dev.clear()
    out["compat"] = C
    print(f"[24] compat (float64) at N={n}: " + "; ".join(
        f"{k} {v['e2e_ms']:.1f} ms end to end, {v['shape']}, device part "
        f"{v['device_part_ms']:.2f} ms ({breakdown_line(v['profile'])}), "
        f"D2H {v['d2h_ms']:.1f} ms for {v['out_bytes'] / 1e9:.3f} GB "
        f"({v['d2h_gb_s']:.2f} GB/s), peak {v['peak_gb']:.2f} GB"
        for k, v in C.items()) + f"; ssq_cwt(float64) at the headline "
        f"({rows_h[0]} rows) first call {ms_h:.2f} ms, steady "
        f"{steady['ssq_cwt']:.2f} (get_w {ms_w:.2f}, "
        f"{steady['ssq_cwt_get_w']:.2f}); "
        f"gradient first {ms_g:.1f} ms, steady {steady['grad']:.2f} (get_w "
        f"{ms_gw:.1f}, {steady['grad_get_w']:.2f}), peak {peak_g:.2f} GB; "
        f"launches {path} ({card})")
    lap("24 compat at 160k")

    # (c) the card against the one-thread CPU at N = 16 384
    xc = xs_np[:N_F64_CPU]
    g, _ = run_calls(torch.as_tensor(xc, device=dev), user)
    c, _ = cpu_ref(torch, lambda: run_calls(torch.as_tensor(xc), "cpu"))
    cpu = {}
    for name in calls:
        if name.startswith("ssq"):
            err = float(np.abs(g[name] - c[name]).max() /
                        np.abs(c[name]).sum())
            bar = F64_TX_BAR
            check(np.array_equal(g[name + " freqs"], c[name + " freqs"]),
                  f"compat.{name}: freqs differ")
        else:
            err = float(np.abs(g[name] - c[name]).max() /
                        np.abs(c[name]).max())
            bar = F64_BAR
        cpu[name] = err
        check(err < bar, f"compat.{name} card vs CPU at N={N_F64_CPU}: "
              f"{err:.2e} >= {bar}")
    out["vs_cpu"] = cpu
    print(f"[24] compat card vs one-thread CPU at N={N_F64_CPU}: " +
          ", ".join(f"{k} {v:.2e}" for k, v in cpu.items()) +
          f" (bars: transforms {F64_BAR} of max, Tx {F64_TX_BAR} of sum|Tx|)")
    del xs, g, c

    # (d) cache_wavelet at the headline (float32): cwt (D) and ssq_cwt
    # (A, B) with the cached filterbank against without
    x32 = ctx["requests"]["noise"][0]
    n_cached = len(_FB_CACHE)
    CW = {}
    for name, fn, want in (
            ("cwt", lambda cw: cwt(x32, wavelet, scales=scales,
                                   cache_wavelet=cw),
             only(cwt_fused=1)),
            ("ssq_cwt", lambda cw: ssq_cwt(x32, wavelet, scales=scales,
                                           cache_wavelet=cw),
             only(cwt_phase=1, reassign=1))):
        ref = fn(None)
        fn(True)                          # samples and uploads once
        zero_counts()
        got = fn(True)
        check(counts() == want, f"{name} with cache_wavelet: launches "
              f"{counts()}")
        torch.cuda.synchronize()
        wx, wx_ref = (got[0], ref[0]) if name == "cwt" else (got[1], ref[1])
        wx_rel = rel(torch, wx, wx_ref)
        row = dict(wx_rel=wx_rel, ms=cuda_ms(torch, lambda: fn(True)),
                   ms_without=cuda_ms(torch, lambda: fn(None)),
                   profile=device_breakdown(torch, lambda: fn(True),
                                            (K_A, K_D, K_B, K_FFT)),
                   profile_without=device_breakdown(
                       torch, lambda: fn(None), (K_A, K_D, K_B, K_FFT)))
        if name == "ssq_cwt":
            row["tx_col_rel"], row["tx_total_rel"] = tx_metrics(
                np, got[0].cpu().numpy(), ref[0].cpu().numpy())
            check(row["tx_col_rel"] < 1e-4, f"ssq_cwt with cache_wavelet: "
                  f"Tx col rel {row['tx_col_rel']:.2e}")
        check(wx_rel < 1e-5, f"{name} with cache_wavelet: Wx rel "
              f"{wx_rel:.2e} >= 1e-5")
        CW[name] = row
        del ref, got, wx, wx_ref
    fb = list(_FB_CACHE.values())[-1]
    CW["cache_bytes"] = sum(v.numel() * v.element_size() for v in fb)
    CW["entries_added"] = len(_FB_CACHE) - n_cached
    out["cache_wavelet"] = CW
    print("[24] cache_wavelet at the headline: " + "; ".join(
        f"{k} Wx rel {v['wx_rel']:.2e}"
        + (f", Tx col rel {v['tx_col_rel']:.2e}" if k == "ssq_cwt" else "")
        + f", {v['ms']:.3f} ms vs {v['ms_without']:.3f} without; device "
        f"{breakdown_line(v['profile'])} vs without "
        f"{breakdown_line(v['profile_without'])}"
        for k, v in CW.items() if isinstance(v, dict)) +
        f"; the cache holds {CW['cache_bytes'] / 1e6:.1f} MB on the device "
        f"({CW['entries_added']} entry) ({card})")
    results["float64"] = out
    lap("24 CPU checks, cache_wavelet")

    src = {"reassign_f64": ("reassign64.cu", "reassign_pallas.py:175"),
           "reassign4_f64": ("reassign64.cu", "reassign_pallas.py:175"),
           "reassign_bwd_f64": ("reassign_bwd.cu", "reassign_pallas.py:485"),
           "reassign4_bwd_f64": ("reassign_bwd.cu", "reassign_pallas.py:485")}
    return [kernel_entry(name, src[name][0], src[name][1], path[name],
                         K[name]["max_abs_err"], K[name]["ms"],
                         K[name]["plain_ms"], K[name]["bound"], None)
            for name in src]


# Phase 25: past the bins a launch takes, and the sharded transforms
NF_STFT_BIG = 8192      # ssq_stft's n_fft past B''s 3632 bins: nf = 4097
NF_RANGED = 4097        # B and B' in double, ranged
NF_MANY = 5000          # ssq_cwt's ssq_freqs and kernel I, ranged
RANGE_SPLIT = 150       # a forced split of nf = 293 into 150 + 143
MXU_BAR = 2e-5          # kernel I against B': sum|d| / sum|B'|


def launch_counts():
    """Every kernel launch counter the main paths move, by JSON name."""
    return counted_launches("stft_dft", "ssq_stft", "istft_ola",
                            "cwt_phase", "cwt_fused", "ifft_halfband",
                            "reassign", "reassign4", "reassign_mxu",
                            "reassign_f64", "reassign4_f64", "reassign_bwd",
                            "reassign4_bwd")


def moved(before):
    """The launch counters that moved since `before`, by how much."""
    return {k: v - before[k] for k, v in launch_counts().items()
            if v != before[k]}


def range_phases(np, torch, dev, card, results, ctx):
    """Phase 25 (a): the scatter past the bins one launch takes. ssq_stft
    at n_fft = 8192 (nf = 4097, B' in two ranges) and ssq_cwt with 5000
    ssq_freqs (B in two ranges) end to end at N = 160 000, each Tx the
    same bits as the kernel on its planes and within 1e-5 of max|Tx| of
    the plain version; B and B' in double at nf = 4097 equal to the
    row-ordered sum; kernel I at nf = 5000 against B' (MXU_BAR); each
    bitwise repeated and timed beside its plain version and its bound
    (each range reads every plane again); at nf = 293 a split forced
    into ranges of 150 against the one launch. Returns the launches of
    the two end-to-end calls."""
    from ssqueeze_rs_tpu_torch import cwt, ssq_cwt, ssq_stft, stft
    from ssqueeze_rs_tpu_torch.config import EPS32, EPS64
    from ssqueeze_rs_tpu_torch.ops import fft_cuda, reassign_cuda as R
    from ssqueeze_rs_tpu_torch.ops.cwt import cwt_phase_args
    from ssqueeze_rs_tpu_torch.ops.ssq_stft import make_Sfs
    from ssqueeze_rs_tpu_torch.ops.ssqueeze import bin_params, plan_ssqueeze
    from ssqueeze_rs_tpu_torch.utils.pad import padsignal

    out, rows, path = {}, [], {}
    wavelet, scales = ctx["wavelet"], ctx["scales"]
    x = ctx["requests"]["noise"][0]
    n = x.shape[-1]
    sc = scales.squeeze(-1)
    na = len(sc)

    def same(a, b):
        return all(torch.equal(u, v) for u, v in zip(a, b))

    def off(k, p):
        """(max|k - p| / max|p|, max|k - p|) over the complex entries."""
        d = float(torch.hypot(k[0] - p[0], k[1] - p[1]).max())
        return d / float(torch.hypot(*p).max()), d

    def ranged_bound(planes, vecs, tx, ranges, flops64=False):
        """Each range reads every plane and row vector once; Tx is written
        once."""
        nbytes = ranges * tensor_bytes(planes, vecs) + tensor_bytes(tx)
        return (bound64 if flops64 else bound)(nbytes, 0.0)

    def row(name, key, nf, fn, plain, args, planes, vecs, ranges,
            ordered=None, flops64=False):
        before = launch_counts()
        k1 = fn(*args)
        launched = moved(before)
        rec = dict(nf=nf, ranges=ranges, launches=launched,
                   repeat=same(k1, fn(*args)))
        if ordered is not None:
            rec["row_ordered"] = same(k1, ordered)
        p1 = plain(*args)
        rec["tx_rel"], rec["tx_abs"] = off(k1, p1)
        rec["ms"] = cuda_ms(torch, lambda: fn(*args), warmup=1, iters=5)
        rec["plain_ms"] = cuda_ms(torch, lambda: plain(*args), warmup=1,
                                  iters=3)
        rec["bound_ms"], rec["bound_by"] = ranged_bound(planes, vecs, k1,
                                                        ranges, flops64)
        out[key] = rec
        rows.append(f"{name} nf={nf} in {ranges} ranges (launches "
                    f"{launched}): Tx rel "
                    f"{rec['tx_rel']:.2e}, repeat {rec['repeat']}"
                    + (f", == row-ordered sum {rec['row_ordered']}"
                       if ordered is not None else "")
                    + f" | {rec['ms']:.3f} ms vs plain "
                    f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.3f} "
                    f"ms ({rec['bound_by']})")
        check(rec["repeat"], f"{name} at nf={nf} differs between two runs")
        check(sum(launched.values()) == ranges, f"{name} at nf={nf}: "
              f"launches {launched}, not one a range ({ranges})")
        return k1, p1

    # ssq_stft at n_fft = 8192 end to end, then B' on its planes
    nf = NF_STFT_BIG // 2 + 1
    before = launch_counts()
    Tx, Sx, *_ = ssq_stft(x, n_fft=NF_STFT_BIG)
    torch.cuda.synchronize()
    path["ssq_stft"] = moved(before)
    check(path["ssq_stft"] == {"reassign4": 2},
          f"ssq_stft(n_fft={NF_STFT_BIG}) launches {path['ssq_stft']}")
    check(Tx.is_cuda and tuple(Tx.shape) == (nf, n) and
          bool(torch.isfinite(Tx).all()), "ssq_stft(n_fft=8192): Tx")
    e2e = cuda_ms(torch, lambda: ssq_stft(x, n_fft=NF_STFT_BIG), warmup=1,
                  iters=3)
    Sx, dSx = stft(x, n_fft=NF_STFT_BIG, derivative=True)
    Sfs_np = make_Sfs(Sx, 1.0)
    _, const_arr, mode, params = plan_ssqueeze(
        n, nf, Sfs_np, None, maprange="maximal", transform="stft")
    planes = [p.contiguous() for p in (Sx.real, Sx.imag, dSx.real,
                                       dSx.imag)]
    del Sx, dSx
    vecs = [torch.as_tensor(const_arr, dtype=torch.float32, device=dev),
            torch.as_tensor(Sfs_np, device=dev)]
    a4 = (*planes, *vecs, 10 * EPS32, params, mode, False, nf, "stft")
    k1, p1 = row("B' (ssq_stft planes)", "B'", nf, R.reassign4,
                 R.reassign4_plain, a4, planes, vecs, 2)
    out["B'"]["e2e_equal"] = bool(torch.equal(Tx.real, k1[0]) and
                                  torch.equal(Tx.imag, k1[1]))
    out["B'"]["e2e_ms"] = e2e
    check(out["B'"]["e2e_equal"], "ssq_stft(n_fft=8192) Tx differs from B' "
          "on its planes")
    bp_rel = out["B'"]["tx_rel"]
    check(bp_rel <= 1e-5, f"B' at nf={nf}: Tx rel {bp_rel:.2e} > 1e-5")
    del Tx, k1, p1, planes, a4
    torch.cuda.empty_cache()

    # ssq_cwt with 5000 ssq_freqs end to end, then B on kernel A's planes
    freqs, *_ = plan_ssqueeze(n, na, None, scales, fs=1.0, maprange="peak",
                              wavelet=wavelet)
    many = np.geomspace(float(freqs.min()), float(freqs.max()), NF_MANY)
    before = launch_counts()
    Tx, *_ = ssq_cwt(x, wavelet, scales=scales, fs=1.0, ssq_freqs=many)
    torch.cuda.synchronize()
    path["ssq_cwt"] = moved(before)
    check(path["ssq_cwt"] == {"cwt_phase": 1, "reassign": 2},
          f"ssq_cwt({NF_MANY} ssq_freqs) launches {path['ssq_cwt']}")
    check(tuple(Tx.shape) == (NF_MANY, n) and bool(torch.isfinite(Tx).all()),
          "ssq_cwt(5000 ssq_freqs): Tx")
    e2e = cuda_ms(torch, lambda: ssq_cwt(x, wavelet, scales=scales, fs=1.0,
                                         ssq_freqs=many), warmup=1, iters=3)
    xp, _, n1, _ = padsignal(x, "reflect", get_params=True)
    kA = fft_cuda.cwt_phase(*cwt_phase_args(xp, sc, 1.0, wavelet),
                            keep=(n1, n), gamma=10 * EPS32)
    _, const_arr, mode, params = plan_ssqueeze(n, na, many, scales, fs=1.0,
                                               maprange="peak",
                                               wavelet=wavelet)
    const = torch.as_tensor(const_arr, dtype=torch.float32, device=dev)
    a3 = (kA[0], kA[1], kA[2], const, params, mode, True, NF_MANY)
    k1, p1 = row("B (ssq_cwt planes)", "B", NF_MANY, R.reassign,
                 R.reassign_plain, a3, kA, [const], 2)
    out["B"]["e2e_equal"] = bool(torch.equal(Tx.real, k1[0]) and
                                 torch.equal(Tx.imag, k1[1]))
    out["B"]["e2e_ms"] = e2e
    check(out["B"]["e2e_equal"], "ssq_cwt(5000 ssq_freqs) Tx differs from "
          "B on kernel A's planes")
    check(out["B"]["tx_rel"] <= 1e-5, f"B at nf={NF_MANY}: Tx rel "
          f"{out['B']['tx_rel']:.2e} > 1e-5")
    del Tx, k1, p1

    # forced splits at the headline plan (nf = 293): ranges of 150
    nf0, prm0, mode0 = ctx["nf"], ctx["params"], ctx["mode"]
    a3h = (kA[0], kA[1], kA[2], ctx["const"], prm0, mode0, True, nf0)
    split = {}
    one = R.reassign(*a3h)
    forced, count = R._launch_ranges(
        R._entry("ssq_reassign", torch.float32), list(kA), [ctx["const"]],
        [R.MODES[mode0], 1], R._plan_floats(mode0, prm0), nf0,
        "reassign kernel", RANGE_SPLIT, lambda r: (R._block_cols(r),))
    split["B"] = (count, same(one, forced))
    del kA, a3h, one, forced

    # kernel I against B' at nf = 5000 on D's ssq_cwt planes (4 planes)
    args = cwt_phase_args(xp, sc, 1.0, wavelet)
    planes4 = [p.contiguous() for p in
               fft_cuda.cwt_fused(*args, keep=(n1, n), derivative=True)]
    del args
    zeros = torch.zeros(na, dtype=torch.float32, device=dev)
    a4 = (*planes4, const, zeros, 10 * EPS32, params, mode, True, NF_MANY,
          "cwt")
    kB4 = R.reassign4(*a4)
    old = os.environ.get("SSQ_TPU_REASSIGN_IMPL")
    os.environ["SSQ_TPU_REASSIGN_IMPL"] = "mxu"
    try:
        kI, _ = row("I (ssq_cwt planes)", "I", NF_MANY, R.reassign4,
                    R.reassign_mxu_plain, a4, planes4, [const, zeros], 2)
        # the headline plan split at 150 rows: each range has its own
        # digit split, so held to the one launch by I's bar
        a4h = (*planes4, ctx["const"], zeros, 10 * EPS32, prm0, mode0, True,
               nf0, "cwt")
        oneI = R.reassign4(*a4h)
        forcedI, countI = R._launch_ranges(
            "ssq_reassign_mxu", planes4, [ctx["const"], zeros],
            [R.TRANSFORMS["cwt"], R.MODES[mode0], 1],
            [R._gamma2(10 * EPS32)] + R._plan_floats(mode0, prm0), nf0,
            "reassign_mxu kernel", RANGE_SPLIT,
            lambda r: (R._mxu_plan(r).n_tile,))
        dI = float((torch.hypot(forcedI[0] - oneI[0], forcedI[1] - oneI[1])
                    .sum() / torch.hypot(*oneI).sum()))
        split["I"] = (countI, same(oneI, forcedI), dI)
        del oneI, forcedI
    finally:
        if old is None:
            os.environ.pop("SSQ_TPU_REASSIGN_IMPL", None)
        else:
            os.environ["SSQ_TPU_REASSIGN_IMPL"] = old
    dIB = float(torch.hypot(kI[0] - kB4[0], kI[1] - kB4[1]).sum() /
                torch.hypot(*kB4).sum())
    out["I"]["vs_B'"] = dIB
    rows[-1] += f"; against B' sum|d|/sum|B'| {dIB:.2e}"
    check(dIB < MXU_BAR, f"kernel I at nf={NF_MANY} vs B': {dIB:.2e}")
    check(out["I"]["tx_rel"] <= 1e-5, f"kernel I at nf={NF_MANY} vs plain "
          f"I: {out['I']['tx_rel']:.2e}")
    del kI, kB4
    oneB4 = R.reassign4(*a4h)
    forcedB4, count = R._launch_ranges(
        R._entry("ssq_reassign4", torch.float32), planes4,
        [ctx["const"], zeros], [R.TRANSFORMS["cwt"], R.MODES[mode0], 1],
        [R._gamma2(10 * EPS32)] + R._plan_floats(mode0, prm0), nf0,
        "reassign4 kernel", RANGE_SPLIT, lambda r: (R._block_cols(r),))
    split["B'"] = (count, same(oneB4, forcedB4))
    del planes4, a4, a4h, oneB4, forcedB4
    torch.cuda.empty_cache()

    # B and B' in double at nf = 4097 on the headline float64 planes
    f64 = torch.float64
    Wx, _, dWx = cwt(x.to(f64), wavelet, scales=scales, derivative=True,
                     dtype="float64")
    planes = [p.contiguous() for p in (Wx.real, Wx.imag, dWx.real,
                                       dWx.imag)]
    del Wx, dWx
    _, const_arr, _, _ = plan_ssqueeze(n, na, None, scales, fs=1.0,
                                       maprange="peak", wavelet=wavelet)
    const64 = torch.as_tensor(const_arr, dtype=f64, device=dev)
    zeros64 = torch.zeros(na, dtype=f64, device=dev)
    g64 = 10 * EPS64
    w = R.phase_w(*planes, zeros64, g64, "cwt")
    m64, prm64 = bin_params(np.geomspace(float(freqs.min()),
                                         float(freqs.max()), NF_RANGED), True)
    ordered = row_ordered(torch, R, planes[0], planes[1], w, const64, prm64,
                          m64, True, NF_RANGED)
    a3 = (planes[0], planes[1], w, const64, prm64, m64, True, NF_RANGED)
    k1, p1 = row("B f64", "B f64", NF_RANGED, R.reassign, R.reassign_plain,
                 a3, (planes[0], planes[1], w), [const64], 2, ordered, True)
    del k1, p1
    a4 = (*planes, const64, zeros64, g64, prm64, m64, True, NF_RANGED, "cwt")
    k1, p1 = row("B' f64", "B' f64", NF_RANGED, R.reassign4,
                 R.reassign4_plain, a4, planes, [const64, zeros64], 2,
                 ordered, True)
    del k1, p1, ordered
    for key in ("B f64", "B' f64"):
        check(out[key]["row_ordered"], f"{key} at nf={NF_RANGED} is not the "
              "row-ordered sum")
    # the headline plan (nf = 293) in double, split at 150 rows
    m0, p0 = mode0, prm0
    for key, entry, pl, vecs, ints, plan, n_in in (
            ("B f64", "ssq_reassign", [planes[0], planes[1], w], [const64],
             [R.MODES[m0], 1], R._plan_floats(m0, p0, f64), 3),
            ("B' f64", "ssq_reassign4", planes, [const64, zeros64],
             [R.TRANSFORMS["cwt"], R.MODES[m0], 1],
             [R._gamma2(g64, f64)] + R._plan_floats(m0, p0, f64), 4)):
        one = (R.reassign(planes[0], planes[1], w, const64, p0, m0, True,
                          nf0) if n_in == 3 else
               R.reassign4(*planes, const64, zeros64, g64, p0, m0, True, nf0,
                           "cwt"))
        forced, count = R._launch_ranges(
            R._entry(entry, f64), pl, vecs, ints, plan, nf0, key,
            RANGE_SPLIT, lambda r, n_in=n_in: R._f64_shape(f64, r, n_in))
        split[key] = (count, same(one, forced))
        del one, forced
    del planes, w, a3, a4
    torch.cuda.empty_cache()

    out["split_293"] = {k: list(v) for k, v in split.items()}
    out["paths"] = path
    results["ranges"] = out
    bp = out["B'"]
    print(f"[25a] bins past one launch at N = {n} ({card}): " +
          "; ".join(rows) + f". End to end: ssq_stft(n_fft={NF_STFT_BIG}) "
          f"{bp['e2e_ms']:.2f} ms, launches {path['ssq_stft']}, Tx == "
          f"B' on its planes {bp['e2e_equal']}; ssq_cwt({NF_MANY} "
          f"ssq_freqs) {out['B']['e2e_ms']:.2f} ms, launches "
          f"{path['ssq_cwt']}, Tx == B on A's planes "
          f"{out['B']['e2e_equal']}. nf = {nf0} forced into ranges of "
          f"{RANGE_SPLIT}: " + ", ".join(
              f"{k} {v[0]} launches, == one launch {v[1]}"
              + (f" (sum|d|/sum|one| {v[2]:.2e})" if len(v) > 2 else "")
              for k, v in split.items()))
    for key, v in split.items():
        check(v[0] == 2, f"{key}: the forced split took {v[0]} launches")
        if key != "I":
            check(v[1], f"{key}: the forced split differs from one launch")
        else:
            check(v[2] < MXU_BAR, f"I: the forced split is {v[2]:.2e} off "
                  "one launch")
    total = {}
    for counts in path.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def chunked_phases(np, torch, dev, card, results, ctx):
    """Phase 25 (b): the sharded transforms of `parallel` on the card, on
    a mesh whose 'time' axis lists it four times and on a (1, 1) mesh, at
    N = 160 000 with the headline settings: chunked_stft and
    chunked_istft (n_fft = 598) equal to stft / istft; chunked_cwt within
    1e-5 of max|Wx| of cwt (the rows of the hybrid's overlap-save run
    have their kernels' tail mass beyond the halo within 1e-6) on the
    rows the unsharded cwt computes without wrap-around (their tail mass
    beyond its own pad within 1e-6) and on the global rows;
    chunked_ssq_cwt and chunked_ssq_stft against ssq_cwt / ssq_stft
    (ssq_stft: Sx equal, Tx within 1e-5 of max|Tx|; ssq_cwt: mean
    column-marginal error < 5e-2 of the mean marginal, the JAX package's
    bar, and Wx as chunked_cwt's); chunked_icwt and
    chunked_issq_cwt within 1e-6 of their unsharded results. Every
    transform's kernels launched once a shard program; the wall and
    device ms of each, beside the unsharded transform's. Returns the
    launches of the four-entry mesh's calls."""
    from ssqueeze_rs_tpu_torch import (cwt, icwt, issq_cwt, istft, ssq_cwt,
                                       ssq_stft, stft)
    from ssqueeze_rs_tpu_torch.parallel import (
        chunked_cwt, chunked_icwt, chunked_istft, chunked_issq_cwt,
        chunked_ssq_cwt, chunked_ssq_stft, chunked_stft, make_mesh)
    from ssqueeze_rs_tpu_torch.parallel import chunked as C

    wavelet, scales = ctx["wavelet"], ctx["scales"]
    x = ctx["requests"]["noise"][0]
    n = x.shape[-1]
    meshes = {"4": make_mesh((1, 4), devices=[dev] * 4),
              "1": make_mesh((1, 1), devices=[dev])}
    out, lines, path = {}, [], {}
    kw_cwt = dict(wavelet=wavelet, scales=scales)
    Sx = stft(x, n_fft=N_FFT)
    W_ref, _ = cwt(x, wavelet, scales=scales)
    T_ref = ssq_cwt(x, wavelet, scales=scales, fs=1.0)[0]
    calls = {
        "stft": (lambda m: chunked_stft(x, m, n_fft=N_FFT),
                 lambda: stft(x, n_fft=N_FFT)),
        "istft": (lambda m: chunked_istft(Sx, m, n_fft=N_FFT),
                  lambda: istft(Sx, n_fft=N_FFT)),
        "cwt": (lambda m: chunked_cwt(x, m, **kw_cwt)[0],
                lambda: cwt(x, wavelet, scales=scales)[0]),
        "ssq_cwt": (lambda m: chunked_ssq_cwt(x, m, fs=1.0, **kw_cwt)[:2],
                    lambda: ssq_cwt(x, wavelet, scales=scales, fs=1.0)[:2]),
        "ssq_stft": (lambda m: chunked_ssq_stft(x, m, n_fft=N_FFT)[:2],
                     lambda: ssq_stft(x, n_fft=N_FFT)[:2]),
        "icwt": (lambda m: chunked_icwt(W_ref, m, **kw_cwt),
                 lambda: icwt(W_ref, wavelet, scales=scales)),
        "issq_cwt": (lambda m: chunked_issq_cwt(T_ref, m, wavelet=wavelet),
                     lambda: issq_cwt(T_ref, wavelet)),
    }
    # the rows the unsharded cwt computes without wrapping around: their
    # kernels' tail mass beyond its own pad (n1 of p2up(N)) within 1e-6.
    # The other rows' edge columns carry the unsharded transform's
    # circular wrap, which a shard's longer reflected halo does not have
    # (a one-shard mesh takes rows as far as 1e-6 of their mass beyond
    # N - 1 samples through the halo), so they are reported, not held
    wav, sc_arr, *_ = C._plan_cwt((n,), wavelet, scales, 32, None)
    M_ref, n1_ref, _ = C.pad_params(n)
    unwrapped = C.overlap_save_tail_mass(wav, sc_arr, n1_ref, M_ref) <= 1e-6
    # the kernels a shard program launches (the hybrid CWT: D for the
    # rows of the halo's overlap-save run and D for its block of the
    # global rows, where either exists)
    # first match wins: G's and H's kernel names contain F's
    groups = (K_A, K_D, K_B, ("G", ("ssq_stft_bluestein",)),
              ("H", ("istft_bluestein", "ola_partials")),
              ("F", ("stft_bluestein",)), K_FFT)

    def profiled(fn):
        """device_breakdown, tried up to three times: in a run of many
        short profiles some sessions saw no device time at all, and some
        fewer launches than ran (the queued time beside it says)."""
        for _ in range(3):
            prof = device_breakdown(torch, fn, groups, calls=2)
            if prof is not None:
                return prof
        return None

    def dev_ms(prof):
        return f"{prof['device_ms']:.2f}" if prof else "not measured"

    def queued_ms(fn, reps=3, spin=200_000_000):
        """The card's ms a call (median of `reps`), the calls queued behind
        one spin of ~0.1 s that outlasts the host's enqueueing of them, so
        each pair of events holds the card's time alone. A host sync
        inside a call (istft's upload of its window norm from pageable
        memory) makes it wait for the card, and adds the host's time
        after it."""
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        events = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        times = sorted(a.elapsed_time(b) for a, b in events)
        return times[len(times) // 2]
    for mname, mesh in meshes.items():
        shards = mesh.shape["time"]
        S = n // shards
        halo = C._clip_halo(C.default_cwt_halo(wav, float(sc_arr.max())), S)
        g0, g1 = C._exact_rows(wav, sc_arr, halo,
                               C.pad_params(S + 2 * halo)[0], 1e-6)
        d_per = int(g1 > g0) + int(g1 - g0 < len(scales))
        want = {"stft": {"stft_dft": shards},
                "istft": {"istft_ola": shards},
                "cwt": {"cwt_fused": d_per * shards},
                "ssq_cwt": {"cwt_fused": d_per * shards,
                            "reassign4": shards},
                "ssq_stft": {"stft_dft": shards, "reassign4": shards},
                "icwt": {}, "issq_cwt": {}}
        res = {"rows_local": [int(g0), int(g1)], "halo": halo}
        for name, (sharded, whole) in calls.items():
            before = launch_counts()
            got = sharded(mesh)
            torch.cuda.synchronize()
            counts = moved(before)
            ref = whole()
            wall = host_ms(torch, lambda: sharded(mesh), n=3)[0]
            prof = profiled(lambda: sharded(mesh))
            wall_ref = host_ms(torch, whole, n=3)[0]
            prof_ref = profiled(whole)
            queued = queued_ms(lambda: sharded(mesh))
            queued_ref = queued_ms(whole)
            rec = dict(launches=counts, wall_ms=wall, profile=prof,
                       queued_ms=queued, unsharded_wall_ms=wall_ref,
                       unsharded_profile=prof_ref,
                       unsharded_queued_ms=queued_ref)
            if name in ("stft", "istft"):
                rec["equal"] = bool(torch.equal(got, ref))
                check(rec["equal"], f"chunked_{name} on mesh {mname} is not "
                      f"bitwise {name}")
            elif name in ("cwt", "ssq_cwt"):
                Wg, Wr = (got, ref) if name == "cwt" else (got[1], ref[1])
                rows = ((Wg - Wr).abs().amax(-1) /
                        Wr.abs().max()).cpu().numpy()
                local = np.zeros(len(rows), bool)
                local[g0:g1] = True
                held = unwrapped | ~local
                rec["rel_held_rows"] = float(rows[held].max())
                rec["rel_wrapped_rows"] = (float(rows[~held].max())
                                           if (~held).any() else 0.0)
                rec["wrapped_rows"] = int((~held).sum())
                check(rec["rel_held_rows"] < 1e-5, f"chunked_{name} on mesh "
                      f"{mname}: Wx row error {rec['rel_held_rows']:.2e} of "
                      "max|Wx|")
                if name == "ssq_cwt":
                    Tg, Tr = got[0], ref[0]
                    cg, cr = Tg.abs().sum(-2), Tr.abs().sum(-2)
                    rec["col_rel"] = float((cg - cr).abs().mean() / cr.mean())
                    check(rec["col_rel"] < 5e-2, f"chunked_ssq_cwt on mesh "
                          f"{mname}: column marginals {rec['col_rel']:.2e}")
            elif name == "ssq_stft":
                Tg, Sg = got
                Tr, Sr = ref
                rec["sx_equal"] = bool(torch.equal(Sg, Sr))
                rec["tx_rel"] = rel(torch, Tg, Tr)
                rec["tx_equal"] = bool(torch.equal(Tg, Tr))
                check(rec["sx_equal"] and rec["tx_rel"] <= 1e-5,
                      f"chunked_ssq_stft on mesh {mname}: Sx equal "
                      f"{rec['sx_equal']}, Tx {rec['tx_rel']:.2e}")
            else:
                rec["rel"] = rel(torch, got, ref)
                rec["equal"] = bool(torch.equal(got, ref))
                check(rec["rel"] <= 1e-6, f"chunked_{name} on mesh {mname}: "
                      f"{rec['rel']:.2e}")
            check(counts == want[name], f"chunked_{name} on mesh {mname}: "
                  f"launches {counts}, want {want[name]}")
            if mname == "4":
                for k, v in counts.items():
                    path[k] = path.get(k, 0) + v
            res[name] = rec
            del got, ref
        out[mname] = res
        lines.append(
            f"mesh {mname} (time x {shards}; cwt halo {halo}, rows "
            f"{g0}..{g1} by overlap-save): " + "; ".join(
                f"{k} " + ", ".join(
                    f"{q} {v:.2e}" if isinstance(v, float) else f"{q} {v}"
                    for q, v in r.items()
                    if q in ("equal", "sx_equal", "tx_equal", "tx_rel",
                             "col_rel", "rel", "rel_held_rows",
                             "rel_wrapped_rows", "wrapped_rows"))
                + f", launches {r['launches']}, wall {r['wall_ms']:.2f} ms "
                f"(unsharded {r['unsharded_wall_ms']:.2f}), device ms "
                f"{dev_ms(r['profile'])} (unsharded "
                f"{dev_ms(r['unsharded_profile'])}), queued ms "
                f"{r['queued_ms']:.2f} (unsharded "
                f"{r['unsharded_queued_ms']:.2f})"
                for k, r in res.items() if isinstance(r, dict)))
    results["chunked"] = out
    print(f"[25b] chunked transforms at N = {n} ({card}): " +
          " | ".join(lines))
    return path


# phase 26: the native host runtime under process_recording
def _fused_candidates(np, a, b, c, d):
    """The float32 results a*b - c*d may take: numpy's (both products
    rounded), and each with one product fused into the subtraction (as
    g++ -march=native contracts it to an FMA), the fused one exact in long
    double before the one rounding to float32."""
    ld = np.longdouble
    ab, cd = a * b, c * d
    return (ab - cd,
            (a.astype(ld) * b - cd.astype(ld)).astype(np.float32),
            (ab.astype(ld) - c.astype(ld) * d).astype(np.float32))


def native_pipeline_phases(np, torch, dev, card, results, ctx):
    """Phase 26: the native library built from native/ssq_native.cpp; its
    memory-mapped reader and prefetch ring on phase 20's recording written
    as a raw file; process_recording from that file (prefetch on and off)
    bitwise phase 20's array-source results, with A's and B's launches;
    the host kernels (TKEO, the float64 reassignment). Returns phase 26's
    launches by kernel name."""
    import tempfile
    from ssqueeze_rs_tpu_torch import cwt, native
    from ssqueeze_rs_tpu_torch.ops.ssqueeze import bin_params, reassign
    from ssqueeze_rs_tpu_torch.parallel import process_recording
    from ssqueeze_rs_tpu_torch.utils.pad import _reflect_indices

    K_D2H = ("D2H", ("Memcpy DtoH",))
    K_H2D = ("H2D", ("Memcpy HtoD",))
    P = ctx["pipeline20"]
    rec, fs = P["rec"], P["fs"]
    C, NR = rec.shape
    S26 = {}

    def counts():
        return counted_launches("cwt_phase", "reassign")

    # (a) the library
    t0 = time.perf_counter()
    native.build_library()
    S26["build_s"] = time.perf_counter() - t0
    check(native.available(), "native library did not load")
    print(f"[26a] native library: {S26['build_s']:.1f} s "
          f"({'compiled' if native.BUILD_LOG else 'cached'}) -> "
          f"{os.path.relpath(native.library_path(), HERE)}")

    launches = dict(cwt_phase=0, reassign=0)
    with tempfile.TemporaryDirectory() as tmp:
        # (b) the reader on the recording as a channel-major raw file
        path = os.path.join(tmp, "rec.f32")
        rec.tofile(path)
        C8, _, N8 = P["out8"].shape
        path8 = os.path.join(tmp, "rec8.f32")
        np.ascontiguousarray(rec[:C8, :N8]).tofile(path8)
        H = CL = P["chunk"]
        with native.MappedRecording(path, n_channels=C) as mr:
            check(mr.n_samples == NR, f"reader: {mr.n_samples} samples")
            last = (NR - 1) // CL * CL
            for start in (0, last):
                cl = min(CL, NR - start)
                got = mr.read_chunk(start, cl, H, H)
                want = rec[:, _reflect_indices(start - H, start + cl + H,
                                               NR)]
                check(np.array_equal(got, want),
                      f"read_chunk at {start}: not the reflect gather")
            direct = list(mr.iter_chunks(CL, H))
            ring = list(mr.iter_chunks_prefetch(CL, H, depth=3))
            check([s for s, _ in direct] == [s for s, _ in ring] ==
                  list(range(0, NR, CL)), "prefetch: chunk starts")
            check(all(np.array_equal(a, b) for (_, a), (_, b) in
                      zip(direct, ring)), "prefetch: chunks not bitwise "
                  "iter_chunks")
            del direct, ring, got, want
        lap("26b native reader")

        # (c) the slice: process_recording from the file, A and B a chunk
        runs = [("energy", path, rec, C, NR,
                 dict(chunk_len=CL, out="energy"), P["en"],
                 P["en_launches"]),
                ("numpy", path8, np.ascontiguousarray(rec[:C8, :N8]), C8,
                 N8, dict(chunk_len=P["chunk8"]), P["out8"],
                 P["out8_launches"])]
        for name, src, arr, nc, ns, kw, want, want_moved in runs:
            if name == "energy":
                check(want_moved == {"cwt_phase": 3 * C, "reassign": 3 * C},
                      f"phase 20 energy: launches {want_moved}")
            # the yardstick: the array source again, warm (phase 20's run
            # was the first at its shapes: host planning, cuFFT plans)
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, _ = process_recording(arr, transform="ssq_cwt", fs=fs, **kw)
            wall = time.perf_counter() - t0
            moved = {k: v - before[k] for k, v in counts().items()}
            for k in launches:
                launches[k] += moved[k]
            check(np.array_equal(got, want) and moved == want_moved,
                  f"pipeline {name} from the array again: bitwise "
                  f"{np.array_equal(got, want)}, launches {moved}")
            S26[f"{name} {nc} x {ns} array source, warm"] = dict(
                s=wall, msamples_s=nc * ns / wall / 1e6, launches=moved)
            del got
            for prefetch in (True, False):
                def call():
                    return process_recording(
                        src, n_channels=nc, transform="ssq_cwt", fs=fs,
                        prefetch=prefetch, **kw)

                before = counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                got, _ = call()
                wall = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() / 1e9
                moved = {k: v - before[k] for k, v in counts().items()}
                for k in launches:
                    launches[k] += moved[k]
                check(got.shape == want.shape and np.array_equal(got, want),
                      f"pipeline {name} from a raw file (prefetch "
                      f"{prefetch}): not bitwise the array source")
                check(moved == want_moved, f"pipeline {name} (prefetch "
                      f"{prefetch}): launches {moved}, phase 20 "
                      f"{want_moved}")
                del got
                # the device's idle share: one more call, profiled
                before = counts()
                prof = device_breakdown(
                    torch, call, (K_A, K_B, K_FFT, K_CPLX, K_D2H, K_H2D),
                    calls=1, warm=True, cpu=False)
                moved_p = {k: v - before[k] for k, v in counts().items()}
                check(moved_p == want_moved, f"pipeline {name} profiled: "
                      f"launches {moved_p}")
                for k in launches:
                    launches[k] += moved_p[k]
                S26[f"{name} {nc} x {ns} prefetch {prefetch}"] = dict(
                    s=wall, msamples_s=nc * ns / wall / 1e6, peak_gb=peak,
                    launches=moved, bitwise_array_source=True,
                    profile=prof)
            lap(f"26c pipeline {name} from a raw file")
    S26["array source (phase 20)"] = dict(
        energy_s=P["en_s"], energy_msamples_s=C * NR / P["en_s"] / 1e6,
        energy_peak_gb=P["en_peak_gb"], numpy_s=P["out8_s"])

    # (d) the host kernels: the TKEO against numpy's formulas, the float64
    # reassignment against the port's plain float64 reassign
    x = np.random.default_rng(26).standard_normal((4, 160_000)).astype(
        np.float32)
    tk = native.tkeo_cpu(x)
    tkm = native.tkeo_modified_cpu(x)
    tkeo = {}
    for nm, out, (a, b, c, d) in (
            ("tkeo", tk, (x[:, 1:-1], x[:, 1:-1], x[:, :-2], x[:, 2:])),
            ("tkeo_modified", tkm, (x[:, 2:-1], x[:, 1:-2], x[:, 3:],
                                    x[:, :-3]))):
        plain, fa, fb = _fused_candidates(np, a, b, c, d)
        check(out.shape == plain.shape, f"{nm}: shape {out.shape}")
        same = out == plain
        check(bool((same | (out == fa) | (out == fb)).all()),
              f"{nm}: an output is neither numpy's formula nor it with one "
              "product fused")
        tkeo[nm] = dict(numpy_share=float(same.mean()),
                        fused_a_share=float((out == fa).mean()),
                        fused_b_share=float((out == fb).mean()))
    S26["tkeo"] = tkeo
    n = 2048
    t = np.linspace(0, 10, n, endpoint=False)
    xs = np.cos(2 * np.pi * 3 * np.exp(t / 3))
    Wx, _, dWx = cwt(torch.as_tensor(xs, device=dev), ("gmw", {"beta": 8.0}),
                     scales="log", fs=n / 10, derivative=True,
                     dtype="float64")
    Wx, dWx = Wx.cpu(), dWx.cpu()
    check(Wx.dtype == torch.complex128, f"cwt float64: {Wx.dtype}")
    ssq_freqs = np.geomspace(0.05, 25.0, 180)
    const = np.full(Wx.shape[0], 0.0217)
    t0 = time.perf_counter()
    Tx = native.reassign_cpu(Wx, dWx, ssq_freqs, const, 1e-8, "log",
                             flipud=True)
    host_s = time.perf_counter() - t0
    mode, params = bin_params(ssq_freqs, True)
    ref = cpu_ref(torch, lambda: reassign(
        Wx, dWx, torch.as_tensor(const), 1e-8, torch.zeros(Wx.shape[0],
                                                          dtype=torch.float64),
        params, mode=mode, flipud=True, fused=True, transform="cwt",
        nf=len(ssq_freqs))).numpy()
    d_tx = float(np.abs(Tx - ref).max() / np.abs(ref).max())
    S26["reassign_cpu"] = dict(rel_vs_plain=d_tx, ms=host_s * 1e3,
                               shape=list(Tx.shape))
    check(Tx.dtype == np.complex128 and d_tx <= 1e-12,
          f"reassign_cpu against the plain float64 reassign: {d_tx:.2e}")
    lap("26d host kernels")

    results["native"] = S26
    runs = "; ".join(
        f"{k}: {v['s']:.2f} s = {v['msamples_s']:.2f} MSamples/s, " +
        (f"peak {v['peak_gb']:.2f} GB, launches {v['launches']}, profile "
         f"{breakdown_line(v['profile'])}" if "profile" in v else
         f"launches {v['launches']}")
        for k, v in S26.items() if isinstance(v, dict) and "s" in v)
    a20 = S26["array source (phase 20)"]
    print(f"[26] native pipeline ({card}): reader bitwise the reflect "
          f"gather (halo {H}), prefetch ring bitwise iter_chunks; from a "
          f"raw file, bitwise the array source: {runs}; array source "
          f"(phase 20, the first call at its shapes) energy "
          f"{a20['energy_s']:.2f} s = {a20['energy_msamples_s']:.2f} "
          f"MSamples/s, peak {a20['energy_peak_gb']:.2f} GB, numpy "
          f"{a20['numpy_s']:.2f} s; tkeo " + ", ".join(
              f"{k} numpy's formula on {v['numpy_share']:.1%} (one product "
              f"fused on the rest)" for k, v in tkeo.items()) +
          f"; reassign_cpu {S26['reassign_cpu']['ms']:.1f} ms, "
          f"{d_tx:.1e} of max|Tx| off the plain float64 reassign")
    return launches

if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
