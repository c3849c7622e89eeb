"""Kernel G's work (`csrc/ssq_stft.cu`): the padded signal (b (n + n_fft -
1) float32), the window and its derivative (2 n_fft), Sfs and the row
constants (2 nf) read once; Tx and Sx written once (4 b nf n float32);
two real FFTs of n_fft points a frame (window and derivative window) at
2.5 n_fft log2 n_fft, and 16 operations an entry for the phase, the bin
and the accumulation."""
import math


def count(s):
    b, n, nf, k = s["batch"], s["n"], s["nf"], s["n_fft"]
    floats = b * (n + k - 1) + 2 * k + 2 * nf + 4 * b * nf * n
    flops = 2.5 * (2 * b * n) * k * math.log2(k) + 16.0 * b * nf * n
    return 4 * floats, flops
