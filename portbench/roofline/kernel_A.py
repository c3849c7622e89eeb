"""Kernel A's work (`csrc/cwt_planes.cu`, ALoad / PhaseStore): per call,
the filterbank (na rows of m/2 float32 bins, one for the whole batch), the
signal spectra (b x m/2 bins, real and imaginary planes), the radian grid
(m/2) and the Nyquist vectors (4 b na) read once; Wx (two planes) and the
phase plane written once (3 b na n float32); two inverse FFTs of length m
a row (Wx and dWx) at the radix-2 count 5 m log2 m."""
import math


def count(s):
    b, na, n, m = s["batch"], s["na"], s["n"], s["m"]
    floats = na * m // 2 + 2 * b * m // 2 + m // 2 + 4 * b * na + 3 * b * na * n
    return 4 * floats, 2 * 5.0 * b * na * m * math.log2(m)
