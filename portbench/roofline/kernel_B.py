"""Kernel B's work (`csrc/reassign.cu`, 3 planes): the Wx planes and the
phase plane read once (3 b na n float32) with the row constants (na), the
Tx planes written once (2 b nf n float32); 8 operations an entry (the bin
from w: a log2, a product and a rounding; the product and two adds of the
accumulation)."""


def count(s):
    b, na, nf, n = s["batch"], s["na"], s["nf"], s["n"]
    return 4 * (3 * b * na * n + na + 2 * b * nf * n), 8.0 * b * na * n
