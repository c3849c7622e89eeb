// The bins of kernels B and B' in double (reassign64.cu): bin64, the
// exact double bin (ssq::bin_of<double> with the log-piecewise branch it
// keeps only); bin_screen, which decides the bin from float32 w where its
// error bound allows; entry_bin, an entry's bin from its planes through
// both. ssqueeze_rs_tpu_torch/tools/reassign64_path.cu instantiates
// entry_bin alone, to count the FP64 instructions an entry runs.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "bins.cuh"

namespace {

using ssq::Plan64;

// ssq::bin_of<double> with one division where it takes two: of the
// log-piecewise form's two branches only the one it keeps is computed,
// with the same operations on the same operands, so every bin is
// bin_of's.
__device__ __forceinline__ int bin64(double w, const Plan64& P) {
  if (!(w < (double)INFINITY)) return -1;
  const double omax = (double)(P.nf - 1);
  const double wsafe = (w > 0.0) ? w : 1.0;
  double k;
  if (P.mode == ssq::kLog) {
    k = fmin(rint(fmax(__ddiv_rn(log2(wsafe) - P.p0, P.p1), 0.0)), omax);
  } else if (P.mode == ssq::kLogPiecewise) {
    const double wl = log2(wsafe);
    if (wl > P.p1)
      k = fmin(rint(__ddiv_rn(wl - P.p1, P.p3)) + P.p4, omax);
    else
      k = fmax(rint(__ddiv_rn(wl - P.p0, P.p2)), 0.0);
  } else {
    k = fmin(rint(fmax(__ddiv_rn(w - P.p0, P.p1), 0.0)), omax);
  }
  if (P.mode != ssq::kLin && !(w > 0.0)) k = 0.0;
  int ki = (int)k;
  if (P.flipud) ki = P.nf - 1 - ki;
  return ki;
}

// The bin screen: the bin of w from a float32 value wf with |wf - w| <=
// rel wf, decided only where that cannot move it; kUndecided sends the
// entry to bin64, the exact double path. log2f is within 1 ulp (the CUDA
// math library's bound), so lf = log2f(wf) is within
//   el = 2^-23 |lf| + 1.445 rel + 2^-40 (|lf| + 1)
// of log2 w (lf's ulp, rel <= 2^-10 through log2, the double log2's own
// rounding). The quotient bin64 rounds, q = (log2 w - a) / b, is then
// formed in double from lf, qs = ((double)lf - a) * (1 / b), within
// el / |b| + 2^-40 |q| of it, and bounded by eq, twice that plus 1e-9
// for the double roundings of the test. Where [qs - eq, qs + eq] lies
// inside one rint cell (m - 1/2, m + 1/2), rint(q) = m, and the clamps of
// bin64 are monotone and keep it. The log-piecewise side (log2 w > p1)
// is decided the same way, by more than 2 el from p1. At the timed
// shapes one entry in a thousand or fewer falls in a window and takes
// the exact path.
constexpr int kUndecided = -2;

struct Screen {
  double r1, r2, r3;   // 1 / p1, 1 / p2, 1 / p3
};

// the m with [qs - eq, qs + eq] inside (m - 1/2, m + 1/2); INT_MIN if
// there is none
__device__ __forceinline__ int screen_cell(double qs, double eq) {
  if (!(eq < 0.25 && fabs(qs) < 1e9)) return INT_MIN;
  const double lo = floor(qs - eq + 0.5), hi = floor(qs + eq + 0.5);
  return lo == hi ? (int)lo : INT_MIN;
}

// k as bin64 gives it, before flipud, for w with |wf - w| <= rel wf (w
// finite, > 0), or kUndecided
__device__ __forceinline__ int bin_screen(float wf, float rel,
                                          const Plan64& P, const Screen& S) {
  if (!(wf > 1e-30f && wf < 1e30f && rel <= 9.765625e-4f)) return kUndecided;
  const int top = P.nf - 1;
  int m;
  if (P.mode == ssq::kLin) {
    const double qs = ((double)wf - P.p0) * S.r1;
    m = screen_cell(qs, 2.0 * (double)(rel * wf) * fabs(S.r1) +
                            1e-9 + 1e-12 * fabs(qs));
    if (m == INT_MIN) return kUndecided;
    return m <= 0 ? 0 : min(m, top);
  }
  const float lf = log2f(wf);
  const double el = (double)(1.1920929e-7f * fabsf(lf) + 1.445f * rel) +
                    1e-12 * ((double)fabsf(lf) + 1.0);
  const double ld = (double)lf;
  if (P.mode == ssq::kLog) {
    const double qs = (ld - P.p0) * S.r1;
    m = screen_cell(qs, 2.0 * el * fabs(S.r1) + 1e-9 + 1e-12 * fabs(qs));
    if (m == INT_MIN) return kUndecided;
    return m <= 0 ? 0 : min(m, top);
  }
  // log-piecewise: the side of p1, then that side's cell
  const double side = ld - P.p1;
  if (!(fabs(side) > 2.0 * el + 1e-12)) return kUndecided;
  if (side > 0.0) {
    const double qs = side * S.r3;
    m = screen_cell(qs, 2.0 * el * fabs(S.r3) + 1e-9 + 1e-12 * fabs(qs));
    if (m == INT_MIN) return kUndecided;
    return (int)fmin((double)m + P.p4, (double)top);
  }
  const double qs = (ld - P.p0) * S.r2;
  m = screen_cell(qs, 2.0 * el * fabs(S.r2) + 1e-9 + 1e-12 * fabs(qs));
  if (m == INT_MIN) return kUndecided;
  return max(m, 0);
}

// The exact path, out of line (the screen leaves it few entries): bin64
// of the w given (B) or formed by ssq::phase_w (B').
__device__ __noinline__ int exact_bin3(double w, Plan64 P) {
  return bin64(w, P);
}

__device__ __noinline__ int exact_bin4(double C, double D, double A, double B,
                                       double sf, double gamma2,
                                       int transform, Plan64 P) {
  return bin64(ssq::phase_w(C, D, A, B, sf, gamma2, transform), P);
}

// The bin of one entry (-1 masked), as bin64 of ssq::phase_w's w gives
// it: the screen where it decides, else the exact double path. kPlanes
// = 3: A = w; kPlanes = 4: (C, D) = Wx, (A, B) = dWx, and w and the mask
// are formed from them.
template <int kPlanes>
__device__ __forceinline__ int entry_bin(double C, double D, double A,
                                         double B, double sf, double gamma2,
                                         int transform, const Plan64& P,
                                         const Screen& S) {
  int k = kUndecided;
  if (kPlanes == 3) {
    if (!(A < (double)INFINITY)) return -1;
    k = bin_screen((float)A, 1.1920929e-7f, P, S);       // 2^-23
    if (k == kUndecided) return exact_bin3(A, P);
  } else {
    // phase_w's operands, in its double operations
    const double mag2 = __dadd_rn(__dmul_rn(C, C), __dmul_rn(D, D));
    if (!(mag2 > gamma2)) return -1;
    const double num = __dsub_rn(__dmul_rn(B, C), __dmul_rn(A, D));
    const double den = __dmul_rn(mag2, ssq::two_pi<double>());
    if (fabs(num) > 1e-30 && fabs(num) < 1e30 && den > 1e-30 && den < 1e30) {
      // num / den in float: two conversions and __fdividef's 2 ulp,
      // within 2^-21 of it
      const float rf = __fdividef((float)num, (float)den);
      if (transform == ssq::kStft) {
        const float sff = (float)sf;
        const float wf = fabsf(__fsub_rn(sff, rf));
        k = bin_screen(wf, 1.01f * __fdividef(4.76837158e-7f * (fabsf(rf) +
                                                  fabsf(sff) + wf), wf),
                       P, S);
      } else {
        k = bin_screen(fabsf(rf), 4.76837158e-7f, P, S);
      }
    }
    if (k == kUndecided)
      return exact_bin4(C, D, A, B, sf, gamma2, transform, P);
  }
  return P.flipud ? P.nf - 1 - k : k;
}

}  // namespace
