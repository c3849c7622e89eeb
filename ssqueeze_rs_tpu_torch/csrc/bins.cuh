// Shared device code of the reassignment kernels (B, B' in reassign.cu;
// G in ssq_stft.cu): the phase transform of the 4-plane contract and the
// analytic frequency binning of ssqueeze_rs_tpu/ops/reassign_pallas.py
// (_bin_indices). Every product, sum and quotient is rounded on its own
// (__fmul_rn, __fadd_rn, __fdiv_rn), as the plain-torch versions round
// each op, so the kernels and their plain versions compute the same w.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ssq {

enum Mode { kLog = 0, kLogPiecewise = 1, kLin = 2 };
enum Transform { kCwt = 0, kStft = 1 };

constexpr float kTwoPi = 6.283185307179586f;

struct Plan {
  int mode, flipud, nf;
  float p0, p1, p2, p3, p4;   // log: vlmin, dvl; log-piecewise: vlmin0,
                              // vlmin1, dvl0, dvl1, idx1; lin: vmin, dv
};

// Bin of one phase value; -1 when masked (w == +inf). Round half to
// even (rintf), w == 0 -> bin 0 for the log modes, flipud k -> nf-1-k.
__device__ __forceinline__ int bin_of(float w, const Plan& P) {
  if (!(w < INFINITY)) return -1;
  const float omax = (float)(P.nf - 1);
  const float wsafe = (w > 0.f) ? w : 1.f;
  float k;
  if (P.mode == kLog) {
    k = fminf(rintf(fmaxf(__fdiv_rn(log2f(wsafe) - P.p0, P.p1), 0.f)), omax);
  } else if (P.mode == kLogPiecewise) {
    const float wl = log2f(wsafe);
    const float k_hi = fminf(rintf(__fdiv_rn(wl - P.p1, P.p3)) + P.p4, omax);
    const float k_lo = fmaxf(rintf(__fdiv_rn(wl - P.p0, P.p2)), 0.f);
    k = (wl > P.p1) ? k_hi : k_lo;
  } else {
    k = fminf(rintf(fmaxf(__fdiv_rn(w - P.p0, P.p1), 0.f)), omax);
  }
  if (P.mode != kLin && !(w > 0.f)) k = 0.f;
  int ki = (int)k;
  if (P.flipud) ki = P.nf - 1 - ki;
  return ki;
}

// Phase transform of the 4-plane contract for one entry: C, D = Wx,
// A, B = dWx. w = |sfs - (B*C - A*D) / (|Wx|^2 * 2pi)| for the STFT,
// |(B*C - A*D) / (|Wx|^2 * 2pi)| for the CWT; +inf where |Wx|^2 <= gamma^2.
__device__ __forceinline__ float phase_w(float C, float D, float A, float B,
                                         float sfs, float gamma2,
                                         int transform) {
  const float mag2 = __fadd_rn(__fmul_rn(C, C), __fmul_rn(D, D));
  if (!(mag2 > gamma2)) return INFINITY;
  float r = __fdiv_rn(__fsub_rn(__fmul_rn(B, C), __fmul_rn(A, D)),
                      __fmul_rn(mag2, kTwoPi));
  if (transform == kStft) r = __fsub_rn(sfs, r);
  return fabsf(r);
}

}  // namespace ssq
