// Shared device code of the reassignment kernels (B, B' in reassign.cu;
// C, C' in reassign_bwd.cu; G in ssq_stft.cu; I in reassign_mxu.cu): the
// phase transform of the 4-plane contract and the analytic frequency
// binning of ssqueeze_rs_tpu/ops/reassign_pallas.py (_bin_indices).
// Every product, sum and quotient is rounded on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn; __dmul_rn, ... in double), as the plain-torch
// versions round each op, so the kernels and their plain versions compute
// the same w.
//
// Templated on the real type T: float (every kernel) and double (B, B', C
// and C' on float64 planes, as the JAX package's float64 kernel B' runs).
// The helpers below resolve each operation to its float or double
// intrinsic; the float instantiation is the same code, in the same order,
// as the float-only version these kernels ran before.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ssq {

enum Mode { kLog = 0, kLogPiecewise = 1, kLin = 2 };
enum Transform { kCwt = 0, kStft = 1 };

constexpr float kTwoPi = 6.283185307179586f;

template <typename T>
struct PlanT {
  int mode, flipud, nf;
  T p0, p1, p2, p3, p4;       // log: vlmin, dvl; log-piecewise: vlmin0,
                              // vlmin1, dvl0, dvl1, idx1; lin: vmin, dv
};
using Plan = PlanT<float>;
using Plan64 = PlanT<double>;

// 2pi in T (reassign_pallas.py _TWO_PI)
template <typename T> __device__ __forceinline__ T two_pi();
template <> __device__ __forceinline__ float two_pi<float>() { return kTwoPi; }
template <> __device__ __forceinline__ double two_pi<double>() {
  return 6.283185307179586;
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float log2_t(float a) { return log2f(a); }
__device__ __forceinline__ double log2_t(double a) { return log2(a); }
__device__ __forceinline__ float rint_t(float a) { return rintf(a); }
__device__ __forceinline__ double rint_t(double a) { return rint(a); }
__device__ __forceinline__ float min_t(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_t(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float max_t(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_t(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }

// Bin of one phase value; -1 when masked (w == +inf). Round half to
// even (rint), w == 0 -> bin 0 for the log modes, flipud k -> nf-1-k.
template <typename T>
__device__ __forceinline__ int bin_of(T w, const PlanT<T>& P) {
  if (!(w < (T)INFINITY)) return -1;
  const T omax = (T)(P.nf - 1);
  const T wsafe = (w > T(0)) ? w : T(1);
  T k;
  if (P.mode == kLog) {
    k = min_t(rint_t(max_t(div_rn(log2_t(wsafe) - P.p0, P.p1), T(0))), omax);
  } else if (P.mode == kLogPiecewise) {
    const T wl = log2_t(wsafe);
    const T k_hi = min_t(rint_t(div_rn(wl - P.p1, P.p3)) + P.p4, omax);
    const T k_lo = max_t(rint_t(div_rn(wl - P.p0, P.p2)), T(0));
    k = (wl > P.p1) ? k_hi : k_lo;
  } else {
    k = min_t(rint_t(max_t(div_rn(w - P.p0, P.p1), T(0))), omax);
  }
  if (P.mode != kLin && !(w > T(0))) k = T(0);
  int ki = (int)k;
  if (P.flipud) ki = P.nf - 1 - ki;
  return ki;
}

// Phase transform of the 4-plane contract for one entry: C, D = Wx,
// A, B = dWx. w = |sfs - (B*C - A*D) / (|Wx|^2 * 2pi)| for the STFT,
// |(B*C - A*D) / (|Wx|^2 * 2pi)| for the CWT; +inf where |Wx|^2 <= gamma^2.
template <typename T>
__device__ __forceinline__ T phase_w(T C, T D, T A, T B, T sfs, T gamma2,
                                     int transform) {
  const T mag2 = add_rn(mul_rn(C, C), mul_rn(D, D));
  if (!(mag2 > gamma2)) return (T)INFINITY;
  T r = div_rn(sub_rn(mul_rn(B, C), mul_rn(A, D)), mul_rn(mag2, two_pi<T>()));
  if (transform == kStft) r = sub_rn(sfs, r);
  return abs_t(r);
}

}  // namespace ssq
