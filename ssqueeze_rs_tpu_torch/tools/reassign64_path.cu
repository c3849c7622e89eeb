// The path of one entry through kernels B and B' in double
// (csrc/reassign64.cu), for counting its FP64 instructions in the SASS
// (chip_smoke.py phase 24: nvcc -cubin, cuobjdump -sass). Never launched.
//
// entry_path<kPlanes, MODE, TRANSFORM> runs what the kernel runs for one
// entry: the bin by entry_bin (csrc/reassign64.cuh) with the bin mode and
// the transform fixed, so the compiler keeps that path only, and the two
// products and adds into the accumulator. Its main body (before the
// out-of-line exact path and the divisions' slow paths) is the screened
// path's work, which all but about one entry in a thousand take.

#include <cuda_runtime.h>

#include "../csrc/reassign64.cuh"

template <int kPlanes, int MODE, int TRANSFORM>
__global__ void entry_path(const double* __restrict__ in,
                           const double* __restrict__ cst,
                           double* __restrict__ acc, ssq::Plan64 P,
                           Screen S, double gamma2) {
  P.mode = MODE;
  const int t = threadIdx.x;
  const double C = in[t], D = in[t + 32], A = in[t + 64], B = in[t + 96];
  const int k = entry_bin<kPlanes>(C, D, A, B, in[t + 128], gamma2,
                                   TRANSFORM, P, S);
  if (k >= 0) {
    const double cc = cst[t];
    acc[2 * k] = __dadd_rn(acc[2 * k], __dmul_rn(C, cc));
    acc[2 * k + 1] = __dadd_rn(acc[2 * k + 1], __dmul_rn(D, cc));
  }
}

// (planes, bin mode, transform): the CWT's log and log-piecewise bins
// (the timed shapes), the linear bins of the STFT
template __global__ void entry_path<3, ssq::kLog, ssq::kCwt>(
    const double*, const double*, double*, ssq::Plan64, Screen, double);
template __global__ void entry_path<3, ssq::kLogPiecewise, ssq::kCwt>(
    const double*, const double*, double*, ssq::Plan64, Screen, double);
template __global__ void entry_path<4, ssq::kLog, ssq::kCwt>(
    const double*, const double*, double*, ssq::Plan64, Screen, double);
template __global__ void entry_path<4, ssq::kLogPiecewise, ssq::kCwt>(
    const double*, const double*, double*, ssq::Plan64, Screen, double);
template __global__ void entry_path<4, ssq::kLin, ssq::kStft>(
    const double*, const double*, double*, ssq::Plan64, Screen, double);
