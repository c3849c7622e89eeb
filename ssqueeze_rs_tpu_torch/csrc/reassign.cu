// Kernels B and B': analytic frequency binning + deterministic
// reassignment (synchrosqueezing scatter) for sm_90a.
//
// Replace ssqueeze_rs_tpu/ops/reassign_pallas.py::_make_kernel in its two
// input contracts (binning in _bin_indices):
//   B  (phase_in=True, 3 planes): Wx and the phase plane w, +inf = masked
//   B' (phase_in=False, 4 planes): Wx and dWx; w and the mask
//      |Wx|^2 > gamma^2 are formed here (bins.cuh phase_w), for the STFT
//      (w = |Sfs - Im(dWx/Wx)/2pi|) or the CWT (w = |Im(dWx/Wx)/2pi|)
// For each column j and each row i in fixed order 0..na-1:
//
//   k = bin(w[i,j])   log / log-piecewise / lin closed form (bins.cuh)
//   Tx[k, j] += (Wxr[i,j] * const[i], Wxi[i,j] * const[i])
//
// One thread owns one column and walks its rows in order, accumulating
// into that column of a shared-memory (2, nf, COLS) block of planes. No
// two threads touch the same accumulator, so there are no atomics and no
// barriers, and every output is a sum taken in row order: the result is
// bitwise the same from run to run. The block then stores its columns.
// COLS (32, 16 or 8) is the largest whose accumulator fits in 227 KB, so
// any nf up to 3632 launches (the TPU kernel's (nf, 512) accumulator
// lives in VMEM and has no such bound).
//
// What bounds it on Hopper: latency of the row walk at low occupancy. The
// accumulator (2 * nf * 32 * 4 B = 75 KB at nf = 293) admits 3 blocks of
// one warp per SM, so few loads are in flight; the bytes moved (three or
// four input planes read once, two output planes written once) would take
// well under a millisecond at full bandwidth. What the design does about
// it: the row loop is unrolled so each thread issues the loads of kUnroll
// rows before it uses them, and the products are rounded as in the
// reference (value = Wx * const, then added) so the sum order is the only
// freedom and it is fixed. The banded variant of the reference
// (_band_mode) is later work.
//
// The kernel lives in reassign.cuh, which csrc/ablate_reassign.cu
// instantiates with its ablation variants and grid modes.

#include <cuda_runtime.h>
#include <math.h>

#include "reassign.cuh"

namespace {

template <int kPlanes>
int dispatch(int cols, const float* wr, const float* wi, const float* p2,
             const float* p3, const float* cst, const float* sfs, int batch,
             int na, long long n, const Plan& P, int transform, float gamma2,
             float* txr, float* txi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (cols) {
    case 32: return launch<32, kPlanes>(wr, wi, p2, p3, cst, sfs, batch, na,
                                        n, P, transform, gamma2, txr, txi, s);
    case 16: return launch<16, kPlanes>(wr, wi, p2, p3, cst, sfs, batch, na,
                                        n, P, transform, gamma2, txr, txi, s);
    case 8: return launch<8, kPlanes>(wr, wi, p2, p3, cst, sfs, batch, na,
                                      n, P, transform, gamma2, txr, txi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Planes are (batch, na, n) and (batch, nf, n), row-major float32; cols is
// the columns per block (32, 16 or 8) the wrapper chose from nf.
// Return cudaGetLastError() after the launch (0 on success).
extern "C" int ssq_reassign(const float* wr, const float* wi, const float* w,
                            const float* cst, int batch, int na, long long n,
                            int nf, int mode, int flipud, float p0, float p1,
                            float p2, float p3, float p4, int cols,
                            float* txr, float* txi, void* stream) {
  const Plan P{mode, flipud, nf, p0, p1, p2, p3, p4};
  return dispatch<3>(cols, wr, wi, w, nullptr, cst, nullptr, batch, na, n, P,
                     ssq::kCwt, 0.f, txr, txi, stream);
}

extern "C" int ssq_reassign4(const float* wr, const float* wi,
                             const float* dr, const float* di,
                             const float* cst, const float* sfs, int batch,
                             int na, long long n, int nf, int transform,
                             int mode, int flipud, float gamma2, float p0,
                             float p1, float p2, float p3, float p4, int cols,
                             float* txr, float* txi, void* stream) {
  const Plan P{mode, flipud, nf, p0, p1, p2, p3, p4};
  return dispatch<4>(cols, wr, wi, dr, di, cst, sfs, batch, na, n, P,
                     transform, gamma2, txr, txi, stream);
}

extern "C" const char* ssq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
