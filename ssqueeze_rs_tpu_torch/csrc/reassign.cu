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

#include <cuda_runtime.h>
#include <math.h>

#include "bins.cuh"

namespace {

using ssq::Plan;

constexpr int kUnroll = 8;    // rows whose loads are issued together

// kPlanes = 3: p2 is the w plane; kPlanes = 4: p2, p3 are dWx.
template <int COLS, int kPlanes>
__global__ void __launch_bounds__(COLS)
reassign_kernel(const float* __restrict__ wr, const float* __restrict__ wi,
                const float* __restrict__ p2, const float* __restrict__ p3,
                const float* __restrict__ cst, const float* __restrict__ sfs,
                int na, long long n, Plan P, int transform, float gamma2,
                float* __restrict__ txr, float* __restrict__ txi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);     // [2][nf][COLS]
  const int nf = P.nf;
  const int tid = threadIdx.x;
  const long long j = (long long)blockIdx.x * COLS + tid;
  const long long bat = blockIdx.y;

  float* ar = acc + tid;
  float* ai = acc + (long long)nf * COLS + tid;
  for (int k = 0; k < nf; ++k) {
    ar[k * COLS] = 0.f;
    ai[k * COLS] = 0.f;
  }
  if (j >= n) return;

  const long long base = bat * na * n + j;
  for (int i0 = 0; i0 < na; i0 += kUnroll) {
    float vr[kUnroll], vi[kUnroll], va[kUnroll], vb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u < na) {
        const long long o = base + (long long)(i0 + u) * n;
        vr[u] = wr[o];
        vi[u] = wi[o];
        va[u] = p2[o];
        if (kPlanes == 4) vb[u] = p3[o];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u < na) {
        const int i = i0 + u;
        const float w = (kPlanes == 4)
            ? ssq::phase_w(vr[u], vi[u], va[u], vb[u], sfs[i], gamma2,
                           transform)
            : va[u];
        const int k = ssq::bin_of(w, P);
        if (k >= 0) {
          const float c = cst[i];
          ar[k * COLS] += __fmul_rn(vr[u], c);
          ai[k * COLS] += __fmul_rn(vi[u], c);
        }
      }
    }
  }

  const long long ob = bat * nf * n + j;
  for (int k = 0; k < nf; ++k) {
    txr[ob + (long long)k * n] = ar[k * COLS];
    txi[ob + (long long)k * n] = ai[k * COLS];
  }
}

template <int COLS, int kPlanes>
int launch(const float* wr, const float* wi, const float* p2, const float* p3,
           const float* cst, const float* sfs, int batch, int na, long long n,
           const Plan& P, int transform, float gamma2, float* txr, float* txi,
           cudaStream_t stream) {
  const size_t smem = (size_t)2 * P.nf * COLS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      reassign_kernel<COLS, kPlanes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + COLS - 1) / COLS), (unsigned)batch);
  reassign_kernel<COLS, kPlanes><<<grid, COLS, smem, stream>>>(
      wr, wi, p2, p3, cst, sfs, na, n, P, transform, gamma2, txr, txi);
  return (int)cudaGetLastError();
}

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
