// Kernel B: analytic frequency binning + deterministic reassignment
// (synchrosqueezing scatter) for sm_90a, 3-plane contract.
//
// Replaces ssqueeze_rs_tpu/ops/reassign_pallas.py::_make_kernel with
// phase_in=True (binning in _bin_indices). For each column j and each row
// i in fixed order 0..na-1:
//
//   k = bin(w[i,j])   log / log-piecewise / lin closed form, round half to
//                     even, w == 0 -> k = 0 for the log modes, flipud
//                     k -> nf-1-k; entries with w == +inf are masked
//   Tx[k, j] += (Wxr[i,j] * const[i], Wxi[i,j] * const[i])
//
// One thread owns one column and walks its rows in order, accumulating
// into that column of a shared-memory (2, nf, 32) block of planes. No two
// threads touch the same accumulator, so there are no atomics and no
// barriers, and every output is a sum taken in row order: the result is
// bitwise the same from run to run. The block then stores its columns,
// 32 consecutive floats per warp store.
//
// What bounds it on Hopper: latency of the row walk at low occupancy. The
// accumulator (2 * nf * 32 * 4 B = 75 KB at nf = 293) admits 3 blocks of
// one warp per SM, so few loads are in flight; the bytes moved (three
// input planes read once, two output planes written once) would take
// well under a millisecond at full bandwidth. What the design does about
// it: the row loop is unrolled so each thread issues the loads of kUnroll
// rows before it uses them, and the products are rounded as in the
// reference (value = Wx * const, then added) so the sum order is the only
// freedom and it is fixed. The banded variant of the reference
// (_band_mode) is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCols = 32;     // columns (= threads) per block
constexpr int kUnroll = 8;    // rows whose loads are issued together

enum Mode { kLog = 0, kLogPiecewise = 1, kLin = 2 };

struct Plan {
  int mode, flipud, nf;
  float p0, p1, p2, p3, p4;   // log: vlmin, dvl; log-piecewise: vlmin0,
                              // vlmin1, dvl0, dvl1, idx1; lin: vmin, dv
};

// Bin of one phase value; -1 when masked (w == +inf).
__device__ __forceinline__ int bin_of(float w, const Plan& P) {
  if (!(w < INFINITY)) return -1;
  const float omax = (float)(P.nf - 1);
  const float wsafe = (w > 0.f) ? w : 1.f;
  float k;
  if (P.mode == kLog) {
    k = fminf(rintf(fmaxf((log2f(wsafe) - P.p0) / P.p1, 0.f)), omax);
  } else if (P.mode == kLogPiecewise) {
    const float wl = log2f(wsafe);
    const float k_hi = fminf(rintf((wl - P.p1) / P.p3) + P.p4, omax);
    const float k_lo = fmaxf(rintf((wl - P.p0) / P.p2), 0.f);
    k = (wl > P.p1) ? k_hi : k_lo;
  } else {
    k = fminf(rintf(fmaxf((w - P.p0) / P.p1, 0.f)), omax);
  }
  if (P.mode != kLin && !(w > 0.f)) k = 0.f;
  int ki = (int)k;
  if (P.flipud) ki = P.nf - 1 - ki;
  return ki;
}

__global__ void __launch_bounds__(kCols)
reassign_kernel(const float* __restrict__ wr, const float* __restrict__ wi,
                const float* __restrict__ w, const float* __restrict__ cst,
                int na, long long n, Plan P, float* __restrict__ txr,
                float* __restrict__ txi) {
  extern __shared__ float acc[];          // [2][nf][kCols]
  const int nf = P.nf;
  const int tid = threadIdx.x;
  const long long j = (long long)blockIdx.x * kCols + tid;
  const long long bat = blockIdx.y;

  float* ar = acc + tid;
  float* ai = acc + (long long)nf * kCols + tid;
  for (int k = 0; k < nf; ++k) {
    ar[k * kCols] = 0.f;
    ai[k * kCols] = 0.f;
  }
  if (j >= n) return;

  const long long base = bat * na * n + j;
  for (int i0 = 0; i0 < na; i0 += kUnroll) {
    float vw[kUnroll], vr[kUnroll], vi[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u < na) {
        const long long o = base + (long long)(i0 + u) * n;
        vw[u] = w[o];
        vr[u] = wr[o];
        vi[u] = wi[o];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u < na) {
        const int k = bin_of(vw[u], P);
        if (k >= 0) {
          const float c = cst[i0 + u];
          ar[k * kCols] += __fmul_rn(vr[u], c);
          ai[k * kCols] += __fmul_rn(vi[u], c);
        }
      }
    }
  }

  const long long ob = bat * nf * n + j;
  for (int k = 0; k < nf; ++k) {
    txr[ob + (long long)k * n] = ar[k * kCols];
    txi[ob + (long long)k * n] = ai[k * kCols];
  }
}

}  // namespace

// Planes are (batch, na, n) and (batch, nf, n), row-major float32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssq_reassign(const float* wr, const float* wi, const float* w,
                            const float* cst, int batch, int na, long long n,
                            int nf, int mode, int flipud, float p0, float p1,
                            float p2, float p3, float p4, float* txr,
                            float* txi, void* stream) {
  const Plan P{mode, flipud, nf, p0, p1, p2, p3, p4};
  const size_t smem = (size_t)2 * nf * kCols * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      reassign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + kCols - 1) / kCols), (unsigned)batch);
  reassign_kernel<<<grid, kCols, smem, (cudaStream_t)stream>>>(
      wr, wi, w, cst, na, n, P, txr, txi);
  return (int)cudaGetLastError();
}

extern "C" const char* ssq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
