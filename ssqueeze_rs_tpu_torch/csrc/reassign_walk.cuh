// The row walk: the design kernels B and B' ran before they took 16 lanes
// a column (csrc/reassign.cu: one thread a column, one warp a block,
// every row of the column walked in order). Probe P4 (csrc/ablate_reassign.cu)
// keeps it as its `walk` variant: an independent kernel whose Tx B and B'
// give bit for bit, which chip_smoke holds them to. The code lives in an
// anonymous namespace so that each source that includes it compiles its
// own instances.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "bins.cuh"

namespace {

using ssq::Plan;

constexpr int kUnroll = 8;    // rows whose loads are issued together

// kPlanes = 3: p2 is the w plane; kPlanes = 4: p2, p3 are dWx. The batch
// on blockIdx.y.
template <int COLS, int kPlanes>
__global__ void __launch_bounds__(COLS)
reassign_walk_kernel(const float* __restrict__ wr,
                     const float* __restrict__ wi,
                     const float* __restrict__ p2,
                     const float* __restrict__ p3,
                     const float* __restrict__ cst,
                     const float* __restrict__ sfs, int na, long long n,
                     Plan P, int transform, float gamma2,
                     float* __restrict__ txr, float* __restrict__ txi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);  // [2][nf][COLS]
  const int nf = P.nf;
  const int tid = threadIdx.x;
  const long long bat = blockIdx.y;
  const long long j = (long long)blockIdx.x * COLS + tid;

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

// One launch of the walk over planes (batch, na, n) into (batch, nf, n).
template <int COLS, int kPlanes>
int launch_walk(const float* wr, const float* wi, const float* p2,
                const float* p3, const float* cst, const float* sfs, int batch,
                int na, long long n, const Plan& P, int transform,
                float gamma2, float* txr, float* txi, cudaStream_t stream) {
  const size_t smem = (size_t)2 * P.nf * COLS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      reassign_walk_kernel<COLS, kPlanes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + COLS - 1) / COLS), (unsigned)batch);
  reassign_walk_kernel<COLS, kPlanes>
      <<<grid, COLS, smem, stream>>>(wr, wi, p2, p3, cst, sfs, na, n, P,
                                     transform, gamma2, txr, txi);
  return (int)cudaGetLastError();
}

}  // namespace
