// The scatter of kernels B and B' (csrc/reassign.cu), shared with the
// probe of csrc/ablate_reassign.cu. The kernel takes a variant V
// (`ReassignAblate`; B and B' are kRFull) and a grid mode: the batch on
// blockIdx.y (B, B') or folded into a 1-D grid of batch * column tiles.
// The code lives in an anonymous namespace so that each source that
// includes it compiles its own instances.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "bins.cuh"

namespace {

using ssq::Plan;

constexpr int kUnroll = 8;    // rows whose loads are issued together

enum ReassignAblate {
  kRFull = 0,
  kRDmaOnly = 1,   // every plane read, zero Tx planes written
  kRBinOnly = 2,   // w and the bin of every entry; one row out: the sum of
                   // the unmasked bins and their count
  kRAddOnly = 3,   // Wx * const added into row i % nf in row order
                   // (no phase, no bin, no mask); dWx read
  kRChains2 = 4,   // even and odd rows into two accumulators, summed last
};

// Accumulator planes (of 2 * nf * COLS floats) a variant keeps in shared
// memory.
__host__ __device__ constexpr int acc_sets(int V) {
  return V == kRChains2 ? 2 : (V == kRDmaOnly || V == kRBinOnly) ? 0 : 1;
}

// kPlanes = 3: p2 is the w plane; kPlanes = 4: p2, p3 are dWx. `sink` is 0
// in every call: a store under it keeps the loads of the variants that
// drop their values (the compiler cannot know it is never taken).
template <int COLS, int kPlanes, int V = kRFull, bool kGrid1d = false>
__global__ void __launch_bounds__(COLS)
reassign_kernel(const float* __restrict__ wr, const float* __restrict__ wi,
                const float* __restrict__ p2, const float* __restrict__ p3,
                const float* __restrict__ cst, const float* __restrict__ sfs,
                int na, long long n, Plan P, int transform, float gamma2,
                int sink, float* __restrict__ txr, float* __restrict__ txi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);  // [sets][2][nf][COLS]
  const int nf = P.nf;
  const int tid = threadIdx.x;
  long long tile, bat;
  if constexpr (kGrid1d) {
    const long long tiles = (n + COLS - 1) / COLS;
    bat = blockIdx.x / tiles;
    tile = blockIdx.x % tiles;
  } else {
    tile = blockIdx.x;
    bat = blockIdx.y;
  }
  const long long j = tile * COLS + tid;
  const long long set = 2LL * nf * COLS;          // one accumulator set

  float* ar = acc + tid;
  float* ai = acc + (long long)nf * COLS + tid;
  constexpr int kSets = acc_sets(V);
#pragma unroll
  for (int s = 0; s < kSets; ++s) {
    for (int k = 0; k < nf; ++k) {
      ar[s * set + k * COLS] = 0.f;
      ai[s * set + k * COLS] = 0.f;
    }
  }
  if (j >= n) return;

  float held = 0.f;             // values a variant reads but does not use
  float kbins = 0.f, kcount = 0.f;  // kRBinOnly
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
        if constexpr (V == kRDmaOnly) {
          held += vr[u] + vi[u] + va[u] + (kPlanes == 4 ? vb[u] : 0.f);
        } else if constexpr (V == kRAddOnly) {
          const int k = i % nf;
          const float c = cst[i];
          ar[k * COLS] += __fmul_rn(vr[u], c);
          ai[k * COLS] += __fmul_rn(vi[u], c);
          held += va[u] + (kPlanes == 4 ? vb[u] : 0.f);
        } else {
          const float w = (kPlanes == 4)
              ? ssq::phase_w(vr[u], vi[u], va[u], vb[u], sfs[i], gamma2,
                             transform)
              : va[u];
          const int k = ssq::bin_of(w, P);
          if constexpr (V == kRBinOnly) {
            if (k >= 0) {
              kbins += (float)k;
              kcount += 1.f;
            }
          } else if (k >= 0) {
            const float c = cst[i];
            // kRChains2: odd rows (u odd: i0 is a multiple of kUnroll)
            // go to the second set
            const long long s = (V == kRChains2 && (u & 1)) ? set : 0;
            ar[s + k * COLS] += __fmul_rn(vr[u], c);
            ai[s + k * COLS] += __fmul_rn(vi[u], c);
          }
        }
      }
    }
  }

  if constexpr (V == kRBinOnly) {
    txr[bat * n + j] = kbins;
    txi[bat * n + j] = kcount;
    return;
  }
  const long long ob = bat * nf * n + j;
  for (int k = 0; k < nf; ++k) {
    float r = 0.f, m = 0.f;
    if constexpr (V == kRChains2) {
      r = __fadd_rn(ar[k * COLS], ar[set + k * COLS]);
      m = __fadd_rn(ai[k * COLS], ai[set + k * COLS]);
    } else if constexpr (V != kRDmaOnly) {
      r = ar[k * COLS];
      m = ai[k * COLS];
    }
    txr[ob + (long long)k * n] = r;
    txi[ob + (long long)k * n] = m;
  }
  if (sink) txr[ob] = held;
}

// One launch of the scatter over planes (batch, na, n) into (batch, nf, n)
// (kRBinOnly: (batch, 1, n)).
template <int COLS, int kPlanes, int V = kRFull, bool kGrid1d = false>
int launch(const float* wr, const float* wi, const float* p2, const float* p3,
           const float* cst, const float* sfs, int batch, int na, long long n,
           const Plan& P, int transform, float gamma2, float* txr, float* txi,
           cudaStream_t stream) {
  const size_t smem = (size_t)acc_sets(V) * 2 * P.nf * COLS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      reassign_kernel<COLS, kPlanes, V, kGrid1d>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((n + COLS - 1) / COLS);
  const dim3 grid = kGrid1d ? dim3(tiles * (unsigned)batch)
                            : dim3(tiles, (unsigned)batch);
  reassign_kernel<COLS, kPlanes, V, kGrid1d><<<grid, COLS, smem, stream>>>(
      wr, wi, p2, p3, cst, sfs, na, n, P, transform, gamma2, 0, txr, txi);
  return (int)cudaGetLastError();
}

}  // namespace
