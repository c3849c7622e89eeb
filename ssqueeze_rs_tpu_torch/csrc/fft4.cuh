// The radix-2 half-band four-step inverse DFT: the design kernels A, D and
// E ran before they moved to the register-radix core (cwt_planes.cu on
// fft_radix.cuh). Its only users are the probes P1-P3 (ablate_cwt.cu,
// through cwt_planes.cuh).
//
// Each output row is the length-M inverse DFT of a spectrum that is zero
// above the Nyquist bin:
//
//   out(n) = (1/M) sum_{k < M/2} Z[k] e^{2 pi i k n / M} + nyq (-1)^n / M
//
// kept only for n in the window [start, start+L). Up to two spectra per row
// (pipelines) go through together, e.g. Z and its derivative spectrum.
//
// Split M = M1*M2, k = M2*k1 + k2, n = n1 + M1*n2:
//   stage 1 (one block per (row, tk2 k2-columns)): the kernel's loader
//     builds Z[k1, k2] for k1 < K1 = M1/2 into shared memory in
//     bit-reversed order, a radix-2 inverse FFT over k1 runs in shared
//     memory, and the twiddled result Y[pipe][row][n1][k2] (complex) is
//     stored to device memory;
//   stage 2 (one block per (row, tn1 n1-rows)): a length-M2 inverse FFT over
//     k2 in shared memory, then the kernel's epilogue is called once for
//     each output inside the keep window with the unscaled values of every
//     pipeline; the epilogue adds the Nyquist term and scales by 1/M.
// Consecutive threads handle consecutive n1 (so consecutive n) in the
// epilogue, and consecutive k2 in stage 1's stores, so both device-memory
// passes are written in 32-byte runs or longer.
//
// Twiddles are e^{2 pi i m / P} = sincospif(2m/P) with 2m/P exact in float
// (P a power of two), accurate to ~1 ulp; per-FFT tables live in shared
// memory. Every column's arithmetic is the same whatever the tile, the
// chunk of rows or the block, so a row's result does not depend on them.
//
// Both stages take a set of ablation flags (`Ablate`, default kFull) for
// the probes of csrc/ablate_cwt.cu: each flag removes one part of the
// pipeline and keeps the memory traffic of the rest. kFull compiles to the
// pipeline above.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace fft4 {

enum Ablate : unsigned {
  kFull = 0,
  kNoFft1 = 1,      // stage 1 without its butterflies
  kNoFft2 = 2,      // stage 2 without its butterflies
  kNoTwiddle = 4,   // stage 1 stores Y without the twiddle multiply
  kNoRev = 8,       // natural-order shared-memory scatter in both stages
  kYOnly = 16,      // stage 1 copies Z to Y (row k1 as row n1) with no
                    // shared memory; stage 2 as kNoFft2 | kNoRev
};

constexpr int kThreads = 256;
// Shared-memory budget per block when choosing the column tile.
constexpr int kSmemBudget = 200 * 1024;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ unsigned bitrev(unsigned v, int logP) {
  return __brev(v) >> (32 - logP);
}

// Twiddle table tw[t] = e^{2 pi i t / P}, t < P/2.
__device__ inline void fill_twiddles(float2* tw, int P) {
  for (int t = threadIdx.x; t < P / 2; t += blockDim.x) {
    float s, c;
    sincospif(2.0f * (float)t / (float)P, &s, &c);
    tw[t] = make_float2(c, s);
  }
}

// In-place radix-2 inverse DFT (unnormalised, sign +) of `ncol` columns
// of length P = 2^logP, column stride `ld`, inputs already in bit-reversed
// order; outputs come out in natural order.
__device__ inline void fft_columns(float2* buf, int ncol, int ld, int logP,
                                   const float2* tw) {
  const int P = 1 << logP;
  const int half = P >> 1;
  const int nbf = ncol * half;
  for (int lh = 0; lh < logP; ++lh) {
    const int h = 1 << lh;
    const int tstride = half >> lh;      // P / (2h)
    for (int q = threadIdx.x; q < nbf; q += blockDim.x) {
      const int col = q >> (logP - 1);
      const int b = q & (half - 1);
      const int j = b & (h - 1);
      const int i0 = ((b >> lh) << (lh + 1)) | j;
      float2* X = buf + (size_t)col * ld;
      const float2 a = X[i0];
      const float2 t = cmul(X[i0 + h], tw[j * tstride]);
      X[i0] = make_float2(a.x + t.x, a.y + t.y);
      X[i0 + h] = make_float2(a.x - t.x, a.y - t.y);
    }
    __syncthreads();
  }
}

// Largest power of two <= 8 whose `pipes` column tiles of length P (plus
// the twiddle table) fit the budget, and at most `other`.
inline int pick_tile(int P, int other, int pipes) {
  int t = 8;
  while (t > 1 &&
         (pipes * t * (P + 1) + P / 2) * (int)sizeof(float2) > kSmemBudget)
    t >>= 1;
  return t < other ? t : other;
}

// Dynamic shared memory of a stage over length P with tile t.
inline size_t smem_bytes(int P, int t, int pipes) {
  return (size_t)(pipes * t * (P + 1) + P / 2) * sizeof(float2);
}

// Stage 1, first half, for the k2-columns [k2_0, k2_0 + tk2): `load(g, z)`
// fills z[0..P) with the P pipelines' values at flat half-band index
// g = k1*M2 + k2 (k1 < K1), placed in `buf` ([P][tk2][M1 + 1]) at the
// bit-reversed position of k1 (rows k1 >= K1 are zero). No barrier.
template <int P, unsigned V = kFull, class Load>
__device__ inline void stage1_scatter(float2* buf, const Load& load,
                                      int logM1, int M2, int tk2, int k2_0) {
  const int M1 = 1 << logM1;
  const int K1 = M1 >> 1;
  const int ld = M1 + 1;                  // padded column stride
  for (int e = threadIdx.x; e < M1 * tk2; e += blockDim.x) {
    const int c = e % tk2;
    const int k1 = e / tk2;
    float2 z[P];
    if (k1 < K1) {
      load((long long)k1 * M2 + k2_0 + c, z);
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p) z[p] = make_float2(0.f, 0.f);
    }
    const int pos = (V & kNoRev) ? k1 : (int)bitrev(k1, logM1);
#pragma unroll
    for (int p = 0; p < P; ++p) buf[(p * tk2 + c) * ld + pos] = z[p];
  }
}

// Stage 1, second half, after a barrier over the scatter: the length-M1
// FFTs of `buf` (twiddle table `tw`) and the twiddled store of Y. Y holds
// P * nrows rows of M complex values: pipeline p of row `local` is row
// p*nrows + local. No barrier after the stores: a caller that reuses
// `buf` synchronises first.
template <int P, unsigned V = kFull>
__device__ inline void stage1_store(float2* buf, const float2* tw, int logM1,
                                    int M2, int tk2, int k2_0,
                                    float2* __restrict__ Y, long long local,
                                    long long nrows) {
  const int M1 = 1 << logM1;
  const int ld = M1 + 1;
  if constexpr (!(V & kNoFft1)) fft_columns(buf, P * tk2, ld, logM1, tw);

  const long long M = (long long)M1 * M2;
  const float invM2x = 2.0f / (float)M;   // exact: M is a power of two
  for (int e = threadIdx.x; e < M1 * tk2; e += blockDim.x) {
    const int c = e % tk2;
    const int n1 = e / tk2;
    const int k2 = k2_0 + c;
    const long long o = (long long)n1 * M2 + k2;
    if constexpr (V & kNoTwiddle) {
#pragma unroll
      for (int p = 0; p < P; ++p)
        Y[(p * nrows + local) * M + o] = buf[(p * tk2 + c) * ld + n1];
    } else {
      // e^{2 pi i n1 k2 / M}; n1*k2 < M <= 2^22, so the argument is exact
      float s, co;
      sincospif((float)(n1 * k2) * invM2x, &s, &co);
      const float2 t = make_float2(co, s);
#pragma unroll
      for (int p = 0; p < P; ++p)
        Y[(p * nrows + local) * M + o] =
            cmul(buf[(p * tk2 + c) * ld + n1], t);
    }
  }
}

// Stage 1 for the block (row `local` of the chunk, k2-columns
// [k2_0, k2_0 + tk2)): `stage1_scatter`, a barrier, `stage1_store`.
template <int P, unsigned V = kFull, class Load>
__device__ inline void stage1(float2* sm, const Load& load, int logM1, int M2,
                              int tk2, int k2_0, float2* __restrict__ Y,
                              long long local, long long nrows) {
  const int M1 = 1 << logM1;
  const int K1 = M1 >> 1;
  float2* tw = sm;                        // M1/2 twiddles
  float2* buf = sm + K1;                  // [P][tk2][M1 + 1]

  if constexpr (V & kYOnly) {
    // the two-launch design's memory floor: Z straight to Y, row k1 as
    // row n1 (rows k1 >= K1 zero), in the full pipeline's access pattern
    const long long M = (long long)M1 * M2;
    for (int e = threadIdx.x; e < M1 * tk2; e += blockDim.x) {
      const int c = e % tk2;
      const int k1 = e / tk2;
      float2 z[P];
      if (k1 < K1) {
        load((long long)k1 * M2 + k2_0 + c, z);
      } else {
#pragma unroll
        for (int p = 0; p < P; ++p) z[p] = make_float2(0.f, 0.f);
      }
      const long long o = (long long)k1 * M2 + k2_0 + c;
#pragma unroll
      for (int p = 0; p < P; ++p) Y[(p * nrows + local) * M + o] = z[p];
    }
  } else {
    fill_twiddles(tw, M1);
    stage1_scatter<P, V>(buf, load, logM1, M2, tk2, k2_0);
    __syncthreads();
    stage1_store<P, V>(buf, tw, logM1, M2, tk2, k2_0, Y, local, nrows);
  }
}

// Stage 2 for the block (row `local` of the chunk, n1-rows
// [n1_0, n1_0 + tn1)). For every kept output n (j = n - start in [0, L))
// calls epi(j, alt, invM, v) with v[p] the unscaled inverse DFT of
// pipeline p at n, invM = 1/M and alt = (-1)^n / M; the epilogue forms
// v.x * invM + nyq.x * alt (and likewise .y).
template <int P, unsigned V = kFull, class Epi>
__device__ inline void stage2(float2* sm, const float2* __restrict__ Y,
                              int logM1, int logM2, int tn1, int n1_0,
                              int start, int L, long long local,
                              long long nrows, const Epi& epi) {
  constexpr bool kFft = !(V & (kNoFft2 | kYOnly));
  constexpr bool kRev = !(V & (kNoRev | kYOnly));
  const int M2 = 1 << logM2;
  const int ld = M2 + 1;
  float2* tw = sm;                        // M2/2 twiddles
  float2* buf = sm + (M2 >> 1);           // [P][tn1][ld]
  const long long M = (long long)M2 << logM1;

  if constexpr (kFft) fill_twiddles(tw, M2);
  for (int e = threadIdx.x; e < tn1 * M2; e += blockDim.x) {
    const int c = e >> logM2;
    const int k2 = e & (M2 - 1);
    const long long g = (long long)(n1_0 + c) * M2 + k2;
    const int pos = kRev ? (int)bitrev(k2, logM2) : k2;
#pragma unroll
    for (int p = 0; p < P; ++p)
      buf[(p * tn1 + c) * ld + pos] = Y[(p * nrows + local) * M + g];
  }
  __syncthreads();

  if constexpr (kFft) fft_columns(buf, P * tn1, ld, logM2, tw);

  const float invM = 1.0f / (float)M;
  const int r0 = start >> logM1;
  const int r1 = ((start + L - 1) >> logM1) + 1;
  const int nout = tn1 * (r1 - r0);
  for (int e = threadIdx.x; e < nout; e += blockDim.x) {
    const int c = e % tn1;
    const int n2 = r0 + e / tn1;
    const int n = n1_0 + c + (n2 << logM1);
    const int j = n - start;
    if (j < 0 || j >= L) continue;
    const float alt = (n & 1) ? -invM : invM;
    float2 v[P];
#pragma unroll
    for (int p = 0; p < P; ++p) v[p] = buf[(p * tn1 + c) * ld + n2];
    epi(j, alt, invM, v);
  }
}

}  // namespace fft4
