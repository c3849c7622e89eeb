// Shared device code of kernels F (stft_dft.cu) and G (ssq_stft.cu): one
// block tile of the hop-1 windowed DFT, the product of a stacked DFT
// matrix K with the Hankel frame matrix of the signal,
//
//   acc[i][m] = sum over t < NP of K[t, kcol0 + ty*TM + i] * xw[tx*TN + m + t]
//
// where xw is the block's signal window in shared memory (frame t of
// column c is xw[c + t], so the frame matrix never exists anywhere) and K
// is (NP, ldk) row-major in device memory, zero-padded to NP taps, a
// multiple of kBK. Every output is a sum over t in increasing order with
// fused multiply-adds from 0, whatever the tile shape, so F and G produce
// the same bits for the same output.
//
// K streams through a double-buffered (kBK, BM) shared-memory tile: each
// thread loads its share of the next tile into registers while the block
// computes on the current one, then stores it (one barrier per tile).
// Each thread keeps a (TM, TN) register tile; per tap it reads TM values
// of K and slides a window of TN + kBK signal values (TN consecutive
// columns), read once per K tile as float4.
#pragma once

#include <cuda_runtime.h>

namespace ssq {

constexpr int kBK = 16;       // taps per K tile

// xw[q] = x[j0 + q] for q < n, 0 at and past mp.
__device__ __forceinline__ void stage_signal(const float* __restrict__ x,
                                             long long mp, long long j0,
                                             int n, float* xw) {
  for (int q = threadIdx.x; q < n; q += blockDim.x) {
    const long long p = j0 + q;
    xw[q] = (p < mp) ? x[p] : 0.f;
  }
}

template <int BM, int BN, int TM, int TN>
struct DftTile {
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kLoads = kBK * BM / 4 / kThreads;  // float4/thread
  static_assert(kLoads * 4 * kThreads == kBK * BM, "K tile split");
  static_assert(TN % 4 == 0, "window read as float4");
  static constexpr int kAsFloats = 2 * kBK * BM;           // shared K tiles
  // signal window length: every column of the tile and NP taps, +1 slack
  // for the last float4 of the last window
  static __host__ __device__ int window(int NP) { return BN + NP; }
};

// Sets acc (each sum starts from 0).
// xw: DftTile::window(NP) staged values (16-byte aligned); As: kAsFloats
// floats of shared memory (16-byte aligned). All threads of the block
// call it; it begins and ends with the block in step.
template <int BM, int BN, int TM, int TN>
__device__ __forceinline__ void dft_tile(const float* __restrict__ K,
                                         long long ldk, long long kcol0,
                                         int NP, const float* xw, float* As,
                                         float (&acc)[TM][TN]) {
  using Tile = DftTile<BM, BN, TM, TN>;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int m = 0; m < TN; ++m) acc[i][m] = 0.f;

  float4 pre[Tile::kLoads];
#pragma unroll
  for (int l = 0; l < Tile::kLoads; ++l) {
    const int e = tid + l * Tile::kThreads;
    const int k = e / (BM / 4), r4 = e % (BM / 4);
    pre[l] = *reinterpret_cast<const float4*>(K + (long long)k * ldk + kcol0 +
                                              4 * r4);
  }
#pragma unroll
  for (int l = 0; l < Tile::kLoads; ++l) {
    const int e = tid + l * Tile::kThreads;
    const int k = e / (BM / 4), r4 = e % (BM / 4);
    *reinterpret_cast<float4*>(As + k * BM + 4 * r4) = pre[l];
  }
  __syncthreads();

  int buf = 0;
  for (int kt = 0; kt < NP; kt += kBK) {
    const bool more = kt + kBK < NP;
    if (more) {
#pragma unroll
      for (int l = 0; l < Tile::kLoads; ++l) {
        const int e = tid + l * Tile::kThreads;
        const int k = e / (BM / 4), r4 = e % (BM / 4);
        pre[l] = *reinterpret_cast<const float4*>(
            K + (long long)(kt + kBK + k) * ldk + kcol0 + 4 * r4);
      }
    }
    float win[TN + kBK];
    const float4* xs = reinterpret_cast<const float4*>(xw + kt + tx * TN);
#pragma unroll
    for (int q = 0; q < (TN + kBK) / 4; ++q) {
      const float4 v = xs[q];
      win[4 * q] = v.x;
      win[4 * q + 1] = v.y;
      win[4 * q + 2] = v.z;
      win[4 * q + 3] = v.w;
    }
    const float* as = As + buf * kBK * BM + ty * TM;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[TM];
      if (TM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(as + k * BM + i);
          a[i] = v.x;
          a[i + 1] = v.y;
          a[i + 2] = v.z;
          a[i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = as[k * BM + i];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int m = 0; m < TN; ++m)
          acc[i][m] = __fmaf_rn(a[i], win[k + m], acc[i][m]);
    }
    if (more) {
      float* dst = As + (buf ^ 1) * kBK * BM;
#pragma unroll
      for (int l = 0; l < Tile::kLoads; ++l) {
        const int e = tid + l * Tile::kThreads;
        const int k = e / (BM / 4), r4 = e % (BM / 4);
        *reinterpret_cast<float4*>(dst + k * BM + 4 * r4) = pre[l];
      }
    }
    __syncthreads();
    buf ^= 1;
  }
}

}  // namespace ssq
