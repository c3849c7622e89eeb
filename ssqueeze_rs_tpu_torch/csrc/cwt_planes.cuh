// Kernel D's two launches as they were before D and E moved onto the
// register-radix core (radix-2 four-step on fft4.cuh, Y through device
// memory), kept for the probes of csrc/ablate_cwt.cu, which ablate them.
// Every kernel and host helper takes a set of flags V: fft4::Ablate's (the
// pipeline's parts) and the two below (the kernel's loader and epilogue).
// The design in full is V = fft4::kFull.
// The code lives in an anonymous namespace so that each source that
// includes it compiles its own instances.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "fft4.cuh"
#include "planes.cuh"

namespace {

using fft4::kThreads;

enum PlanesAblate : unsigned {
  kNoOut = 1u << 8,     // store one column (j = 0) of each row: (rows, 1)
  kPwScalar = 1u << 9,  // Pw read once per block (its row's first value)
                        // and used for every bin: the pipeline on x alone
};

// Launch 1: P = 1 builds Z = Pw * x, P = 2 also the derivative pipeline
// dZ = (-Im Z, Re Z) * xig / dt.
template <int P, unsigned V>
__global__ void __launch_bounds__(kThreads)
cwt_planes_stage1(const float* __restrict__ Pw, const float* __restrict__ xr,
                  const float* __restrict__ xi, const float* __restrict__ xig,
                  float inv_dt, int na, int logM1, int M2, int tk2,
                  float2* __restrict__ Y, long long row0, long long nrows) {
  extern __shared__ float2 sm[];
  const int K1 = (1 << logM1) >> 1;
  const long long local = blockIdx.x;
  const long long row = row0 + local;
  const long long ia = row % na, ib = row / na;
  const float* pw = Pw + ia * (long long)K1 * M2;
  const float* sr = xr + ib * (long long)K1 * M2;
  const float* si = xi + ib * (long long)K1 * M2;
  float p0 = 0.f;
  if constexpr ((V & kPwScalar) != 0) p0 = pw[0];
  auto load = [&](long long g, float2* z) {
    const float p = (V & kPwScalar) ? p0 : pw[g];
    const float zr = p * sr[g];
    const float zi = p * si[g];
    z[0] = make_float2(zr, zi);
    if constexpr (P == 2) {
      const float s = xig[g] * inv_dt;
      z[1] = make_float2(-zi * s, zr * s);
    }
  };
  fft4::stage1<P, V>(sm, load, logM1, M2, tk2, blockIdx.y * tk2, Y, local,
                     nrows);
}

// Launch 2: pipeline p's kept outputs plus its Nyquist term (planes.cuh).
template <int P, unsigned V>
__global__ void __launch_bounds__(kThreads)
planes_stage2(const float2* __restrict__ Y, Planes pl, int logM1, int logM2,
              int tn1, int start, int L, long long row0, long long nrows) {
  extern __shared__ float2 sm[];
  const long long local = blockIdx.x;
  const long long row = row0 + local;
  float nr[P], ni[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    nr[p] = pl.nyq[2 * p][row];
    ni[p] = pl.nyq[2 * p + 1][row];
  }
  auto epi = [&](int j, float alt, float invM, const float2* v) {
    if ((V & kNoOut) && j != 0) return;
    const long long o = (V & kNoOut) ? row : row * L + j;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      pl.o[2 * p][o] = v[p].x * invM + nr[p] * alt;
      pl.o[2 * p + 1][o] = v[p].y * invM + ni[p] * alt;
    }
  };
  fft4::stage2<P, V>(sm, Y, logM1, logM2, tn1, blockIdx.y * tn1, start, L,
                     local, nrows, epi);
}

// Shared-memory sizes and tiles of both launches, set on the kernels.
struct Plan {
  int tk2, tn1;
  size_t smem1, smem2;
};

template <class K1, class K2>
cudaError_t plan_launches(K1 k1, K2 k2, int logM1, int logM2, int pipes,
                          Plan* plan) {
  const int M1 = 1 << logM1, M2 = 1 << logM2;
  plan->tk2 = fft4::pick_tile(M1, M2, pipes);
  plan->smem1 = fft4::smem_bytes(M1, plan->tk2, pipes);
  plan->tn1 = fft4::pick_tile(M2, M1, pipes);
  plan->smem2 = fft4::smem_bytes(M2, plan->tn1, pipes);
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan->smem1);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      k2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan->smem2);
}

// The flags each launch reads: a variant instantiates each launch on its
// own flags only, so variants that differ in one launch share the other.
constexpr unsigned kStage1Flags = fft4::kNoFft1 | fft4::kNoTwiddle |
                                  fft4::kNoRev | fft4::kYOnly | kPwScalar;
constexpr unsigned kStage2Flags = fft4::kNoFft2 | fft4::kNoRev |
                                  fft4::kYOnly | kNoOut;

// Both launches over rows in chunks of at most `ychunk` (Y: scratch of
// P*ychunk*M float2). Returns cudaGetLastError() after the launches.
template <int P, unsigned V>
int cwt_planes_run(const float* Pw, const float* xr, const float* xi,
                   const float* xig, float inv_dt, Planes pl, long long rows,
                   int na, int logM1, int logM2, int start, int L, void* Y,
                   long long ychunk, cudaStream_t st) {
  constexpr unsigned V1 = V & kStage1Flags, V2 = V & kStage2Flags;
  Plan plan;
  cudaError_t err = plan_launches(cwt_planes_stage1<P, V1>,
                                  planes_stage2<P, V2>, logM1, logM2, P,
                                  &plan);
  if (err != cudaSuccess) return (int)err;
  const int M1 = 1 << logM1, M2 = 1 << logM2;
  for (long long row0 = 0; row0 < rows; row0 += ychunk) {
    const long long nr = rows - row0 < ychunk ? rows - row0 : ychunk;
    cwt_planes_stage1<P, V1><<<dim3((unsigned)nr, M2 / plan.tk2), kThreads,
                               plan.smem1, st>>>(
        Pw, xr, xi, xig, inv_dt, na, logM1, M2, plan.tk2, (float2*)Y, row0,
        nr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    planes_stage2<P, V2><<<dim3((unsigned)nr, M1 / plan.tn1), kThreads,
                           plan.smem2, st>>>(
        (const float2*)Y, pl, logM1, logM2, plan.tn1, start, L, row0, nr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace
