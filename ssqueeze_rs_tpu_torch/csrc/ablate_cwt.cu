// Probes P1-P3: where kernel D's time went in its earlier radix-2 design
// (the CWT planes with the derivative as two radix-2 launches through an
// intermediate in device memory, cwt_planes.cuh), for sm_90a. D itself
// and E run on the register-radix core (cwt_planes.cu, fft_radix.cuh);
// these probes still ablate the radix-2 design, which no kernel on the
// port's paths runs any more.
//
// They replace the TPU probes of tools/ablate_cwt_kernel.py and
// tools/cwt_kernel_probe.py, which timed stripped variants of the fused
// Pallas CWT kernel at the cwt headline (293 rows, M = 2^18, 160 000 kept
// columns, with the derivative):
//
// P1 (ssq_ablate_cwt; _make_kernel :62, pallas_call :359, and
//   cwt_kernel_probe.make_kernel :52, :119): the radix-2 design's two launches
//   (cwt_planes.cuh) instantiated with ablation flags:
//     full      the radix-2 design, whole (within 1e-5 of D's plain)
//     nostage1  no length-M1 butterflies (load, bit-reversed scatter,
//               twiddle and Y store stay)
//     nostage2  no length-M2 butterflies
//     nofft     neither (the TPU nodots, cwt_kernel_probe's glue)
//     notwiddle Y stored without the sincospif twiddle multiply
//     norev     natural-order shared-memory scatters (the TPU nolayout)
//     yonly     launch 1 copies Z to Y, launch 2 copies Y to the planes:
//               the two-launch design's memory floor (the probe's dma)
//     noout     full compute, one column of each row stored
//     overlap   full compute on x alone: Pw read once per block (its
//               row's first value) and used for every bin
//   The TPU's nosplit, ksplitC and dots4 time its bf16 dot splits, which
//   this port does not have.
// P2 (ssq_cwt_copy_floor; run_dma's kernel :395, :404): the copy floor of
//   any one-pass design at these bytes: every Pw row read once and written
//   to the first K columns of 4 (dmaonly) or 1 (dma1) planes of (rows, L),
//   the rest zero; dmanoin writes zero planes and reads nothing; dmarb8
//   gives each block 8 rows instead of 1.
// P3 (ssq_cwt_staged; _make_manual_kernel :195, :311): D's launch 1 as a
//   persistent kernel (the SMs times the blocks that fit on one) over
//   (row, k2-tile) items, each block bringing the next item's Pw, x, xig
//   tiles into a second shared-memory slot with 16-byte cp.async.cg while
//   the current item's butterflies run; launch 2 is P1's. Same arithmetic,
//   so the planes are P1 full's bit for bit.
//
// What bounds them: D's work moves ~0.91 GB at the headline (Pw 0.15 GB
// in, four 0.19 GB planes out), ~0.27 ms at 3.35 TB/s; P2 is that floor
// as a kernel, P1 splits the radix-2 design's ~5.9 ms between its parts,
// P3 asks whether
// explicit asynchronous staging buys anything on this card.

#include <cuda_runtime.h>
#include <math.h>

#include "cwt_planes.cuh"

namespace {

using fft4::kNoFft1;
using fft4::kNoFft2;
using fft4::kNoRev;
using fft4::kNoTwiddle;
using fft4::kYOnly;

// -- P1 -------------------------------------------------------------------
// Flags of P1's variants, in the order of the `variant` argument.
constexpr unsigned kVariantFlags[] = {
    fft4::kFull,          // full
    kNoFft1,              // nostage1
    kNoFft2,              // nostage2
    kNoFft1 | kNoFft2,    // nofft
    kNoTwiddle,           // notwiddle
    kNoRev,               // norev
    kYOnly,               // yonly
    kNoOut,               // noout
    kPwScalar,            // overlap
};
constexpr int kVariants = sizeof(kVariantFlags) / sizeof(kVariantFlags[0]);

template <int I>
int ablate_run(int variant, const float* Pw, const float* xr,
               const float* xi, const float* xig, float inv_dt, Planes pl,
               long long rows, int na, int logM1, int logM2, int start, int L,
               void* Y, long long ychunk, cudaStream_t st) {
  if constexpr (I == kVariants) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (variant == I)
      return cwt_planes_run<2, kVariantFlags[I]>(Pw, xr, xi, xig, inv_dt, pl,
                                                 rows, na, logM1, logM2,
                                                 start, L, Y, ychunk, st);
    return ablate_run<I + 1>(variant, Pw, xr, xi, xig, inv_dt, pl, rows, na,
                             logM1, logM2, start, L, Y, ychunk, st);
  }
}

// -- P2 -------------------------------------------------------------------
constexpr int kCopyVec = 4;     // float4 per thread per row

template <int NP, int RB, bool kRead>
__global__ void __launch_bounds__(kThreads)
copy_floor(const float* __restrict__ Pw, long long K, int rows, long long L,
           Planes pl) {
  const long long L4 = L / 4, K4 = K / 4;
  const long long j0 = (long long)blockIdx.x * (kThreads * kCopyVec) +
                       threadIdx.x;
  for (int r = 0; r < RB; ++r) {
    const long long row = (long long)blockIdx.y * RB + r;
    if (row >= rows) return;
    const float4* src = reinterpret_cast<const float4*>(Pw + row * K);
    float4 v[kCopyVec];
#pragma unroll
    for (int u = 0; u < kCopyVec; ++u) {
      const long long j = j0 + u * kThreads;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kRead && j < K4 && j < L4) v[u] = src[j];
    }
#pragma unroll
    for (int u = 0; u < kCopyVec; ++u) {
      const long long j = j0 + u * kThreads;
      if (j >= L4) break;
#pragma unroll
      for (int p = 0; p < NP; ++p)
        reinterpret_cast<float4*>(pl.o[p] + row * L)[j] = v[u];
    }
  }
}

template <int NP, int RB, bool kRead>
int copy_run(const float* Pw, long long K, int rows, long long L, Planes pl,
             cudaStream_t st) {
  const long long cols = kThreads * kCopyVec * 4;
  const dim3 grid((unsigned)((L + cols - 1) / cols),
                  (unsigned)((rows + RB - 1) / RB));
  copy_floor<NP, RB, kRead><<<grid, kThreads, 0, st>>>(Pw, K, rows, L, pl);
  return (int)cudaGetLastError();
}

// -- P3 -------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Floats of one staging slot: the Pw, xr, xi and xig tiles, each
// (K1, tk2).
__host__ __device__ inline int slot_floats(int K1, int tk2) {
  return 4 * K1 * tk2;
}

// D's launch 1 (P = 2) as a persistent kernel over items (row, k2-tile),
// rows fastest as in D's grid. Shared memory: two slots, then the
// twiddles and the transform buffer of fft4::stage1.
__global__ void __launch_bounds__(kThreads)
staged_stage1(const float* __restrict__ Pw, const float* __restrict__ xr,
              const float* __restrict__ xi, const float* __restrict__ xig,
              float inv_dt, int na, int logM1, int logM2, int tk2,
              float2* __restrict__ Y, long long row0, long long nrows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int M1 = 1 << logM1, M2 = 1 << logM2, K1 = M1 >> 1;
  const int sf = slot_floats(K1, tk2);
  float* slots = reinterpret_cast<float*>(smem_raw);   // [2][4][K1][tk2]
  float2* tw = reinterpret_cast<float2*>(slots + 2 * sf);
  float2* buf = tw + K1;
  const long long items = nrows * (M2 / tk2);
  const int q = tk2 / 4;                 // 16-byte chunks per tile row

  auto issue = [&](long long item, int slot) {
    const long long row = row0 + item % nrows;
    const int k2_0 = (int)(item / nrows) * tk2;
    const long long ia = row % na, ib = row / na;
    const long long plane = (long long)K1 * M2;
    float* dst = slots + slot * sf;
    for (int e = threadIdx.x; e < 4 * K1 * q; e += blockDim.x) {
      const int a = e / (K1 * q);          // Pw, xr, xi, xig
      const int r = e - a * K1 * q;
      const int k1 = r / q;
      const int c4 = (r - k1 * q) * 4;
      const float* src = a == 0 ? Pw + ia * plane
                         : a == 1 ? xr + ib * plane
                         : a == 2 ? xi + ib * plane : xig;
      cp_async16(dst + (a * K1 + k1) * tk2 + c4,
                 src + (long long)k1 * M2 + k2_0 + c4);
    }
  };

  fft4::fill_twiddles(tw, M1);
  long long item = blockIdx.x;
  if (item < items) issue(item, 0);
  cp_async_commit();
  for (int slot = 0; item < items; item += gridDim.x, slot ^= 1) {
    if (item + gridDim.x < items) issue(item + gridDim.x, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                  // this item's tiles have landed
    __syncthreads();
    const long long local = item % nrows;
    const int k2_0 = (int)(item / nrows) * tk2;
    const float* tp = slots + slot * sf;
    const float* tr = tp + K1 * tk2;
    const float* ti = tr + K1 * tk2;
    const float* tg = ti + K1 * tk2;
    auto load = [&](long long g, float2* z) {     // D's loader
      const int t = (int)(g >> logM2) * tk2 + (int)(g & (M2 - 1)) - k2_0;
      const float p = tp[t];
      const float zr = p * tr[t];
      const float zi = p * ti[t];
      const float s = tg[t] * inv_dt;
      z[0] = make_float2(zr, zi);
      z[1] = make_float2(-zi * s, zr * s);
    };
    fft4::stage1_scatter<2>(buf, load, logM1, M2, tk2, k2_0);
    __syncthreads();
    fft4::stage1_store<2>(buf, tw, logM1, M2, tk2, k2_0, Y, local, nrows);
    __syncthreads();                     // buf and this slot are free
  }
  cp_async_wait<0>();
}

}  // namespace

// P1. The arguments of ssq_cwt_planes with the derivative (Y: scratch of
// 2*ychunk*M float2) and `variant`: 0 full, 1 nostage1, 2 nostage2,
// 3 nofft, 4 notwiddle, 5 norev, 6 yonly, 7 noout (planes (rows, 1)),
// 8 overlap. Returns cudaGetLastError() after the launches.
extern "C" int ssq_ablate_cwt(const float* Pw, const float* xr,
                              const float* xi, const float* xig, float inv_dt,
                              const float* nwr, const float* nwi,
                              const float* ndr, const float* ndi,
                              long long rows, int na, int logM1, int logM2,
                              int start, int L, int variant, void* Y,
                              long long ychunk, float* owr, float* owi,
                              float* odr, float* odi, void* stream) {
  if (ychunk < 1) return (int)cudaErrorInvalidValue;
  Planes pl = {{nwr, nwi, ndr, ndi}, {owr, owi, odr, odi}};
  return ablate_run<0>(variant, Pw, xr, xi, xig, inv_dt, pl, rows, na, logM1,
                       logM2, start, L, Y, ychunk, (cudaStream_t)stream);
}

// P2. Pw: (rows, K); planes (rows, L); K and L multiples of 4. (nplanes,
// rb, read): dmaonly (4, 1, 1), dma1 (1, 1, 1), dmanoin (4, 1, 0), dmarb8
// (4, 8, 1); planes past nplanes are not written (may be null).
extern "C" int ssq_cwt_copy_floor(const float* Pw, long long K, int rows,
                                  long long L, int nplanes, int rb, int read,
                                  float* o0, float* o1, float* o2, float* o3,
                                  void* stream) {
  if (K % 4 || L % 4) return (int)cudaErrorInvalidValue;
  Planes pl = {{nullptr, nullptr, nullptr, nullptr}, {o0, o1, o2, o3}};
  cudaStream_t st = (cudaStream_t)stream;
  if (nplanes == 4 && rb == 1 && read)
    return copy_run<4, 1, true>(Pw, K, rows, L, pl, st);
  if (nplanes == 1 && rb == 1 && read)
    return copy_run<1, 1, true>(Pw, K, rows, L, pl, st);
  if (nplanes == 4 && rb == 1 && !read)
    return copy_run<4, 1, false>(Pw, K, rows, L, pl, st);
  if (nplanes == 4 && rb == 8 && read)
    return copy_run<4, 8, true>(Pw, K, rows, L, pl, st);
  return (int)cudaErrorInvalidValue;
}

// P3. The arguments of ssq_cwt_planes with the derivative (Y: scratch of
// 2*ychunk*M float2); M2 and D's k2-tile multiples of 4. Returns
// cudaGetLastError() after the launches.
extern "C" int ssq_cwt_staged(const float* Pw, const float* xr,
                              const float* xi, const float* xig, float inv_dt,
                              const float* nwr, const float* nwi,
                              const float* ndr, const float* ndi,
                              long long rows, int na, int logM1, int logM2,
                              int start, int L, void* Y, long long ychunk,
                              float* owr, float* owi, float* odr, float* odi,
                              void* stream) {
  if (ychunk < 1) return (int)cudaErrorInvalidValue;
  Planes pl = {{nwr, nwi, ndr, ndi}, {owr, owi, odr, odi}};
  cudaStream_t st = (cudaStream_t)stream;
  Plan plan;
  cudaError_t err = plan_launches(cwt_planes_stage1<2, fft4::kFull>,
                                  planes_stage2<2, fft4::kFull>, logM1, logM2,
                                  2, &plan);
  if (err != cudaSuccess) return (int)err;
  const int M1 = 1 << logM1, M2 = 1 << logM2;
  if (plan.tk2 % 4) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float) * slot_floats(M1 / 2, plan.tk2) +
                      fft4::smem_bytes(M1, plan.tk2, 2);
  err = cudaFuncSetAttribute(staged_stage1,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, staged_stage1, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  for (long long row0 = 0; row0 < rows; row0 += ychunk) {
    const long long nr = rows - row0 < ychunk ? rows - row0 : ychunk;
    const long long items = nr * (M2 / plan.tk2);
    const long long blocks =
        items < (long long)sms * per_sm ? items : (long long)sms * per_sm;
    staged_stage1<<<(unsigned)blocks, kThreads, smem, st>>>(
        Pw, xr, xi, xig, inv_dt, na, logM1, logM2, plan.tk2, (float2*)Y,
        row0, nr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    planes_stage2<2, fft4::kFull><<<dim3((unsigned)nr, M1 / plan.tn1),
                                    kThreads, plan.smem2, st>>>(
        (const float2*)Y, pl, logM1, logM2, plan.tn1, start, L, row0, nr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
