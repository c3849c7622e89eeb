// Probe J7: does an asynchronous copy from device memory overlap a serial
// tensor-core chain on the same SMs? For sm_90a.
//
// Replaces the TPU probe tools/dma_overlap_probe.py::_make_kernel (its
// pallas_call at :88). Function, with x (M, M) float32:
//
//   x = f32(bf16(a))
//   R times:  [dots]   D times  x = (bf16(x) @ bf16(b)) * 1e-3   (f32 sum)
//             [copies] the chunk src[r*CH : (r+1)*CH] (CH x M float32) is
//                      copied on chip, issued before the dots and waited
//                      on after them; then x = x + src[r*CH, 0] * 1e-30
//   out = x[:8]
//
// variant: 1 copies, 2 dots, 3 both. On the TPU the chunk (8 MB at the
// probe's shape) went into VMEM; no block here holds it, so the rows of x
// are split over blocks of 16 (a row of x @ b needs only that row of x)
// and each block streams its share of every chunk through a ring of four
// 32 KB shared-memory slots. One copy warp issues the pieces with
// cp.async.bulk (the TMA's 1-D copy), each completing on its slot's
// mbarrier; it waits on a slot only to reuse it and, at the iteration's
// end, on the last pieces. Eight dot warps meanwhile run the chain:
// x's 16 rows stay in shared memory (float32), each warp computes M / 8
// columns of x @ b with mma.sync m16n8k16, reading bf16(b) transposed
// (the caller's operand, made once) through L2. After the
// iteration's barrier every thread reads src[r*CH, 0] from device memory,
// so the function is the TPU kernel's. Products and sums keep their
// float32 roundings (__fmul_rn / __fadd_rn, no contraction): the copy
// term lives near 1e-30.
//
// What bounds it: the copies' bytes (R * CH * M * 4: 512 MB at the probe's
// shape, 0.153 ms at 3.35 TB/s) against the dots' operations at the bf16
// rate (R * D * 2 M^3, 0.052 ms); the question is whether `both` takes
// the larger or the sum of `copies` and `dots`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using ssq::mma_bf16;
using ssq::pack_bf16;

constexpr int kRows = 16;  // rows of x a block
constexpr int kDotWarps = 8;
constexpr int kDotThreads = kDotWarps * 32;
constexpr int kThreads = kDotThreads + 32;  // and the copy warp
constexpr int kSlots = 4;
constexpr int kPiece = 32 * 1024;  // bytes a slot
constexpr int kMaxM = 512;
enum { kCopies = 1, kDots = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from device
// memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <int V>
__global__ void __launch_bounds__(kThreads, 1)
dma_overlap_kernel(const float* __restrict__ src, const float* __restrict__ a,
                   const __nv_bfloat16* __restrict__ bT,
                   float* __restrict__ out, int M, int R, int D,
                   long long chunk_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;                                  // the slots
  float* x = reinterpret_cast<float*>(smem + kSlots * kPiece);  // [16][M+8]
  const int LDX = M + 8;
  uint64_t* bars = reinterpret_cast<uint64_t*>(x + kRows * LDX);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kRows;
  for (int e = tid; e < kRows * M; e += kThreads) {
    const int r = e / M, c = e - r * M;
    x[r * LDX + c] =
        __bfloat162float(__float2bfloat16_rn(a[(long long)(row0 + r) * M + c]));
  }
  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // this block's share of each chunk, in bytes: 16-byte multiples, the
  // last block takes the rest
  const long long share = (chunk_bytes / gridDim.x) & ~15LL;
  const long long lo = (long long)blockIdx.x * share;
  const long long hi = blockIdx.x + 1 == gridDim.x ? chunk_bytes : lo + share;
  const unsigned char* srcb = reinterpret_cast<const unsigned char*>(src);
  long long issued = 0, waited = 0;  // pieces over all iterations

  const int g = lane >> 2, q = lane & 3;
  const int ncol = M / kDotWarps;  // columns a dot warp computes
  const int nt = ncol / 8;         // its 8-column mma tiles (<= 8)
  const int cw = warp * ncol;

  for (int r = 0; r < R; ++r) {
    if ((V & kCopies) && warp == kDotWarps && lane == 0) {
      const unsigned char* base = srcb + (long long)r * chunk_bytes;
      for (long long off = lo; off < hi; off += kPiece) {
        for (; waited + kSlots <= issued; ++waited)  // the slot is free
          mbar_wait(&bars[waited % kSlots], (uint32_t)((waited / kSlots) & 1));
        const int slot = (int)(issued % kSlots);
        const uint32_t bytes = (uint32_t)min((long long)kPiece, hi - off);
        mbar_expect_tx(&bars[slot], bytes);
        bulk_copy(ring + slot * kPiece, base + off, bytes, &bars[slot]);
        ++issued;
      }
      for (; waited < issued; ++waited)  // the iteration's copies landed
        mbar_wait(&bars[waited % kSlots], (uint32_t)((waited / kSlots) & 1));
    }
    if ((V & kDots) && warp < kDotWarps) {
      for (int d = 0; d < D; ++d) {
        float acc[8][4];
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
        for (int kb = 0; kb < M; kb += 16) {
          const float* xa = x + g * LDX + kb + 2 * q;
          const uint32_t af[4] = {
              pack_bf16(xa[0], xa[1]), pack_bf16(xa[8 * LDX], xa[8 * LDX + 1]),
              pack_bf16(xa[8], xa[9]),
              pack_bf16(xa[8 * LDX + 8], xa[8 * LDX + 9])};
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            if (t < nt) {
              const __nv_bfloat16* pb =
                  bT + (long long)(cw + t * 8 + g) * M + kb + 2 * q;
              const uint32_t b0 = __ldg(reinterpret_cast<const unsigned*>(pb));
              const uint32_t b1 =
                  __ldg(reinterpret_cast<const unsigned*>(pb + 8));
              mma_bf16(acc[t], af, b0, b1);
            }
          }
        }
        asm volatile("bar.sync 1, %0;" ::"n"(kDotThreads) : "memory");
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          if (t < nt) {
            float* xo = x + g * LDX + cw + t * 8 + 2 * q;
            xo[0] = __fmul_rn(acc[t][0], 1e-3f);
            xo[1] = __fmul_rn(acc[t][1], 1e-3f);
            xo[8 * LDX] = __fmul_rn(acc[t][2], 1e-3f);
            xo[8 * LDX + 1] = __fmul_rn(acc[t][3], 1e-3f);
          }
        }
        asm volatile("bar.sync 1, %0;" ::"n"(kDotThreads) : "memory");
      }
    }
    __syncthreads();  // the dots are done and the copies have landed
    if (V & kCopies) {
      const float s = __fmul_rn(src[(long long)r * (chunk_bytes / 4)], 1e-30f);
      for (int e = tid; e < kRows * M; e += kThreads) {
        const int rr = e / M, c = e - rr * M;
        x[rr * LDX + c] = __fadd_rn(x[rr * LDX + c], s);
      }
      __syncthreads();
    }
  }
  if (blockIdx.x == 0)
    for (int e = tid; e < 8 * M; e += kThreads)
      out[e] = x[(e / M) * LDX + e % M];
}

template <int V>
int launch(const float* src, const float* a, const __nv_bfloat16* bT,
           float* out, int M, int R, int D, long long chunk_bytes,
           cudaStream_t s) {
  const int smem = kSlots * kPiece + kRows * (M + 8) * (int)sizeof(float) +
                   kSlots * (int)sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      dma_overlap_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dma_overlap_kernel<V><<<M / kRows, kThreads, smem, s>>>(src, a, bT, out, M, R,
                                                          D, chunk_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

// src (>= R * CH, M), a (M, M) float32, bT (M, M) bf16 with bT[n][k] =
// bf16(b[k][n]), row-major, 16-byte aligned; out (8, M). M a multiple of
// 64 up to 512; variant 1 copies, 2 dots, 3 both. Launches the probe and
// returns cudaGetLastError() after the launch.
extern "C" int ssq_dma_overlap(const float* src, const float* a,
                               const void* bT, float* out, int M, int R,
                               int D, long long CH, int variant,
                               void* stream) {
  if (M < 64 || M > kMaxM || M % 64 || R < 0 || D < 0 || CH < 1 ||
      variant < 1 || variant > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* bt = reinterpret_cast<const __nv_bfloat16*>(bT);
  const long long chunk = CH * M * (long long)sizeof(float);
  switch (variant) {
    case kCopies: return launch<kCopies>(src, a, bt, out, M, R, D, chunk, s);
    case kDots: return launch<kDots>(src, a, bt, out, M, R, D, chunk, s);
    default:
      return launch<kCopies | kDots>(src, a, bt, out, M, R, D, chunk, s);
  }
}
