// Probe J5: the in-kernel tensor-core rate by shape and precision, with
// independent chains, and the shared-memory rate, for sm_90a.
//
// Replaces the TPU probes of tools/mxu_rate_probe.py: dot_probe (its
// pallas_call at :47), copy_probe (:70) and dot_probe_chains (:153).
// Functions, with A_s the s-th (m, k) slice of A's rows:
//
//   dot     out = sum_{i<R} A_{i % 2} @ B                     (m, n) float32
//   chains  out_c = sum_{i<R} A_{(i + c) % (C + 1)} @ B, c < C   (C, m, n)
//   copy    out = sum_{i<R} A_{i % 2}                          (m, n) float32
//
// The TPU ran GRID steps in order on one core, each recomputing the same
// output from operands resident in VMEM. Here the GRID steps are copies
// of the grid along blockIdx.y, each writing the same values (every copy
// sums in the same order, so the result is deterministic), and the whole
// card is busy: the rate is GRID * R * 2mkn over the time.
//
// Dots: a block (8 warps, 2 along m by 4 along n) owns an output tile. For
// each of the R products it stages k-chunks of 32 of A's slice and of B
// (transposed) in shared memory and runs mma.sync over them into fresh
// float32 accumulators in registers, then adds the product to the running
// sum, kept in shared memory, in float32 (__fadd_rn): the TPU kernel's
// acc + dot. Precisions, from float32 operands:
//   bf16    m16n8k16, operands rounded by __float2bfloat16_rn (as JAX's
//           astype(bfloat16))
//   tf32    m16n8k8 on operands rounded by cvt.rna.tf32.f32
//   3xtf32  hi = tf32(v), lo = tf32(v - hi); hi*lo + lo*hi (into their own
//           accumulators) + hi*hi, the card's own accurate float32
//           product on the tensor cores
// With C chains each warp keeps C accumulator sets and its tile shrinks
// with C (64 accumulators a thread, 96 at C = 24), so 24 chains fit the
// registers; chains run in bf16, as on the TPU.
//
// Copy: a block stages its 4096-float tile of both slices in shared memory
// once, then makes R passes of acc = acc + slice through shared memory
// (a barrier between passes): the shared-memory rate is GRID * R * 3 *
// m * n * 4 bytes over the time.
//
// What bounds them: the tensor cores' rate of the precision for the dots
// (989 TFLOP/s bf16, 495 TF32, 3xTF32 a third of that), the bytes of A,
// B and out for the copy. This first version stages with plain loads and
// one buffer, and feeds the tensor cores through mma.sync, not wgmma: it
// measures what such a kernel gets, not the card's peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

using ssq::mma_bf16;
using ssq::mma_tf32;
using ssq::tf32;

enum Precision { kBF16 = 0, kTF32 = 1, k3xTF32 = 2 };

constexpr int kThreads = 256;  // 8 warps: 2 along m, 4 along n
constexpr int kBK = 32;        // k a shared-memory chunk
constexpr int kCopyTile = 4096;

// mma tiles (16 rows x 8 columns) a warp keeps per chain: a thread holds
// 4 floats a tile in each of its accumulator sets (the current product
// and, for 3xtf32, its small terms): 64 floats (96 at C = 24)
template <int P, int C> struct WarpTile { static constexpr int M = 1, N = 1; };
template <> struct WarpTile<kBF16, 1> { static constexpr int M = 4, N = 4; };
template <> struct WarpTile<kTF32, 1> { static constexpr int M = 4, N = 4; };
template <> struct WarpTile<k3xTF32, 1> { static constexpr int M = 2, N = 4; };
template <> struct WarpTile<kBF16, 2> { static constexpr int M = 2, N = 4; };
template <> struct WarpTile<kBF16, 4> { static constexpr int M = 2, N = 2; };
template <> struct WarpTile<kBF16, 8> { static constexpr int M = 1, N = 2; };

template <int P, int C>
struct DotCfg {
  using T = typename std::conditional<P == kBF16, __nv_bfloat16, float>::type;
  static constexpr int WM = WarpTile<P, C>::M, WN = WarpTile<P, C>::N;
  static constexpr int BM = 2 * 16 * WM, BN = 4 * 8 * WN;
  // padded rows: the fragment loads of a warp hit 32 distinct banks
  static constexpr int LD = kBK + (P == kBF16 ? 8 : 4);
  // the running sums' rows, padded: a half-warp's float2 accesses hit 32
  // distinct banks
  static constexpr int LDS = BN + 8;
  static constexpr int STAGE = (C * BM + BN) * LD * (int)sizeof(T);
  static constexpr int SMEM = STAGE + C * BM * LDS * (int)sizeof(float);
  static constexpr int BLOCKS = C == 24 ? 1 : 2;  // a SM, by registers
};

template <typename T> __device__ __forceinline__ T to_smem(float v);
template <> __device__ __forceinline__ __nv_bfloat16 to_smem(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ float to_smem(float v) { return v; }

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int P, int C>
__global__ void __launch_bounds__(kThreads, DotCfg<P, C>::BLOCKS)
rate_dot_kernel(const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ out, int m, int k, int n, int R) {
  using Cfg = DotCfg<P, C>;
  using T = typename Cfg::T;
  constexpr int WM = Cfg::WM, WN = Cfg::WN, BM = Cfg::BM, BN = Cfg::BN;
  constexpr int LD = Cfg::LD, LDS = Cfg::LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sA = reinterpret_cast<T*>(smem_raw);  // [C][BM][LD]
  T* sB = sA + C * BM * LD;                // [BN][LD]: B transposed
  float* run = reinterpret_cast<float*>(smem_raw + Cfg::STAGE);  // [C][BM][LDS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wr = (warp >> 2) * 16 * WM;  // the warp's rows and columns
  const int wc = (warp & 3) * 8 * WN;    // within the block's tile
  const int tiles_n = (n + BN - 1) / BN;
  const int row0 = (blockIdx.x / tiles_n) * BM;
  const int col0 = (blockIdx.x % tiles_n) * BN;

  // run (shared memory, each thread its own entries): the sum over i in
  // float32, in order, as the TPU kernel's acc + dot; acc: the i-th
  // product, fresh each time (its small terms apart in sml for 3xtf32):
  // the tensor cores' float32 accumulation truncates, so a sum carried
  // through all R products inside them would drift
  float acc[C][WM][WN][4];
  float sml[P == k3xTF32 ? C : 1][P == k3xTF32 ? WM : 1][WN][4];
  auto at = [&](int c, int tm, int tn, int e) {
    return (c * BM + wr + tm * 16 + g + (e >= 2 ? 8 : 0)) * LDS + wc +
           tn * 8 + 2 * q + (e & 1);
  };
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int tm = 0; tm < WM; ++tm)
#pragma unroll
      for (int tn = 0; tn < WN; ++tn)
#pragma unroll
        for (int e = 0; e < 4; ++e) run[at(c, tm, tn, e)] = 0.f;

  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int tm = 0; tm < WM; ++tm)
#pragma unroll
        for (int tn = 0; tn < WN; ++tn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[c][tm][tn][e] = 0.f;
            if constexpr (P == k3xTF32) sml[c][tm][tn][e] = 0.f;
          }
    for (int k0 = 0; k0 < k; k0 += kBK) {
      __syncthreads();  // the previous chunk's readers are done
      for (int e = tid; e < BN * kBK; e += kThreads) {
        const int c = e % BN, kk = e / BN;
        const int gk = k0 + kk, gc = col0 + c;
        sB[c * LD + kk] =
            to_smem<T>(gk < k && gc < n ? B[(long long)gk * n + gc] : 0.f);
      }
#pragma unroll 1
      for (int ch = 0; ch < C; ++ch) {
        const long long slice = (long long)((i + ch) % (C + 1)) * m;
        for (int e = tid; e < BM * kBK; e += kThreads) {
          const int kk = e % kBK, r = e / kBK;
          const int gk = k0 + kk, gr = row0 + r;
          sA[(ch * BM + r) * LD + kk] = to_smem<T>(
              gk < k && gr < m ? A[(slice + gr) * k + gk] : 0.f);
        }
      }
      __syncthreads();

      if constexpr (P == kBF16) {
#pragma unroll
        for (int kb = 0; kb < kBK; kb += 16) {
          uint32_t b[WN][2];
#pragma unroll
          for (int tn = 0; tn < WN; ++tn) {
            const T* p = sB + (wc + tn * 8 + g) * LD + kb + 2 * q;
            b[tn][0] = ld32(p);
            b[tn][1] = ld32(p + 8);
          }
#pragma unroll
          for (int ch = 0; ch < C; ++ch)
#pragma unroll
            for (int tm = 0; tm < WM; ++tm) {
              const T* p = sA + (ch * BM + wr + tm * 16 + g) * LD + kb + 2 * q;
              const uint32_t a[4] = {ld32(p), ld32(p + 8 * LD), ld32(p + 8),
                                     ld32(p + 8 * LD + 8)};
#pragma unroll
              for (int tn = 0; tn < WN; ++tn)
                mma_bf16(acc[ch][tm][tn], a, b[tn][0], b[tn][1]);
            }
        }
      } else {
#pragma unroll
        for (int kb = 0; kb < kBK; kb += 8) {
          uint32_t bh[WN][2], bl[WN][2];
#pragma unroll
          for (int tn = 0; tn < WN; ++tn) {
            const float* p = sB + (wc + tn * 8 + g) * LD + kb + q;
            const float v[2] = {p[0], p[4]};
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              bh[tn][j] = tf32(v[j]);
              bl[tn][j] = tf32(v[j] - __uint_as_float(bh[tn][j]));
            }
          }
#pragma unroll
          for (int ch = 0; ch < C; ++ch)
#pragma unroll
            for (int tm = 0; tm < WM; ++tm) {
              const float* p = sA + (ch * BM + wr + tm * 16 + g) * LD + kb + q;
              const float v[4] = {p[0], p[8 * LD], p[4], p[8 * LD + 4]};
              uint32_t ah[4], al[4];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                ah[j] = tf32(v[j]);
                al[j] = tf32(v[j] - __uint_as_float(ah[j]));
              }
#pragma unroll
              for (int tn = 0; tn < WN; ++tn) {
                if constexpr (P == k3xTF32) {
                  mma_tf32(sml[ch][tm][tn], ah, bl[tn][0], bl[tn][1]);
                  mma_tf32(sml[ch][tm][tn], al, bh[tn][0], bh[tn][1]);
                }
                mma_tf32(acc[ch][tm][tn], ah, bh[tn][0], bh[tn][1]);
              }
            }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int tm = 0; tm < WM; ++tm)
#pragma unroll
        for (int tn = 0; tn < WN; ++tn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float d = acc[c][tm][tn][e];
            if constexpr (P == k3xTF32) d = __fadd_rn(d, sml[c][tm][tn][e]);
            const int o = at(c, tm, tn, e);
            run[o] = __fadd_rn(run[o], d);
          }
  }

  __syncthreads();  // the tile leaves row by row
  for (int e = tid; e < C * BM * BN; e += kThreads) {
    const int c = e / (BM * BN), rc = e - c * BM * BN;
    const int r = rc / BN, cc = rc - r * BN;
    if (row0 + r < m && col0 + cc < n)
      out[(long long)c * m * n + (long long)(row0 + r) * n + col0 + cc] =
          run[(c * BM + r) * LDS + cc];
  }
}

__global__ void __launch_bounds__(kThreads)
rate_copy_kernel(const float* __restrict__ A, float* __restrict__ out,
                 long long mn, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* s0 = reinterpret_cast<float4*>(smem_raw);  // A's two slices
  float4* s1 = s0 + kCopyTile / 4;                     // and the sum,
  float4* acc = s1 + kCopyTile / 4;                    // the block's tile
  const long long base = (long long)blockIdx.x * kCopyTile;
  const int n4 = (int)(min((long long)kCopyTile, mn - base) / 4);
  const float4* a0 = reinterpret_cast<const float4*>(A + base);
  const float4* a1 = reinterpret_cast<const float4*>(A + mn + base);
  for (int e = threadIdx.x; e < n4; e += kThreads) {
    s0[e] = a0[e];
    s1[e] = a1[e];
    acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  for (int i = 0; i < R; ++i) {
    const float4* s = (i & 1) ? s1 : s0;
    for (int e = threadIdx.x; e < n4; e += kThreads) {
      float4 v = acc[e];
      const float4 w = s[e];
      v.x = __fadd_rn(v.x, w.x);
      v.y = __fadd_rn(v.y, w.y);
      v.z = __fadd_rn(v.z, w.z);
      v.w = __fadd_rn(v.w, w.w);
      acc[e] = v;
    }
    __syncthreads();  // the pass is in shared memory before the next reads
  }
  float4* o = reinterpret_cast<float4*>(out + base);
  for (int e = threadIdx.x; e < n4; e += kThreads) o[e] = acc[e];
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int P, int C>
int launch_dot(const float* A, const float* B, float* out, int m, int k,
               int n, int R, int grid, cudaStream_t s) {
  using Cfg = DotCfg<P, C>;
  if (int err = allow_smem(rate_dot_kernel<P, C>, Cfg::SMEM)) return err;
  const int tiles = ((m + Cfg::BM - 1) / Cfg::BM) * ((n + Cfg::BN - 1) / Cfg::BN);
  rate_dot_kernel<P, C><<<dim3(tiles, grid), kThreads, Cfg::SMEM, s>>>(
      A, B, out, m, k, n, R);
  return (int)cudaGetLastError();
}

}  // namespace

// A (2m, k) for chains == 1, else ((chains + 1) m, k); B (k, n); out
// (chains, m, n); float32, row-major. precision 0 bf16, 1 tf32, 2 3xtf32
// (chains > 1: bf16 only); chains 1, 2, 4, 8, 16 or 24; grid: the
// copies along blockIdx.y (1..65535). Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int ssq_rate_dot(const float* A, const float* B, float* out, int m,
                            int k, int n, int R, int grid, int precision,
                            int chains, void* stream) {
  if (m < 1 || k < 1 || n < 1 || R < 0 || grid < 1 || grid > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (chains == 1) {
    switch (precision) {
      case kBF16: return launch_dot<kBF16, 1>(A, B, out, m, k, n, R, grid, s);
      case kTF32: return launch_dot<kTF32, 1>(A, B, out, m, k, n, R, grid, s);
      case k3xTF32:
        return launch_dot<k3xTF32, 1>(A, B, out, m, k, n, R, grid, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (precision != kBF16) return (int)cudaErrorInvalidValue;
  switch (chains) {
    case 2: return launch_dot<kBF16, 2>(A, B, out, m, k, n, R, grid, s);
    case 4: return launch_dot<kBF16, 4>(A, B, out, m, k, n, R, grid, s);
    case 8: return launch_dot<kBF16, 8>(A, B, out, m, k, n, R, grid, s);
    case 16: return launch_dot<kBF16, 16>(A, B, out, m, k, n, R, grid, s);
    case 24: return launch_dot<kBF16, 24>(A, B, out, m, k, n, R, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// A (2m, n), out (m, n), float32, row-major, m * n a multiple of 4 (16-byte
// aligned tiles). Returns cudaGetLastError() after the launch.
extern "C" int ssq_rate_copy(const float* A, float* out, int m, int n, int R,
                             int grid, void* stream) {
  const long long mn = (long long)m * n;
  if (m < 1 || n < 1 || (mn & 3) || R < 0 || grid < 1 || grid > 65535)
    return (int)cudaErrorInvalidValue;
  const int smem = 3 * kCopyTile * (int)sizeof(float);
  if (int err = allow_smem(rate_copy_kernel, smem)) return err;
  const int tiles = (int)((mn + kCopyTile - 1) / kCopyTile);
  rate_copy_kernel<<<dim3(tiles, grid), kThreads, smem,
                     (cudaStream_t)stream>>>(A, out, mn, R);
  return (int)cudaGetLastError();
}
