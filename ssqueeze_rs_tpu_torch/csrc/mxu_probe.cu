// Probe J6: the costs around a digit-split one-hot product (kernel I's
// design), one small kernel per question, for sm_90a.
//
// Replaces the TPU probes tools/mxu_probe.py (run_kernel's pallas_call at
// :56, the kernels of main :92-190) and tools/mxu_probe2.py (:44, main
// :79-175). On the TPU each question was a kernel whose GRID sequential
// steps each did the work again; those with a VMEM accumulator carried it
// over every step (left unset at the start there; zeroed here). Here the
// steps are a loop inside every block (and, for the accumulators, the
// NG groups a loop inside it): each block does its share of the output at
// every step. A runtime stride that is always 0 offsets each step's
// addresses, so the compiler cannot fold the steps into one.
//
// Dots (ssq_mxu_dots: q_dots, q_dots4, q_bigdot, q_batch): bf16 operands,
// float32 accumulation, mma.sync m16n8k16. A block (4 warps) owns a 32 x 64
// tile of the output and stages its rows of A and columns of B (padded to
// whole mma tiles, zero-filled) in shared memory: once, when they fit
// (K = 296: the operands stay on chip, as in VMEM), else 64 of K at a time
// at every step (q_bigdot, K = 18 944). With `accumulate` the sum runs on
// over the steps (q_dots: GRID * NG products of the same A @ B); without,
// each step recomputes the product (q_bigdot, q_batch: the last step's
// product is the output).
//
// Element questions (ssq_mxu_elem), one output element a thread (q_bbuild:
// one column pair of six), its accumulator in a register:
//   0 trans     out (T, NA) = float(K32.T), through a 32 x 33 tile
//   1 repeat    out (NA, 16T)[i, j] = (KLO[i, j/16] == j%16) ? V[i, j/16] : 0
//   2 bcast     out (NA, 16T)[i, 16G g + r G + c] = V[i, G g + c]
//   3 slice128  out (NA, 128) = sum over steps, g < NG of BALL[:, 128g:128g+128]
//   4 abuild    out (F1 G, NA)[r, c] = sum over steps, g of
//               (KHT[G g + r % G, c] == r / G)
//   5 strided   out (F1, 128) = sum over steps, g of sum_{r<G} D[r::G]
//               (summed from 0, r in order)
//   6 bbuild    out (NA, 768): the six 128-column pieces (hi, mid, lo of Br,
//               then of Bi; Br = sel ? v : 0, Bi = sel ? v / 2 : 0, sel =
//               KLR == lane / G) of bf16 splits, summed over steps and g
// Every element question is exact against its plain version: the same
// float32 operations in the same order (integer counts, copies, selects,
// bf16 roundings to nearest even).
//
// What bounds them: the tensor cores' bf16 rate for the dots; bytes or
// float32 operations for the element questions (the steps multiply the
// operations, not the bytes: inputs read once, outputs written once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using ssq::mma_bf16;

constexpr int kDotThreads = 128;  // 4 warps: 2 along m, 2 along n
constexpr int kTM = 32, kTN = 64;  // the block's tile; a warp's 16 x 32
constexpr int kKC = 64;            // k a chunk when the operands stream
constexpr int kMaxResident = 100 * 1024;
constexpr int kThreads = 256;

enum Question {
  kTrans = 0, kRepeat, kBcast, kSlice128, kABuild, kStrided, kBBuild
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kDotThreads)
dots_kernel(const __nv_bfloat16* __restrict__ A,
            const __nv_bfloat16* __restrict__ B, float* __restrict__ out,
            int M, int K, int N, int steps, int accumulate, int kc,
            long long zero) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LD = kc + 8;  // padded rows: conflict-free fragment loads
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kTM][LD]
  __nv_bfloat16* sB = sA + kTM * LD;  // [kTN][LD]: B transposed

  const long long bat = blockIdx.z;
  A += bat * M * K;
  B += bat * K * N;
  out += bat * M * N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int row0 = blockIdx.y * kTM, col0 = blockIdx.x * kTN;
  const int wr = (warp >> 1) * 16, wc = (warp & 1) * 32;
  const bool resident = kc >= K;

  auto stage = [&](const __nv_bfloat16* a, const __nv_bfloat16* b, int k0) {
    const __nv_bfloat16 z = __float2bfloat16_rn(0.f);
    for (int e = tid; e < kTM * kc; e += kDotThreads) {
      const int kk = e % kc, r = e / kc;
      const int gk = k0 + kk, gr = row0 + r;
      sA[r * LD + kk] = gk < K && gr < M ? a[(long long)gr * K + gk] : z;
    }
    for (int e = tid; e < kTN * kc; e += kDotThreads) {
      const int c = e % kTN, kk = e / kTN;
      const int gk = k0 + kk, gc = col0 + c;
      sB[c * LD + kk] = gk < K && gc < N ? b[(long long)gk * N + gc] : z;
    }
  };

  // run: the output (with `accumulate` the float32 sum over the steps, in
  // order: the TPU kernel's acc + dot); acc: the step's product, fresh
  // each step (the tensor cores' accumulation truncates, so a sum carried
  // through all the steps inside them would drift)
  float run[4][4], acc[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) run[t][e] = 0.f;
  if (resident) {
    stage(A, B, 0);
    __syncthreads();
  }
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kc) {
      if (!resident) {
        __syncthreads();
        stage(A + s * zero, B + s * zero, k0);
        __syncthreads();
      }
      for (int kb = 0; kb < kc && k0 + kb < K; kb += 16) {
        const __nv_bfloat16* p = sA + (wr + g) * LD + kb + 2 * q;
        const uint32_t a[4] = {ld32(p), ld32(p + 8 * LD), ld32(p + 8),
                               ld32(p + 8 * LD + 8)};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const __nv_bfloat16* pb = sB + (wc + t * 8 + g) * LD + kb + 2 * q;
          mma_bf16(acc[t], a, ld32(pb), ld32(pb + 8));
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        run[t][e] = accumulate ? __fadd_rn(run[t][e], acc[t][e]) : acc[t][e];
  }
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + wr + g + (e >= 2 ? 8 : 0);
      const int c = col0 + wc + t * 8 + 2 * q + (e & 1);
      if (r < M && c < N) out[(long long)r * N + c] = run[t][e];
    }
}

__global__ void trans_kernel(const int* __restrict__ in, float* __restrict__ out,
                             int rows, int cols, int steps, long long zero) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int s = 0; s < steps; ++s) {
    const int* src = in + s * zero;
    float* dst = out + s * zero;
    for (int j = ty; j < 32; j += 8) {
      const int r = r0 + j, c = c0 + tx;
      if (r < rows && c < cols) tile[j][tx] = (float)src[(long long)r * cols + c];
    }
    __syncthreads();
    for (int j = ty; j < 32; j += 8) {
      const int c = c0 + j, r = r0 + tx;
      if (c < cols && r < rows) dst[(long long)c * rows + r] = tile[tx][j];
    }
    __syncthreads();
  }
}

// d0 = NA, d1 = T
__global__ void repeat_kernel(const int* __restrict__ klo,
                              const float* __restrict__ v,
                              float* __restrict__ out, int na, int T, int steps,
                              long long zero) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)na * 16 * T) return;
  const long long i = idx / (16 * T);
  const int j = (int)(idx - i * 16 * T);
  const long long src = i * T + (j >> 4);
  for (int s = 0; s < steps; ++s)
    out[idx + s * zero] =
        klo[src + s * zero] == (j & 15) ? v[src + s * zero] : 0.f;
}

// d0 = NA, d1 = T, d2 = G
__global__ void bcast_kernel(const float* __restrict__ v, float* __restrict__ out,
                             int na, int T, int G, int steps, long long zero) {
  const int W = (T / G) * 16 * G;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)na * W) return;
  const long long i = idx / W;
  const int j = (int)(idx - i * W);
  const long long src = i * T + (j / (16 * G)) * G + j % G;
  for (int s = 0; s < steps; ++s) out[idx + s * zero] = v[src + s * zero];
}

// d0 = NA, d1 = W (BALL's row width), d2 = NG
__global__ void slice128_kernel(const float* __restrict__ ball,
                                float* __restrict__ out, int na, int W, int ng,
                                int steps, long long zero) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)na * 128) return;
  const long long i = idx >> 7;
  const int c = (int)(idx & 127);
  float acc = 0.f;
  for (int s = 0; s < steps; ++s) {
    const float* row = ball + s * zero + i * W + c;
    for (int g = 0; g < ng; ++g) acc = __fadd_rn(acc, row[g * 128]);
  }
  out[idx] = acc;
}

// d0 = NA, d1 = NG, d2 = G, d3 = F1
__global__ void abuild_kernel(const int* __restrict__ kht,
                              float* __restrict__ out, int na, int ng, int G,
                              int f1s, int steps, long long zero) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)f1s * G * na) return;
  const int r = (int)(idx / na), c = (int)(idx - (long long)r * na);
  const int f1 = r / G, rr = r % G;
  float acc = 0.f;
  for (int s = 0; s < steps; ++s) {
    const int* col = kht + s * zero + (long long)rr * na + c;
    for (int g = 0; g < ng; ++g)
      acc = __fadd_rn(acc, col[(long long)g * G * na] == f1 ? 1.f : 0.f);
  }
  out[idx] = acc;
}

// d0 = M (rows of D, F1 * G), d1 = L (its columns), d2 = G, d3 = NG
__global__ void strided_kernel(const float* __restrict__ d,
                               float* __restrict__ out, int M, int L, int G,
                               int ng, int steps, long long zero) {
  const int f1s = M / G;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)f1s * L) return;
  const int f = (int)(idx / L), c = (int)(idx - (long long)f * L);
  float acc = 0.f;
  for (int s = 0; s < steps; ++s) {
    for (int g = 0; g < ng; ++g) {
      const float* col = d + (s * ng + g) * zero + (long long)f * G * L + c;
      float sum = 0.f;
      for (int r = 0; r < G; ++r) sum = __fadd_rn(sum, col[(long long)r * L]);
      acc = __fadd_rn(acc, sum);
    }
  }
  out[idx] = acc;
}

// x = hi + mid + lo in bf16 (each rounded to nearest even), as
// tools/mxu_probe2.py's split3
__device__ __forceinline__ void split3(float x, float (&p)[3]) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  const float r1 = __fsub_rn(x, __bfloat162float(h));
  const __nv_bfloat16 m = __float2bfloat16_rn(r1);
  const __nv_bfloat16 l = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(m)));
  p[0] = __bfloat162float(h);
  p[1] = __bfloat162float(m);
  p[2] = __bfloat162float(l);
}

// d0 = NA, d1 = W (the operands' row width), d2 = NG, d3 = G
__global__ void bbuild_kernel(const int* __restrict__ klr,
                              const float* __restrict__ vrr,
                              float* __restrict__ out, int na, int W, int ng,
                              int G, int steps, long long zero) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)na * 128) return;
  const long long i = idx >> 7;
  const int c = (int)(idx & 127);
  const int f0 = c / G;
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < steps; ++s) {
    const long long o = s * zero + i * W + c;
    for (int g = 0; g < ng; ++g) {
      const bool sel = klr[o + g * 128] == f0;
      const float v = vrr[o + g * 128];
      float pr[3], pi[3];
      split3(sel ? v : 0.f, pr);
      split3(sel ? __fmul_rn(v, 0.5f) : 0.f, pi);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        acc[p] = __fadd_rn(acc[p], pr[p]);
        acc[3 + p] = __fadd_rn(acc[3 + p], pi[p]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < 6; ++p) out[i * 768 + p * 128 + c] = acc[p];
}

unsigned blocks(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// A (batch, M, K), B (batch, K, N) bf16, out (batch, M, N) float32,
// row-major. steps products, accumulated over the steps or each step's
// alone. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssq_mxu_dots(const void* A, const void* B, float* out,
                            int batch, int M, int K, int N, int steps,
                            int accumulate, void* stream) {
  if (batch < 1 || batch > 65535 || M < 1 || K < 1 || N < 1 || steps < 0)
    return (int)cudaErrorInvalidValue;
  const int kp = (K + 15) / 16 * 16;
  int kc = kp;
  if ((kTM + kTN) * (kp + 8) * 2 > kMaxResident) kc = kKC;
  const int smem = (kTM + kTN) * (kc + 8) * 2;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM, batch);
  dots_kernel<<<grid, kDotThreads, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(A),
      reinterpret_cast<const __nv_bfloat16*>(B), out, M, K, N, steps,
      accumulate, kc, 0LL);
  return (int)cudaGetLastError();
}

// One element question (see above for d0..d3 and the layouts); int32
// and float32 operands, row-major; zero must be 0 (each step's offset).
// Returns cudaGetLastError() after the launch.
extern "C" int ssq_mxu_elem(int question, const void* in0, const void* in1,
                            float* out, int d0, int d1, int d2, int d3,
                            int steps, long long zero, void* stream) {
  if (d0 < 1 || d1 < 1 || steps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* i0 = reinterpret_cast<const int*>(in0);
  const float* f0 = reinterpret_cast<const float*>(in0);
  switch (question) {
    case kTrans:
      trans_kernel<<<dim3((d1 + 31) / 32, (d0 + 31) / 32), dim3(32, 8), 0, s>>>(
          i0, out, d0, d1, steps, zero);
      break;
    case kRepeat:
      repeat_kernel<<<blocks((long long)d0 * 16 * d1), kThreads, 0, s>>>(
          i0, reinterpret_cast<const float*>(in1), out, d0, d1, steps, zero);
      break;
    case kBcast:
      if (d2 < 1 || d1 % d2) return (int)cudaErrorInvalidValue;
      bcast_kernel<<<blocks((long long)d0 * 16 * d1), kThreads, 0, s>>>(
          f0, out, d0, d1, d2, steps, zero);
      break;
    case kSlice128:
      if (d1 < d2 * 128) return (int)cudaErrorInvalidValue;
      slice128_kernel<<<blocks((long long)d0 * 128), kThreads, 0, s>>>(
          f0, out, d0, d1, d2, steps, zero);
      break;
    case kABuild:
      if (d2 < 1 || d3 < 1) return (int)cudaErrorInvalidValue;
      abuild_kernel<<<blocks((long long)d3 * d2 * d0), kThreads, 0, s>>>(
          i0, out, d0, d1, d2, d3, steps, zero);
      break;
    case kStrided:
      if (d2 < 1 || d0 % d2) return (int)cudaErrorInvalidValue;
      strided_kernel<<<blocks((long long)(d0 / d2) * d1), kThreads, 0, s>>>(
          f0, out, d0, d1, d2, d3, steps, zero);
      break;
    case kBBuild:
      if (d3 < 1 || d1 < d2 * 128) return (int)cudaErrorInvalidValue;
      bbuild_kernel<<<blocks((long long)d0 * 128), kThreads, 0, s>>>(
          i0, reinterpret_cast<const float*>(in1), out, d0, d1, d2, d3, steps,
          zero);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
