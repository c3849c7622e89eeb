// Kernel G: the whole hop-1 ssq_stft in one kernel, for sm_90a.
//
// Replaces ssqueeze_rs_tpu/ops/stft_pallas.py::_make_ssq_stft_kernel (its
// full loop; the banded branch is bitwise equal to it and is later work).
// A block owns T consecutive frames of one signal (the wrapper's plan) and
// stages their signal window in shared memory once. In rounds of NCOL
// frames, one a column of the register-radix core:
//   1. window 0 (Sx) and then window 1 (dS, times fs) through F's chirp-z
//      frame routine (bluestein.cuh, the same device code and host tables
//      as kernel F, so Sx is bitwise F's with two windows); Sx is stored
//      from registers in runs over frames, and its bins < nf stay in the
//      thread's registers until window 1's dS lands at the same (lane, q);
//      dS never leaves the chip;
//   2. w = |Sfs - Im(dS/Sx)/2pi| and its linear bin (bins.cuh, the code of
//      kernel B'), masked where |Sx|^2 <= gamma^2; the entry's bin (16
//      bits, -1 when masked) and value Sx * const[i] are staged in shared
//      memory, [i][frame] at a frame stride that keeps a round's stores
//      free of bank conflicts.
// After the last round the core's twiddles and buffers are free, and a
// (2, nf, T) accumulator takes their place. The ordered squeeze: thread
// (f, g) walks frame f's entries in increasing i and adds each whose bin
// lies in its group g's share of the bins (256 / T groups split them
// evenly), so each (bin, frame) sum is one thread's, taken in increasing
// i from zero, with no atomics: Tx is bitwise run-to-run and bitwise B'
// applied to F's planes (B' sums each column's rows in the same order).
// Tx is then stored in runs over frames.
//
// What bounds it: as F, issue and latency of the transforms (two complex
// FFTs of Q points a window a frame, Q = 1024 at n_fft = 598) at one block
// a SM, far above the bytes (the signal in, four planes of nf x frames
// out: ~0.77 GB at the bench shape, ~0.23 ms at 3.35 TB/s). The squeeze
// adds each entry's phase and bin (two IEEE divisions, as B'), the
// staging stores and the walk, which all 8 warps share (a single warp,
// one thread a frame, walking every entry alone was slower on the H100).
// T is the largest power of two up to 256 whose plan fits in 227 KB
// (ops/stft_cuda.py _ssq_plan, from n_fft alone): 32 at n_fft = 598, 4 at
// 2048.

#include <cuda_runtime.h>

#include "bins.cuh"
#include "bluestein.cuh"

namespace {

// Floats before the staged entries: the core, or the accumulator that
// takes its place after the last round, whichever is larger.
template <int LOGQ>
__host__ __device__ size_t front_floats(int nf, int T) {
  const size_t core = fftr::core_smem<LOGQ>() / sizeof(float);
  const size_t acc = 2 * (size_t)nf * T;
  return core > acc ? core : acc;
}

// Shared memory: core | acc, values (2, nf, SS) floats, the signal window
// (T + n_fft floats), bins (nf, SS) shorts.
template <int LOGQ>
size_t smem_bytes(int nf, int n_fft, int T, int SS) {
  return sizeof(float) * (front_floats<LOGQ>(nf, T) + 2 * (size_t)nf * SS +
                          T + n_fft) +
         sizeof(short) * (size_t)nf * SS;
}

template <int LOGQ>
__global__ void __launch_bounds__(fftr::kThreads)
ssq_stft_bluestein(const float* __restrict__ xp, const float2* __restrict__ A,
                   const float2* __restrict__ B, const float2* __restrict__ D,
                   long long mp, int n_fft, int nf, long long n_out, float fs,
                   const float* __restrict__ cst,
                   const float* __restrict__ sfs, float gamma2, ssq::Plan P,
                   int T, int SS, float* __restrict__ txr,
                   float* __restrict__ txi, float* __restrict__ sxr,
                   float* __restrict__ sxi) {
  using S = fftr::Shape<LOGQ>;
  constexpr int KQ = bluestein::bin_slots<LOGQ>();
  extern __shared__ float2 sm[];
  float2* tw = sm;
  float2* const bufs[2] = {sm + S::kTwFloat2,
                          sm + S::kTwFloat2 + S::NCOL * S::LD};
  float* acc = reinterpret_cast<float*>(sm);     // [2][nf][T], last
  float* evr = acc + front_floats<LOGQ>(nf, T);  // [nf][SS]
  float* evi = evr + (size_t)nf * SS;
  float* xw = evi + (size_t)nf * SS;             // T + n_fft - 1
  short* ebin = reinterpret_cast<short*>(xw + T + n_fft);
  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const long long j0 = (long long)blockIdx.x * T;
  const int nframes = n_out - j0 < T ? (int)(n_out - j0) : T;
  fftr::fill_twiddles<LOGQ>(tw);
  const int nw = T + n_fft - 1;
  for (int q = tid; q < nw; q += blockDim.x) {
    const long long p = j0 + q;
    xw[q] = p < mp ? xp[b * mp + p] : 0.f;
  }
  __syncthreads();

  int col[S::U], lane[S::U];
  fftr::units<LOGQ>(col, lane);
  for (int f0 = 0; f0 < T; f0 += S::NCOL) {
    float2 sx[S::U][KQ];                   // window 0's bins < nf
#pragma unroll 1
    for (int w = 0; w < 2; ++w) {
      float2 v[S::U][S::E];
      bluestein::frame_dft<LOGQ>(v, col, lane, bufs, tw, xw, f0, nframes,
                                 A + w * n_fft, B, D, n_fft, nf, w == 1, fs);
#pragma unroll
      for (int u = 0; u < S::U; ++u) {
        const int jl = f0 + col[u];
        if (jl >= nframes) continue;
        const long long o = b * nf * n_out + j0 + jl;
#pragma unroll
        for (int q = 0; q < KQ; ++q) {
          const int i = lane[u] + q * S::TPC;
          if (i >= nf) continue;
          if (w == 0) {
            sx[u][q] = v[u][q];
            sxr[o + (long long)i * n_out] = v[u][q].x;
            sxi[o + (long long)i * n_out] = v[u][q].y;
          } else {
            const float C = sx[u][q].x, Dv = sx[u][q].y;
            const float wv = ssq::phase_w(C, Dv, v[u][q].x, v[u][q].y,
                                          sfs[i], gamma2, ssq::kStft);
            const int k = ssq::bin_of(wv, P);
            float vr = 0.f, vi = 0.f;
            if (k >= 0) {
              vr = __fmul_rn(C, cst[i]);
              vi = __fmul_rn(Dv, cst[i]);
            }
            const int e = i * SS + jl;
            evr[e] = vr;
            evi[e] = vi;
            ebin[e] = (short)k;
          }
        }
      }
    }
  }
  __syncthreads();                          // the core is free

  for (int e = tid; e < 2 * nf * T; e += blockDim.x) acc[e] = 0.f;
  __syncthreads();
  // the ordered squeeze: thread (f, g) walks frame f's entries in
  // increasing i and adds those whose bin falls in its group's range, so
  // each (bin, frame) sum is one thread's, taken in increasing i from zero
  // (T divides the block: G = kThreads / T groups split the bins evenly)
  const int f = tid & (T - 1);
  const int groups = blockDim.x / T;
  const int g = tid / T;
  const int klo = g * nf / groups, khi = (g + 1) * nf / groups;
  if (f < nframes) {
    float* ar = acc + f;
    float* ai = acc + (size_t)nf * T + f;
    constexpr int kAhead = 4;             // bins read before their adds
    int i = 0;
    for (; i + kAhead <= nf; i += kAhead) {
      int k[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) k[u] = ebin[(i + u) * SS + f];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (k[u] >= klo && k[u] < khi) {
          const int e = (i + u) * SS + f;
          ar[k[u] * T] += evr[e];
          ai[k[u] * T] += evi[e];
        }
      }
    }
    for (; i < nf; ++i) {
      const int e = i * SS + f;
      const int k = ebin[e];
      if (k >= klo && k < khi) {
        ar[k * T] += evr[e];
        ai[k * T] += evi[e];
      }
    }
  }
  __syncthreads();
  if (f < nframes) {
    for (int k = g; k < nf; k += groups) {
      const long long o = (b * nf + k) * n_out + j0 + f;
      txr[o] = acc[k * T + f];
      txi[o] = acc[(size_t)(nf + k) * T + f];
    }
  }
}

}  // namespace

// xp: (batch, mp) float32 padded signals; A: (2, n_fft) complex64 chirped
// windows (the window, the derivative window); B: (2^logQ,) complex64;
// D: (nf,) complex64 (kernel F's tables); cst, sfs: (nf,); outputs
// (batch, nf, n_out). Linear binning plan (mode, flipud, p0..p4) as in
// reassign.cu. cols (T, a power of two <= 256) frames a block and stride
// (SS >= T) the frame stride of the staged entries, the wrapper's plan.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssq_stft_fused(const float* xp, const void* A, const void* B,
                              const void* D, int batch, long long mp,
                              int n_fft, int nf, int logQ, long long n_out,
                              float fs, const float* cst, const float* sfs,
                              float gamma2, int mode, int flipud, float p0,
                              float p1, float p2, float p3, float p4,
                              int cols, int stride, float* txr, float* txi,
                              float* sxr, float* sxi, void* stream) {
  if (logQ < 2 || logQ > 12 || (1LL << logQ) < n_fft + nf - 1 ||
      n_out + n_fft - 1 > mp || cols < 1 || cols > fftr::kThreads ||
      stride < cols || nf > 32767 || fftr::kThreads % cols)
    return (int)cudaErrorInvalidValue;
  const ssq::Plan P{mode, flipud, nf, p0, p1, p2, p3, p4};
  return (int)fftr::dispatch_log<2, 12>(logQ, [&](auto c) {
    constexpr int LOG = decltype(c)::value;
    using S = fftr::Shape<LOG>;
    if (nf > bluestein::bin_slots<LOG>() * S::TPC)
      return cudaErrorInvalidValue;
    auto k = ssq_stft_bluestein<LOG>;
    const size_t smem = smem_bytes<LOG>(nf, n_fft, cols, stride);
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((unsigned)((n_out + cols - 1) / cols), (unsigned)batch);
    k<<<grid, fftr::kThreads, smem, (cudaStream_t)stream>>>(
        xp, (const float2*)A, (const float2*)B, (const float2*)D, mp, n_fft,
        nf, n_out, fs, cst, sfs, gamma2, P, cols, stride, txr, txi, sxr,
        sxi);
    return cudaGetLastError();
  });
}
