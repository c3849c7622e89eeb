// Kernel F: the hop-1 STFT, every frame's windowed DFT as a chirp-z
// (Bluestein) transform on the register-radix FFT core, for sm_90a.
//
// Replaces ssqueeze_rs_tpu/ops/stft_pallas.py::_make_kernel (with
// _frames_dft_into). For frame j of signal b and tap window v_w (W = 1 or 2
// windows), with N = n_fft and nf = N/2 + 1 bins,
//
//   X_w[k, j] = c_k sum_{t < N} v_w[t] xp[b, j + t] e^{-2 pi i k t / N}
//
// and out[b, w*2nf + k, j] = Re X_w[k, j], out[b, w*2nf + nf + k, j] =
// Im X_w[k, j]; with scale_w1 the rows of window 1 (the derivative planes)
// are multiplied by fs. c_k carries the caller's per-bin factors (the
// modulation phase, the irfft weights). That is the dense product with the
// stacked K_T of the plain version, which the three callers carry beside
// this structure (ops/stft_cuda.py DftSpec).
//
// Bluestein (bluestein.cuh, the frame routine G runs too): the DFT as a
// convolution with a chirp, circular over Q = 2^n >= N + nf - 1 points
// (Q = 1024 at N = 598). The tables A_w[t] = v_w[t] e^{-i pi t^2 / N},
// B = FFT(b) / Q of the chirp filter and D[k] = c_k e^{-i pi k^2 / N} are
// built on the host in float64 (chirp angles from t^2 mod 2N in integers,
// so they stay exact at any N) and cached per window; any N up to 2048
// takes the same kernel (Q <= 4096).
//
// Design: a block owns kFrames frames of one signal and stages their
// signal window (kFrames + N - 1 floats) in shared memory once, so no frame
// matrix exists anywhere. The core holds NCOL columns at a time, one frame
// each, so neighbouring threads hold neighbouring frames: the window reads
// are conflict-free and the plane stores are runs over frames. A round
// takes its frames through each window in turn. Each column's forward FFT
// ends in registers in the order the inverse one starts from, so the
// product with B costs no shared-memory exchange; the first pass skips
// the zero tail of a when N <= Q/2, and the last pass of the inverse skips
// the butterflies whose outputs are all >= nf.
//
// What bounds it: at the bench shape (N = 598, 160 000 frames) the
// function's work is W real DFTs of 598 points a frame, ~2.2e9 flops a
// window, against 0.38 GB of planes a window: memory-bound, ~0.12 ms at
// 3.35 TB/s with one window. Bluestein does ~7x that arithmetic (two
// complex transforms of 1024 points a real 598-point DFT, ~1.6e10 flops a
// window), its 4 exchanges a column move ~65 KB a frame through shared
// memory, and at ~165 registers a thread one block fits a SM: issue and
// latency, not memory, set its pace on this card.

#include <cuda_runtime.h>

#include "bluestein.cuh"

namespace {

constexpr int kFrames = 64;               // frames a block

template <int LOGQ>
__global__ void __launch_bounds__(fftr::kThreads)
stft_bluestein(const float* __restrict__ xp, const float2* __restrict__ A,
               const float2* __restrict__ B, const float2* __restrict__ D,
               long long mp, int n_fft, int nf, int W, long long n_out,
               float fs, int scale_w1, float* __restrict__ out) {
  using S = fftr::Shape<LOGQ>;
  extern __shared__ float2 sm[];
  float2* tw = sm;
  float2* const bufs[2] = {sm + S::kTwFloat2,
                          sm + S::kTwFloat2 + S::NCOL * S::LD};
  float* xw = reinterpret_cast<float*>(sm + S::kTwFloat2 + S::kBufFloat2);
  const long long b = blockIdx.y;
  const long long j0 = (long long)blockIdx.x * kFrames;
  const long long rows = 2LL * W * nf;
  const int nframes = n_out - j0 < kFrames ? (int)(n_out - j0) : kFrames;
  fftr::fill_twiddles<LOGQ>(tw);
  const int nw = kFrames + n_fft - 1;
  for (int q = threadIdx.x; q < nw; q += blockDim.x) {
    const long long p = j0 + q;
    xw[q] = p < mp ? xp[b * mp + p] : 0.f;
  }
  __syncthreads();

  int col[S::U], lane[S::U];
  fftr::units<LOGQ>(col, lane);
  // a round: NCOL frames, one a column, through each window in turn
  for (int f0 = 0; f0 < kFrames; f0 += S::NCOL) {
    for (int w = 0; w < W; ++w) {
      float2 v[S::U][S::E];
      bluestein::frame_dft<LOGQ>(v, col, lane, bufs, tw, xw, f0, nframes,
                                 A + w * n_fft, B, D, n_fft, nf,
                                 scale_w1 && w == 1, fs);
#pragma unroll
      for (int u = 0; u < S::U; ++u) {
        const int jl = f0 + col[u];
        if (jl >= nframes) continue;
        float* o = out + (b * rows + 2LL * w * nf) * n_out + j0 + jl;
#pragma unroll
        for (int q = 0; q < S::E; ++q) {
          const int k = lane[u] + q * S::TPC;
          if (k >= nf) continue;
          o[(long long)k * n_out] = v[u][q].x;
          o[(long long)(nf + k) * n_out] = v[u][q].y;
        }
      }
    }
  }
}

}  // namespace

// xp: (batch, mp) float32 padded signals; A: (W, n_fft) complex64 chirped
// windows; B: (2^logQ,) complex64, the chirp filter's FFT / Q; D: (nf,)
// complex64 bin factors; out: (batch, 2*W*nf, n_out). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ssq_stft_dft(const float* xp, const void* A, const void* B,
                            const void* D, int batch, long long mp,
                            int n_fft, int nf, int W, int logQ,
                            long long n_out, float fs, int scale_w1,
                            float* out, void* stream) {
  if (W < 1 || W > 2 || logQ < 2 || logQ > 12 ||
      (1LL << logQ) < n_fft + nf - 1 || n_out + n_fft - 1 > mp)
    return (int)cudaErrorInvalidValue;
  return (int)fftr::dispatch_log<2, 12>(logQ, [&](auto c) {
    constexpr int LOG = decltype(c)::value;
    auto k = stft_bluestein<LOG>;
    const size_t smem = fftr::core_smem<LOG>() +
                        (size_t)(kFrames + n_fft) * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((unsigned)((n_out + kFrames - 1) / kFrames),
                    (unsigned)batch);
    k<<<grid, fftr::kThreads, smem, (cudaStream_t)stream>>>(
        xp, (const float2*)A, (const float2*)B, (const float2*)D, mp, n_fft,
        nf, W, n_out, fs, scale_w1, out);
    return cudaGetLastError();
  });
}
