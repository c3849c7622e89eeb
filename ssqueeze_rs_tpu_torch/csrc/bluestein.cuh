// The chirp-z (Bluestein) frame transform of kernels F (stft_dft.cu) and G
// (ssq_stft.cu): one window's DFT of a round of frames on the
// register-radix FFT core, from the host tables of
// ops/stft_cuda.py::bluestein_tables. Both kernels run this one device
// code, so G's Sx planes are F's bit for bit.
//
// For frame j and tap window v_w, with N = n_fft and nf = N/2 + 1 bins,
// X_w[k] = c_k sum_{t < N} v_w[t] x[j + t] e^{-2 pi i k t / N}. With
// kt = (k^2 + t^2 - (k-t)^2) / 2 that is a convolution with the chirp
// e^{i pi m^2 / N}: X_w[k] = D[k] (a * b)[k], a[t] = A_w[t] x[j + t],
// A_w[t] = v_w[t] e^{-i pi t^2 / N}, D[k] = c_k e^{-i pi k^2 / N}, run
// circularly over Q = 2^LOGQ >= N + nf - 1 points: a forward FFT of a, the
// product with B = FFT(b) / Q, an inverse FFT pruned to the bins < nf.
#pragma once

#include <cuda_runtime.h>

#include "fft_radix.cuh"

namespace bluestein {

// Registers a slot keeps for the bins < nf: lanes hold bins lane + q TPC,
// and Q >= N + nf - 1 >= 3 nf - 3 puts every bin below Q/3 + 1.
template <int LOGQ>
__host__ __device__ constexpr int bin_slots() {
  using S = fftr::Shape<LOGQ>;
  constexpr int need = (S::P / 3 + 1 + S::TPC - 1) / S::TPC;
  return need < S::E ? need : S::E;
}

// One window of a round: the core's NCOL columns are frames f0 + col of the
// block's staged signal window xw (frame f starts at xw[f]); frames at or
// past `nframes` load zeros. On return v[u][q] holds X_w[k] of the slot's
// frame at bin k = lane[u] + q TPC for every k < nf (times fs, rounded on
// its own, when `scale`); the other registers are undefined. A: the
// window's n_fft chirped taps; B: (Q,); D: (nf,). All threads of the block
// call it together; it leaves the buffers free for the next call.
template <int LOGQ>
__device__ __forceinline__ void frame_dft(
    float2 (&v)[fftr::Shape<LOGQ>::U][fftr::Shape<LOGQ>::E],
    const int (&col)[fftr::Shape<LOGQ>::U],
    const int (&lane)[fftr::Shape<LOGQ>::U], float2* const (&bufs)[2],
    const float2* tw, const float* xw, int f0, int nframes,
    const float2* __restrict__ A, const float2* __restrict__ B,
    const float2* __restrict__ D, int n_fft, int nf, bool scale, float fs) {
  using S = fftr::Shape<LOGQ>;
  // the windowed, chirped frames; the first pass skips the zero tail of a
  // when N <= Q/2
#pragma unroll
  for (int u = 0; u < S::U; ++u) {
    const int jl = f0 + col[u];
    const bool ok = jl < nframes;
#pragma unroll
    for (int q = 0; q < S::E; ++q) {
      const int k = lane[u] + q * S::TPC;
      float2 a = make_float2(0.f, 0.f);
      if (ok && k < n_fft) {
        const float x = xw[jl + k];
        const float2 c = A[k];
        a = make_float2(x * c.x, x * c.y);
      }
      v[u][q] = a;
    }
  }
  fftr::fft<LOGQ, -1>(v, col, lane, bufs, tw, 2 * n_fft <= S::P, 0, S::P);
  // the forward transform ends in registers in the order the inverse one
  // starts from: the product with B costs no exchange
#pragma unroll
  for (int u = 0; u < S::U; ++u)
#pragma unroll
    for (int q = 0; q < S::E; ++q)
      v[u][q] = fftr::cmul(v[u][q], B[lane[u] + q * S::TPC]);
  // the last pass skips the butterflies whose outputs are all >= nf
  fftr::fft<LOGQ, 1, S::kNextFlip>(v, col, lane, bufs, tw, false, 0, nf);
#pragma unroll
  for (int u = 0; u < S::U; ++u)
#pragma unroll
    for (int q = 0; q < S::E; ++q) {
      const int k = lane[u] + q * S::TPC;
      if (k >= nf) continue;
      float2 X = fftr::cmul(D[k], v[u][q]);
      if (scale) X = make_float2(__fmul_rn(X.x, fs), __fmul_rn(X.y, fs));
      v[u][q] = X;
    }
}

}  // namespace bluestein
