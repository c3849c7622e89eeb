// Kernel H: the hop-1 inverse STFT's irfft and overlap-add as kernel F's
// exact adjoint, a per-frame inverse chirp-z transform on the
// register-radix FFT core and a deterministic overlap-add, for sm_90a.
//
// Replaces ssqueeze_rs_tpu/ops/stft_pallas.py::_make_istft_kernel (public
// istft_ola_fused). For every signal and output sample c,
//
//   out[c] = sum_t (Fr Sr - Fs Si)[t, c - t],   c < n_segs + N - 1,
//
// frames c - t outside [0, n_segs) contributing 0 (N = n_fft). Every
// caller's matrices have a structure, which it passes (ops/stft_cuda.py
// DftSpec): K' = [Fr^T; -Fs^T] is a stacked DFT matrix of kernel F, rows
// [Re; Im] of c_k sum_t v_w[t] e^{-2 pi i k t / N} for W = 1 or 2 tap
// windows v_w, nf = N/2 + 1 bins and per-bin factors c_k. With the planes
// stacked, g = [Sr; Si] (2 W nf rows), out = OLA(K'^T g), and since
// a Re z + b Im z = Re(conj(z) (a + i b)), frame j contributes
//
//   y_j[t] = sum_w v_w[t] Re( sum_{k<nf} conj(c_k) G_w[k] e^{2 pi i k t / N} )
//
// with G_w[k] = g[w 2nf + k, j] + i g[w 2nf + nf + k, j]. That is F's
// chirp-z transform run backwards on F's own host tables (A_w[t] = v_w[t]
// e^{-i pi t^2 / N}, B = FFT_Q(b) / Q of the chirp filter b[m] =
// e^{i pi m^2 / N} at m in (-N, nf), D[k] = c_k e^{-i pi k^2 / N}):
// kt = (k^2 + t^2 - (t - k)^2) / 2 gives
//
//   y_j[t] = sum_w Re( conj(A_w[t]) c_w[t] ),
//   c_w = IFFT_Q( FFT_Q(conj(D) G_w) conj(B) )      (unnormalised inverse),
//
// because sum_k a[k] conj(b[k - t]) is the circular correlation of a with
// b, whose transform is FFT(a) conj(FFT(b)), and conj(b[k - t]) =
// e^{-i pi (t - k)^2 / N}; the lags k - t lie in (-N, nf), which Q >= N +
// nf - 1 keeps apart. Then out[c] = sum_j y_j[c - j].
//
// Design: a block owns kFrames consecutive frames of one signal and an
// overlap-add span of kFrames + N - 1 samples in shared memory. The core
// holds NCOL columns at a time, one frame each, so neighbouring threads
// load neighbouring frames of a row of g. A round takes its frames through
// each window: conj(D) G_w loaded (nonzero only below nf, so the forward
// FFT's first pass skips its zero half when 2 nf <= Q), the forward FFT,
// the product with conj(B) in registers (the forward FFT ends in the order
// the inverse starts from, as in F), the inverse FFT, whose last pass
// skips the butterflies with every output >= N, and Re(conj(A_w) c_w)
// added over the windows into a buffer of the round's frames. Then each
// thread adds, for its samples of the span, the round's frames in frame
// order. The span is the block's partial sum; a second launch adds, for
// each output sample, the partials of the blocks that cover it, in block
// order. Every sum runs in a fixed order (no atomics): H is bitwise
// repeatable. The frame buffer's column stride is N rounded up to
// 32 / NCOL modulo 32 banks, so its stores (NCOL columns of a warp at
// neighbouring t) and the span's reads (neighbouring samples) are free of
// bank conflicts; the partials (~7 MB at N = 598 and 160 000 frames) stay
// in L2 for the second launch.
//
// What bounds it: at the bench shape (N = 598, 160 000 frames, one
// window) the function's work is a real inverse FFT of 598 points a
// frame, ~2.2e9 flops, against 0.38 GB of planes: memory-bound, ~0.12 ms
// at 3.35 TB/s. The chirp-z route does two complex FFTs of Q = 1024
// points a frame (~7x that arithmetic), its exchanges move ~65 KB a frame
// through shared memory, and at ~170 registers a thread (F: ~165) one
// block fits a SM: latency and the instruction rate, as for F, set its
// pace. The dense product it replaces did 598 x 300 x 2 multiply-adds a
// sample, 1.15e11 flops.

#include <cuda_runtime.h>

#include "fft_radix.cuh"

namespace {

constexpr int kFrames = 64;               // frames a block

// The frame buffer's column stride: >= n_fft and 32 / NCOL modulo 32
// (1 when NCOL >= 32), so the NCOL columns of a warp fall on distinct banks.
template <int LOGQ>
constexpr int frame_stride(int n_fft) {
  constexpr int ncol = fftr::Shape<LOGQ>::NCOL;
  constexpr int want = ncol >= 32 ? 1 : 32 / ncol;
  return n_fft + ((want - n_fft) & 31);
}

__device__ __forceinline__ float2 conjf2(float2 a) {
  return make_float2(a.x, -a.y);
}

// Block (frame group blockIdx.x, signal blockIdx.y). sr, si: (batch, h,
// n_segs), the stacked planes' rows [0, h) and [h, 2h); part: (batch,
// gridDim.x, kFrames + n_fft - 1).
template <int LOGQ>
__global__ void __launch_bounds__(fftr::kThreads)
istft_bluestein(const float* __restrict__ sr, const float* __restrict__ si,
                const float2* __restrict__ A, const float2* __restrict__ B,
                const float2* __restrict__ D, long long h, long long n_segs,
                int n_fft, int nf, int W, int ldy, float* __restrict__ part) {
  using S = fftr::Shape<LOGQ>;
  extern __shared__ float2 sm[];
  float2* tw = sm;
  float2* const bufs[2] = {sm + S::kTwFloat2,
                          sm + S::kTwFloat2 + S::NCOL * S::LD};
  float* ybuf = reinterpret_cast<float*>(sm + S::kTwFloat2 + S::kBufFloat2);
  float* span = ybuf + S::NCOL * ldy;     // kFrames + n_fft - 1 samples
  const long long b = blockIdx.y;
  const long long j0 = (long long)blockIdx.x * kFrames;
  const int ns = kFrames + n_fft - 1;
  fftr::fill_twiddles<LOGQ>(tw);
  for (int s = threadIdx.x; s < ns; s += blockDim.x) span[s] = 0.f;
  __syncthreads();

  int col[S::U], lane[S::U];
  fftr::units<LOGQ>(col, lane);
  const bool half_in = 2 * nf <= S::P;
  // G_w of a round's frames, raw, into registers: each step (a round's
  // window) loads the next step's, so its loads are in flight while this
  // step's transforms run
  auto load = [&](int f0, int w, float2 (&g)[S::U][S::E]) {
    // the window's rows w 2nf + k (Re G) and w 2nf + nf + k (Im G) of g
    const long long re = 2LL * w * nf, im = re + nf;
    const float* gr = re < h ? sr + (b * h + re) * n_segs
                             : si + (b * h + re - h) * n_segs;
    const float* gi = im < h ? sr + (b * h + im) * n_segs
                             : si + (b * h + im - h) * n_segs;
#pragma unroll
    for (int u = 0; u < S::U; ++u) {
      const int jl = f0 + col[u];
      const long long j = j0 + jl;
      const bool ok = jl < kFrames && j < n_segs;
#pragma unroll
      for (int q = 0; q < S::E; ++q) {
        const int k = lane[u] + q * S::TPC;
        const long long o = (long long)k * n_segs + j;
        g[u][q] = ok && k < nf ? make_float2(gr[o], gi[o])
                               : make_float2(0.f, 0.f);
      }
    }
  };
  float2 next[S::U][S::E];
  load(0, 0, next);
  // a round: NCOL frames (at most kFrames), one a column, through each
  // window in turn
  for (int f0 = 0; f0 < kFrames; f0 += S::NCOL) {
    for (int w = 0; w < W; ++w) {
      float2 v[S::U][S::E];
#pragma unroll
      for (int u = 0; u < S::U; ++u)
#pragma unroll
        for (int q = 0; q < S::E; ++q) {
          const int k = lane[u] + q * S::TPC;
          v[u][q] = k < nf ? fftr::cmul(conjf2(D[k]), next[u][q])
                           : next[u][q];
        }
      if (w + 1 < W)
        load(f0, w + 1, next);
      else if (f0 + S::NCOL < kFrames)
        load(f0 + S::NCOL, 0, next);
      fftr::fft<LOGQ, -1>(v, col, lane, bufs, tw, half_in, 0, S::P);
#pragma unroll
      for (int u = 0; u < S::U; ++u)
#pragma unroll
        for (int q = 0; q < S::E; ++q)
          v[u][q] = fftr::cmul(v[u][q], conjf2(B[lane[u] + q * S::TPC]));
      fftr::fft<LOGQ, 1, S::kNextFlip>(v, col, lane, bufs, tw, false, 0,
                                       n_fft);
#pragma unroll
      for (int u = 0; u < S::U; ++u) {
        if (f0 + col[u] >= kFrames) continue;
        float* y = ybuf + col[u] * ldy;
#pragma unroll
        for (int q = 0; q < S::E; ++q) {
          const int t = lane[u] + q * S::TPC;
          if (t >= n_fft) continue;
          // Re(conj(A_w[t]) c_w[t]), the windows added in order
          const float2 a = A[w * n_fft + t];
          const float yt = a.x * v[u][q].x + a.y * v[u][q].y;
          y[t] = w ? y[t] + yt : yt;
        }
      }
    }
    __syncthreads();                      // the round's frames
    // span[f0 + s] += y_{f0 + c}[s - c], c in frame order
    const int nc = kFrames - f0 < S::NCOL ? kFrames - f0 : S::NCOL;
    for (int s = threadIdx.x; s < nc + n_fft - 1; s += blockDim.x) {
      float acc = span[f0 + s];
      for (int c = 0; c < nc; ++c) {
        const int t = s - c;
        if (t >= 0 && t < n_fft) acc += ybuf[c * ldy + t];
      }
      span[f0 + s] = acc;
    }
    __syncthreads();                      // before the next round's frames
  }
  float* o = part + (b * gridDim.x + blockIdx.x) * (long long)ns;
  for (int s = threadIdx.x; s < ns; s += blockDim.x) o[s] = span[s];
}

// out[b, c] = sum over the blocks i that cover c, in order, of
// part[b, i, c - i kFrames] (0 <= c - i kFrames < ns).
__global__ void ola_partials(const float* __restrict__ part, long long nblk,
                             int ns, long long L, long long n,
                             float* __restrict__ out) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const long long b = e / L, c = e % L;
    const long long hi = c / kFrames < nblk - 1 ? c / kFrames : nblk - 1;
    const long long lo = c - ns + 1 <= 0 ? 0 : (c - ns + kFrames) / kFrames;
    const float* p = part + b * nblk * ns + c;
    float acc = 0.f;
    for (long long i = lo; i <= hi; ++i) acc += p[i * (ns - kFrames)];
    out[e] = acc;
  }
}

}  // namespace

// sr, si: (batch, h, n_segs) float32, the rows [0, h) and [h, 2h) of the
// stacked planes g (h = W nf); A: (W, n_fft), B: (2^logQ,), D: (nf,)
// complex64, kernel F's Bluestein tables of the structure of [Fr^T; -Fs^T];
// part: scratch of batch * ceil(n_segs / 64) * (64 + n_fft - 1) floats;
// out: (batch, n_segs + n_fft - 1). Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int ssq_istft_ola(const float* sr, const float* si, const void* A,
                             const void* B, const void* D, int batch,
                             long long h, long long n_segs, int n_fft, int nf,
                             int W, int logQ, float* part, float* out,
                             void* stream) {
  if (W < 1 || W > 2 || h != (long long)W * nf || logQ < 2 || logQ > 12 ||
      (1LL << logQ) < n_fft + nf - 1 || n_segs < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long nblk = (n_segs + kFrames - 1) / kFrames;
  const int ns = kFrames + n_fft - 1;
  cudaError_t err = fftr::dispatch_log<2, 12>(logQ, [&](auto c) {
    constexpr int LOG = decltype(c)::value;
    auto k = istft_bluestein<LOG>;
    const int ldy = frame_stride<LOG>(n_fft);
    const size_t smem =
        fftr::core_smem<LOG>() +
        (size_t)(fftr::Shape<LOG>::NCOL * ldy + ns) * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    k<<<dim3((unsigned)nblk, (unsigned)batch), fftr::kThreads, smem, st>>>(
        sr, si, (const float2*)A, (const float2*)B, (const float2*)D, h,
        n_segs, n_fft, nf, W, ldy, part);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  const long long L = n_segs + n_fft - 1, n = (long long)batch * L;
  const long long blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  ola_partials<<<(unsigned)blocks, 256, 0, st>>>(part, nblk, ns, L, n, out);
  return (int)cudaGetLastError();
}
