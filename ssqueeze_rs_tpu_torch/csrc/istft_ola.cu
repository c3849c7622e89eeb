// Kernel H: hop-1 inverse STFT as one fused irfft product + overlap-add,
// for sm_90a.
//
// Replaces ssqueeze_rs_tpu/ops/stft_pallas.py::_make_istft_kernel. For
// every output sample c of every signal,
//
//   out[c] = sum_k sum_t Fr'[t, k] * Sr[k, c - t] - Fs'[t, k] * Si[k, c - t]
//
// with Fr', Fs' the window-scaled irfft matrices (window^win_exp folded in
// on the host) and columns c - t outside [0, n_segs) contributing 0: the
// irfft matmul and the overlap-add of its n_fft shifted rows in one pass,
// so the (n_fft, n_segs) buffer of the unfused route never exists.
//
// Design: a block of 128 threads owns 1536 consecutive samples (12 per
// thread) and one of up to 8 slices of the frequency rows. Per step it
// stages 4 rows of the Sx planes over the window [c0 - NP + 1, c0 + 1536)
// and the matching 4 columns of Fr', Fs' in shared memory; each thread
// slides a 28-value window of Sx across 16 taps at a time (float4 reads,
// no bank conflicts) against broadcast reads of Fr', Fs'. Every sample is
// summed in fixed order and in levels, to keep float32 rounding near that
// of the unfused product + overlap-add (one accumulator over the ~48 000
// terms of a slice lost a factor of five): 32 products of a 16-tap step,
// then the steps of one row k, then the rows of the slice. The slices'
// partial sums go to device memory and a second, small kernel adds them in
// slice order, so the result is deterministic (no atomics) and the
// frequency split gives the card enough blocks at one signal of 160 000
// samples.
//
// What bounds it: float32 arithmetic, 1.15e11 FLOP at the bench shape
// (598 taps x 300 rows x 2 planes x 160 597 samples) against 0.4 GB read;
// 384 FMAs per 22 float4 reads of shared memory keep the CUDA cores the
// limit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTN = 12;                  // samples per thread
constexpr int kT = kThreads * kTN;       // samples per block
constexpr int kKC = 4;                   // frequency rows per stage
constexpr int kBT = 16;                  // taps per window step
constexpr int kWin = kTN + kBT;          // sliding window (28, float4s)

__global__ void __launch_bounds__(kThreads)
istft_ola_kernel(const float* __restrict__ sr, const float* __restrict__ si,
                 const float* __restrict__ frT, const float* __restrict__ fsT,
                 int nf, long long n_segs, int NP, long long L, int k_slice,
                 int batch, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = kT + NP;                 // staged Sx columns per row
  float* swr = reinterpret_cast<float*>(smem_raw);   // [kKC][W]
  float* swi = swr + kKC * W;
  float* fwr = swi + kKC * W;                         // [kKC][NP]
  float* fwi = fwr + kKC * NP;
  const int tid = threadIdx.x;
  const long long b = blockIdx.z;
  const long long c0 = (long long)blockIdx.x * kT;
  const int k_begin = blockIdx.y * k_slice;
  const int k_end = min(nf, k_begin + k_slice);

  float acc[kTN];
#pragma unroll
  for (int m = 0; m < kTN; ++m) acc[m] = 0.f;

  for (int kb = k_begin; kb < k_end; kb += kKC) {
    // sw[kk][q] = S[kb + kk, c0 - NP + 1 + q]; fw[kk][t] = F'[t, kb + kk]
    for (int e = tid; e < kKC * W; e += kThreads) {
      const int k = kb + e / W;
      const long long col = c0 - NP + 1 + e % W;
      const bool in = k < k_end && col >= 0 && col < n_segs;
      const long long o = (b * nf + k) * n_segs + col;
      swr[e] = in ? sr[o] : 0.f;
      swi[e] = in ? si[o] : 0.f;
    }
    for (int e = tid; e < kKC * NP; e += kThreads) {
      const int k = kb + e / NP;
      const bool in = k < k_end;
      const long long o = (long long)k * NP + e % NP;
      fwr[e] = in ? frT[o] : 0.f;
      fwi[e] = in ? fsT[o] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kKC; ++kk) {
      float racc[kTN];                  // this row's sum over the taps
#pragma unroll
      for (int m = 0; m < kTN; ++m) racc[m] = 0.f;
      const float* rowr = swr + kk * W;
      const float* rowi = swi + kk * W;
      const float4* far = reinterpret_cast<const float4*>(fwr + kk * NP);
      const float4* fai = reinterpret_cast<const float4*>(fwi + kk * NP);
      for (int t0 = 0; t0 < NP; t0 += kBT) {
        // sample c0 + tid*kTN + m, tap t0 + tt reads column index
        // q = tid*kTN + m + NP - 1 - t0 - tt = q0 + (kBT - 1 - tt) + m
        const int q0 = tid * kTN + NP - t0 - kBT;
        float a[kBT], ai[kBT], br[kWin], bi[kWin];
#pragma unroll
        for (int u = 0; u < kBT / 4; ++u) {
          const float4 x = far[t0 / 4 + u], y = fai[t0 / 4 + u];
          a[4 * u] = x.x; a[4 * u + 1] = x.y; a[4 * u + 2] = x.z;
          a[4 * u + 3] = x.w;
          ai[4 * u] = -y.x; ai[4 * u + 1] = -y.y; ai[4 * u + 2] = -y.z;
          ai[4 * u + 3] = -y.w;
        }
        const float4* wr4 = reinterpret_cast<const float4*>(rowr + q0);
        const float4* wi4 = reinterpret_cast<const float4*>(rowi + q0);
#pragma unroll
        for (int u = 0; u < kWin / 4; ++u) {
          const float4 x = wr4[u], y = wi4[u];
          br[4 * u] = x.x; br[4 * u + 1] = x.y; br[4 * u + 2] = x.z;
          br[4 * u + 3] = x.w;
          bi[4 * u] = y.x; bi[4 * u + 1] = y.y; bi[4 * u + 2] = y.z;
          bi[4 * u + 3] = y.w;
        }
        float tacc[kTN];                // this step's 2 * kBT products
#pragma unroll
        for (int m = 0; m < kTN; ++m) tacc[m] = 0.f;
#pragma unroll
        for (int tt = 0; tt < kBT; ++tt)
#pragma unroll
          for (int m = 0; m < kTN; ++m) {
            tacc[m] = __fmaf_rn(a[tt], br[kBT - 1 - tt + m], tacc[m]);
            tacc[m] = __fmaf_rn(ai[tt], bi[kBT - 1 - tt + m], tacc[m]);
          }
#pragma unroll
        for (int m = 0; m < kTN; ++m) racc[m] += tacc[m];
      }
#pragma unroll
      for (int m = 0; m < kTN; ++m) acc[m] += racc[m];
    }
    __syncthreads();
  }

  float* o = part + ((long long)blockIdx.y * batch + b) * L;
#pragma unroll
  for (int m = 0; m < kTN; ++m) {
    const long long c = c0 + tid * kTN + m;
    if (c < L) o[c] = acc[m];
  }
}

// out[i] = sum over slices s in order of part[s][i], i < n.
__global__ void sum_slices_kernel(const float* __restrict__ part,
                                  int nslices, long long n,
                                  float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int k = 1; k < nslices; ++k) s += part[k * n + i];
    out[i] = s;
  }
}

}  // namespace

// sr, si: (batch, nf, n_segs) Sx planes; frT, fsT: (nf, NP) transposed
// Fr', Fs' zero-padded to NP (a multiple of 16) taps; the frequency rows
// go in nslices slices of k_slice rows (a multiple of 4); part:
// (nslices, batch, L) scratch; out: (batch, L) with L = n_segs + n_fft - 1.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int ssq_istft_ola(const float* sr, const float* si,
                             const float* frT, const float* fsT, int batch,
                             int nf, long long n_segs, int NP, long long L,
                             int k_slice, int nslices, float* part,
                             float* out, void* stream) {
  if (NP % kBT || k_slice % kKC || (long long)nslices * k_slice < nf)
    return (int)cudaErrorInvalidValue;
  // Sx window rows and F' columns, two planes each (the wrapper's
  // istft_ola_ok computes the same)
  const size_t smem = sizeof(float) * 2 * kKC * ((size_t)(kT + NP) + NP);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      istft_ola_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((L + kT - 1) / kT), (unsigned)nslices,
                  (unsigned)batch);
  istft_ola_kernel<<<grid, kThreads, smem, s>>>(sr, si, frT, fsT, nf, n_segs,
                                                NP, L, k_slice, batch, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)batch * L;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  sum_slices_kernel<<<blocks, 256, 0, s>>>(part, nslices, n, out);
  return (int)cudaGetLastError();
}
