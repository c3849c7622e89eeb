// Kernel F: hop-1 STFT as one fused framing + windowed-DFT product, for
// sm_90a.
//
// Replaces ssqueeze_rs_tpu/ops/stft_pallas.py::_make_kernel (with
// _frames_dft_into). out[b, r, j] = sum_t K_T[r, t] * xp[b, j + t] for the
// stacked [Sr; Si(; dSr; dSi)] DFT matrix K_T (window, modulation and
// derivative window folded in on the host); rows r >= scale_from (the
// derivative planes) are then multiplied by fs, as ops/stft.py does after
// the product.
//
// Design: a block owns a (128 rows, 128 columns) output tile of one
// signal. It stages the signal window xp[j0 : j0 + 128 + NP] in shared
// memory once (about 3 KB at n_fft = 598): frame t of column j is
// xw[j - j0 + t], so no frame matrix exists in device memory (the TPU
// kernel builds it in VMEM; the XLA route writes 383 MB of it). The K
// tiles stream through shared memory (dft_tile.cuh); the whole K_T (2.9 MB
// at 1200 x 598) stays in the 50 MB L2. Each thread sums an 8 x 8 register
// tile over the taps in increasing order, in full float32 on the CUDA
// cores (no bf16 splits, no tensor cores: later work).
//
// What bounds it: float32 arithmetic. At the bench shape (N = 160 000,
// n_fft = 598) F is 1.15e11 FLOP with 600 rows and 2.3e11 with 1200,
// against 0.4-0.8 GB of output; the 8 x 8 tile does 64 FMAs per two
// shared-memory reads of K and a sliding signal window read once per 16
// taps, so the CUDA cores, not memory, set its pace.

#include <cuda_runtime.h>

#include "dft_tile.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kTM = 8, kTN = 8;
using Tile = ssq::DftTile<kBM, kBN, kTM, kTN>;

__global__ void __launch_bounds__(Tile::kThreads)
stft_dft_kernel(const float* __restrict__ xp, const float* __restrict__ K,
                long long mp, int NP, int rows, int rows_pad, long long n_out,
                float fs, int scale_from, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);
  float* xw = As + Tile::kAsFloats;
  const long long b = blockIdx.z;
  const long long j0 = (long long)blockIdx.x * kBN;
  const int r0 = blockIdx.y * kBM;

  ssq::stage_signal(xp + b * mp, mp, j0, Tile::window(NP), xw);
  __syncthreads();
  float acc[kTM][kTN];
  ssq::dft_tile<kBM, kBN, kTM, kTN>(K, rows_pad, r0, NP, xw, As, acc);

  const int tx = threadIdx.x % (kBN / kTN);
  const int ty = threadIdx.x / (kBN / kTN);
  const long long j = j0 + tx * kTN;
  const bool vec = ((n_out & 3) == 0) && (j + kTN <= n_out);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = r0 + ty * kTM + i;
    if (r >= rows) continue;
    float v[kTN];
#pragma unroll
    for (int m = 0; m < kTN; ++m)
      v[m] = (r >= scale_from) ? __fmul_rn(acc[i][m], fs) : acc[i][m];
    float* o = out + (b * rows + r) * n_out + j;
    if (vec) {
#pragma unroll
      for (int m = 0; m < kTN; m += 4)
        *reinterpret_cast<float4*>(o + m) =
            make_float4(v[m], v[m + 1], v[m + 2], v[m + 3]);
    } else {
#pragma unroll
      for (int m = 0; m < kTN; ++m)
        if (j + m < n_out) o[m] = v[m];
    }
  }
}

}  // namespace

// xp: (batch, mp) float32 padded signals; K: (NP, rows_pad) float32, the
// transposed K_T zero-padded to NP (a multiple of 16) taps and rows_pad (a
// multiple of 128) rows; out: (batch, rows, n_out). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ssq_stft_dft(const float* xp, const float* K, int batch,
                            long long mp, int NP, int rows, int rows_pad,
                            long long n_out, float fs, int scale_from,
                            float* out, void* stream) {
  if (NP % ssq::kBK || rows_pad % kBM || rows > rows_pad)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (Tile::kAsFloats + Tile::window(NP)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stft_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n_out + kBN - 1) / kBN),
                  (unsigned)(rows_pad / kBM), (unsigned)batch);
  stft_dft_kernel<<<grid, Tile::kThreads, smem, (cudaStream_t)stream>>>(
      xp, K, mp, NP, rows, rows_pad, n_out, fs, scale_from, out);
  return (int)cudaGetLastError();
}
