// Kernel A: fused CWT filterbank multiply + half-band inverse DFT + unpad
// + Nyquist term + phase transform, for sm_90a.
//
// Replaces ssqueeze_rs_tpu/ops/fft_pallas.py::_make_cwt_kernel_phase
// (the pallas_call in _cwt_fused_call with phase_gamma). Per output row
// (b-major: row = ib*na + ia) it computes
//
//   Z[k]  = Pw[ia,k] * xhat[ib,k]              k < M/2 (half band)
//   dZ[k] = (-Im Z[k], Re Z[k]) * xig[k] / dt  (the derivative pipeline)
//   W(n)  = (1/M) sum_k Z[k] e^{2 pi i k n / M} + nyq_w (-1)^n / M
//   dW(n) likewise with dZ and nyq_d
//
// for n in the keep window [start, start+L), and emits Wx = (C, D) and
//   w = |B*C - A*D| / (|Wx|^2 * 2 pi),  or +inf where |Wx|^2 <= gamma^2,
// with (A, B) = dW. All planes float32.
//
// Transform: the two-launch four-step split of fft4.cuh (shared with
// kernels D and E): launch 1 builds Z and dZ in registers while loading
// and runs the length-M1 FFTs, launch 2 the length-M2 FFTs, the keep
// window, the Nyquist term and this phase epilogue.
//
// What bounds it on Hopper: device-memory traffic on the intermediate.
// Counted as the work requires (each input read once, each output written
// once) the bound is Pw (0.15 GB at the 160k headline: 293 rows, M = 2^18)
// plus ~1 MB of signal planes in and three 293 x 160 000 planes (0.56 GB)
// out, ~0.72 GB or ~0.21 ms at 3.35 TB/s. What this simple design pays
// above that is the intermediate Y: 2 pipelines x rows x M complex floats
// (1.2 GB at the headline), written once and read once; the FFT arithmetic
// (~10 flop per butterfly, log2 M butterfly stages) is far below the
// card's rate. What the design does about it: Z and dZ are never
// materialised (built from Pw and xhat while loading launch 1), Y is
// written and read exactly once with full 32-byte sectors, only the n2
// rows that cover the keep window are stored, and the 1/M scale is applied
// once at the end. Rows go through the two launches in chunks of at most
// `ychunk` rows, so Y has a fixed size whatever the batch. Keeping Y out of
// device memory altogether (one block cluster per row, distributed shared
// memory) is later work.

#include <cuda_runtime.h>
#include <math.h>

#include "fft4.cuh"

namespace {

using fft4::kThreads;

__global__ void __launch_bounds__(kThreads)
cwt_stage1(const float* __restrict__ Pw, const float* __restrict__ xr,
           const float* __restrict__ xi, const float* __restrict__ xig,
           float inv_dt, int na, int logM1, int M2, int tk2,
           float2* __restrict__ Y, long long row0, long long nrows) {
  extern __shared__ float2 sm[];
  const int K1 = (1 << logM1) >> 1;
  const long long local = blockIdx.x;      // row within the chunk (Y)
  const long long row = row0 + local;
  const long long ia = row % na, ib = row / na;
  const float* pw = Pw + ia * (long long)K1 * M2;
  const float* sr = xr + ib * (long long)K1 * M2;
  const float* si = xi + ib * (long long)K1 * M2;
  auto load = [&](long long g, float2* z) {
    const float p = pw[g];
    const float zr = p * sr[g];
    const float zi = p * si[g];
    const float s = xig[g] * inv_dt;
    z[0] = make_float2(zr, zi);
    z[1] = make_float2(-zi * s, zr * s);
  };
  fft4::stage1<2>(sm, load, logM1, M2, tk2, blockIdx.y * tk2, Y, local,
                  nrows);
}

__global__ void __launch_bounds__(kThreads)
cwt_stage2(const float2* __restrict__ Y, const float* __restrict__ nwr,
           const float* __restrict__ nwi, const float* __restrict__ ndr,
           const float* __restrict__ ndi, int logM1, int logM2, int tn1,
           int start, int L, float gamma2, float* __restrict__ owr,
           float* __restrict__ owi, float* __restrict__ ow, long long row0,
           long long nrows) {
  extern __shared__ float2 sm[];
  const long long local = blockIdx.x;
  const long long row = row0 + local;
  const float nr_w = nwr[row], ni_w = nwi[row];
  const float nr_d = ndr[row], ni_d = ndi[row];
  const float two_pi = 6.283185307179586f;
  auto epi = [&](int j, float alt, float invM, const float2* v) {
    const float C = v[0].x * invM + nr_w * alt;
    const float D = v[0].y * invM + ni_w * alt;
    const float A = v[1].x * invM + nr_d * alt;
    const float B = v[1].y * invM + ni_d * alt;
    const float mag2 = C * C + D * D;
    const float ratio = (B * C - A * D) / (mag2 * two_pi);
    const long long o = row * L + j;
    owr[o] = C;
    owi[o] = D;
    ow[o] = (mag2 > gamma2) ? fabsf(ratio) : INFINITY;
  };
  fft4::stage2<2>(sm, Y, logM1, logM2, tn1, blockIdx.y * tn1, start, L,
                  local, nrows, epi);
}

}  // namespace

// Y: scratch of 2*ychunk*M float2; rows go through both launches ychunk at
// a time. Returns cudaGetLastError() after the launches (0 on success).
extern "C" int ssq_cwt_phase(const float* Pw, const float* xr,
                             const float* xi, const float* xig, float inv_dt,
                             const float* nwr, const float* nwi,
                             const float* ndr, const float* ndi,
                             long long rows, int na, int logM1, int logM2,
                             int start, int L, float gamma2, void* Y,
                             long long ychunk, float* owr, float* owi,
                             float* ow,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int M1 = 1 << logM1, M2 = 1 << logM2;

  if (ychunk < 1) return (int)cudaErrorInvalidValue;
  const int tk2 = fft4::pick_tile(M1, M2, 2);
  const size_t smem1 = fft4::smem_bytes(M1, tk2, 2);
  cudaError_t err = cudaFuncSetAttribute(
      cwt_stage1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  const int tn1 = fft4::pick_tile(M2, M1, 2);
  const size_t smem2 = fft4::smem_bytes(M2, tn1, 2);
  err = cudaFuncSetAttribute(
      cwt_stage2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;

  for (long long row0 = 0; row0 < rows; row0 += ychunk) {
    const long long nr = rows - row0 < ychunk ? rows - row0 : ychunk;
    cwt_stage1<<<dim3((unsigned)nr, M2 / tk2), kThreads, smem1, st>>>(
        Pw, xr, xi, xig, inv_dt, na, logM1, M2, tk2, (float2*)Y, row0, nr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cwt_stage2<<<dim3((unsigned)nr, M1 / tn1), kThreads, smem2, st>>>(
        (const float2*)Y, nwr, nwi, ndr, ndi, logM1, logM2, tn1, start, L,
        gamma2, owr, owi, ow, row0, nr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
