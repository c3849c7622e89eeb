// Kernels D and E: the half-band inverse DFT of CWT spectra, emitting
// float32 real/imaginary planes, for sm_90a.
//
// D replaces ssqueeze_rs_tpu/ops/fft_pallas.py::_make_cwt_kernel and its
// TPU variants _make_cwt_kernel_t, _make_cwt_kernel_rb and
// _make_cwt_kernel_tiled (the pallas_call in _cwt_fused_call without
// phase_gamma; they differ only in matrix-unit issue order and VMEM
// tiling). Per output row (b-major: row = ib*na + ia) it computes
//
//   Z[k]  = Pw[ia,k] * xhat[ib,k]              k < M/2 (half band)
//   dZ[k] = (-Im Z[k], Re Z[k]) * xig[k] / dt  (only with derivative)
//   Wx(n)  = (1/M) sum_k Z[k] e^{2 pi i k n / M} + nyq_w (-1)^n / M
//   dWx(n) likewise with dZ and nyq_d
//
// for n in the keep window [start, start+L), and emits (Wxr, Wxi) or
// (Wxr, Wxi, dWxr, dWxi). It is kernel A (cwt_phase.cu) with plane stores
// in place of the phase epilogue, and one pipeline instead of two when the
// derivative is off.
//
// E replaces ssqueeze_rs_tpu/ops/fft_pallas.py::_make_kernel and
// _make_kernel_tiled (the pallas_call in _fused_call, public
// ifft_halfband_planar_fused): the same transform of Z planes (B, K1, M2)
// given in device memory, with Nyquist values (B,), emitting (xr, xi)
// (B, L). The port uses it for analytic wavelets whose psih is complex.
//
// Both run the two-launch four-step split of fft4.cuh: launch 1 loads (D:
// builds) Z, runs the length-M1 FFTs and stores the twiddled intermediate
// Y; launch 2 runs the length-M2 FFTs and stores the kept planes with the
// Nyquist term. Rows go through in chunks of at most `ychunk`, so Y has a
// fixed size whatever the batch; every M that best_split accepts
// (up to 2^22) fits shared memory, so no tiling by k2 is needed.
//
// What bounds them on Hopper: device-memory traffic. Counted as the work
// requires, D at the cwt headline (293 rows, M = 2^18, 160 000 kept
// columns) reads Pw (0.15 GB) and writes two 0.19 GB planes, ~0.53 GB or
// ~0.16 ms at 3.35 TB/s; with the derivative four planes, ~0.91 GB or
// ~0.27 ms. E reads its Z planes (2 x rows x M/2 x 4 B) and writes two
// planes. What this simple design pays above that is Y: rows x M complex
// floats per pipeline (0.61 GB at the headline), written once and read
// once. What the design does about it: D never materialises Z (built from
// Pw and xhat while loading), Y is written and read exactly once in full
// 32-byte sectors, only the n2 rows that cover the keep window are
// transformed and stored, and the derivative pipeline runs only when it is
// asked for. Keeping Y on chip (one block cluster per row, distributed
// shared memory) is later work.
//
// D's two kernels live in cwt_planes.cuh, which csrc/ablate_cwt.cu
// instantiates with its ablation flags.

#include <cuda_runtime.h>
#include <math.h>

#include "cwt_planes.cuh"

namespace {

// E, launch 1: Z planes (rows, K1, M2) from device memory.
__global__ void __launch_bounds__(kThreads)
ifft_planes_stage1(const float* __restrict__ Zr, const float* __restrict__ Zi,
                   int logM1, int M2, int tk2, float2* __restrict__ Y,
                   long long row0, long long nrows) {
  extern __shared__ float2 sm[];
  const long long half = (long long)((1 << logM1) >> 1) * M2;
  const long long local = blockIdx.x;
  const float* zr = Zr + (row0 + local) * half;
  const float* zi = Zi + (row0 + local) * half;
  auto load = [&](long long g, float2* z) {
    z[0] = make_float2(zr[g], zi[g]);
  };
  fft4::stage1<1>(sm, load, logM1, M2, tk2, blockIdx.y * tk2, Y, local,
                  nrows);
}

}  // namespace

// Kernel D. Y: scratch of P*ychunk*M float2 (P = 2 with the derivative,
// else 1); rows go through both launches ychunk at a time. Without the
// derivative, ndr/ndi/odr/odi are not read or written (may be null).
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int ssq_cwt_planes(const float* Pw, const float* xr,
                              const float* xi, const float* xig, float inv_dt,
                              const float* nwr, const float* nwi,
                              const float* ndr, const float* ndi,
                              long long rows, int na, int logM1, int logM2,
                              int start, int L, int derivative, void* Y,
                              long long ychunk, float* owr, float* owi,
                              float* odr, float* odi, void* stream) {
  if (ychunk < 1) return (int)cudaErrorInvalidValue;
  Planes pl = {{nwr, nwi, ndr, ndi}, {owr, owi, odr, odi}};
  cudaStream_t st = (cudaStream_t)stream;
  if (derivative)
    return cwt_planes_run<2, fft4::kFull>(Pw, xr, xi, xig, inv_dt, pl, rows,
                                          na, logM1, logM2, start, L, Y,
                                          ychunk, st);
  return cwt_planes_run<1, fft4::kFull>(Pw, xr, xi, xig, inv_dt, pl, rows, na,
                                        logM1, logM2, start, L, Y, ychunk,
                                        st);
}

// Kernel E. Zr, Zi: (rows, K1, M2); nr, ni: (rows,); Y: scratch of
// ychunk*M float2. Returns cudaGetLastError() after the launches.
extern "C" int ssq_ifft_halfband(const float* Zr, const float* Zi,
                                 const float* nr, const float* ni,
                                 long long rows, int logM1, int logM2,
                                 int start, int L, void* Y, long long ychunk,
                                 float* outr, float* outi, void* stream) {
  if (ychunk < 1) return (int)cudaErrorInvalidValue;
  Planes pl = {{nr, ni, nullptr, nullptr}, {outr, outi, nullptr, nullptr}};
  cudaStream_t st = (cudaStream_t)stream;
  Plan plan;
  cudaError_t err = plan_launches(ifft_planes_stage1,
                                  planes_stage2<1, fft4::kFull>, logM1, logM2,
                                  1, &plan);
  if (err != cudaSuccess) return (int)err;
  const int M1 = 1 << logM1, M2 = 1 << logM2;
  for (long long row0 = 0; row0 < rows; row0 += ychunk) {
    const long long nrw = rows - row0 < ychunk ? rows - row0 : ychunk;
    ifft_planes_stage1<<<dim3((unsigned)nrw, M2 / plan.tk2), kThreads,
                         plan.smem1, st>>>(Zr, Zi, logM1, M2, plan.tk2,
                                           (float2*)Y, row0, nrw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    planes_stage2<1, fft4::kFull><<<dim3((unsigned)nrw, M1 / plan.tn1),
                                    kThreads, plan.smem2, st>>>(
        (const float2*)Y, pl, logM1, logM2, plan.tn1, start, L, row0, nrw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
