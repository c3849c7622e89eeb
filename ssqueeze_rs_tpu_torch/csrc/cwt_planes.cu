// Kernels D, E and A: the half-band inverse DFT of CWT spectra, emitting
// float32 real/imaginary planes (D, E) or Wx and the phase plane (A), for
// sm_90a.
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
// (Wxr, Wxi, dWxr, dWxi).
//
// E replaces ssqueeze_rs_tpu/ops/fft_pallas.py::_make_kernel and
// _make_kernel_tiled (the pallas_call in _fused_call, public
// ifft_halfband_planar_fused): the same transform of Z planes (B, K1, M2)
// given in device memory, with Nyquist values (B,), emitting (xr, xi)
// (B, L). The port uses it for analytic wavelets whose psih is complex.
//
// A replaces ssqueeze_rs_tpu/ops/fft_pallas.py::_make_cwt_kernel_phase
// (the pallas_call in _cwt_fused_call with phase_gamma): D with the
// derivative, whose epilogue emits Wx = (C, D) and
//   w = |B*C - A*D| / (|Wx|^2 * 2 pi),  or +inf where |Wx|^2 <= gamma^2,
// with (A, B) = dWx, in place of the four planes.
//
// All three split M = M1*M2 (k = M2*k1 + k2, n = n1 + M1*n2) into two
// launches: launch 1 runs the length-M1 inverse FFTs over k1 and stores
// the twiddled intermediate Y[pipe][row][n1][k2]; launch 2 runs the
// length-M2 inverse FFTs over k2 and stores the kept outputs with the
// Nyquist term. Launch 1 takes a loader (DLoad, ALoad: Pw * xhat and dZ;
// ELoad: the given Z planes), launch 2 a store (PlanesStore: a pipeline a
// block, its planes; PhaseStore: both pipelines of a row in one thread's
// two slots, and A's epilogue).
//
// What bounds D on Hopper: device-memory traffic. Counted as the work
// requires, D at the cwt headline (293 rows, M = 2^18, 160 000 kept
// columns) reads Pw (0.15 GB) and writes two 0.19 GB planes, ~0.53 GB or
// ~0.16 ms at 3.35 TB/s; with the derivative four planes, ~0.91 GB or
// ~0.27 ms (A: three planes, ~0.72 GB or ~0.21 ms). Above that it pays Y
// (rows x M complex floats a pipeline, 0.61 GB at the headline, written
// once and read once) and the butterflies' shared-memory passes. What the
// design does about them:
//   * Y stays in L2. The caller gives row chunks whose Y (pipes x ychunk x
//     M x 8 bytes) fits well inside the 50 MB L2, and both launches of a
//     chunk are issued here back to back, so launch 2 reads what launch 1
//     has just written without a round trip through device memory.
//   * The column FFTs run on the register-radix core (fft_radix.cuh):
//     radix-8 or radix-16 passes with one shared-memory exchange each, 3
//     for 512 or 2048 points where radix 2 took 9 or 11. Launch 1 tells
//     the core that only the first M1/2 inputs are nonzero (the half
//     band), launch 2 that only the n2 rows covering the keep window are
//     wanted.
//   * Z is never materialised (built from Pw and xhat while loading); all
//     device-memory runs cover whole 32-byte sectors but launch 1's reads
//     of Pw and xhat with the derivative and A's stores (16 bytes a run,
//     the rest in the next block's run).
// E reads 8 bytes a point from device memory (two planes) where D reads Pw
// and shares xhat between rows; a block of launch 1 holds NCOL
// neighbouring k2 columns (8 at M1 = 512), so each plane's run is 32
// bytes, one whole sector. A's launch 2 holds both pipelines of NCU = 4 n1
// rows a block at M2 = 512, where D's holds 8 rows of one pipeline.
//
// The loaders, the stores, both launches and the host loop over the row
// chunks (run_planes) are in cwt_pair.cuh, which the probes P1 and P3
// (ablate_cwt.cu) instantiate with ablation flags; this file holds the
// entry points.

#include <cuda_runtime.h>

#include "cwt_pair.cuh"

// Kernel D. Y: scratch of P*ychunk*M float2 (P = 2 with the derivative,
// else 1); rows go through both launches ychunk at a time (the caller sizes
// the chunk so that Y stays in L2). Without the derivative, ndr/ndi/odr/odi
// are not read or written (may be null). Returns cudaGetLastError() after
// the launches (0 on success).
extern "C" int ssq_cwt_planes(const float* Pw, const float* xr,
                              const float* xi, const float* xig, float inv_dt,
                              const float* nwr, const float* nwi,
                              const float* ndr, const float* ndi,
                              long long rows, int na, int logM1, int logM2,
                              int start, int L, int derivative, void* Y,
                              long long ychunk, float* owr, float* owi,
                              float* odr, float* odi, void* stream) {
  const DLoad load = {Pw, xr, xi, xig, inv_dt, na};
  const PlanesStore pl = {{{nwr, nwi, ndr, ndi}, {owr, owi, odr, odi}}};
  cudaStream_t st = (cudaStream_t)stream;
  if (derivative)
    return run_planes<2>(load, pl, rows, logM1, logM2, start, L, (float2*)Y,
                         ychunk, st);
  return run_planes<1>(load, pl, rows, logM1, logM2, start, L, (float2*)Y,
                       ychunk, st);
}

// Kernel E. Zr, Zi: (rows, K1, M2); nr, ni: (rows,); Y: scratch of
// ychunk*M float2 (the caller sizes the chunk as D's, so that Y stays in
// L2). Returns cudaGetLastError() after the launches.
extern "C" int ssq_ifft_halfband(const float* Zr, const float* Zi,
                                 const float* nr, const float* ni,
                                 long long rows, int logM1, int logM2,
                                 int start, int L, void* Y, long long ychunk,
                                 float* outr, float* outi, void* stream) {
  const PlanesStore pl = {
      {{nr, ni, nullptr, nullptr}, {outr, outi, nullptr, nullptr}}};
  return run_planes<1>(ELoad{Zr, Zi}, pl, rows, logM1, logM2, start, L,
                       (float2*)Y, ychunk, (cudaStream_t)stream);
}

// Kernel A: D's launch pair with the derivative, A's loader (D's) and the
// phase store. Y: scratch of 2*ychunk*M float2 (the caller sizes the chunk
// as D's, so that Y stays in L2); outputs (rows, L). Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int ssq_cwt_phase(const float* Pw, const float* xr,
                             const float* xi, const float* xig, float inv_dt,
                             const float* nwr, const float* nwi,
                             const float* ndr, const float* ndi,
                             long long rows, int na, int logM1, int logM2,
                             int start, int L, float gamma2, void* Y,
                             long long ychunk, float* owr, float* owi,
                             float* ow, void* stream) {
  const ALoad load = {{Pw, xr, xi, xig, inv_dt, na}};
  const PhaseStore ps = {nwr, nwi, ndr, ndi, gamma2, owr, owi, ow};
  return run_planes<2>(load, ps, rows, logM1, logM2, start, L, (float2*)Y,
                       ychunk, (cudaStream_t)stream);
}
