// Kernels C and C': the reassignment's VJP gather, for sm_90a.
//
// Replace ssqueeze_rs_tpu/ops/reassign_pallas.py::_make_bwd_kernel (driven
// by _reassign_bwd_2d and _reassign_bwd) in the two input contracts of
// kernels B and B' (reassign.cu):
//   C  (phase_in=True, 3 planes): bins from the phase plane w, +inf =
//      masked; the Wx planes are not read
//   C' (phase_in=False, 4 planes): bins from Wx and dWx through bins.cuh
//      phase_w, for the CWT or the STFT phase transform
// For every entry (i, j):
//
//   k = bin(w[i,j])                       bins.cuh, as B, B' and G bin it
//   gWr[i,j] = const[i] * gTxr[k, j]      0 where k = -1 (masked)
//   gWi[i,j] = const[i] * gTxi[k, j]
//
// The bins are piecewise constant in the inputs, so the cotangent flows
// only through the values B scattered; w, dWx, const and Sfs get zero (the
// wrapper returns those). C calls the same device functions as the forward
// kernels (ssq::phase_w, ssq::bin_of), so it rounds log2 and every division
// the same way and reads exactly the bin the forward scattered to.
//
// Design: one thread per entry, j fastest across a warp, one block row per
// (row i, signal): the w plane (or the four planes) is read and the two gW
// planes written coalesced, and each output is one product, so there are
// no sums, no atomics and the result is bitwise the same from run to run.
//
// What bounds it: memory traffic. At the ssq_cwt headline (293 x 160 000)
// it reads the w plane (187 MB) and writes the two gW planes (375 MB); the
// gather of gTx[k, j] costs one 32-byte sector per entry wherever
// neighbouring columns bin to different rows (up to ~3 GB of sectors on
// white noise, much less on a tone, where a warp's columns share a row).
// The design leaves the gather to L2 and the sector granularity; staging a
// column tile of gTx in shared memory would bound it at the plane sizes.

#include <cuda_runtime.h>

#include "bins.cuh"

namespace {

using ssq::Plan;

constexpr int kThreads = 256;     // columns per block

// kPlanes = 3: p0 is the w plane (p1..p3 unused); kPlanes = 4: p0, p1 are
// Wx and p2, p3 dWx.
template <int kPlanes>
__global__ void __launch_bounds__(kThreads)
reassign_bwd_kernel(const float* __restrict__ p0, const float* __restrict__ p1,
                    const float* __restrict__ p2, const float* __restrict__ p3,
                    const float* __restrict__ cst, const float* __restrict__ sfs,
                    int na, long long n, Plan P, int transform, float gamma2,
                    const float* __restrict__ gr, const float* __restrict__ gi,
                    float* __restrict__ gwr, float* __restrict__ gwi) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const int i = blockIdx.y;
  const long long bat = blockIdx.z;
  const long long o = (bat * na + i) * n + j;
  const float w = (kPlanes == 4)
      ? ssq::phase_w(p0[o], p1[o], p2[o], p3[o], sfs[i], gamma2, transform)
      : p0[o];
  const int k = ssq::bin_of(w, P);
  float vr = 0.f, vi = 0.f;
  if (k >= 0) {
    const long long g = (bat * P.nf + k) * n + j;
    const float c = cst[i];
    vr = __fmul_rn(gr[g], c);
    vi = __fmul_rn(gi[g], c);
  }
  gwr[o] = vr;
  gwi[o] = vi;
}

template <int kPlanes>
int launch(const float* p0, const float* p1, const float* p2, const float* p3,
           const float* cst, const float* sfs, int batch, int na, long long n,
           const Plan& P, int transform, float gamma2, const float* gr,
           const float* gi, float* gwr, float* gwi, void* stream) {
  if (na > 65535 || batch > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)na,
                  (unsigned)batch);
  reassign_bwd_kernel<kPlanes><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      p0, p1, p2, p3, cst, sfs, na, n, P, transform, gamma2, gr, gi, gwr,
      gwi);
  return (int)cudaGetLastError();
}

}  // namespace

// w: (batch, na, n) phase plane; gr, gi: (batch, nf, n) cotangents of Tx;
// gwr, gwi: (batch, na, n) cotangents of Wx. Row-major float32. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ssq_reassign_bwd(const float* w, const float* cst, int batch,
                                int na, long long n, int nf, int mode,
                                int flipud, float p0, float p1, float p2,
                                float p3, float p4, const float* gr,
                                const float* gi, float* gwr, float* gwi,
                                void* stream) {
  const Plan P{mode, flipud, nf, p0, p1, p2, p3, p4};
  return launch<3>(w, nullptr, nullptr, nullptr, cst, nullptr, batch, na, n,
                   P, ssq::kCwt, 0.f, gr, gi, gwr, gwi, stream);
}

// wr, wi, dr, di: (batch, na, n) Wx and dWx planes; the rest as above.
extern "C" int ssq_reassign4_bwd(const float* wr, const float* wi,
                                 const float* dr, const float* di,
                                 const float* cst, const float* sfs,
                                 int batch, int na, long long n, int nf,
                                 int transform, int mode, int flipud,
                                 float gamma2, float p0, float p1, float p2,
                                 float p3, float p4, const float* gr,
                                 const float* gi, float* gwr, float* gwi,
                                 void* stream) {
  const Plan P{mode, flipud, nf, p0, p1, p2, p3, p4};
  return launch<4>(wr, wi, dr, di, cst, sfs, batch, na, n, P, transform,
                   gamma2, gr, gi, gwr, gwi, stream);
}
