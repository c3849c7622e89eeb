// Kernels B and B': analytic frequency binning + deterministic
// reassignment (synchrosqueezing scatter) for sm_90a.
//
// Replace ssqueeze_rs_tpu/ops/reassign_pallas.py::_make_kernel in its two
// input contracts (binning in _bin_indices):
//   B  (phase_in=True, 3 planes): Wx and the phase plane w, +inf = masked
//   B' (phase_in=False, 4 planes): Wx and dWx; w and the mask
//      |Wx|^2 > gamma^2 are formed here (bins.cuh phase_w), for the STFT
//      (w = |Sfs - Im(dWx/Wx)/2pi|) or the CWT (w = |Im(dWx/Wx)/2pi|)
// For each column j and each row i in fixed order 0..na-1:
//
//   k = bin(w[i,j])   log / log-piecewise / lin closed form (bins.cuh)
//   Tx[k, j] += (Wxr[i,j] * const[i], Wxi[i,j] * const[i])
//
// A block owns COLS columns and 16 lanes a column (thread (c, g)); a warp
// covers 2 columns and 16 rows at a step. Each lane loads one entry of its
// column (row i0 + g), forms its bin and products once and adds them
// itself to the block's shared-memory (2, nf, COLS) accumulator. Lanes
// whose entries share a (bin, column) find each other with
// __match_any_sync and add in rounds by row, one __syncwarp apart, so
// every (bin, column) sum takes its adds in row order from zero: no
// atomics, the same bits from run to run, and the same bits as the row
// walk these kernels ran before (reassign_walk.cuh, probe P4's subject).
// The block then stores its columns with all its threads. COLS comes from
// nf alone (reassign_cuda._block_cols): 32 where the accumulator fits
// 227 KB (nf <= 908), else 8, so any nf up to 3632 launches (the TPU
// kernel's (nf, 512) accumulator lives in VMEM and has no such bound).
//
// What bounds it on Hopper: the bytes (three or four planes read once,
// two written once: 0.28 / 0.34 ms at 293 x 160 000 at 3.35 TB/s) once
// enough loads are in flight. The row walk held one warp a block, and its
// 75 KB accumulator at nf = 293 let 3 blocks share an SM: 3 warps, each
// entry a serial chain of load, bin and a shared read-modify-write at an
// address the bin picks. Here the same accumulator carries 16 warps a
// block (48 an SM at nf = 293), each entry is binned by its own lane
// instead of in one thread's chain, a step's rows go into the accumulator
// in one round unless two of them share a bin, and each lane keeps the
// loads of the next rows in flight while it adds the current ones. The
// products are rounded as in the reference (value = Wx * const, then
// added), so the sum order is the only freedom and it is fixed. The
// banded variant of the reference (_band_mode) is later work.

#include <cuda_runtime.h>
#include <math.h>

#include "reassign.cuh"

namespace {

template <int kPlanes>
int dispatch(int cols, const float* wr, const float* wi, const float* p2,
             const float* p3, const float* cst, const float* sfs, int batch,
             int na, long long n, const Plan& P, int transform, float gamma2,
             float* txr, float* txi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (cols) {
    case 32: return launch<32, kPlanes>(wr, wi, p2, p3, cst, sfs, batch, na,
                                        n, P, transform, gamma2, txr, txi, s);
    case 8: return launch<8, kPlanes>(wr, wi, p2, p3, cst, sfs, batch, na, n,
                                      P, transform, gamma2, txr, txi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Planes are (batch, na, n) and (batch, nf, n), row-major float32; cols
// (32 or 8) is the columns a block the wrapper chose from nf.
// Return cudaGetLastError() after the launch (0 on success).
extern "C" int ssq_reassign(const float* wr, const float* wi, const float* w,
                            const float* cst, int batch, int na, long long n,
                            int nf, int mode, int flipud, float p0, float p1,
                            float p2, float p3, float p4, int cols,
                            float* txr, float* txi, void* stream) {
  const Plan P{mode, flipud, nf, p0, p1, p2, p3, p4};
  return dispatch<3>(cols, wr, wi, w, nullptr, cst, nullptr, batch, na, n, P,
                     ssq::kCwt, 0.f, txr, txi, stream);
}

extern "C" int ssq_reassign4(const float* wr, const float* wi,
                             const float* dr, const float* di,
                             const float* cst, const float* sfs, int batch,
                             int na, long long n, int nf, int transform,
                             int mode, int flipud, float gamma2, float p0,
                             float p1, float p2, float p3, float p4, int cols,
                             float* txr, float* txi, void* stream) {
  const Plan P{mode, flipud, nf, p0, p1, p2, p3, p4};
  return dispatch<4>(cols, wr, wi, dr, di, cst, sfs, batch, na, n, P,
                     transform, gamma2, txr, txi, stream);
}

extern "C" const char* ssq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
