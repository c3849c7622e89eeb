// Probe P4: the ablation of the row walk, the design kernels B and B'
// (the reassignment scatter of csrc/reassign.cu) ran before their
// redesign, and its batch grid modes, for sm_90a.
//
// Replaces the TPU probes tools/ablate_reassign.py::_make_kernel (its
// pallas_call at :225: the Pallas scatter with parts stripped) and
// tools/bench_reassign_batch.py::grid3d (:134: the production scatter on a
// flattened batch grid). It instantiates the row walk (reassign_walk.cuh:
// one thread a column, one warp a block) with a variant V. Its `full` is
// the old B' (4 planes) and, through ssq_ablate_reassign3, the old B (3
// planes); the redesigned B and B' give the same Tx bit for bit:
//
//   full     the row walk itself (32, 16 or 8 columns a block, the
//            caller's choice)
//   dmaonly  the four planes read, two zero Tx planes written
//   binonly  w and the bin of every entry; one row out per plane: the sum
//            of the unmasked bins (Txr) and their count (Txi)
//   addonly  Wx * const added into row i % nf in row order: no phase, no
//            bin, no mask (dWx still read): the shared-memory
//            read-modify-write rate of the row walk
//   chains2  even and odd rows into two accumulators, summed at the end
//
// Grid modes of `full` over a (batch, na, n) batch: the batch on
// blockIdx.y or one 1-D grid of batch * ceil(n / cols) blocks; the third
// mode, one call over (na, batch * n) columns, is the launch at batch 1 on
// relaid planes (the wrapper's). The scatter is column-local, so the
// three give the same bits.
//
// The TPU probe's cmponly, groupG and overlap variants ask about its
// one-hot compare and VMEM traffic, which this kernel does not have.
//
// What bounds it: as B', the four planes read once and the two Tx planes
// written once (0.34 ms at 293 x 160 000 on an H100 at 3.35 TB/s); the
// variants split the 1.7 ms the row walk takes between the loads
// (dmaonly), the phase and bin arithmetic (binonly), the shared-memory
// accumulate (addonly) and its dependency chain (chains2).

#include <cuda_runtime.h>
#include <math.h>

#include "reassign_walk.cuh"

namespace {

template <int COLS, int V>
int launch_mode(int grid1d, const float* wr, const float* wi, const float* dr,
                const float* di, const float* cst, const float* sfs,
                int batch, int na, long long n, const Plan& P, int transform,
                float gamma2, float* txr, float* txi, cudaStream_t s) {
  if (grid1d) {
    if (V != kRFull) return (int)cudaErrorInvalidValue;
    return launch_walk<COLS, 4, kRFull, true>(wr, wi, dr, di, cst, sfs,
                                              batch, na, n, P, transform,
                                              gamma2, txr, txi, s);
  }
  return launch_walk<COLS, 4, V, false>(wr, wi, dr, di, cst, sfs, batch, na,
                                        n, P, transform, gamma2, txr, txi, s);
}

template <int COLS>
int launch_variant(int variant, int grid1d, const float* wr, const float* wi,
                   const float* dr, const float* di, const float* cst,
                   const float* sfs, int batch, int na, long long n,
                   const Plan& P, int transform, float gamma2, float* txr,
                   float* txi, cudaStream_t s) {
#define SSQ_VARIANT(V)                                                      \
  case V:                                                                   \
    return launch_mode<COLS, V>(grid1d, wr, wi, dr, di, cst, sfs, batch,   \
                                na, n, P, transform, gamma2, txr, txi, s);
  switch (variant) {
    SSQ_VARIANT(kRFull)
    SSQ_VARIANT(kRDmaOnly)
    SSQ_VARIANT(kRBinOnly)
    SSQ_VARIANT(kRAddOnly)
    SSQ_VARIANT(kRChains2)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SSQ_VARIANT
}

}  // namespace

// Planes are (batch, na, n) float32, row-major; Tx (batch, nf, n), or
// (batch, 1, n) for binonly. variant: 0 full, 1 dmaonly, 2 binonly,
// 3 addonly, 4 chains2; grid1d (full only): the batch folded into
// blockIdx.x; cols: 32, 16 or 8 columns (= threads) a block, whose
// accumulator (chains2: two) must fit shared memory. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ssq_ablate_reassign(const float* wr, const float* wi,
                                   const float* dr, const float* di,
                                   const float* cst, const float* sfs,
                                   int batch, int na, long long n, int nf,
                                   int transform, int mode, int flipud,
                                   float gamma2, float p0, float p1, float p2,
                                   float p3, float p4, int cols, int variant,
                                   int grid1d, float* txr, float* txi,
                                   void* stream) {
  const Plan P{mode, flipud, nf, p0, p1, p2, p3, p4};
  cudaStream_t s = (cudaStream_t)stream;
  switch (cols) {
    case 32: return launch_variant<32>(variant, grid1d, wr, wi, dr, di, cst,
                                       sfs, batch, na, n, P, transform,
                                       gamma2, txr, txi, s);
    case 16: return launch_variant<16>(variant, grid1d, wr, wi, dr, di, cst,
                                       sfs, batch, na, n, P, transform,
                                       gamma2, txr, txi, s);
    case 8: return launch_variant<8>(variant, grid1d, wr, wi, dr, di, cst,
                                     sfs, batch, na, n, P, transform, gamma2,
                                     txr, txi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// `full` at 3 planes (the old B): Wx and the w plane, +inf where masked;
// the arguments of ssq_reassign (cols: 32, 16 or 8).
extern "C" int ssq_ablate_reassign3(const float* wr, const float* wi,
                                    const float* w, const float* cst,
                                    int batch, int na, long long n, int nf,
                                    int mode, int flipud, float p0, float p1,
                                    float p2, float p3, float p4, int cols,
                                    float* txr, float* txi, void* stream) {
  const Plan P{mode, flipud, nf, p0, p1, p2, p3, p4};
  cudaStream_t s = (cudaStream_t)stream;
  switch (cols) {
    case 32: return launch_walk<32, 3>(wr, wi, w, nullptr, cst, nullptr, batch,
                                       na, n, P, ssq::kCwt, 0.f, txr, txi, s);
    case 16: return launch_walk<16, 3>(wr, wi, w, nullptr, cst, nullptr, batch,
                                       na, n, P, ssq::kCwt, 0.f, txr, txi, s);
    case 8: return launch_walk<8, 3>(wr, wi, w, nullptr, cst, nullptr, batch,
                                     na, n, P, ssq::kCwt, 0.f, txr, txi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
