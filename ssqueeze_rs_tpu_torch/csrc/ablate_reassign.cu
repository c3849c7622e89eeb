// Probe P4: the ablation of kernels B and B' (the reassignment scatter of
// csrc/reassign.cu: 16 lanes a column, rounds by row) and its batch grid
// modes, for sm_90a.
//
// Replaces the TPU probes tools/ablate_reassign.py::_make_kernel (its
// pallas_call at :225: the Pallas scatter with parts stripped) and
// tools/bench_reassign_batch.py::grid3d (:134: the production scatter on a
// flattened batch grid). It instantiates B''s own scatter
// (reassign_block of reassign.cuh) with the ablation flags V; `full` (no
// flag) is B' (4 planes) bit for bit and, through ssq_ablate_reassign3,
// B (3 planes), at 32, 16 or 8 columns a block (B's own are 32 and 8):
//
//   full        the scatter itself
//   dmaonly     the four planes read, zero Tx written
//   binonly     w and the bin of every entry, no add; one row out per
//               plane: the sum of the unmasked bins (Txr), their count
//               (Txi)
//   addonly     Wx * const added into row i % nf in the rounds by row: no
//               phase, bin or mask (dWx still read)
//   chains2     even and odd rows into two accumulators, summed at the end
//   serial      16 rounds a step, one row group a round, in place of
//               __match_any_sync and __reduce_max_sync: full bit for bit
//   noprefetch  the next step's loads issued after this step's adds: full
//               bit for bit
//   nostore     Tx of one column a block stored, (batch, nf, tiles): the
//               store of the two Tx planes taken out
//   dmarows     dmaonly with thread (c, g) = (tid % COLS, tid / COLS): a
//               warp load reads whole rows of the block's columns (one
//               128-byte line at 32 columns) where the scatter's reads 8
//               bytes of each of 16 lines
//   walk        the row walk B and B' ran before (reassign_walk.cuh:
//               one thread a column): full bit for bit by another design
//
// Every flag set launches with full's shared memory (chains2: twice), so
// the variants run at full's blocks an SM.
//
// Grid modes of `full` over a (batch, na, n) batch: the batch on
// blockIdx.y (as B and B' take it) or one 1-D grid of batch * ceil(n /
// cols) blocks; the third mode, one call over (na, batch * n) columns, is
// the launch at batch 1 on relaid planes (the wrapper's). The scatter is
// column-local, so the three give the same bits.
//
// The TPU probe's cmponly, groupG and overlap variants ask about its
// one-hot compare and VMEM traffic, which this kernel does not have.
//
// What bounds it: as B', the four planes read once and the two Tx planes
// written once (0.34 ms at 293 x 160 000 on an H100 at 3.35 TB/s); the
// variants split B''s time between the loads (dmaonly, and dmarows on
// whole lines), the phase and bin arithmetic (binonly), the accumulate's
// rounds (addonly, serial, chains2), the overlap of the next loads
// (noprefetch) and the store (nostore).

#include <cuda_runtime.h>
#include <math.h>

#include "reassign.cuh"
#include "reassign_walk.cuh"

namespace {

enum Variant {
  kFull = 0, kDmaOnly, kBinOnly, kAddOnly, kChains2, kSerial, kNoPrefetch,
  kNoStore, kDmaRows, kWalk, kVariants
};

// The flags of each variant but the walk, in Variant order.
constexpr unsigned kFlags[kWalk] = {
    0u,         kRaDmaOnly, kRaBinOnly,  kRaAddOnly,  kRaChains2,
    kRaSerial,  kRaLateLoad, kRaOneStore, kRaDmaOnly | kRaRowLoads};

// B''s scatter under flags V over bins [0, nf); the batch on blockIdx.y,
// or folded into blockIdx.x (kGrid1d).
template <int COLS, int kPlanes, unsigned V, bool kGrid1d>
__global__ void __launch_bounds__(COLS * kLanes)
ablate_reassign_kernel(const float* __restrict__ wr,
                       const float* __restrict__ wi,
                       const float* __restrict__ p2,
                       const float* __restrict__ p3,
                       const float* __restrict__ cst,
                       const float* __restrict__ sfs, int na, long long n,
                       Plan P, int transform, float gamma2, int sink,
                       float* __restrict__ txr, float* __restrict__ txi) {
  long long tile, bat;
  if constexpr (kGrid1d) {
    const long long tiles = (n + COLS - 1) / COLS;
    bat = blockIdx.x / tiles;
    tile = blockIdx.x % tiles;
  } else {
    tile = blockIdx.x;
    bat = blockIdx.y;
  }
  reassign_block<float, COLS, kPlanes, V>(wr, wi, p2, p3, cst, sfs, na, n, P,
                                          transform, gamma2, 0, P.nf, txr,
                                          txi, tile, bat, sink);
}

template <int COLS, int kPlanes, unsigned V, bool kGrid1d>
int launch_ablate(const float* wr, const float* wi, const float* p2,
                  const float* p3, const float* cst, const float* sfs,
                  int batch, int na, long long n, const Plan& P,
                  int transform, float gamma2, float* txr, float* txi,
                  cudaStream_t s) {
  auto kernel = ablate_reassign_kernel<COLS, kPlanes, V, kGrid1d>;
  const size_t smem =
      (size_t)reassign_sets(V) * 2 * P.nf * COLS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((n + COLS - 1) / COLS);
  const dim3 grid = kGrid1d ? dim3(tiles * (unsigned)batch)
                            : dim3(tiles, (unsigned)batch);
  kernel<<<grid, COLS * kLanes, smem, s>>>(wr, wi, p2, p3, cst, sfs, na, n, P,
                                           transform, gamma2, 0, txr, txi);
  return (int)cudaGetLastError();
}

template <int COLS, int I = 0>
int launch_variant(int variant, int grid1d, const float* wr, const float* wi,
                   const float* dr, const float* di, const float* cst,
                   const float* sfs, int batch, int na, long long n,
                   const Plan& P, int transform, float gamma2, float* txr,
                   float* txi, cudaStream_t s) {
  if constexpr (I == kWalk) {
    if (variant != kWalk || grid1d) return (int)cudaErrorInvalidValue;
    return launch_walk<COLS, 4>(wr, wi, dr, di, cst, sfs, batch, na, n, P,
                                transform, gamma2, txr, txi, s);
  } else {
    if (variant != I)
      return launch_variant<COLS, I + 1>(variant, grid1d, wr, wi, dr, di, cst,
                                         sfs, batch, na, n, P, transform,
                                         gamma2, txr, txi, s);
    if (grid1d) {
      if (I != kFull) return (int)cudaErrorInvalidValue;
      return launch_ablate<COLS, 4, 0u, true>(wr, wi, dr, di, cst, sfs, batch,
                                              na, n, P, transform, gamma2,
                                              txr, txi, s);
    }
    return launch_ablate<COLS, 4, kFlags[I], false>(
        wr, wi, dr, di, cst, sfs, batch, na, n, P, transform, gamma2, txr, txi,
        s);
  }
}

}  // namespace

// Planes are (batch, na, n) float32, row-major; Tx (batch, nf, n), or
// (batch, 1, n) for binonly and (batch, nf, ceil(n / cols)) for nostore.
// variant: 0 full, 1 dmaonly, 2 binonly, 3 addonly, 4 chains2, 5 serial,
// 6 noprefetch, 7 nostore, 8 dmarows, 9 walk; grid1d (full only): the
// batch folded into blockIdx.x; cols: 32, 16 or 8 columns a block (16 lanes a column;
// the walk: one thread a column), whose accumulators (chains2: two) must
// fit shared memory. Returns cudaGetLastError() after the launch (0 on
// success).
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
  if (variant < 0 || variant >= kVariants) return (int)cudaErrorInvalidValue;
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

namespace {

template <int COLS>
int launch3(int walk, const float* wr, const float* wi, const float* w,
            const float* cst, int batch, int na, long long n, const Plan& P,
            float* txr, float* txi, cudaStream_t s) {
  if (walk)
    return launch_walk<COLS, 3>(wr, wi, w, nullptr, cst, nullptr, batch, na,
                                n, P, ssq::kCwt, 0.f, txr, txi, s);
  return launch_ablate<COLS, 3, 0u, false>(wr, wi, w, nullptr, cst, nullptr,
                                           batch, na, n, P, ssq::kCwt, 0.f,
                                           txr, txi, s);
}

}  // namespace

// The 3-plane scatter (Wx and the w plane, +inf where masked): variant 0
// `full`, B's scatter (B bit for bit), or 1 `walk`, the row walk at 3
// planes; the arguments of ssq_reassign (cols: 32, 16 or 8) over bins
// [0, nf).
extern "C" int ssq_ablate_reassign3(const float* wr, const float* wi,
                                    const float* w, const float* cst,
                                    int batch, int na, long long n, int nf,
                                    int mode, int flipud, float p0, float p1,
                                    float p2, float p3, float p4, int cols,
                                    int variant, float* txr, float* txi,
                                    void* stream) {
  const Plan P{mode, flipud, nf, p0, p1, p2, p3, p4};
  cudaStream_t s = (cudaStream_t)stream;
  if (variant != 0 && variant != 1) return (int)cudaErrorInvalidValue;
  switch (cols) {
    case 32: return launch3<32>(variant, wr, wi, w, cst, batch, na, n, P, txr,
                                txi, s);
    case 16: return launch3<16>(variant, wr, wi, w, cst, batch, na, n, P, txr,
                                txi, s);
    case 8: return launch3<8>(variant, wr, wi, w, cst, batch, na, n, P, txr,
                              txi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
