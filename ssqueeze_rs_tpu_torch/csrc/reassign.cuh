// The scatter of kernels B and B' (csrc/reassign.cu): 16 lanes a column,
// each entry loaded and binned once by one lane and added, in row order,
// by that lane.
//
// A block owns COLS consecutive columns of one batch item (the batch on
// blockIdx.y) and has 16 * COLS threads. A launch sums the bins of one
// range [k0, k0 + nk) of [0, nf): every entry is binned over all nf bins
// (clamped and flipped as bins.cuh does), and only an entry whose final
// bin falls in the range is added, at row k - k0; the launch writes Tx
// rows k0 .. k0 + nk - 1. So a call split into ranges adds each Tx entry's
// rows in the order one launch would. Lane l of warp w is thread (c, g)
// with c = 2 * w + l % 2, the block's column, and g = l / 2, its row
// group: a warp covers 2 columns and 16 rows at a step. The block keeps a
// (2, nk, COLS) accumulator of the planes' type T (float: reassign.cu
// instantiates it for float32 planes only; float64 planes run
// reassign64.cu) in shared memory, the entry of bin k and column c at
// column c ^ (k mod COLS) of row k (the lanes of one column that add to
// different bins in one round then hit different 4-byte banks).
//
// A step takes rows i0 .. i0 + 15: thread (c, g) loads row i0 + g of
// column c (every plane) and forms its bin and its two products once.
// Lanes whose entries share a (bin, column) find each other with
// __match_any_sync, each takes the rank of its row among them, and the
// warp adds in rounds: in round r the lanes of rank r add their entries,
// then __syncwarp. So every (bin, column) sum takes its adds in
// increasing row order from zero, the same adds in the same order as the
// row walk (reassign_walk.cuh), with no atomics and no block barrier
// inside the walk; a step whose rows all land in different bins takes
// one round. The loads of the next step go out before this step's bins
// and adds.
//
// The scatter of one block is reassign_block, templated on ablation flags
// V (ReassignAblate): B and B' (reassign_kernel) run it with none, probe
// P4 (ablate_reassign.cu) with each flag set, so P4's `full` is this
// kernel's code and each flag takes one part of it out.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "bins.cuh"

namespace {

using ssq::PlanT;

constexpr int kLanes = 16;             // lanes a column (G)
constexpr int kWarpCols = 32 / kLanes;  // columns a warp covers

// Offset of bin k, column c in one accumulator plane.
template <int COLS>
__device__ __forceinline__ int acc_at(int k, int c) {
  return k * COLS + (c ^ (k & (COLS - 1)));
}

// Ablation flags of the scatter (probe P4, csrc/ablate_reassign.cu): each
// takes out or reorders one part of it. The path's kernel below runs the
// scatter with none (0), and the flags must add nothing to its code
// (tools/sass_compare.py holds B's and B''s SASS to a parent tree's).
enum ReassignAblate : unsigned {
  kRaDmaOnly = 1u,     // every plane read (values kept alive through
                       // `sink`), no phase, bin or add: zero Tx stored
  kRaBinOnly = 2u,     // w and the bin of every entry, no add; one row out:
                       // the column's sum of unmasked bins and their count
  kRaAddOnly = 4u,     // Wx * const into row i % nf in the rounds by row:
                       // no phase, bin or mask (dWx read, kept alive)
  kRaChains2 = 8u,     // even and odd rows into two accumulators (their own
                       // keys in the match), summed at the store
  kRaSerial = 16u,     // 16 rounds a step, one row group a round: no
                       // __match_any_sync, no __reduce_max_sync
  kRaLateLoad = 32u,   // the next step's loads issued after the adds
  kRaOneStore = 64u,   // Tx of one column a block stored: (nk, tiles)
  kRaRowLoads = 128u,  // with kRaDmaOnly: thread (c, g) = (tid % COLS,
                       // tid / COLS), so a warp load reads whole rows of
                       // the block's columns (one 128-byte line at 32)
};

// Accumulator sets (of 2 * nk * COLS values) a flag set keeps.
__host__ __device__ constexpr int reassign_sets(unsigned V) {
  return (V & kRaChains2) ? 2 : 1;
}

// The scatter of one block: COLS columns of column tile `tile` of batch
// item `bat`. kPlanes = 3: p2 is the w plane (+inf where masked);
// kPlanes = 4: p2, p3 are dWx, and w and the mask |Wx|^2 > gamma^2 are
// formed here. V: the ablation flags (0 on the path); `sink` (0 in every
// call) is read only by the flag sets that drop values they load: a store
// under it keeps those loads.
template <typename T, int COLS, int kPlanes, unsigned V>
__device__ __forceinline__ void reassign_block(
    const T* __restrict__ wr, const T* __restrict__ wi,
    const T* __restrict__ p2, const T* __restrict__ p3,
    const T* __restrict__ cst, const T* __restrict__ sfs, int na,
    long long n, const PlanT<T>& P, int transform, T gamma2, int k0, int nk,
    T* __restrict__ txr, T* __restrict__ txi, long long tile, long long bat,
    int sink) {
  static_assert(COLS % kWarpCols == 0, "plan");
  constexpr bool kDma = V & kRaDmaOnly, kBins = V & kRaBinOnly,
                 kAddOnly = V & kRaAddOnly, kChains = V & kRaChains2,
                 kSerial = V & kRaSerial, kLate = V & kRaLateLoad,
                 kOneStore = V & kRaOneStore, kRows = V & kRaRowLoads;
  constexpr bool kAdds = !kDma && !kBins;     // the rounds run
  constexpr int kSets = reassign_sets(V);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);  // [kSets][2][nk][COLS]
  const int nf = P.nf;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = kRows ? tid / COLS : lane / kWarpCols;
  const int c = kRows ? tid % COLS
                      : (tid >> 5) * kWarpCols + lane % kWarpCols;
  const long long j0 = tile * COLS;
  const bool live = j0 + c < n;
  T* acc_i = acc + (long long)nk * COLS;

  if constexpr (!kBins) {
    for (int e = tid; e < kSets * 2 * nk * COLS; e += COLS * kLanes)
      acc[e] = T(0);
    __syncthreads();
  }

  const long long base = bat * na * n + j0 + c;
  T vr = T(0), vi = T(0), va = T(0), vb = T(0);
  T held = T(0), kbins = T(0), kcount = T(0);   // the flag sets' values
  if (live && g < na) {
    vr = wr[base + (long long)g * n];
    vi = wi[base + (long long)g * n];
    va = p2[base + (long long)g * n];
    if (kPlanes == 4) vb = p3[base + (long long)g * n];
  }
  for (int i0 = 0; i0 < na; i0 += kLanes) {
    // this step's entry: its bin and products
    const int i = i0 + g;
    int k = -1;
    T pr = T(0), pi = T(0);
    if (live && i < na) {
      if constexpr (kDma) {
        held += vr + vi + va + (kPlanes == 4 ? vb : T(0));
      } else if constexpr (kAddOnly) {
        k = i % nf;
        k = k >= k0 && k < k0 + nk ? k - k0 : -1;
        const T cc = cst[i];
        pr = ssq::mul_rn(vr, cc);
        pi = ssq::mul_rn(vi, cc);
        held += va + (kPlanes == 4 ? vb : T(0));
      } else {
        const T w = (kPlanes == 4)
            ? ssq::phase_w(vr, vi, va, vb, sfs[i], gamma2, transform)
            : va;
        k = ssq::bin_of(w, P);
        if constexpr (kBins) {
          if (k >= 0) {
            kbins += (T)k;
            kcount += T(1);
          }
        } else {
          k = k >= k0 && k < k0 + nk ? k - k0 : -1;   // this launch's range
          const T cc = cst[i];
          pr = ssq::mul_rn(vr, cc);
          pi = ssq::mul_rn(vi, cc);
        }
      }
    }
    // the next step's loads go out before this one's adds
    const int in = i + kLanes;
    if (!kLate && live && in < na) {
      const long long o = base + (long long)in * n;
      vr = wr[o];
      vi = wi[o];
      va = p2[o];
      if (kPlanes == 4) vb = p3[o];
    }
    if constexpr (kAdds && kSerial) {
      // one row group a round, in row order
      for (int r = 0; r < kLanes; ++r) {
        if (g == r && k >= 0) {
          const int a = acc_at<COLS>(k, c);
          acc[a] += pr;
          acc_i[a] += pi;
        }
        __syncwarp();
      }
    } else if constexpr (kAdds) {
      // the lanes of one (bin, column) add in rounds by row: a lane's rank
      // is the count of lower lanes (lower rows) in its group
      const int s = kChains ? (g & 1) : 0;    // i's parity: i0 % 16 == 0
      const int key = k >= 0 ? (k * kSets + s) * COLS + c : -1 - lane;
      const unsigned same = __match_any_sync(0xffffffffu, key);
      const int rank = __popc(same & ((1u << lane) - 1u));
      const int rounds = __reduce_max_sync(0xffffffffu, rank);
      for (int r = 0; r <= rounds; ++r) {
        if (rank == r && k >= 0) {
          const int a = acc_at<COLS>(k, c) + s * 2 * nk * COLS;
          acc[a] += pr;
          acc_i[a] += pi;
        }
        __syncwarp();
      }
    }
    if (kLate && live && in < na) {
      const long long o = base + (long long)in * n;
      vr = wr[o];
      vi = wi[o];
      va = p2[o];
      if (kPlanes == 4) vb = p3[o];
    }
  }
  if constexpr (kBins) {
    // the column's 16 lanes (one parity of the warp's lanes) sum their
    // counts; integers below 2^24, so any order gives the same bits
    for (int off = 16; off >= kWarpCols; off >>= 1) {
      kbins += __shfl_xor_sync(0xffffffffu, kbins, off);
      kcount += __shfl_xor_sync(0xffffffffu, kcount, off);
    }
    if (g == 0 && live) {
      txr[bat * n + j0 + c] = kbins;
      txi[bat * n + j0 + c] = kcount;
    }
    return;
  }
  __syncthreads();

  if constexpr (kOneStore) {
    // column 0 of the block's tile only, into (batch, nf, tiles)
    const long long tiles = (n + COLS - 1) / COLS;
    const long long ob = (bat * nf + k0) * tiles + tile;
    for (int kk = tid; kk < nk; kk += COLS * kLanes) {
      txr[ob + kk * tiles] = acc[acc_at<COLS>(kk, 0)];
      txi[ob + kk * tiles] = acc_i[acc_at<COLS>(kk, 0)];
    }
    return;
  }
  // every thread stores: a warp writes COLS consecutive entries of Tx rows
  const long long ob = bat * nf * n + (long long)k0 * n + j0;
  for (int e = tid; e < nk * COLS; e += COLS * kLanes) {
    const int kk = e / COLS, cc = e % COLS;
    if (j0 + cc < n) {
      T r = acc[acc_at<COLS>(kk, cc)], m = acc_i[acc_at<COLS>(kk, cc)];
      if constexpr (kChains) {
        const long long set = 2LL * nk * COLS;
        r = ssq::add_rn(r, acc[set + acc_at<COLS>(kk, cc)]);
        m = ssq::add_rn(m, acc_i[set + acc_at<COLS>(kk, cc)]);
      }
      txr[ob + (long long)kk * n + cc] = r;
      txi[ob + (long long)kk * n + cc] = m;
    }
  }
  if constexpr (kDma || kAddOnly) {
    if (sink) txr[ob] = held;
  }
}

// Kernels B and B': the scatter with no ablation flag, the batch on
// blockIdx.y.
template <typename T, int COLS, int kPlanes>
__global__ void __launch_bounds__(COLS * kLanes)
reassign_kernel(const T* __restrict__ wr, const T* __restrict__ wi,
                const T* __restrict__ p2, const T* __restrict__ p3,
                const T* __restrict__ cst, const T* __restrict__ sfs,
                int na, long long n, PlanT<T> P, int transform, T gamma2,
                int k0, int nk, T* __restrict__ txr, T* __restrict__ txi) {
  reassign_block<T, COLS, kPlanes, 0u>(wr, wi, p2, p3, cst, sfs, na, n, P,
                                       transform, gamma2, k0, nk, txr, txi,
                                       blockIdx.x, blockIdx.y, 0);
}

// One launch over planes (batch, na, n) into rows k0 .. k0 + nk - 1 of Tx
// planes (batch, nf, n).
template <typename T, int COLS, int kPlanes>
int launch(const T* wr, const T* wi, const T* p2, const T* p3, const T* cst,
           const T* sfs, int batch, int na, long long n, const PlanT<T>& P,
           int transform, T gamma2, int k0, int nk, T* txr, T* txi,
           cudaStream_t stream) {
  if (k0 < 0 || nk < 1 || k0 + nk > P.nf) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * nk * COLS * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      reassign_kernel<T, COLS, kPlanes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + COLS - 1) / COLS), (unsigned)batch);
  reassign_kernel<T, COLS, kPlanes>
      <<<grid, COLS * kLanes, smem, stream>>>(wr, wi, p2, p3, cst, sfs, na, n,
                                              P, transform, gamma2, k0, nk,
                                              txr, txi);
  return (int)cudaGetLastError();
}

}  // namespace
