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

// kPlanes = 3: p2 is the w plane (+inf where masked); kPlanes = 4: p2, p3
// are dWx, and w and the mask |Wx|^2 > gamma^2 are formed here.
template <typename T, int COLS, int kPlanes>
__global__ void __launch_bounds__(COLS * kLanes)
reassign_kernel(const T* __restrict__ wr, const T* __restrict__ wi,
                const T* __restrict__ p2, const T* __restrict__ p3,
                const T* __restrict__ cst, const T* __restrict__ sfs,
                int na, long long n, PlanT<T> P, int transform, T gamma2,
                int k0, int nk, T* __restrict__ txr, T* __restrict__ txi) {
  static_assert(COLS % kWarpCols == 0, "plan");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);  // [2][nk][COLS]
  const int nf = P.nf;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane / kWarpCols;
  const int c = (tid >> 5) * kWarpCols + lane % kWarpCols;
  const long long j0 = (long long)blockIdx.x * COLS;
  const long long bat = blockIdx.y;
  const bool live = j0 + c < n;
  T* acc_i = acc + (long long)nk * COLS;

  for (int e = tid; e < 2 * nk * COLS; e += COLS * kLanes) acc[e] = T(0);
  __syncthreads();

  const long long base = bat * na * n + j0 + c;
  T vr = T(0), vi = T(0), va = T(0), vb = T(0);
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
      const T w = (kPlanes == 4)
          ? ssq::phase_w(vr, vi, va, vb, sfs[i], gamma2, transform)
          : va;
      k = ssq::bin_of(w, P);
      k = k >= k0 && k < k0 + nk ? k - k0 : -1;   // this launch's range
      const T cc = cst[i];
      pr = ssq::mul_rn(vr, cc);
      pi = ssq::mul_rn(vi, cc);
    }
    // the next step's loads go out before this one's adds
    const int in = i + kLanes;
    if (live && in < na) {
      const long long o = base + (long long)in * n;
      vr = wr[o];
      vi = wi[o];
      va = p2[o];
      if (kPlanes == 4) vb = p3[o];
    }
    // the lanes of one (bin, column) add in rounds by row: a lane's rank
    // is the count of lower lanes (lower rows) in its group
    const int key = k >= 0 ? k * COLS + c : -1 - lane;
    const unsigned same = __match_any_sync(0xffffffffu, key);
    const int rank = __popc(same & ((1u << lane) - 1u));
    const int rounds = __reduce_max_sync(0xffffffffu, rank);
    for (int r = 0; r <= rounds; ++r) {
      if (rank == r && k >= 0) {
        const int a = acc_at<COLS>(k, c);
        acc[a] += pr;
        acc_i[a] += pi;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // every thread stores: a warp writes COLS consecutive entries of Tx rows
  const long long ob = bat * nf * n + (long long)k0 * n + j0;
  for (int e = tid; e < nk * COLS; e += COLS * kLanes) {
    const int kk = e / COLS, cc = e % COLS;
    if (j0 + cc < n) {
      txr[ob + (long long)kk * n + cc] = acc[acc_at<COLS>(kk, cc)];
      txi[ob + (long long)kk * n + cc] = acc_i[acc_at<COLS>(kk, cc)];
    }
  }
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
