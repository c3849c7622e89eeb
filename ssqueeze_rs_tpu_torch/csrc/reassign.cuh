// The scatter of kernels B and B' (csrc/reassign.cu): 16 lanes a column,
// each entry loaded and binned once by one lane and added, in row order,
// by that lane.
//
// A block owns COLS consecutive columns of one batch item (the batch on
// blockIdx.y) and has 16 * COLS threads. Lane l of warp w is thread (c, g)
// with c = 2 * w + l % 2, the block's column, and g = l / 2, its row
// group: a warp covers 2 columns and 16 rows at a step. The block keeps a
// (2, nf, COLS) float accumulator in shared memory, the entry of bin k and
// column c at column c ^ (k mod COLS) of row k (the lanes of one column
// that add to different bins in one round then hit different banks).
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

using ssq::Plan;

constexpr int kLanes = 16;             // lanes a column (G)
constexpr int kWarpCols = 32 / kLanes;  // columns a warp covers

// Offset of bin k, column c in one accumulator plane.
template <int COLS>
__device__ __forceinline__ int acc_at(int k, int c) {
  return k * COLS + (c ^ (k & (COLS - 1)));
}

// kPlanes = 3: p2 is the w plane (+inf where masked); kPlanes = 4: p2, p3
// are dWx, and w and the mask |Wx|^2 > gamma^2 are formed here.
template <int COLS, int kPlanes>
__global__ void __launch_bounds__(COLS * kLanes)
reassign_kernel(const float* __restrict__ wr, const float* __restrict__ wi,
                const float* __restrict__ p2, const float* __restrict__ p3,
                const float* __restrict__ cst, const float* __restrict__ sfs,
                int na, long long n, Plan P, int transform, float gamma2,
                float* __restrict__ txr, float* __restrict__ txi) {
  static_assert(COLS % kWarpCols == 0, "plan");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);  // [2][nf][COLS]
  const int nf = P.nf;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane / kWarpCols;
  const int c = (tid >> 5) * kWarpCols + lane % kWarpCols;
  const long long j0 = (long long)blockIdx.x * COLS;
  const long long bat = blockIdx.y;
  const bool live = j0 + c < n;
  float* acc_i = acc + (long long)nf * COLS;

  for (int e = tid; e < 2 * nf * COLS; e += COLS * kLanes) acc[e] = 0.f;
  __syncthreads();

  const long long base = bat * na * n + j0 + c;
  float vr = 0.f, vi = 0.f, va = 0.f, vb = 0.f;
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
    float pr = 0.f, pi = 0.f;
    if (live && i < na) {
      const float w = (kPlanes == 4)
          ? ssq::phase_w(vr, vi, va, vb, sfs[i], gamma2, transform)
          : va;
      k = ssq::bin_of(w, P);
      const float cc = cst[i];
      pr = __fmul_rn(vr, cc);
      pi = __fmul_rn(vi, cc);
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

  // every thread stores: a warp writes COLS consecutive floats of Tx rows
  const long long ob = bat * nf * n + j0;
  for (int e = tid; e < nf * COLS; e += COLS * kLanes) {
    const int kk = e / COLS, cc = e % COLS;
    if (j0 + cc < n) {
      txr[ob + (long long)kk * n + cc] = acc[acc_at<COLS>(kk, cc)];
      txi[ob + (long long)kk * n + cc] = acc_i[acc_at<COLS>(kk, cc)];
    }
  }
}

// One launch over planes (batch, na, n) into Tx planes (batch, nf, n).
template <int COLS, int kPlanes>
int launch(const float* wr, const float* wi, const float* p2, const float* p3,
           const float* cst, const float* sfs, int batch, int na, long long n,
           const Plan& P, int transform, float gamma2, float* txr, float* txi,
           cudaStream_t stream) {
  const size_t smem = (size_t)2 * P.nf * COLS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      reassign_kernel<COLS, kPlanes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + COLS - 1) / COLS), (unsigned)batch);
  reassign_kernel<COLS, kPlanes>
      <<<grid, COLS * kLanes, smem, stream>>>(wr, wi, p2, p3, cst, sfs, na, n,
                                              P, transform, gamma2, txr, txi);
  return (int)cudaGetLastError();
}

}  // namespace
