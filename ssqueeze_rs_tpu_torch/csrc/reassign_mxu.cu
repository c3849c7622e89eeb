// Kernel I: the 4-plane reassignment (synchrosqueezing scatter) as a
// digit-split one-hot matrix product on the tensor cores, for sm_90a.
//
// Replaces ssqueeze_rs_tpu/ops/reassign_pallas.py::_make_mxu_kernel (the
// SSQ_TPU_REASSIGN_IMPL=mxu forward of _reassign_with_vjp). It computes
// what kernel B' (reassign.cu, 4 planes) computes: for each column j and
// each row i, w = phase_w(Wx, dWx) and its bin k = bin_of(w) (bins.cuh,
// so the bins are B''s bit for bit; k = -1 where masked), then
//
//   Tx[k, j] += Wx[i, j] * const[i].
//
// The bin is split into digits k = 16*khi + klo, and each column's sums
// become a product of indicators:
//
//   Tx[16*f1 + f0, j] = sum_i [khi(i,j) == f1] * (v(i,j) * [klo(i,j) == f0])
//
// that is, per column, A (F1 x na, the one-hot of khi) times B (na x 16,
// v times the one-hot of klo). The TPU kernel packed 8 columns into one
// (8*F1 x na) @ (na x 128) product and pulled out the diagonal with mask
// matmuls, which its 128-lane layout needs and which does 8x the MACs.
// Here each warp owns one column and runs mma.sync.m16n8k8 TF32 tiles:
// M = 16 values of f1 (a "tile" of 256 bins), N = 8 values of f0 (two
// halves), K = 8 rows per step. The 0/1 factor is exact in TF32; v is
// split in two terms, v_hi = tf32(v) and v_lo = tf32(v - v_hi), both
// accumulated in float32, which keeps ~22 of v's 24 bits (the tensor
// cores take no float32 operands).
//
// Block: 8 warps, 8 consecutive columns (one sector of each plane row).
// The block walks the rows in stages of 32: each thread loads one entry
// of the four planes (the next stage's loads are issued before this
// stage's products), forms its bin and value into shared memory, and each
// warp then reads the two rows its lanes need per k-step (rows tig and
// tig + 4 of the fragment layout) from shared memory. A pass keeps TG
// tiles of accumulators in registers (16 floats per tile per thread);
// nf > 4 tiles (1024 bins) takes several passes, one per blockIdx.y, each
// re-reading the planes. The results leave through shared memory, so
// each stored row is 8 consecutive columns, in direct bin order (the TPU
// wrapper's un-interleave is gone).
//
// Deterministic: a fixed sequence of mma instructions, no atomics, so
// the result repeats bit for bit. Not IEEE-ordered against B' (the
// tensor cores add in their own order): held to B' by the JAX package's
// bar for I (sum-relative < 2e-5, nonzero patterns equal).
//
// What bounds it on Hopper: the function is B''s scatter, so its bound is
// B''s, its bytes (4 planes in, 2 out: 0.344 ms at 293 x 160 000 at 3.35
// TB/s); the binning's arithmetic is far below that. The tensor-core
// products are this design's own cost, not the function's: 16 mma per 8
// rows per column at nf <= 512, 15 of 16 terms of the one-hot zero, the
// bins padded to whole tiles and doubled by the split. This first, simple
// version runs at ~15 % of the bound: the fragment selects around each
// mma and two barriers per 32-row stage; wgmma and TMA are later work.
// Its time grows slowly with nf (a pass holds 4 tiles = 1024 bins), so at
// nf ~1000 it beats B', whose accumulator then leaves one block of 16
// threads per SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bins.cuh"
#include "mma.cuh"

namespace {

using ssq::Plan;
using ssq::mma_tf32;
using ssq::tf32;

constexpr int kCols = 8;       // columns per block = warps per block
constexpr int kRows = 32;      // rows per shared-memory stage
constexpr int kThreads = kCols * 32;
constexpr int kTileBins = 256; // 16 f1 x 16 f0

template <int TG>
__global__ void __launch_bounds__(kThreads)
reassign_mxu_kernel(const float* __restrict__ wr, const float* __restrict__ wi,
                    const float* __restrict__ dr, const float* __restrict__ di,
                    const float* __restrict__ cst, const float* __restrict__ sfs,
                    int na, long long n, Plan P, int transform, float gamma2,
                    int ntiles, float* __restrict__ txr,
                    float* __restrict__ txi) {
  __shared__ int sk[kRows][kCols];
  __shared__ float svr[kRows][kCols];
  __shared__ float svi[kRows][kCols];
  __shared__ float sout[2][kTileBins][kCols];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;       // groupID, thread in group
  const long long j0 = (long long)blockIdx.x * kCols;
  const int tile0 = blockIdx.y * TG;
  const long long bat = blockIdx.z;

  // loader role: this thread's entry of each stage
  const int lr = tid / kCols, lc = tid % kCols;
  const long long jl = j0 + lc;
  const long long pbase = bat * na * n + jl;

  float acc[TG][2][2][4];      // [tile][f0 half][re, im][fragment]
#pragma unroll
  for (int t = 0; t < TG; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][h][c][e] = 0.f;

  float C = 0.f, D = 0.f, A = 0.f, B = 0.f;
  auto load = [&](int i0) {
    const int i = i0 + lr;
    if (i < na && jl < n) {
      const long long o = pbase + (long long)i * n;
      C = wr[o];
      D = wi[o];
      A = dr[o];
      B = di[o];
    }
  };
  load(0);

  for (int i0 = 0; i0 < na; i0 += kRows) {
    // this thread's entry: its bin and value (k = -1, v = 0 when masked,
    // past the last row or past the last column)
    const int i = i0 + lr;
    int k = -1;
    float vr = 0.f, vi = 0.f;
    if (i < na && jl < n) {
      const float w = ssq::phase_w(C, D, A, B, sfs[i], gamma2, transform);
      k = ssq::bin_of(w, P);
      if (k >= 0) {
        const float c = cst[i];
        vr = __fmul_rn(C, c);
        vi = __fmul_rn(D, c);
      }
    }
    __syncthreads();           // the previous stage's readers are done
    sk[lr][lc] = k;
    svr[lr][lc] = vr;
    svi[lr][lc] = vi;
    __syncthreads();
    if (i0 + kRows < na) load(i0 + kRows);   // in flight during the mma

#pragma unroll
    for (int s = 0; s < kRows / 8; ++s) {
      const int r0 = s * 8 + q, r1 = r0 + 4;
      const int k0 = sk[r0][warp], k1 = sk[r1][warp];
      const float vr0 = svr[r0][warp], vr1 = svr[r1][warp];
      const float vi0 = svi[r0][warp], vi1 = svi[r1][warp];
      const int hi0 = k0 >> 4, hi1 = k1 >> 4;  // -1 >> 4 == -1: no f1
      const int lo0 = k0 & 15, lo1 = k1 & 15;
      // A fragments (one per tile): rows g, g + 8 (f1), cols q, q + 4 (rows)
      uint32_t a[TG][4];
#pragma unroll
      for (int t = 0; t < TG; ++t) {
        const int f1 = (tile0 + t) * 16 + g;
        a[t][0] = (hi0 == f1) ? 0x3f800000u : 0u;
        a[t][1] = (hi0 == f1 + 8) ? 0x3f800000u : 0u;
        a[t][2] = (hi1 == f1) ? 0x3f800000u : 0u;
        a[t][3] = (hi1 == f1 + 8) ? 0x3f800000u : 0u;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // B fragments: rows q, q + 4 (rows of Wx), col g (f0 = 8h + g)
        const int f0 = h * 8 + g;
        const float br0 = (lo0 == f0) ? vr0 : 0.f;
        const float br1 = (lo1 == f0) ? vr1 : 0.f;
        const float bi0 = (lo0 == f0) ? vi0 : 0.f;
        const float bi1 = (lo1 == f0) ? vi1 : 0.f;
        const uint32_t rh0 = tf32(br0), rh1 = tf32(br1);
        const uint32_t ih0 = tf32(bi0), ih1 = tf32(bi1);
        const uint32_t rl0 = tf32(br0 - __uint_as_float(rh0));
        const uint32_t rl1 = tf32(br1 - __uint_as_float(rh1));
        const uint32_t il0 = tf32(bi0 - __uint_as_float(ih0));
        const uint32_t il1 = tf32(bi1 - __uint_as_float(ih1));
#pragma unroll
        for (int t = 0; t < TG; ++t) {
          if (tile0 + t < ntiles) {
            mma_tf32(acc[t][h][0], a[t], rh0, rh1);
            mma_tf32(acc[t][h][0], a[t], rl0, rl1);
            mma_tf32(acc[t][h][1], a[t], ih0, ih1);
            mma_tf32(acc[t][h][1], a[t], il0, il1);
          }
        }
      }
    }
  }

  // store: each tile's 256 bins of the block's 8 columns through shared
  // memory; C fragment e sits at row g (+8 for e >= 2), col 2q + (e & 1)
  const int nf = P.nf;
  const long long obase = bat * nf * n + j0;
#pragma unroll
  for (int t = 0; t < TG; ++t) {
    if (tile0 + t >= ntiles) break;
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lb = (g + (e >= 2 ? 8 : 0)) * 16 + h * 8 + 2 * q + (e & 1);
        sout[0][lb][warp] = acc[t][h][0][e];
        sout[1][lb][warp] = acc[t][h][1][e];
      }
    __syncthreads();
    const int kb = (tile0 + t) * kTileBins;
    for (int e = tid; e < kTileBins * kCols; e += kThreads) {
      const int lb = e / kCols, c = e % kCols;
      const int kk = kb + lb;
      if (kk < nf && j0 + c < n) {
        const long long o = obase + (long long)kk * n + c;
        txr[o] = sout[0][lb][c];
        txi[o] = sout[1][lb][c];
      }
    }
  }
}

template <int TG>
int launch(const float* wr, const float* wi, const float* dr, const float* di,
           const float* cst, const float* sfs, int batch, int na, long long n,
           const Plan& P, int transform, float gamma2, int ntiles,
           int passes, float* txr, float* txi, cudaStream_t stream) {
  const dim3 grid((unsigned)((n + kCols - 1) / kCols), (unsigned)passes,
                  (unsigned)batch);
  reassign_mxu_kernel<TG><<<grid, kThreads, 0, stream>>>(
      wr, wi, dr, di, cst, sfs, na, n, P, transform, gamma2, ntiles, txr,
      txi);
  return (int)cudaGetLastError();
}

}  // namespace

// Planes are (batch, na, n) and (batch, nf, n), row-major float32. The
// wrapper splits the ntiles = ceil(nf / 256) tiles into `passes` passes
// of `tiles_per_pass` (1..4) tiles each (reassign_cuda._mxu_passes).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssq_reassign_mxu(const float* wr, const float* wi,
                                const float* dr, const float* di,
                                const float* cst, const float* sfs, int batch,
                                int na, long long n, int nf, int transform,
                                int mode, int flipud, float gamma2, float p0,
                                float p1, float p2, float p3, float p4,
                                int tiles_per_pass, float* txr, float* txi,
                                void* stream) {
  const Plan P{mode, flipud, nf, p0, p1, p2, p3, p4};
  const int ntiles = (nf + kTileBins - 1) / kTileBins;
  const int passes = (ntiles + tiles_per_pass - 1) / tiles_per_pass;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tiles_per_pass) {
    case 1: return launch<1>(wr, wi, dr, di, cst, sfs, batch, na, n, P,
                             transform, gamma2, ntiles, passes, txr, txi, s);
    case 2: return launch<2>(wr, wi, dr, di, cst, sfs, batch, na, n, P,
                             transform, gamma2, ntiles, passes, txr, txi, s);
    case 3: return launch<3>(wr, wi, dr, di, cst, sfs, batch, na, n, P,
                             transform, gamma2, ntiles, passes, txr, txi, s);
    case 4: return launch<4>(wr, wi, dr, di, cst, sfs, batch, na, n, P,
                             transform, gamma2, ntiles, passes, txr, txi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
