// Kernel I: the 4-plane reassignment (synchrosqueezing scatter) as a
// digit-split one-hot matrix product on Hopper's warpgroup tensor-core
// instruction (wgmma), for sm_90a.
//
// Replaces ssqueeze_rs_tpu/ops/reassign_pallas.py::_make_mxu_kernel (the
// SSQ_TPU_REASSIGN_IMPL=mxu forward of _reassign_with_vjp). It computes
// what kernel B' (reassign.cu, 4 planes) computes: for each column j and
// each row i, w = phase_w(Wx, dWx) and its bin k = bin_of(w) (bins.cuh,
// so the bins are B''s bit for bit; k = -1 where masked), then
//
//   Tx[k, j] += Wx[i, j] * const[i].
//
// Bin ranges. A launch sums the bins of one range [k0, k0 + nk) of [0,
// nf) (one range, the whole of [0, nf), up to 4096 bins; past that the
// wrapper splits nf into ranges of at most 4096, reassign_cuda._ranges,
// one launch each): every entry is binned over all nf bins, and one whose
// final bin k falls in the range enters the product at k - k0; the launch
// writes Tx rows k0 .. k0 + nk - 1. Below, nf stands for the range's nk
// wherever it sizes the digit split, the product or the store.
//
// The digit split. The bin is k = F0 * khi + klo, F0 = ceil(nf / 64), so
// khi < 64. Each value v = Wx * const (__fmul_rn) is cut into three bf16
// parts, v = hi + mid + lo (the TPU kernel's split3; exact for float32's
// 24 bits), and per column the sums become one product over the rows:
//
//   D[f1, (3c + p) F0 + f0] = sum_i [khi(i) == f1] * part_p(v_c(i))
//                                   * [klo(i) == f0]
//
// with c = re, im and p = hi, mid, lo; then Tx_c[F0 f1 + f0] = (D[.., 3c
// F0 + f0] + D[.., (3c + 1) F0 + f0]) + D[.., (3c + 2) F0 + f0], in that
// order, and bins >= nf are dropped. A (M = 64 high digits x 16 rows) is
// the one-hot of khi; B (16 rows x N) holds the parts at their low digit;
// N = 6 F0 rounded up to 8 (16 past 128, 32 past 256). One m64nNk16
// wgmma a column and 16 rows covers every bin of nf <= 4096: the planes
// are read once, with no passes. Past N = 128, two or four warpgroups
// share a column, each multiplying the same A tile by its own 128 or
// fewer of B's columns.
//
// The block: 4 warpgroups (512 threads, one block an SM), COLS columns,
// each warpgroup's sums in its registers for the whole walk down the
// rows (at most 64 accumulators a thread: COLS = 16 at nf <= 320, 4 at
// nf = 1025, 1 past 2688). The rows go in stages of ROWS (a multiple of
// 16, at most 128, at most two entries a thread):
//   1. the four planes' (ROWS x COLS) tiles and the rows' sfs and const
//      arrive in a ring of 3 shared-memory stages by cp.async (16 bytes a
//      copy where the rows allow it, else 4), each stage completing on
//      its mbarrier; a stage's copies go out two stages ahead of its use;
//   2. each thread bins its entries of stage t (16 consecutive threads
//      take the 16 rows of one column's step) while the products of
//      stage t - 1 run;
//   3. after a barrier (every product of t - 1 done) each thread clears
//      the marks its entries left in the tiles at t - 1 and writes the
//      new ones: a bf16 one at (row, khi) in A, the six parts at (row,
//      (3c + p) F0 + klo) in B. The tiles stay zero but for the stage's
//      entries, so no thread writes a dense operand;
//   4. fence.proxy.async, a barrier, and each warpgroup issues its
//      products of the stage, both operands from the tiles, and commits
//      without waiting.
// D leaves through shared memory ([64][N + 1][COLS + 1] floats, odd
// strides), so each stored Tx row is COLS consecutive columns, in direct
// bin order.
//
// Deterministic: each column's sums come from one warpgroup (a fixed
// share of N) in one fixed sequence of wgmma instructions, no atomics, so
// Tx repeats bit for bit. Not IEEE-ordered against B' (the tensor cores
// add in their own order): held to B' by the JAX package's bar for I
// (sum-relative < 2e-5, nonzero patterns equal).
//
// What bounds it on Hopper. The function is B''s scatter, so its least
// time is B''s: the bytes of four planes in and two out (0.344 ms at
// 293 x 160 000, 0.147 ms at 1025 x 20 000, at 3.35 TB/s). This design
// adds tensor-core work, 64 N MACs an entry: 2048 at nf = 293 (N = 32),
// 6656 at nf = 1025 (N = 104), that is 0.194 and 0.276 ms at 989 TFLOP/s
// (bf16). So the bytes bound it below nf ~600 (12 nf FLOP an entry
// against ~24 bytes) and the tensor-core work above. The design reads
// each plane byte once (no passes) and keeps the products' work near the
// function's: a column's 16 rows a product, the bins padded only to the
// next 64 F0. On the card it is held back by neither (PERF.md: its times;
// tools/reassign_mxu_phases.py: the phases' clocks): a small wgmma costs
// ~20-30 cycles of the SM (m64n32k16 at nf = 293, m64n104k16 at 1025),
// binning an entry and writing its marks each take ~1400 cycles of one
// thread, and a warpgroup's binning and its stalled product issue take
// turns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bins.cuh"
#include "wgmma.cuh"

namespace {

using ssq::Plan;

constexpr int kGroups = 4;                 // warpgroups a block
constexpr int kThreads = 128 * kGroups;
constexpr int kStages = 3;                 // plane stages in the ring
constexpr int kMaxSmem = 232448;           // a block's shared memory
constexpr int kMaxNf = 4096;               // 64 high digits x F0 = 64
constexpr int kAccRegs = 64;               // accumulators a thread
constexpr int kMaxCols = 32;               // columns a block
constexpr int kMaxEntries = 2;             // entries a thread bins a stage
constexpr int kMaxRows = 128;              // rows a stage
constexpr int kParts = 3;                  // bf16 parts of a value
constexpr int kTileA = 2048;               // bytes of a step's A tile
constexpr uint16_t kOne = 0x3F80u;         // bf16 one

// The host plan (reassign_cuda._mxu_plan mirrors these). F0, the low
// digit's width, is the smallest with 64 * F0 >= nf; N = 6 * F0 (re, im
// x 3 parts) rounded up to 8 (to 16 past 128, to 32 past 256).
__host__ __device__ constexpr int f0_for(int nf) { return (nf + 63) / 64; }

__host__ __device__ constexpr int n_tile_for(int nf) {
  return 6 * f0_for(nf) <= 128   ? (6 * f0_for(nf) + 7) / 8 * 8
         : 6 * f0_for(nf) <= 256 ? (6 * f0_for(nf) + 15) / 16 * 16
                                 : (6 * f0_for(nf) + 31) / 32 * 32;
}

// warpgroups that share a column: each takes N / split of its products
// (at most 128)
__host__ __device__ constexpr int split_for(int N) {
  return N <= 128 ? 1 : N <= 256 ? 2 : 4;
}

// columns a warpgroup: its accumulators (N / split / 2 a column) within
// kAccRegs registers a thread, the block's columns within kMaxCols
__host__ __device__ constexpr int cols_per_group(int N) {
  return kAccRegs / (N / split_for(N) / 2) <
                 kMaxCols * split_for(N) / kGroups
             ? kAccRegs / (N / split_for(N) / 2)
             : kMaxCols * split_for(N) / kGroups;
}

__host__ __device__ constexpr int cols_for(int N) {
  return kGroups / split_for(N) * cols_per_group(N);
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Dynamic shared memory: the A tiles then the B tiles of a stage
// ([COLS][STEPS] each), or at the end the products D ([64][N + 1][COLS +
// 1] floats: odd strides, so the store's reads spread over the banks),
// then the plane ring (each stage the four planes' (rows x
// cols) tiles, rows padded to cols + 4 floats, then the rows' sfs and
// const) and the mbarriers.
__host__ __device__ constexpr int tile_bytes(int N, int cols, int rows) {
  return cols * (rows / 16) * (kTileA + 32 * N);
}

__host__ __device__ constexpr int region_bytes(int N, int cols, int rows) {
  return round_up(tile_bytes(N, cols, rows) > 64 * (N + 1) * (cols + 1) * 4
                      ? tile_bytes(N, cols, rows)
                      : 64 * (N + 1) * (cols + 1) * 4,
                  128);
}

__host__ __device__ constexpr int stage_floats(int cols, int rows) {
  return 4 * rows * (cols + 4) + 2 * rows;
}

__host__ __device__ constexpr int smem_bytes(int N, int cols, int rows) {
  return region_bytes(N, cols, rows) + kStages * stage_floats(cols, rows) * 4 +
         kStages * 8;
}

// rows a stage: a multiple of 16 (whole k16 steps), at most kMaxRows and
// kMaxEntries entries a thread, less by 16 until the shared memory fits
__host__ __device__ constexpr int rows_for(int N) {
  const int most = kMaxEntries * kThreads / cols_for(N) / 16 * 16;
  int rows = most < kMaxRows ? most : kMaxRows;
  rows = rows < 16 ? 16 : rows;
  while (smem_bytes(N, cols_for(N), rows) > kMaxSmem) rows -= 16;
  return rows;
}

template <int N>
struct Shape {
  static constexpr int kSplit = split_for(N);
  static constexpr int kNW = N / kSplit;       // products of a warpgroup
  static constexpr int kCpg = cols_per_group(N);
  static constexpr int kCols = cols_for(N);
  static constexpr int kRows = rows_for(N);
  static constexpr int kSteps = kRows / 16;    // k16 steps a stage
  static constexpr int kTileB = 32 * N;        // bytes of a step's B tile
  static constexpr int kTilesB = kCols * kSteps * kTileA;  // B tiles' offset
  static constexpr int kEntries = (kRows * kCols + kThreads - 1) / kThreads;
  static constexpr int kLd = kCols + 1;        // D strides
  static constexpr int kLdn = (N + 1) * kLd;
  static constexpr int kLdr = kCols + 4;       // plane row stride in the ring
  static constexpr int kPlane = kRows * kLdr;  // floats of a plane's tile
  static constexpr int kPlanes = region_bytes(N, kCols, kRows);
  static constexpr int kStage = stage_floats(kCols, kRows);
  static constexpr int kBars = kPlanes + kStages * kStage * 4;
  static constexpr int kSmem = kBars + kStages * 8;
  static_assert(kSmem == smem_bytes(N, kCols, kRows), "layout");
  static_assert(kSmem <= kMaxSmem && kRows % 16 == 0 && kRows >= 16, "plan");
  static_assert(kEntries <= kMaxEntries && kNW % 8 == 0 && kNW <= 128 &&
                    kCpg >= 1 && kCpg * kNW / 2 <= kAccRegs,
                "plan");
};

// The three bf16 parts of v, v = hi + mid + lo, each rounded to nearest
// even (hi of v, mid of v - hi, lo of the rest), as bits.
__device__ __forceinline__ void split3(float v, uint16_t (&b)[kParts]) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  const float r1 = __fsub_rn(v, __bfloat162float(hi));
  const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
  const __nv_bfloat16 lo =
      __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
  b[0] = __bfloat16_as_ushort(hi);
  b[1] = __bfloat16_as_ushort(mid);
  b[2] = __bfloat16_as_ushort(lo);
}

// Byte of element (k, row) in a K-major tile (wgmma.cuh: LBO 128, SBO 256).
__device__ __forceinline__ int at(int k, int row) {
  return ((row & 7) << 4) + ((k & 7) << 1) + ((k >> 3) << 7) +
         ((row >> 3) << 8);
}

// Entry e of a stage: 16 consecutive threads take the 16 rows of one
// column's k16 step (their tile writes and plane reads then spread over
// the banks), the columns next, then the steps.
template <int COLS>
__device__ __forceinline__ int entry_row(int e) {
  return (e >> 4) / COLS * 16 + (e & 15);
}

template <int COLS>
__device__ __forceinline__ int entry_col(int e) {
  return (e >> 4) % COLS;
}

__device__ __forceinline__ void set16(unsigned char* p, uint16_t v) {
  *reinterpret_cast<uint16_t*>(p) = v;
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
reassign_mxu_kernel(const float* __restrict__ wr, const float* __restrict__ wi,
                    const float* __restrict__ dr, const float* __restrict__ di,
                    const float* __restrict__ cst, const float* __restrict__ sfs,
                    int na, long long n, Plan P, int transform, float gamma2,
                    int F0, int vec, int k0, int nk, float* __restrict__ txr,
                    float* __restrict__ txi) {
  using S = Shape<N>;
  constexpr int COLS = S::kCols, ROWS = S::kRows, STEPS = S::kSteps;
  constexpr int CPG = S::kCpg, NW = S::kNW;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* tilesA = smem;                    // [COLS][STEPS]
  unsigned char* tilesB = smem + S::kTilesB;       // [COLS][STEPS]
  float* ring = reinterpret_cast<float*>(smem + S::kPlanes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBars);
  float* prod = reinterpret_cast<float*>(smem);    // D at the end

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, q = tid & 3;
  const int c0 = wg / S::kSplit * CPG;             // this warpgroup's columns
  const int n0 = wg % S::kSplit * NW;              // and products
  const long long j0 = (long long)blockIdx.x * COLS;
  const long long pbase = (long long)blockIdx.y * na * n;
  const int T = (na + ROWS - 1) / ROWS;
  const int nf = P.nf;
  const float inv_f0 = 1.f / (float)F0;

  for (int o = tid * 16; o < S::kPlanes; o += kThreads * 16)
    *reinterpret_cast<uint4*>(smem + o) = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) ssq::mbar_init(&bars[s], kThreads);
    ssq::mbar_init_fence();
  }
  __syncthreads();

  // stage t's tiles of the four planes and its rows' sfs and const into
  // ring slot t % kStages; each thread arrives once on the slot's barrier
  // when its copies land
  auto load = [&](int t) {
    float* dst = ring + (t % kStages) * S::kStage;
    const int i0 = t * ROWS;
    if (vec) {
      constexpr int kQuads = COLS / 4 > 0 ? COLS / 4 : 1;
      for (int c = tid; c < 4 * ROWS * kQuads; c += kThreads) {
        const int p = c / (ROWS * kQuads), rc = c - p * (ROWS * kQuads);
        const int r = rc / kQuads, c4 = (rc - r * kQuads) * 4;
        const float* src = p == 0 ? wr : p == 1 ? wi : p == 2 ? dr : di;
        if (i0 + r < na && j0 + c4 < n)
          ssq::cp_async16(dst + p * S::kPlane + r * S::kLdr + c4,
                          src + pbase + (long long)(i0 + r) * n + j0 + c4);
      }
    } else {
      for (int e = tid; e < 4 * ROWS * COLS; e += kThreads) {
        const int p = e / (ROWS * COLS), rc = e - p * (ROWS * COLS);
        const int r = rc / COLS, c = rc - r * COLS;
        const float* src = p == 0 ? wr : p == 1 ? wi : p == 2 ? dr : di;
        if (i0 + r < na && j0 + c < n)
          ssq::cp_async4(dst + p * S::kPlane + r * S::kLdr + c,
                         src + pbase + (long long)(i0 + r) * n + j0 + c);
      }
    }
    if (tid < ROWS && i0 + tid < na) {
      ssq::cp_async4(dst + 4 * S::kPlane + tid, sfs + i0 + tid);
      ssq::cp_async4(dst + 4 * S::kPlane + ROWS + tid, cst + i0 + tid);
    }
    ssq::cp_async_arrive(&bars[t % kStages]);
  };

  float acc[CPG][NW / 2];
#pragma unroll
  for (int u = 0; u < CPG; ++u)
#pragma unroll
    for (int x = 0; x < NW / 2; ++x) acc[u][x] = 0.f;
  int prev_hi[S::kEntries], prev_lo[S::kEntries];   // marks in the tiles
#pragma unroll
  for (int u = 0; u < S::kEntries; ++u) prev_hi[u] = prev_lo[u] = -1;

  for (int t = 0; t < kStages - 1 && t < T; ++t) load(t);
  for (int t = 0; t < T; ++t) {
    // ring slot (t + 2) % kStages was read at stage t - 1, before its
    // barriers
    if (t + kStages - 1 < T) load(t + kStages - 1);
    ssq::mbar_wait(&bars[t % kStages], (t / kStages) & 1);
    // this thread's entries: every bin first (independent chains, while
    // the products of stage t - 1 run), then the writes
    const float* st = ring + (t % kStages) * S::kStage;
    int kv[S::kEntries];
    uint16_t pv[S::kEntries][2][kParts];
#pragma unroll
    for (int u = 0; u < S::kEntries; ++u) {
      const int e = tid + u * kThreads;
      const int r = entry_row<COLS>(e), c = entry_col<COLS>(e);
      const bool valid = e < ROWS * COLS && t * ROWS + r < na && j0 + c < n;
      const float* sp = st + (valid ? r * S::kLdr + c : 0);
      const float C = sp[0], D = sp[S::kPlane];
      const float A = sp[2 * S::kPlane], B = sp[3 * S::kPlane];
      const float* rv = st + 4 * S::kPlane + (valid ? r : 0);
      const float w = ssq::phase_w(C, D, A, B, rv[0], gamma2, transform);
      const int k = valid ? ssq::bin_of(w, P) : -1;
      kv[u] = k >= k0 && k < k0 + nk ? k - k0 : -1;   // this launch's range
      split3(__fmul_rn(C, rv[ROWS]), pv[u][0]);
      split3(__fmul_rn(D, rv[ROWS]), pv[u][1]);
    }
    ssq::wgmma_wait<0>();       // this warpgroup's products of stage t - 1
#pragma unroll
    for (int u = 0; u < CPG; ++u)
#pragma unroll
      for (int x = 0; x < NW / 2; ++x) ssq::fence_operand(acc[u][x]);
    __syncthreads();            // every product of stage t - 1 has run
#pragma unroll
    for (int u = 0; u < S::kEntries; ++u) {
      const int e = tid + u * kThreads;
      if (e < ROWS * COLS) {
        const int r = entry_row<COLS>(e), c = entry_col<COLS>(e);
        const int tile = c * STEPS + (r >> 4), k = r & 15;
        unsigned char* ta = tilesA + tile * kTileA;
        unsigned char* tb = tilesB + tile * S::kTileB;
        if (prev_hi[u] >= 0) {
          set16(ta + at(k, prev_hi[u]), 0);
#pragma unroll
          for (int z = 0; z < 2 * kParts; ++z)
            set16(tb + at(k, z * F0 + prev_lo[u]), 0);
        }
        const int bin = kv[u];
        int khi = -1, klo = -1;
        if (bin >= 0) {
          khi = (int)(((float)bin + 0.5f) * inv_f0);
          klo = bin - khi * F0;
          set16(ta + at(k, khi), kOne);
#pragma unroll
          for (int z = 0; z < 2 * kParts; ++z)
            set16(tb + at(k, z * F0 + klo), pv[u][z / kParts][z % kParts]);
        }
        prev_hi[u] = khi;
        prev_lo[u] = klo;
      }
    }
    ssq::fence_proxy_async();
    __syncthreads();            // stage t's tiles are whole
    // this warpgroup's products of stage t: a step, a column, one
    // m64n(NW)k16 over its share of B's columns; they run while the next
    // stage is binned
    ssq::wgmma_fence();
#pragma unroll
    for (int s = 0; s < STEPS; ++s)
#pragma unroll
      for (int u = 0; u < CPG; ++u) {
        const int tile = (c0 + u) * STEPS + s;
        ssq::WgmmaSS<NW>::mma(
            acc[u], ssq::desc_kmajor(tilesA + tile * kTileA),
            ssq::desc_kmajor(tilesB + tile * S::kTileB + n0 * 32));
      }
    ssq::wgmma_commit();
#pragma unroll
    for (int u = 0; u < CPG; ++u)
#pragma unroll
      for (int x = 0; x < NW / 2; ++x) ssq::fence_operand(acc[u][x]);
  }
  ssq::wgmma_wait<0>();
#pragma unroll
  for (int u = 0; u < CPG; ++u)
#pragma unroll
    for (int x = 0; x < NW / 2; ++x) ssq::fence_operand(acc[u][x]);
  __syncthreads();              // every product has run: D takes the tiles

#pragma unroll
  for (int u = 0; u < CPG; ++u)
#pragma unroll
    for (int x = 0; x < NW / 2; ++x) {
      const int t8 = x >> 2, e = x & 3;
      const int f1 = 16 * warp + g + 8 * (e >> 1);
      const int col = n0 + 8 * t8 + 2 * q + (e & 1);
      prod[f1 * S::kLdn + col * S::kLd + c0 + u] = acc[u][x];
    }
  __syncthreads();

  // Tx[c][f1 * F0 + f0] = (D[3c F0 + f0] + D[(3c + 1) F0 + f0])
  //                       + D[(3c + 2) F0 + f0], at row f1 of D
  const long long obase =
      (long long)blockIdx.y * nf * n + (long long)k0 * n + j0;
  auto tx = [&](int part, int bin, int c) {
    const int f1 = (int)(((float)bin + 0.5f) * inv_f0), f0 = bin - f1 * F0;
    const float* d = prod + f1 * S::kLdn + (3 * part * F0 + f0) * S::kLd + c;
    const int stride = F0 * S::kLd;
    return __fadd_rn(__fadd_rn(d[0], d[stride]), d[2 * stride]);
  };
  if (vec) {                    // whole float4s of each row (n % 4 == 0)
    constexpr int Q = COLS / 4 > 0 ? COLS / 4 : 1;
    for (int o = tid; o < 2 * nk * Q; o += kThreads) {
      const int pb = o / Q, c = (o - pb * Q) * 4;
      const int part = pb >= nk ? 1 : 0, bin = pb - part * nk;
      if (j0 + c < n)
        *reinterpret_cast<float4*>((part ? txi : txr) + obase +
                                   (long long)bin * n + c) =
            make_float4(tx(part, bin, c), tx(part, bin, c + 1),
                        tx(part, bin, c + 2), tx(part, bin, c + 3));
    }
  } else {
    for (int o = tid; o < 2 * nk * COLS; o += kThreads) {
      const int pb = o / COLS, c = o - pb * COLS;
      const int part = pb >= nk ? 1 : 0, bin = pb - part * nk;
      if (j0 + c < n)
        (part ? txi : txr)[obase + (long long)bin * n + c] = tx(part, bin, c);
    }
  }
}

template <int N>
int launch(const float* wr, const float* wi, const float* dr, const float* di,
           const float* cst, const float* sfs, int batch, int na, long long n,
           const Plan& P, int transform, float gamma2, int k0, int nk,
           float* txr, float* txi, cudaStream_t stream) {
  using S = Shape<N>;
  const cudaError_t err = cudaFuncSetAttribute(
      reassign_mxu_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int vec = S::kCols % 4 == 0 && n % 4 == 0 &&
                  (((uintptr_t)wr | (uintptr_t)wi | (uintptr_t)dr |
                    (uintptr_t)di | (uintptr_t)txr | (uintptr_t)txi) & 15) == 0;
  const dim3 grid((unsigned)((n + S::kCols - 1) / S::kCols), (unsigned)batch);
  reassign_mxu_kernel<N><<<grid, kThreads, S::kSmem, stream>>>(
      wr, wi, dr, di, cst, sfs, na, n, P, transform, gamma2, f0_for(nk), vec,
      k0, nk, txr, txi);
  return (int)cudaGetLastError();
}

}  // namespace

// Planes are (batch, na, n) and (batch, nf, n), row-major float32; the
// launch sums bins k0 .. k0 + nk - 1 (nk <= 4096) into those Tx rows.
// `n_tile` is the plan's wgmma width N for nk (reassign_cuda._mxu_plan);
// any other value, or a range out of [0, nf), returns
// cudaErrorInvalidValue.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssq_reassign_mxu(const float* wr, const float* wi,
                                const float* dr, const float* di,
                                const float* cst, const float* sfs, int batch,
                                int na, long long n, int nf, int transform,
                                int mode, int flipud, float gamma2, float p0,
                                float p1, float p2, float p3, float p4,
                                int n_tile, int k0, int nk, float* txr,
                                float* txi, void* stream) {
  if (nk < 1 || nk > kMaxNf || k0 < 0 || k0 + nk > nf ||
      n_tile != n_tile_for(nk))
    return (int)cudaErrorInvalidValue;
  const Plan P{mode, flipud, nf, p0, p1, p2, p3, p4};
  cudaStream_t s = (cudaStream_t)stream;
#define SSQ_MXU_CASE(NT)                                                    \
  case NT:                                                                  \
    return launch<NT>(wr, wi, dr, di, cst, sfs, batch, na, n, P, transform, \
                      gamma2, k0, nk, txr, txi, s);
  switch (n_tile) {
    SSQ_MXU_CASE(8) SSQ_MXU_CASE(16) SSQ_MXU_CASE(24) SSQ_MXU_CASE(32)
    SSQ_MXU_CASE(40) SSQ_MXU_CASE(48) SSQ_MXU_CASE(56) SSQ_MXU_CASE(64)
    SSQ_MXU_CASE(72) SSQ_MXU_CASE(80) SSQ_MXU_CASE(88) SSQ_MXU_CASE(96)
    SSQ_MXU_CASE(104) SSQ_MXU_CASE(112) SSQ_MXU_CASE(120) SSQ_MXU_CASE(128)
    SSQ_MXU_CASE(144) SSQ_MXU_CASE(160) SSQ_MXU_CASE(176) SSQ_MXU_CASE(192)
    SSQ_MXU_CASE(208) SSQ_MXU_CASE(224) SSQ_MXU_CASE(240) SSQ_MXU_CASE(256)
    SSQ_MXU_CASE(288) SSQ_MXU_CASE(320) SSQ_MXU_CASE(352) SSQ_MXU_CASE(384)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SSQ_MXU_CASE
}
