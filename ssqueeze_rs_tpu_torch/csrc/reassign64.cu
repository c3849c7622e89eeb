// Kernels B and B' in double (float64 planes): analytic frequency binning
// and deterministic reassignment for sm_90a.
//
// Replaces ssqueeze_rs_tpu/ops/reassign_pallas.py::_make_kernel on float64
// planes (the JAX package's float64 kernel), in its two input contracts
// (the float32 kernels B and B' of reassign.cu take the same two):
//   B  (3 planes): Wx and the phase plane w, +inf = masked
//   B' (4 planes): Wx and dWx; w and the mask |Wx|^2 > gamma^2 are formed
//      here (phase_w's operations)
// For each column j and each row i in increasing order:
//   k = bin(w[i,j]);  Tx[k, j] += (Wxr[i,j] * const[i], Wxi[i,j] * const[i])
// A launch takes the bins of one range [k0, k0 + nk) of [0, nf): every
// entry is binned over all nf bins and added, at accumulator row k - k0,
// only when its final (clamped, flipped) bin falls in the range; Tx rows
// k0 .. k0 + nk - 1 go out. Past 3632 bins the wrapper splits nf into
// such ranges (reassign_cuda._ranges), one launch each, every launch
// reading every plane row, so each Tx entry still takes its rows' adds in
// increasing row order.
//
// Bound: the bytes, each plane read once and Tx written once at 3.35
// TB/s: 0.560 ms (B) and 0.672 ms (B') at 293 x 160 000 (nf = 293), B'
// 1.123 ms at 490 x 160 000 (nf = 490) and 1.231 ms at 293 x 160 000
// into nf = 1025. The FP64 work (chip_smoke.py phase 24 counts it in the
// SASS) is a fraction of that at the FP64 pipe's 64 lanes a clock an SM.
//
// What held back the float32 design (reassign.cuh: 16 lanes a column,
// each lane with one step of loads in flight) run in double:
//   1. its (2, nf, COLS) double accumulator took the shared memory, so
//      the threads an SM, and with them the loads in flight, fell with
//      nf: 16 KB of B' loads an SM at nf = 293, 4 at 1025, 2 at 2000;
//   2. row runs of 16 bytes a warp and a swizzle made for 4-byte banks;
//   3. FP64 work an entry: a double log2 and two IEEE divisions (one for
//      w, one for the bin; two for a log-piecewise bin, which computed
//      both branches).
// What this kernel does about each:
//   1. the planes come in by TMA: one 2-D box of 16 GROUPS rows x COLS
//      columns a plane a stage, from one thread, into a ring of `stages`
//      stages, each completing on its mbarrier; the boxes of the next
//      stages are in flight while a stage is binned and added. The host
//      plan (reassign_cuda._f64_plan) sizes the ring from what the
//      accumulator leaves, at least 32 KB in flight an SM at every nf, and
//      GROUPS row groups of warps share a column tile, so the warps an SM
//      no longer fall with the columns an SM (2 to 4 blocks of 8 warps, or
//      one of 16). A block is persistent: it walks its tiles (COLS columns
//      of one batch item) on one ring, and its Tx goes out by TMA too, so
//      the next tile's loads and the last one's stores run under its adds.
//   2. each plane row of a tile is one run of COLS x 8 bytes (64 at 8
//      columns, wherever the accumulator allows 8); the stages and the
//      accumulator have the TMA boxes' swizzle (stage_at), which gives a
//      half-warp's 8-byte reads and adds (8 rows of 2 columns) 16 bank
//      pairs.
//   3. a float screen (bin_screen) decides the bin from float32 w, log2f
//      and a bound on their error wherever the bound keeps it inside one
//      rounding cell, and sends the rest (one entry in a thousand or
//      fewer at the timed shapes) to the exact double path, whose one
//      division a bin computes only the log-piecewise branch it keeps
//      (bin64). Every bin is the exact one.
//
// The lanes (reassign.cuh's map, row group h of GROUPS): lane l of warp w
// is column 2 (w mod COLS/2) + l mod 2 and stage row 16 h + l / 2, h = w /
// (COLS/2). Each lane bins its entry of a stage; the row groups add in
// turn (a named barrier a column pair between groups h - 1 and h, while
// the later groups bin the next stage), and in a group the lanes of one
// (bin, column) add in rounds by row (a lane's rank: its column's lower
// lanes with its bin, by shuffles; __syncwarp between rounds). So every
// (bin, column) sum takes its adds in increasing row order from zero,
// each product __dmul_rn(v, const[i]) added on its own with __dadd_rn: Tx
// is bitwise the row-ordered sum, with no atomics.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "reassign64.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

using ssq::Plan64;
using ssq::tma_expect;
using ssq::tma_load;
using ssq::tma_store;

namespace {

constexpr int kLanes = 16;       // lanes a column: a row group's rows
constexpr int kMaxStages = 16;   // ring stages (reassign_cuda._F64_MAX_STAGES)
constexpr size_t kSmSmem = 228 * 1024;    // shared memory of an SM
constexpr size_t kBlockReserve = 1024;    // of it, the runtime's a block

// A stage plane is the TMA box of kRows rows x COLS columns, dense, with
// the box's swizzle (64 or 32 bytes for 8 or 4 columns; none for 2): the
// 16-byte chunks of a 128-byte line are permuted by the line's row bits,
// so a half-warp's reads (8 rows of 2 columns) fall in 16 different bank
// pairs. Offset (doubles) of row r, column c in a plane whose base is
// aligned to the swizzle's period.
template <int COLS>
__device__ __forceinline__ int stage_at(int r, int c) {
  constexpr int kM = COLS == 8 ? 3 : COLS == 4 ? 1 : 0;
  const int off = (r * COLS + c) * 8;
  return (off ^ (((off >> 7) & kM) << 4)) >> 3;
}

// Doubles of one accumulator plane, (nf, COLS) rounded up to 1024 bytes
// so both planes and the ring after them keep the TMA's alignment.
__host__ __device__ constexpr int acc_plane(int nf, int cols) {
  return (nf * cols + 127) / 128 * 128;
}

// Dynamic shared memory: 1024 bytes to align the base, the two
// accumulator planes, the ring of `stages` stages (kPlanes planes of 16
// GROUPS rows x COLS doubles) and one mbarrier a stage.
__host__ __device__ constexpr size_t smem_bytes(int nf, int cols, int groups,
                                                int planes, int stages) {
  return 1024 + (size_t)16 * acc_plane(nf, cols) +
         (size_t)stages * (planes * kLanes * groups * cols * 8 + 8);
}

// Offset of bin k, column c in one accumulator plane: the TMA box layout
// of the Tx store, (nf, COLS) with stage_at's swizzle. A half-warp adds
// for 8 rows of each of its 2 columns; the swizzle puts one column's bins
// that differ in their low three bits in 8 different bank pairs and the
// other column in the other 8.
template <int COLS>
__device__ __forceinline__ int acc_at(int k, int c) {
  return stage_at<COLS>(k, c);
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   ssq::smem_u32(dst)),
               "l"(src)
               : "memory");
}

// kPlanes = 3: p2 is the w plane (+inf where masked); kPlanes = 4: p2, p3
// are dWx. Tiles: `tiles_row` a batch item, `tiles` in all; block b walks
// tiles b, b + gridDim.x, ...
// MINB: the blocks an SM the plan gives this launch, so ptxas fits their
// registers (64 a thread at 4 blocks of 256 threads, 80 at 3, 128 at 2 or
// at one block of 512)
template <int COLS, int GROUPS, int MINB, int kPlanes>
__global__ void __launch_bounds__(kLanes * COLS * GROUPS, MINB)
reassign_kernel_f64(const double* __restrict__ wr,
                    const double* __restrict__ wi,
                    const double* __restrict__ p2,
                    const double* __restrict__ p3,
                    const double* __restrict__ cst,
                    const double* __restrict__ sfs, int na, long long n,
                    int tiles_row, int tiles, Plan64 P, int transform,
                    double gamma2, int stages, int vec, int k0, int nk,
                    double* __restrict__ txr, double* __restrict__ txi,
                    const __grid_constant__ CUtensorMap tm0,
                    const __grid_constant__ CUtensorMap tm1,
                    const __grid_constant__ CUtensorMap tm2,
                    const __grid_constant__ CUtensorMap tm3,
                    const __grid_constant__ CUtensorMap tmr,
                    const __grid_constant__ CUtensorMap tmi) {
  constexpr int kThreads = kLanes * COLS * GROUPS;
  constexpr int kRows = kLanes * GROUPS;        // rows a stage
  constexpr int kPlane = kRows * COLS;          // doubles a stage plane
  constexpr int kStage = kPlanes * kPlane;
  constexpr int kPairs = COLS / 2;              // warps a row group
  static_assert(COLS % 2 == 0 && kThreads % 32 == 0, "plan");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nf = P.nf;
  double* acc = reinterpret_cast<double*>(
      smem_raw + ((1024 - (ssq::smem_u32(smem_raw) & 1023)) & 1023));
  const int accp = acc_plane(nk, COLS);
  double* acc_i = acc + accp;
  double* ring = acc + 2 * accp;                           // [stages][kStage]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + stages * kStage);
  const Screen S{1.0 / P.p1, 1.0 / P.p2, 1.0 / P.p3};

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = warp / kPairs;
  const int c = (warp % kPairs) * 2 + (lane & 1);
  const int g = grp * kLanes + (lane >> 1);
  const int T = na > kRows ? (na + kRows - 1) / kRows : 1;   // stages a tile
  const int G = gridDim.x;
  const int Q = (tiles - (int)blockIdx.x + G - 1) / G * T;    // this block's

  // a stage's copies: when vec, one TMA box a plane from thread 0 (the
  // stage's barrier expects their bytes); else 8 bytes of each plane from
  // every thread, its row lr and column lc
  const int lr = tid / COLS, lc = tid % COLS;
  const long long lro = (long long)lr * n + lc;
  const int ldst = stage_at<COLS>(lr, lc);

  for (int e = tid; e < 2 * accp; e += kThreads) acc[e] = 0.0;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s)
      ssq::mbar_init(&bars[s], vec ? 1 : kThreads);
    ssq::mbar_init_fence();
  }
  __syncthreads();

  // the load stream: the next stage to copy is row stage lt of tile ltile
  // (its columns from lj0, its planes' offset lbase), into slot lslot
  int ltile = blockIdx.x, lt = 0, lslot = 0;
  int lrow = ltile / tiles_row * na;           // its item's first row
  long long lj0 = (long long)(ltile % tiles_row) * COLS;
  auto load = [&]() {
    double* dst = ring + lslot * kStage;
    const int i0 = lt * kRows;
    if (vec) {
      if (tid == 0) {
        const int x = (int)lj0, y = lrow + i0;
        tma_expect(&bars[lslot], kPlanes * kPlane * 8);
        tma_load(dst, &tm0, x, y, &bars[lslot]);
        tma_load(dst + kPlane, &tm1, x, y, &bars[lslot]);
        tma_load(dst + 2 * kPlane, &tm2, x, y, &bars[lslot]);
        if (kPlanes == 4) tma_load(dst + 3 * kPlane, &tm3, x, y, &bars[lslot]);
      }
    } else {
      if (i0 + lr < na && lj0 + lc < n) {
        const long long o = (long long)(lrow + i0) * n + lj0 + lro;
        cp_async8(dst + ldst, wr + o);
        cp_async8(dst + kPlane + ldst, wi + o);
        cp_async8(dst + 2 * kPlane + ldst, p2 + o);
        if (kPlanes == 4) cp_async8(dst + 3 * kPlane + ldst, p3 + o);
      }
      ssq::cp_async_arrive(&bars[lslot]);
    }
    lslot = lslot + 1 == stages ? 0 : lslot + 1;
    if (++lt == T) {
      lt = 0;
      ltile += G;
      lrow = ltile / tiles_row * na;
      lj0 = (long long)(ltile % tiles_row) * COLS;
    }
  };

  for (int s = 0; s < stages && s < Q; ++s) load();

  // the bin stream: the next stage to bin is row stage bt of the tile of
  // columns from bj0, in slot bslot (phase bpar of its barrier)
  int btile = blockIdx.x, bt = 0, bslot = 0;
  unsigned bpar = 0;
  long long bj0 = (long long)(btile % tiles_row) * COLS;
  // this lane's entry of that stage: its bin (-1: none) and products
  auto bin_next = [&](int& k, double& pr, double& pi) {
    ssq::mbar_wait(&bars[bslot], bpar);
    const int i = bt * kRows + g;
    k = -1;
    pr = pi = 0.0;
    if (i < na && bj0 + c < n) {
      const double* sp = ring + bslot * kStage + stage_at<COLS>(g, c);
      const double vr = sp[0], vi = sp[kPlane];
      k = entry_bin<kPlanes>(vr, vi, sp[2 * kPlane],
                             kPlanes == 4 ? sp[3 * kPlane] : 0.0,
                             kPlanes == 4 ? __ldg(sfs + i) : 0.0, gamma2,
                             transform, P, S);
      k = k >= k0 && k < k0 + nk ? k - k0 : -1;   // this launch's range
      const double cc = __ldg(cst + i);
      pr = __dmul_rn(vr, cc);
      pi = __dmul_rn(vi, cc);
    }
    if (++bslot == stages) {
      bslot = 0;
      bpar ^= 1u;
    }
    if (++bt == T) {
      bt = 0;
      btile += G;
      bj0 = (long long)(btile % tiles_row) * COLS;
    }
  };
  // the add stream: row stage t of the tile of columns from j0, whose Tx
  // starts at ob
  int tile = blockIdx.x, t = 0;
  long long j0 = (long long)(tile % tiles_row) * COLS;
  long long ob = (long long)(tile / tiles_row) * nf * n + (long long)k0 * n +
                 j0;
  // named barrier pair_bar + h (h >= 1) orders the column pair's row
  // groups h - 1 and h (ids 1 .. COLS / 2 (GROUPS - 1) <= 15)
  const int pair_bar = (warp % kPairs) * (GROUPS - 1);
  static_assert(kPairs * (GROUPS - 1) <= 15, "named barriers");
  int k;
  double pr, pi;
  if (Q > 0) bin_next(k, pr, pi);
  for (int q = 0; q < Q; ++q) {
    // every lane has binned stage q, whose slot is refilled now, and the
    // adds of stage q - 1 and the last tile's store are done
    __syncthreads();
    if (q + stages < Q) load();
    // stage q's adds, the row groups in turn: group h waits on its column
    // pair's barrier for group h - 1 and bins stage q + 1 before that, so
    // the bins of one stage run under the adds of the last; in a group,
    // the lanes of one (bin, column) add in rounds by row (a lane's rank:
    // the lower lanes, lower rows, of its group)
    const int key = k >= 0 ? k * COLS + c : -1 - lane;
    int rank = 0;
#pragma unroll
    for (int d = 2; d < 32; d += 2) {           // the column's lower lanes
      const int other = __shfl_up_sync(0xffffffffu, key, d);
      rank += lane >= d && other == key;
    }
    const int rounds = __reduce_max_sync(0xffffffffu, rank);
    int k2 = -1;
    double pr2 = 0.0, pi2 = 0.0;
    if (grp > 0) {
      if (q + 1 < Q) bin_next(k2, pr2, pi2);
      asm volatile("bar.sync %0, 64;" ::"r"(pair_bar + grp) : "memory");
    }
    for (int r = 0; r <= rounds; ++r) {
      if (rank == r && k >= 0) {
        const int a = acc_at<COLS>(k, c);
        acc[a] = __dadd_rn(acc[a], pr);
        acc_i[a] = __dadd_rn(acc_i[a], pi);
      }
      __syncwarp();
    }
    if (grp + 1 < GROUPS)
      asm volatile("bar.arrive %0, 64;" ::"r"(pair_bar + grp + 1)
                   : "memory");
    if (grp == 0 && q + 1 < Q) bin_next(k2, pr2, pi2);
    k = k2;
    pr = pr2;
    pi = pi2;
    if (++t == T) {
      // the tile's last stage: its Tx columns out, the accumulator
      // zeroed. vec: thread 0 stores the two planes by TMA (maps of the
      // range's rows), boxes of at most 256 bins, and waits only until the
      // TMA has read them; else every thread stores entries in runs of
      // the columns
      if (vec) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncthreads();
        if (tid == 0) {
          const int bat = (tile / tiles_row);
          for (int r0 = 0; r0 < nk; r0 += 256) {
            tma_store(&tmr, acc + r0 * COLS, (int)j0, r0, bat);
            tma_store(&tmi, acc_i + r0 * COLS, (int)j0, r0, bat);
          }
          asm volatile("cp.async.bulk.commit_group;" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        }
        __syncthreads();
        double2* z = reinterpret_cast<double2*>(acc);
        for (int e = tid; e < accp; e += kThreads)
          z[e] = make_double2(0.0, 0.0);
      } else {
        __syncthreads();
        for (int e = tid; e < nk * COLS; e += kThreads) {
          const int kk = e / COLS, cc = e % COLS;
          const int a = acc_at<COLS>(kk, cc);
          if (j0 + cc < n) {
            txr[ob + (long long)kk * n + cc] = acc[a];
            txi[ob + (long long)kk * n + cc] = acc_i[a];
          }
          acc[a] = 0.0;
          acc_i[a] = 0.0;
        }
      }
      t = 0;
      tile += G;
      j0 = (long long)(tile % tiles_row) * COLS;
      ob = (long long)(tile / tiles_row) * nf * n + (long long)k0 * n + j0;
    }
  }
  if (vec && tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The TMA map of a float64 tensor of `rank` 2 (n columns x rows) or 3
// (n x rows x items, an item every `item_rows` rows), boxes of `box_rows`
// rows x `cols` columns (x 1 item) with stage_at's swizzle; false if
// cuTensorMapEncodeTiled is missing or refuses the map.
bool plane_map(CUtensorMap* tm, const double* p, int rank, long long rows,
               long long items, long long n, int cols, int box_rows,
               long long item_rows) {
  const ssq::EncodeTiled encode = ssq::tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)rows,
                              (cuuint64_t)items};
  const cuuint64_t strides[2] = {(cuuint64_t)n * 8,
                                 (cuuint64_t)(n * 8 * item_rows)};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = cols == 8   ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : cols == 4 ? CU_TENSOR_MAP_SWIZZLE_32B
                                             : CU_TENSOR_MAP_SWIZZLE_NONE;
  return encode(tm, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, (cuuint32_t)rank,
                const_cast<double*>(p), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One launch over planes (batch, na, n) into rows k0 .. k0 + nk - 1 of Tx
// planes (batch, nf, n): as many persistent blocks as fit on the card, at
// most one a tile. The planes go in by TMA where n is even and every plane
// 16-byte aligned, else by 8-byte cp.async.
template <int COLS, int GROUPS, int MINB, int kPlanes>
int launch(const double* wr, const double* wi, const double* p2,
           const double* p3, const double* cst, const double* sfs, int batch,
           int na, long long n, const Plan64& P, int transform, double gamma2,
           int stages, int k0, int nk, double* txr, double* txi,
           cudaStream_t stream) {
  constexpr int kThreads = kLanes * COLS * GROUPS;
  auto kernel = reassign_kernel_f64<COLS, GROUPS, MINB, kPlanes>;
  if (stages < 2 || stages > kMaxStages || k0 < 0 || nk < 1 ||
      k0 + nk > P.nf)
    return (int)cudaErrorInvalidValue;
  const long long tiles_row = (n + COLS - 1) / COLS;
  const long long tiles = tiles_row * batch;
  if (tiles > 0x7fffffffLL || (long long)batch * na > 0x7fffffffLL ||
      n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (tiles == 0) return 0;
  const size_t smem = smem_bytes(nk, COLS, GROUPS, kPlanes, stages);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long grid = tiles < (long long)per_sm * sms
                             ? tiles : (long long)per_sm * sms;
  auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const double* planes[4] = {wr, wi, p2, kPlanes == 4 ? p3 : p2};
  CUtensorMap tm[6];
  int vec = n % 2 == 0 && aligned(txr) && aligned(txi);
  for (int p = 0; p < 4 && vec; ++p)
    vec = aligned(planes[p]) &&
          plane_map(&tm[p], planes[p], 2, (long long)batch * na, 1, n, COLS,
                    kLanes * GROUPS, (long long)batch * na);
  const int box = nk < 256 ? nk : 256;
  vec = vec &&
        plane_map(&tm[4], txr + (long long)k0 * n, 3, nk, batch, n, COLS,
                  box, P.nf) &&
        plane_map(&tm[5], txi + (long long)k0 * n, 3, nk, batch, n, COLS,
                  box, P.nf);
  if (!vec) memset(tm, 0, sizeof(tm));
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      wr, wi, p2, p3, cst, sfs, na, n, (int)tiles_row, (int)tiles, P,
      transform, gamma2, stages, vec, k0, nk, txr, txi, tm[0], tm[1], tm[2],
      tm[3], tm[4], tm[5]);
  return (int)cudaGetLastError();
}

// The (columns, row groups) of reassign_cuda._f64_plan, 8 columns and 2
// row groups in as many blocks an SM (4, 3, 2) as their shared memory
// lets in, the rest one block an SM; any other launch is refused.
template <int kPlanes>
int dispatch(int cols, int groups, const double* wr, const double* wi,
             const double* p2, const double* p3, const double* cst,
             const double* sfs, int batch, int na, long long n,
             const Plan64& P, int transform, double gamma2, int stages,
             int k0, int nk, double* txr, double* txi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int fit = (int)(kSmSmem / (smem_bytes(nk, cols, groups, kPlanes,
                                              stages) + kBlockReserve));
  const int blocks = fit < 4 ? fit : 4;
#define SSQ_F64_CASE(C, G, B)                                              \
  if (cols == C && groups == G && (B == 1 || blocks == B))                 \
    return launch<C, G, B, kPlanes>(wr, wi, p2, p3, cst, sfs, batch, na, n, \
                                    P, transform, gamma2, stages, k0, nk,   \
                                    txr, txi, s);
  SSQ_F64_CASE(8, 2, 4)
  SSQ_F64_CASE(8, 2, 3)
  SSQ_F64_CASE(8, 2, 2)
  SSQ_F64_CASE(8, 4, 1)
  SSQ_F64_CASE(4, 8, 1)
  SSQ_F64_CASE(2, 16, 1)
#undef SSQ_F64_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Planes are (batch, na, n) and (batch, nf, n), row-major float64, with
// the plan constants and gamma^2 in double; the launch sums bins k0 .. k0 +
// nk - 1 into those Tx rows; cols, groups and stages are
// reassign_cuda._f64_plan(nk, planes)'s. Return cudaGetLastError() after
// the launch (0 on success).
extern "C" int ssq_reassign_f64(const double* wr, const double* wi,
                                const double* w, const double* cst, int batch,
                                int na, long long n, int nf, int mode,
                                int flipud, double p0, double p1, double p2,
                                double p3, double p4, int cols, int groups,
                                int stages, int k0, int nk, double* txr,
                                double* txi, void* stream) {
  const Plan64 P{mode, flipud, nf, p0, p1, p2, p3, p4};
  return dispatch<3>(cols, groups, wr, wi, w, nullptr, cst, nullptr, batch,
                     na, n, P, ssq::kCwt, 0.0, stages, k0, nk, txr, txi,
                     stream);
}

extern "C" int ssq_reassign4_f64(const double* wr, const double* wi,
                                 const double* dr, const double* di,
                                 const double* cst, const double* sfs,
                                 int batch, int na, long long n, int nf,
                                 int transform, int mode, int flipud,
                                 double gamma2, double p0, double p1,
                                 double p2, double p3, double p4, int cols,
                                 int groups, int stages, int k0, int nk,
                                 double* txr, double* txi, void* stream) {
  const Plan64 P{mode, flipud, nf, p0, p1, p2, p3, p4};
  return dispatch<4>(cols, groups, wr, wi, dr, di, cst, sfs, batch, na, n,
                     P, transform, gamma2, stages, k0, nk, txr, txi, stream);
}
