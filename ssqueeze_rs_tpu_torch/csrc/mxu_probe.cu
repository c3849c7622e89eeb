// Probe J6: the costs around a digit-split one-hot product (kernel I's
// design), one small kernel per question, for sm_90a.
//
// Replaces the TPU probes tools/mxu_probe.py (run_kernel's pallas_call at
// :56, the kernels of main :92-190) and tools/mxu_probe2.py (:44, main
// :79-175). On the TPU each question was a kernel whose GRID sequential
// steps each did the work again; those with a VMEM accumulator carried it
// over every step (left unset at the start there; zeroed here). Here the
// steps are a loop inside every block (and, for the accumulators, the
// NG groups a loop inside it). A runtime stride that is always 0 offsets
// each step's operands, so no step can be folded into another.
//
// Dots (ssq_mxu_dots: q_dots, q_dots4, q_bigdot, q_batch), bf16 operands,
// float32 sums:
//   accumulate   out = sum over s < steps of bf16(A) @ bf16(B), each
//                step's product fresh over k, then run = run + product
//                (__fadd_rn) in the order of s
//   otherwise    out[b] = bf16(A[b]) @ bf16(B[b]), recomputed at every step
// Each step's product is the same matrix P, so out is the float32
// sequential sum of P taken `steps` times: the sum stays in step order
// for every output element (no split of the steps across blocks, no sum
// carried through the tensor cores across steps, whose float32
// accumulation truncates), and results are bitwise run to run (no
// atomics). The card is filled by output tiles; without `accumulate`
// the steps are independent recomputations, so they are also spread
// over `copies` of each tile, each copy writing the same values.
//
// Orientation: the transposed product, out^T (N x M) = B^T A^T, one
// warpgroup's unit an m64 slab of out's columns (n0 .. n0 + 63) by a
// chunk of out's rows as the wgmma N. At the TPU probe's M = 152 an m64
// tile over M would compute 192 rows (26 % waste); over N = 768 (q_dots;
// 512 for q_dots4) it takes 12 (8) whole slabs, and M = 19 x 8 needs no
// padding along the wgmma N. A (M, K) row-major is the K-major B operand
// of that product as it lies; B (K, N) row-major is the MN-major A.
//
// Resident route (K <= kResidentK = 304: q_dots, q_dots4, q_batch), one
// warpgroup a block: the unit's operands are loaded once (16-byte
// cp.async where K and N are multiples of 8, else element by element,
// zeros past K, M and N) into shared memory: B's slab (304 x 64) and A's
// chunk (width rows x 304) in desc_kmajor's core-matrix layout. B's slab
// then moves into registers as the fixed A operand of every step (19 k16
// tiles x 4 registers: 76 a thread), so each wgmma (WgmmaRS, m64nWk16)
// reads only A's chunk from shared memory (32 W bytes) where the
// shared-memory form would read 2 KB of the fixed operand too. Every
// step runs all 19 k16 tiles, the tiles past K zeros (the probe's K =
// 296 needs 19; a smaller K pays for the zeros). Units: chunks of
// kUnitN = 16 rows, the last 8 wide where M % 16 is 1..8.
// The wgmma latency is hidden without reordering the sum: the products of
// kChains = 4 steps are issued back to back, each into its own fresh
// accumulator set, then one wait, then their adds into the running sum in
// the order of s (4 x 8 + 8 accumulator registers at n16). Adding step s
// while step s + 1 runs (two sets, a wait<1> between them) made ptxas
// serialize every wgmma (C7514: an accumulator read while another set's
// products were in flight). tools/mxu_dots_variants.py builds and times
// these choices (pipelined, 1, 2 or 8 sets, n8 units). What holds the
// route then: an m64nNk16 wgmma occupies an SM's tensor cores for about
// as long at N = 8 as at N = 16, so narrow units run at about half an
// SM's bf16 peak, and wider units would fill fewer SMs.
// Unit plan (mxu_probe.dots_plan mirrors it): q_dots 12 slabs x 10 chunks
// (nine n16, one n8) = 120 units, q_dots4 8 x 10 = 80, q_batch 8 entries
// x 2 x 2 = 32 tiles x 4 copies of 4 steps = 128: one warpgroup an SM of
// the 132.
//
// Streamed route (K > 304: q_bigdot, K = 18 944): the operands do not fit
// on chip, so each step re-streams them. Persistent blocks of one
// producer warp and one consumer warpgroup, two blocks an SM: the
// producer keeps TMA loads of k boxes of 64 in flight into a ring of
// stages (kRing bytes), each stage B's 64 x 64 box (MN-major, the
// 128-byte swizzle) and A's NS x 64 box (K-major, the same swizzle), TMA
// filling zeros past the edges; the consumer runs WgmmaSS<NS>::mma<1>
// (A transposed) over the stage's four k16 steps into a fresh product and
// adds it into its running sum after the last box. Within one step's
// product the order over k is free, as for the plain @. NS: M in
// ceil(M / 128) chunks, each rounded up to 16 rows (q_bigdot: two of 80,
// 12 slabs, 24 tiles x 11 copies = 264 units). Where K or N is not a
// multiple of 8 (no TMA map), the producer warp writes the boxes itself
// in the same swizzle.
//
// Element questions (ssq_mxu_elem), one output element a thread (q_bbuild:
// one column pair of six), its accumulator in a register:
//   0 trans     out (T, NA) = float(K32.T), through a 32 x 33 tile
//   1 repeat    out (NA, 16T)[i, j] = (KLO[i, j/16] == j%16) ? V[i, j/16] : 0
//   2 bcast     out (NA, 16T)[i, 16G g + r G + c] = V[i, G g + c]
//   3 slice128  out (NA, 128) = sum over steps, g < NG of BALL[:, 128g:128g+128]
//   4 abuild    out (F1 G, NA)[r, c] = sum over steps, g of
//               (KHT[G g + r % G, c] == r / G)
//   5 strided   out (F1, 128) = sum over steps, g of sum_{r<G} D[r::G]
//               (summed from 0, r in order)
//   6 bbuild    out (NA, 768): the six 128-column pieces (hi, mid, lo of Br,
//               then of Bi; Br = sel ? v : 0, Bi = sel ? v / 2 : 0, sel =
//               KLR == lane / G) of bf16 splits, summed over steps and g
// Every element question is exact against its plain version: the same
// float32 operations in the same order (integer counts, copies, selects,
// bf16 roundings to nearest even).
//
// What bounds them: the tensor cores' bf16 rate for the dots; bytes or
// float32 operations for the element questions (the steps multiply the
// operations, not the bytes: inputs read once, outputs written once).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kSlab = 64;          // out's columns a unit: one m64 slab
constexpr int kUnitN = 16;        // out's rows a resident unit
constexpr int kMaxKT = 19;         // k16 tiles of the fixed operand held
constexpr int kResidentK = 16 * kMaxKT;  // in registers: K <= 304
constexpr int kChains = 4;         // steps in flight before one wait
constexpr int kStreamMaxN = 128;   // out's rows a streamed unit, at most
constexpr int kBox = 64;           // k a streamed box: 128 bytes of bf16
constexpr int kRing = 96 * 1024;   // a streamed block's ring of stages
constexpr int kStreamBlocks = 2;   // streamed blocks an SM (the ring)
constexpr int kWG = 128;           // a warpgroup
constexpr int kStreamThreads = kWG + 32;  // and the producer warp
constexpr int kThreads = 256;

static_assert(kUnitN == 8 || kUnitN == 16, "WgmmaRS has n8 and n16");

enum Question {
  kTrans = 0, kRepeat, kBcast, kSlice128, kABuild, kStrided, kBBuild
};

// Unit u of a dots launch: batch entry, first column n0 (a slab of 64),
// first row m0 and rows (the last chunk's rounded up to 8) of out, and
// its copy; units run copy-fastest, then chunk, slab, entry.
struct Unit {
  int bat, n0, m0, width, copy;
};

__device__ __forceinline__ Unit unit_at(long long u, int slabs, int chunks,
                                        int copies, int W, int M) {
  const int copy = (int)(u % copies);
  u /= copies;
  const int chunk = (int)(u % chunks);
  u /= chunks;
  const int m0 = chunk * W, rest = M - m0;
  return {(int)(u / slabs), (int)(u % slabs) * kSlab, m0,
          rest >= W ? W : (rest + 7) / 8 * 8, copy};
}

// The steps copy c of `copies` runs: c, c + copies, ...
__device__ __forceinline__ int steps_of(int steps, int copy, int copies) {
  return steps > copy ? (steps - copy + copies - 1) / copies : 0;
}

// out[m][n] of a unit's tile from the accumulator fragment: d[4t + e] is
// row 16 wq + g + 8 (e >> 1) of the slab (out's column), column 8t + 2q +
// (e & 1) of the chunk (out's row)
template <int W>
__device__ __forceinline__ void store_tile(const float (&run)[W / 2],
                                           float* o, int M, int N, int n0,
                                           int m0) {
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int t = 0; t < W / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + 16 * wq + g + 8 * (e >> 1);
      const int m = m0 + 8 * t + 2 * q + (e & 1);
      if (m < M && n < N) o[(long long)m * N + n] = run[4 * t + e];
    }
}

// -- resident route -----------------------------------------------------------
// One step's product into acc: kMaxKT k16 wgmmas (zeros past K), A (the
// slab) from registers, B (the chunk) from shared memory at desc, tile kt
// 32 W bytes on (the descriptor counts 16-byte units). The operands'
// registers and the accumulator are fenced so that no other instruction
// touches them while the products are in flight.
template <int W>
__device__ __forceinline__ void issue(float (&acc)[W / 2],
                                      uint32_t (&fa)[kMaxKT][4],
                                      uint64_t desc) {
  auto fence = [&]() {
#pragma unroll
    for (int e = 0; e < W / 2; ++e) ssq::fence_operand(acc[e]);
#pragma unroll
    for (int kt = 0; kt < kMaxKT; ++kt)
#pragma unroll
      for (int j = 0; j < 4; ++j) ssq::fence_operand(fa[kt][j]);
  };
  fence();
  ssq::wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < kMaxKT; ++kt)
    ssq::WgmmaRS<W>::mma(acc, fa[kt], desc + (uint64_t)(2 * W * kt), kt);
  ssq::wgmma_commit();
  fence();
}

// The unit's ns products and its running sum, then its tile out: the
// products of kChains steps are issued back to back, each into its own
// fresh accumulator set, then one wait, then their adds into the sum in
// step order. An accumulator is read only after the wait that covers
// every product in flight: reading one while another's products run
// (a wait<1> between two sets) made ptxas serialize every wgmma.
template <int W>
__device__ __forceinline__ void resident_unit(uint32_t (&fa)[kMaxKT][4],
                                              uint64_t desc, int ns,
                                              int accumulate, long long zero,
                                              float* o, int M, int N, int n0,
                                              int m0) {
  constexpr int NR = W / 2;
  float run[NR], acc[kChains][NR];
#pragma unroll
  for (int e = 0; e < NR; ++e) run[e] = 0.f;
  // step i's operand: the resident chunk at i * zero (always 0) bytes on
  auto at = [&](int i) { return desc + (uint64_t)(i * zero); };
  auto take = [&](float (&a)[NR]) {   // after the wait that covers a
#pragma unroll
    for (int e = 0; e < NR; ++e) {
      ssq::fence_operand(a[e]);
      run[e] = accumulate ? __fadd_rn(run[e], a[e]) : a[e];
    }
  };
  int i = 0;
  for (; i + kChains <= ns; i += kChains) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) issue<W>(acc[c], fa, at(i + c));
    ssq::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kChains; ++c) take(acc[c]);
  }
  for (; i < ns; ++i) {   // the last ns % kChains steps, one at a time
    issue<W>(acc[0], fa, at(i));
    ssq::wgmma_wait<0>();
    take(acc[0]);
  }
  store_tile<W>(run, o, M, N, n0, m0);
}

// Shared memory: B's slab [kp][64] (bf16 bits, 128-byte rows), A's chunk
// (kMaxKT tiles of 32 * width bytes), then the loads' mbarrier; kp =
// kResidentK whatever K, zeros past it.
__global__ void __launch_bounds__(kWG)
dots_resident(const uint16_t* __restrict__ A, const uint16_t* __restrict__ B,
              float* __restrict__ out, int M, int K, int N, int steps,
              int accumulate, int slabs, int chunks, int copies,
              long long units, int vec_a, int vec_b, long long zero) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kp = kResidentK;
  uint16_t* sB = reinterpret_cast<uint16_t*>(smem_raw);
  unsigned char* sA = smem_raw + kp * kSlab * 2;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sA + kMaxKT * 32 * kUnitN);
  const int tid = threadIdx.x, lane = tid & 31, wq = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  if (tid == 0) {
    ssq::mbar_init(bar, kWG);
    ssq::mbar_init_fence();
  }
  __syncthreads();
  uint32_t phase = 0;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit U = unit_at(u, slabs, chunks, copies, kUnitN, M);
    const uint16_t* a = A + (long long)U.bat * M * K;
    const uint16_t* b = B + (long long)U.bat * K * N;
    // 1. the unit's operands into shared memory, once
    if (vec_b) {
      for (int e = tid; e < kp * 8; e += kWG) {
        const int k = e >> 3, n = U.n0 + 8 * (e & 7);
        uint16_t* dst = sB + k * kSlab + 8 * (e & 7);
        if (k < K && n < N)
          ssq::cp_async16(dst, b + (long long)k * N + n);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    } else {
      for (int e = tid; e < kp * kSlab; e += kWG) {
        const int k = e / kSlab, n = U.n0 + e % kSlab;
        sB[e] = k < K && n < N ? b[(long long)k * N + n] : 0;
      }
    }
    const int W = U.width;
    if (vec_a) {
      const int kc = kp / 8;   // 16-byte pieces of a row
      for (int e = tid; e < W * kc; e += kWG) {
        const int r = e / kc, c = e % kc, m = U.m0 + r;
        unsigned char* dst = sA + (c >> 1) * 32 * W + (c & 1) * 128 +
                             (r >> 3) * 256 + (r & 7) * 16;
        if (m < M && 8 * c < K)
          ssq::cp_async16(dst, a + (long long)m * K + 8 * c);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    } else {
      for (int e = tid; e < W * kp; e += kWG) {
        const int r = e / kp, k = e % kp, m = U.m0 + r;
        uint16_t* dst = reinterpret_cast<uint16_t*>(
                            sA + (k >> 4) * 32 * W + ((k >> 3) & 1) * 128 +
                            (r >> 3) * 256 + (r & 7) * 16) +
                        (k & 7);
        *dst = m < M && k < K ? a[(long long)m * K + k] : 0;
      }
    }
    ssq::cp_async_arrive(bar);
    ssq::mbar_wait(bar, phase);
    phase ^= 1;
    ssq::fence_proxy_async();   // the generic zeros, before wgmma reads
    __syncthreads();
    // 2. B's slab into registers: the fixed A operand of every step
    uint32_t fa[kMaxKT][4];
    auto pair = [&](int k, int n) {   // (k, n) and (k + 1, n), low k low
      return (uint32_t)sB[k * kSlab + n] |
             ((uint32_t)sB[(k + 1) * kSlab + n] << 16);
    };
#pragma unroll
    for (int kt = 0; kt < kMaxKT; ++kt) {
      const int k = 16 * kt + 2 * q, n = 16 * wq + g;
      fa[kt][0] = pair(k, n);
      fa[kt][1] = pair(k, n + 8);
      fa[kt][2] = pair(k + 8, n);
      fa[kt][3] = pair(k + 8, n + 8);
    }
    // 3. the unit's steps (a tail chunk of 8 rows: its own instantiation)
    const int ns = steps_of(steps, U.copy, copies);
    float* o = out + (long long)U.bat * M * N;
    if (W == kUnitN)
      resident_unit<kUnitN>(fa, ssq::desc_kmajor(sA), ns, accumulate, zero,
                            o, M, N, U.n0, U.m0);
    else
      resident_unit<8>(fa, ssq::desc_kmajor(sA), ns, accumulate, zero, o, M,
                       N, U.n0, U.m0);
    __syncthreads();   // every product read the operands before the next unit
  }
}

// -- streamed route -----------------------------------------------------------
template <int NS>
struct Stream {
  static constexpr int B_BOX = kBox * kSlab * 2;  // B: 64 k x 64 columns
  static constexpr int A_BOX = NS * kBox * 2;     // A: NS rows x 64 k
  static constexpr int STAGE = B_BOX + A_BOX;
  static constexpr int STAGES = kRing / STAGE;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
};

// A box of `rows` 128-byte rows in the 128-byte swizzle, written by the
// producer warp where there is no TMA map: element (r, c) of the source
// at(r, c), zero where !in(r, c).
template <typename At>
__device__ __forceinline__ void fill_box(uint16_t* box, int rows, At at) {
  for (int e = threadIdx.x & 31; e < rows * 64; e += 32) {
    const int r = e >> 6, c = e & 63;
    box[r * 64 + (((c >> 3) ^ (r & 7)) << 3) + (c & 7)] = at(r, c);
  }
}

// ta: A (K, M, batch), boxes 64 x NS; tb: B (N, K, batch), boxes 64 x 64.
template <int NS>
__global__ void __launch_bounds__(kStreamThreads, 1)
dots_streamed(const __grid_constant__ CUtensorMap ta,
              const __grid_constant__ CUtensorMap tb,
              const uint16_t* __restrict__ A, const uint16_t* __restrict__ B,
              float* __restrict__ out, int M, int K, int N, int steps,
              int accumulate, int slabs, int chunks, int copies,
              long long units, int tma, long long zero) {
  using S = Stream<NS>;
  constexpr int NR = NS / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (ssq::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::STAGES * S::STAGE);
  uint64_t* empty = full + S::STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      ssq::mbar_init(&full[s], 1);
      ssq::mbar_init(&empty[s], 1);
    }
    ssq::mbar_init_fence();
  }
  __syncthreads();
  const int kboxes = (K + kBox - 1) / kBox;
  int stage = 0;
  uint32_t phase = 0;
  auto next = [&]() {
    if (++stage == S::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };

  if (warp == 4) {
    // the producer: every box of every step of every unit of this block,
    // in the consumer's order
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit U = unit_at(u, slabs, chunks, copies, NS, M);
      const int ns = steps_of(steps, U.copy, copies);
      const uint16_t* a = A + (long long)U.bat * M * K;
      const uint16_t* b = B + (long long)U.bat * K * N;
      for (int i = 0; i < ns; ++i) {
        // step i's boxes at k + (its step) * zero: always k
        const int off = (int)((U.copy + (long long)i * copies) * zero);
        for (int kb = 0; kb < kboxes; ++kb) {
          ssq::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * S::STAGE;
          const int k0 = kb * kBox + off;
          if (tma) {
            if (lane == 0) {
              ssq::tma_expect(&full[stage], S::STAGE);
              ssq::tma_load(st, &tb, U.n0, k0, U.bat, &full[stage]);
              ssq::tma_load(st + S::B_BOX, &ta, k0, U.m0, U.bat,
                            &full[stage]);
            }
          } else {
            fill_box(reinterpret_cast<uint16_t*>(st), kBox,
                     [&](int r, int c) -> uint16_t {
                       const int k = k0 + r, n = U.n0 + c;
                       return k < K && n < N ? b[(long long)k * N + n] : 0;
                     });
            fill_box(reinterpret_cast<uint16_t*>(st + S::B_BOX), NS,
                     [&](int r, int c) -> uint16_t {
                       const int m = U.m0 + r, k = k0 + c;
                       return m < M && k < K ? a[(long long)m * K + k] : 0;
                     });
            ssq::fence_proxy_async();
            __syncwarp();
            if (lane == 0) ssq::mbar_arrive(&full[stage]);
          }
          next();
        }
      }
    }
  } else {
    // the consumer warpgroup
    const bool signals = threadIdx.x == 0;
    float acc[NR], run[NR];
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit U = unit_at(u, slabs, chunks, copies, NS, M);
      const int ns = steps_of(steps, U.copy, copies);
#pragma unroll
      for (int e = 0; e < NR; ++e) run[e] = 0.f;
      for (int i = 0; i < ns; ++i) {
        int held = 0;
        for (int kb = 0; kb < kboxes; ++kb) {
          ssq::mbar_wait(&full[stage], phase);
          const unsigned char* st = ring + stage * S::STAGE;
          const uint64_t da = ssq::desc_sw128(st);
          const uint64_t db = ssq::desc_sw128(st + S::B_BOX);
#pragma unroll
          for (int e = 0; e < NR; ++e) ssq::fence_operand(acc[e]);
          ssq::wgmma_fence();
#pragma unroll
          for (int j = 0; j < kBox / 16; ++j)
            ssq::WgmmaSS<NS>::template mma<1>(acc, da + 128 * j, db + 2 * j,
                                              (kb | j) != 0);
          ssq::wgmma_commit();
#pragma unroll
          for (int e = 0; e < NR; ++e) ssq::fence_operand(acc[e]);
          if (kb > 0) {
            ssq::wgmma_wait<1>();   // the previous stage's products are done
            if (signals) ssq::mbar_arrive(&empty[held]);
          }
          held = stage;
          next();
        }
        ssq::wgmma_wait<0>();
        if (signals) ssq::mbar_arrive(&empty[held]);
#pragma unroll
        for (int e = 0; e < NR; ++e) {
          ssq::fence_operand(acc[e]);
          run[e] = accumulate ? __fadd_rn(run[e], acc[e]) : acc[e];
        }
      }
      store_tile<NS>(run, out + (long long)U.bat * M * N, M, N, U.n0, U.m0);
    }
  }
}

__global__ void trans_kernel(const int* __restrict__ in, float* __restrict__ out,
                             int rows, int cols, int steps, long long zero) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int s = 0; s < steps; ++s) {
    const int* src = in + s * zero;
    float* dst = out + s * zero;
    for (int j = ty; j < 32; j += 8) {
      const int r = r0 + j, c = c0 + tx;
      if (r < rows && c < cols) tile[j][tx] = (float)src[(long long)r * cols + c];
    }
    __syncthreads();
    for (int j = ty; j < 32; j += 8) {
      const int c = c0 + j, r = r0 + tx;
      if (c < cols && r < rows) dst[(long long)c * rows + r] = tile[tx][j];
    }
    __syncthreads();
  }
}

// d0 = NA, d1 = T
__global__ void repeat_kernel(const int* __restrict__ klo,
                              const float* __restrict__ v,
                              float* __restrict__ out, int na, int T, int steps,
                              long long zero) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)na * 16 * T) return;
  const long long i = idx / (16 * T);
  const int j = (int)(idx - i * 16 * T);
  const long long src = i * T + (j >> 4);
  for (int s = 0; s < steps; ++s)
    out[idx + s * zero] =
        klo[src + s * zero] == (j & 15) ? v[src + s * zero] : 0.f;
}

// d0 = NA, d1 = T, d2 = G
__global__ void bcast_kernel(const float* __restrict__ v, float* __restrict__ out,
                             int na, int T, int G, int steps, long long zero) {
  const int W = (T / G) * 16 * G;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)na * W) return;
  const long long i = idx / W;
  const int j = (int)(idx - i * W);
  const long long src = i * T + (j / (16 * G)) * G + j % G;
  for (int s = 0; s < steps; ++s) out[idx + s * zero] = v[src + s * zero];
}

// d0 = NA, d1 = W (BALL's row width), d2 = NG
__global__ void slice128_kernel(const float* __restrict__ ball,
                                float* __restrict__ out, int na, int W, int ng,
                                int steps, long long zero) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)na * 128) return;
  const long long i = idx >> 7;
  const int c = (int)(idx & 127);
  float acc = 0.f;
  for (int s = 0; s < steps; ++s) {
    const float* row = ball + s * zero + i * W + c;
    for (int g = 0; g < ng; ++g) acc = __fadd_rn(acc, row[g * 128]);
  }
  out[idx] = acc;
}

// d0 = NA, d1 = NG, d2 = G, d3 = F1
__global__ void abuild_kernel(const int* __restrict__ kht,
                              float* __restrict__ out, int na, int ng, int G,
                              int f1s, int steps, long long zero) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)f1s * G * na) return;
  const int r = (int)(idx / na), c = (int)(idx - (long long)r * na);
  const int f1 = r / G, rr = r % G;
  float acc = 0.f;
  for (int s = 0; s < steps; ++s) {
    const int* col = kht + s * zero + (long long)rr * na + c;
    for (int g = 0; g < ng; ++g)
      acc = __fadd_rn(acc, col[(long long)g * G * na] == f1 ? 1.f : 0.f);
  }
  out[idx] = acc;
}

// d0 = M (rows of D, F1 * G), d1 = L (its columns), d2 = G, d3 = NG
__global__ void strided_kernel(const float* __restrict__ d,
                               float* __restrict__ out, int M, int L, int G,
                               int ng, int steps, long long zero) {
  const int f1s = M / G;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)f1s * L) return;
  const int f = (int)(idx / L), c = (int)(idx - (long long)f * L);
  float acc = 0.f;
  for (int s = 0; s < steps; ++s) {
    for (int g = 0; g < ng; ++g) {
      const float* col = d + (s * ng + g) * zero + (long long)f * G * L + c;
      float sum = 0.f;
      for (int r = 0; r < G; ++r) sum = __fadd_rn(sum, col[(long long)r * L]);
      acc = __fadd_rn(acc, sum);
    }
  }
  out[idx] = acc;
}

// x = hi + mid + lo in bf16 (each rounded to nearest even), as
// tools/mxu_probe2.py's split3
__device__ __forceinline__ void split3(float x, float (&p)[3]) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  const float r1 = __fsub_rn(x, __bfloat162float(h));
  const __nv_bfloat16 m = __float2bfloat16_rn(r1);
  const __nv_bfloat16 l = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(m)));
  p[0] = __bfloat162float(h);
  p[1] = __bfloat162float(m);
  p[2] = __bfloat162float(l);
}

// d0 = NA, d1 = W (the operands' row width), d2 = NG, d3 = G
__global__ void bbuild_kernel(const int* __restrict__ klr,
                              const float* __restrict__ vrr,
                              float* __restrict__ out, int na, int W, int ng,
                              int G, int steps, long long zero) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)na * 128) return;
  const long long i = idx >> 7;
  const int c = (int)(idx & 127);
  const int f0 = c / G;
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < steps; ++s) {
    const long long o = s * zero + i * W + c;
    for (int g = 0; g < ng; ++g) {
      const bool sel = klr[o + g * 128] == f0;
      const float v = vrr[o + g * 128];
      float pr[3], pi[3];
      split3(sel ? v : 0.f, pr);
      split3(sel ? __fmul_rn(v, 0.5f) : 0.f, pi);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        acc[p] = __fadd_rn(acc[p], pr[p]);
        acc[3 + p] = __fadd_rn(acc[3 + p], pi[p]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < 6; ++p) out[i * 768 + p * 128 + c] = acc[p];
}


// -- the dots' plan and launches ----------------------------------------------
// mxu_probe.dots_plan mirrors it.
struct Plan {
  int route;    // 0 resident, 1 streamed
  int width;    // out's rows a unit (the wgmma N; a resident tail 8)
  int slabs, chunks, copies;
  long long tiles, units;
};

Plan plan_dots(int batch, int M, int K, int N, int steps, int accumulate,
               int sms) {
  Plan P;
  P.route = (K + 15) / 16 * 16 <= kResidentK ? 0 : 1;
  if (P.route == 0) {
    P.width = kUnitN;
  } else {
    const int parts = (M + kStreamMaxN - 1) / kStreamMaxN;
    P.width = ((M + parts - 1) / parts + 15) / 16 * 16;
  }
  P.chunks = (M + P.width - 1) / P.width;
  P.slabs = (N + kSlab - 1) / kSlab;
  P.tiles = (long long)batch * P.slabs * P.chunks;
  // without `accumulate` the steps are independent: copies of each tile
  // take them in turn, as many as fill the card's slots once
  long long copies = 1;
  if (!accumulate && steps > 1) {
    copies = (long long)sms * (P.route ? kStreamBlocks : 1) / P.tiles;
    if (copies < 1) copies = 1;
    if (copies > steps) copies = steps;
  }
  P.copies = (int)copies;
  P.units = P.tiles * P.copies;
  return P;
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// Calls f(std::integral_constant<int, NS>{}) for the streamed width NS
// (16, 32, ..., kStreamMaxN) and returns what it returns.
template <typename F>
int with_width(int width, F&& f) {
  switch (width) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
  }
  return (int)cudaErrorInvalidValue;
}

// The launch of a plan: its kernel, block size and shared memory, and
// the blocks that fit on the card (each walks units u, u + blocks, ...).
struct Launch {
  const void* kernel;
  int threads, smem, blocks, per_sm;
};

int launch_of(const Plan& P, int sms, Launch* L) {
  if (P.route == 0) {
    *L = {reinterpret_cast<const void*>(dots_resident), kWG,
          kResidentK * kSlab * 2 + kMaxKT * 32 * kUnitN + 8, 0, 0};
  } else if (int err = with_width(P.width, [&](auto ns) {
               constexpr int NS = decltype(ns)::value;
               *L = {reinterpret_cast<const void*>(dots_streamed<NS>),
                     kStreamThreads, Stream<NS>::SMEM, 0, 0};
               return 0;
             })) {
    return err;
  }
  if (int err = allow_smem(L->kernel, L->smem)) return err;
  int fit = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &fit, L->kernel, L->threads, L->smem);
  if (err != cudaSuccess) return (int)err;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  long long blocks = (long long)fit * sms;
  if (P.units < blocks) blocks = P.units;
  if (blocks < 1) blocks = 1;
  L->blocks = (int)blocks;
  L->per_sm = (int)((blocks + sms - 1) / sms);
  return 0;
}

bool bad_dots(int batch, int M, int K, int N, int steps) {
  return batch < 1 || batch > 65535 || M < 1 || K < 1 || N < 1 || steps < 0;
}

// The map of a row-major bf16 operand p (items x rows x cols), boxes of
// box_rows rows x 64 columns in the 128-byte swizzle, zeros past the
// edges.
bool operand_map(CUtensorMap* tm, const void* p, int cols, int rows,
                 int items, int box_rows) {
  const ssq::EncodeTiled encode = ssq::tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)items};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)cols * 2 * rows};
  const cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(p), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

unsigned blocks(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// A (batch, M, K), B (batch, K, N) bf16, out (batch, M, N) float32,
// row-major. steps products, accumulated over the steps or each step's
// alone. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssq_mxu_dots(const void* A, const void* B, float* out,
                            int batch, int M, int K, int N, int steps,
                            int accumulate, void* stream) {
  if (bad_dots(batch, M, K, N, steps)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  if (int err = device_sms(&sms)) return err;
  const Plan P = plan_dots(batch, M, K, N, steps, accumulate, sms);
  Launch L;
  if (int err = launch_of(P, sms, &L)) return err;
  const uint16_t* a = reinterpret_cast<const uint16_t*>(A);
  const uint16_t* b = reinterpret_cast<const uint16_t*>(B);
  cudaStream_t s = (cudaStream_t)stream;
  if (P.route == 0) {
    dots_resident<<<L.blocks, L.threads, L.smem, s>>>(
        a, b, out, M, K, N, steps, accumulate, P.slabs, P.chunks, P.copies,
        P.units, K % 8 == 0 && aligned16(A), N % 8 == 0 && aligned16(B),
        0LL);
    return (int)cudaGetLastError();
  }
  CUtensorMap tm[2] = {};
  const int tma = K % 8 == 0 && N % 8 == 0 && aligned16(A) &&
                  aligned16(B) &&
                  operand_map(&tm[0], A, K, M, batch, P.width) &&
                  operand_map(&tm[1], B, N, K, batch, kBox);
  return with_width(P.width, [&](auto ns) {
    constexpr int NS = decltype(ns)::value;
    dots_streamed<NS><<<L.blocks, L.threads, L.smem, s>>>(
        tm[0], tm[1], a, b, out, M, K, N, steps, accumulate, P.slabs,
        P.chunks, P.copies, P.units, tma, 0LL);
    return (int)cudaGetLastError();
  });
}

// The plan ssq_mxu_dots takes for these shapes on the current device,
// into plan[8]: route (0 resident, 1 streamed), width (out's rows a
// unit), slabs, chunks, copies, units, blocks launched, warpgroups an SM.
// Returns a CUDA error code (0 on success).
extern "C" int ssq_mxu_dots_plan(int batch, int M, int K, int N, int steps,
                                 int accumulate, int* plan) {
  if (bad_dots(batch, M, K, N, steps)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  if (int err = device_sms(&sms)) return err;
  const Plan P = plan_dots(batch, M, K, N, steps, accumulate, sms);
  Launch L;
  if (int err = launch_of(P, sms, &L)) return err;
  const long long units = P.units < INT_MAX ? P.units : INT_MAX;
  const int v[8] = {P.route, P.width, P.slabs, P.chunks, P.copies,
                    (int)units, L.blocks, L.per_sm};
  for (int i = 0; i < 8; ++i) plan[i] = v[i];
  return 0;
}

// One element question (see above for d0..d3 and the layouts); int32
// and float32 operands, row-major; zero must be 0 (each step's offset).
// Returns cudaGetLastError() after the launch.
extern "C" int ssq_mxu_elem(int question, const void* in0, const void* in1,
                            float* out, int d0, int d1, int d2, int d3,
                            int steps, long long zero, void* stream) {
  if (d0 < 1 || d1 < 1 || steps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* i0 = reinterpret_cast<const int*>(in0);
  const float* f0 = reinterpret_cast<const float*>(in0);
  switch (question) {
    case kTrans:
      trans_kernel<<<dim3((d1 + 31) / 32, (d0 + 31) / 32), dim3(32, 8), 0, s>>>(
          i0, out, d0, d1, steps, zero);
      break;
    case kRepeat:
      repeat_kernel<<<blocks((long long)d0 * 16 * d1), kThreads, 0, s>>>(
          i0, reinterpret_cast<const float*>(in1), out, d0, d1, steps, zero);
      break;
    case kBcast:
      if (d2 < 1 || d1 % d2) return (int)cudaErrorInvalidValue;
      bcast_kernel<<<blocks((long long)d0 * 16 * d1), kThreads, 0, s>>>(
          f0, out, d0, d1, d2, steps, zero);
      break;
    case kSlice128:
      if (d1 < d2 * 128) return (int)cudaErrorInvalidValue;
      slice128_kernel<<<blocks((long long)d0 * 128), kThreads, 0, s>>>(
          f0, out, d0, d1, d2, steps, zero);
      break;
    case kABuild:
      if (d2 < 1 || d3 < 1) return (int)cudaErrorInvalidValue;
      abuild_kernel<<<blocks((long long)d3 * d2 * d0), kThreads, 0, s>>>(
          i0, out, d0, d1, d2, d3, steps, zero);
      break;
    case kStrided:
      if (d2 < 1 || d0 % d2) return (int)cudaErrorInvalidValue;
      strided_kernel<<<blocks((long long)(d0 / d2) * d1), kThreads, 0, s>>>(
          f0, out, d0, d1, d2, d3, steps, zero);
      break;
    case kBBuild:
      if (d3 < 1 || d1 < d2 * 128) return (int)cudaErrorInvalidValue;
      bbuild_kernel<<<blocks((long long)d0 * 128), kThreads, 0, s>>>(
          i0, reinterpret_cast<const float*>(in1), out, d0, d1, d2, d3, steps,
          zero);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
