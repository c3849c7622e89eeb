// Probe J5: the in-kernel tensor-core rate by shape and precision, with
// independent chains, and the shared-memory rate, for sm_90a.
//
// Replaces the TPU probes of tools/mxu_rate_probe.py: dot_probe (its
// pallas_call at :47), copy_probe (:70) and dot_probe_chains (:153).
// Functions, with A_s the s-th (m, k) slice of A's rows:
//
//   dot     out = sum_{i<R} A_{i % 2} @ B                     (m, n) float32
//   chains  out_c = sum_{i<R} A_{(i + c) % (C + 1)} @ B, c < C   (C, m, n)
//   copy    out = sum_{i<R} A_{i % 2}                          (m, n) float32
//
// The TPU ran GRID steps in order on one core, each recomputing the same
// output from operands resident in VMEM. Here the GRID steps are copies:
// each copy of each output tile does all R products itself and writes
// the same values (every copy sums in the same order, so the result is
// deterministic), and the whole card is busy: the rate is GRID * R * C *
// 2mkn over the time.
//
// Dots and chains, in two launches:
//  1. rate_prep_kernel writes the operands once a call into the scratch
//     the wrapper allocates: A's slices (slices, m, kp) and B transposed
//     (n, kp), K-major, rounded as the precision wants (bf16 by
//     __float2bfloat16_rn, as JAX's astype; TF32 by cvt.rna; 3xTF32 as hi
//     = tf32(v) and lo = tf32(v - hi), each its own buffer), k padded
//     with zeros to kp, a multiple of the TMA box (64 bf16, 32 float), so
//     every row is a whole number of 128-byte lines.
//  2. rate_dot_kernel: persistent blocks of two consumer warpgroups and
//     one producer warp. The producer's one thread keeps TMA loads of k
//     boxes in flight into a ring of 6 stages (4 for 3xTF32) of 1024-byte
//     aligned boxes in the 128-byte swizzle, each stage completing on its
//     full mbarrier and freed on its empty one; it runs straight on from
//     one product's last box into the next product's first (the A slice
//     is one more box coordinate) and from one tile into the next. Each
//     consumer warpgroup runs wgmma over the stages from the swizzled
//     descriptors into a fresh accumulator (scale-d 0 on a product's first
//     k-step) and, when the product is done, adds it into its running sum
//     in registers in float32 (__fadd_rn): the TPU kernel's acc + dot.
//       bf16    m64n128k16, a warpgroup's tile 64 x 128
//       tf32    m64n128k8
//       3xtf32  m64n64k8: hi*lo and lo*hi into their own accumulator,
//               then hi*hi; three accumulator sets (fresh, small terms,
//               running sum) of 32 a thread, where n128 would take 192
//               and spill (no setmaxnreg: the block's 288 threads may
//               hold 224 registers each)
//     A box is 64 rows x 128 bytes (one warpgroup's A at one k box), B's
//     128 (64) rows: TMA fills the edges in m and n with zeros, and the
//     stores mask them.
//     Chains (C > 1, bf16): the two warpgroups of a block take two chains
//     (2z and 2z + 1 for the block's z < C/2) over the same 64 x 128
//     output tile, so one B box a k-step serves both products and each
//     warpgroup has one A box of its own slice; the chain pairs are spread
//     over the blocks. A warpgroup keeps one product (64 + 64 registers
//     with its running sum), as for the dot, so the operand bytes a flop
//     are the dot's at every C; the chains in flight on an SM are the
//     two warpgroups' (the TPU probe's question: do independent
//     accumulators hide the latency?).
//     Clusters: where GRID is even, the two copies of a unit run as a
//     cluster of two blocks (on neighbouring SMs, scheduled together),
//     each loading its own boxes, which ran faster on the H100 than the
//     same blocks unclustered (chip_smoke.py phase 22 times an odd GRID,
//     which runs unclustered). TMA multicast of the boxes (each block
//     loading half of every stage into both) was slower: a stage is then
//     freed only when both blocks are done with it, and the operand feed
//     it halves was not the limit. An odd GRID runs unclustered.
//
// Copy: as on the TPU, whose GRID steps reran the sum on slices resident
// in VMEM, each tile of A is loaded once and the GRID copies are a loop
// over operands resident in registers. Persistent blocks (two an SM) walk
// the output tiles of 2048 floats (block b: tiles b, b + blocks, ...).
// Thread 0 keeps three tiles' two slices in flight ahead of the one in
// use, by TMA bulk copies into a ring of four stages (8 KB a slice), each
// completing on its stage's mbarrier. Each thread takes its 8 floats of
// each slice into registers (a barrier frees the stage) and runs every
// copy there: R adds of the slices in turn from +0 (__fadd_rn, the plain
// order). The copies must not fold into one: each copy starts from the
// bits of the last copy's sums ANDed with a kernel argument that is 0,
// which no compiler can see through, so each copy depends on the one
// before and none can be merged, hoisted or dropped. (fence_operand, an
// empty inline statement, emits no instruction: with fences in its place
// and the copy loop unrolled by two, the kernel ran its copies faster
// than the lanes can add, so copies had been merged.) The last copy's
// sums are stored once.
//
// What bounds them: the tensor cores' rate of the precision for the dots
// (989 TFLOP/s bf16, 495 TF32, 3xTF32 a third of that); for the copy,
// the adds (GRID * R * m * n, one lane's __fadd_rn a clock: 33.5 T adds/s
// at 132 SMs x 128 lanes x 1.98 GHz) over the bytes of A and out. A 128 x
// 128 tile reads 64 flop a byte of operands into shared memory (32 in
// TF32) from L2, and its wgmma read A and B back from shared memory for
// every product.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

enum Precision { kBF16 = 0, kTF32 = 1, k3xTF32 = 2 };

constexpr int kCopyThreads = 256;
constexpr int kCopyPer = 8;                          // floats a thread a slice
constexpr int kCopyTile = kCopyThreads * kCopyPer;  // floats a tile a slice
constexpr int kCopyStages = 4;
constexpr int kCopyBlocksPerSM = 2;

constexpr int kConsumers = 2;                  // warpgroups a block
constexpr int kDotThreads = 128 * kConsumers + 32;   // and a producer warp
constexpr int kWgRows = 64;                    // a warpgroup's rows
constexpr int kRing = 192 * 1024;              // shared memory of the ring
constexpr int kPrepThreads = 256;              // 32 x 8, a 32 x 32 tile

template <int P>
struct Op {
  using T = typename std::conditional<P == kBF16, __nv_bfloat16, float>::type;
  static constexpr int KB = 128 / (int)sizeof(T);   // k a box: one line
  static constexpr int KSTEP = P == kBF16 ? 16 : 8;  // k a wgmma
  static constexpr int N = P == k3xTF32 ? 64 : 128;  // a warpgroup's columns
  static constexpr int PARTS = P == k3xTF32 ? 2 : 1; // hi (and lo)
  static constexpr int A_BOX = kWgRows * 128;        // bytes
  static constexpr int B_BOX = N * 128;
  static constexpr int PART = kConsumers * A_BOX + B_BOX;  // a stage's hi
  static constexpr int STAGE = PARTS * PART;
  static constexpr int STAGES = kRing / STAGE;             // 6 or 4
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
};

template <int P>
__device__ __forceinline__ void mma(float (&d)[Op<P>::N / 2], uint64_t a,
                                    uint64_t b, int scale_d) {
  if constexpr (P == kBF16)
    ssq::WgmmaSS<128>::mma(d, a, b, scale_d);
  else
    ssq::WgmmaTF32<Op<P>::N>::mma(d, a, b, scale_d);
}

// Unit u of a launch: output tile `tile` (rows row0.., columns col0..) of
// chain pair z; the units of a launch are every (z, tile) once a cluster
// of copies, so the copies are units u, u + per, ...
struct Unit {
  int z, row0, col0;
};

__device__ __forceinline__ Unit unit_at(int u, int per, int tiles, int tiles_n,
                                        int bm, int bn) {
  const int zt = u % per, t = zt % tiles;
  return {zt / tiles, (t / tiles_n) * bm, (t % tiles_n) * bn};
}

// What warpgroup w takes of unit U: its first row and its chain (the dot:
// rows 64 w of the block's 128, chain 0; chains: the block's 64 rows,
// chain 2z + w); the slice of A its product i reads.
struct Part {
  int rows, chain;
};

__device__ __forceinline__ Part part_of(const Unit& U, int w, int C) {
  return C == 1 ? Part{U.row0 + kWgRows * w, 0} : Part{U.row0, 2 * U.z + w};
}

__device__ __forceinline__ int slice_of(int i, int chain, int C) {
  return C == 1 ? (i & 1) : (i + chain) % (C + 1);
}

// ta, tb: the hi operands' maps (A (kp, m, slices), B^T (kp, n)); ta_lo,
// tb_lo the lo ones (3xtf32). Boxes: A 64 rows, B N rows, of KB along k.
template <int P>
__global__ void __launch_bounds__(kDotThreads, 1)
rate_dot_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap ta_lo,
                const __grid_constant__ CUtensorMap tb_lo,
                float* __restrict__ out, int m, int n, int kboxes, int R,
                int C, int units, int cl) {
  using O = Op<P>;
  constexpr int NR = O::N / 2;   // accumulator registers a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (ssq::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + O::STAGES * O::STAGE);
  uint64_t* empty = full + O::STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < O::STAGES; ++s) {
      ssq::mbar_init(&full[s], 1);
      ssq::mbar_init(&empty[s], kConsumers);
    }
    ssq::mbar_init_fence();
  }
  __syncthreads();

  const int bm = C == 1 ? kConsumers * kWgRows : kWgRows;
  const int tiles_n = (n + O::N - 1) / O::N;
  const int tiles = (m + bm - 1) / bm * tiles_n;
  const int per = (C == 1 ? 1 : C / 2) * tiles;
  // the blocks of a cluster are copies: they walk the same units
  const int clusters = gridDim.x / cl, cluster = blockIdx.x / cl;

  if (warp == 4 * kConsumers) {
    // the producer: stage after stage, every box of every product of
    // every unit of this cluster, in the consumers' order
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = cluster; u < units; u += clusters) {
        const Unit U = unit_at(u, per, tiles, tiles_n, bm, O::N);
        const Part w0 = part_of(U, 0, C), w1 = part_of(U, 1, C);
        for (int i = 0; i < R; ++i) {
          const int s0 = slice_of(i, w0.chain, C), s1 = slice_of(i, w1.chain, C);
          for (int kb = 0; kb < kboxes; ++kb) {
            ssq::mbar_wait(&empty[stage], phase ^ 1);
            uint64_t* bar = &full[stage];
            ssq::tma_expect(bar, O::STAGE);
            const int x = kb * O::KB;
#pragma unroll
            for (int p = 0; p < O::PARTS; ++p) {
              unsigned char* st = ring + stage * O::STAGE + p * O::PART;
              const CUtensorMap* ma = p ? &ta_lo : &ta;
              const CUtensorMap* mb = p ? &tb_lo : &tb;
              ssq::tma_load(st, ma, x, w0.rows, s0, bar);
              ssq::tma_load(st + O::A_BOX, ma, x, w1.rows, s1, bar);
              ssq::tma_load(st + 2 * O::A_BOX, mb, x, U.col0, bar);
            }
            if (++stage == O::STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    // a consumer warpgroup
    const int wg = warp / 4, wq = warp % 4, g = lane / 4, q = lane % 4;
    const bool signals = threadIdx.x % 128 == 0;
    float acc[NR], run[NR], sml[P == k3xTF32 ? NR : 1];
    int stage = 0;
    uint32_t phase = 0;
    auto release = [&](int s) {   // the warpgroup is done with stage s
      if (signals) ssq::mbar_arrive(&empty[s]);
    };
    for (int u = cluster; u < units; u += clusters) {
      const Unit U = unit_at(u, per, tiles, tiles_n, bm, O::N);
      const Part W = part_of(U, wg, C);
#pragma unroll
      for (int e = 0; e < NR; ++e) run[e] = 0.f;
      for (int i = 0; i < R; ++i) {
        int held = 0;
        for (int kb = 0; kb < kboxes; ++kb) {
          ssq::mbar_wait(&full[stage], phase);
          const unsigned char* st = ring + stage * O::STAGE;
          const uint64_t da = ssq::desc_sw128(st + wg * O::A_BOX);
          const uint64_t db = ssq::desc_sw128(st + 2 * O::A_BOX);
#pragma unroll
          for (int e = 0; e < NR; ++e) {
            ssq::fence_operand(acc[e]);
            if constexpr (P == k3xTF32) ssq::fence_operand(sml[e]);
          }
          ssq::wgmma_fence();
#pragma unroll
          for (int s = 0; s < O::KB / O::KSTEP; ++s) {
            const int sd = (kb | s) != 0;   // 0: the product's first step
            if constexpr (P == k3xTF32) {
              const uint64_t dal = ssq::desc_sw128(st + O::PART + wg * O::A_BOX);
              const uint64_t dbl = ssq::desc_sw128(st + O::PART + 2 * O::A_BOX);
              mma<P>(sml, da + 2 * s, dbl + 2 * s, sd);
              mma<P>(sml, dal + 2 * s, db + 2 * s, 1);
            }
            mma<P>(acc, da + 2 * s, db + 2 * s, sd);
          }
          ssq::wgmma_commit();
#pragma unroll
          for (int e = 0; e < NR; ++e) {
            ssq::fence_operand(acc[e]);
            if constexpr (P == k3xTF32) ssq::fence_operand(sml[e]);
          }
          if (kb > 0) {
            ssq::wgmma_wait<1>();   // the previous stage's products are done
            release(held);
          }
          held = stage;
          if (++stage == O::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        ssq::wgmma_wait<0>();
        release(held);
#pragma unroll
        for (int e = 0; e < NR; ++e) {
          ssq::fence_operand(acc[e]);
          float d = acc[e];
          if constexpr (P == k3xTF32) {
            ssq::fence_operand(sml[e]);
            d = __fadd_rn(d, sml[e]);
          }
          run[e] = __fadd_rn(run[e], d);
        }
      }
      // the tile leaves from the registers: d[4t + e] is row 16 wq + g +
      // 8 (e >> 1), column 8t + 2q + (e & 1) of the warpgroup's tile
      float* o = out + (long long)W.chain * m * n;
      const bool pairs = (n & 1) == 0;
#pragma unroll
      for (int t = 0; t < O::N / 8; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = W.rows + 16 * wq + g + 8 * h;
          const int c = U.col0 + 8 * t + 2 * q;
          if (r >= m || c >= n) continue;
          float* p = o + (long long)r * n + c;
          const float v0 = run[4 * t + 2 * h], v1 = run[4 * t + 2 * h + 1];
          if (pairs) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            p[0] = v0;
            if (c + 1 < n) p[1] = v1;
          }
        }
    }
  }
}

// The operand pre-pass: blocks [0, a_blocks) write A' (rowsA, kp) from A
// (rowsA, k), the rest B' = B^T (n, kp) from B (k, n), each block a 32 x
// 32 tile (B's through shared memory, so both sides are coalesced), k
// padded with zeros; hi, and for 3xtf32 lo, rounded as the precision
// wants.
template <int P>
__device__ __forceinline__ void put(typename Op<P>::T* hi,
                                    typename Op<P>::T* lo, long long i,
                                    float v) {
  if constexpr (P == kBF16) {
    hi[i] = __float2bfloat16_rn(v);
  } else {
    const float h = __uint_as_float(ssq::tf32(v));
    hi[i] = h;
    if constexpr (P == k3xTF32) lo[i] = __uint_as_float(ssq::tf32(v - h));
  }
}

template <int P>
__global__ void __launch_bounds__(kPrepThreads)
rate_prep_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 typename Op<P>::T* __restrict__ ah,
                 typename Op<P>::T* __restrict__ bh,
                 typename Op<P>::T* __restrict__ al,
                 typename Op<P>::T* __restrict__ bl, int rows, int k, int n,
                 int kp, int a_blocks) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int kt = kp / 32;
  int b = blockIdx.x;
  if (b < a_blocks) {
    const int r0 = b / kt * 32, gk = b % kt * 32 + tx;
    for (int r = ty; r < 32; r += kPrepThreads / 32) {
      const int gr = r0 + r;
      if (gr < rows)
        put<P>(ah, al, (long long)gr * kp + gk,
               gk < k ? A[(long long)gr * k + gk] : 0.f);
    }
    return;
  }
  b -= a_blocks;
  const int c0 = b / kt * 32, k0 = b % kt * 32;
  for (int r = ty; r < 32; r += kPrepThreads / 32) {
    const int gk = k0 + r, gc = c0 + tx;
    tile[r][tx] = gk < k && gc < n ? B[(long long)gk * n + gc] : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += kPrepThreads / 32) {
    const int gc = c0 + r;
    if (gc < n) put<P>(bh, bl, (long long)gc * kp + k0 + tx, tile[tx][r]);
  }
}

// Block b's k-th tile starts at element (b + k * blocks) * kCopyTile of
// each slice; thread t takes the float4s t and t + 256 of it. zero: 0.
__global__ void __launch_bounds__(kCopyThreads)
rate_copy_kernel(const float* __restrict__ A, float* __restrict__ out,
                 long long mn, int R, int grid, int tiles, int zero) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // [stage][slice][tile]
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kCopyStages * 2 * kCopyTile);
  constexpr int V = kCopyPer / 4;  // float4s a thread a slice
  const int tid = threadIdx.x;
  const int mine = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x;  // this block's tiles
  auto base = [&](int k) {
    return ((long long)blockIdx.x + (long long)k * gridDim.x) * kCopyTile;
  };
  auto issue = [&](int k) {  // tile k's two slices into stage k % stages
    const long long b = base(k);
    const uint32_t bytes =
        (uint32_t)(4 * min((long long)kCopyTile, mn - b));
    float* st = ring + (k % kCopyStages) * 2 * kCopyTile;
    uint64_t* bar = &full[k % kCopyStages];
    ssq::tma_expect(bar, 2 * bytes);
    ssq::bulk_load(st, A + b, bytes, bar);
    ssq::bulk_load(st + kCopyTile, A + mn + b, bytes, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < kCopyStages; ++s) ssq::mbar_init(&full[s], 1);
    ssq::mbar_init_fence();
    for (int k = 0; k < kCopyStages - 1 && k < mine; ++k) issue(k);
  }
  __syncthreads();
  for (int k = 0; k < mine; ++k) {
    // stage (k + stages - 1) % stages was last read at tile k - 1, before
    // that tile's barrier
    if (tid == 0 && k + kCopyStages - 1 < mine) issue(k + kCopyStages - 1);
    ssq::mbar_wait(&full[k % kCopyStages], (uint32_t)((k / kCopyStages) & 1));
    const long long b = base(k);
    const int n4 = (int)(min((long long)kCopyTile, mn - b) / 4);
    const float4* st = reinterpret_cast<const float4*>(
        ring + (k % kCopyStages) * 2 * kCopyTile);
    // the thread's floats of the two slices (zeros past the tile's end)
    alignas(16) float a0[kCopyPer] = {}, a1[kCopyPer] = {};
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int e = tid + v * kCopyThreads;
      if (e < n4) {
        *reinterpret_cast<float4*>(&a0[4 * v]) = st[e];
        *reinterpret_cast<float4*>(&a1[4 * v]) = st[kCopyTile / 4 + e];
      }
    }
    __syncthreads();  // the stage is in registers: it may be loaded again
    alignas(16) float acc[kCopyPer] = {};
    for (int c = 0; c < grid; ++c) {
      // the copy starts from the bits of the last copy's sums and `zero`:
      // +0.0f, but no compiler can know it, so every copy is its own work
#pragma unroll
      for (int e = 0; e < kCopyPer; ++e)
        acc[e] = __int_as_float(__float_as_int(acc[e]) & zero);
      int i = 0;
      for (; i + 1 < R; i += 2) {
#pragma unroll
        for (int e = 0; e < kCopyPer; ++e) {
          acc[e] = __fadd_rn(acc[e], a0[e]);
          acc[e] = __fadd_rn(acc[e], a1[e]);
        }
      }
      if (i < R) {
#pragma unroll
        for (int e = 0; e < kCopyPer; ++e) acc[e] = __fadd_rn(acc[e], a0[e]);
      }
    }
    float4* o = reinterpret_cast<float4*>(out + b);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int e = tid + v * kCopyThreads;
      if (e < n4)
        o[e] = *reinterpret_cast<const float4*>(&acc[4 * v]);
    }
  }
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The scratch of a call (mxu_rate_probe._prep_layout): A' hi (rows, kp),
// B' hi (n, kp), then for 3xtf32 A' lo and B' lo, each of Op<P>::T; kp is
// k rounded up to the box's KB.
template <int P>
struct Scratch {
  using T = typename Op<P>::T;
  int kp;
  T *ah, *bh, *al, *bl;
  Scratch(void* base, long long rows, int k, int n)
      : kp((k + Op<P>::KB - 1) / Op<P>::KB * Op<P>::KB) {
    ah = static_cast<T*>(base);
    bh = ah + rows * kp;
    al = bh + (long long)n * kp;
    bl = al + rows * kp;
  }
};

template <int P>
int launch_prep(const float* A, const float* B, const Scratch<P>& S,
                long long rows, int k, int n, cudaStream_t s) {
  const int kt = S.kp / 32;
  const long long a_blocks = (rows + 31) / 32 * kt;
  const long long blocks = a_blocks + (long long)(n + 31) / 32 * kt;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  rate_prep_kernel<P><<<(unsigned)blocks, kPrepThreads, 0, s>>>(
      A, B, S.ah, S.bh, S.al, S.bl, (int)rows, k, n, S.kp, (int)a_blocks);
  return (int)cudaGetLastError();
}

// The map of a K-major operand p (items x rows x kp, T), boxes of
// box_rows rows x KB in the 128-byte swizzle, zeros past the edges.
template <int P>
bool operand_map(CUtensorMap* tm, const void* p, int kp, int rows, int items,
                 int box_rows) {
  const ssq::EncodeTiled encode = ssq::tensor_map_encoder();
  if (!encode) return false;
  constexpr int es = (int)sizeof(typename Op<P>::T);
  const cuuint64_t dims[3] = {(cuuint64_t)kp, (cuuint64_t)rows,
                              (cuuint64_t)items};
  const cuuint64_t strides[2] = {(cuuint64_t)kp * es,
                                 (cuuint64_t)kp * es * rows};
  const cuuint32_t box[3] = {(cuuint32_t)Op<P>::KB, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(tm,
                P == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                items > 1 ? 3 : 2, const_cast<void*>(p), dims, strides, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The products alone, on operands the pre-pass wrote into S: persistent
// clusters (two blocks where grid is even, else one), as many as fit.
template <int P>
int launch_products(const Scratch<P>& S, float* out, int m, int n, int R,
                    int grid, int C, cudaStream_t s) {
  using O = Op<P>;
  auto kernel = rate_dot_kernel<P>;
  const int slices = C == 1 ? 2 : C + 1;
  CUtensorMap tm[4];
  if (!operand_map<P>(&tm[0], S.ah, S.kp, m, slices, kWgRows) ||
      !operand_map<P>(&tm[1], S.bh, S.kp, n, 1, O::N))
    return (int)cudaErrorNotSupported;
  tm[2] = tm[0];
  tm[3] = tm[1];
  if (P == k3xTF32 &&
      (!operand_map<P>(&tm[2], S.al, S.kp, m, slices, kWgRows) ||
       !operand_map<P>(&tm[3], S.bl, S.kp, n, 1, O::N)))
    return (int)cudaErrorNotSupported;
  const int cl = grid % 2 == 0 ? 2 : 1;
  const int bm = C == 1 ? kConsumers * kWgRows : kWgRows;
  const long long tiles =
      (long long)((m + bm - 1) / bm) * ((n + O::N - 1) / O::N);
  const long long units = (C == 1 ? 1 : C / 2) * tiles * (grid / cl);
  if (units > INT_MAX) return (int)cudaErrorInvalidValue;
  if (int err = allow_smem(kernel, O::SMEM)) return err;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, 1, 1);
  cfg.blockDim = dim3(kDotThreads, 1, 1);
  cfg.dynamicSmemBytes = O::SMEM;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  const int clusters = units < fit ? (int)units : fit;
  cfg.gridDim = dim3((unsigned)(clusters * cl), 1, 1);
  err = cudaLaunchKernelEx(&cfg, kernel, tm[0], tm[1], tm[2], tm[3], out, m,
                           n, S.kp / O::KB, R, C, (int)units, cl);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool bad_dot(int m, int k, int n, int R, int grid, int precision,
             int chains) {
  if (m < 1 || k < 1 || n < 1 || R < 0 || grid < 1 || grid > 65535)
    return true;
  if (chains == 1) return precision < kBF16 || precision > k3xTF32;
  return precision != kBF16 ||
         !(chains == 2 || chains == 4 || chains == 8 || chains == 16 ||
           chains == 24);
}

template <int P>
int run_dot(const float* A, const float* B, void* scratch, float* out, int m,
            int k, int n, int R, int grid, int chains, bool products,
            cudaStream_t s) {
  const long long rows = (long long)(chains == 1 ? 2 : chains + 1) * m;
  const Scratch<P> S(scratch, rows, k, n);
  if (int err = launch_prep<P>(A, B, S, rows, k, n, s)) return err;
  return products ? launch_products<P>(S, out, m, n, R, grid, chains, s) : 0;
}

int dispatch(const float* A, const float* B, void* scratch, float* out, int m,
             int k, int n, int R, int grid, int precision, int chains,
             bool products, void* stream) {
  if (bad_dot(m, k, n, R, grid, precision, chains))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (precision) {
    case kBF16:
      return run_dot<kBF16>(A, B, scratch, out, m, k, n, R, grid, chains,
                            products, s);
    case kTF32:
      return run_dot<kTF32>(A, B, scratch, out, m, k, n, R, grid, chains,
                            products, s);
    default:
      return run_dot<k3xTF32>(A, B, scratch, out, m, k, n, R, grid, chains,
                              products, s);
  }
}

// The copy's walk (mxu_rate_probe.copy_walk mirrors it): tiles of
// kCopyTile floats, kCopyBlocksPerSM persistent blocks an SM over them.
int copy_blocks(long long mn, int* tiles, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long t = (mn + kCopyTile - 1) / kCopyTile;
  if (t > INT_MAX) return (int)cudaErrorInvalidValue;
  *tiles = (int)t;
  const long long most = (long long)kCopyBlocksPerSM * sms;
  *blocks = (int)(t < most ? t : most);
  return 0;
}

}  // namespace

// A (2m, k) for chains == 1, else ((chains + 1) m, k); B (k, n); out
// (chains, m, n); float32, row-major. scratch: the operands the pre-pass
// writes, as many bytes as mxu_rate_probe._prep_layout gives, 16-byte
// aligned. precision 0 bf16, 1 tf32, 2 3xtf32 (chains > 1: bf16 only);
// chains 1, 2, 4, 8, 16 or 24; grid: the copies of every output tile
// (1..65535). Launches the pre-pass, then the products. Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int ssq_rate_dot(const float* A, const float* B, void* scratch,
                            float* out, int m, int k, int n, int R, int grid,
                            int precision, int chains, void* stream) {
  return dispatch(A, B, scratch, out, m, k, n, R, grid, precision, chains,
                  true, stream);
}

// ssq_rate_dot's pre-pass alone, into scratch (its time, and its operands
// against their plain model).
extern "C" int ssq_rate_prep(const float* A, const float* B, void* scratch,
                             int m, int k, int n, int precision, int chains,
                             void* stream) {
  return dispatch(A, B, scratch, nullptr, m, k, n, 0, 1, precision, chains,
                  false, stream);
}

// A (2m, n), out (m, n), float32, row-major, 16-byte aligned, m * n a
// multiple of 4. Returns cudaGetLastError() after the launch.
extern "C" int ssq_rate_copy(const float* A, float* out, int m, int n, int R,
                             int grid, void* stream) {
  const long long mn = (long long)m * n;
  if (m < 1 || n < 1 || (mn & 3) || R < 0 || grid < 1 || grid > 65535 ||
      (reinterpret_cast<uintptr_t>(A) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  const int smem = kCopyStages * (2 * kCopyTile * (int)sizeof(float) + 8);
  if (int err = allow_smem(rate_copy_kernel, smem)) return err;
  int tiles = 0, blocks = 0;
  if (int err = copy_blocks(mn, &tiles, &blocks)) return err;
  rate_copy_kernel<<<blocks, kCopyThreads, smem, (cudaStream_t)stream>>>(
      A, out, mn, R, grid, tiles, 0);
  return (int)cudaGetLastError();
}
