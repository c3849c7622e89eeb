// Probe J7: does an asynchronous copy from device memory overlap a serial
// tensor-core chain on the same SMs? For sm_90a.
//
// Replaces the TPU probe tools/dma_overlap_probe.py::_make_kernel (its
// pallas_call at :88). Function, with x (M, M) float32:
//
//   x = f32(bf16(a))
//   R times:  [dots]   D times  x = (bf16(x) @ bf16(b)) * 1e-3   (f32 sum)
//             [copies] the chunk src[r*CH : (r+1)*CH] (CH x M float32) is
//                      copied on chip, issued before the dots and waited
//                      on after them; then x = x + src[r*CH, 0] * 1e-30
//   out = x[:8]
//
// variant: 1 copies, 2 dots, 3 both. On the TPU the chunk (8 MB at the
// probe's shape) went into VMEM while the matrix unit ran the chain. Here:
//
//  - Rows of x go in groups of 64 (a row of x @ b needs only that row of
//    x), one group a thread-block cluster of C blocks (8, or 16 where M is
//    a multiple of 128: a non-portable cluster size); block c of a cluster
//    owns columns [c N, (c + 1) N) of x, N = M / C. It holds its slice of
//    x in float32 in the accumulator registers of its one warpgroup, and
//    its columns of bf16(b), loaded once by TMA (boxes of 64 k x N in the
//    128-byte swizzle), resident in shared memory.
//  - A product is 32 k-steps (M / 16) of m64nNk16 wgmma, A (the group's
//    bf16(x), 64 x M) and B both from shared memory, into fresh
//    accumulators; the epilogue forms x = acc * 1e-3 (__fmul_rn), writes
//    bf16(x) into its own columns of the next A buffer (each 8 k of the 64
//    rows one 1024-byte run, so the columns are one span of N * 128
//    bytes) and sends that span by one TMA bulk copy (from its shared
//    memory into a peer's shared memory) to each other block of
//    the cluster, completing on the peer's mbarrier of that buffer. Two A
//    buffers alternate; a block starts product p once its buffer's
//    barrier says all C spans are in, which also orders every reuse of a
//    buffer after the products that read it (the sender of a span into
//    buffer p % 2 has itself waited on the spans of product p - 1, which
//    came after every block's product p - 2).
//  - The copies come from every block of the launch: block b's share of
//    each chunk is the 16-byte units [b U / G, (b + 1) U / G) of its U,
//    G the blocks, so the shares cover the chunk once. A copy warp's one
//    thread issues each share in pieces of 8 KB into a ring of slots by
//    TMA bulk copies, each completing on its slot's mbarrier; it waits on a
//    slot only to reuse it and on the last pieces at the iteration's end,
//    then arrives on the `landed` barrier. The warpgroup, at the last
//    product's epilogue of an iteration (or at the iteration's end when
//    there is no product), waits on `landed` and adds the copy term to its
//    float32 slice before it rounds and sends it (its own rounding, as in
//    the plain loop). The iteration's copies start only when the
//    warpgroup starts the iteration (a named barrier), as the TPU issued
//    them before the dots. `copies` runs the same grid without products.
//  - out = x[:8] comes from the first cluster's first warp. Products and
//    sums keep their float32 roundings (__fmul_rn / __fadd_rn), with no
//    atomics: the result is bitwise the same run to run.
//
// What bounds it: the copies' bytes (R * CH * M * 4: 512 MB at the probe's
// shape, 0.153 ms at 3.35 TB/s) against the dots' operations at the bf16
// rate (R * D * 2 M^3, 0.052 ms); the question is whether `both` takes
// the larger or the sum of `copies` and `dots`.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kRows = 64;            // rows of x a cluster: one m64 tile
constexpr int kThreads = 128 + 32;   // a warpgroup and the copy warp
constexpr int kPiece = 8 * 1024;     // bytes a ring slot
constexpr int kMaxSlots = 8;
constexpr int kMaxM = 512;
constexpr int kCluster = 8;          // the default cluster size
constexpr int kSmemMax = 232448;     // a block's shared memory
constexpr int kBars = 4 + kMaxSlots;
enum { kCopies = 1, kDots = 2 };
enum { kWarpgroupBar = 1, kIterationBar = 2 };  // named barriers

// A launch's shape (dma_overlap_probe.plan mirrors it): C blocks a
// cluster, N columns a block, G blocks, the ring's slots and the dynamic
// shared memory: 1024 bytes of slack to align, B's columns (M x N bf16),
// two A buffers (64 x M bf16), the ring, the barriers.
struct Plan {
  int C, N, G, slots, smem;
};

Plan plan(int M, int cluster) {
  Plan p;
  p.C = cluster;
  while (M % (8 * p.C)) p.C /= 2;
  p.N = M / p.C;
  p.G = M / kRows * p.C;
  const int fixed = 1024 + M * p.N * 2 + 2 * kRows * M * 2 + kBars * 8;
  p.slots = (kSmemMax - fixed) / kPiece;
  if (p.slots > kMaxSlots) p.slots = kMaxSlots;
  p.smem = fixed + p.slots * kPiece;
  return p;
}

// A's layout: element (k, row) of a 64 x M buffer at byte (k / 8) * 1024 +
// (row / 8) * 128 + (row % 8) * 16 + (k % 8) * 2 (desc_kmajor(p, 1024,
// 128)); k-step s starts at s * 2048.
__device__ __forceinline__ int a_byte(int k, int row) {
  return (k >> 3) * 1024 + (row >> 3) * 128 + (row & 7) * 16 + (k & 7) * 2;
}

template <int V, int N>
__global__ void __launch_bounds__(kThreads, 1)
dma_overlap_kernel(const __grid_constant__ CUtensorMap tb,
                   const float* __restrict__ src, const float* __restrict__ a,
                   float* __restrict__ out, int M, int R, int D,
                   long long chunk_bytes, int slots) {
  constexpr int C_REGS = N / 2;  // accumulator registers a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* bs =
      smem_raw + ((1024 - (ssq::smem_u32(smem_raw) & 1023)) & 1023);
  const int b_bytes = M * N * 2, a_bytes = kRows * M * 2;
  unsigned char* abuf = bs + b_bytes;  // the two A buffers
  unsigned char* ring = abuf + 2 * a_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + slots * kPiece);
  uint64_t* bload = full + 2;
  uint64_t* landed = full + 3;
  uint64_t* piece = full + 4;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int C = M / N, rank = ssq::cluster_rank();
  const int row0 = (int)(blockIdx.x / C) * kRows, col0 = rank * N;
  const int products = R * D;
  const bool dots = (V & kDots) && products > 0;
  if (tid == 0) {
    ssq::mbar_init(&full[0], 1);
    ssq::mbar_init(&full[1], 1);
    ssq::mbar_init(bload, 1);
    ssq::mbar_init(landed, 1);
    for (int s = 0; s < slots; ++s) ssq::mbar_init(&piece[s], 1);
    ssq::mbar_init_fence();
    if (dots) {  // B's columns [col0, col0 + N): M / 64 boxes of 64 k
      ssq::tma_expect(bload, (uint32_t)b_bytes);
      for (int j = 0; j < M / 64; ++j)
        ssq::tma_load(bs + j * N * 128, &tb, 64 * j, col0, bload);
    }
  }
  // every block's barriers exist before a peer signals them
  ssq::cluster_sync();

  if (warp < 4) {
    // the warpgroup: d[4t + e] is row 16 warp + g + 8 (e >> 1), column
    // 8t + 2q + (e & 1) of the block's 64 x N slice
    const int g = lane / 4, q = lane % 4;
    float x[C_REGS], acc[C_REGS];
#pragma unroll
    for (int t = 0; t < N / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + 16 * warp + g + 8 * (e >> 1);
        const int c = col0 + 8 * t + 2 * q + (e & 1);
        x[4 * t + e] = __bfloat162float(
            __float2bfloat16_rn(a[(long long)r * M + c]));
      }
    // fill f of the A buffers (f % 2): bf16(x) into this block's span,
    // then the span to every other block of the cluster
    auto send = [&](int f) {
      unsigned char* A = abuf + (f & 1) * a_bytes;
#pragma unroll
      for (int t = 0; t < N / 8; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(
              A + a_byte(col0 + 8 * t + 2 * q, 16 * warp + g + 8 * h)) =
              ssq::pack_bf16(x[4 * t + 2 * h], x[4 * t + 2 * h + 1]);
      ssq::fence_proxy_async();  // before wgmma and the copies read them
      ssq::bar_sync(kWarpgroupBar, 128);
      if (tid == 0) {
        const uint32_t span = N * 128;
        unsigned char* mine = A + col0 * 128;
        ssq::tma_expect(&full[f & 1], (uint32_t)(C - 1) * span);
        for (int p = 1; p < C; ++p)
          ssq::bulk_copy_peer(mine, (rank + p) % C, span, &full[f & 1]);
      }
    };
    auto add_copy_term = [&](int r) {  // once the iteration's copies landed
      ssq::mbar_wait(landed, (uint32_t)(r & 1));
      const float s = __fmul_rn(src[(long long)r * (chunk_bytes / 4)], 1e-30f);
#pragma unroll
      for (int e = 0; e < C_REGS; ++e) x[e] = __fadd_rn(x[e], s);
    };
    if (dots) {
      send(0);
      ssq::mbar_wait(bload, 0);
    }
    int f = 0;  // the fill the next product reads
    for (int r = 0; r < R; ++r) {
      if constexpr ((V & kCopies) != 0) ssq::bar_sync(kIterationBar, kThreads);
      if constexpr ((V & kDots) != 0) {
        for (int d = 0; d < D; ++d, ++f) {
          const unsigned char* A = abuf + (f & 1) * a_bytes;
          ssq::mbar_wait(&full[f & 1], (uint32_t)((f >> 1) & 1));
          const uint64_t da = ssq::desc_kmajor(A, 1024, 128);
#pragma unroll
          for (int e = 0; e < C_REGS; ++e) ssq::fence_operand(acc[e]);
          ssq::wgmma_fence();
          for (int j = 0; j < M / 64; ++j) {
            const uint64_t db = ssq::desc_sw128(bs + j * N * 128);
#pragma unroll
            for (int s = 0; s < 4; ++s)
              ssq::WgmmaSS<N>::mma(acc, da + (4 * j + s) * 128, db + 2 * s,
                                   (j | s) != 0);
          }
          ssq::wgmma_commit();
          ssq::wgmma_wait<0>();
#pragma unroll
          for (int e = 0; e < C_REGS; ++e) {
            ssq::fence_operand(acc[e]);
            x[e] = __fmul_rn(acc[e], 1e-3f);
          }
          if ((V & kCopies) && d == D - 1) add_copy_term(r);
          if (f + 1 < products) send(f + 1);
        }
      }
      if constexpr ((V & kCopies) != 0)
        if (!(V & kDots) || D == 0) add_copy_term(r);
    }
    if (blockIdx.x < (unsigned)C && warp == 0) {  // rows 0-7: g, e < 2
#pragma unroll
      for (int t = 0; t < N / 8; ++t) {
        float* o = out + (long long)g * M + col0 + 8 * t + 2 * q;
        o[0] = x[4 * t];
        o[1] = x[4 * t + 1];
      }
    }
  } else if constexpr ((V & kCopies) != 0) {
    // the copy warp: block b's share of every chunk, in pieces
    const long long units = chunk_bytes / 16;
    const long long lo = (long long)blockIdx.x * units / gridDim.x * 16;
    const long long hi = ((long long)blockIdx.x + 1) * units / gridDim.x * 16;
    const unsigned char* srcb = reinterpret_cast<const unsigned char*>(src);
    long long issued = 0, waited = 0;  // pieces over all iterations
    for (int r = 0; r < R; ++r) {
      ssq::bar_sync(kIterationBar, kThreads);
      if (lane == 0) {
        const unsigned char* base = srcb + (long long)r * chunk_bytes;
        for (long long off = lo; off < hi; off += kPiece) {
          for (; waited + slots <= issued; ++waited)  // the slot is free
            ssq::mbar_wait(&piece[waited % slots],
                           (uint32_t)((waited / slots) & 1));
          const int slot = (int)(issued % slots);
          const uint32_t bytes = (uint32_t)min((long long)kPiece, hi - off);
          ssq::tma_expect(&piece[slot], bytes);
          ssq::bulk_load(ring + slot * kPiece, base + off, bytes,
                         &piece[slot]);
          ++issued;
        }
        for (; waited < issued; ++waited)  // the iteration's copies landed
          ssq::mbar_wait(&piece[waited % slots],
                         (uint32_t)((waited / slots) & 1));
        ssq::mbar_arrive(landed);
      }
      __syncwarp();
    }
  }
  __syncwarp();
  // no block leaves while a peer's copy may still read its shared memory
  ssq::cluster_sync();
}

// The 2-D map of bT (M rows n, M columns k, bf16), boxes of 64 k x N rows
// in the 128-byte swizzle.
bool b_map(CUtensorMap* tm, const void* bT, int M, int N) {
  const ssq::EncodeTiled encode = ssq::tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)M, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)M * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)N};
  const cuuint32_t step[2] = {1, 1};
  return encode(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(bT),
                dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int V, int N>
cudaError_t configure(const Plan& p, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  auto kernel = dma_overlap_kernel<V, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err == cudaSuccess && p.C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(p.G, 1, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = p.smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

template <int V, int N>
int launch(const CUtensorMap& tb, const float* src, const float* a,
           float* out, int M, int R, int D, long long chunk, const Plan& p,
           cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<V, N>(p, &cfg, attr);
  if (err != cudaSuccess) return (int)err;
  cfg.stream = s;
  err = cudaLaunchKernelEx(&cfg, dma_overlap_kernel<V, N>, tb, src, a, out, M,
                           R, D, chunk, p.slots);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int V>
int launch_v(const CUtensorMap& tb, const float* src, const float* a,
             float* out, int M, int R, int D, long long chunk, const Plan& p,
             cudaStream_t s) {
#define SSQ_J7_N(n) \
  case n: return launch<V, n>(tb, src, a, out, M, R, D, chunk, p, s);
  switch (p.N) {
    SSQ_J7_N(8) SSQ_J7_N(16) SSQ_J7_N(24) SSQ_J7_N(32)
    SSQ_J7_N(40) SSQ_J7_N(48) SSQ_J7_N(56) SSQ_J7_N(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SSQ_J7_N
}

bool bad(int M, int R, int D, long long CH, int cluster) {
  return M < 64 || M > kMaxM || M % 64 || R < 0 || D < 0 || CH < 1 ||
         (cluster != 8 && cluster != 16);
}

}  // namespace

// src (>= R * CH, M), a (M, M) float32, bT (M, M) bf16 with bT[n][k] =
// bf16(b[k][n]), row-major, 16-byte aligned; out (8, M). M a multiple of
// 64 up to 512; variant 1 copies, 2 dots, 3 both; cluster 8 or 16 (taken
// down to 8 where M is not a multiple of 8 * cluster). Launches the probe
// and returns cudaGetLastError() after the launch.
extern "C" int ssq_dma_overlap_cluster(const float* src, const float* a,
                                       const void* bT, float* out, int M,
                                       int R, int D, long long CH,
                                       int variant, int cluster,
                                       void* stream) {
  if (bad(M, R, D, CH, cluster) || variant < 1 || variant > 3 ||
      (reinterpret_cast<uintptr_t>(src) & 15) ||
      (reinterpret_cast<uintptr_t>(bT) & 15))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(M, cluster);
  CUtensorMap tb;
  if (!b_map(&tb, bT, M, p.N)) return (int)cudaErrorNotSupported;
  cudaStream_t s = (cudaStream_t)stream;
  const long long chunk = CH * M * (long long)sizeof(float);
  switch (variant) {
    case kCopies:
      return launch_v<kCopies>(tb, src, a, out, M, R, D, chunk, p, s);
    case kDots:
      return launch_v<kDots>(tb, src, a, out, M, R, D, chunk, p, s);
    default:
      return launch_v<kCopies | kDots>(tb, src, a, out, M, R, D, chunk, p, s);
  }
}

// As ssq_dma_overlap_cluster at the default cluster size.
extern "C" int ssq_dma_overlap(const float* src, const float* a,
                               const void* bT, float* out, int M, int R,
                               int D, long long CH, int variant,
                               void* stream) {
  return ssq_dma_overlap_cluster(src, a, bT, out, M, R, D, CH, variant,
                                 kCluster, stream);
}

// The launch's plan into v: cluster size, columns a block, blocks, ring
// slots, dynamic shared memory, and the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters of the `both` kernel).
extern "C" int ssq_dma_overlap_plan(int M, int cluster, int* v) {
  if (bad(M, 0, 0, 1, cluster)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(M, cluster);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err;
  int fit = 0;
#define SSQ_J7_N(n)                                                 \
  case n:                                                           \
    err = configure<kCopies | kDots, n>(p, &cfg, attr);             \
    if (err == cudaSuccess)                                         \
      err = cudaOccupancyMaxActiveClusters(                         \
          &fit, dma_overlap_kernel<kCopies | kDots, n>, &cfg);      \
    break;
  switch (p.N) {
    SSQ_J7_N(8) SSQ_J7_N(16) SSQ_J7_N(24) SSQ_J7_N(32)
    SSQ_J7_N(40) SSQ_J7_N(48) SSQ_J7_N(56) SSQ_J7_N(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SSQ_J7_N
  if (err != cudaSuccess) return (int)err;
  v[0] = p.C;
  v[1] = p.N;
  v[2] = p.G;
  v[3] = p.slots;
  v[4] = p.smem;
  v[5] = fit;
  return 0;
}
