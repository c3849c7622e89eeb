// Probe J8: the cost per block, per step and per launch of a trivial
// kernel, for sm_90a.
//
// Replaces the TPU probe tools/grid_slope_probe.py::build (its pallas_call
// at :50): out = x + 1 on one (rows, L) float32 tile per grid step, the
// output block either the same for every step or step i's own rows. On
// the TPU the grid's steps ran in order on one core, the constant output
// block stayed resident in VMEM and was written back once, and the probe
// read the cost of a step from the slope of time against the grid size.
// Two designs here, one function:
//
// mode 1, persistent (the default). The tile is cut into chunks of at
//   most kChunk floats (32 KB; the last one shorter); a work item is a
//   (step, chunk) pair. A static plan (`plan`, mirrored by
//   grid_slope_probe.plan) launches per_chunk blocks a chunk, at most
//   per_sm blocks an SM times the SMs, per_sm = kPerSM (2) or fewer where
//   the occupancy at the design's shared memory is lower: block b owns
//   chunk b / per_chunk and a contiguous range of that chunk's steps. (Two
//   blocks an SM beat the occupancy's 6 to 8 on the card in all but one
//   case: PERF.md, PR 24.) Each block loads its chunk of x once, by one
//   TMA bulk copy into shared memory, and never reads x again. Each step
//   does its own adds (no add is folded across steps: the step's chunk is
//   read at an index offset by `s & zero`, a kernel argument that is 0,
//   so no compiler can hoist the load or its adds out of the step loop):
//     vary = 1, store 0 (regs)  the +1 in registers, 16-byte streaming
//                               stores (st.global.cs: evict first, which
//                               wrote one plane 13 % faster than plain
//                               stores) of the step's rows from registers
//     vary = 1, store 1 (bulk)  the +1 into one of kSlots staging slots in
//                               shared memory, then one bulk store (TMA)
//                               of the slot to the step's rows
//     vary = 0                  every step's +1 into the block's resident
//                               output chunk in shared memory; only the
//                               block that owns a chunk's last step stores
//                               it (16-byte streaming stores or one bulk
//                               store), so the output is written once
// mode 0, blocks (the PR 7 design, kept for the GPU's own question: the
//   cost of one CUDA block a step). Each step is one thread block (grid
//   blocks, in no order, on 132 SMs), reading the whole tile through L2:
//     vary = 0  every block writes the same (rows, L) output, with
//               identical values (a benign race: the result is
//               deterministic)
//     vary = 1  block i writes rows [i * rows, (i + 1) * rows) of a
//               (grid * rows, L) output
//
// What bounds it: bytes (the tile read once, the output written once);
// what the probe measures is everything else: the launch, the blocks'
// scheduling and the card's write rate for one float32 plane (row-out at
// 293 steps writes 192 MB, one plane of the headline ssq_cwt).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
grid_slope_kernel(const float* __restrict__ x, float* __restrict__ out,
                  long long tile, int vary) {
  float* o = out + (vary ? (long long)blockIdx.x * tile : 0);
  if ((tile & 3) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* o4 = reinterpret_cast<float4*>(o);
    for (long long e = threadIdx.x; e < tile / 4; e += kThreads) {
      float4 v = x4[e];
      v.x = __fadd_rn(v.x, 1.f);
      v.y = __fadd_rn(v.y, 1.f);
      v.z = __fadd_rn(v.z, 1.f);
      v.w = __fadd_rn(v.w, 1.f);
      o4[e] = v;
    }
  } else {
    for (long long e = threadIdx.x; e < tile; e += kThreads)
      o[e] = __fadd_rn(x[e], 1.f);
  }
}

// -- persistent ------------------------------------------------------------
constexpr int kChunk = 8192;                   // floats a chunk: 32 KB
constexpr int kPer = kChunk / 4 / kThreads;    // float4s a thread a chunk
constexpr int kSlots = 2;                      // the bulk route's slots
constexpr int kPerSM = 2;                      // blocks an SM at most
enum { kBlocks = 0, kPersistent = 1 };
enum { kRegs = 0, kBulk = 1 };

// shared memory a block: the chunk of x, then the staging slots (vary,
// bulk) or the resident output chunk (vary = 0), then the mbarrier
__host__ __device__ constexpr int buffers(int vary, int store) {
  return 1 + (vary ? (store == kBulk ? kSlots : 0) : 1);
}

__device__ __forceinline__ float4 plus1(float4 v) {
  v.x = __fadd_rn(v.x, 1.f);
  v.y = __fadd_rn(v.y, 1.f);
  v.z = __fadd_rn(v.z, 1.f);
  v.w = __fadd_rn(v.w, 1.f);
  return v;
}

// cf: the plan's chunk (floats); per_chunk: blocks a chunk; zero: 0.
template <int kStore, int kVary>
__global__ void __launch_bounds__(kThreads, kPerSM)
grid_slope_persistent(const float* __restrict__ x, float* __restrict__ out,
                      long long tile, int grid, int cf, int per_chunk,
                      int zero) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float4* in = reinterpret_cast<float4*>(smem_raw);
  float4* buf = in + cf / 4;    // the slots, or the resident output chunk
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      in + (size_t)buffers(kVary, kStore) * (cf / 4));
  const int tid = threadIdx.x;
  const int c = blockIdx.x / per_chunk, j = blockIdx.x % per_chunk;
  const long long c0 = (long long)c * cf;
  const int n4 = (int)(min((long long)cf, tile - c0) / 4);
  const int lo = (int)((long long)j * grid / per_chunk);
  const int hi = (int)((long long)(j + 1) * grid / per_chunk);
  if (tid == 0) {
    ssq::mbar_init(bar, 1);
    ssq::mbar_init_fence();
    ssq::tma_expect(bar, (uint32_t)n4 * 16);
    ssq::bulk_load(in, x + c0, (uint32_t)n4 * 16, bar);
  }
  __syncthreads();
  ssq::mbar_wait(bar, 0);

  if constexpr (!kVary) {
    for (int s = lo; s < hi; ++s) {
      const int z = s & zero;
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int e = tid + v * kThreads;
        if (e < n4) buf[e + z] = plus1(in[e + z]);
      }
    }
    if (hi != grid) return;   // the chunk's last step is another block's
    float4* o = reinterpret_cast<float4*>(out + c0);
    if constexpr (kStore == kBulk) {
      ssq::fence_proxy_async();   // the adds before the bulk store reads
      __syncthreads();
      if (tid == 0) {
        ssq::bulk_store(o, buf, (uint32_t)n4 * 16);
        ssq::bulk_commit();
        ssq::bulk_wait<0>();
      }
    } else {
#pragma unroll
      for (int v = 0; v < kPer; ++v) {   // the thread's own entries
        const int e = tid + v * kThreads;
        if (e < n4) __stcs(o + e, buf[e]);
      }
    }
  } else if constexpr (kStore == kRegs) {
    for (int s = lo; s < hi; ++s) {
      const int z = s & zero;
      float4* o = reinterpret_cast<float4*>(out + (long long)s * tile + c0);
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int e = tid + v * kThreads;
        if (e < n4) __stcs(o + e, plus1(in[e + z]));
      }
    }
  } else {
    for (int s = lo; s < hi; ++s) {
      const int z = s & zero;
      float4* slot = buf + (size_t)((s - lo) % kSlots) * (cf / 4);
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int e = tid + v * kThreads;
        if (e < n4) slot[e] = plus1(in[e + z]);
      }
      ssq::fence_proxy_async();   // this thread's slot before the store
      // the next step's slot was last read by the store kSlots - 1 steps
      // back: at most kSlots - 2 newer stores may still read theirs
      if (tid == 0) ssq::bulk_wait_read<kSlots - 2>();
      __syncthreads();
      if (tid == 0) {
        ssq::bulk_store(out + (long long)s * tile + c0, slot,
                        (uint32_t)n4 * 16);
        ssq::bulk_commit();
      }
    }
    if (tid == 0) ssq::bulk_wait<0>();
  }
}

struct Plan {
  int chunk, chunks, per_chunk, blocks, smem, per_sm, sms;
};

template <int kStore, int kVary>
cudaError_t fit(int smem, int* per_sm) {
  auto* k = grid_slope_persistent<kStore, kVary>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, k, kThreads,
                                                        (size_t)smem);
  return err;
}

// The launch for a tile of `tile` floats (a multiple of 4) at `grid`
// steps: chunks of kChunk floats, per_sm = min(kPerSM, the occupancy),
// per_chunk = min(grid, per_sm * sms /
// chunks) blocks a chunk, each owning steps [j grid / per_chunk, (j + 1)
// grid / per_chunk) of it; a tile of more chunks than per_sm * sms is
// refused.
cudaError_t plan(long long tile, int grid, int vary, int store, Plan* p) {
  if (tile < 4 || (tile & 3) || grid < 1 || (store != kRegs &&
                                             store != kBulk))
    return cudaErrorInvalidValue;
  const long long cf = tile < kChunk ? tile : kChunk;
  const long long chunks = (tile + cf - 1) / cf;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&p->sms, cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err != cudaSuccess) return err;
  p->chunk = (int)cf;
  p->smem = buffers(vary, store) * (int)cf * 4 + 16;
  if (vary)
    err = store == kBulk ? fit<kBulk, 1>(p->smem, &p->per_sm)
                         : fit<kRegs, 1>(p->smem, &p->per_sm);
  else
    err = store == kBulk ? fit<kBulk, 0>(p->smem, &p->per_sm)
                         : fit<kRegs, 0>(p->smem, &p->per_sm);
  if (err != cudaSuccess) return err;
  if (p->per_sm > kPerSM) p->per_sm = kPerSM;
  const long long most = (long long)p->per_sm * p->sms;
  if (chunks > most) return cudaErrorInvalidValue;
  p->chunks = (int)chunks;
  p->per_chunk = (int)(most / chunks < grid ? most / chunks : grid);
  p->blocks = p->chunks * p->per_chunk;
  return cudaSuccess;
}

template <int kStore, int kVary>
void launch(const float* x, float* out, long long tile, int grid,
            const Plan& p, cudaStream_t st) {
  grid_slope_persistent<kStore, kVary><<<p.blocks, kThreads, p.smem, st>>>(
      x, out, tile, grid, p.chunk, p.per_chunk, 0);
}

}  // namespace

// x: the (rows, L) tile, tile = rows * L floats; out: (rows, L) (vary 0)
// or (grid * rows, L) (vary 1), float32, 16-byte aligned. mode 0 blocks,
// 1 persistent (tile a multiple of 4 floats); store 0 regs, 1 bulk
// (persistent only). Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int ssq_grid_slope(const float* x, float* out, long long tile,
                              int grid, int vary, int mode, int store,
                              void* stream) {
  if (grid < 1 || tile < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == kBlocks) {
    grid_slope_kernel<<<grid, kThreads, 0, st>>>(x, out, tile, vary);
    return (int)cudaGetLastError();
  }
  if (mode != kPersistent) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan(tile, grid, vary, store, &p);
  if (err != cudaSuccess) return (int)err;
  if (vary && store == kBulk)
    launch<kBulk, 1>(x, out, tile, grid, p, st);
  else if (vary)
    launch<kRegs, 1>(x, out, tile, grid, p, st);
  else if (store == kBulk)
    launch<kBulk, 0>(x, out, tile, grid, p, st);
  else
    launch<kRegs, 0>(x, out, tile, grid, p, st);
  return (int)cudaGetLastError();
}

// The persistent launch's plan on the current device (the mirror is
// grid_slope_probe.plan): v = chunk (floats), chunks, per_chunk, blocks,
// smem (bytes a block), per_sm (blocks an SM), sms.
extern "C" int ssq_grid_slope_plan(long long tile, int grid, int vary,
                                   int store, int* v) {
  Plan p;
  cudaError_t err = plan(tile, grid, vary, store, &p);
  if (err != cudaSuccess) return (int)err;
  const int got[7] = {p.chunk, p.chunks, p.per_chunk, p.blocks,
                      p.smem,  p.per_sm, p.sms};
  for (int i = 0; i < 7; ++i) v[i] = got[i];
  return 0;
}
