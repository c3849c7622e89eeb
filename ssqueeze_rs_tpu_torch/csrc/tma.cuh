// The Tensor Memory Accelerator (TMA), shared by the double kernels B and
// B' (reassign64.cu), probe J5 (rate_probe.cu), probe J7 (dma_overlap.cu)
// and probes P2 and P3 (ablate_cwt.cu), for sm_90a.
//
// A TMA load copies one box of a tensor map from device memory into
// shared memory, issued by one thread, and completes on an mbarrier by
// the box's bytes (tma_expect arms the barrier with them; a box that runs
// past the tensor's edge is filled with zeros and still counts its whole
// size). A TMA store writes a box back from shared memory in the thread's
// bulk group.
//
// Host: tensor_map_encoder() looks cuTensorMapEncodeTiled up through the
// runtime's entry-point query, so the library does not link against
// libcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace ssq {

// Arms bar: one arrival, and `bytes` more to land before its phase ends.
__device__ __forceinline__ void tma_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// The box of the 2-D map tm at column x, row y into dst, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* tm,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// The box of the 3-D map tm at (x, y, z) into dst, completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* tm,
                                         int x, int y, int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(x), "r"(y), "r"(z),
      "r"(smem_u32(bar))
      : "memory");
}

// The box of the 3-D map tm at (x, y, z) from shared memory at src, in
// this thread's bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* tm,
                                          const void* src, int x, int y,
                                          int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3}], [%4];" ::"l"(reinterpret_cast<uint64_t>(tm)),
      "r"(x), "r"(y), "r"(z), "r"(smem_u32(src))
      : "memory");
}

// 1-D bulk copies (cp.async.bulk: no tensor map). `bytes` is a multiple of
// 16 and both addresses are 16-byte aligned.
//
// `bytes` from device memory at src into shared memory at dst, completing
// on bar (armed by tma_expect).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` of this block's shared memory at p into the same place in the
// shared memory of the cluster's block `rank`, completing there on that
// block's barrier at the place of bar (armed by its own tma_expect; the
// bytes may land before it is armed).
__device__ __forceinline__ void bulk_copy_peer(const void* p, int rank,
                                               uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(cluster_addr(p, rank)),
      "r"(smem_u32(p)), "r"(bytes), "r"(cluster_addr(bar, rank))
      : "memory");
}

// `bytes` from shared memory at src to device memory at dst, in this
// thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

// Closes this thread's bulk group of the stores issued since the last one.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's newest bulk groups still read
// their shared memory (their slots may then be written again).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// Waits until at most N of this thread's newest bulk groups are pending.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" ::"n"(N) : "memory");
}

// cuTensorMapEncodeTiled's signature, looked up through the runtime (no
// link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, or nullptr if it is missing.
inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess || !fn)
      return nullptr;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  return encode;
}

}  // namespace ssq
