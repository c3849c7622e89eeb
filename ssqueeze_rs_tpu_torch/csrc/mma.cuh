// The tensor-core helpers the hand-written kernels share (sm_90a):
// mma.sync tiles in TF32 and bf16 with float32 accumulation, and the
// roundings that feed them.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32 and mma.m16n8k16 .bf16),
// with g = lane / 4 (group) and q = lane % 4 (thread in group):
//   A (16 x K, row): tf32  a0 (g, q)      a1 (g+8, q)      a2 (g, q+4)
//                                          a3 (g+8, q+4)
//                    bf16  a0 (g, 2q:2q+2) a1 (g+8, 2q:2q+2)
//                          a2 (g, 2q+8:2q+10) a3 (g+8, 2q+8:2q+10)
//   B (K x 8, col):  tf32  b0 (q, g)      b1 (q+4, g)
//                    bf16  b0 (2q:2q+2, g) b1 (2q+8:2q+10, g)
//   C (16 x 8):      c0 (g, 2q)  c1 (g, 2q+1)  c2 (g+8, 2q)  c3 (g+8, 2q+1)
// A bf16 register holds the lower k index in its low 16 bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ssq {

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero; the low 13 bits of the result are zero.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a (16x8, row) * b (8x8, col), TF32 in, float32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (to nearest even) in one register, `lo` in
// the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace ssq
