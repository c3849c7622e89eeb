// Probe J8: the cost per block and per launch of a trivial kernel, for
// sm_90a.
//
// Replaces the TPU probe tools/grid_slope_probe.py::build (its pallas_call
// at :50): out = x + 1 on one (rows, L) float32 tile per grid step, the
// output block either the same for every step or step i's own rows. On
// the TPU the grid's steps ran in order on one core and the probe read the
// cost of a step from the slope of time against the grid size. Here each
// step is one thread block (grid blocks, in no order, on 132 SMs):
//
//   vary = 0  every block writes the same (rows, L) output, with identical
//             values (a benign race: the result is deterministic)
//   vary = 1  block i writes rows [i * rows, (i + 1) * rows) of a
//             (grid * rows, L) output
//
// What bounds it: bytes (the tile read once, the output written once);
// what the probe measures is everything else: the launch, the blocks'
// scheduling and, for the 655 KB tiles, one block's streaming rate.

#include <cuda_runtime.h>

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

}  // namespace

// x: the (rows, L) tile, tile = rows * L floats; out: (rows, L) (vary 0)
// or (grid * rows, L) (vary 1), float32, 16-byte aligned. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ssq_grid_slope(const float* x, float* out, long long tile,
                              int grid, int vary, void* stream) {
  if (grid < 1 || tile < 1) return (int)cudaErrorInvalidValue;
  grid_slope_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, out, tile,
                                                                 vary);
  return (int)cudaGetLastError();
}
