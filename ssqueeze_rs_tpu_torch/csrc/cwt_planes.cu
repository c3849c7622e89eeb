// Kernels D, E and A: the half-band inverse DFT of CWT spectra, emitting
// float32 real/imaginary planes (D, E) or Wx and the phase plane (A), for
// sm_90a.
//
// D replaces ssqueeze_rs_tpu/ops/fft_pallas.py::_make_cwt_kernel and its
// TPU variants _make_cwt_kernel_t, _make_cwt_kernel_rb and
// _make_cwt_kernel_tiled (the pallas_call in _cwt_fused_call without
// phase_gamma; they differ only in matrix-unit issue order and VMEM
// tiling). Per output row (b-major: row = ib*na + ia) it computes
//
//   Z[k]  = Pw[ia,k] * xhat[ib,k]              k < M/2 (half band)
//   dZ[k] = (-Im Z[k], Re Z[k]) * xig[k] / dt  (only with derivative)
//   Wx(n)  = (1/M) sum_k Z[k] e^{2 pi i k n / M} + nyq_w (-1)^n / M
//   dWx(n) likewise with dZ and nyq_d
//
// for n in the keep window [start, start+L), and emits (Wxr, Wxi) or
// (Wxr, Wxi, dWxr, dWxi).
//
// E replaces ssqueeze_rs_tpu/ops/fft_pallas.py::_make_kernel and
// _make_kernel_tiled (the pallas_call in _fused_call, public
// ifft_halfband_planar_fused): the same transform of Z planes (B, K1, M2)
// given in device memory, with Nyquist values (B,), emitting (xr, xi)
// (B, L). The port uses it for analytic wavelets whose psih is complex.
//
// A replaces ssqueeze_rs_tpu/ops/fft_pallas.py::_make_cwt_kernel_phase
// (the pallas_call in _cwt_fused_call with phase_gamma): D with the
// derivative, whose epilogue emits Wx = (C, D) and
//   w = |B*C - A*D| / (|Wx|^2 * 2 pi),  or +inf where |Wx|^2 <= gamma^2,
// with (A, B) = dWx, in place of the four planes.
//
// All three split M = M1*M2 (k = M2*k1 + k2, n = n1 + M1*n2) into two
// launches: launch 1 runs the length-M1 inverse FFTs over k1 and stores
// the twiddled intermediate Y[pipe][row][n1][k2]; launch 2 runs the
// length-M2 inverse FFTs over k2 and stores the kept outputs with the
// Nyquist term. Launch 1 takes a loader (DLoad, ALoad: Pw * xhat and dZ;
// ELoad: the given Z planes), launch 2 a store (PlanesStore: a pipeline a
// block, its planes; PhaseStore: both pipelines of a row in one thread's
// two slots, and A's epilogue).
//
// What bounds D on Hopper: device-memory traffic. Counted as the work
// requires, D at the cwt headline (293 rows, M = 2^18, 160 000 kept
// columns) reads Pw (0.15 GB) and writes two 0.19 GB planes, ~0.53 GB or
// ~0.16 ms at 3.35 TB/s; with the derivative four planes, ~0.91 GB or
// ~0.27 ms (A: three planes, ~0.72 GB or ~0.21 ms). Above that it pays Y
// (rows x M complex floats a pipeline, 0.61 GB at the headline, written
// once and read once) and the butterflies' shared-memory passes. What the
// design does about them:
//   * Y stays in L2. The caller gives row chunks whose Y (pipes x ychunk x
//     M x 8 bytes) fits well inside the 50 MB L2, and both launches of a
//     chunk are issued here back to back, so launch 2 reads what launch 1
//     has just written without a round trip through device memory.
//   * The column FFTs run on the register-radix core (fft_radix.cuh):
//     radix-8 or radix-16 passes with one shared-memory exchange each, 3
//     for 512 or 2048 points where radix 2 took 9 or 11. Launch 1 tells
//     the core that only the first M1/2 inputs are nonzero (the half
//     band), launch 2 that only the n2 rows covering the keep window are
//     wanted.
//   * Z is never materialised (built from Pw and xhat while loading); all
//     device-memory runs cover whole 32-byte sectors but launch 1's reads
//     of Pw and xhat with the derivative and A's stores (16 bytes a run,
//     the rest in the next block's run).
// E reads 8 bytes a point from device memory (two planes) where D reads Pw
// and shares xhat between rows; a block of launch 1 holds NCOL
// neighbouring k2 columns (8 at M1 = 512), so each plane's run is 32
// bytes, one whole sector. A's launch 2 holds both pipelines of NCU = 4 n1
// rows a block at M2 = 512, where D's holds 8 rows of one pipeline. The
// radix-2 four-step design these kernels ran before (cwt_planes.cuh on
// fft4.cuh, Y through device memory) is kept only for the probes of
// csrc/ablate_cwt.cu.

#include <cuda_runtime.h>
#include <math.h>

#include "fft_radix.cuh"
#include "planes.cuh"

namespace {

// Launch 1's spectrum loaders: row(r, half) gives row r's view, whose z(g)
// is Z at bin g = k1*M2 + k2 (and z2(g, z, dz) Z and dZ, for the
// derivative). Reads go through the read-only path (__ldg).
//
// Kernel D: Z = Pw[ia] * xhat[ib] (row = ib*na + ia), dZ = (-Im Z, Re Z) *
// xig / dt, built while loading.
struct DLoad {
  const float* Pw;
  const float* xr;
  const float* xi;
  const float* xig;
  float inv_dt;
  int na;
  struct Row {
    const float* pw;
    const float* sr;
    const float* si;
    const float* xig;
    float inv_dt;
    __device__ float2 z(long long g) const {
      const float p = __ldg(pw + g);
      return make_float2(p * __ldg(sr + g), p * __ldg(si + g));
    }
    __device__ void z2(long long g, float2& z, float2& dz) const {
      const float p = __ldg(pw + g);
      const float zr = p * __ldg(sr + g);
      const float zi = p * __ldg(si + g);
      const float s = __ldg(xig + g) * inv_dt;
      z = make_float2(zr, zi);
      dz = make_float2(-zi * s, zr * s);
    }
  };
  __device__ Row row(long long r, long long half) const {
    const long long ia = r % na, ib = r / na;
    return {Pw + ia * half, xr + ib * half, xi + ib * half, xig, inv_dt};
  }
};

// Kernel E: Z read from the row's planes (rows, K1, M2).
struct ELoad {
  const float* Zr;
  const float* Zi;
  struct Row {
    const float* zr;
    const float* zi;
    __device__ float2 z(long long g) const {
      return make_float2(__ldg(zr + g), __ldg(zi + g));
    }
  };
  __device__ Row row(long long r, long long half) const {
    return {Zr + r * half, Zi + r * half};
  }
};

// Kernel A: D's loader under a name of its own, so that A's launches are
// told from D's by name (torch.profiler) and run D's code.
struct ALoad : DLoad {};

// Launch 1. Block (row `local` of the chunk, k2 group blockIdx.y): the
// core's NCOL columns are (pipe, k2) pairs, pipe-major, NK = NCOL / P k2
// columns a block. Column (p, k2) is Z (p = 0) or dZ (p = 1) at
// k1*M2 + k2, k1 < M1/2. With the derivative a thread's two slots hold
// the two pipelines of one column (slot-major), which load Pw, xhat and
// the grid once.
template <int LOGM1, int P, class Load>
__global__ void __launch_bounds__(fftr::kThreads)
cwt_d_stage1(Load load, int logM2, float2* __restrict__ Y, long long row0,
             long long nrows) {
  // the derivative's two pipelines of a column in one thread's two slots
  constexpr bool PAIR = P == 2;
  using S = fftr::Shape<LOGM1, PAIR>;
  constexpr int NK = S::NCOL / P;
  extern __shared__ float2 sm[];
  float2* tw = sm;
  float2* const bufs[2] = {sm + S::kTwFloat2,
                          sm + S::kTwFloat2 + S::NCOL * S::LD};
  const int M2 = 1 << logM2;
  constexpr int K1 = S::P / 2;
  const long long local = blockIdx.x;
  const auto src = load.row(row0 + local, (long long)K1 * M2);
  fftr::fill_twiddles<LOGM1>(tw);

  int col[S::U], lane[S::U];
  fftr::units<LOGM1, PAIR>(col, lane);
  float2 v[S::U][S::E];
  if constexpr (PAIR) {
    // slot p holds pipeline p of the thread's (k2, lane): one load of Pw,
    // xhat and the grid feeds both
    const int k2 = blockIdx.y * NK + col[0];
#pragma unroll
    for (int q = 0; q < S::E; ++q) {
      const int k1 = lane[0] + q * S::TPC;
      float2 z = make_float2(0.f, 0.f), dz = z;
      if (k2 < M2 && k1 < K1) src.z2((long long)k1 * M2 + k2, z, dz);
      v[0][q] = z;
      v[1][q] = dz;
    }
  } else {
#pragma unroll
    for (int u = 0; u < S::U; ++u) {
      const int k2 = blockIdx.y * NK + col[u];
#pragma unroll
      for (int q = 0; q < S::E; ++q) {
        const int k1 = lane[u] + q * S::TPC;
        v[u][q] = k2 < M2 && k1 < K1 ? src.z((long long)k1 * M2 + k2)
                                     : make_float2(0.f, 0.f);
      }
    }
  }
  __syncthreads();                        // the twiddle table
  fftr::fft<LOGM1, 1, 0, PAIR>(v, col, lane, bufs, tw, true, 0, S::P);

  const long long M = (long long)S::P * M2;
  const float inv2 = 2.0f / (float)M;     // exact: M is a power of two
#pragma unroll
  for (int u = 0; u < S::U; ++u) {
    const int pipe = col[u] / NK;
    const int k2 = blockIdx.y * NK + col[u] % NK;
    if (k2 >= M2) continue;
    float2* y = Y + (pipe * nrows + local) * M + k2;
    // e^{2 pi i n1 k2 / M} at n1 = lane + q TPC: the lane's value times the
    // step e^{2 pi i TPC k2 / M} q times (lane*k2 and TPC*k2 < M <= 2^22, so
    // both arguments are exact; the products add < 8 ulp)
    float s0, c0, s1, c1;
    sincospif((float)(lane[u] * k2) * inv2, &s0, &c0);
    sincospif((float)(S::TPC * k2) * inv2, &s1, &c1);
    float2 w = make_float2(c0, s0);
    const float2 step = make_float2(c1, s1);
#pragma unroll
    for (int q = 0; q < S::E; ++q) {
      const int n1 = lane[u] + q * S::TPC;
      y[(long long)n1 * M2] = fftr::cmul(v[u][q], w);
      w = fftr::cmul(w, step);
    }
  }
}

// Launch 2's output stages (a template parameter, as launch 1's loader).
//
// PlanesStore (D, E): one pipeline a block (blockIdx.z); pipeline p's kept
// outputs plus its Nyquist term go to planes (o[2p], o[2p+1]).
struct PlanesStore {
  static constexpr bool kPair = false;
  Planes pl;
};

// PhaseStore (A): both pipelines of an n1 row in one thread's two slots
// (the core's slot-major layout, as launch 1 with the derivative), so one
// thread holds Wx = (C, D) and dWx = (A, B) of each of its outputs and
// forms w = |B*C - A*D| / (|Wx|^2 * 2 pi), or +inf where |Wx|^2 <= gamma^2.
// Emits Wx and w; dWx never leaves the chip.
struct PhaseStore {
  static constexpr bool kPair = true;
  const float* nwr;
  const float* nwi;
  const float* ndr;
  const float* ndi;
  float gamma2;
  float* owr;
  float* owi;
  float* ow;
};

// A kept output: the transform's value over M plus the Nyquist term
// nyq (-1)^n / M (alt = +-1/M), its one rounding spelt out so that the
// compiler's contraction cannot differ between instances: D's and A's Wx
// come from this one expression, so A's Wx is D's with the derivative bit
// for bit.
__device__ __forceinline__ float kept(float v, float invM, float nyq,
                                      float alt) {
  return __fmaf_rn(v, invM, __fmul_rn(nyq, alt));
}

// Launch 2. Block (row `local`, n1 group blockIdx.y, and with PlanesStore
// pipe blockIdx.z): the core's columns are n1 rows of Y (with PhaseStore
// the two pipelines of NCU rows); outputs n2 in the rows that cover the
// keep window go through the store.
template <int LOGM2, class Store>
__global__ void __launch_bounds__(fftr::kThreads)
cwt_d_stage2(const float2* __restrict__ Y, Store st, int logM1, int start,
             int L, long long row0, long long nrows) {
  constexpr bool PAIR = Store::kPair;
  using S = fftr::Shape<LOGM2, PAIR>;
  constexpr int NN = PAIR ? S::NCU : S::NCOL;   // n1 rows a block
  extern __shared__ float2 sm[];
  float2* tw = sm;
  float2* const bufs[2] = {sm + S::kTwFloat2,
                          sm + S::kTwFloat2 + S::NCOL * S::LD};
  const int M1 = 1 << logM1;
  const long long local = blockIdx.x;
  const long long row = row0 + local;
  const long long M = (long long)S::P << logM1;
  fftr::fill_twiddles<LOGM2>(tw);

  int col[S::U], lane[S::U];
  fftr::units<LOGM2, PAIR>(col, lane);
  float2 v[S::U][S::E];
#pragma unroll
  for (int u = 0; u < S::U; ++u) {
    // slot-major: slot u is pipeline u (col[u] / NCU == u)
    const int pipe = PAIR ? u : blockIdx.z;
    const int n1 = blockIdx.y * NN + col[u] % NN;
    const float2* y = Y + (pipe * nrows + local) * M;
#pragma unroll
    for (int q = 0; q < S::E; ++q)
      v[u][q] = n1 < M1 ? y[(long long)n1 * S::P + lane[u] + q * S::TPC]
                        : make_float2(0.f, 0.f);
  }
  __syncthreads();                        // the twiddle table
  const int r0 = start >> logM1;
  const int r1 = ((start + L - 1) >> logM1) + 1;
  fftr::fft<LOGM2, 1, 0, PAIR>(v, col, lane, bufs, tw, false, r0, r1);

  const float invM = 1.0f / (float)M;
  if constexpr (PAIR) {
    const int n1 = blockIdx.y * NN + col[0] % NN;
    if (n1 >= M1) return;
    const float alt = (n1 & 1) ? -invM : invM;     // (-1)^n / M, M1 even
    const float nr_w = st.nwr[row], ni_w = st.nwi[row];
    const float nr_d = st.ndr[row], ni_d = st.ndi[row];
    const float two_pi = 6.283185307179586f;
#pragma unroll
    for (int q = 0; q < S::E; ++q) {
      const int n2 = lane[0] + q * S::TPC;
      const int j = n1 + (n2 << logM1) - start;
      if (n2 < r0 || n2 >= r1 || j < 0 || j >= L) continue;
      const float C = kept(v[0][q].x, invM, nr_w, alt);
      const float D = kept(v[0][q].y, invM, ni_w, alt);
      const float A = kept(v[1][q].x, invM, nr_d, alt);
      const float B = kept(v[1][q].y, invM, ni_d, alt);
      const float mag2 = C * C + D * D;
      const float ratio = (B * C - A * D) / (mag2 * two_pi);
      const long long o = row * L + j;
      st.owr[o] = C;
      st.owi[o] = D;
      st.ow[o] = (mag2 > st.gamma2) ? fabsf(ratio) : INFINITY;
    }
  } else {
    const int pipe = blockIdx.z;
    // (constant indices: a struct parameter indexed at run time would be
    // copied to local memory)
    const float nr = (pipe ? st.pl.nyq[2] : st.pl.nyq[0])[row];
    const float ni = (pipe ? st.pl.nyq[3] : st.pl.nyq[1])[row];
    float* or_ = (pipe ? st.pl.o[2] : st.pl.o[0]) + row * L;
    float* oi = (pipe ? st.pl.o[3] : st.pl.o[1]) + row * L;
#pragma unroll
    for (int u = 0; u < S::U; ++u) {
      const int n1 = blockIdx.y * NN + col[u];
      if (n1 >= M1) continue;
      const float alt = (n1 & 1) ? -invM : invM;   // (-1)^n / M, M1 even
#pragma unroll
      for (int q = 0; q < S::E; ++q) {
        const int n2 = lane[u] + q * S::TPC;
        const int j = n1 + (n2 << logM1) - start;
        if (n2 < r0 || n2 >= r1 || j < 0 || j >= L) continue;
        or_[j] = kept(v[u][q].x, invM, nr, alt);
        oi[j] = kept(v[u][q].y, invM, ni, alt);
      }
    }
  }
}

// Both launches over the rows, ychunk rows at a time (Y: scratch of
// P*ychunk*M float2), pipeline 0 (and 1) from `load`, the outputs through
// `store`.
template <int P, class Load, class Store>
int run_planes(Load load, Store store, long long rows, int logM1, int logM2,
               int start, int L, float2* Y, long long ychunk,
               cudaStream_t st) {
  if (ychunk < 1 || logM1 < 1 || logM2 < 1 || logM1 > 11 || logM2 > 11)
    return (int)cudaErrorInvalidValue;
  constexpr bool PAIR2 = Store::kPair;
  static_assert(!PAIR2 || P == 2, "the phase store takes both pipelines");
  const int M1 = 1 << logM1, M2 = 1 << logM2;
  // both launches' instances, shared memory and columns a block, resolved
  // once for every chunk
  decltype(&cwt_d_stage1<1, P, Load>) k1 = nullptr;
  decltype(&cwt_d_stage2<1, Store>) k2 = nullptr;
  size_t s1 = 0, s2 = 0;
  int nk = 1, nc = 1;
  cudaError_t err = fftr::dispatch_log<1, 11>(logM1, [&](auto c) {
    constexpr int LOG = decltype(c)::value;
    k1 = cwt_d_stage1<LOG, P, Load>;
    s1 = fftr::core_smem<LOG, P == 2>();
    nk = fftr::Shape<LOG, P == 2>::NCOL / P;
    return cudaFuncSetAttribute(
        k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  });
  if (err != cudaSuccess) return (int)err;
  err = fftr::dispatch_log<1, 11>(logM2, [&](auto c) {
    constexpr int LOG = decltype(c)::value;
    using S2 = fftr::Shape<LOG, PAIR2>;
    k2 = cwt_d_stage2<LOG, Store>;
    s2 = fftr::core_smem<LOG, PAIR2>();
    nc = PAIR2 ? S2::NCU : S2::NCOL;
    return cudaFuncSetAttribute(
        k2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  });
  if (err != cudaSuccess) return (int)err;
  const unsigned z2 = PAIR2 ? 1 : P;   // PlanesStore: a pipeline a block
  for (long long row0 = 0; row0 < rows; row0 += ychunk) {
    const long long nr = rows - row0 < ychunk ? rows - row0 : ychunk;
    k1<<<dim3((unsigned)nr, (M2 + nk - 1) / nk), fftr::kThreads, s1, st>>>(
        load, logM2, Y, row0, nr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    k2<<<dim3((unsigned)nr, (M1 + nc - 1) / nc, z2), fftr::kThreads, s2,
         st>>>(Y, store, logM1, start, L, row0, nr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel D. Y: scratch of P*ychunk*M float2 (P = 2 with the derivative,
// else 1); rows go through both launches ychunk at a time (the caller sizes
// the chunk so that Y stays in L2). Without the derivative, ndr/ndi/odr/odi
// are not read or written (may be null). Returns cudaGetLastError() after
// the launches (0 on success).
extern "C" int ssq_cwt_planes(const float* Pw, const float* xr,
                              const float* xi, const float* xig, float inv_dt,
                              const float* nwr, const float* nwi,
                              const float* ndr, const float* ndi,
                              long long rows, int na, int logM1, int logM2,
                              int start, int L, int derivative, void* Y,
                              long long ychunk, float* owr, float* owi,
                              float* odr, float* odi, void* stream) {
  const DLoad load = {Pw, xr, xi, xig, inv_dt, na};
  const PlanesStore pl = {{{nwr, nwi, ndr, ndi}, {owr, owi, odr, odi}}};
  cudaStream_t st = (cudaStream_t)stream;
  if (derivative)
    return run_planes<2>(load, pl, rows, logM1, logM2, start, L, (float2*)Y,
                         ychunk, st);
  return run_planes<1>(load, pl, rows, logM1, logM2, start, L, (float2*)Y,
                       ychunk, st);
}

// Kernel E. Zr, Zi: (rows, K1, M2); nr, ni: (rows,); Y: scratch of
// ychunk*M float2 (the caller sizes the chunk as D's, so that Y stays in
// L2). Returns cudaGetLastError() after the launches.
extern "C" int ssq_ifft_halfband(const float* Zr, const float* Zi,
                                 const float* nr, const float* ni,
                                 long long rows, int logM1, int logM2,
                                 int start, int L, void* Y, long long ychunk,
                                 float* outr, float* outi, void* stream) {
  const PlanesStore pl = {
      {{nr, ni, nullptr, nullptr}, {outr, outi, nullptr, nullptr}}};
  return run_planes<1>(ELoad{Zr, Zi}, pl, rows, logM1, logM2, start, L,
                       (float2*)Y, ychunk, (cudaStream_t)stream);
}

// Kernel A: D's launch pair with the derivative, A's loader (D's) and the
// phase store. Y: scratch of 2*ychunk*M float2 (the caller sizes the chunk
// as D's, so that Y stays in L2); outputs (rows, L). Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int ssq_cwt_phase(const float* Pw, const float* xr,
                             const float* xi, const float* xig, float inv_dt,
                             const float* nwr, const float* nwi,
                             const float* ndr, const float* ndi,
                             long long rows, int na, int logM1, int logM2,
                             int start, int L, float gamma2, void* Y,
                             long long ychunk, float* owr, float* owi,
                             float* ow, void* stream) {
  const ALoad load = {{Pw, xr, xi, xig, inv_dt, na}};
  const PhaseStore ps = {nwr, nwi, ndr, ndi, gamma2, owr, owi, ow};
  return run_planes<2>(load, ps, rows, logM1, logM2, start, L, (float2*)Y,
                       ychunk, (cudaStream_t)stream);
}
