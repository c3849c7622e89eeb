// The launch pair of kernels D, E and A (cwt_planes.cu): launch 1 runs
// the length-M1 inverse FFTs over k1 of a row's half-band spectrum, from a
// loader, and stores the twiddled intermediate Y[pipe][row][n1][k2];
// launch 2 runs the length-M2 inverse FFTs over k2 and hands the kept
// outputs to a store. Both run on the register-radix core
// (fft_radix.cuh). The design, and what bounds it, is described in
// cwt_planes.cu; it lives in this header so that the probes of
// ablate_cwt.cu instantiate the same kernels.
//
// Ablation. A loader's and a store's `kAblate` (0 for the path's DLoad,
// ELoad, ALoad, PlanesStore and PhaseStore, which compile to the design in
// full) are the flags of their launch, below; fftr::kNoExch passes through
// to the core. Each flag removes one part of its launch and keeps the
// memory traffic of the rest.
//
// The code lives in an anonymous namespace so that each source that
// includes it compiles its own instances.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "fft_radix.cuh"
#include "planes.cuh"

namespace {

// Flags of a loader's or a store's kAblate: each removes one part of its
// launch (the probes' variants, ablate_cwt.cu). fftr::kNoExch (bit 0) goes
// to the core's passes.
enum Ablate : unsigned {
  kNoFft = 1u << 4,      // the launch's radix passes skipped
  kNoTwiddle = 1u << 5,  // launch 1 stores Y without the twiddle chain
  kNoTable = 1u << 6,    // no twiddle tables, and no barrier for them
  kPwOnce = 1u << 7,     // loader: Pw read once a block (the row's first
                         // value) and used for every bin
  kNoOut = 1u << 8,      // store: one output a row (j = 0), planes (rows, 1)
};

// Launch 1's spectrum loaders: row(r, half) gives row r's view, whose z(g)
// is Z at bin g = k1*M2 + k2 (and z2(g, z, dz) Z and dZ, for the
// derivative). Reads go through the read-only path (__ldg).
//
// Kernel D: Z = Pw[ia] * xhat[ib] (row = ib*na + ia), dZ = (-Im Z, Re Z) *
// xig / dt, built while loading.
struct DLoad {
  static constexpr unsigned kAblate = 0;
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
  static constexpr unsigned kAblate = 0;
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
  constexpr unsigned V = Load::kAblate;
  const auto src = load.row(row0 + local, (long long)K1 * M2);
  if constexpr ((V & kNoTable) == 0) fftr::fill_twiddles<LOGM1>(tw);

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
  if constexpr ((V & kNoTable) == 0) __syncthreads();   // the table
  if constexpr ((V & kNoFft) == 0)
    fftr::fft<LOGM1, 1, 0, PAIR, V & fftr::kNoExch>(v, col, lane, bufs, tw,
                                                    true, 0, S::P);

  const long long M = (long long)S::P * M2;
  const float inv2 = 2.0f / (float)M;     // exact: M is a power of two
#pragma unroll
  for (int u = 0; u < S::U; ++u) {
    const int pipe = col[u] / NK;
    const int k2 = blockIdx.y * NK + col[u] % NK;
    if (k2 >= M2) continue;
    float2* y = Y + (pipe * nrows + local) * M + k2;
    if constexpr ((V & kNoTwiddle) != 0) {
#pragma unroll
      for (int q = 0; q < S::E; ++q)
        y[(long long)(lane[u] + q * S::TPC) * M2] = v[u][q];
      continue;
    }
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
  static constexpr unsigned kAblate = 0;
  Planes pl;
};

// PhaseStore (A): both pipelines of an n1 row in one thread's two slots
// (the core's slot-major layout, as launch 1 with the derivative), so one
// thread holds Wx = (C, D) and dWx = (A, B) of each of its outputs and
// forms w = |B*C - A*D| / (|Wx|^2 * 2 pi), or +inf where |Wx|^2 <= gamma^2.
// Emits Wx and w; dWx never leaves the chip.
struct PhaseStore {
  static constexpr bool kPair = true;
  static constexpr unsigned kAblate = 0;
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
  constexpr unsigned V = Store::kAblate;
  static_assert(!PAIR || (V & kNoOut) == 0, "noout takes the planes store");
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
  if constexpr ((V & kNoTable) == 0) fftr::fill_twiddles<LOGM2>(tw);

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
  if constexpr ((V & kNoTable) == 0) __syncthreads();   // the table
  const int r0 = start >> logM1;
  const int r1 = ((start + L - 1) >> logM1) + 1;
  if constexpr ((V & kNoFft) == 0)
    fftr::fft<LOGM2, 1, 0, PAIR, V & fftr::kNoExch>(v, col, lane, bufs, tw,
                                                    false, r0, r1);

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
    // kNoOut: planes (rows, 1), the output at j = 0 alone
    const long long ld = (V & kNoOut) != 0 ? 1 : L;
    float* or_ = (pipe ? st.pl.o[2] : st.pl.o[0]) + row * ld;
    float* oi = (pipe ? st.pl.o[3] : st.pl.o[1]) + row * ld;
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
        if ((V & kNoOut) != 0 && j != 0) continue;
        or_[j] = kept(v[u][q].x, invM, nr, alt);
        oi[j] = kept(v[u][q].y, invM, ni, alt);
      }
    }
  }
}

// Both launches over the rows, ychunk rows at a time (Y: scratch of
// P*ychunk*M float2), pipeline 0 (and 1) from `load`, the outputs through
// `store`; instances for log2 M1 and log2 M2 in [LO, HI] (others return
// cudaErrorInvalidValue).
template <int P, class Load, class Store, int LO = 1, int HI = 11>
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
  decltype(&cwt_d_stage1<LO, P, Load>) k1 = nullptr;
  decltype(&cwt_d_stage2<LO, Store>) k2 = nullptr;
  size_t s1 = 0, s2 = 0;
  int nk = 1, nc = 1;
  cudaError_t err = fftr::dispatch_log<LO, HI>(logM1, [&](auto c) {
    constexpr int LOG = decltype(c)::value;
    k1 = cwt_d_stage1<LOG, P, Load>;
    s1 = fftr::core_smem<LOG, P == 2>();
    nk = fftr::Shape<LOG, P == 2>::NCOL / P;
    return cudaFuncSetAttribute(
        k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  });
  if (err != cudaSuccess) return (int)err;
  err = fftr::dispatch_log<LO, HI>(logM2, [&](auto c) {
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
