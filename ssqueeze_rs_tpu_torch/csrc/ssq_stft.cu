// Kernel G: the whole hop-1 ssq_stft in one kernel, for sm_90a.
//
// Replaces ssqueeze_rs_tpu/ops/stft_pallas.py::_make_ssq_stft_kernel (its
// full loop; the banded branch is bitwise equal to it and is later work).
// Per block of T consecutive columns of one signal, for each chunk of
// R = 64 frequency rows in increasing order:
//   1. the four planes Sr, Si, dSr, dSi of the chunk from the windowed DFT
//      (dft_tile.cuh, the same device code and sum order as kernel F, so
//      Sx is bitwise F's), dS times fs;
//   2. Sx stored; w = |Sfs - Im(dS/S)/2pi| and its linear bin (bins.cuh,
//      the code of kernel B'), masked where |Sx|^2 <= gamma^2 or past the
//      last column;
//   3. Tx[k, j] += Sx[i, j] * const[i] into a shared-memory (2, nf, T)
//      accumulator: one thread owns each column and adds the rows in
//      increasing i, with no atomics, so Tx is bitwise run-to-run and
//      bitwise B' applied to F's planes.
// The Sx/dSx planes of a chunk live only in shared memory between the DFT
// and the squeeze, as in the TPU kernel's VMEM.
//
// What bounds it: float32 arithmetic of the DFT (2.3e11 FLOP at the bench
// shape, 1200 rows x 598 taps x 160 000 columns), as in F; the squeeze
// adds a few percent. T (32, 16 or 8) is the largest whose shared-memory
// plan fits in 227 KB (the wrapper's ssq_stft_fused_ok decides it from
// nf and n_fft alone); one block of 8 warps per SM then keeps 32
// independent sums per thread in flight.

#include <cuda_runtime.h>

#include "bins.cuh"
#include "dft_tile.cuh"

namespace {

constexpr int kR = 64;              // frequency rows per plane per chunk
constexpr int kBM = 4 * kR;         // tile rows: [Sr; Si; dSr; dSi] chunk
constexpr int kTN = 8;
constexpr int kThreads = 256;

template <int T>
struct Shape {
  static constexpr int TM = kBM * T / (kTN * kThreads);
  using Tile = ssq::DftTile<kBM, T, TM, kTN>;
  static_assert(Tile::kThreads == kThreads, "thread count");
  // shared memory: acc (2, nf, T) | s (4, R, T) | ks (R, T) | As | xw
  static size_t smem(int nf, int NP) {
    return sizeof(float) * ((size_t)2 * nf * T + 4 * kR * T + kR * T +
                            Tile::kAsFloats + Tile::window(NP));
  }
};

template <int T>
__global__ void __launch_bounds__(kThreads)
ssq_stft_kernel(const float* __restrict__ xp, const float* __restrict__ Kg,
                long long mp, int NP, int nchunks, long long n_out, float fs,
                const float* __restrict__ cst, const float* __restrict__ sfs,
                float gamma2, ssq::Plan P, float* __restrict__ txr,
                float* __restrict__ txi, float* __restrict__ sxr,
                float* __restrict__ sxi) {
  using Tile = typename Shape<T>::Tile;
  constexpr int TM = Shape<T>::TM;
  constexpr int RT = kR * T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nf = P.nf;
  float* acc = reinterpret_cast<float*>(smem_raw);    // [2][nf][T]
  float* s = acc + 2 * nf * T;                        // [4][R][T]
  int* ks = reinterpret_cast<int*>(s + 4 * RT);       // [R][T]
  float* As = reinterpret_cast<float*>(ks + RT);
  float* xw = As + Tile::kAsFloats;
  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const long long j0 = (long long)blockIdx.x * T;

  for (int e = tid; e < 2 * nf * T; e += kThreads) acc[e] = 0.f;
  ssq::stage_signal(xp + b * mp, mp, j0, Tile::window(NP), xw);
  __syncthreads();

  const int tx = tid % (T / kTN);
  const int ty = tid / (T / kTN);
  for (int c = 0; c < nchunks; ++c) {
    float v[TM][kTN];
    ssq::dft_tile<kBM, T, TM, kTN>(Kg, (long long)nchunks * kBM,
                                   (long long)c * kBM, NP, xw, As, v);
    // 1. the chunk's four planes into shared memory, dS times fs
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty * TM + i;              // plane r / R, row r % R
#pragma unroll
      for (int m = 0; m < kTN; ++m)
        s[r * T + tx * kTN + m] =
            (r >= 2 * kR) ? __fmul_rn(v[i][m], fs) : v[i][m];
    }
    __syncthreads();
    // 2. store Sx; phase, bin and value of every entry (own entry only:
    //    the value goes where dSr/dSi were, the bin into ks)
    for (int e = tid; e < 2 * RT; e += kThreads) {
      const int i = c * kR + (e / T) % kR;
      const long long j = j0 + e % T;
      if (i < nf && j < n_out)
        (e < RT ? sxr : sxi)[(b * nf + i) * n_out + j] = s[e];
    }
    for (int e = tid; e < RT; e += kThreads) {
      const int i = c * kR + e / T;
      const long long j = j0 + e % T;
      const float C = s[e], D = s[RT + e];
      int k = -1;
      float vr = 0.f, vi = 0.f;
      if (i < nf && j < n_out) {
        const float w = ssq::phase_w(C, D, s[2 * RT + e], s[3 * RT + e],
                                     sfs[i], gamma2, ssq::kStft);
        k = ssq::bin_of(w, P);
        if (k >= 0) {
          vr = __fmul_rn(C, cst[i]);
          vi = __fmul_rn(D, cst[i]);
        }
      }
      s[2 * RT + e] = vr;
      s[3 * RT + e] = vi;
      ks[e] = k;
    }
    __syncthreads();
    // 3. ordered accumulate: thread tid < T owns column tid
    if (tid < T) {
      for (int r = 0; r < kR; ++r) {
        const int e = r * T + tid;
        const int k = ks[e];
        if (k >= 0) {
          acc[k * T + tid] += s[2 * RT + e];
          acc[(nf + k) * T + tid] += s[3 * RT + e];
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < nf * T; e += kThreads) {
    const long long j = j0 + e % T;
    if (j < n_out) {
      const long long o = (b * nf + e / T) * n_out + j;
      txr[o] = acc[e];
      txi[o] = acc[nf * T + e];
    }
  }
}

template <int T>
int launch(const float* xp, const float* Kg, int batch, long long mp, int NP,
           int nf, int nchunks, long long n_out, float fs, const float* cst,
           const float* sfs, float gamma2, const ssq::Plan& P, float* txr,
           float* txi, float* sxr, float* sxi, cudaStream_t stream) {
  const size_t smem = Shape<T>::smem(nf, NP);
  cudaError_t err = cudaFuncSetAttribute(
      ssq_stft_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n_out + T - 1) / T), (unsigned)batch);
  ssq_stft_kernel<T><<<grid, kThreads, smem, stream>>>(
      xp, Kg, mp, NP, nchunks, n_out, fs, cst, sfs, gamma2, P, txr, txi, sxr,
      sxi);
  return (int)cudaGetLastError();
}

}  // namespace

// xp: (batch, mp) padded signals; Kg: (NP, nchunks * 256), column block c
// holding rows [64c, 64c + 64) of the Sr, Si, dSr, dSi matrices in that
// order (zero past nf and past n_fft taps); cst, sfs: (nf,); outputs
// (batch, nf, n_out). cols (32, 16 or 8) is the wrapper's choice of T.
// Linear binning plan (mode, flipud, p0..p4) as in reassign.cu.
extern "C" int ssq_stft_fused(const float* xp, const float* Kg, int batch,
                              long long mp, int NP, int nf, int nchunks,
                              long long n_out, float fs, const float* cst,
                              const float* sfs, float gamma2, int mode,
                              int flipud, float p0, float p1, float p2,
                              float p3, float p4, int cols, float* txr,
                              float* txi, float* sxr, float* sxi,
                              void* stream) {
  if (NP % ssq::kBK || nchunks * kR < nf) return (int)cudaErrorInvalidValue;
  const ssq::Plan P{mode, flipud, nf, p0, p1, p2, p3, p4};
  cudaStream_t s = (cudaStream_t)stream;
  switch (cols) {
    case 32: return launch<32>(xp, Kg, batch, mp, NP, nf, nchunks, n_out, fs,
                               cst, sfs, gamma2, P, txr, txi, sxr, sxi, s);
    case 16: return launch<16>(xp, Kg, batch, mp, NP, nf, nchunks, n_out, fs,
                               cst, sfs, gamma2, P, txr, txi, sxr, sxi, s);
    case 8: return launch<8>(xp, Kg, batch, mp, NP, nf, nchunks, n_out, fs,
                             cst, sfs, gamma2, P, txr, txi, sxr, sxi, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
