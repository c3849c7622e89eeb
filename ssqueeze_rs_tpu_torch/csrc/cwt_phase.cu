// Kernel A: fused CWT filterbank multiply + half-band inverse DFT + unpad
// + Nyquist term + phase transform, for sm_90a.
//
// Replaces ssqueeze_rs_tpu/ops/fft_pallas.py::_make_cwt_kernel_phase
// (the pallas_call in _cwt_fused_call with phase_gamma). Per output row
// (b-major: row = ib*na + ia) it computes
//
//   Z[k]  = Pw[ia,k] * xhat[ib,k]              k < M/2 (half band)
//   dZ[k] = (-Im Z[k], Re Z[k]) * xig[k] / dt  (the derivative pipeline)
//   W(n)  = (1/M) sum_k Z[k] e^{2 pi i k n / M} + nyq_w (-1)^n / M
//   dW(n) likewise with dZ and nyq_d
//
// for n in the keep window [start, start+L), and emits Wx = (C, D) and
//   w = |B*C - A*D| / (|Wx|^2 * 2 pi),  or +inf where |Wx|^2 <= gamma^2,
// with (A, B) = dW. All planes float32.
//
// Transform: four-step split M = M1*M2, k = M2*k1 + k2, n = n1 + M1*n2.
//   launch 1 (one block per (row, TK2 k2-columns)): build Z and dZ in
//     registers, radix-2 inverse FFT over k1 in shared memory (K1 = M1/2
//     non-zero inputs), twiddle e^{2 pi i n1 k2 / M}, store the
//     intermediate Y[pipe][row][n1][k2] (complex) to device memory;
//   launch 2 (one block per (row, TN1 n1-rows)): length-M2 inverse FFT
//     over k2 in shared memory, then only the outputs inside the keep
//     window, with the Nyquist term and the phase epilogue, stored so that
//     consecutive threads write consecutive n (the transpose n = n1 + M1*n2
//     goes through shared memory).
//
// What bounds it on Hopper: device-memory traffic on the intermediate.
// Y is 2 pipelines x rows x M complex floats (1.2 GB at the 160k headline:
// 293 rows, M = 2^18), written once and read once, against ~0.15 GB of
// filterbank input and ~0.56 GB of output planes; the FFT arithmetic
// (~10 flop per butterfly, log2 M butterfly stages) is far below the
// card's rate. What the design does about it: Z and dZ are never
// materialised (built from Pw and xhat while loading launch 1), the
// intermediate is written and read exactly once with full 32-byte sectors
// (TK2 / TN1 consecutive columns per block), only the n2 rows that cover
// the keep window are stored, and the 1/M scale is applied once at the
// end. Rows go through the two launches in chunks of at most `ychunk`
// rows, so Y has a fixed size whatever the batch. Keeping Y out of device
// memory altogether (one block cluster per row, distributed shared memory)
// is later work.
//
// Twiddles are e^{2 pi i m / P} = sincospif(2m/P) with 2m/P exact in
// float (P a power of two), accurate to ~1 ulp; per-FFT tables live in
// shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
// Shared-memory budget per block when choosing the column tile.
constexpr int kSmemBudget = 200 * 1024;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ unsigned bitrev(unsigned v, int logP) {
  return __brev(v) >> (32 - logP);
}

// Twiddle table tw[t] = e^{2 pi i t / P}, t < P/2.
__device__ void fill_twiddles(float2* tw, int P) {
  for (int t = threadIdx.x; t < P / 2; t += blockDim.x) {
    float s, c;
    sincospif(2.0f * (float)t / (float)P, &s, &c);
    tw[t] = make_float2(c, s);
  }
}

// In-place radix-2 inverse DFT (unnormalised, sign +) of `ncol` columns
// of length P = 2^logP, column stride `ld`, inputs already in bit-reversed
// order; outputs come out in natural order.
__device__ void fft_columns(float2* buf, int ncol, int ld, int logP,
                            const float2* tw) {
  const int P = 1 << logP;
  const int half = P >> 1;
  const int nbf = ncol * half;
  for (int lh = 0; lh < logP; ++lh) {
    const int h = 1 << lh;
    const int tstride = half >> lh;      // P / (2h)
    for (int q = threadIdx.x; q < nbf; q += blockDim.x) {
      const int col = q >> (logP - 1);
      const int b = q & (half - 1);
      const int j = b & (h - 1);
      const int i0 = ((b >> lh) << (lh + 1)) | j;
      float2* X = buf + (size_t)col * ld;
      const float2 a = X[i0];
      const float2 t = cmul(X[i0 + h], tw[j * tstride]);
      X[i0] = make_float2(a.x + t.x, a.y + t.y);
      X[i0 + h] = make_float2(a.x - t.x, a.y - t.y);
    }
    __syncthreads();
  }
}

// Largest power of two <= 8 whose column tile fits the budget.
int pick_tile(int P, int other) {
  int t = 8;
  while (t > 1 && (2 * t * (P + 1) + P / 2) * (int)sizeof(float2) > kSmemBudget)
    t >>= 1;
  return t < other ? t : other;
}

__global__ void __launch_bounds__(kThreads)
cwt_stage1(const float* __restrict__ Pw, const float* __restrict__ xr,
           const float* __restrict__ xi, const float* __restrict__ xig,
           float inv_dt, int na, int logM1, int M2, int tk2,
           float2* __restrict__ Y, long long row0, long long nrows) {
  extern __shared__ float2 sm[];
  const int M1 = 1 << logM1;
  const int K1 = M1 >> 1;
  const int ld = M1 + 1;                  // padded column stride
  float2* tw = sm;                        // M1/2 twiddles
  float2* buf = sm + K1;                  // [2][tk2][ld]

  const long long local = blockIdx.x;      // row within the chunk (Y)
  const long long row = row0 + local;
  const int k2_0 = blockIdx.y * tk2;
  const long long ia = row % na, ib = row / na;
  const float* pw = Pw + ia * (long long)K1 * M2;
  const float* sr = xr + ib * (long long)K1 * M2;
  const float* si = xi + ib * (long long)K1 * M2;

  fill_twiddles(tw, M1);
  for (int e = threadIdx.x; e < M1 * tk2; e += blockDim.x) {
    const int c = e % tk2;
    const int k1 = e / tk2;
    float2 z = make_float2(0.f, 0.f), dz = z;
    if (k1 < K1) {
      const long long g = (long long)k1 * M2 + k2_0 + c;
      const float p = pw[g];
      const float zr = p * sr[g];
      const float zi = p * si[g];
      const float s = xig[g] * inv_dt;
      z = make_float2(zr, zi);
      dz = make_float2(-zi * s, zr * s);
    }
    const int pos = bitrev(k1, logM1);
    buf[c * ld + pos] = z;
    buf[(tk2 + c) * ld + pos] = dz;
  }
  __syncthreads();

  fft_columns(buf, 2 * tk2, ld, logM1, tw);

  const long long M = (long long)M1 * M2;
  const float invM2x = 2.0f / (float)M;   // exact: M is a power of two
  float2* y0 = Y + local * M;
  float2* y1 = Y + (nrows + local) * M;
  for (int e = threadIdx.x; e < M1 * tk2; e += blockDim.x) {
    const int c = e % tk2;
    const int n1 = e / tk2;
    const int k2 = k2_0 + c;
    // e^{2 pi i n1 k2 / M}; n1*k2 < M <= 2^22, so the argument is exact
    float s, co;
    sincospif((float)(n1 * k2) * invM2x, &s, &co);
    const float2 t = make_float2(co, s);
    const long long o = (long long)n1 * M2 + k2;
    y0[o] = cmul(buf[c * ld + n1], t);
    y1[o] = cmul(buf[(tk2 + c) * ld + n1], t);
  }
}

__global__ void __launch_bounds__(kThreads)
cwt_stage2(const float2* __restrict__ Y, const float* __restrict__ nwr,
           const float* __restrict__ nwi, const float* __restrict__ ndr,
           const float* __restrict__ ndi, int logM1, int logM2, int tn1,
           int start, int L, float gamma2, float* __restrict__ owr,
           float* __restrict__ owi, float* __restrict__ ow, long long row0,
           long long nrows) {
  extern __shared__ float2 sm[];
  const int M2 = 1 << logM2;
  const int ld = M2 + 1;
  float2* tw = sm;                        // M2/2 twiddles
  float2* buf = sm + (M2 >> 1);           // [2][tn1][ld]

  const long long local = blockIdx.x;
  const long long row = row0 + local;
  const int n1_0 = blockIdx.y * tn1;
  const long long M = (long long)M2 << logM1;
  const float2* y0 = Y + local * M;
  const float2* y1 = Y + (nrows + local) * M;

  fill_twiddles(tw, M2);
  for (int e = threadIdx.x; e < tn1 * M2; e += blockDim.x) {
    const int c = e >> logM2;
    const int k2 = e & (M2 - 1);
    const long long g = (long long)(n1_0 + c) * M2 + k2;
    const int pos = bitrev(k2, logM2);
    buf[c * ld + pos] = y0[g];
    buf[(tn1 + c) * ld + pos] = y1[g];
  }
  __syncthreads();

  fft_columns(buf, 2 * tn1, ld, logM2, tw);

  const float invM = 1.0f / (float)M;
  const float nr_w = nwr[row], ni_w = nwi[row];
  const float nr_d = ndr[row], ni_d = ndi[row];
  const int r0 = start >> logM1;
  const int r1 = ((start + L - 1) >> logM1) + 1;
  const int nout = tn1 * (r1 - r0);
  const float two_pi = 6.283185307179586f;
  for (int e = threadIdx.x; e < nout; e += blockDim.x) {
    const int c = e % tn1;
    const int n2 = r0 + e / tn1;
    const int n = n1_0 + c + (n2 << logM1);
    const int j = n - start;
    if (j < 0 || j >= L) continue;
    const float alt = (n & 1) ? -invM : invM;
    const float2 zw = buf[c * ld + n2];
    const float2 zd = buf[(tn1 + c) * ld + n2];
    const float C = zw.x * invM + nr_w * alt;
    const float D = zw.y * invM + ni_w * alt;
    const float A = zd.x * invM + nr_d * alt;
    const float B = zd.y * invM + ni_d * alt;
    const float mag2 = C * C + D * D;
    const float ratio = (B * C - A * D) / (mag2 * two_pi);
    const long long o = row * L + j;
    owr[o] = C;
    owi[o] = D;
    ow[o] = (mag2 > gamma2) ? fabsf(ratio) : INFINITY;
  }
}

}  // namespace

// Y: scratch of 2*ychunk*M float2; rows go through both launches ychunk at
// a time. Returns cudaGetLastError() after the launches (0 on success).
extern "C" int ssq_cwt_phase(const float* Pw, const float* xr,
                             const float* xi, const float* xig, float inv_dt,
                             const float* nwr, const float* nwi,
                             const float* ndr, const float* ndi,
                             long long rows, int na, int logM1, int logM2,
                             int start, int L, float gamma2, void* Y,
                             long long ychunk, float* owr, float* owi,
                             float* ow,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int M1 = 1 << logM1, M2 = 1 << logM2;

  if (ychunk < 1) return (int)cudaErrorInvalidValue;
  const int tk2 = pick_tile(M1, M2);
  const size_t smem1 = (size_t)(2 * tk2 * (M1 + 1) + M1 / 2) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      cwt_stage1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  const int tn1 = pick_tile(M2, M1);
  const size_t smem2 = (size_t)(2 * tn1 * (M2 + 1) + M2 / 2) * sizeof(float2);
  err = cudaFuncSetAttribute(
      cwt_stage2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;

  for (long long row0 = 0; row0 < rows; row0 += ychunk) {
    const long long nr = rows - row0 < ychunk ? rows - row0 : ychunk;
    cwt_stage1<<<dim3((unsigned)nr, M2 / tk2), kThreads, smem1, st>>>(
        Pw, xr, xi, xig, inv_dt, na, logM1, M2, tk2, (float2*)Y, row0, nr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cwt_stage2<<<dim3((unsigned)nr, M1 / tn1), kThreads, smem2, st>>>(
        (const float2*)Y, nwr, nwi, ndr, ndi, logM1, logM2, tn1, start, L,
        gamma2, owr, owi, ow, row0, nr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
