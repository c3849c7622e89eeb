// The register-radix FFT core of kernels D (cwt_planes.cu) and F
// (stft_dft.cu): unnormalised power-of-two DFTs of columns, the points in
// registers, exchanged through shared memory between passes.
//
//   X[k] = sum_{n < P} x[n] e^{SIGN 2 pi i k n / P},  P = 2^LOGP, 2..4096
//
// Layout. A block of kThreads threads holds Shape::NCOL columns at a time,
// Shape::U slots a thread. Slot u of thread t is unit t + u kThreads,
// which is column unit % NCOL and lane unit / NCOL: neighbouring threads
// work on neighbouring columns, so the callers' device-memory accesses
// are runs over all NCOL columns. Slot-major (PAIR, two slots a thread):
// slot u of thread t is column u NCU + t % NCU and lane t / NCU
// (NCU = NCOL / 2), so a thread's two slots hold the same lane of NCU-apart
// columns (kernel D's two pipelines of one column, loaded once) and the
// runs are NCU columns long.
//
// A lane holds E points of its column in registers (16 where radix-16
// passes need fewer passes than radix 8, else min(8, P)), in lane order:
// v[q] is point lane + q TPC (TPC = P / E lanes a column), on entry the
// input and on exit the output of that index. A caller loads and stores
// in that order; the forward and the inverse transform of one column meet
// in registers.
//
// Passes (Stockham, self-sorting): radix E, then one pass of a smaller
// radix for what is left, so 512 points take 3 passes (8 8 8), and 1024
// and 2048 take 3 (16 16 4, 16 16 8). Pass p of radix R and stride
// Ns = E^p does E/R radix-R DFTs in registers; butterfly b reads points
// b + r P/R, multiplies them by e^{SIGN 2 pi i (b % Ns) r / (Ns R)} and
// writes its outputs to (b / Ns) Ns R + b % Ns + r Ns. Between two passes
// there is one shared-memory exchange and one barrier: the passes
// alternate between two buffers (pass p writes bufs[(p + FLIP) & 1]), so
// no pass overwrites what another thread may still read. A transform that
// follows another in the same buffers takes FLIP = kNextFlip of the first.
//
// Shared memory: a column takes Shape::LD float2, one float2 of padding
// after every E points (`pad`) and a column stride that puts neighbouring
// columns 16 / NCU float2 apart on the banks (NCU: the columns side by
// side in a warp). In both layouts every exchange is free of bank
// conflicts (counted by `bank_ways` of tests/test_torch_cwt.py, a numpy
// mirror of this schedule that the CPU tests run). A pass's shared-memory
// addresses are a per-butterfly base plus constants. Twiddles come from
// shared tables e^{2 pi i m / K}, one for each pass's K = Ns R (that of the
// last pass is K = P), filled with sincospif at exact arguments (2m/K is
// exact in float), ~1 ulp each.
//
// Pruning. `half_in` says that only the first P/2 inputs are nonzero: the
// first radix-8 or radix-16 pass then skips its first radix-2 level.
// [lo, hi) is the range of wanted outputs: the last pass skips the
// butterflies whose outputs all fall outside it (their registers are left
// undefined).
//
// What bounds it: shared memory and issue. Each exchange reads and writes
// every point once (16 bytes a point) and each pass but the first reads a
// twiddle a point; radix 8 or 16 takes 2-3 exchanges where radix 2 took
// log2 P, and the butterflies' arithmetic (~4-5 P log2 P flops a
// transform) comes next.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace fftr {

constexpr int kThreads = 256;

// Flags of the core (`fft`'s V; 0, the default, is the design above and
// what every path kernel runs). The probes of csrc/ablate_cwt.cu set them:
//   kNoExch   every pass reads its butterflies' inputs from the lane's own
//             registers (point b + r P/R at slot g + r G, as the first pass
//             does) and writes its outputs back there in place (as the
//             last pass does): the shared-memory exchanges are skipped,
//             the barriers kept. The result is a different linear map of
//             the column, which depends on the lane order and the passes'
//             radices and strides.
//   kGroupBar the barrier between passes is the named barrier of the
//             thread's group of kThreads threads (1 + threadIdx.x /
//             kThreads) in place of __syncthreads, so that several groups
//             (and a producer warp) can share a block.
enum Flags : unsigned {
  kNoExch = 1u << 0,
  kGroupBar = 1u << 1,
};

// index i with one float2 of padding after every 2^le points
__host__ __device__ constexpr int pad_by(int i, int le) {
  return i + (i >> le);
}

// PAIR picks the slot-major layout with two slots a thread (see units) and
// the column stride that keeps it free of bank conflicts.
template <int LOGP, bool PAIR = false>
struct Shape {
  static_assert(LOGP >= 1 && LOGP <= 12, "P = 2 .. 4096");
  static constexpr int P = 1 << LOGP;
  // log2 of the points a lane holds: 16 where radix-16 passes need fewer
  // passes than radix 8, else min(8, P)
  static constexpr int LE = (LOGP + 3) / 4 < (LOGP + 2) / 3 ? 4
                            : (LOGP < 3 ? LOGP : 3);
  static constexpr int E = 1 << LE;                // points a lane holds
  static constexpr int TPC = P / E;                // lanes a column
  static constexpr int U =                         // slots a thread
      P < 8 || PAIR ? 2 : (P == 4096 ? 2 : 1) * 16 / E;
  static constexpr int NCOL = U * kThreads / TPC;  // columns in flight
  // columns side by side in a warp's slot: all in flight, or a slot's
  static constexpr int NCU = PAIR ? NCOL / U : NCOL;
  // one float2 of padding after every E points of a column
  __host__ __device__ static constexpr int pad(int i) {
    return pad_by(i, LE);
  }
  static constexpr int LD = pad_by(P, LE) + (NCU >= 16 ? 1 : 16 / NCU);
  static constexpr int NPASS = (LOGP + LE - 1) / LE;
  static constexpr int kNextFlip = (NPASS - 1) & 1;
  __host__ __device__ static constexpr int radix(int p) {
    return p < LOGP / LE ? E : 1 << (LOGP % LE);
  }
  // pass p (1 <= p < NPASS - 1) reads its twiddles e^{2 pi i m / E^(p+1)}
  // from a table of E^(p+1) at tw_offset(p); the last pass from the table
  // of P at 0
  __host__ __device__ static constexpr int tw_offset(int p) {
    int off = P;
    for (int q = 1; q < p; ++q) off += 1 << (LE * (q + 1));
    return off;
  }
  // the twiddle tables and both exchange buffers, in float2
  static constexpr int kTwFloat2 = tw_offset(NPASS - 1);
  static constexpr int kBufFloat2 = 2 * NCOL * LD;
  static_assert(NCOL >= 2, "the layout needs two columns in flight");
};

// Bytes of a block's twiddle tables and both exchange buffers.
template <int LOGP, bool PAIR = false>
__host__ __device__ constexpr size_t core_smem() {
  using S = Shape<LOGP, PAIR>;
  return (size_t)(S::kTwFloat2 + S::kBufFloat2) * sizeof(float2);
}

// Calls f(std::integral_constant<int, LOG>) for LOG = log in [LO, HI]: a
// host's choice of a kernel instance by its transform length.
template <int LO, int HI, class F>
cudaError_t dispatch_log(int log, F&& f) {
  if constexpr (LO > HI) {
    return cudaErrorInvalidValue;
  } else {
    if (log == LO) return f(std::integral_constant<int, LO>{});
    return dispatch_log<LO + 1, HI>(log, f);
  }
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// table[m] = e^{2 pi i m / K}, m < K (all threads of the block).
__device__ inline void fill_table(float2* table, int K) {
  for (int m = threadIdx.x; m < K; m += blockDim.x) {
    float s, c;
    sincospif(2.0f * (float)m / (float)K, &s, &c);
    table[m] = make_float2(c, s);
  }
}

// The twiddle tables of Shape<LOGP> (kTwFloat2 float2; the caller
// synchronises before use). Pass p of stride Ns and radix R needs
// e^{2 pi i j r / (Ns R)}, j < Ns: from a table of Ns R entries its lanes
// read neighbouring entries (a table of P read at stride P / (Ns R) would
// put them all on a few banks).
template <int LOGP>
__device__ inline void fill_twiddles(float2* tw) {
  using S = Shape<LOGP>;
  fill_table(tw, S::P);
  for (int p = 1; p < S::NPASS - 1; ++p)
    fill_table(tw + S::tw_offset(p), 1 << (S::LE * (p + 1)));
}

// conj for SIGN < 0
template <int SIGN>
__device__ __forceinline__ float2 twiddle(const float2* table, unsigned m) {
  const float2 t = table[m];
  return SIGN > 0 ? t : make_float2(t.x, -t.y);
}

// a * (SIGN i)
template <int SIGN>
__device__ __forceinline__ float2 mul_i(float2 a) {
  return SIGN > 0 ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

template <int SIGN>
__device__ __forceinline__ void dft2(float2* v) {
  const float2 a = v[0], b = v[1];
  v[0] = make_float2(a.x + b.x, a.y + b.y);
  v[1] = make_float2(a.x - b.x, a.y - b.y);
}

template <int SIGN>
__device__ __forceinline__ void dft4(float2* v) {
  const float2 a = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
  const float2 c = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
  const float2 b = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
  const float2 d = mul_i<SIGN>(make_float2(v[1].x - v[3].x, v[1].y - v[3].y));
  v[0] = make_float2(a.x + b.x, a.y + b.y);
  v[2] = make_float2(a.x - b.x, a.y - b.y);
  v[1] = make_float2(c.x + d.x, c.y + d.y);
  v[3] = make_float2(c.x - d.x, c.y - d.y);
}

// Radix 8, decimation in frequency: u_n = x_n + x_{n+4} and
// t_n = (x_n - x_{n+4}) w8^n (n < 4) give the even and the odd outputs by
// two radix-4 DFTs. HALF: x_4..x_7 are zero (not read).
template <int SIGN, bool HALF>
__device__ __forceinline__ void dft8(float2* v) {
  constexpr float h = 0.70710678118654752f;   // sqrt(1/2)
  float2 u[4], t[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    if (HALF) {
      u[n] = v[n];
      t[n] = v[n];
    } else {
      u[n] = make_float2(v[n].x + v[n + 4].x, v[n].y + v[n + 4].y);
      t[n] = make_float2(v[n].x - v[n + 4].x, v[n].y - v[n + 4].y);
    }
  }
  // t1 *= w8, t2 *= w8^2 = SIGN i, t3 *= w8^3
  t[1] = make_float2(h * (t[1].x - SIGN * t[1].y),
                     h * (t[1].y + SIGN * t[1].x));
  t[2] = mul_i<SIGN>(t[2]);
  t[3] = make_float2(h * (-t[3].x - SIGN * t[3].y),
                     h * (SIGN * t[3].x - t[3].y));
  dft4<SIGN>(u);
  dft4<SIGN>(t);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = u[k];
    v[2 * k + 1] = t[k];
  }
}

// Radix 16 the same way: u_n = x_n + x_{n+8}, t_n = (x_n - x_{n+8}) w16^n
// (n < 8) give the even and the odd outputs by two radix-8 DFTs.
template <int SIGN, bool HALF>
__device__ __forceinline__ void dft16(float2* v) {
  constexpr float c1 = 0.92387953251128674f;  // cos(pi/8)
  constexpr float s1 = 0.38268343236508977f;  // sin(pi/8)
  constexpr float h = 0.70710678118654752f;
  // w16^n = (cos, SIGN sin)(pi n / 8), n = 1..7 (n = 4: SIGN i)
  constexpr float wc[8] = {1.f, c1, h, s1, 0.f, -s1, -h, -c1};
  constexpr float ws[8] = {0.f, s1, h, c1, 1.f, c1, h, s1};
  float2 u[8], t[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (HALF) {
      u[n] = v[n];
      t[n] = v[n];
    } else {
      u[n] = make_float2(v[n].x + v[n + 8].x, v[n].y + v[n + 8].y);
      t[n] = make_float2(v[n].x - v[n + 8].x, v[n].y - v[n + 8].y);
    }
  }
#pragma unroll
  for (int n = 1; n < 8; ++n)
    t[n] = n == 4 ? mul_i<SIGN>(t[n])
                  : cmul(t[n], make_float2(wc[n], SIGN * ws[n]));
  dft8<SIGN, false>(u);
  dft8<SIGN, false>(t);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[2 * k] = u[k];
    v[2 * k + 1] = t[k];
  }
}

template <int R, int SIGN>
__device__ __forceinline__ void dft(float2* v, bool half) {
  if constexpr (R == 16) {
    if (half) dft16<SIGN, true>(v);
    else dft16<SIGN, false>(v);
  } else if constexpr (R == 8) {
    if (half) dft8<SIGN, true>(v);
    else dft8<SIGN, false>(v);
  } else if constexpr (R == 4) {
    dft4<SIGN>(v);
  } else {
    dft2<SIGN>(v);
  }
}

// The barrier between two passes (kGroupBar: the group's own).
template <unsigned V>
__device__ __forceinline__ void pass_barrier() {
  if constexpr ((V & kGroupBar) != 0)
    asm volatile("bar.sync %0, %1;" ::"r"(1 + (int)threadIdx.x / kThreads),
                 "n"(kThreads)
                 : "memory");
  else
    __syncthreads();
}

template <int LOGP, int SIGN, int FLIP, int PASS, bool PAIR, unsigned V>
__device__ __forceinline__ void pass(
    float2 (&v)[Shape<LOGP, PAIR>::U][Shape<LOGP>::E],
    const int (&col)[Shape<LOGP, PAIR>::U],
    const int (&lane)[Shape<LOGP, PAIR>::U],
    float2* const (&bufs)[2], const float2* tw, bool half_in, int lo,
    int hi) {
  using S = Shape<LOGP, PAIR>;
  constexpr int P = S::P, E = S::E, TPC = S::TPC, LD = S::LD;
  constexpr int R = S::radix(PASS);
  constexpr int G = E / R;                 // butterflies a lane
  constexpr int PR = P / R;
  constexpr unsigned NS = 1u << (S::LE * PASS);  // the earlier radices
  constexpr bool FIRST = PASS == 0, LAST = PASS == S::NPASS - 1;
  // without the exchanges every pass reads as the first and writes as the
  // last
  constexpr bool NOEXCH = (V & kNoExch) != 0;
  const float2* src = bufs[(PASS - 1 + FLIP) & 1];
  float2* dst = bufs[(PASS + FLIP) & 1];
#pragma unroll
  for (int u = 0; u < S::U; ++u) {
    float2 t[E];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const unsigned b = lane[u] + g * TPC;
      if (LAST && ((int)b >= hi || (int)b + (R - 1) * PR < lo)) continue;
      // point b + r P/R; with P/R a multiple of E its padded index is the
      // padded b plus (E + 1) (r P/R) / E
      const int rd = col[u] * LD + S::pad(b);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if constexpr (FIRST || NOEXCH)
          t[g * R + r] = v[u][g + r * G];
        else if constexpr (PR % E == 0)
          t[g * R + r] = src[rd + (E + 1) * (r * PR / E)];
        else
          t[g * R + r] = src[col[u] * LD + S::pad(b + r * PR)];
      }
      if constexpr (NS > 1) {
        const float2* table = LAST ? tw : tw + S::tw_offset(PASS);
        const unsigned j = b % NS;
#pragma unroll
        for (int r = 1; r < R; ++r)
          t[g * R + r] = cmul(t[g * R + r], twiddle<SIGN>(table, j * r));
      }
      dft<R, SIGN>(t + g * R, FIRST && half_in);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const unsigned b = lane[u] + g * TPC;
      // output r of butterfly b goes to (b / Ns) Ns R + b % Ns + r Ns
      const unsigned w0 = (b / NS) * NS * R + b % NS;
      const int wr = col[u] * LD + S::pad(w0);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if constexpr (LAST || NOEXCH)
          v[u][g + r * G] = t[g * R + r];
        else if constexpr (NS % E == 0 || (NS == 1 && R == E))
          dst[wr + (NS == 1 ? r : (E + 1) * (r * (int)NS / E))] =
              t[g * R + r];
        else
          dst[col[u] * LD + S::pad(w0 + r * NS)] = t[g * R + r];
      }
    }
  }
  if constexpr (!LAST) {
    pass_barrier<V>();
    pass<LOGP, SIGN, FLIP, PASS + 1, PAIR, V>(v, col, lane, bufs, tw,
                                              half_in, lo, hi);
  }
}

// Each slot's column and lane (see the layout above).
template <int LOGP, bool PAIR = false>
__device__ __forceinline__ void units(int (&col)[Shape<LOGP, PAIR>::U],
                                      int (&lane)[Shape<LOGP, PAIR>::U]) {
  using S = Shape<LOGP, PAIR>;
#pragma unroll
  for (int u = 0; u < S::U; ++u) {
    if (PAIR) {
      col[u] = u * S::NCU + threadIdx.x % S::NCU;
      lane[u] = threadIdx.x / S::NCU;
    } else {
      const int id = threadIdx.x + u * kThreads;
      col[u] = id % S::NCOL;
      lane[u] = id / S::NCOL;
    }
  }
}

// The transform of every unit's column, in place in v (lane order in and
// out). All threads of the block (kGroupBar: of the group) call it
// together; bufs: two buffers of NCOL * LD float2 each; tw: the tables of
// fill_twiddles<LOGP>; V: the flags above (0: the design in full).
template <int LOGP, int SIGN, int FLIP = 0, bool PAIR = false,
          unsigned V = 0>
__device__ __forceinline__ void fft(
    float2 (&v)[Shape<LOGP, PAIR>::U][Shape<LOGP>::E],
    const int (&col)[Shape<LOGP, PAIR>::U],
    const int (&lane)[Shape<LOGP, PAIR>::U],
    float2* const (&bufs)[2], const float2* tw, bool half_in, int lo,
    int hi) {
  pass<LOGP, SIGN, FLIP, 0, PAIR, V>(v, col, lane, bufs, tw, half_in, lo,
                                     hi);
}

}  // namespace fftr
