// Probes P1-P3: where kernel D's time goes (the CWT planes with the
// derivative on D's launch pair, cwt_pair.cuh on the register-radix core
// fft_radix.cuh, rows in L2-sized chunks), for sm_90a.
//
// They replace the TPU probes of tools/ablate_cwt_kernel.py and
// tools/cwt_kernel_probe.py, which timed stripped variants of the fused
// Pallas CWT kernel at the cwt headline (293 rows, M = 2^18, 160 000 kept
// columns, with the derivative):
//
// P1 (ssq_ablate_cwt; _make_kernel :62, pallas_call :359, and
//   cwt_kernel_probe.make_kernel :52, :119): D's launches
//   cwt_d_stage1<logM1, 2, Load> and cwt_d_stage2<logM2, Store>
//   instantiated with the loader's and the store's ablation flags
//   (cwt_pair.cuh) and the core's (fftr::kNoExch):
//     full      D itself (DLoad, PlanesStore): D's planes bit for bit
//     nostage1  launch 1's radix passes skipped (the load, the twiddle and
//               the Y store stay)
//     nostage2  launch 2's passes skipped
//     nofft     both skipped (the TPU nodots, cwt_kernel_probe's glue)
//     notwiddle Y stored without the sincospif / cmul twiddle chain
//     noexch    every pass on its lane's own registers: the shared-memory
//               exchanges between passes skipped, the barriers kept (the
//               TPU nolayout)
//     yonly     launch 1 copies Z and dZ to Y, launch 2 copies Y to the
//               planes (no passes, twiddles or tables), Y in L2: the launch
//               pair's memory floor (the probe's dma)
//     noout     full compute, one column of each row stored
//     overlap   full compute with Pw read once a block (its row's first
//               value) and used for every bin: the pipeline on x alone
//     nochunk   full with one chunk of all rows, so Y goes through device
//               memory: what D's L2 chunking buys; D's planes bit for bit
//   The TPU's nosplit, ksplitC and dots4 time its bf16 dot splits, which
//   this port does not have.
// P2 (ssq_cwt_copy_floor; run_dma's kernel :395, :404): the copy floor of
//   any one-pass design at these bytes: every Pw row read once and written
//   to the first K columns of 4 (dmaonly) or 1 (dma1) planes of (rows, L),
//   the rest zero; dmanoin writes zero planes and reads nothing; dmarb8
//   takes 8 rows a work item instead of 1. A persistent kernel, one block
//   an SM, whose one issuing thread moves every byte by TMA bulk copies:
//   a work item is RB rows of one kCopyTile-float column chunk; each row's
//   part of Pw goes by cp.async.bulk into a ring of kCopySlots slots (on
//   an mbarrier each) and from there by bulk stores to the planes, the
//   zero part by bulk stores from a zeroed tile. A slot is loaded again
//   only after the stores from it have read it (wait_group.read), so
//   kCopySlots - 1 loads stay in flight behind the stores.
// P3 (ssq_cwt_staged; _make_manual_kernel :195, :311): D's launch 1 as a
//   persistent kernel fed by TMA. One producer warp keeps a ring of
//   kStages slots in flight on mbarriers; a slot holds one work item's
//   boxes of Pw (a 3-D map over (na, K1, M2)), xr, xi (over (b, K1, M2))
//   and xig (over (K1, M2)), kBoxCols k2 columns wide (32-byte rows, in
//   the 32-byte swizzle: every device-memory read is a whole sector, where
//   D's __ldg reads of Pw and xhat with the derivative run 16 bytes). The
//   work items are (row, k2 block) pairs, rows fastest as in D's grid. Two
//   consumer groups of 256 threads (D's block, on their own named
//   barriers) each run D's column code on 4 of the item's k2 columns out
//   of the slot that has landed, then free it. Launch 2 is D's. Same
//   arithmetic in the same order, so the planes are P1 full's bit for bit.
//
// What bounds them: D's work moves ~0.91 GB at the headline (Pw 0.15 GB
// in, four 0.19 GB planes out), ~0.27 ms at 3.35 TB/s; P2 is that floor
// as a kernel; P1 splits D's time between its parts; P3 asks whether
// explicit asynchronous staging buys anything on this card.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "cwt_pair.cuh"
#include "tma.cuh"

namespace {

constexpr int kThreads = fftr::kThreads;
// the log2 M1 and log2 M2 the probes are built for: M = 2^18 .. 2^20
constexpr int kLogLo = 9, kLogHi = 10;

// -- P1 -------------------------------------------------------------------
// A variant's flags: launch 1's (the loader's) and launch 2's (the
// store's).
struct Variant {
  unsigned load, store;
};
constexpr unsigned kYOnly1 = kNoFft | kNoTwiddle | kNoTable;
constexpr unsigned kYOnly2 = kNoFft | kNoTable;
// P1's variants, in the order of the `variant` argument; nochunk (the
// last) is full over one chunk of all rows
constexpr Variant kVariants[] = {
    {0, 0},                              // full
    {kNoFft, 0},                         // nostage1
    {0, kNoFft},                         // nostage2
    {kNoFft, kNoFft},                    // nofft
    {kNoTwiddle, 0},                     // notwiddle
    {fftr::kNoExch, fftr::kNoExch},      // noexch
    {kYOnly1, kYOnly2},                  // yonly
    {0, kNoOut},                         // noout
    {kPwOnce, 0},                        // overlap
    {0, 0},                              // nochunk
};
constexpr int kNumVariants = sizeof(kVariants) / sizeof(kVariants[0]);
constexpr int kNoChunk = kNumVariants - 1;

// D's loader with launch 1's flags V (kPwOnce: Pw read once a block).
template <unsigned V>
struct ProbeLoad : DLoad {
  static constexpr unsigned kAblate = V;
  struct Row : DLoad::Row {
    float p0;   // kPwOnce: the row's first Pw value
    __device__ void z2(long long g, float2& z, float2& dz) const {
      if constexpr ((V & kPwOnce) == 0) {
        DLoad::Row::z2(g, z, dz);
      } else {
        const float zr = p0 * __ldg(sr + g);
        const float zi = p0 * __ldg(si + g);
        const float s = __ldg(xig + g) * inv_dt;
        z = make_float2(zr, zi);
        dz = make_float2(-zi * s, zr * s);
      }
    }
  };
  __device__ Row row(long long r, long long half) const {
    const DLoad::Row base = DLoad::row(r, half);
    return {base, (V & kPwOnce) != 0 ? __ldg(base.pw) : 0.f};
  }
};

// D's planes store with launch 2's flags V.
template <unsigned V>
struct ProbeStore : PlanesStore {
  static constexpr unsigned kAblate = V;
};

// D's own types where a launch keeps everything
template <unsigned V>
using LoadOf = std::conditional_t<V == 0, DLoad, ProbeLoad<V>>;
template <unsigned V>
using StoreOf = std::conditional_t<V == 0, PlanesStore, ProbeStore<V>>;

template <int I>
int ablate_run(int variant, const DLoad& d, const PlanesStore& pl,
               long long rows, int logM1, int logM2, int start, int L,
               float2* Y, long long ychunk, cudaStream_t st) {
  if constexpr (I == kNumVariants) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (variant != I)
      return ablate_run<I + 1>(variant, d, pl, rows, logM1, logM2, start, L,
                               Y, ychunk, st);
    constexpr Variant v = kVariants[I];
    LoadOf<v.load> load;
    static_cast<DLoad&>(load) = d;
    StoreOf<v.store> store;
    static_cast<PlanesStore&>(store) = pl;
    return run_planes<2, LoadOf<v.load>, StoreOf<v.store>, kLogLo, kLogHi>(
        load, store, rows, logM1, logM2, start, L, Y, ychunk, st);
  }
}

// -- P2 -------------------------------------------------------------------
constexpr int kCopyTile = 8192;     // floats a column chunk and slot: 32 KB
constexpr int kCopySlots = 6;       // slots of the ring
constexpr int kCopyThreads = 128;   // all zero the zero tile; one issues
// the ring, the zero tile, the slots' mbarriers
constexpr size_t kCopySmem =
    (size_t)(kCopySlots + 1) * kCopyTile * sizeof(float) +
    kCopySlots * sizeof(uint64_t);

// One row's part of a work item: the floats of Pw it copies (nload, from
// column c0) and the zeros after them (nzero); both 0 past the last row.
struct CopyUnit {
  long long row, c0;
  int nload, nzero;
};

template <int RB, bool kRead>
__device__ __forceinline__ CopyUnit copy_unit(int q, long long K, int rows,
                                              long long L, long long groups) {
  // work items chunk-major: consecutive items (blocks) take the same
  // column chunk of consecutive row groups
  const long long it = blockIdx.x + (long long)(q / RB) * gridDim.x;
  const long long row = it % groups * RB + q % RB;
  const long long c0 = it / groups * kCopyTile;
  CopyUnit u{row, c0, 0, 0};
  if (row < rows) {
    const long long w = L - c0 < kCopyTile ? L - c0 : kCopyTile;
    const long long in = kRead ? (K < c0 + w ? K - c0 : w) : 0;
    u.nload = in > 0 ? (int)in : 0;
    u.nzero = (int)w - u.nload;
  }
  return u;
}

template <int NP, int RB, bool kRead>
__global__ void __launch_bounds__(kCopyThreads, 1)
copy_floor(const float* __restrict__ Pw, long long K, int rows, long long L,
           Planes pl, long long chunks) {
  const long long groups = (rows + RB - 1) / RB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // [kCopySlots][tile]
  float* zero = ring + (size_t)kCopySlots * kCopyTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(zero + kCopyTile);
  float4* z4 = reinterpret_cast<float4*>(zero);
  for (int e = threadIdx.x; e < kCopyTile / 4; e += kCopyThreads)
    z4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kCopySlots; ++s) ssq::mbar_init(&full[s], 1);
    ssq::mbar_init_fence();
  }
  ssq::fence_proxy_async();    // the zeros before the bulk stores read them
  __syncthreads();
  if (threadIdx.x != 0) return;

  const long long items = groups * chunks;
  const int units =
      (int)((items - blockIdx.x + gridDim.x - 1) / gridDim.x) * RB;
  auto issue = [&](int q) {
    const CopyUnit u = copy_unit<RB, kRead>(q, K, rows, L, groups);
    uint64_t* bar = &full[q % kCopySlots];
    if (u.nload) {
      ssq::tma_expect(bar, (uint32_t)u.nload * 4);
      ssq::bulk_load(ring + (size_t)(q % kCopySlots) * kCopyTile,
                     Pw + u.row * K + u.c0, (uint32_t)u.nload * 4, bar);
    } else {
      ssq::mbar_arrive(bar);
    }
  };
  for (int q = 0; q < units && q < kCopySlots; ++q) issue(q);
  for (int q = 0; q < units; ++q) {
    const int s = q % kCopySlots;
    const CopyUnit u = copy_unit<RB, kRead>(q, K, rows, L, groups);
    ssq::mbar_wait(&full[s], (uint32_t)(q / kCopySlots) & 1u);
    ssq::fence_proxy_async();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float* dst = pl.o[p] + u.row * L + u.c0;
      if (u.nload)
        ssq::bulk_store(dst, ring + (size_t)s * kCopyTile,
                        (uint32_t)u.nload * 4);
      if (u.nzero)
        ssq::bulk_store(dst + u.nload, zero, (uint32_t)u.nzero * 4);
    }
    ssq::bulk_commit();
    // the slot of unit q - 1 is read once its group (all but the newest)
    // is done reading: it takes the unit kCopySlots past it
    const int next = q - 1 + kCopySlots;
    if (q >= 1 && next < units) {
      ssq::bulk_wait_read<1>();
      issue(next);
    }
  }
  ssq::bulk_wait<0>();
}

template <int NP, int RB, bool kRead>
int copy_run(const float* Pw, long long K, int rows, long long L, Planes pl,
             cudaStream_t st) {
  const long long chunks = (L + kCopyTile - 1) / kCopyTile;
  const long long items = (rows + RB - 1) / RB * chunks;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(copy_floor<NP, RB, kRead>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kCopySmem);
  if (err != cudaSuccess) return (int)err;
  if (items < 1) return 0;
  const unsigned grid = (unsigned)(items < sms ? items : sms);
  copy_floor<NP, RB, kRead><<<grid, kCopyThreads, kCopySmem, st>>>(
      Pw, K, rows, L, pl, chunks);
  return (int)cudaGetLastError();
}

// -- P3 -------------------------------------------------------------------
constexpr int kStages = 2;     // slots of the ring
constexpr int kGroups = 2;     // consumer groups of kThreads threads
constexpr int kBoxCols = 8;    // k2 columns of a box: 32-byte rows
constexpr int kStagedThreads = kGroups * kThreads + 32;   // + the producer

// The shapes of P3's launch 1 at M1 = 2^LOGM1.
template <int LOGM1>
struct Staged {
  using S = fftr::Shape<LOGM1, true>;
  static constexpr int K1 = S::P / 2;
  static constexpr int NK = S::NCOL / 2;          // k2 columns a group
  static_assert(kGroups * NK == kBoxCols, "a group a core's columns");
  static constexpr int BOXR = K1 < 256 ? K1 : 256;   // k1 rows a box
  static constexpr int NBOX = K1 / BOXR;             // boxes an array
  static constexpr int kBox = BOXR * kBoxCols * 4;   // bytes
  static constexpr int kArray = K1 * kBoxCols * 4;   // Pw, xr, xi or xig
  static constexpr int kSlot = 4 * kArray;
  // the ring (1024-aligned), the twiddle tables, each group's exchange
  // buffers, the full and empty barriers
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kSlot +
      ((size_t)S::kTwFloat2 + kGroups * (size_t)S::kBufFloat2) *
          sizeof(float2) +
      2 * kStages * sizeof(uint64_t);
};

// The end of D's launch 1 (cwt_pair.cuh cwt_d_stage1, its arithmetic
// written out again): the NK columns from k2 = k2base of the transformed
// spectrum in v (lane order), times the twiddle e^{2 pi i n1 k2 / M}, into
// Y[pipe][local][n1][k2].
template <int LOGM1, int P>
__device__ __forceinline__ void stage1_store(
    const float2 (&v)[fftr::Shape<LOGM1, P == 2>::U]
                     [fftr::Shape<LOGM1, P == 2>::E],
    const int (&col)[fftr::Shape<LOGM1, P == 2>::U],
    const int (&lane)[fftr::Shape<LOGM1, P == 2>::U], unsigned k2base,
    int M2,
    float2* __restrict__ Y, long long local, long long nrows) {
  using S = fftr::Shape<LOGM1, P == 2>;
  constexpr int NK = S::NCOL / P;
  const long long M = (long long)S::P * M2;
  const float inv2 = 2.0f / (float)M;     // exact: M is a power of two
#pragma unroll
  for (int u = 0; u < S::U; ++u) {
    const int pipe = col[u] / NK;
    const int k2 = k2base + col[u] % NK;
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

// Element (k1, c) of an array's boxes: row k1 of 32 bytes in the 32-byte
// swizzle (the 16-byte half of a row flips with bit 7 of its offset).
__device__ __forceinline__ int swz32(int k1, int c) {
  const int o = k1 * (kBoxCols * 4) + c * 4;
  return (o ^ (((o >> 7) & 1) << 4)) >> 2;
}

template <int LOGM1>
__global__ void __launch_bounds__(kStagedThreads, 1)
staged_stage1(const __grid_constant__ CUtensorMap tpw,
              const __grid_constant__ CUtensorMap txr,
              const __grid_constant__ CUtensorMap txi,
              const __grid_constant__ CUtensorMap txig, float inv_dt, int na,
              int logM2, float2* __restrict__ Y, long long row0,
              long long nrows) {
  using T = Staged<LOGM1>;
  using S = typename T::S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (ssq::smem_u32(smem_raw) & 1023)) & 1023);
  float2* tw = reinterpret_cast<float2*>(ring + kStages * T::kSlot);
  float2* core = tw + S::kTwFloat2;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(core + kGroups * S::kBufFloat2);
  uint64_t* empty = full + kStages;
  const int M2 = 1 << logM2;
  const long long items = nrows * (M2 / kBoxCols);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      ssq::mbar_init(&full[s], 1);
      ssq::mbar_init(&empty[s], kGroups * kThreads);
    }
    ssq::mbar_init_fence();
  }
  fftr::fill_twiddles<LOGM1>(tw);
  __syncthreads();   // the barriers and the twiddle tables; the last
                     // barrier of the whole block

  if (threadIdx.x >= kGroups * kThreads) {
    // the producer: every item's boxes, stage after stage
    if (threadIdx.x == kGroups * kThreads) {
      int stage = 0;
      uint32_t phase = 0;
      for (long long it = blockIdx.x; it < items; it += gridDim.x) {
        const long long row = row0 + it % nrows;
        const int k2 = (int)(it / nrows) * kBoxCols;
        const int ia = (int)(row % na), ib = (int)(row / na);
        ssq::mbar_wait(&empty[stage], phase ^ 1);
        uint64_t* bar = &full[stage];
        ssq::tma_expect(bar, T::kSlot);
        unsigned char* slot = ring + stage * T::kSlot;
        for (int b = 0; b < T::NBOX; ++b) {
          const int y = b * T::BOXR, off = b * T::kBox;
          ssq::tma_load(slot + off, &tpw, k2, y, ia, bar);
          ssq::tma_load(slot + T::kArray + off, &txr, k2, y, ib, bar);
          ssq::tma_load(slot + 2 * T::kArray + off, &txi, k2, y, ib, bar);
          ssq::tma_load(slot + 3 * T::kArray + off, &txig, k2, y, bar);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // a consumer group: D's launch 1 on columns [group NK, (group + 1) NK)
  // of each item, its threads laid out as D's block (fftr::units)
  const int group = threadIdx.x / kThreads, t = threadIdx.x % kThreads;
  float2* const bufs[2] = {core + group * S::kBufFloat2,
                          core + group * S::kBufFloat2 + S::NCOL * S::LD};
  int col[S::U], lane[S::U];
#pragma unroll
  for (int u = 0; u < S::U; ++u) {
    col[u] = u * S::NCU + t % S::NCU;
    lane[u] = t / S::NCU;
  }
  int stage = 0;
  uint32_t phase = 0;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const long long local = it % nrows;
    const unsigned k2base = (unsigned)(it / nrows) * kBoxCols +
                            group * T::NK;
    const int c = group * T::NK + col[0];       // the column in the box
    ssq::mbar_wait(&full[stage], phase);
    const float* slot =
        reinterpret_cast<const float*>(ring + stage * T::kSlot);
    const float* sp = slot;
    const float* sr = slot + T::kArray / 4;
    const float* si = slot + 2 * T::kArray / 4;
    const float* sg = slot + 3 * T::kArray / 4;
    // D's loads on the slot, under D's test (k2 < M2 always holds here;
    // kept so that the products are formed where D forms them, and the
    // compiler fuses them into the same additions)
    const int k2 = k2base + col[0];
    float2 v[S::U][S::E];
#pragma unroll
    for (int q = 0; q < S::E; ++q) {   // DLoad::Row::z2 on the slot
      const int k1 = lane[0] + q * S::TPC;
      float2 z = make_float2(0.f, 0.f), dz = z;
      if (k2 < M2 && k1 < T::K1) {
        const int e = swz32(k1, c);
        const float p = sp[e];
        const float zr = p * sr[e];
        const float zi = p * si[e];
        const float s = sg[e] * inv_dt;
        z = make_float2(zr, zi);
        dz = make_float2(-zi * s, zr * s);
      }
      v[0][q] = z;
      v[1][q] = dz;
    }
    ssq::mbar_arrive(&empty[stage]);   // the slot is in registers
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
    fftr::fft<LOGM1, 1, 0, true, fftr::kGroupBar>(v, col, lane, bufs, tw,
                                                  true, 0, S::P);
    stage1_store<LOGM1, 2>(v, col, lane, k2base, M2, Y, local, nrows);
    // the next item's transform writes the buffers this one's last pass
    // read only where the passes are even in number
    if constexpr (S::kNextFlip != 0) fftr::pass_barrier<fftr::kGroupBar>();
  }
}

// The 3-D (or, with n = 0, 2-D) map of a float32 (n, K1, M2) array in
// boxes of kBoxCols x box_rows (x 1), the 32-byte swizzle.
bool staged_map(CUtensorMap* tm, const float* p, int M2, int K1, int n,
                int box_rows) {
  const ssq::EncodeTiled encode = ssq::tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)M2, (cuuint64_t)K1,
                              (cuuint64_t)(n > 0 ? n : 1)};
  const cuuint64_t strides[2] = {(cuuint64_t)M2 * 4,
                                 (cuuint64_t)M2 * 4 * K1};
  const cuuint32_t box[3] = {(cuuint32_t)kBoxCols, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(tm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, n > 0 ? 3 : 2,
                const_cast<float*>(p), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// P3's launch-1 instance at log2 M1 = LOGM1, its shared memory set, and
// the blocks of it an SM holds.
template <int LOGM1>
cudaError_t staged_setup(int* per_sm) {
  const auto k = staged_stage1<LOGM1>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Staged<LOGM1>::kSmem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, k, kStagedThreads, Staged<LOGM1>::kSmem);
}

}  // namespace

// P1. The arguments of ssq_cwt_planes with the derivative (Y: scratch of
// 2*ychunk*M float2, of 2*rows*M for nochunk) and `variant`: 0 full,
// 1 nostage1, 2 nostage2, 3 nofft, 4 notwiddle, 5 noexch, 6 yonly, 7 noout
// (planes (rows, 1)), 8 overlap, 9 nochunk (ychunk = rows); log2 M1 and
// log2 M2 in [9, 10]. Returns cudaGetLastError() after the launches.
extern "C" int ssq_ablate_cwt(const float* Pw, const float* xr,
                              const float* xi, const float* xig, float inv_dt,
                              const float* nwr, const float* nwi,
                              const float* ndr, const float* ndi,
                              long long rows, int na, int logM1, int logM2,
                              int start, int L, int variant, void* Y,
                              long long ychunk, float* owr, float* owi,
                              float* odr, float* odi, void* stream) {
  if (ychunk < 1) return (int)cudaErrorInvalidValue;
  if (variant == kNoChunk) ychunk = rows;
  const DLoad d = {Pw, xr, xi, xig, inv_dt, na};
  const PlanesStore pl = {{{nwr, nwi, ndr, ndi}, {owr, owi, odr, odi}}};
  return ablate_run<0>(variant, d, pl, rows, logM1, logM2, start, L,
                       (float2*)Y, ychunk, (cudaStream_t)stream);
}

// P2. Pw: (rows, K); planes (rows, L); K and L multiples of 4 (16-byte
// rows for the bulk copies). (nplanes, rb, read): dmaonly (4, 1, 1), dma1
// (1, 1, 1), dmanoin (4, 1, 0), dmarb8 (4, 8, 1); planes past nplanes are
// not written (may be null).
extern "C" int ssq_cwt_copy_floor(const float* Pw, long long K, int rows,
                                  long long L, int nplanes, int rb, int read,
                                  float* o0, float* o1, float* o2, float* o3,
                                  void* stream) {
  if (K % 4 || L % 4) return (int)cudaErrorInvalidValue;
  Planes pl = {{nullptr, nullptr, nullptr, nullptr}, {o0, o1, o2, o3}};
  cudaStream_t st = (cudaStream_t)stream;
  if (nplanes == 4 && rb == 1 && read)
    return copy_run<4, 1, true>(Pw, K, rows, L, pl, st);
  if (nplanes == 1 && rb == 1 && read)
    return copy_run<1, 1, true>(Pw, K, rows, L, pl, st);
  if (nplanes == 4 && rb == 1 && !read)
    return copy_run<4, 1, false>(Pw, K, rows, L, pl, st);
  if (nplanes == 4 && rb == 8 && read)
    return copy_run<4, 8, true>(Pw, K, rows, L, pl, st);
  return (int)cudaErrorInvalidValue;
}

// P3. The arguments of ssq_cwt_planes with the derivative (Y: scratch of
// 2*ychunk*M float2); log2 M1 = 9 (K1 = 256: one box a k2 block and
// array), log2 M2 in [9, 10]. Launch 1 is staged_stage1 over each chunk's
// items on as many persistent blocks as fit, launch 2 D's. Returns
// cudaGetLastError() after the launches.
extern "C" int ssq_cwt_staged(const float* Pw, const float* xr,
                              const float* xi, const float* xig, float inv_dt,
                              const float* nwr, const float* nwi,
                              const float* ndr, const float* ndi,
                              long long rows, int na, int logM1, int logM2,
                              int start, int L, void* Y, long long ychunk,
                              float* owr, float* owi, float* odr, float* odi,
                              void* stream) {
  constexpr int LOGM1 = kLogLo;
  if (ychunk < 1 || logM1 != LOGM1 || logM2 < kLogLo || logM2 > kLogHi ||
      rows % na)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int M1 = 1 << logM1, M2 = 1 << logM2, K1 = M1 / 2;
  CUtensorMap tm[4];
  const int nb = (int)(rows / na), box_rows = Staged<LOGM1>::BOXR;
  if (!staged_map(&tm[0], Pw, M2, K1, na, box_rows) ||
      !staged_map(&tm[1], xr, M2, K1, nb, box_rows) ||
      !staged_map(&tm[2], xi, M2, K1, nb, box_rows) ||
      !staged_map(&tm[3], xig, M2, K1, 0, box_rows))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = staged_setup<LOGM1>(&per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // launch 2: D's instance and its shared memory, as run_planes sets them
  decltype(&cwt_d_stage2<kLogLo, PlanesStore>) k2 = nullptr;
  size_t s2 = 0;
  int nc = 1;
  err = fftr::dispatch_log<kLogLo, kLogHi>(logM2, [&](auto c) {
    constexpr int LOG = decltype(c)::value;
    k2 = cwt_d_stage2<LOG, PlanesStore>;
    s2 = fftr::core_smem<LOG, false>();
    nc = fftr::Shape<LOG, false>::NCOL;
    return cudaFuncSetAttribute(
        k2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  });
  if (err != cudaSuccess) return (int)err;
  const PlanesStore pl = {{{nwr, nwi, ndr, ndi}, {owr, owi, odr, odi}}};
  for (long long row0 = 0; row0 < rows; row0 += ychunk) {
    const long long nr = rows - row0 < ychunk ? rows - row0 : ychunk;
    const long long items = nr * (M2 / kBoxCols);
    const long long cap = (long long)sms * per_sm;
    staged_stage1<LOGM1><<<(unsigned)(items < cap ? items : cap),
                           kStagedThreads, Staged<LOGM1>::kSmem, st>>>(
        tm[0], tm[1], tm[2], tm[3], inv_dt, na, logM2, (float2*)Y, row0, nr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    k2<<<dim3((unsigned)nr, (M1 + nc - 1) / nc, 2), kThreads, s2, st>>>(
        (const float2*)Y, pl, logM1, start, L, row0, nr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// P3's launch 1 as built: out[0..5] = blocks an SM, registers a thread,
// dynamic shared memory (bytes), threads a block, slots of the ring, k2
// columns a box. Returns a cudaError_t.
extern "C" int ssq_cwt_staged_plan(int* out) {
  constexpr int LOGM1 = kLogLo;
  cudaFuncAttributes attr;
  int per_sm = 0;
  cudaError_t err = staged_setup<LOGM1>(&per_sm);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr,
                                                      staged_stage1<LOGM1>);
  if (err != cudaSuccess) return (int)err;
  out[0] = per_sm;
  out[1] = attr.numRegs;
  out[2] = (int)Staged<LOGM1>::kSmem;
  out[3] = kStagedThreads;
  out[4] = kStages;
  out[5] = kBoxCols;
  return 0;
}
