// Up-path skip projection: a 1x1 conv over a two-part channel concat, plus
// the residual add, plus the output's per-sample channel statistics.
//
// Replaces lfvdm_tpu/ops/skipconv.py::_kernel (the Pallas kernel behind
// skip_conv_stats, launched by _fwd_pallas). Plain version, launch plan and
// wrapper: lfvdm_tpu_torch/ops/skipconv.py.
//
// Layout (row-major, NCHW with the pixels flattened to P = H·W):
//   x1     (N, c1, P)     the up path's h
//   x2     (N, c2, P)     the skip tensor
//   w      (F, c1 + c2)   the 1x1 conv weight
//   b      (F,)
//   resid  (N, F, P)      the residual branch's output
//   y      (N, F, P)      y[n] = w[:, :c1]·x1[n] + w[:, c1:]·x2[n] + resid[n] + b
//   s1, s2 (N, F) f32     Σ_p y and Σ_p y², taken from the f32 value of y
//                         before it is rounded to the storage type
//   partial (2, N, p_tiles, F) f32 scratch: per-pixel-tile sums
//
// Per sample the op is a GEMM (F x K) · (K x P) with K = c1 + c2, and a
// fused epilogue. Every tile of output covers channels of ONE sample, so
// each row's Σy and Σy² over the tile's pixels is one partial per (sample,
// pixel tile, channel); a second small kernel sums the partials over the
// pixel tiles in a fixed order, so the statistics are deterministic (no
// atomics). Activation rows are read in place from x1 or x2: the concat is
// never built.
//
// Two routes, chosen by the launch plan (make_plan, mirrored by
// skipconv.plan in Python, which passes its plan to be checked):
//
//  * "bulk": bf16, P % 8 == 0, c1 % 16 == 0, c2 % 16 == 0, 16-byte aligned
//    x1, x2, w, resid and y (every flagship shape). A persistent kernel for
//    Hopper, below.
//  * "generic": everything else (f32, odd widths, unaligned views): 64 x 64
//    tiles, element-wise loads into one shared stage; bf16 on WMMA, f32 on
//    plain FMAs.
//
// Bound on the H100: the flagship work is 2·N·P·K·F flops against the bytes
// of x1, x2, resid and y (plus w), far under the card's ~295 bf16 operations
// per byte, so the bound is bytes: 0.590 ms for the 10 up-path launches of
// one flagship forward (0.2004 ms at each 128 x 128 level, 0.0033 ms at the
// smallest). At ds 16 the arithmetic needs 2.7 µs at the bf16 peak and the
// bytes 3.5 µs. So the bulk route is built for bytes in flight and for
// fewer re-reads through L2, not for tensor-core rate:
//
//  1. Bytes in flight. A producer warpgroup (4 warps) keeps a ring of up to
//     4 stages of 64-deep K slices (w: BM rows, x: BN pixels; up to 35 KB
//     each) in flight, where covering the memory latency takes ~18 KB per
//     SM. Full and empty mbarriers per stage replace __syncthreads in the
//     main loop, so the 8 consumer warps never wait for one another there.
//     The slices go by 16-byte cp.async, each producer thread's copies
//     completing on the stage's mbarrier, and not by bulk copies: a slice
//     is one 128-256 byte row per copy, and the copy engine takes ~27 ns
//     per bulk copy per SM whatever its size (PERF.md), ~1.3 TB/s at most.
//  2. Weight re-reads. Where one channel tile covers F (F <= BM) and K is
//     small (the 64 x 64 and 128 x 128 levels, 0.51 of the 0.59 ms bound),
//     the whole w stays resident in shared memory for the kernel's life,
//     loaded once per CTA by bulk copies of whole rows (few and long); the
//     ring carries x alone. Elsewhere w streams with x.
//  3. A serial epilogue. The grid is persistent (one CTA per SM) and walks
//     output tiles in a fixed round-robin order, channel tiles innermost so
//     that concurrent CTAs share x in L2. The producers prefetch each
//     tile's residual rows into a buffer of their own (two buffers) at the
//     tile's start; the epilogue adds acc + resid + bias in f32, takes the
//     statistics from those unrounded values, writes the rounded y over the
//     residual rows and stores them in 16-byte chunks, while the producers
//     already fill the ring for the next tile.
//  4. Latency at the small levels (K up to 1024). Slices are 64 deep, so
//     16 steps at most, none with a block-wide barrier, and a consumer only
//     ever waits for the slice it needs.
//
// Tensor cores: mma.sync m16n8k16 (bf16 in, f32 accumulators in registers)
// on ldmatrix fragments: A = w (f, k) row-major, B = x (k, p) read with
// ldmatrix.trans. Each staged row is padded by 16 bytes, so the ldmatrix
// rows fall in distinct banks with no swizzle. Ragged edges: chunks past F,
// K or P are zero-filled; rows of the resident w past F hold stale values
// that reach only outputs the epilogue masks, and the inner loop stops at
// the last K row that exists (K % 16 == 0).
//
// Next steps: TMA tensor maps and wgmma, a backward kernel.

#include <mma.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// The "generic" route: f32, odd widths, unaligned views.
// ---------------------------------------------------------------------------

constexpr int kBM = 64;   // output channels per block
constexpr int kBN = 64;   // pixels per block
constexpr int kBK = 32;   // reduction depth per stage
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// Shared tiles; the activation rows carry padding so that the WMMA loads
// stay 32-byte aligned and the FMA loop avoids bank conflicts.
template <typename T>
struct Tiles;
template <>
struct Tiles<__nv_bfloat16> {
  static constexpr int kLdA = kBK + 8;
  static constexpr int kLdB = kBN + 8;
};
template <>
struct Tiles<float> {
  static constexpr int kLdA = kBK + 1;
  static constexpr int kLdB = kBN + 4;
};
constexpr int kLdC = kBN + 4;

// Stage the w slice [f0, f0+kBM) x [k0, k0+kBK) and the activation slice
// [k0, k0+kBK) x [p0, p0+kBN) of sample n; zeros past F, K and P.
template <typename T>
__device__ __forceinline__ void load_tiles(T* sA, T* sB, const T* __restrict__ w,
                                           const T* __restrict__ x1n, const T* __restrict__ x2n,
                                           int f0, int k0, int p0, int F, int c1, int c2, int P) {
  constexpr int ldA = Tiles<T>::kLdA, ldB = Tiles<T>::kLdB;
  const int K = c1 + c2;
  for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
    const int r = i / kBK, c = i - r * kBK;
    const int f = f0 + r, k = k0 + c;
    sA[r * ldA + c] = (f < F && k < K) ? w[(long long)f * K + k] : zero<T>();
  }
  for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
    const int r = i / kBN, c = i - r * kBN;
    const int k = k0 + r, p = p0 + c;
    T v = zero<T>();
    if (p < P) {
      if (k < c1) {
        v = x1n[(long long)k * P + p];
      } else if (k < K) {
        v = x2n[(long long)(k - c1) * P + p];
      }
    }
    sB[r * ldB + c] = v;
  }
}

// The block's (kBM, kBN) accumulator in f32, written to sC.
__device__ __forceinline__ void mainloop(const __nv_bfloat16* __restrict__ w,
                                         const __nv_bfloat16* __restrict__ x1n,
                                         const __nv_bfloat16* __restrict__ x2n, int f0, int p0,
                                         int F, int c1, int c2, int P, float* sC) {
  using namespace nvcuda;
  constexpr int ldA = Tiles<__nv_bfloat16>::kLdA, ldB = Tiles<__nv_bfloat16>::kLdB;
  __shared__ __align__(32) __nv_bfloat16 sA[kBM * ldA];
  __shared__ __align__(32) __nv_bfloat16 sB[kBK * ldB];
  // Four warps in a 2 x 2 layout; each owns a 32 x 32 quarter: 2 x 2 fragments.
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int K = c1 + c2;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous slice's readers are done
    load_tiles(sA, sB, w, x1n, x2n, f0, k0, p0, F, c1, c2, P);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], sA + (wm + 16 * i) * ldA + kk, ldA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], sB + kk * ldB + wn + 16 * j, ldB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wm + 16 * i) * kLdC + wn + 16 * j, acc[i][j], kLdC,
                              wmma::mem_row_major);
}

__device__ __forceinline__ void mainloop(const float* __restrict__ w, const float* __restrict__ x1n,
                                         const float* __restrict__ x2n, int f0, int p0, int F,
                                         int c1, int c2, int P, float* sC) {
  constexpr int ldA = Tiles<float>::kLdA, ldB = Tiles<float>::kLdB;
  __shared__ float sA[kBM * ldA];
  __shared__ float sB[kBK * ldB];
  // 8 x 16 threads; each owns 8 rows x 4 columns of the tile.
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int K = c1 + c2;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();
    load_tiles(sA, sB, w, x1n, x2n, f0, k0, p0, F, c1, c2, P);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sA[(tr * 8 + i) * ldA + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[k * ldB + tc * 4 + j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sC[(tr * 8 + i) * kLdC + tc * 4 + j] = acc[i][j];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    skip_conv_stats_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                           const T* __restrict__ w, const T* __restrict__ b,
                           const T* __restrict__ resid, T* __restrict__ y,
                           float* __restrict__ part1, float* __restrict__ part2, int N, int c1,
                           int c2, int F, int P) {
  __shared__ __align__(32) float sC[kBM * kLdC];
  const int pt = blockIdx.x, nPT = gridDim.x;
  const int p0 = pt * kBN;
  const int f0 = blockIdx.y * kBM;
  const int n = blockIdx.z;
  const T* x1n = x1 + (long long)n * c1 * P;
  const T* x2n = x2 + (long long)n * c2 * P;
  mainloop(w, x1n, x2n, f0, p0, F, c1, c2, P, sC);
  __syncthreads();

  // Epilogue: warp `warp` takes rows warp, warp + 4, ...; each lane two pixels.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBM; r += kWarps) {
    const int f = f0 + r;
    if (f >= F) break;  // warp-uniform
    const float bias = lfvdm::load_f32(b + f);
    const long long row = ((long long)n * F + f) * P;
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int c = lane; c < kBN; c += 32) {
      const int p = p0 + c;
      if (p < P) {
        const float v = (sC[r * kLdC + c] + lfvdm::load_f32(resid + row + p)) + bias;
        lfvdm::store_f32(y + row + p, v);
        s += v;
        q = fmaf(v, v, q);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if (lane == 0) {
      const long long at = ((long long)n * nPT + pt) * F + f;
      part1[at] = s;
      part2[at] = q;
    }
  }
}

// s[n, f] = Σ_pt part[n, pt, f], summed in pixel-tile order. Block (32, 8):
// x over channels, y strides over the tiles; the eight row sums are then
// added in a fixed order.
__global__ void __launch_bounds__(256)
    reduce_partials_kernel(const float* __restrict__ part1, const float* __restrict__ part2,
                           float* __restrict__ s1, float* __restrict__ s2, int nPT, int F) {
  __shared__ float red[2][8][33];
  const int f = blockIdx.x * 32 + threadIdx.x;
  const int n = blockIdx.y;
  float a = 0.f, q = 0.f;
  if (f < F) {
    for (int pt = threadIdx.y; pt < nPT; pt += 8) {
      const long long at = ((long long)n * nPT + pt) * F + f;
      a += part1[at];
      q += part2[at];
    }
  }
  red[0][threadIdx.y][threadIdx.x] = a;
  red[1][threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && f < F) {
    float sa = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sa += red[0][i][threadIdx.x];
      sq += red[1][i][threadIdx.x];
    }
    s1[(long long)n * F + f] = sa;
    s2[(long long)n * F + f] = sq;
  }
}

// ---------------------------------------------------------------------------
// The "bulk" route: a persistent kernel, a producer warpgroup feeding an
// mbarrier ring, mma.sync on ldmatrix fragments, the residual prefetched.
// ---------------------------------------------------------------------------

namespace bulk {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;              // output channels per tile
constexpr int kBK = 64;               // K rows per slice
constexpr int kConsumerWarps = 8;     // warps 0..7 compute, warps 8..11 copy
constexpr int kProducerWarps = 4;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kProducers = 32 * kProducerWarps;
constexpr int kThreads = kConsumers + kProducers;
constexpr int kMaxStages = 4;
constexpr int kResidBufs = 2;
constexpr int kBarBytes = 256;        // the mbarriers, at the start of shared memory
constexpr int kRedBytes = 2 * 2 * 2 * kBM * 4;  // [2 tiles][2 warp columns][Σy, Σy²][BM] f32
constexpr int kSmemMax = 232448;      // dynamic shared memory a block may use on the H100
constexpr int kWResidentMaxK = 384;   // w resident: F <= kBM and K up to this

// The launch plan; skipconv.py::plan computes the same fields.
enum Route : int { kGeneric = 0, kBulk = 1 };
struct Plan {
  int route, bm, bn, stages, w_resident, p_tiles, grid, smem;
};
constexpr int kPlanFields = 8;

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

inline int smem_bytes(int bn, int K, bool w_resident, int stages) {
  const int stage = (w_resident ? 0 : kBM * (kBK + 8) * 2) + kBK * (bn + 8) * 2;
  return kBarBytes + kRedBytes + (w_resident ? kBM * (K + 8) * 2 : 0) + stages * stage +
         kResidBufs * kBM * (bn + 8) * 2;
}

inline Plan make_plan(int dtype, int N, int c1, int c2, int F, int P, bool aligned, int sms) {
  const int K = c1 + c2;
  Plan p{kGeneric, 64, 64, 1, 0, ceil_div(P, 64), 0, 0};
  p.grid = p.p_tiles * ceil_div(F, 64) * N;
  if (dtype != lfvdm::kBFloat16 || P % 8 != 0 || c1 % 16 != 0 || c2 % 16 != 0 || !aligned)
    return p;
  const int bn = P >= 128 ? 128 : 64;
  const long long tiles = (long long)N * ceil_div(P, bn) * ceil_div(F, kBM);
  if (tiles > 0x7fffffffLL) return p;
  bool w_resident = F <= kBM && K <= kWResidentMaxK;
  int stages = kMaxStages;
  for (;;) {
    while (stages > 2 && smem_bytes(bn, K, w_resident, stages) > kSmemMax) --stages;
    if (!w_resident || smem_bytes(bn, K, w_resident, stages) <= kSmemMax) break;
    w_resident = false;
    stages = kMaxStages;
  }
  return Plan{kBulk, kBM, bn, stages, w_resident ? 1 : 0, ceil_div(P, bn),
              (int)(tiles < sms ? tiles : sms), smem_bytes(bn, K, w_resident, stages)};
}

struct Args {
  const bf16* x1;
  const bf16* x2;
  const bf16* w;
  const bf16* b;
  const bf16* resid;
  bf16* y;
  float* part1;
  float* part2;
  int c1, c2, F, P;
  int p_tiles, f_tiles, tiles, stages, w_resident;
};

// Tile t of the round-robin walk: channel tiles innermost, then pixel
// tiles, then samples.
struct Tile {
  int n, pt, f0, p0;
};
__device__ __forceinline__ Tile tile_of(int t, int p_tiles, int f_tiles, int BN) {
  const int ft = t % f_tiles, rest = t / f_tiles;
  const int pt = rest % p_tiles, n = rest / p_tiles;
  return Tile{n, pt, ft * kBM, pt * BN};
}

// Copies `rows` x `cols` bf16 from `src` (row stride `ld_src`, row r's source
// given by src_row(r)) into `dst` (row stride `ld_dst`) as 16-byte cp.async
// chunks spread over the producer threads; chunks past `rows` or `cols` up
// to `ROWS` x `COLS` are zero-filled, so no stale value reaches the tile.
template <int ROWS, int COLS, typename SrcRow>
__device__ __forceinline__ void copy_rows(bf16* dst, int ld_dst, int rows, int cols,
                                          SrcRow src_row, const bf16* dummy, int pt) {
  constexpr int kChunks = COLS / 8;
  static_assert(kProducers % kChunks == 0 && (ROWS * kChunks) % kProducers == 0, "even split");
  const int c = (pt % kChunks) * 8;
#pragma unroll
  for (int r = pt / kChunks; r < ROWS; r += kProducers / kChunks) {
    const bool valid = r < rows && c < cols;
    lfvdm::cp_async16(dst + r * ld_dst + c, valid ? src_row(r) + c : dummy, valid);
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1) skip_conv_stats_bulk_kernel(const Args a) {
  constexpr int kWarpsN = 2, kWN = BN / kWarpsN;  // 4 x 2 warps, 32 rows each
  constexpr int kNI = kWN / 8;                   // n8 accumulator tiles per warp
  constexpr int kLdW = kBK + 8, kLdX = BN + 8, kLdR = BN + 8;  // bf16 per staged row
  static_assert(kNI >= 2 && kNI % 2 == 0, "B fragments come in pairs of n8 tiles");
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = a.c1 + a.c2, F = a.F, P = a.P, S = a.stages;
  const bool w_res = a.w_resident != 0;
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem);  // slice s has landed
  uint64_t* const empty = full + kMaxStages;                  // slice s has been read
  uint64_t* const rfull = empty + kMaxStages;                 // residual buffer landed
  uint64_t* const rempty = rfull + kResidBufs;                // y of the buffer stored
  uint64_t* const wfull = rempty + kResidBufs;                // resident w landed
  float* const red = reinterpret_cast<float*>(smem + kBarBytes);
  bf16* const s_wres = reinterpret_cast<bf16*>(smem + kBarBytes + kRedBytes);
  const int ld_wres = K + 8;
  bf16* const s_stages = s_wres + (w_res ? kBM * ld_wres : 0);
  const int stage_w = w_res ? 0 : kBM * kLdW;  // bf16 of w per stage
  const int stage = stage_w + kBK * kLdX;
  bf16* const s_res = s_stages + S * stage;    // kResidBufs x (kBM, kLdR)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      lfvdm::mbar_init(&full[s], kProducers);  // one cp.async arrival per producer thread
      lfvdm::mbar_init(&empty[s], kConsumerWarps);
    }
    for (int r = 0; r < kResidBufs; ++r) {
      lfvdm::mbar_init(&rfull[r], kProducers);
      lfvdm::mbar_init(&rempty[r], kConsumerWarps);
    }
    lfvdm::mbar_init(wfull, 1);
    lfvdm::mbar_init_fence();
  }
  __syncthreads();
  const int nK = (K + kBK - 1) / kBK;

  if (warp >= kConsumerWarps) {
    // Producers. The resident w goes in once, by bulk copies of whole rows
    // (few and long); the ring's slices and the residual go by 16-byte
    // cp.async, each thread's completing on the stage's mbarrier.
    const int pt = threadIdx.x - kConsumers;
    if (w_res && pt < 32) {
      const int rows = F < kBM ? F : kBM;
      if (pt == 0) lfvdm::mbar_arrive_expect_tx(wfull, rows * K * 2);
      __syncwarp();
      for (int r = pt; r < rows; r += 32)
        lfvdm::bulk_load(s_wres + r * ld_wres, a.w + (long long)r * K, K * 2, wfull);
    }
    int it = 0, j = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++j) {
      const Tile tl = tile_of(t, a.p_tiles, a.f_tiles, BN);
      const int rows = min(kBM, F - tl.f0), cols = min(BN, P - tl.p0);
      const int rb = j % kResidBufs;
      lfvdm::mbar_wait(&rempty[rb], ((j / kResidBufs) & 1) ^ 1);
      const bf16* res = a.resid + ((long long)tl.n * F + tl.f0) * P + tl.p0;
      copy_rows<kBM, BN>(s_res + rb * kBM * kLdR, kLdR, rows, cols,
                         [&](int r) { return res + (long long)r * P; }, a.resid, pt);
      lfvdm::cp_async_mbar_arrive(&rfull[rb]);
      const bf16* x1n = a.x1 + (long long)tl.n * a.c1 * P + tl.p0;
      const bf16* x2n = a.x2 + (long long)tl.n * a.c2 * P + tl.p0;
      const bf16* wt = a.w + (long long)tl.f0 * K;
      for (int kt = 0; kt < nK; ++kt, ++it) {
        const int s = it % S;
        lfvdm::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        const int k0 = kt * kBK, kw = min(kBK, K - k0);
        bf16* const sw = s_stages + s * stage;
        if (!w_res)
          copy_rows<kBM, kBK>(sw, kLdW, rows, kw,
                              [&](int r) { return wt + (long long)r * K + k0; }, a.w, pt);
        copy_rows<kBK, BN>(sw + stage_w, kLdX, kw, cols, [&](int r) {
          const int k = k0 + r;  // a slice may straddle the x1 / x2 boundary
          return k < a.c1 ? x1n + (long long)k * P : x2n + (long long)(k - a.c1) * P;
        }, a.x1, pt);
        lfvdm::cp_async_mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // Consumers: warp (wm, wn) owns rows [wm, wm + 32) and columns [wn, wn +
  // kWN) of the tile as 2 x kNI accumulator tiles of 16 x 8. Lane (g, tq) =
  // (lane / 4, lane % 4) holds rows g and g + 8, columns 2 tq and 2 tq + 1.
  const int wn_i = warp % kWarpsN;
  const int wm = (warp / kWarpsN) * 32, wn = wn_i * kWN;
  const int g = lane >> 2, tq = lane & 3;
  if (w_res) lfvdm::mbar_wait(wfull, 0);
  int it = 0, j = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++j) {
    const Tile tl = tile_of(t, a.p_tiles, a.f_tiles, BN);
    float acc[2][kNI][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < kNI; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jj][e] = 0.f;

    for (int kt = 0; kt < nK; ++kt, ++it) {
      const int s = it % S;
      lfvdm::mbar_wait(&full[s], (it / S) & 1);
      const int k0 = kt * kBK, kw = min(kBK, K - k0);
      const bf16* sa = w_res ? s_wres + k0 : s_stages + s * stage;
      const int lda = w_res ? ld_wres : kLdW;
      const bf16* sb = s_stages + s * stage + stage_w;
      // ldmatrix rows. A: rows wm + lane % 16, k + 8 (lane / 16). B (trans):
      // k + (lane % 8) + 8 ((lane / 8) % 2), pixels wn + 8 (lane / 16).
      const bf16* arow = sa + (wm + (lane & 15)) * lda + ((lane >> 4) << 3);
      const bf16* brow =
          sb + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kLdX + wn + ((lane >> 4) << 3);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        if (kk * 16 < kw) {  // the K tail: no work on the zero-filled rows
          unsigned af[2][4];
          lfvdm::ldmatrix_x4(af[0], arow + kk * 16);
          lfvdm::ldmatrix_x4(af[1], arow + 16 * lda + kk * 16);
#pragma unroll
          for (int jp = 0; jp < kNI / 2; ++jp) {
            unsigned bq[4];
            lfvdm::ldmatrix_x4_trans(bq, brow + kk * 16 * kLdX + jp * 16);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              lfvdm::mma_bf16(acc[i][2 * jp], af[i], bq[0], bq[1]);
              lfvdm::mma_bf16(acc[i][2 * jp + 1], af[i], bq[2], bq[3]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) lfvdm::mbar_arrive(&empty[s]);
    }

    // Epilogue: y = (acc + resid) + bias in f32, over the residual rows.
    const int rb = j % kResidBufs;
    lfvdm::mbar_wait(&rfull[rb], (j / kResidBufs) & 1);
    bf16* const sr = s_res + rb * kBM * kLdR;
    float* const rd = red + (j & 1) * kWarpsN * 2 * kBM;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + 16 * i + g + 8 * h;
        const int f = tl.f0 + r;
        const float bias = f < F ? __bfloat162float(a.b[f]) : 0.f;
        float s = 0.f, q = 0.f;
#pragma unroll
        for (int jj = 0; jj < kNI; ++jj) {
          const int c = wn + 8 * jj + 2 * tq;
          unsigned* cell = reinterpret_cast<unsigned*>(sr + r * kLdR + c);
          const float2 rr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cell));
          const float v0 = (acc[i][jj][2 * h] + rr.x) + bias;
          const float v1 = (acc[i][jj][2 * h + 1] + rr.y) + bias;
          *cell = lfvdm::pack_bf16(v0, v1);
          if (tl.p0 + c < P) {  // P is even: both pixels or neither
            s += v0 + v1;
            q = fmaf(v0, v0, fmaf(v1, v1, q));
          }
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        q += __shfl_xor_sync(0xffffffffu, q, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        q += __shfl_xor_sync(0xffffffffu, q, 2);
        if (tq == 0) {
          rd[(wn_i * 2) * kBM + r] = s;
          rd[(wn_i * 2 + 1) * kBM + r] = q;
        }
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");  // consumers only
    const int rows = min(kBM, F - tl.f0), cols = min(BN, P - tl.p0);
    if (const int r = threadIdx.x; r < rows) {
      const long long at = ((long long)tl.n * a.p_tiles + tl.pt) * F + tl.f0 + r;
      a.part1[at] = rd[r] + rd[2 * kBM + r];
      a.part2[at] = rd[kBM + r] + rd[3 * kBM + r];
    }
    // y leaves in 16-byte chunks, a warp's 32 lanes on consecutive chunks.
    constexpr int kChunks = BN / 8;
    const int c = (threadIdx.x % kChunks) * 8;
    bf16* const yt = a.y + ((long long)tl.n * F + tl.f0) * P + tl.p0;
    if (c < cols)
      for (int r = threadIdx.x / kChunks; r < rows; r += kConsumers / kChunks)
        *reinterpret_cast<uint4*>(yt + (long long)r * P + c) =
            *reinterpret_cast<const uint4*>(sr + r * kLdR + c);
    __syncwarp();
    if (lane == 0) lfvdm::mbar_arrive(&rempty[rb]);
  }
}

template <int BN>
int launch(const Args& a, const Plan& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(skip_conv_stats_bulk_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  skip_conv_stats_bulk_kernel<BN><<<p.grid, kThreads, p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace bulk

int launch_generic(int dtype, const void* x1, const void* x2, const void* w, const void* b,
                   const void* resid, void* y, float* part1, float* part2, int N, int c1, int c2,
                   int F, int P, int p_tiles, cudaStream_t stream) {
  const dim3 grid(p_tiles, (F + kBM - 1) / kBM, N);
  if (dtype == lfvdm::kFloat32) {
    skip_conv_stats_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x1), static_cast<const float*>(x2),
        static_cast<const float*>(w), static_cast<const float*>(b),
        static_cast<const float*>(resid), static_cast<float*>(y), part1, part2, N, c1, c2, F, P);
  } else {
    using bf16 = __nv_bfloat16;
    skip_conv_stats_kernel<bf16><<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(x1), static_cast<const bf16*>(x2), static_cast<const bf16*>(w),
        static_cast<const bf16*>(b), static_cast<const bf16*>(resid), static_cast<bf16*>(y),
        part1, part2, N, c1, c2, F, P);
  }
  return (int)cudaGetLastError();
}

int launch_bulk(const void* x1, const void* x2, const void* w, const void* b, const void* resid,
                void* y, float* part1, float* part2, int N, int c1, int c2, int F, int P,
                const bulk::Plan& p, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int f_tiles = (F + p.bm - 1) / p.bm;
  const bulk::Args a{static_cast<const bf16*>(x1), static_cast<const bf16*>(x2),
                     static_cast<const bf16*>(w), static_cast<const bf16*>(b),
                     static_cast<const bf16*>(resid), static_cast<bf16*>(y), part1, part2,
                     c1, c2, F, P, p.p_tiles, f_tiles, N * p.p_tiles * f_tiles, p.stages,
                     p.w_resident};
  if (p.bn == 128) return bulk::launch<128>(a, p, stream);
  if (p.bn == 64) return bulk::launch<64>(a, p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The launch plan for these sizes on a card with `sms` SMs: route, BM, BN,
// stages, w resident, pixel tiles, grid and dynamic shared-memory bytes, in
// that order, into out[0..7]. `aligned`: x1, x2, w, resid and y all start on
// 16-byte boundaries. Returns a cudaError_t.
extern "C" int lfvdm_skip_conv_stats_plan(int dtype, int N, int c1, int c2, int F, int P,
                                          int aligned, int sms, int* out) {
  if (N < 1 || c1 < 1 || c2 < 1 || F < 1 || P < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  const bulk::Plan p = bulk::make_plan(dtype, N, c1, c2, F, P, aligned != 0, sms);
  const int fields[bulk::kPlanFields] = {p.route, p.bm, p.bn, p.stages, p.w_resident,
                                         p.p_tiles, p.grid, p.smem};
  for (int i = 0; i < bulk::kPlanFields; ++i) out[i] = fields[i];
  return 0;
}

// Returns a cudaError_t: 0 when both launches were accepted. `plan` is the
// caller's launch plan (8 ints, as lfvdm_skip_conv_stats_plan gives them);
// a plan other than this library's own for these inputs on this card is
// refused. ``partial`` holds 2 * N * plan.p_tiles * F floats.
extern "C" int lfvdm_skip_conv_stats(int dtype, const void* x1, const void* x2, const void* w,
                                     const void* b, const void* resid, void* y, void* partial,
                                     void* s1, void* s2, int N, int c1, int c2, int F, int P,
                                     const int* plan, void* stream) {
  if (N < 1 || N > 65535 || c1 < 1 || c2 < 1 || F < 1 || P < 1 || (F + kBM - 1) / kBM > 65535 ||
      (dtype != lfvdm::kFloat32 && dtype != lfvdm::kBFloat16))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  using lfvdm::aligned16;
  const bool aligned = aligned16(x1) && aligned16(x2) && aligned16(w) && aligned16(resid) &&
                       aligned16(y);
  const bulk::Plan p = bulk::make_plan(dtype, N, c1, c2, F, P, aligned, sms);
  const int fields[bulk::kPlanFields] = {p.route, p.bm, p.bn, p.stages, p.w_resident,
                                         p.p_tiles, p.grid, p.smem};
  for (int i = 0; i < bulk::kPlanFields; ++i)
    if (plan[i] != fields[i]) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part1 = static_cast<float*>(partial);
  float* part2 = part1 + (long long)N * p.p_tiles * F;
  const int rc = p.route == bulk::kBulk
                     ? launch_bulk(x1, x2, w, b, resid, y, part1, part2, N, c1, c2, F, P, p, s)
                     : launch_generic(dtype, x1, x2, w, b, resid, y, part1, part2, N, c1, c2, F,
                                      P, p.p_tiles, s);
  if (rc != 0) return rc;
  const dim3 rgrid((F + 31) / 32, N);
  reduce_partials_kernel<<<rgrid, dim3(32, 8), 0, s>>>(part1, part2, static_cast<float*>(s1),
                                                        static_cast<float*>(s2), p.p_tiles, F);
  return (int)cudaGetLastError();
}
