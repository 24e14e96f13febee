// Up-path skip projection: a 1x1 conv over a two-part channel concat, plus
// the residual add, plus the output's per-sample channel statistics.
//
// Replaces lfvdm_tpu/ops/skipconv.py::_kernel (the Pallas kernel behind
// skip_conv_stats, launched by _fwd_pallas). Plain version and wrapper:
// lfvdm_tpu_torch/ops/skipconv.py.
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
//   partial (2, N, nPT, F) f32 scratch: per-pixel-tile sums (nPT = ceil(P/64))
//
// Per sample the op is a GEMM (F x K) · (K x P) with K = c1 + c2, and a
// fused epilogue. A block owns a tile of output channels by 64 pixels of one
// sample, so a tile never straddles two samples, and walks K in 32-deep
// slices, staging the weight slice and the activation slice in shared memory.
// Each activation row is read in place from x1 or x2, so the concat is never
// built. The epilogue adds the residual and the bias in f32, stores y, and
// reduces each row's Σy and Σy² over the tile's pixels into one partial per
// (sample, pixel tile, channel). A second small kernel sums the partials
// over the pixel tiles in a fixed order, so the statistics are deterministic
// (no atomics).
//
// Two main loops:
//  * bf16 with P, c1 and c2 multiples of 8 and 16-byte aligned pointers (every
//    flagship shape): 128-channel tiles, so x is read once wherever F <= 128
//    (the 64 x 64 and 128 x 128 levels, which carry most of the bytes);
//    16-byte cp.async copies into two shared stages, so the next slice loads
//    while the tensor cores (WMMA 16x16x16, f32 accumulation) work on this
//    one; a 16-byte epilogue.
//  * otherwise (f32, or odd widths): 64-channel tiles, element-wise loads,
//    one stage; bf16 on WMMA, f32 on plain FMAs.
//
// Bound on the H100: at the flagship shapes (K <= 1024, F <= 512) the bf16
// work is 2·M·K·F flops against (x1 + x2 + resid + y) bytes, under the
// card's operations-per-byte balance, so the bound is bytes. The fast loop
// reads x from device memory once per 128-channel tile (once at F <= 128, up
// to four times at F = 512, where the activations are smallest) and writes y
// once; the partial sums add 8 bytes per (sample, pixel tile, channel), about
// 3% of the traffic at 128 x 128. TMA, wgmma and a persistent grid are the
// next steps.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kBM = 64;   // output channels per block
constexpr int kBN = 64;   // pixels per block (the wrapper's TILE_P)
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

// ---------------------------------------------------------------------------
// The bf16 fast path: 128-channel tiles, cp.async double buffering.
// ---------------------------------------------------------------------------

constexpr int kFM = 128;                 // output channels per block
constexpr int kFThreads = 256;           // 8 warps: 4 (channels) x 2 (pixels)
constexpr int kFLdA = kBK + 8;           // bf16 elements per staged w row
constexpr int kFLdB = kBN + 8;           // bf16 elements per staged x row
constexpr int kFStageA = kFM * kFLdA;    // elements
constexpr int kFStageB = kBK * kFLdB;
constexpr int kFSmemStages = 2 * (kFStageA + kFStageB) * 2;  // bytes
constexpr int kFSmemC = kFM * kLdC * 4;                       // bytes
constexpr int kFSmem = kFSmemStages > kFSmemC ? kFSmemStages : kFSmemC;

// Issue the copies of slice k0 into stage (sA, sB): 2 w chunks and 1 x chunk
// of 16 bytes per thread. Chunks past F, K or P are zero-filled.
__device__ __forceinline__ void load_stage_async(__nv_bfloat16* sA, __nv_bfloat16* sB,
                                                 const __nv_bfloat16* __restrict__ w,
                                                 const __nv_bfloat16* __restrict__ x1n,
                                                 const __nv_bfloat16* __restrict__ x2n, int f0,
                                                 int k0, int p0, int F, int c1, int c2, int P) {
  const int K = c1 + c2;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = tid + i * kFThreads;  // 128 rows x 4 chunks
    const int r = chunk / 4, c = (chunk % 4) * 8;
    const int f = f0 + r, k = k0 + c;
    const bool valid = f < F && k < K;
    lfvdm::cp_async16(sA + r * kFLdA + c, valid ? w + (long long)f * K + k : w, valid);
  }
  {
    const int r = tid / 8, c = (tid % 8) * 8;  // 32 rows x 8 chunks
    const int k = k0 + r, p = p0 + c;
    const bool valid = k < K && p < P;
    const __nv_bfloat16* src = x1n;
    if (valid) src = k < c1 ? x1n + (long long)k * P + p : x2n + (long long)(k - c1) * P + p;
    lfvdm::cp_async16(sB + r * kFLdB + c, src, valid);
  }
}

__global__ void __launch_bounds__(kFThreads, 2)
    skip_conv_stats_fast_kernel(const __nv_bfloat16* __restrict__ x1,
                                const __nv_bfloat16* __restrict__ x2,
                                const __nv_bfloat16* __restrict__ w,
                                const __nv_bfloat16* __restrict__ b,
                                const __nv_bfloat16* __restrict__ resid,
                                __nv_bfloat16* __restrict__ y, float* __restrict__ part1,
                                float* __restrict__ part2, int c1, int c2, int F, int P) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[kFSmem];
  // Stage s: w slice at stages + s * kFStageA, x slice at stages + 2 * kFStageA
  // + s * kFStageB. After the main loop the same bytes hold the f32 tile.
  __nv_bfloat16* const stages = reinterpret_cast<__nv_bfloat16*>(smem);
  float* const sC = reinterpret_cast<float*>(smem);

  const int pt = blockIdx.x, nPT = gridDim.x;
  const int p0 = pt * kBN;
  const int f0 = blockIdx.y * kFM;
  const int n = blockIdx.z;
  const __nv_bfloat16* x1n = x1 + (long long)n * c1 * P;
  const __nv_bfloat16* x2n = x2 + (long long)n * c2 * P;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int K = c1 + c2;
  const int nK = (K + kBK - 1) / kBK;
  load_stage_async(stages, stages + 2 * kFStageA, w, x1n, x2n, f0, 0, p0, F, c1, c2, P);
  lfvdm::cp_async_commit();
  for (int kt = 0; kt < nK; ++kt) {
    const int cur = kt & 1, nxt = cur ^ 1;
    if (kt + 1 < nK) {
      load_stage_async(stages + nxt * kFStageA, stages + 2 * kFStageA + nxt * kFStageB, w, x1n,
                       x2n, f0, (kt + 1) * kBK, p0, F, c1, c2, P);
      lfvdm::cp_async_commit();
      lfvdm::cp_async_wait<1>();  // this slice has landed; the next one is in flight
    } else {
      lfvdm::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* sA = stages + cur * kFStageA;
    const __nv_bfloat16* sB = stages + 2 * kFStageA + cur * kFStageB;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sA + (wm + 16 * i) * kFLdA + kk, kFLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bb[j], sB + kk * kFLdB + wn + 16 * j, kFLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bb[j], acc[i][j]);
    }
    __syncthreads();  // readers done before this stage is refilled (or reused as sC)
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wm + 16 * i) * kLdC + wn + 16 * j, acc[i][j], kLdC,
                              wmma::mem_row_major);
  __syncthreads();

  // Epilogue: 8 lanes per row, 8 pixels (16 bytes) per lane, 4 rows per warp
  // at a time; each warp owns 16 rows.
  const int sub = lane / 8, chunk = lane % 8;
  const int p = p0 + chunk * 8;
  const bool p_in = p < P;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int r = warp * 16 + it * 4 + sub;
    const int f = f0 + r;
    float s = 0.f, q = 0.f;
    if (f < F && p_in) {
      const float4 ca = *reinterpret_cast<const float4*>(sC + r * kLdC + chunk * 8);
      const float4 cb = *reinterpret_cast<const float4*>(sC + r * kLdC + chunk * 8 + 4);
      const float acc8[8] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
      const long long at = ((long long)n * F + f) * P + p;
      const uint4 rv = *reinterpret_cast<const uint4*>(resid + at);
      const __nv_bfloat16* r8 = reinterpret_cast<const __nv_bfloat16*>(&rv);
      const float bias = __bfloat162float(b[f]);
      uint4 out;
      __nv_bfloat16* o8 = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float v = (acc8[e] + __bfloat162float(r8[e])) + bias;
        o8[e] = __float2bfloat16(v);
        s += v;
        q = fmaf(v, v, q);
      }
      *reinterpret_cast<uint4*>(y + at) = out;
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if (chunk == 0 && f < F) {
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

template <typename T>
int launch(const void* x1, const void* x2, const void* w, const void* b, const void* resid,
           void* y, float* partial, float* s1, float* s2, int N, int c1, int c2, int F, int P,
           int nPT, cudaStream_t stream) {
  float* part1 = partial;
  float* part2 = partial + (long long)N * nPT * F;
  using lfvdm::aligned16;
  const bool fast = std::is_same<T, __nv_bfloat16>::value && P % 8 == 0 && c1 % 8 == 0 &&
                    c2 % 8 == 0 && aligned16(x1) && aligned16(x2) && aligned16(w) &&
                    aligned16(resid) && aligned16(y);
  if (fast) {
    const dim3 grid(nPT, (F + kFM - 1) / kFM, N);
    skip_conv_stats_fast_kernel<<<grid, kFThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x1), static_cast<const __nv_bfloat16*>(x2),
        static_cast<const __nv_bfloat16*>(w), static_cast<const __nv_bfloat16*>(b),
        static_cast<const __nv_bfloat16*>(resid), static_cast<__nv_bfloat16*>(y), part1, part2,
        c1, c2, F, P);
  } else {
    const dim3 grid(nPT, (F + kBM - 1) / kBM, N);
    skip_conv_stats_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x1), static_cast<const T*>(x2), static_cast<const T*>(w),
        static_cast<const T*>(b), static_cast<const T*>(resid), static_cast<T*>(y), part1, part2,
        N, c1, c2, F, P);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 rgrid((F + 31) / 32, N);
  reduce_partials_kernel<<<rgrid, dim3(32, 8), 0, stream>>>(part1, part2, s1, s2, nPT, F);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 when both launches were accepted. ``partial``
// holds 2 * N * partial_tiles * F floats; partial_tiles must be ceil(P / 64).
extern "C" int lfvdm_skip_conv_stats(int dtype, const void* x1, const void* x2, const void* w,
                                     const void* b, const void* resid, void* y, void* partial,
                                     void* s1, void* s2, int N, int c1, int c2, int F, int P,
                                     int partial_tiles, void* stream) {
  if (N < 1 || N > 65535 || c1 < 1 || c2 < 1 || F < 1 || P < 1 ||
      partial_tiles != (P + kBN - 1) / kBN || (F + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* o1 = static_cast<float*>(s1);
  float* o2 = static_cast<float*>(s2);
  if (dtype == lfvdm::kFloat32)
    return launch<float>(x1, x2, w, b, resid, y, part, o1, o2, N, c1, c2, F, P, partial_tiles, s);
  if (dtype == lfvdm::kBFloat16)
    return launch<__nv_bfloat16>(x1, x2, w, b, resid, y, part, o1, o2, N, c1, c2, F, P,
                                 partial_tiles, s);
  return (int)cudaErrorInvalidValue;
}
