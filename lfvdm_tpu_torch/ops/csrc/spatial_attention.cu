// Multi-head softmax(q kᵀ) v over the pixel tokens of each (batch, frame, head).
//
// Replaces lfvdm_tpu/ops/attention.py::_spatial_kernel (the Pallas kernel
// behind spatial_attention, launched by _spatial_pallas). Plain version and
// wrapper: lfvdm_tpu_torch/ops/attention.py, whose _spatial_route picks one
// of the two kernels below by dtype, width and alignment.
//
// Layout (row-major): q, k, v, out (N, D, F) with N = B·T·H, D tokens, F
// features per head (F minor); q arrives pre-scaled by F^-1/2. No mask.
//
// The function is the TPU kernel's: f32 logits and softmax, the normalised
// weights rounded to the storage type before attn @ v, f32 accumulation.
// Both kernels are flash-attention forwards in two passes over 64-key tiles,
// so the (D, D) logits never reach device memory. Pass 1 finds each query
// row's max and sum of exponentials online (f32); pass 2 recomputes the
// logits, forms the normalised weights, rounds them exactly where the
// reference does and accumulates attn @ v in f32. The second q kᵀ costs the
// extra pass; in exchange kernel and reference round the same values (a
// one-pass online softmax normalises last, so it cannot).
//
// Bound on the H100: bytes. The work is 4·N·D²·F flops against q, k, v and
// out, 8·N·D·F bytes in bf16: D/2 flops per byte, at most 128 at the
// flagship shapes (N = 160, D = 64..256, F = 96..128), under the card's ~295
// bf16 flops per byte. In f32 (no tensor cores) the bound is operations.
//
// * lfvdm_spatial_attention_mma — bf16, F a multiple of 16 up to 128, every
//   pointer 16-byte aligned (the flagship path). One block of 4 warps per
//   (n, 64-query tile), each warp owning 16 query rows: 640 blocks at ds 8,
//   160 at ds 16. Three blocks fit on an SM at F <= 96 (66.5 KB of shared
//   memory each at F = 96, at most 168 registers a thread), two at F = 112
//   and 128 (87 KB at F = 128). Q, K and V stay bf16 in shared memory, rows
//   padded by 16 bytes so that ldmatrix is free of bank conflicts. 16-byte
//   cp.async copies fill a two-stage ring of 64-key tiles while the tensor
//   cores work on the previous tile; rows past D are zero-filled by the
//   copy. q kᵀ is mma.sync m16n8k16 (bf16 in, f32 out) on ldmatrix
//   fragments, the warp's Q fragments held in registers. Pass 2 turns the
//   logit accumulators into the bf16 A fragments of attn @ v in registers
//   (the C layout of two n8 tiles is the A layout of one k16 slice) and
//   takes V through ldmatrix.trans. Pass 2 walks the key tiles backwards,
//   so it starts on pass 1's last logits (at D <= 64 q kᵀ runs once) and
//   then on the K tile pass 1 left in the ring: at D <= 128 K is copied
//   once. The D/64 blocks of one problem share their k and v reads through
//   the 50 MB L2, which holds a whole flagship launch (<= 31.5 MB), so
//   device memory sees q, k, v and out about once. What holds it above its
//   bound is inside the SM: each warp reads every K and V tile from shared
//   memory through ldmatrix, and the second q kᵀ and the exponentials of
//   both passes are the price of rounding where the reference rounds.
//   wgmma, which reads B from shared memory directly, is the next step.
// * lfvdm_spatial_attention — f32, bf16 at other widths or alignments, and
//   any F above 128: the first version, plain FMAs on f32 tiles in shared
//   memory. 256 threads give each query row four threads, each holding 16
//   logits and up to 32 output columns in registers. Past F = 128 the logits
//   sum over 128-wide feature chunks of Q and K staged in turn, and a third
//   grid dimension gives each block 128 columns of v and out, so shared
//   memory stays at most 113 KB for any F. It runs far above its bound.

#include <math.h>

#include <climits>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kLanesPerRow = kThreads / kBlockQ;   // 4
constexpr int kColsS = kBlockK / kLanesPerRow;     // 16 logits per thread
constexpr int kChunkF = 128;                       // features staged at a time
constexpr int kColsO = kChunkF / kLanesPerRow;     // 32 outputs per thread

// Q, K and V chunks of (64, min(F, 128) + 1) floats, then the weights.
__host__ __device__ constexpr int smem_floats(int F) {
  return 3 * kBlockQ * ((F < kChunkF ? F : kChunkF) + 1) + kBlockQ * (kBlockK + 1);
}

// Any F: the logits sum over 128-wide feature chunks of q and k staged in
// turn, and blockIdx.z picks the 128 output columns (of v and out) this block
// computes. At F <= 128 (one chunk) Q is staged once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    spatial_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ out, int D, int F) {
  extern __shared__ float smem[];
  const int ld = (F < kChunkF ? F : kChunkF) + 1;  // padded rows: 8 rows of a warp hit 8 banks
  float* sQ = smem;
  float* sK = sQ + kBlockQ * ld;
  float* sV = sK + kBlockK * ld;
  float* sP = sV + kBlockK * ld;  // (kBlockQ, kBlockK + 1)

  const int tid = threadIdx.x;
  const int row = tid / kLanesPerRow;
  const int lane = tid % kLanesPerRow;
  const long long base = (long long)blockIdx.x * D * F;
  const int q0 = blockIdx.y * kBlockQ;
  const int c0 = blockIdx.z * kChunkF;                                  // output columns
  const int wo = F - c0 < kChunkF ? F - c0 : kChunkF;
  const bool one_chunk = F <= kChunkF;

  // Rows [r0, r0 + 64) and columns [f0, f0 + w) of one (D, F) matrix; zeros
  // past D.
  auto stage = [&](float* dst, const T* src, int r0, int f0, int w) {
    for (int i = tid; i < kBlockK * w; i += kThreads) {
      const int r = i / w, f = i - r * w;
      dst[r * ld + f] =
          r0 + r < D ? lfvdm::load_f32(src + base + (long long)(r0 + r) * F + f0 + f) : 0.f;
    }
  };
  if (one_chunk) stage(sQ, q, q0, 0, F);

  // This thread's 16 logits of tile k0: columns lane + 4j; -inf past D.
  // With ``with_v`` it also stages the tile's V columns [c0, c0 + wo).
  auto logits = [&](int k0, float* s, bool with_v) {
#pragma unroll
    for (int j = 0; j < kColsS; ++j) s[j] = 0.f;
    for (int f0 = 0; f0 < F; f0 += kChunkF) {
      const int w = F - f0 < kChunkF ? F - f0 : kChunkF;
      __syncthreads();  // the previous chunk's (and tile's) readers are done
      if (!one_chunk) stage(sQ, q, q0, f0, w);
      stage(sK, k, k0, f0, w);
      if (with_v && f0 == 0) stage(sV, v, k0, c0, wo);
      __syncthreads();
      for (int f = 0; f < w; ++f) {
        const float qf = sQ[row * ld + f];
#pragma unroll
        for (int j = 0; j < kColsS; ++j)
          s[j] = fmaf(qf, sK[(lane + kLanesPerRow * j) * ld + f], s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kColsS; ++j)
      if (k0 + lane + kLanesPerRow * j >= D) s[j] = -INFINITY;
  };

  // Pass 1: the row max and the row sum of exp(logit - max), online over
  // the key tiles. The four threads of a row are adjacent lanes of a warp.
  float row_max = -INFINITY;
  float row_sum = 0.f;
  float s[kColsS];
  for (int k0 = 0; k0 < D; k0 += kBlockK) {
    logits(k0, s, false);
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kColsS; ++j) tile_max = fmaxf(tile_max, s[j]);
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float new_max = fmaxf(row_max, tile_max);  // finite: key k0 < D exists
    float tile_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kColsS; ++j) tile_sum += expf(s[j] - new_max);
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 1);
    tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, 2);
    row_sum = row_sum * expf(row_max - new_max) + tile_sum;  // expf(-inf) = 0
    row_max = new_max;
  }

  // Pass 2: the normalised weights, rounded to the storage type as the
  // reference rounds them, times V.
  float o[kColsO];
#pragma unroll
  for (int i = 0; i < kColsO; ++i) o[i] = 0.f;
  for (int k0 = 0; k0 < D; k0 += kBlockK) {
    logits(k0, s, true);
#pragma unroll
    for (int j = 0; j < kColsS; ++j)
      sP[row * (kBlockK + 1) + lane + kLanesPerRow * j] =
          lfvdm::round_through(expf(s[j] - row_max) / row_sum, q);
    __syncwarp();  // a row's weights are written and read by the same warp
    for (int c = 0; c < kBlockK; ++c) {
      const float p = sP[row * (kBlockK + 1) + c];
#pragma unroll
      for (int i = 0; i < kColsO; ++i) {
        const int f = lane + kLanesPerRow * i;
        if (f < wo) o[i] = fmaf(p, sV[c * ld + f], o[i]);
      }
    }
  }

  if (q0 + row < D) {
    T* dst = out + base + (long long)(q0 + row) * F + c0;
#pragma unroll
    for (int i = 0; i < kColsO; ++i) {
      const int f = lane + kLanesPerRow * i;
      if (f < wo) lfvdm::store_f32(dst + f, o[i]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int N, int D, int F,
           cudaStream_t stream) {
  const int smem = smem_floats(F) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(spatial_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N, (D + kBlockQ - 1) / kBlockQ, (F + kChunkF - 1) / kChunkF);
  spatial_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), D, F);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core kernel: mma.sync m16n8k16, ldmatrix, cp.async ring.
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kKeys = 64;  // keys per staged tile
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kWarps = 4;                // each owns 16 query rows
constexpr int kThreads = 32 * kWarps;
constexpr int kQRows = 16 * kWarps;      // query rows per block
static_assert(kQRows == kKeys, "the Q tile and the K and V tiles share one shape");
constexpr int kSmemPerSM = 232448;       // bytes a block may use on the H100
constexpr int kSmemReserved = 1024;      // bytes the system takes per block

template <int F>
struct Shape {
  static constexpr int kLd = F + 8;          // bf16 per staged row: 16 bytes of padding
  static constexpr int kTile = kKeys * kLd;  // bf16 per staged tile
  static constexpr int kChunks = F / 8;      // 16-byte chunks per row
  // Q, then two K stages, then two V stages.
  static constexpr int kSmemBytes = 5 * kTile * 2;
  // Three blocks per SM where their shared memory fits (F <= 96: 66.5 KB
  // each at F = 96), else two; the register cap follows (168 or 255).
  static constexpr int kMinBlocks = 3 * (kSmemBytes + kSmemReserved) <= kSmemPerSM ? 3 : 2;
};

using lfvdm::ldmatrix_x4;        // csrc/common.cuh
using lfvdm::ldmatrix_x4_trans;
using lfvdm::mma_bf16;
using lfvdm::pack_bf16;

// Copy rows [r0, r0 + 64) of one (D, F) matrix into a staged tile; rows past
// D are zero-filled.
template <int F>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                          int r0, int D) {
  constexpr int kChunks = F / 8, kLd = F + 8;
#pragma unroll
  for (int i = 0; i < kKeys * kChunks / kThreads; ++i) {  // F / 16 chunks per thread
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool in = r0 + r < D;
    lfvdm::cp_async16(dst + r * kLd + col, in ? src + (long long)(r0 + r) * F + col : src, in);
  }
}

// The warp's (16, 64) logits against one staged key tile, as eight n8
// accumulator tiles; keys past D get -inf. Lane (g, t) = (lane / 4, lane % 4)
// holds rows g and g + 8, keys 8j + 2t and 8j + 2t + 1 of tile j.
template <int F>
__device__ __forceinline__ void logits(float (&s)[8][4], const unsigned (&qa)[F / 16][4],
                                       const __nv_bfloat16* tK, int k0, int D, int lane) {
  constexpr int kLd = F + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // ldmatrix rows: keys 16 jp + (lane % 8) + 8 (lane / 16), features
  // + 8 ((lane / 8) % 2).
  const __nv_bfloat16* row =
      tK + ((lane & 7) + ((lane >> 4) << 3)) * kLd + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int kk = 0; kk < F / 16; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      unsigned b[4];
      ldmatrix_x4(b, row + jp * 16 * kLd + kk * 16);
      mma_bf16(s[2 * jp], qa[kk], b[0], b[1]);
      mma_bf16(s[2 * jp + 1], qa[kk], b[2], b[3]);
    }
  }
  if (k0 + kKeys > D) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + 2 * (lane & 3) + (e & 1) >= D) s[j][e] = -INFINITY;
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads, Shape<F>::kMinBlocks)
    spatial_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 __nv_bfloat16* __restrict__ out, int D, int q_tiles) {
  using S = Shape<F>;
  constexpr int kLd = S::kLd;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* const sQ = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* const sK = sQ + S::kTile;      // stages 0, 1
  __nv_bfloat16* const sV = sK + 2 * S::kTile;  // stages 0, 1

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x - n * q_tiles) * kQRows;
  const long long base = (long long)n * D * F;
  const __nv_bfloat16* const qn = q + base;
  const __nv_bfloat16* const kn = k + base;
  const __nv_bfloat16* const vn = v + base;
  const int nT = (D + kKeys - 1) / kKeys;
  const int steps = 2 * nT;

  // Step s < nT is pass 1 on key tile s; step s >= nT is pass 2 on key tile
  // 2 nT - 1 - s (backwards). Tile t sits in ring stage t % 2 in both
  // passes, so pass 2's first two K tiles are the two pass 1 ended on, and
  // its first step takes pass 1's last logits as they are.
  auto tile_of = [&](int s) { return s < nT ? s : steps - 1 - s; };
  auto issue = [&](int s) {
    const int t = tile_of(s), stage = t & 1;
    if (s < nT || s - nT >= 2) copy_tile<F>(sK + stage * S::kTile, kn, t * kKeys, D);
    if (s >= nT) copy_tile<F>(sV + stage * S::kTile, vn, t * kKeys, D);
  };

  copy_tile<F>(sQ, qn, q0, D);
  issue(0);
  lfvdm::cp_async_commit();

  unsigned qa[F / 16][4];  // the warp's Q rows as A fragments, one per k16 slice
  float row_max[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float row_sum[2] = {0.f, 0.f};  // this lane's share of the row's sum (pass 1)
  float neg_max2[2] = {0.f, 0.f};  // -max·log2(e) (pass 2)
  float inv_sum[2] = {0.f, 0.f};   // 1 / sum (pass 2)
  float o[F / 8][4];
#pragma unroll
  for (int j = 0; j < F / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float sc[8][4];  // the warp's logits of the current key tile

  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      issue(s + 1);
      lfvdm::cp_async_commit();
      lfvdm::cp_async_wait<1>();  // step s has landed; step s + 1 is in flight
    } else {
      lfvdm::cp_async_wait<0>();
    }
    __syncthreads();
    if (s == 0) {
      // A fragment rows: 16 warp + lane % 16, features + 8 (lane / 16).
      const __nv_bfloat16* row = sQ + (warp * 16 + (lane & 15)) * kLd + ((lane >> 4) << 3);
#pragma unroll
      for (int kk = 0; kk < F / 16; ++kk) ldmatrix_x4(qa[kk], row + kk * 16);
    }
    const int t = tile_of(s);
    if (s != nT) logits<F>(sc, qa, sK + (t & 1) * S::kTile, t * kKeys, D, lane);

    if (s < nT) {
      // Pass 1: online max (reduced over the row's quad of lanes) and sum.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * h], sc[j][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m = fmaxf(row_max[h], mx);  // finite: key t·64 < D exists
        const float nm2 = -m * kLog2e;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sum += exp2f(fmaf(sc[j][2 * h], kLog2e, nm2)) +
                 exp2f(fmaf(sc[j][2 * h + 1], kLog2e, nm2));
        row_sum[h] = row_sum[h] * exp2f(fmaf(row_max[h], kLog2e, nm2)) + sum;  // exp2(-inf) = 0
        row_max[h] = m;
      }
      if (s == nT - 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float l = row_sum[h];
          l += __shfl_xor_sync(0xffffffffu, l, 1);
          l += __shfl_xor_sync(0xffffffffu, l, 2);
          inv_sum[h] = 1.f / l;
          neg_max2[h] = -row_max[h] * kLog2e;
        }
      }
    } else {
      // Pass 2: the normalised weights, rounded to bf16 as the reference
      // rounds them, become the A fragments of attn @ v: key slice kc is
      // accumulator tiles 2kc (keys 2t, 2t + 1) and 2kc + 1 (keys 8 + 2t, ...).
      const __nv_bfloat16* tV = sV + (t & 1) * S::kTile;
      // ldmatrix.trans rows: keys 16 kc + (lane % 8) + 8 ((lane / 8) % 2),
      // features + 8 (lane / 16).
      const __nv_bfloat16* row =
          tV + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kLd + ((lane >> 4) << 3);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        float p[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[jj][e] = exp2f(fmaf(sc[2 * kc + jj][e], kLog2e, neg_max2[e >> 1])) * inv_sum[e >> 1];
        const unsigned pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                                pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
        for (int fp = 0; fp < F / 16; ++fp) {
          unsigned b[4];
          ldmatrix_x4_trans(b, row + kc * 16 * kLd + fp * 16);
          mma_bf16(o[2 * fp], pa, b[0], b[1]);
          mma_bf16(o[2 * fp + 1], pa, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // readers done before the stage is refilled
  }

  // Epilogue: the warp stages its 16 rows in bf16 over its own rows of sQ,
  // then stores them in 16-byte chunks; no row past D is stored.
  __nv_bfloat16* const sO = sQ + warp * 16 * kLd;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < F / 8; ++j) {
    *reinterpret_cast<unsigned*>(sO + g * kLd + 8 * j + 2 * tq) = pack_bf16(o[j][0], o[j][1]);
    *reinterpret_cast<unsigned*>(sO + (g + 8) * kLd + 8 * j + 2 * tq) =
        pack_bf16(o[j][2], o[j][3]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * S::kChunks / 32; ++i) {  // 16 rows of F / 8 chunks: 2F / 32 per lane
    const int c = lane + 32 * i;
    const int r = c / S::kChunks, col = (c % S::kChunks) * 8;
    const int qrow = q0 + warp * 16 + r;
    if (qrow < D)
      *reinterpret_cast<uint4*>(out + base + (long long)qrow * F + col) =
          *reinterpret_cast<const uint4*>(sO + r * kLd + col);
  }
}

template <int F>
int launch(const void* q, const void* k, const void* v, void* out, int N, int D,
           cudaStream_t stream) {
  constexpr int smem = Shape<F>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(spatial_attention_mma_kernel<F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (D + kQRows - 1) / kQRows;
  if ((long long)N * q_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  spatial_attention_mma_kernel<F><<<N * q_tiles, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), D, q_tiles);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int lfvdm_spatial_attention(int dtype, const void* q, const void* k, const void* v,
                                       void* out, int N, int D, int F, void* stream) {
  if (N < 1 || D < 1 || F < 1 || (D + kBlockQ - 1) / kBlockQ > 65535 ||
      (F + kChunkF - 1) / kChunkF > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfvdm::kFloat32) return launch<float>(q, k, v, out, N, D, F, s);
  if (dtype == lfvdm::kBFloat16) return launch<__nv_bfloat16>(q, k, v, out, N, D, F, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernel: bf16 only, F in {16, 32, ..., 128}, every pointer
// 16-byte aligned; anything else is refused. Returns a cudaError_t.
extern "C" int lfvdm_spatial_attention_mma(int dtype, const void* q, const void* k, const void* v,
                                           void* out, int N, int D, int F, void* stream) {
  using lfvdm::aligned16;
  if (dtype != lfvdm::kBFloat16 || N < 1 || D < 1 || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (F) {
    case 16: return tc::launch<16>(q, k, v, out, N, D, s);
    case 32: return tc::launch<32>(q, k, v, out, N, D, s);
    case 48: return tc::launch<48>(q, k, v, out, N, D, s);
    case 64: return tc::launch<64>(q, k, v, out, N, D, s);
    case 80: return tc::launch<80>(q, k, v, out, N, D, s);
    case 96: return tc::launch<96>(q, k, v, out, N, D, s);
    case 112: return tc::launch<112>(q, k, v, out, N, D, s);
    case 128: return tc::launch<128>(q, k, v, out, N, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
