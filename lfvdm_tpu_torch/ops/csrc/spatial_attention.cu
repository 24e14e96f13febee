// Multi-head softmax(q kᵀ) v over the pixel tokens of each (batch, frame, head).
//
// Replaces lfvdm_tpu/ops/attention.py::_spatial_kernel (the Pallas kernel
// behind spatial_attention). Plain version and wrapper:
// lfvdm_tpu_torch/ops/attention.py.
//
// Layout (row-major): q, k, v, out (N, D, F) with N = B·T·H, D tokens, F
// features per head (F minor); q arrives pre-scaled by F^-1/2. No mask.
//
// A flash-attention forward in two passes: one block per (n, 64-query
// tile), walking 64-key tiles, so the (D, D) logits never reach device
// memory. Pass 1 finds each query row's max and sum of exponentials with an
// online softmax (f32); pass 2 recomputes the logits, forms the normalised
// weights, rounds them to the storage type exactly as the reference does
// before attn @ v, and accumulates attn @ v in f32. The second q kᵀ costs
// the extra pass; in exchange the bf16 kernel and the reference round the
// same values (a one-pass online softmax cannot, since it normalises last).
// Q, K and V tiles are staged in shared memory as f32; 256 threads give each
// query row four threads, each holding 16 logits and F/4 output columns in
// registers.
//
// Bound on the H100: at the flagship shapes (N = 160, D = 64..256,
// F = 96..128) the bf16 work is under the card's operations-per-byte
// balance, so the bound is bytes; in f32 (no tensor cores) it is operations.
// This first version multiplies with plain FMAs on shared memory and
// computes q kᵀ twice, so it runs far above either bound; mma.sync or wgmma
// tiles are the next step.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kLanesPerRow = kThreads / kBlockQ;   // 4
constexpr int kColsS = kBlockK / kLanesPerRow;     // 16 logits per thread
constexpr int kMaxF = 128;                         // the wrapper rejects more
constexpr int kColsO = kMaxF / kLanesPerRow;       // 32 outputs per thread

__host__ __device__ constexpr int smem_floats(int F) {
  return 3 * kBlockQ * (F + 1) + kBlockQ * (kBlockK + 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    spatial_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ out, int D, int F) {
  extern __shared__ float smem[];
  const int ld = F + 1;  // padded rows: the 8 rows a warp reads hit 8 banks
  float* sQ = smem;
  float* sK = sQ + kBlockQ * ld;
  float* sV = sK + kBlockK * ld;
  float* sP = sV + kBlockK * ld;  // (kBlockQ, kBlockK + 1)

  const int tid = threadIdx.x;
  const int row = tid / kLanesPerRow;
  const int lane = tid % kLanesPerRow;
  const long long base = (long long)blockIdx.x * D * F;
  const int q0 = blockIdx.y * kBlockQ;

  for (int i = tid; i < kBlockQ * F; i += kThreads) {
    const int r = i / F, f = i - r * F;
    sQ[r * ld + f] = (q0 + r < D) ? lfvdm::load_f32(q + base + (long long)(q0 + r) * F + f) : 0.f;
  }

  // Stage key tile k0 (and its values) in shared memory.
  auto load_tile = [&](int k0, bool with_v) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBlockK * F; i += kThreads) {
      const int r = i / F, f = i - r * F;
      const bool in = k0 + r < D;
      const long long g = base + (long long)(k0 + r) * F + f;
      sK[r * ld + f] = in ? lfvdm::load_f32(k + g) : 0.f;
      if (with_v) sV[r * ld + f] = in ? lfvdm::load_f32(v + g) : 0.f;
    }
    __syncthreads();
  };
  // This thread's 16 logits of tile k0: columns lane + 4j; -inf past D.
  auto logits = [&](int k0, float* s) {
#pragma unroll
    for (int j = 0; j < kColsS; ++j) s[j] = 0.f;
    for (int f = 0; f < F; ++f) {
      const float qf = sQ[row * ld + f];
#pragma unroll
      for (int j = 0; j < kColsS; ++j)
        s[j] = fmaf(qf, sK[(lane + kLanesPerRow * j) * ld + f], s[j]);
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
    load_tile(k0, false);
    logits(k0, s);
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
    load_tile(k0, true);
    logits(k0, s);
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
        if (f < F) o[i] = fmaf(p, sV[c * ld + f], o[i]);
      }
    }
  }

  if (q0 + row < D) {
    T* dst = out + base + (long long)(q0 + row) * F;
#pragma unroll
    for (int i = 0; i < kColsO; ++i) {
      const int f = lane + kLanesPerRow * i;
      if (f < F) lfvdm::store_f32(dst + f, o[i]);
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
  const dim3 grid(N, (D + kBlockQ - 1) / kBlockQ);
  spatial_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), D, F);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int lfvdm_spatial_attention(int dtype, const void* q, const void* k, const void* v,
                                       void* out, int N, int D, int F, void* stream) {
  if (N < 1 || D < 1 || F < 1 || F > kMaxF || (D + kBlockQ - 1) / kBlockQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfvdm::kFloat32) return launch<float>(q, k, v, out, N, D, F, s);
  if (dtype == lfvdm::kBFloat16) return launch<__nv_bfloat16>(q, k, v, out, N, D, F, s);
  return (int)cudaErrorInvalidValue;
}
