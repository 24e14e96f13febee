// AdamW and every EMA copy in one pass over the parameters, in place, as a
// multi-tensor apply.
//
// Replaces no Pallas kernel: the JAX package computes this update
// (lfvdm_tpu/training/train_loop.py _fused_adamw_ema, under LFVDM_FUSED_OPT)
// as an XLA fusion of jax.tree.map. Per element of every local parameter:
//
//   m2 = b1·m + (1 − b1)·g
//   v2 = b2·v + (1 − b2)·g²
//   u  = (m2 / c1) / (sqrt(v2 / c2) + eps) + wd·p     c1, c2 = 1 − b^(count + 1)
//   p2 = p − lr·u
//   e2 = e·r + p2·(1 − r)  for each EMA rate r, in f32, stored at e's dtype
//
// written to p, m, v and every e only where the 0-d `finite` flag is true,
// so a skipped step leaves every bit as it was (the JAX step's select). The
// flag, the Adam count and the schedule's LR factor are read from device
// memory: nothing goes back to the host, and the launches are legal inside
// a CUDA graph.
//
// Bound: bytes. Each element reads p, g, m, v and every e once and writes
// p, m, v and every e once (36 bytes for f32 with one rate) against about 20
// flops. So the design is one read and one write of each array: 16-byte
// loads and stores where a tensor's arrays allow them, no intermediate in
// device memory, and no gather of the tensors into flat copies.
//
// The tensors' pointers and sizes travel as kernel arguments, up to
// kMaxTensors tensors and kMaxBlocks blocks per launch (PyTorch's
// _foreach kernels do the same); the host function below walks the tensor
// list and launches as often as it takes. No device-side table: the
// gradients are new tensors in every eager step, and arguments captured in
// a graph stay right because a graph's gradients live at fixed addresses.
// The argument block is ~15 KB: above the old 4 KB limit, inside the
// 32,764 bytes that CUDA 12.1 and later allow on sm_70 and newer.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8192;  // elements per block: 32 a thread, 8 vector steps
constexpr int kMaxTensors = 128;
constexpr int kMaxRates = 4;
constexpr int kMaxBlocks = 1024;

struct TensorList {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  void* e[kMaxRates][kMaxTensors];
  long long numel[kMaxTensors];
  unsigned char block_tensor[kMaxBlocks];  // slot of the tensor this block updates
  int block_chunk[kMaxBlocks];             // and which kChunk elements of it
};
static_assert(kMaxTensors <= 256, "block_tensor holds a byte");
static_assert(sizeof(TensorList) + 128 <= 32764, "kernel arguments above CUDA's limit");

struct Hyper {
  const unsigned char* finite;  // 0-d bool
  const long long* count;       // 0-d int64: updates made before this one
  const float* lr_factor;       // 0-d f32 schedule factor, or null
  float lr, wd, b1, one_minus_b1, b2, one_minus_b2, eps;
  float rate[kMaxRates], one_minus_rate[kMaxRates];
  int n_rates;
};

// The update of one element; `e` holds the EMA copies' values on entry and
// their new values (unrounded f32) on return.
__device__ __forceinline__ void update(float& p, float g, float& m, float& v, float* e,
                                       const Hyper& h, float c1, float c2, float lr) {
  m = h.b1 * m + h.one_minus_b1 * g;
  v = h.b2 * v + h.one_minus_b2 * (g * g);
  const float u = (m / c1) / (sqrtf(v / c2) + h.eps) + h.wd * p;
  p = p - lr * u;
#pragma unroll
  for (int r = 0; r < kMaxRates; ++r)
    if (r < h.n_rates) e[r] = e[r] * h.rate[r] + p * h.one_minus_rate[r];
}

// Plain loads throughout: the EMA copies and the state are written by the
// kernel, so the read-only path (__ldg) does not apply to them.
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  uint2 raw;
  raw.x = lfvdm::pack_bf16(x.x, x.y);
  raw.y = lfvdm::pack_bf16(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ bool vec_aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
    fused_adamw_ema_kernel(const __grid_constant__ TensorList tl, const __grid_constant__ Hyper h) {
  if (!*h.finite) return;  // a skipped step: nothing is written
  const float count = static_cast<float>(*h.count + 1);
  const float c1 = 1.0f - powf(h.b1, count);
  const float c2 = 1.0f - powf(h.b2, count);
  const float lr = h.lr_factor != nullptr ? h.lr * *h.lr_factor : h.lr;

  const int slot = tl.block_tensor[blockIdx.x];
  const long long start = static_cast<long long>(tl.block_chunk[blockIdx.x]) * kChunk;
  const long long left = tl.numel[slot] - start;
  const int n = left < kChunk ? static_cast<int>(left) : kChunk;
  float* p = tl.p[slot] + start;
  const float* g = tl.g[slot] + start;
  float* m = tl.m[slot] + start;
  float* v = tl.v[slot] + start;
  E* e[kMaxRates];
  bool vec = vec_aligned(p, 16) && vec_aligned(g, 16) && vec_aligned(m, 16) &&
             vec_aligned(v, 16);
#pragma unroll
  for (int r = 0; r < kMaxRates; ++r) {
    e[r] = r < h.n_rates ? static_cast<E*>(tl.e[r][slot]) + start : nullptr;
    if (r < h.n_rates) vec = vec && vec_aligned(e[r], 4 * sizeof(E));
  }

  int done = 0;
  if (vec) {
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      float4 pp = load4(p + 4 * i), gg = load4(g + 4 * i), mm = load4(m + 4 * i),
             vv = load4(v + 4 * i);
      float4 ee[kMaxRates];
#pragma unroll
      for (int r = 0; r < kMaxRates; ++r)
        if (r < h.n_rates) ee[r] = load4(e[r] + 4 * i);
      float* pf = &pp.x;
      float* gf = &gg.x;
      float* mf = &mm.x;
      float* vf = &vv.x;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float ek[kMaxRates];
#pragma unroll
        for (int r = 0; r < kMaxRates; ++r) ek[r] = r < h.n_rates ? (&ee[r].x)[k] : 0.0f;
        update(pf[k], gf[k], mf[k], vf[k], ek, h, c1, c2, lr);
#pragma unroll
        for (int r = 0; r < kMaxRates; ++r)
          if (r < h.n_rates) (&ee[r].x)[k] = ek[r];
      }
      store4(p + 4 * i, pp);
      store4(m + 4 * i, mm);
      store4(v + 4 * i, vv);
#pragma unroll
      for (int r = 0; r < kMaxRates; ++r)
        if (r < h.n_rates) store4(e[r] + 4 * i, ee[r]);
    }
    done = 4 * n4;
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) {  // the tail, or unaligned data
    float pi = p[i], mi = m[i], vi = v[i];
    float ek[kMaxRates];
#pragma unroll
    for (int r = 0; r < kMaxRates; ++r)
      ek[r] = r < h.n_rates ? load1(e[r] + i) : 0.0f;
    update(pi, g[i], mi, vi, ek, h, c1, c2, lr);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
#pragma unroll
    for (int r = 0; r < kMaxRates; ++r)
      if (r < h.n_rates) lfvdm::store_f32(e[r] + i, ek[r]);
  }
}

template <typename E>
int launch_all(int n_tensors, const long long* numel, void* const* p, void* const* g,
               void* const* m, void* const* v, void* const* e, const Hyper& h,
               cudaStream_t stream, int* launches) {
  TensorList tl;
  int slot = 0, blocks = 0;
  *launches = 0;
  auto fill = [&](int to, int t) {
    tl.p[to] = static_cast<float*>(p[t]);
    tl.g[to] = static_cast<const float*>(g[t]);
    tl.m[to] = static_cast<float*>(m[t]);
    tl.v[to] = static_cast<float*>(v[t]);
    tl.numel[to] = numel[t];
    for (int r = 0; r < h.n_rates; ++r) tl.e[r][to] = e[static_cast<long long>(r) * n_tensors + t];
  };
  for (int t = 0; t < n_tensors; ++t) {
    if (numel[t] == 0) continue;
    fill(slot, t);
    const long long chunks = (numel[t] + kChunk - 1) / kChunk;
    for (long long c = 0; c < chunks; ++c) {
      tl.block_tensor[blocks] = static_cast<unsigned char>(slot);
      tl.block_chunk[blocks] = static_cast<int>(c);
      ++blocks;
      const bool last_chunk = c == chunks - 1;
      if (blocks == kMaxBlocks || (last_chunk && slot == kMaxTensors - 1)) {
        fused_adamw_ema_kernel<E><<<blocks, kThreads, 0, stream>>>(tl, h);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        ++*launches;
        blocks = 0;
        if (last_chunk) {
          slot = -1;  // the next tensor starts a new list
        } else {      // this tensor goes on in the next launch, from slot 0
          fill(0, t);
          slot = 0;
        }
      }
    }
    ++slot;
  }
  if (blocks > 0) {
    fused_adamw_ema_kernel<E><<<blocks, kThreads, 0, stream>>>(tl, h);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}

}  // namespace

// Returns a cudaError_t: 0 when every launch was accepted. `p`, `g`, `m`,
// `v` hold n_tensors f32 device pointers each, `e` n_rates · n_tensors
// pointers rate by rate (all f32, or all bf16 as `ema_dtype` says), `numel`
// each tensor's elements. `hyper` holds lr, wd, b1, 1 − b1, b2, 1 − b2, eps,
// then each rate and each 1 − rate. The number of kernel launches made goes
// to `launches`.
extern "C" int lfvdm_fused_adamw_ema(int ema_dtype, int n_tensors, int n_rates,
                                     const long long* numel, void* const* p, void* const* g,
                                     void* const* m, void* const* v, void* const* e,
                                     const void* finite, const void* count,
                                     const void* lr_factor, const float* hyper, int* launches,
                                     void* stream) {
  *launches = 0;
  if (n_tensors < 0 || n_rates < 0 || n_rates > kMaxRates || finite == nullptr ||
      count == nullptr || (ema_dtype != lfvdm::kFloat32 && ema_dtype != lfvdm::kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int t = 0; t < n_tensors; ++t)
    if (numel[t] < 0 || (numel[t] + kChunk - 1) / kChunk > 2147483647LL)
      return static_cast<int>(cudaErrorInvalidValue);
  Hyper h;
  h.finite = static_cast<const unsigned char*>(finite);
  h.count = static_cast<const long long*>(count);
  h.lr_factor = static_cast<const float*>(lr_factor);
  h.lr = hyper[0];
  h.wd = hyper[1];
  h.b1 = hyper[2];
  h.one_minus_b1 = hyper[3];
  h.b2 = hyper[4];
  h.one_minus_b2 = hyper[5];
  h.eps = hyper[6];
  for (int r = 0; r < kMaxRates; ++r) {
    h.rate[r] = r < n_rates ? hyper[7 + r] : 0.0f;
    h.one_minus_rate[r] = r < n_rates ? hyper[7 + n_rates + r] : 0.0f;
  }
  h.n_rates = n_rates;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ema_dtype == lfvdm::kBFloat16
             ? launch_all<__nv_bfloat16>(n_tensors, numel, p, g, m, v, e, h, s, launches)
             : launch_all<float>(n_tensors, numel, p, g, m, v, e, h, s, launches);
}
