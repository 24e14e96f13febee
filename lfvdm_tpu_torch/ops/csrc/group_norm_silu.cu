// GroupNorm, the scale-shift after it and SiLU in one pass: the video U-Net's
// normalisation where no gradient is taken (ops/groupnorm.py).
//
// Replaces no Pallas kernel: the JAX package leaves GroupNorm32, the
// ResBlock's `* (1 + scale) + shift` and SiLU to XLA, which fuses them. Per
// element of x (N, C, H·W), with the group g of channel c:
//
//   y = silu(((x − mean_g)·rstd_g·γ_c + β_c)·(1 + scale[n, c]) + shift[n, c])
//
// in f32, rounded once to y's dtype. The statistics come from x, in one
// pass about a pivot (the slab's first element, so E[(x − p)²] − E[x − p]²
// cancels little), or from given per-(n, c) f32 sums (Σx, Σx²): E[x²] −
// E[x]², clamped at 0.
//
// Bound: bytes. A handful of operations per element against one read and
// one write of it (4 bytes in bf16), though SiLU's exp and reciprocal keep
// the special-function units about half as busy as the memory. So x is read
// from device memory once, and many small blocks are resident at once (8 an
// SM), so that one block's arithmetic and barriers overlap another's memory
// traffic. Each (n, g) slab, one contiguous run of (C/G)·H·W elements in
// NCHW, is split into `parts` blocks of kThreads threads, each thread
// holding kCache 16-byte units in registers (all its loads in flight at
// once): 2,048 bf16 elements a block's registers, up to 8 parts a slab.
// The parts of a slab form a thread-block cluster: each block reduces its
// sums, and the cluster adds the parts' sums through distributed shared
// memory in rank order. Units past what the registers hold are read again
// to apply, from L2 while the part is small (every flagship slab: 65,536
// elements at most, 8 parts of 8,192). With given sums nothing is read for
// the statistics, the parts need no cluster, and each streams its share.
// On the H100 at the flagship's 35 sites this took 7.2 ms per B=8, K=20
// forward against 5.3 ms of bytes (other block sizes, more registers a
// thread or a two-pass variance were slower; PERF.md). The affine, scale and
// shift fold into one multiply-add per channel, from a table in shared
// memory. Sums are reduced in a fixed order (no atomics), so launches
// repeat bitwise. Allocates nothing; launches on the caller's stream.

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kCache = 4;      // 16-byte units a thread keeps
constexpr int kThreads = 128;  // at most, per block; 8 blocks an SM at 64 registers
constexpr int kMinBlocks = 8;
constexpr int kMaxParts = 8;   // blocks a slab is split into (the portable cluster size)
constexpr int kMaxWarps = kThreads / 32;

// kE elements of T, loaded and stored as one access (16 bytes of input).
template <typename T, int kE>
struct alignas(sizeof(T) * kE) Pack {
  T v[kE];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x·sigmoid(x); exp overflows to inf for x < −88, giving −0.
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

// The block's total of v, in every thread, in a fixed order.
__device__ __forceinline__ float2 block_sum(float2 v, float2* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // an earlier call's readers are done with red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : make_float2(0.0f, 0.0f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

// The cluster's total of each block's `v`, in every thread of the cluster,
// added in rank order; `slot` is this block's shared exchange slot.
__device__ __forceinline__ float2 cluster_total(float2 v, float2* slot, int parts) {
  if (parts == 1) return v;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) *slot = v;
  cluster.sync();
  float2 t = make_float2(0.0f, 0.0f);
  for (int r = 0; r < parts; ++r) {
    const float2 p = *cluster.map_shared_rank(slot, r);
    t.x += p.x;
    t.y += p.y;
  }
  return t;
}

// A block may leave only once its cluster's peers have read its slots.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct Args {
  const void* x;
  void* y;
  const float* gamma;
  const float* beta;
  const void* scale;  // (N, C) rows ss_stride apart, in y's dtype; null: none
  const void* shift;
  long long ss_stride;
  const float* s1;  // (N, C) f32 sums; null: statistics from x
  const float* s2;
  int C, G, cpg;
  int units;       // units of a slab
  int parts;       // blocks a slab is split into
  int per_part;    // units of a part (the last may hold fewer)
  int unit_hw;     // units of a channel
  int unit_shift;  // log2(unit_hw) where it is a power of two, else -1
  float count;     // elements of a slab
  float eps;
};

__device__ __forceinline__ int channel_of(const Args& a, int u) {
  return a.unit_shift >= 0 ? u >> a.unit_shift : u / a.unit_hw;
}

// Adds Σ(x − pivot) and Σ(x − pivot)² over one unit to m.
template <typename T, int kE>
__device__ __forceinline__ void add_moments(float2& m, const Pack<T, kE>& p, float pivot) {
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    const float d = to_f32(p.v[k]) - pivot;
    m.x += d;
    m.y = fmaf(d, d, m.y);
  }
}

// y = silu(x·mul + add) for one unit, stored 16 bytes at a time (an f32
// output of a bf16 unit takes two stores).
template <typename Tin, typename Tout, int kE>
__device__ __forceinline__ void apply(Pack<Tout, kE>* y, const Pack<Tin, kE>& p, float mul,
                                      float add) {
  constexpr int kOut = 16 / sizeof(Tout) < kE ? 16 / sizeof(Tout) : kE;
  using Out = Pack<Tout, kOut>;
#pragma unroll
  for (int h = 0; h < kE / kOut; ++h) {
    Out o;
#pragma unroll
    for (int k = 0; k < kOut; ++k)
      o.v[k] = from_f32<Tout>(silu(fmaf(to_f32(p.v[h * kOut + k]), mul, add)));
    reinterpret_cast<Out*>(y)[h] = o;
  }
}

template <typename Tin, typename Tout, int kE, bool kSums>
__global__ void __launch_bounds__(kThreads, kMinBlocks) group_norm_silu_kernel(const Args a) {
  // [cpg] multipliers, [cpg] addends, the cluster's exchange slot, the reduction's partials
  extern __shared__ float smem[];
  float* mul = smem;
  float* add = smem + a.cpg;
  float2* xch = reinterpret_cast<float2*>(smem + 2 * a.cpg);
  float2* red = xch + 1;
  const int ng = blockIdx.x / a.parts, part = blockIdx.x - ng * a.parts;
  const int n = ng / a.G, g = ng - n * a.G;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int u0 = part * a.per_part;  // this part's first unit in the slab
  const int len = max(0, min(a.units - u0, a.per_part));
  const long long slab = static_cast<long long>(ng) * a.units;
  const Pack<Tin, kE>* __restrict__ x = static_cast<const Pack<Tin, kE>*>(a.x) + slab + u0;
  Pack<Tout, kE>* __restrict__ y = static_cast<Pack<Tout, kE>*>(a.y) + slab + u0;

  Pack<Tin, kE> cache[kCache];
  float mean, rstd;
  if constexpr (kSums) {
    float2 s = make_float2(0.0f, 0.0f);
    const long long row = static_cast<long long>(n) * a.C + g * a.cpg;
    for (int c = tid; c < a.cpg; c += nt) {
      s.x += a.s1[row + c];
      s.y += a.s2[row + c];
    }
    s = block_sum(s, red);
    mean = s.x / a.count;
    rstd = rsqrtf(fmaxf(s.y / a.count - mean * mean, 0.0f) + a.eps);
  } else {
    const float pivot = to_f32(static_cast<const Tin*>(a.x)[slab * kE]);
    float2 m = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < kCache; ++r) {
      const int i = tid + r * nt;
      if (i < len) {
        cache[r] = x[i];
        add_moments(m, cache[r], pivot);
      }
    }
    for (int i = tid + kCache * nt; i < len; i += nt) add_moments(m, x[i], pivot);
    m = cluster_total(block_sum(m, red), xch, a.parts);
    const float md = m.x / a.count;
    mean = pivot + md;
    rstd = rsqrtf(fmaxf(m.y / a.count - md * md, 0.0f) + a.eps);
    if (a.parts > 1) cluster_arrive();
  }

  const long long ss_row = static_cast<long long>(n) * a.ss_stride;
  for (int c = tid; c < a.cpg; c += nt) {
    const int ch = g * a.cpg + c;
    float m = rstd * a.gamma[ch];
    float b = a.beta[ch] - mean * m;
    if (a.scale != nullptr) {
      const float s = 1.0f + to_f32(static_cast<const Tout*>(a.scale)[ss_row + ch]);
      m *= s;
      b *= s;
    }
    if (a.shift != nullptr) b += to_f32(static_cast<const Tout*>(a.shift)[ss_row + ch]);
    mul[c] = m;
    add[c] = b;
  }
  __syncthreads();

  if constexpr (kSums) {
#pragma unroll
    for (int r = 0; r < kCache; ++r) {
      const int i = tid + r * nt;
      if (i < len) cache[r] = x[i];
    }
#pragma unroll
    for (int r = 0; r < kCache; ++r) {
      const int i = tid + r * nt;
      if (i < len) {
        const int c = channel_of(a, u0 + i);
        apply<Tin, Tout, kE>(y + i, cache[r], mul[c], add[c]);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kCache; ++r) {
      const int i = tid + r * nt;
      if (i < len) {
        const int c = channel_of(a, u0 + i);
        apply<Tin, Tout, kE>(y + i, cache[r], mul[c], add[c]);
      }
    }
    for (int i = tid + kCache * nt; i < len; i += nt) {
      const int c = channel_of(a, u0 + i);
      apply<Tin, Tout, kE>(y + i, x[i], mul[c], add[c]);
    }
    if (a.parts > 1) cluster_wait();
  }
}

int threads_for(int units) {
  int t = 64;
  while (t < kThreads && t * kCache < units) t *= 2;
  return t;
}

template <typename Tin, typename Tout, int kE>
int launch(const Args& a, int N, cudaStream_t s) {
  const size_t smem = 2 * a.cpg * sizeof(float) + (1 + kMaxWarps) * sizeof(float2);
  const dim3 grid(static_cast<unsigned>(N) * a.G * a.parts);
  const dim3 block(threads_for(a.per_part));
  if (a.s1 != nullptr) {
    group_norm_silu_kernel<Tin, Tout, kE, true><<<grid, block, smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  if (a.parts == 1) {
    group_norm_silu_kernel<Tin, Tout, kE, false><<<grid, block, smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, group_norm_silu_kernel<Tin, Tout, kE, false>, a);
  return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

template <typename Tin, typename Tout>
int dispatch(Args a, int N, long long hw, bool vec, cudaStream_t s) {
  constexpr int kE = 16 / sizeof(Tin);
  const int e = vec ? kE : 1;
  if (vec && (hw % kE != 0 || !lfvdm::aligned16(a.x) ||
              reinterpret_cast<uintptr_t>(a.y) % (kE * sizeof(Tout)) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  a.units = static_cast<int>(a.cpg * hw / e);
  a.unit_hw = static_cast<int>(hw / e);
  a.unit_shift = -1;
  for (int b = 0; b < 31; ++b)
    if ((1 << b) == a.unit_hw) a.unit_shift = b;
  const int held = kThreads * kCache;  // units one block holds
  if (a.s1 != nullptr) {  // streamed: one round a part
    a.parts = (a.units + held - 1) / held;
  } else {  // a cluster of up to kMaxParts parts, holding what it can
    a.parts = 1;
    while (a.parts < kMaxParts && (a.units + a.parts - 1) / a.parts > held) a.parts *= 2;
  }
  a.per_part = (a.units + a.parts - 1) / a.parts;
  if (static_cast<long long>(N) * a.G * a.parts > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  return vec ? launch<Tin, Tout, kE>(a, N, s) : launch<Tin, Tout, 1>(a, N, s);
}

}  // namespace

// y = silu(GroupNorm(x)·(1 + scale) + shift) over x (N, C, hw), G groups.
// vec: 16-byte units (hw a multiple of 16 bytes' elements, x 16-byte and y
// unit-aligned), else one element at a time. Returns a cudaError_t code
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int lfvdm_group_norm_silu(int in_dtype, int out_dtype, const void* x, void* y,
                                     const float* gamma, const float* beta, const void* scale,
                                     const void* shift, long long ss_stride, const float* s1,
                                     const float* s2, int N, int C, int G, long long hw,
                                     float eps, int vec, void* stream) {
  const long long cpg = G > 0 ? C / G : 0;
  if (N < 0 || C <= 0 || G <= 0 || C % G != 0 || hw <= 0 || x == nullptr || y == nullptr ||
      gamma == nullptr || beta == nullptr || (s1 == nullptr) != (s2 == nullptr) ||
      cpg * hw > 2147483647LL ||
      2 * cpg * sizeof(float) + (1 + kMaxWarps) * sizeof(float2) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  Args a;
  a.x = x;
  a.y = y;
  a.gamma = gamma;
  a.beta = beta;
  a.scale = scale;
  a.shift = shift;
  a.ss_stride = ss_stride;
  a.s1 = s1;
  a.s2 = s2;
  a.C = C;
  a.G = G;
  a.cpg = static_cast<int>(cpg);
  a.count = static_cast<float>(static_cast<double>(cpg) * hw);
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (in_dtype == lfvdm::kBFloat16 && out_dtype == lfvdm::kBFloat16)
    return dispatch<bf16, bf16>(a, N, hw, vec != 0, s);
  if (in_dtype == lfvdm::kBFloat16 && out_dtype == lfvdm::kFloat32)
    return dispatch<bf16, float>(a, N, hw, vec != 0, s);
  if (in_dtype == lfvdm::kFloat32 && out_dtype == lfvdm::kFloat32)
    return dispatch<float, float>(a, N, hw, vec != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
