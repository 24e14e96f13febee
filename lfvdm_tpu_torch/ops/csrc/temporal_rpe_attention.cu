// Two-group-masked RPE attention over the frames at each pixel site.
//
// Replaces lfvdm_tpu/ops/attention.py::_temporal_kernel (the Pallas kernel
// behind temporal_rpe_attention, launched by _temporal_pallas). Plain version
// and wrapper: lfvdm_tpu_torch/ops/attention.py.
//
// Layout (row-major, pixel sites D minor):
//   q, k, v, out   (B, H, T, F, D)   q pre-scaled by F^-1/2
//   r_k, r_q_t     (B, H, T, S, F)   S == T; r_q_t[t, s] = R_q[s, t] * scale
//   r_v_t          (B, H, T, F, S)
//   mask           (B, T) f32, per-frame group in {0, 1}
//
// For query frame t at site d:
//   logit[s] = q[t]·k[s] + q[t]·r_k[t, s] + k[s]·r_q_t[t, s]   (sums over F)
//   allowed(t, s) = m_t m_s + (1 - m_t)(1 - m_s), else logit = f32 min
//   attn = softmax_s(logit) in f32, normalised, then rounded to the storage
//          type (as the reference rounds it, before both value products)
//   out[t, f] = sum_s attn[s] (v[s, f] + r_v_t[t, f, s])
//
// Bound on the H100: bytes. A flagship launch (B·H = 8, T = 20, F = 96 at
// D = 256, F = 128 at D = 64) moves q, k, v, out and the r tables once:
// 0.0099 and 0.0039 ms at 3.35 TB/s, 0.045 ms per U-Net forward (3 + 4
// launches). Its 10·B·H·T²·F·D operations would take 0.051 ms per forward at
// the card's 67 TFLOP/s outside the tensor cores, so a kernel on the CUDA
// cores can come within 1.13x of the bound; the tensor cores are not used.
//
// Design. A block of 8 warps owns one (b, h), a tile of 32 neighbouring
// sites (one per lane, so every q/k/v/out access of a warp is one contiguous
// run along D) and a group of TQ consecutive query frames (TQ = 4, 2 or 1:
// the largest that still gives every SM a block, so that the 512 sites of a
// ds-16 launch, at TQ = 2, fill the card as the 2048 of a ds-8 one do at
// TQ = 4; on the card TQ = 2 there beat TQ = 1, 0.053 against 0.070 ms).
// Keys and features go in chunks of 32.
//  1. Logits. Warps split the keys of a chunk (warp w takes keys w, w + 8,
//     w + 16, w + 24). A thread holds q of its TQ frames for 8 features at a
//     time in registers, and each k[s, f, d] it loads feeds 2·TQ FMAs (q·k
//     and k·r_q for every query frame): every k element of the tile is read
//     once per block, by the one thread that uses it; the blocks of the other
//     query groups read it again from L2. The r tables do not depend on d:
//     the block stages r_k and r_q_t of its frames, keys and features in
//     shared memory as f32, once, and every lane of a warp reads the same
//     16 bytes (a broadcast of 4 features). The masked f32 logits go to
//     shared memory, (TQ, T, 32) floats.
//  2. Softmax. One thread per (query frame, site) takes the max, the
//     exponentials and the sum over all T keys in f32, then writes the
//     normalised weights, rounded to the storage type, over the logits. The
//     weights are exact (no online rescaling), so they round where the
//     reference rounds, for any T.
//  3. Values. Warps split a chunk of 32 features, 4 each; each v[s, f, d] a
//     thread loads feeds TQ FMAs, each weight read from shared memory feeds
//     8, and r_v_t comes staged as f32, 4 features in one broadcast read.
// Shared memory (128·TQ·T bytes of logits and 8·TQ KB of r tables) is the
// only limit on T: T <= 1752 at TQ = 1 (the H100's 227 KB a block). No
// atomics: two launches on the same inputs are bitwise equal.
//
// Where it stands (PERF.md §6, on an H100 at 700 W): 0.143 ms at ds 8 and
// 0.053 ms at ds 16, ~14x the bound, ~4.7x faster per U-Net forward than
// the one-thread-per-(frame, site) kernel it replaced and ~3x faster than
// the plain version. Neither fewer load instructions (the staged r tables:
// 15% at ds 8) nor more loads in flight (tried: slower, spills) moved it
// much. What is left is inside each block: every 32-feature chunk is staged
// between two barriers with nothing to overlap the copy (7 such stalls a
// block at ds 8), at most two blocks fit an SM (128 registers), and a ds-8
// grid of 320 blocks runs in 1.2 waves. Copying the next chunk while
// computing on this one (cp.async into a second buffer) is the next lever.

#include <cfloat>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kSites = 32;                          // lanes: pixel sites
constexpr int kWarps = 8;
constexpr int kThreads = kSites * kWarps;
constexpr int kChunk = 32;                          // keys, and features, staged at a time
constexpr int kKeysPerThread = kChunk / kWarps;     // logits: 4 keys per thread per chunk
constexpr int kFc = 8;                              // logits: q features in registers
constexpr int kFb = kChunk / kWarps;                // values: 4 features per thread per chunk
constexpr int kSmemPerBlock = 232448;               // bytes a block may use on the H100

__host__ __device__ constexpr int smem_floats(int tq, int nT) {
  return tq * nT * kSites + 2 * tq * kChunk * kChunk;
}

// Everything a block needs to address its inputs.
template <typename T>
struct Args {
  const T* q;      // q[t * fd + f * D] at this thread's site
  const T* k;
  const T* v;
  const T* r_k;    // r_k[(t * nT + s) * F + f] of this (b, h)
  const T* r_q_t;
  const T* r_v_t;  // r_v_t[(t * F + f) * nT + s] of this (b, h)
  long long fd;    // F * D
  int nT, F, D;
};

// sRk, sRq (TQ, 32 keys, 32 features) f32 <- r_k, r_q_t at query frames t0 +
// i, keys s0 + sl, features f0 + fl; zeros outside the tables.
template <typename T, int TQ>
__device__ __forceinline__ void stage_rk_rq(float* sRk, float* sRq, const Args<T>& a, int t0,
                                            int s0, int f0) {
  for (int idx = threadIdx.x; idx < TQ * kChunk * kChunk; idx += kThreads) {
    const int fl = idx % kChunk, sl = (idx / kChunk) % kChunk, i = idx / (kChunk * kChunk);
    const int t = t0 + i, s = s0 + sl, f = f0 + fl;
    const bool in = t < a.nT && s < a.nT && f < a.F;
    const long long g = ((long long)t * a.nT + s) * a.F + f;
    sRk[idx] = in ? lfvdm::load_f32(a.r_k + g) : 0.f;
    sRq[idx] = in ? lfvdm::load_f32(a.r_q_t + g) : 0.f;
  }
}

// sRv (TQ, 32 keys, 32 features) f32 <- r_v_t at query frames t0 + i, keys
// s0 + sl, features f0 + fl; zeros outside. Lanes take neighbouring features,
// so the stores are free of bank conflicts (the loads gather through L1).
template <typename T, int TQ>
__device__ __forceinline__ void stage_rv(float* sRv, const Args<T>& a, int t0, int s0, int f0) {
  for (int idx = threadIdx.x; idx < TQ * kChunk * kChunk; idx += kThreads) {
    const int fl = idx % kChunk, sl = (idx / kChunk) % kChunk, i = idx / (kChunk * kChunk);
    const int t = t0 + i, s = s0 + sl, f = f0 + fl;
    const bool in = t < a.nT && s < a.nT && f < a.F;
    sRv[idx] = in ? lfvdm::load_f32(a.r_v_t + ((long long)t * a.F + f) * a.nT + s) : 0.f;
  }
}

// acc[c][i] += the logit terms of features [f0 + fl, f0 + fl + N) for key
// s0 + warp + 8c and query frame t0 + i (clamped to nT - 1: those rows are
// computed and never stored). r_k and r_q_t come from the staged chunk.
template <typename T, int TQ, int N>
__device__ __forceinline__ void logit_terms(float (&acc)[kKeysPerThread][TQ], const Args<T>& a,
                                            const float* sRk, const float* sRq, int t0, int s0,
                                            int f0, int fl, int warp) {
  float qr[TQ][N];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int t = min(t0 + i, a.nT - 1);
#pragma unroll
    for (int j = 0; j < N; ++j)
      qr[i][j] = lfvdm::load_f32(a.q + t * a.fd + (long long)(f0 + fl + j) * a.D);
  }
#pragma unroll
  for (int c = 0; c < kKeysPerThread; ++c) {
    const int sl = warp + kWarps * c;
    const int s = s0 + sl;
    if (s >= a.nT) break;  // warp-uniform
    float kr[N];
#pragma unroll
    for (int j = 0; j < N; ++j)
      kr[j] = lfvdm::load_f32(a.k + s * a.fd + (long long)(f0 + fl + j) * a.D);
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int r = (i * kChunk + sl) * kChunk + fl;
      float rk[N], rq[N];
      if constexpr (N % 4 == 0) {
#pragma unroll
        for (int j = 0; j < N; j += 4) {
          const float4 x = *reinterpret_cast<const float4*>(sRk + r + j);
          const float4 y = *reinterpret_cast<const float4*>(sRq + r + j);
          rk[j] = x.x, rk[j + 1] = x.y, rk[j + 2] = x.z, rk[j + 3] = x.w;
          rq[j] = y.x, rq[j + 1] = y.y, rq[j + 2] = y.z, rq[j + 3] = y.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) rk[j] = sRk[r + j], rq[j] = sRq[r + j];
      }
      float x = acc[c][i];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        x = fmaf(qr[i][j], kr[j], x);
        x = fmaf(qr[i][j], rk[j], x);
        x = fmaf(kr[j], rq[j], x);
      }
      acc[c][i] = x;
    }
  }
}

template <typename T, int TQ>
__global__ void __launch_bounds__(kThreads, 2)
    temporal_rpe_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, const T* __restrict__ r_k,
                                  const T* __restrict__ r_q_t, const T* __restrict__ r_v_t,
                                  const float* __restrict__ mask, T* __restrict__ out, int H,
                                  int nT, int F, int D, int tiles, int groups) {
  extern __shared__ __align__(16) float smem[];
  float* const sL = smem;                           // (TQ, nT, 32): logits, then weights
  float* const sR0 = sL + TQ * nT * kSites;         // (TQ, 32, 32): r_k, then r_v_t
  float* const sR1 = sR0 + TQ * kChunk * kChunk;    // (TQ, 32, 32): r_q_t
  const int lane = threadIdx.x % kSites, warp = threadIdx.x / kSites;
  // blockIdx.x = (bh * groups + g) * tiles + tile: neighbouring blocks share
  // (b, h) and their r tables.
  const int tile = blockIdx.x % tiles;
  const int g = (blockIdx.x / tiles) % groups;
  const int bh = blockIdx.x / (tiles * groups);
  const int b = bh / H;
  const int t0 = g * TQ;
  const int d = tile * kSites + lane;
  const bool site_ok = d < D;
  const int d_ld = site_ok ? d : D - 1;  // out-of-range lanes load a valid site

  const long long fd = (long long)F * D;
  const long long qkv = (long long)bh * nT * fd;
  const long long rr = (long long)bh * nT * nT * F;
  const Args<T> a{q + qkv + d_ld, k + qkv + d_ld, v + qkv + d_ld, r_k + rr, r_q_t + rr,
                  r_v_t + rr, fd, nT, F, D};
  const float* m = mask + (long long)b * nT;

  // 1. Masked logits into shared memory, a chunk of 32 keys at a time.
  for (int s0 = 0; s0 < nT; s0 += kChunk) {
    float acc[kKeysPerThread][TQ];
#pragma unroll
    for (int c = 0; c < kKeysPerThread; ++c)
#pragma unroll
      for (int i = 0; i < TQ; ++i) acc[c][i] = 0.f;
    for (int f0 = 0; f0 < F; f0 += kChunk) {
      __syncthreads();  // the previous chunk's readers are done
      stage_rk_rq<T, TQ>(sR0, sR1, a, t0, s0, f0);
      __syncthreads();
      const int w = min(kChunk, F - f0);
      const int w8 = w - w % kFc;
      for (int fl = 0; fl < w8; fl += kFc)
        logit_terms<T, TQ, kFc>(acc, a, sR0, sR1, t0, s0, f0, fl, warp);
      for (int fl = w8; fl < w; ++fl) logit_terms<T, TQ, 1>(acc, a, sR0, sR1, t0, s0, f0, fl, warp);
    }
#pragma unroll
    for (int c = 0; c < kKeysPerThread; ++c) {
      const int s = s0 + warp + kWarps * c;
      if (s >= nT) break;
      const float m_s = m[s];
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const float m_t = m[min(t0 + i, nT - 1)];
        const float allowed = m_t * m_s + (1.f - m_t) * (1.f - m_s);
        sL[(i * nT + s) * kSites + lane] = allowed > 0.5f ? acc[c][i] : -FLT_MAX;
      }
    }
  }
  __syncthreads();

  // 2. Softmax over the keys of each (query frame, site), in place.
  for (int row = threadIdx.x; row < TQ * kSites; row += kThreads) {
    float* x = sL + (row / kSites) * nT * kSites + row % kSites;
    float mx = -FLT_MAX;
    for (int s = 0; s < nT; ++s) mx = fmaxf(mx, x[s * kSites]);
    float sum = 0.f;
    for (int s = 0; s < nT; ++s) {
      const float e = expf(x[s * kSites] - mx);
      x[s * kSites] = e;
      sum += e;
    }
    for (int s = 0; s < nT; ++s) x[s * kSites] = lfvdm::round_through(x[s * kSites] / sum, q);
  }

  // 3. Values: each warp takes 4 features of a chunk of 32, over all keys.
  T* const out_site = out + qkv + d;
  for (int f0 = 0; f0 < F; f0 += kChunk) {
    const int fw = f0 + warp * kFb;         // this warp's first feature
    const int fn = max(0, min(kFb, F - fw));  // how many of its 4 exist
    float acc[TQ][kFb];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < kFb; ++j) acc[i][j] = 0.f;
    for (int s0 = 0; s0 < nT; s0 += kChunk) {
      __syncthreads();  // the weights are written; the previous chunk's readers are done
      stage_rv<T, TQ>(sR0, a, t0, s0, f0);
      __syncthreads();
      const int sn = min(kChunk, nT - s0);
      if (fn == 0) continue;
      for (int sl = 0; sl < sn; ++sl) {
        const int s = s0 + sl;
        float vv[kFb];
#pragma unroll
        for (int j = 0; j < kFb; ++j)
          vv[j] = j < fn ? lfvdm::load_f32(a.v + s * fd + (long long)(fw + j) * D) : 0.f;
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          const float w = sL[(i * nT + s) * kSites + lane];
          const float4 r = *reinterpret_cast<const float4*>(sR0 + (i * kChunk + sl) * kChunk +
                                                           warp * kFb);
          const float rv[kFb] = {r.x, r.y, r.z, r.w};
#pragma unroll
          for (int j = 0; j < kFb; ++j) {
            acc[i][j] = fmaf(w, vv[j], acc[i][j]);
            acc[i][j] = fmaf(w, rv[j], acc[i][j]);
          }
        }
      }
    }
    if (!site_ok) continue;
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      if (t0 + i >= nT) break;
#pragma unroll
      for (int j = 0; j < kFb; ++j)
        if (j < fn) lfvdm::store_f32(out_site + (t0 + i) * fd + (long long)(fw + j) * D, acc[i][j]);
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

template <typename T, int TQ>
int launch_tq(const void* q, const void* k, const void* v, const void* r_k, const void* r_q_t,
              const void* r_v_t, const float* mask, void* out, int B, int H, int nT, int F, int D,
              cudaStream_t stream) {
  const int smem = smem_floats(TQ, nT) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(temporal_rpe_attention_kernel<T, TQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (D + kSites - 1) / kSites;
  const int groups = (nT + TQ - 1) / TQ;
  temporal_rpe_attention_kernel<T, TQ><<<B * H * tiles * groups, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(r_k), static_cast<const T*>(r_q_t), static_cast<const T*>(r_v_t),
      mask, static_cast<T*>(out), H, nT, F, D, tiles, groups);
  return (int)cudaGetLastError();
}

// The largest TQ in {4, 2, 1} whose grid gives every SM a block and whose
// shared memory fits; else TQ = 1.
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* r_k, const void* r_q_t,
           const void* r_v_t, const float* mask, void* out, int B, int H, int nT, int F, int D,
           cudaStream_t stream) {
  const long long sites = (long long)B * H * ((D + kSites - 1) / kSites);
  const long long want = 1LL * sm_count();
  auto fits = [&](int tq) { return 4LL * smem_floats(tq, nT) <= kSmemPerBlock; };
  int tq = 1;
  if (fits(4) && sites * ((nT + 3) / 4) >= want)
    tq = 4;
  else if (fits(2) && sites * ((nT + 1) / 2) >= want)
    tq = 2;
  if (!fits(tq) || sites * nT > INT_MAX) return (int)cudaErrorInvalidValue;
  switch (tq) {
    case 4: return launch_tq<T, 4>(q, k, v, r_k, r_q_t, r_v_t, mask, out, B, H, nT, F, D, stream);
    case 2: return launch_tq<T, 2>(q, k, v, r_k, r_q_t, r_v_t, mask, out, B, H, nT, F, D, stream);
    default: return launch_tq<T, 1>(q, k, v, r_k, r_q_t, r_v_t, mask, out, B, H, nT, F, D, stream);
  }
}

}  // namespace

// The most frames the kernel takes: its logits and r-table chunks in shared
// memory at TQ = 1.
extern "C" int lfvdm_temporal_rpe_attention_max_frames() {
  return (kSmemPerBlock / (int)sizeof(float) - smem_floats(1, 0)) / kSites;
}

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int lfvdm_temporal_rpe_attention(int dtype, const void* q, const void* k,
                                            const void* v, const void* r_k, const void* r_q_t,
                                            const void* r_v_t, const void* mask, void* out, int B,
                                            int H, int T, int F, int D, void* stream) {
  if (T < 1 || F < 1 || D < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfvdm::kFloat32)
    return launch<float>(q, k, v, r_k, r_q_t, r_v_t, m, out, B, H, T, F, D, s);
  if (dtype == lfvdm::kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, r_k, r_q_t, r_v_t, m, out, B, H, T, F, D, s);
  return (int)cudaErrorInvalidValue;
}
