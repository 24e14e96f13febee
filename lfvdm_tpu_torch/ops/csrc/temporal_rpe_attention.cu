// Two-group-masked RPE attention over the frames at each pixel site.
//
// Replaces lfvdm_tpu/ops/attention.py::_temporal_kernel (the Pallas kernel
// behind temporal_rpe_attention). Plain version and wrapper:
// lfvdm_tpu_torch/ops/attention.py.
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
//   attn = softmax_s(logit), rounded to the storage type
//   out[t, f] = sum_s attn[s] (v[s, f] + r_v_t[t, f, s])
//
// One thread owns one (query frame, site) pair. S <= 32, so the S logits
// live in registers and the softmax runs inside the thread. Neighbouring
// threads take neighbouring sites, so every q/k/v/out access of a warp is
// one contiguous run along D; the r tables do not depend on d, so all lanes
// of a warp read the same address and the load is a broadcast.
//
// Bound on the H100: at the flagship shapes (B·H = 8, T = 20, F = 96..128,
// D = 64..256) the work is ~1 GFLOP over ~30 MB, under the card's
// operations-per-byte balance, so the bound is bytes. The design reads each
// q/k/v element from device memory once per block and leans on L1 for the
// T-fold reuse of k and v across the query frames of a block; a faster
// version would stage k/v tiles in shared memory.

#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kMaxT = 32;   // frames; the wrapper rejects more
constexpr int kSites = 32;  // threadIdx.x: pixel sites
constexpr int kRows = 4;    // threadIdx.y: query frames

template <typename T>
__global__ void __launch_bounds__(kSites* kRows)
    temporal_rpe_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, const T* __restrict__ r_k,
                                  const T* __restrict__ r_q_t, const T* __restrict__ r_v_t,
                                  const float* __restrict__ mask, T* __restrict__ out,
                                  int H, int nT, int F, int D) {
  const int d = blockIdx.x * kSites + threadIdx.x;
  const int t = blockIdx.y * kRows + threadIdx.y;
  const int bh = blockIdx.z;
  if (d >= D || t >= nT) return;
  const int b = bh / H;

  const long long qkv_base = (long long)bh * nT * F * D;
  const long long fd = (long long)F * D;
  const T* q_t = q + qkv_base + t * fd + d;  // q_t[f * D]
  const T* k_b = k + qkv_base + d;           // k_b[s * F * D + f * D]
  const T* v_b = v + qkv_base + d;
  const long long r_base = ((long long)bh * nT + t) * nT * F;
  const T* rk_t = r_k + r_base;    // rk_t[s * F + f]
  const T* rq_t = r_q_t + r_base;  // rq_t[s * F + f]
  const T* rv_t = r_v_t + r_base;  // rv_t[f * S + s]

  // One key frame at a time, so that only the S logits stay live.
  float logit[kMaxT];
#pragma unroll
  for (int s = 0; s < kMaxT; ++s) {
    float acc = 0.f;
    if (s < nT) {
      const T* k_s = k_b + s * fd;
      const T* rk_ts = rk_t + s * F;
      const T* rq_ts = rq_t + s * F;
#pragma unroll 4
      for (int f = 0; f < F; ++f) {
        const float qf = lfvdm::load_f32(q_t + f * (long long)D);
        const float kf = lfvdm::load_f32(k_s + f * (long long)D);
        acc = fmaf(qf, kf, acc);
        acc = fmaf(qf, lfvdm::load_f32(rk_ts + f), acc);
        acc = fmaf(kf, lfvdm::load_f32(rq_ts + f), acc);
      }
    }
    logit[s] = acc;
  }

  // Two-group mask and softmax over s, all in registers.
  const float* m = mask + (long long)b * nT;
  const float m_t = m[t];
  float row_max = -FLT_MAX;
#pragma unroll
  for (int s = 0; s < kMaxT; ++s) {
    if (s < nT) {
      const float m_s = m[s];
      const float allowed = m_t * m_s + (1.f - m_t) * (1.f - m_s);
      if (!(allowed > 0.5f)) logit[s] = -FLT_MAX;
      row_max = fmaxf(row_max, logit[s]);
    }
  }
  float denom = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxT; ++s) {
    if (s < nT) {
      logit[s] = expf(logit[s] - row_max);
      denom += logit[s];
    }
  }
#pragma unroll
  for (int s = 0; s < kMaxT; ++s) {
    // The reference rounds the weights to the storage type before both
    // value products; do the same.
    if (s < nT) logit[s] = lfvdm::round_through(logit[s] / denom, q);
  }

  T* out_t = out + qkv_base + t * fd + d;
  for (int f = 0; f < F; ++f) {
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxT; ++s) {
      if (s < nT) {
        acc = fmaf(logit[s], lfvdm::load_f32(v_b + s * fd + f * (long long)D), acc);
        acc = fmaf(logit[s], lfvdm::load_f32(rv_t + f * nT + s), acc);
      }
    }
    lfvdm::store_f32(out_t + f * (long long)D, acc);
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const void* r_k, const void* r_q_t,
            const void* r_v_t, const float* mask, void* out, int B, int H, int nT, int F, int D,
            cudaStream_t stream) {
  const dim3 block(kSites, kRows);
  const dim3 grid((D + kSites - 1) / kSites, (nT + kRows - 1) / kRows, B * H);
  temporal_rpe_attention_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(r_k), static_cast<const T*>(r_q_t), static_cast<const T*>(r_v_t),
      mask, static_cast<T*>(out), H, nT, F, D);
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int lfvdm_temporal_rpe_attention(int dtype, const void* q, const void* k,
                                            const void* v, const void* r_k, const void* r_q_t,
                                            const void* r_v_t, const void* mask, void* out, int B,
                                            int H, int T, int F, int D, void* stream) {
  if (T < 1 || T > kMaxT || F < 1 || D < 1 || B * H < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lfvdm::kFloat32) {
    launch<float>(q, k, v, r_k, r_q_t, r_v_t, m, out, B, H, T, F, D, s);
  } else if (dtype == lfvdm::kBFloat16) {
    launch<__nv_bfloat16>(q, k, v, r_k, r_q_t, r_v_t, m, out, B, H, T, F, D, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
