// Scalar helpers shared by the attention kernels: every load widens to f32,
// every store rounds from f32, so one template body serves float and bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lfvdm {

// dtype codes passed from Python (ops/attention.py: _DTYPE_CODES).
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Round an f32 value through the storage type and back (a no-op for f32).
__device__ __forceinline__ float round_through(float x, const float*) { return x; }
__device__ __forceinline__ float round_through(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

}  // namespace lfvdm
