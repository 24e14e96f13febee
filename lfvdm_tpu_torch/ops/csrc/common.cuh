// Helpers shared by the kernels. Scalar loads widen to f32 and stores round
// from f32, so one template body serves float and bf16; the cp.async helpers
// serve the bf16 tensor-core loops.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace lfvdm {

// dtype codes passed from Python (ops/_common.py: _DTYPE_CODES).
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

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; valid = false
// fills the 16 bytes with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace lfvdm
