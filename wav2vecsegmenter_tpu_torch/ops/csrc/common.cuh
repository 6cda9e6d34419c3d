// Shared helpers of the hand-written kernels: element loads and stores in
// float32 or bfloat16 with float32 arithmetic, and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// element-type codes passed from Python (ops/_build.dtype_code)
enum W2vDtype { W2V_F32 = 0, W2V_BF16 = 1 };

// a negative status means the C entry point refused its arguments
#define W2V_BAD_ARGS (-1)

__device__ __forceinline__ float w2v_load(const float* p) { return *p; }
__device__ __forceinline__ float w2v_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void w2v_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void w2v_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// round a float32 value through the element type (identity for float32)
__device__ __forceinline__ float w2v_round(float v, const float*) { return v; }
__device__ __forceinline__ float w2v_round(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// exact (erf) GELU in float32
__device__ __forceinline__ float w2v_gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float w2v_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
