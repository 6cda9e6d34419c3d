// Shared helpers of the hand-written kernels: element loads and stores in
// float32 or bfloat16 with float32 arithmetic, warp reductions, and the
// key-tile schedule of the attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// two float32 values as one packed bf16 pair (lo in the low half)
__device__ __forceinline__ uint32_t w2v_pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The key tiles a CTA visits, into tiles[0 .. *count): those that hold a
// valid key, or all of them when the batch row has none.  mask_s gets the
// row's mask bytes (1 = valid).  Ends with the block synchronised.
__device__ __forceinline__ void w2v_key_tiles(const unsigned char* mrow,
                                              int tk, int bk,
                                              unsigned char* mask_s,
                                              unsigned char* flag_s,
                                              int* count, int* tiles) {
  const int ntiles = (tk + bk - 1) / bk;
  for (int j = threadIdx.x; j < tk; j += blockDim.x)
    mask_s[j] = mrow == nullptr || mrow[j] != 0;
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < ntiles; i += blockDim.x / 32) {
    bool any = false;
    for (int j = i * bk + lane; j < min(tk, (i + 1) * bk); j += 32)
      any |= mask_s[j] != 0;
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) flag_s[i] = any;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int i = 0; i < ntiles; ++i)
      if (flag_s[i]) tiles[n++] = i;
    if (n == 0)
      for (; n < ntiles; ++n) tiles[n] = n;
    *count = n;
  }
  __syncthreads();
}
