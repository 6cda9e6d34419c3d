// The bf16 row kernels' shared pieces (layernorm.cu: K1/K2;
// layernorm_bwd.cu: K9): a warp a row, each lane 8 consecutive columns of
// every 256-column pass as one 16-byte access where the chunk is whole and
// the row 16-byte aligned, else (the masked tail) in 8-, 4- or 2-byte
// accesses as the row's alignment allows; float32 parameters in registers.
#pragma once

#include "common.cuh"

constexpr int kLnChunk = 8;               // bf16 columns a lane owns a pass
constexpr int kLnPass = 32 * kLnChunk;    // columns a pass: 256

__device__ __forceinline__ uint4 ln_ldg16(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ float ln_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float ln_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// columns [c0, c0 + 8) of a row that lie below h: all 8 where the pass is
// whole, else 0..8 (the masked tail)
__device__ __forceinline__ int ln_valid(int c0, int h) {
  return min(max(h - c0, 0), kLnChunk);
}

// 8 float32 parameters at p[c0 ..], zero past h
template <bool TAIL>
__device__ __forceinline__ void ln_param(const float* __restrict__ p, int c0,
                                         int h, float (&v)[kLnChunk]) {
  if (!TAIL || ln_valid(c0, h) == kLnChunk) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p + c0));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p + c0) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kLnChunk; ++j) v[j] = c0 + j < h ? __ldg(p + c0 + j)
                                                         : 0.f;
  }
}

// A chunk with fewer than 8 columns below h, or any chunk of a row that is
// not 16-byte aligned (h not a multiple of 8), in the widest accesses the
// row's alignment allows: 8 bytes where h % 4 == 0, 4 where h is even,
// else 2 (n, the chunk's columns below h, is a multiple of that width).
__device__ __forceinline__ uint4 ln_load_part(const __nv_bfloat16* p, int n,
                                              int h) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if ((h & 3) == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (4 * k < n) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + k);
        w[2 * k] = v.x;
        w[2 * k + 1] = v.y;
      }
  } else if ((h & 1) == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (2 * k < n) w[k] = __ldg(reinterpret_cast<const unsigned*>(p) + k);
  } else {
    const unsigned short* e = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int j = 0; j < kLnChunk; ++j)
      if (j < n) w[j / 2] |= (uint32_t)__ldg(e + j) << (16 * (j & 1));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void ln_store_part(__nv_bfloat16* p, int n, int h,
                                              const float (&y)[kLnChunk]) {
  if ((h & 3) == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (4 * k < n)
        reinterpret_cast<uint2*>(p)[k] =
            make_uint2(w2v_pack_bf16(y[4 * k], y[4 * k + 1]),
                       w2v_pack_bf16(y[4 * k + 2], y[4 * k + 3]));
  } else if ((h & 1) == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (2 * k < n)
        reinterpret_cast<uint32_t*>(p)[k] =
            w2v_pack_bf16(y[2 * k], y[2 * k + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < kLnChunk; ++j)
      if (j < n) w2v_store(p + j, y[j]);
  }
}

// one lane's chunks of row r (zeros past h, nothing past the last row)
template <int PASSES, bool TAIL>
__device__ __forceinline__ void ln_load_row(const __nv_bfloat16* x,
                                            long long r, long long rows,
                                            int h, int lane,
                                            uint4 (&buf)[PASSES]) {
  if (r >= rows) return;
  const __nv_bfloat16* xr = x + r * h;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int c0 = p * kLnPass + lane * kLnChunk;
    if (!TAIL || ((h & 7) == 0 && c0 + kLnChunk <= h))
      buf[p] = ln_ldg16(xr + c0);
    else
      buf[p] = ln_load_part(xr + c0, ln_valid(c0, h), h);
  }
}


// element j of a chunk of 8 packed bf16 (j a compile-time constant)
__device__ __forceinline__ float ln_elem(const uint4& v, int j) {
  const uint32_t w = j < 2 ? v.x : j < 4 ? v.y : j < 6 ? v.z : v.w;
  return (j & 1) ? ln_hi(w) : ln_lo(w);
}
