// The SFC head's output layer at V = 1: out[r] = round(x[r, :] . w) + b.
//
// One warp a row.  Lane l reads the row in 16-byte chunks, chunk q = 32 p + l
// of pass p (columns [q * VEC, q * VEC + VEC), VEC = 8 bf16 or 4 float32
// elements), and accumulates x * w into one float32 sum in column order;
// the 32 lane sums then meet in a butterfly (xor 16, 8, 4, 2, 1).  The
// order of every addition is fixed by the column alone, never by the
// number of rows or where a row lies in the batch, so a row's result is the
// same bit for bit alone or in any batch.  cuBLAS at N = 1 picks its
// reduction by the problem's size, and a window's logit moved with its
// batch.
//
// Rounding points: those of the JAX head, ``h @ w.astype(dt) +
// b.astype(dt)``: the dot product in float32, rounded to the compute type,
// then the bias, in the compute type, added and rounded again.  In bf16 a
// product of two bf16 values is exact in float32, so the fused multiply-add
// rounds only the sum.
//
// Bound: bytes.  The rows are read once (14 x 999 rows of 1024 bf16 values,
// 28.6 MB, ~8.5 us at 3.35 TB/s); w (2 KB) stays in L1.  Each lane keeps
// h / (32 VEC) independent 16-byte loads in flight (4 at h = 1024 in bf16).
#include "common.cuh"

namespace {

constexpr int kRowWarps = 8;  // warps (rows) a block

template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
};

__device__ __forceinline__ float row_dot_chunk(const float* x, const float* w,
                                               float acc) {
  const float4 xv = __ldcs(reinterpret_cast<const float4*>(x));
  const float4 wv = __ldg(reinterpret_cast<const float4*>(w));
  acc = fmaf(xv.x, wv.x, acc);
  acc = fmaf(xv.y, wv.y, acc);
  acc = fmaf(xv.z, wv.z, acc);
  return fmaf(xv.w, wv.w, acc);
}

__device__ __forceinline__ float row_dot_chunk(const __nv_bfloat16* x,
                                               const __nv_bfloat16* w,
                                               float acc) {
  const uint4 xr = __ldcs(reinterpret_cast<const uint4*>(x));
  const uint4 wr = __ldg(reinterpret_cast<const uint4*>(w));
  const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&xr);
  const __nv_bfloat162* wv = reinterpret_cast<const __nv_bfloat162*>(&wr);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(xv[i]);
    const float2 b = __bfloat1622float2(wv[i]);
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
    row_dot_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ b, T* __restrict__ out,
                   long long rows, int h) {
  constexpr int kVec = Vec<T>::kN;
  const int lane = threadIdx.x % 32;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + row * h;
  const int chunks = h / kVec;
  float acc = 0.f;
  for (int q = lane; q < chunks; q += 32)
    acc = row_dot_chunk(xr + q * kVec, w + q * kVec, acc);
  acc = w2v_warp_sum(acc);
  if (lane == 0) {
    const T* tag = nullptr;
    w2v_store(out + row, w2v_round(acc, tag) + w2v_load(b));
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* out,
           long long rows, int h, cudaStream_t s) {
  const long long blocks = (rows + kRowWarps - 1) / kRowWarps;
  row_dot_kernel<T><<<static_cast<unsigned>(blocks), kRowWarps * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(out), rows, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [rows, h], w [h], b [1], out [rows], all of the element type ``dtype``;
// x and w 16-byte aligned, h a whole number of 16-byte chunks.
extern "C" int w2v_row_dot(const void* x, const void* w, const void* b,
                           void* out, long long rows, int h, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = dtype == W2V_BF16 ? 8 : 4;
  if (rows <= 0 || h <= 0 || h % vec ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return W2V_BAD_ARGS;
  if (dtype == W2V_F32) return launch<float>(x, w, b, out, rows, h, s);
  if (dtype == W2V_BF16)
    return launch<__nv_bfloat16>(x, w, b, out, rows, h, s);
  return W2V_BAD_ARGS;
}
