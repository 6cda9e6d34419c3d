// Split-TF32 ("3xTF32") tensor-core products in float32, and the cp.async
// tile loads, of the float32 attention kernels (attention.cu,
// attention_bwd.cu); the split and the loads also of the float32 GEMM
// mainloop (gemm.cuh), whose products run on wgmma.
//
// A float32 x is split as x = hi + lo: hi is x rounded to TF32 (10 mantissa
// bits; to nearest, ties away from zero, as cvt.rna.tf32.f32 rounds), and
// lo is x - hi, which float32 holds exactly, rounded the same way.  Then
//   a b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b
// with three mma.sync.m16n8k8 TF32 products into one float32 accumulator,
// the two small cross terms first and hi hi last (CUTLASS's 3xTF32 order).
// The dropped lo_a lo_b and the rounding of lo sit near 2^-22 of |a b|,
// within a few float32 ulps, so the products keep float32's accuracy at
// three TF32 products' cost: 495/3 TFLOP/s of tensor-core peak on the
// H100 against the 67 of its scalar float32 pipes.
//
// Fragments of mma.m16n8k8 (PTX ISA), lane = 4 g + t:
//   A (16 x 8, row): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, col):  b0 (k = t, n = g), b1 (k = t+4, n = g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// A k-step may take its 8 k indices in any order, the same in A and B.
#pragma once

#include <stdint.h>

// hi and lo of x as TF32 bit patterns (the low 13 bits clear): adding half
// a TF32 ulp to the bits and clearing the low 13 rounds the magnitude to
// nearest with ties away, a carry moving into the exponent as it should
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct Tf32A {
  uint32_t hi[4], lo[4];
};
struct Tf32B {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - __uint_as_float(hi));
}

// an A fragment from its four values a0..a3
__device__ __forceinline__ Tf32A tf32_a(float a0, float a1, float a2,
                                        float a3) {
  Tf32A f;
  tf32_split(a0, f.hi[0], f.lo[0]);
  tf32_split(a1, f.hi[1], f.lo[1]);
  tf32_split(a2, f.hi[2], f.lo[2]);
  tf32_split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ Tf32B tf32_b(float b0, float b1) {
  Tf32B f;
  tf32_split(b0, f.hi[0], f.lo[0]);
  tf32_split(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void tf32_mma(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in split TF32
__device__ __forceinline__ void tf32_mma3(float (&c)[4], const Tf32A& a,
                                          const Tf32B& b) {
  tf32_mma(c, a.lo, b.hi);
  tf32_mma(c, a.hi, b.lo);
  tf32_mma(c, a.hi, b.hi);
}

// c = a b in split TF32, from a zero accumulator.  The tensor cores add
// into their float32 accumulator with truncation, so along a chain of
// products the rounding errors share a sign and grow with its length: a
// sum over ~1000 rows run through one accumulator misses float32's
// limits by a few times.  The kernels cut every sum into short partials,
// each begun here and added to its running sum by an IEEE add.
__device__ __forceinline__ void tf32_mma3_fresh(float (&c)[4],
                                                const Tf32A& a,
                                                const Tf32B& b) {
  const float z = 0.f;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a.lo[0]), "r"(a.lo[1]), "r"(a.lo[2]), "r"(a.lo[3]),
        "r"(b.hi[0]), "r"(b.hi[1]), "f"(z));
  tf32_mma(c, a.hi, b.lo);
  tf32_mma(c, a.hi, b.hi);
}

// The key (or query) a column of an 8-wide accumulator tile stands for:
// column n holds row kappa(n) = n ^ (n >> 2) of the streamed tile, i.e.
// columns 0..7 <- rows 0, 1, 2, 3, 5, 4, 7, 6.  Then the accumulator is,
// with no shuffle, the A fragment of the next product over those rows
// (a0 = c0, a1 = c2, a2 = c1, a3 = c3: k index t is row kappa(2t), t + 4
// is row kappa(2t + 1)), and with shared rows (D + kF32Pad) floats apart,
// a stride of 8 banks mod 32, both reads of a streamed tile are free of
// bank conflicts: the 64-bit B loads of rows kappa(g) (lanes of a
// half-warp hit rows whose strides differ mod 4), and the 32-bit B loads of
// the next product, rows kappa(2t) and kappa(2t + 1) at column 8 m + g.
__device__ __forceinline__ int tf32_kappa(int n) { return n ^ (n >> 2); }

// what the kernels need of an operand they read by cp.async: a
// 16-byte-aligned start and (batch, time, head) strides, in floats, of
// whole 16-byte units
inline bool tf32_rows_ok(const void* p, long long sb, long long st,
                         long long sh) {
  return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         sb % 4 == 0 && st % 4 == 0 && sh % 4 == 0;
}

// and of one they write as float pairs
inline bool tf32_pairs_ok(const void* p, long long sb, long long st,
                          long long sh) {
  return p != nullptr && reinterpret_cast<uintptr_t>(p) % 8 == 0 &&
         sb % 2 == 0 && st % 2 == 0 && sh % 2 == 0;
}

// 16 bytes global -> shared without registers; zeros where !valid (then
// nothing is read, and src only needs to be a valid address)
__device__ __forceinline__ void tf32_cp16(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void tf32_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void tf32_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + ROWS) of a [T, D] float32 operand (one batch and head,
// time stride st, rows from r0 + n on zero) into shared rows of RS floats
template <int D, int RS, int ROWS>
__device__ __forceinline__ void tf32_load_rows(float* dst, const float* src,
                                               long long st, int r0, int n) {
  constexpr int kChunks = D / 4;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks, c = idx % kChunks;
    const bool ok = r < n;
    tf32_cp16(dst + r * RS + 4 * c,
              ok ? src + (long long)(r0 + r) * st + 4 * c : src, ok);
  }
}

// the A fragment of k-step kk from 16 shared rows (row g and g + 8 of
// this lane, RS floats apart): k index t is column 8 kk + 2t, t + 4 is
// column 8 kk + 2t + 1 (one 64-bit load a row)
template <int RS>
__device__ __forceinline__ Tf32A tf32_a_rows(const float* rows16, int kk) {
  const int lane = threadIdx.x % 32;
  const float* p = rows16 + (lane / 4) * RS + 8 * kk + 2 * (lane % 4);
  const float2 x0 = *reinterpret_cast<const float2*>(p);
  const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * RS);
  return tf32_a(x0.x, x1.x, x0.y, x1.y);
}

// the B fragment of k-step kk against the 8-row block at rows8 (columns
// in kappa order): this lane's row kappa(g), columns 8 kk + 2t, + 1
template <int RS>
__device__ __forceinline__ Tf32B tf32_b_rows(const float* rows8, int kk) {
  const int lane = threadIdx.x % 32;
  const float2 y = *reinterpret_cast<const float2*>(
      rows8 + tf32_kappa(lane / 4) * RS + 8 * kk + 2 * (lane % 4));
  return tf32_b(y.x, y.y);
}

// the A fragment of an accumulator tile c whose columns are in kappa order
__device__ __forceinline__ Tf32A tf32_a_acc(const float (&c)[4]) {
  return tf32_a(c[0], c[2], c[1], c[3]);
}

// the B fragment of the product (accumulator, kappa order) x (8 shared
// rows of RS floats) at output columns 8 m .. 8 m + 7: rows kappa(2t) and
// kappa(2t + 1), column 8 m + g
template <int RS>
__device__ __forceinline__ Tf32B tf32_b_cols(const float* rows8, int m) {
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const float* p = rows8 + 8 * m + lane / 4;
  return tf32_b(p[tf32_kappa(2 * t) * RS], p[tf32_kappa(2 * t + 1) * RS]);
}
