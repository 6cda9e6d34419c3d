// The scalar block-tile GEMM mainloop of the float32 (oracle) arms of the
// conv kernels (convfuse.cu) and the FFN (ffn.cu), each followed by its own
// epilogue, and the mma.sync tile product of the raw-audio conv kernel.
// (The bf16 GEMMs run on wgmma: wgmma_gemm.cuh, convfuse.cu.)
//
// SimtGemm: a block computes the tile C[m0 : m0+BM, n0 : n0+BN] of
// C = A . B^T with float32 sums:
//   A: rows m of K elements, K contiguous; row m starts at
//      W2vRows::offset(m) (a batch-major overlapping view is allowed, which
//      is how a strided conv reads its input as GEMM rows without a copy);
//      rows m >= M read as zero, so a ragged last row tile needs no padding;
//   B: [N, K], K contiguous (a torch.nn.Linear weight, or a conv weight
//      permuted to [O, k*C]).
// Scalar FMAs, an outer product of TM x TN values per thread over tiles of
// 16 K-steps, single buffered.  After run(), for_each(f) visits the block's
// sums as f(row, col, value), row and col relative to the tile.

#pragma once

#include "common.cuh"

// Row addressing of an A operand: row m lives at
//   (m / rows_per_batch) * batch_stride + (m % rows_per_batch) * row_stride
struct W2vRows {
  long long rows_per_batch;
  long long batch_stride;
  long long row_stride;
  __device__ __forceinline__ long long offset(long long m) const {
    return (m / rows_per_batch) * batch_stride +
           (m % rows_per_batch) * row_stride;
  }
};

// d += a . b for one 16x8x16 bf16 tile, float32 accumulate
__device__ __forceinline__ void w2v_mma_bf16(float (&d)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM, int BN, int TM, int TN>
struct SimtGemm {
  static constexpr int kBM = BM;
  static constexpr int kBN = BN;
  static constexpr int kMinBlocks = 1;
  static constexpr int kThreads = 256;
  static constexpr int kBK = 16;
  static constexpr int kTX = BN / TN;  // threads along N
  static constexpr int kTY = BM / TM;
  static constexpr int kBMp = BM + 4;  // padded shared rows (floats)
  static constexpr int kBNp = BN + 4;
  static constexpr int kSmemBytes = kBK * (kBMp + kBNp) * 4;
  static constexpr int kACh = BM * 4 / kThreads;  // float4 loads a thread
  static constexpr int kBCh = BN * 4 / kThreads;  // makes per tile
  static constexpr int kKAlign = kBK;
  static_assert(kTX * kTY == kThreads, "thread layout");
  static_assert(kACh >= 1 && kBCh >= 1, "loads");

  float acc[TM][TN];

  __device__ __forceinline__ void run(const float* A, W2vRows arows,
                                      long long M, const float* B,
                                      long long ldb, int K, long long m0,
                                      int n0, unsigned char* smem_raw) {
    float* As = reinterpret_cast<float*>(smem_raw);  // [kBK][kBMp]
    float* Bs = As + kBK * kBMp;                      // [kBK][kBNp]
    const int tid = threadIdx.x;
    const int tx = tid % kTX;
    const int ty = tid / kTX;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    const int kc = (tid & 3) * 4;
    const int r0 = tid >> 2;
    const float* a_src[kACh];
    bool a_ok[kACh];
#pragma unroll
    for (int i = 0; i < kACh; ++i) {
      const long long m = m0 + r0 + i * (kThreads / 4);
      a_ok[i] = m < M;
      a_src[i] = A + (a_ok[i] ? arows.offset(m) : 0) + kc;
    }
    const float* b_src = B + (long long)(n0 + r0) * ldb + kc;

    for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
      for (int i = 0; i < kACh; ++i) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (a_ok[i]) v = *reinterpret_cast<const float4*>(a_src[i] + k0);
        const int r = r0 + i * (kThreads / 4);
        As[(kc + 0) * kBMp + r] = v.x;
        As[(kc + 1) * kBMp + r] = v.y;
        As[(kc + 2) * kBMp + r] = v.z;
        As[(kc + 3) * kBMp + r] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kBCh; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            b_src + (long long)i * (kThreads / 4) * ldb + k0);
        const int r = r0 + i * (kThreads / 4);
        Bs[(kc + 0) * kBNp + r] = v.x;
        Bs[(kc + 1) * kBNp + r] = v.y;
        Bs[(kc + 2) * kBNp + r] = v.z;
        Bs[(kc + 3) * kBNp + r] = v.w;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[k * kBMp + ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[k * kBNp + tx + kTX * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  template <class F>
  __device__ __forceinline__ void for_each(F&& f) const {
    const int tx = threadIdx.x % kTX;
    const int ty = threadIdx.x / kTX;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) f(ty * TM + i, tx + kTX * j, acc[i][j]);
  }
};
