// The split-TF32 block-tile GEMM mainloop of the float32 arms of the conv
// kernels (convfuse.cu) and the FFN (ffn.cu), each followed by its own
// epilogue, and the mma.sync tile product of the raw-audio conv kernel.
// (The bf16 GEMMs run on wgmma: wgmma_gemm.cuh, convfuse.cu.)
//
// Tf32Gemm: a block of two warpgroups computes the tile C[m0 : m0+128,
// n0 : n0+BN] of C = A . B^T in float32 on the tensor cores (wgmma
// m64nBNk8 in TF32, a warpgroup 64 rows):
//   A: rows m of K float32 elements, K contiguous; row m starts at
//      W2vRows::offset(m) (a batch-major overlapping view is allowed, which
//      is how a strided conv reads its input as GEMM rows without a copy);
//      rows m >= M read as zero, so a ragged last row tile needs no padding;
//   B: [N, K], K contiguous (a torch.nn.Linear weight, or a conv weight
//      permuted to [O, k*C]), given split: bhi and blo, the TF32 hi and lo
//      parts of each element (tf32_split_kernel, once a call).
// Each product a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b (tf32.cuh):
// A's fragments are read from shared memory into registers and split there
// (once per fragment), B's hi and lo tiles are wgmma's shared operands.  The
// tensor cores' float32 accumulation truncates, so the sum over K is a
// chain of fresh partials of STEPS k-steps (8 K each), the first wgmma of
// each with scale-d = 0, added to the running sums by IEEE adds in k order
// once the partial's wgmma group has retired: the running sums double the
// accumulator (BN / 2 + BN / 2 floats a thread).
//
// Loads: every thread starts cp.async copies (16 bytes, no registers)
// through a ring of STAGES stages of 32 K each; a shared tile is [rows][32]
// floats in wgmma's 128-byte swizzle (row r's 16-byte chunk c at c ^ r % 8,
// 8-row atoms of 1024 bytes), which also keeps the A fragments' reads free
// of bank conflicts.  A stage's copies are made visible to wgmma (the async
// proxy) by a proxy fence before the block's barrier.  After run(),
// for_each(f) visits the block's sums as f(row, col, v0, v1), the values of
// columns col and col + 1, row and col relative to the tile.

#pragma once

#include "common.cuh"
#include "hopper.cuh"
#include "tf32.cuh"

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

namespace {  // each source that includes this file has its own copy

// hi[i], lo[i] = the TF32 split of x[i] (tf32.cuh), i < n: the B operands
// of Tf32Gemm, split once a call
__global__ void __launch_bounds__(256)
tf32_split_kernel(const float* __restrict__ x, float* __restrict__ hi,
                  float* __restrict__ lo, long long n) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += 256LL * gridDim.x) {
    uint32_t h, l;
    tf32_split(x[i], h, l);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(l);
  }
}

int launch_tf32_split(const float* x, float* hi, float* lo, long long n,
                      cudaStream_t stream) {
  const long long blocks = (n + 255) / 256;
  tf32_split_kernel<<<(unsigned)(blocks < 1024 ? blocks : 1024), 256, 0,
                      stream>>>(x, hi, lo, n);
  return (int)cudaGetLastError();
}

}  // namespace

template <int BN, int STAGES, int STEPS>
struct Tf32Gemm {
  static constexpr int kBM = 128;  // two warpgroups of 64 rows
  static constexpr int kBN = BN;
  static constexpr int kBK = 32;   // K a stage: a 128-byte swizzle row
  static constexpr int kThreads = 256;
  static constexpr int kAcc = BN / 2;  // sums a thread
  static constexpr int kAFloats = kBM * kBK;
  static constexpr int kBFloats = BN * kBK;
  static constexpr int kStageFloats = kAFloats + 2 * kBFloats;  // A, hi, lo
  // the stages, and 1024 bytes to align them to the swizzle's atom
  static constexpr int kSmemBytes = STAGES * kStageFloats * 4 + 1024;
  static constexpr int kPass = kThreads / 8;  // rows a pass of the copies
  static constexpr int kALoads = kBM / kPass;
  static constexpr int kBLoads = BN / kPass;
  static_assert(BN == 64 || BN == 128, "wgmma N");
  static_assert(STAGES >= 3 && (kBK / 8) % STEPS == 0, "ring, partials");

  float sum[kAcc];

  // the float offset of (row, 16-byte chunk) in a [rows][kBK] shared tile
  static __device__ __forceinline__ int swz(int row, int chunk) {
    return row * kBK + ((chunk ^ (row & 7)) << 2);
  }

  // K a multiple of kBK; A's rows, bhi and blo 16-byte aligned
  __device__ __forceinline__ void run(const float* A, W2vRows arows,
                                      long long M, const float* bhi,
                                      const float* blo, long long ldb, int K,
                                      long long m0, int n0,
                                      unsigned char* smem_raw) {
    float* smem = reinterpret_cast<float*>(hop_align1024(smem_raw));
    const int tid = threadIdx.x;
    const int c = tid % 8, r0 = tid / 8;
    const float* a_src[kALoads];
    bool a_ok[kALoads];
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      const long long m = m0 + r0 + i * kPass;
      a_ok[i] = m < M;
      a_src[i] = A + (a_ok[i] ? arows.offset(m) : 0) + 4 * c;
    }
    const long long b_off = (long long)(n0 + r0) * ldb + 4 * c;
    auto load = [&](int slot, int k0) {
      float* as = smem + slot * kStageFloats;
      float* bh = as + kAFloats;
      float* bl = bh + kBFloats;
#pragma unroll
      for (int i = 0; i < kALoads; ++i)
        tf32_cp16(as + swz(r0 + i * kPass, c), a_src[i] + k0, a_ok[i]);
#pragma unroll
      for (int i = 0; i < kBLoads; ++i) {
        const long long o = b_off + (long long)i * kPass * ldb + k0;
        tf32_cp16(bh + swz(r0 + i * kPass, c), bhi + o, true);
        tf32_cp16(bl + swz(r0 + i * kPass, c), blo + o, true);
      }
    };

#pragma unroll
    for (int e = 0; e < kAcc; ++e) sum[e] = 0.f;
    // this thread's A rows: g and g + 8 of its warp's 16 in its
    // warpgroup's 64
    const int lane = tid % 32, t = lane % 4;
    const int ra = 64 * (tid / 128) + 16 * (tid / 32 % 4) + lane / 4;
    const int k_tiles = K / kBK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < k_tiles) load(s, s * kBK);
      tf32_cp_commit();
    }
    float part[kAcc];
    for (int kt = 0; kt < k_tiles; ++kt) {
      tf32_cp_wait<STAGES - 2>();
      hop_fence_async_smem();  // this thread's copies, to wgmma's proxy
      __syncthreads();  // stage kt has landed; kt - 1's slot is free
      const int next = kt + STAGES - 1;
      if (next < k_tiles) load(next % STAGES, next * kBK);
      tf32_cp_commit();
      const float* as = smem + (kt % STAGES) * kStageFloats;
      const float* bh = as + kAFloats;
      const float* bl = bh + kBFloats;
      // the stage's A fragments, split: k-step kk's k indices t and t + 4
      // are chunks 2 kk and 2 kk + 1 of the rows
      uint32_t ah[kBK / 8][4], al[kBK / 8][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        const float x[4] = {as[swz(ra, 2 * kk) + t],
                            as[swz(ra + 8, 2 * kk) + t],
                            as[swz(ra, 2 * kk + 1) + t],
                            as[swz(ra + 8, 2 * kk + 1) + t]};
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32_split(x[e], ah[kk][e], al[kk][e]);
      }
      hop_fence_regs(part);
      hop_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        const uint64_t dh = hop_desc_sw128(bh + 8 * kk, 16, 1024);
        const uint64_t dl = hop_desc_sw128(bl + 8 * kk, 16, 1024);
        hop_wgmma_tf32_rs<BN>(part, al[kk], dh, kk % STEPS != 0);
        hop_wgmma_tf32_rs<BN>(part, ah[kk], dl, 1);
        hop_wgmma_tf32_rs<BN>(part, ah[kk], dh, 1);
        if (kk % STEPS == STEPS - 1) {
          hop_wgmma_commit();
          hop_wgmma_wait<0>();
          hop_fence_regs(part);
#pragma unroll
          for (int e = 0; e < kAcc; ++e) sum[e] += part[e];
          if (kk + 1 < kBK / 8) hop_wgmma_fence();
        }
      }
    }
    tf32_cp_wait<0>();
  }

  // the tile row of sum[4 j + 2 h], and the tile column of sum[4 j]
  static __device__ __forceinline__ int row_of(int h) {
    const int lane = threadIdx.x % 32;
    return 64 * (threadIdx.x / 128) + 16 * (threadIdx.x / 32 % 4) +
           lane / 4 + 8 * h;
  }
  static __device__ __forceinline__ int col_of(int j) {
    return 8 * j + 2 * (threadIdx.x % 4);
  }

  template <class F>
  __device__ __forceinline__ void for_each(F&& f) const {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(row_of(h), col_of(j), sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
  }
};
