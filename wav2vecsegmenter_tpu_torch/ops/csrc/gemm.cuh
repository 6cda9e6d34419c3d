// Block-tile GEMM mainloops of the conv kernels (convfuse.cu) and of the
// FFN's float32 arm (ffn.cu), each followed by its own epilogue.  (The
// FFN's bf16 arm runs on wgmma_gemm.cuh.)
//
// A block computes the tile C[m0 : m0+BM, n0 : n0+BN] of C = A . B^T with
// float32 sums:
//   A: rows m of K elements, K contiguous; row m starts at
//      W2vRows::offset(m) (a batch-major overlapping view is allowed, which
//      is how a strided conv reads its input as GEMM rows without a copy);
//      rows m >= M read as zero, so a ragged last row tile needs no padding;
//   B: [N, K], K contiguous (a torch.nn.Linear weight, or a conv weight
//      permuted to [O, k*C]).
// After run(), for_each(f) visits the block's sums as f(row, col, value),
// row and col relative to the tile.
//
// TcGemm (bfloat16 operands): tensor cores through mma.sync m16n8k16 with
// float32 accumulators in registers; A and B tiles of BK K-steps go to
// shared memory through a ring of cp.async stages (16-byte copies, the
// out-of-range A rows zero-filled by the copy itself); ldmatrix feeds the
// fragments.  Shared-memory rows are BK + 8 bf16 (80 or 144 bytes), so the
// eight 16-byte row reads of one ldmatrix phase fall in distinct banks.
// SimtGemm (float32 operands, the f32 oracle arm): scalar FMAs, an outer
// product of TM x TN values per thread over tiles of 16 K-steps, single
// buffered.

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

__device__ __forceinline__ unsigned w2v_smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; `valid` false writes 16 zero bytes
__device__ __forceinline__ void w2v_cp_async16(void* smem, const void* gmem,
                                               bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   w2v_smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void w2v_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void w2v_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void w2v_ldmatrix_x4(unsigned (&r)[4],
                                                const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(w2v_smem_addr(smem)));
}

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

// BK: K per pipeline stage (32 or 64); MIN_BLOCKS: blocks an SM must hold
// (the kernels' __launch_bounds__, which caps the registers a thread)
template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES, int BK,
          int MIN_BLOCKS>
struct TcGemm {
  static constexpr int kBM = BM;
  static constexpr int kBN = BN;
  static constexpr int kMinBlocks = MIN_BLOCKS;
  static constexpr int kLds = BK + 8;  // shared-memory row, in bf16
  static constexpr int kCpr = BK / 8;  // 16-byte copies a row
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int kWTM = BM / WARPS_M;  // warp tile
  static constexpr int kWTN = BN / WARPS_N;
  static constexpr int kMI = kWTM / 16;      // mma tiles per warp tile
  static constexpr int kNI = kWTN / 8;
  static constexpr int kStage = (BM + BN) * kLds;  // bf16 per stage
  static constexpr int kSmemBytes = STAGES * kStage * 2;
  static constexpr int kACh = BM * kCpr / kThreads;  // 16-byte copies a
  static constexpr int kBCh = BN * kCpr / kThreads;  // thread makes a stage
  static constexpr int kKAlign = BK;                 // K must be a multiple
  static_assert(BK % 16 == 0 && kThreads % kCpr == 0, "stage depth");
  static_assert(kWTM % 16 == 0 && kWTN % 16 == 0, "warp tile");
  static_assert(kACh >= 1 && BM * kCpr % kThreads == 0, "A copies");
  static_assert(kBCh >= 1 && BN * kCpr % kThreads == 0, "B copies");
  static_assert(STAGES >= 2, "pipeline");

  float acc[kMI][kNI][4];

  __device__ __forceinline__ void run(const __nv_bfloat16* A, W2vRows arows,
                                      long long M, const __nv_bfloat16* B,
                                      long long ldb, int K, long long m0,
                                      int n0, unsigned char* smem_raw) {
    __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int wm = warp / WARPS_N;
    const int wn = warp % WARPS_N;
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    // copy c of a stage: tile row c / kCpr, 16-byte chunk c % kCpr of the
    // BK values; a thread's chunk is fixed and its rows step by
    // kThreads / kCpr
    constexpr int kRowStep = kThreads / kCpr;
    const int kc = (tid % kCpr) * 8;
    const int r0 = tid / kCpr;
    const __nv_bfloat16* a_src[kACh];
    bool a_ok[kACh];
#pragma unroll
    for (int i = 0; i < kACh; ++i) {
      const long long m = m0 + r0 + i * kRowStep;
      a_ok[i] = m < M;
      a_src[i] = A + (a_ok[i] ? arows.offset(m) : 0) + kc;
    }
    const __nv_bfloat16* b_src = B + (long long)(n0 + r0) * ldb + kc;

    auto load = [&](int slot, int kt) {
      __nv_bfloat16* st = smem + slot * kStage;
      const int k0 = kt * BK;
#pragma unroll
      for (int i = 0; i < kACh; ++i)
        w2v_cp_async16(st + (r0 + i * kRowStep) * kLds + kc,
                       a_src[i] + (a_ok[i] ? k0 : 0), a_ok[i]);
#pragma unroll
      for (int i = 0; i < kBCh; ++i)
        w2v_cp_async16(st + (BM + r0 + i * kRowStep) * kLds + kc,
                       b_src + (long long)i * kRowStep * ldb + k0, true);
    };

    const int KT = K / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < KT) load(s, s);
      w2v_cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      w2v_cp_async_wait<STAGES - 2>();
      __syncthreads();  // stage kt landed; stage kt-1 is free for refill
      const int pf = kt + STAGES - 1;
      if (pf < KT) load(pf % STAGES, pf);
      w2v_cp_async_commit();

      const __nv_bfloat16* As = smem + (kt % STAGES) * kStage;
      const __nv_bfloat16* Bs = As + BM * kLds;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        unsigned af[kMI][4];
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
          w2v_ldmatrix_x4(
              af[mi], As + (wm * kWTM + mi * 16 + (lane & 15)) * kLds + kk +
                          (lane >> 4) * 8);
#pragma unroll
        for (int nj = 0; nj < kNI / 2; ++nj) {
          // matrices: (n 0-7, k lo), (n 0-7, k hi), (n 8-15, k lo),
          // (n 8-15, k hi) of this pair of n8 tiles
          unsigned bq[4];
          w2v_ldmatrix_x4(
              bq, Bs + (wn * kWTN + nj * 16 + (lane >> 4) * 8 + (lane & 7)) *
                           kLds +
                      kk + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mi = 0; mi < kMI; ++mi) {
            w2v_mma_bf16(acc[mi][2 * nj], af[mi], bq[0], bq[1]);
            w2v_mma_bf16(acc[mi][2 * nj + 1], af[mi], bq[2], bq[3]);
          }
        }
      }
    }
    w2v_cp_async_wait<0>();
    __syncthreads();  // shared memory is free for the epilogue
  }

  template <class F>
  __device__ __forceinline__ void for_each(F&& f) const {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int row = (warp / WARPS_N) * kWTM + (lane >> 2);
    const int col = (warp % WARPS_N) * kWTN + (lane & 3) * 2;
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(row + mi * 16 + (e >> 1) * 8, col + ni * 8 + (e & 1),
            acc[mi][ni][e]);
  }
};

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
