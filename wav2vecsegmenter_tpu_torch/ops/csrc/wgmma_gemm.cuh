// Warp-specialised, persistent bf16 GEMM on Hopper's wgmma and TMA
// (sm_90a), the FFN's (ffn.cu), with the kernel's own epilogue.
//
// C = A . B^T with float32 sums:
//   A: [M, K] bf16, K contiguous (the FFN's input or hidden activation);
//   B: [N, K] bf16, K contiguous (a torch.nn.Linear weight).
// C is cut into BM x BN tiles, N tiles fastest (the CTAs in flight share
// A's row tiles and the whole weight stays in L2).  A grid of at most one
// CTA an SM walks them: CTA c takes tiles c, c + G, c + 2G, ... (G CTAs).
// Each CTA is a producer warpgroup and two consumer warpgroups:
//   * one producer thread streams the A [BM x 64] and B [BN x 64] boxes of
//     every K tile of the CTA's tiles, in order, by TMA (host-side tensor
//     maps, hopper.cuh hop_make_map; 128-byte swizzle; A rows past M arrive
//     as zeros) into a ring of STAGES stages with full/empty mbarriers;
//   * the consumer warpgroups take the CTA's tiles in turns (ping-pong):
//     while one runs its tile's mainloop (BM/64 m64nBNk16 wgmma a K step,
//     both operands from shared memory, one K tile's group kept in flight
//     while the next is issued), the other runs the epilogue of its
//     previous tile (bias, GELU, the bf16 stores), so the tensor cores do
//     not wait for the epilogue.  A stage is freed once the group that read
//     it has retired.  The mainloops take turns through a pair of order
//     mbarriers: a warpgroup starts its tile's mainloop once the other has
//     passed every wait of its own, so no warpgroup waits on a stage more
//     than one use ahead of the stage's last completed use (the parity
//     waits could not tell the two apart).
// The producer hands its registers to the consumers (setmaxnreg); a
// consumer's accumulator is BM * BN / 128 floats a thread.

#pragma once

#include "hopper.cuh"

template <int BM, int BN, int STAGES>
struct WgGemm {
  static constexpr int kBM = BM;   // rows of a warpgroup's tile
  static constexpr int kBN = BN;
  static constexpr int kBK = 64;   // K-steps a stage: one swizzle row
  static constexpr int kKAlign = kBK;  // K must be a multiple
  static constexpr int kHalves = BM / 64;  // m64 wgmma a K step
  static constexpr int kConsumers = 256;
  static constexpr int kThreads = kConsumers + 128;  // + the producer group
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = 240;
  static constexpr int kABytes = BM * kBK * 2;
  static constexpr int kBBytes = BN * kBK * 2;
  static constexpr int kStage = kABytes + kBBytes;
  // full[STAGES], empty[STAGES], order[2] (order[w]: warpgroup w may run
  // its next mainloop)
  static constexpr int kBars = STAGES * kStage;
  static constexpr int kSmemBytes = 1024 + kBars + 16 * STAGES + 16;
  static_assert(BM == 64 || BM == 128, "warpgroup tile rows");
  static_assert(BN == 64 || BN == 128, "wgmma N");
  static_assert(kABytes % 1024 == 0 && kBBytes % 1024 == 0, "swizzle atoms");
  static_assert(STAGES >= 2 && kSmemBytes <= 227 * 1024, "shared memory");

  float acc[kHalves][BN / 2];

  static __device__ __forceinline__ uint64_t* full(unsigned char* smem) {
    return reinterpret_cast<uint64_t*>(smem + kBars);
  }
  static __device__ __forceinline__ uint64_t* empty(unsigned char* smem) {
    return full(smem) + STAGES;
  }
  static __device__ __forceinline__ uint64_t* order(unsigned char* smem) {
    return full(smem) + 2 * STAGES;
  }

  // thread 0, before a __syncthreads(): each stage is used by one consumer
  // warpgroup at a time
  static __device__ __forceinline__ void init(unsigned char* smem) {
    for (int s = 0; s < STAGES; ++s) {
      hop_mbar_init(&full(smem)[s], 1);
      hop_mbar_init(&empty(smem)[s], 128);
    }
    hop_mbar_init(&order(smem)[0], 128);
    hop_mbar_init(&order(smem)[1], 128);
    hop_mbar_init_fence();
  }

  // the producer thread: A and B boxes of every K tile of the CTA's tiles
  static __device__ __forceinline__ void produce(unsigned char* smem,
                                                 const CUtensorMap* amap,
                                                 const CUtensorMap* bmap,
                                                 int m_tiles, int n_tiles,
                                                 int k_tiles) {
    int g = 0;  // the CTA's K tiles so far, over all its tiles
    for (int t = blockIdx.x; t < m_tiles * n_tiles; t += gridDim.x) {
      const int m0 = (t / n_tiles) * BM, n0 = (t % n_tiles) * BN;
      for (int kt = 0; kt < k_tiles; ++kt, ++g) {
        const int s = g % STAGES;
        unsigned char* st = smem + s * kStage;
        hop_mbar_wait(&empty(smem)[s], ((g / STAGES) & 1) ^ 1);
        hop_mbar_expect_tx(&full(smem)[s], kStage);
        hop_tma_load_3d(st, amap, &full(smem)[s], kt * kBK, m0, 0);
        hop_tma_load_3d(st + kABytes, bmap, &full(smem)[s], kt * kBK, n0, 0);
      }
    }
  }

  // a consumer warpgroup: the CTA's tiles of its turn, each one's sums
  // handed to f(row, col, v0, v1) for the pairs (col, col + 1) of this
  // thread (row and col absolute, col even)
  template <class F>
  __device__ __forceinline__ void consume(unsigned char* smem, int m_tiles,
                                         int n_tiles, int k_tiles, F&& f) {
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    const int row = ((threadIdx.x % 128) / 32) * 16 + lane / 4;
    const int col = 2 * (lane % 4);
    int turn = wg;  // the CTA's tiles are taken in turns
    for (int t = blockIdx.x + wg * gridDim.x; t < m_tiles * n_tiles;
         t += 2 * gridDim.x, turn += 2) {
      const int m0 = (t / n_tiles) * BM, n0 = (t % n_tiles) * BN;
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[h][i] = 0.f;
      const int g0 = turn * k_tiles;
      // turn j > 0 waits for turn j - 1's mainloop (the other warpgroup's
      // ((j - 1) / 2)-th signal)
      if (turn > 0) hop_mbar_wait(&order(smem)[wg], ((turn - 1) / 2) & 1);
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int g = g0 + kt, s = g % STAGES;
        hop_mbar_wait(&full(smem)[s], (g / STAGES) & 1);
        const unsigned char* a_s = smem + s * kStage;
        const unsigned char* b_s = a_s + kABytes;
#pragma unroll
        for (int h = 0; h < kHalves; ++h) hop_fence_regs(acc[h]);
        hop_wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
          for (int h = 0; h < kHalves; ++h)
            hop_wgmma_ss<BN>(
                acc[h], hop_desc_sw128(a_s + h * 64 * 128 + kk * 32, 16, 1024),
                hop_desc_sw128(b_s + kk * 32, 16, 1024), 1);
        hop_wgmma_commit();
        // the group of the previous K tile has retired: its stage is free
        hop_wgmma_wait<1>();
#pragma unroll
        for (int h = 0; h < kHalves; ++h) hop_fence_regs(acc[h]);
        if (kt > 0) hop_mbar_arrive(&empty(smem)[(g - 1) % STAGES]);
      }
      hop_mbar_arrive(&order(smem)[wg ^ 1]);
      hop_wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < kHalves; ++h) hop_fence_regs(acc[h]);
      hop_mbar_arrive(&empty(smem)[(g0 + k_tiles - 1) % STAGES]);
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
#pragma unroll
        for (int i = 0; i < BN / 2; i += 2)
          f(m0 + h * 64 + row + 8 * ((i >> 1) & 1), n0 + col + 8 * (i / 4),
            acc[h][i], acc[h][i + 1]);
    }
  }
};
