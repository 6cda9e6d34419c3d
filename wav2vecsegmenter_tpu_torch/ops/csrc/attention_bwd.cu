// Multi-head attention backward over key-padded windows, read through
// strides: dq, dk, dv from q, k, v, the key mask and the output gradient do.
//
// Replaces the Pallas kernel _attn_bwd_kernel of
// wav2vecsegmenter_tpu/ops/attention.py (the custom VJP of the SFC head's
// attention, and of the encoder's under fine-tuning).  Its arithmetic, with
// bias_j = 0 for a valid key and -1e30 for a padded one:
//   s_ij  = q_i . k_j * scale + bias_j                     (float32)
//   P_ij  = exp(s_ij - max_j s_ij) / sum_j exp(...)        (normalised, f32)
//   dP_ij = do_i . v_j,   delta_i = sum_j P_ij dP_ij
//   dS_ij = P_ij (dP_ij - delta_i)
//   dv_j  = sum_i T(P_ij) do_i
//   dq_i  = scale * sum_j T(dS_ij) k_j,  dk_j = scale * sum_i T(dS_ij) q_i
// where T() rounds to the input type (P and dS are cast before their
// products, as the TPU kernel does); every product accumulates in float32
// and dq, dk, dv are rounded to the input type once at the end.  (The
// forward kernel of attention.cu rounds the unnormalised probabilities
// instead; the backward follows the TPU backward.)
//
// Bound on the H100: operations.  The gradient recomputes the scores and
// dP: about 8 * T^2 * D FLOP per (batch, head) against O(T * D) bytes.
// No atomics, so the sums run in a fixed order and two runs give the same
// bits.  The TPU kernel walked query blocks in grid order and accumulated dK
// and dV in revisited output blocks; blocks on the card run in parallel, so
// the work splits by what each output sums over: a query-major kernel for
// dq, a key-major one for dk and dv.  Masked keys score -1e30, so a row
// whose keys are all masked gets a uniform finite P.  The TPU-only padding
// of the query axis to block_q = 256 and the [B,T,H,D] -> [B,H,T,D]
// transposes are not rebuilt: the kernels take (batch, time, head) strides.
// Two designs:
//
// bf16: three launches, seven products, all on wgmma (hopper.cuh).
//   0. The row statistics come from the forward: under grad, the forward
//      kernel (attention.cu) writes each query row's running max m (log2
//      units) and sum l at its end, so no kernel here sweeps the keys for
//      them.  attn_bwd_rows_kernel, a pre-pass, forms per query row
//      delta = do . o from the forward's bf16 output o and writes the rows
//      table (m, 1/l, delta, 0), one float4 a row.  (The TPU kernel takes
//      delta = sum_j P dP from float32 P; do . o differs from it by o's
//      bf16 rounding, and the CPU emulation of this schedule
//      (tests/test_torch_attention_tiles_bwd.py) meets the limits the
//      kernels are held to against the TPU kernel, so no float32 copy of
//      the output is kept.)
//   1. attn_bwd_dq_tc_kernel, one CTA per (batch, head, 128 query rows):
//      S = Q K^T and dP = dO V^T from shared memory, P and dS in registers
//      from the rows table, dQ += T(dS) K with dS as the register A
//      fragment: three products a key tile.  It visits only the key tiles
//      that hold a valid key (all of them when the batch row has none).
//   2. attn_bwd_dkdv_tc_kernel, one CTA per (batch, head, 128 key rows):
//      S^T = K Q^T and dP^T = V dO^T, P^T and dS^T from the statistics of
//      the tile's queries (broadcast along its columns), dV += T(P^T) dO and
//      dK += T(dS^T) Q: four products a query tile.  A CTA whose keys are
//      all masked, in a batch row with a valid key, writes zeros (P = 0
//      there exactly).
//   Each CTA is two consumer warpgroups of 64 own rows and a producer
//   warpgroup; one producer thread loads the own tiles once and streams the
//   other side (K/V, or Q/dO and their rows) through a two-stage ring by
//   TMA with full/empty mbarriers.  The operands have 4-D tensor maps over
//   [B, T, H, D] as they lie, the head dim innermost (128-byte swizzle,
//   boxes of 64 columns), so rows past T arrive as zeros, and so do the
//   columns past D of a box that reaches beyond the head (never the next
//   head's); the rows table has one over [B*H, Tq, 4] floats, whose zero
//   rows give P = 0.  The producer gives its registers to the consumers
//   (setmaxnreg), which hold S, dP and dq (or dk and dv) in float32: at
//   D=128 dk + dv are 128 floats a thread.  Streamed tiles: 128 rows at
//   D=64, 64 at D=96 and 128.  D=96 (the SFC head of a base model, 768 /
//   8, and the autoregressive segmenter's attention on one) runs D=128's
//   schedule over the padded width DP = 128: S and dP take the 96 real
//   columns (6 steps of k16), the dq, dk and dv products run at N = 128
//   over operands whose last 32 columns arrive as zeros, so those
//   accumulator columns stay zero, and the epilogues store the first 96
//   columns and no more (the gradient of a packed [B, T, 3, H, D]
//   projection holds the next head's columns right after them).  Under
//   tensor cores the dk/dv kernel's
//   recomputed scores need not equal the forward's bit for bit (another
//   summation order); the bf16 tolerances cover that.
// float32 (float32 training, and the float32 arms of every fidelity
//   check): the same three launches, on the tensor cores in split TF32
//   (tf32.cuh: x = hi + lo, both TF32, and a b = hi hi + hi lo + lo hi in
//   three mma.sync.m16n8k8 into a float32 accumulator; the dropped lo lo
//   term and lo's rounding are ~2^-22 of each product, a few float32 ulps,
//   so the gradients stay within the float32 limits, 1e-4 + 1e-5 relative,
//   of their plain version, which one TF32 product, 2^-11, would miss).
//   The bound is the products counted three times at the 495 TFLOP/s TF32
//   peak.  The row statistics come from the forward as in bf16: the float32
//   forward writes (m, l) under grad, attn_bwd_rows_f32_kernel forms
//   delta = do . o from its float32 output, and no kernel sweeps the keys
//   for them.  attn_bwd_dq_f32_kernel (one CTA of four warps per (batch,
//   head, 64 query rows), Q and dO in shared memory, K and V tiles of the
//   visited key tiles double-buffered by cp.async: S, dP, dQ += dS K, three
//   products a tile) and attn_bwd_dkdv_f32_kernel (64 key rows a CTA, K
//   and V in shared memory, Q, dO and the rows table of every query tile
//   streamed: S^T, dP^T, dV += P^T dO, dK += dS^T Q, four products a tile;
//   the all-masked key tile writes zeros) keep every sum in a fixed order,
//   without atomics.  Each warp owns 16 rows and reads a streamed tile
//   once for all of them; the accumulators of S and dP, whose columns are
//   rows of the streamed tile in the order kappa(n) = n ^ (n >> 2) within
//   each 8, are the A fragments of the next products with no shuffle
//   (tf32.cuh).  Streamed tiles: 32 rows at D=64, 16 at D=96 and 128,
//   where dk and dv alone are 128 floats a thread; D=96 runs 12 k-steps
//   over its own columns, unpadded.

#include <limits.h>
#include <math.h>

#include "hopper.cuh"
#include "tf32.cuh"

namespace {

constexpr int kTcBox = 64;  // columns of a bf16 TMA box (128 bytes)

// the width the bf16 route computes over: D rounded up to whole 64-column
// boxes (96 -> 128); the columns past D are zeros and never stored
template <int D>
__host__ __device__ constexpr int padded_dim() {
  return (D + kTcBox - 1) / kTcBox * kTcBox;
}

struct Strides {
  long long b, t, h;
};

// ---------------------------------------------------------------------------
// float32: split-TF32 mma.sync (tf32.cuh)
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 4;       // warps a CTA, 16 own rows each
constexpr int kF32Rows = 64;       // own rows a CTA (queries, or keys)
constexpr int kF32Stream64 = 32;   // streamed rows a tile, by head dim
constexpr int kF32Stream96 = 16;
constexpr int kF32Stream128 = 16;
constexpr int kF32Pad = 8;         // floats past D a shared row (8 banks)
constexpr int kF32Steps = 2;       // k-steps of a partial of S and dP
constexpr int kF32MinBlocks = 2;   // CTAs an SM: up to 255 registers
constexpr int kF32SmemMax = 227 * 1024;
constexpr int kF32RowsThreads = 256;  // the pre-pass: one warp a query row

template <int D>
struct F32Bwd {
  static_assert(D == 64 || D == 96 || D == 128, "head dim");
  static_assert(kF32Rows == 16 * kF32Warps, "16 rows a warp");
  static constexpr int BN =
      D == 64 ? kF32Stream64 : D == 96 ? kF32Stream96 : kF32Stream128;
  static constexpr int RS = D + kF32Pad;  // shared row stride (floats)
  // floats: the two own tiles (Q and dO, or K and V) at 0 and kOwn; stage
  // s at 2 kOwn + s kStage: two streamed tiles, then (dk/dv kernel) the
  // rows table of their queries, a float4 each
  static constexpr int kOwn = kF32Rows * RS;
  static constexpr int kStage = 2 * BN * RS + 4 * BN;
  // bytes: (dq kernel) the key-tile count and list, the per-tile flags
  // and the key mask row
  static constexpr int kCount = 4 * (2 * kOwn + 2 * kStage);
  static constexpr int kList = kCount + 16;
  static_assert(BN % 8 == 0 && D % (8 * kF32Steps) == 0, "whole partials");

  static constexpr long long kSmemDkdv = kCount;
  static long long smem_dq(int tk) {
    const long long ntiles = (tk + BN - 1) / BN;
    return kList + 4 * ntiles + ntiles + tk;
  }
};

// S = A B^T and dP = A' B'^T over the head dim for a warp's 16 own rows
// (a, a2: A and A' in shared memory) against NT 8-row blocks of a streamed
// tile (b, b2), columns in kappa order; each a sum of partials of
// kF32Steps k-steps (tf32_mma3_fresh)
template <int D, int NT, int RS>
__device__ __forceinline__ void f32_scores(float (&s)[NT][4],
                                           float (&dp)[NT][4],
                                           const float* a, const float* a2,
                                           const float* b, const float* b2) {
#pragma unroll
  for (int kk = 0; kk < D / 8; kk += kF32Steps) {
    float ps[NT][4], pd[NT][4];
#pragma unroll
    for (int u = 0; u < kF32Steps; ++u) {
      const Tf32A x = tf32_a_rows<RS>(a, kk + u);
      const Tf32A x2 = tf32_a_rows<RS>(a2, kk + u);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const Tf32B y = tf32_b_rows<RS>(b + 8 * j * RS, kk + u);
        const Tf32B y2 = tf32_b_rows<RS>(b2 + 8 * j * RS, kk + u);
        if (u == 0) {
          tf32_mma3_fresh(ps[j], x, y);
          tf32_mma3_fresh(pd[j], x2, y2);
        } else {
          tf32_mma3(ps[j], x, y);
          tf32_mma3(pd[j], x2, y2);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = kk == 0 ? ps[j][e] : s[j][e] + ps[j][e];
        dp[j][e] = kk == 0 ? pd[j][e] : dp[j][e] + pd[j][e];
      }
  }
}

// acc += the tile's product at output columns 8 i .. 8 i + 7: the split
// accumulator fragments a[j] (kappa order) against the streamed rows
// 8 j .. 8 j + 7 of b, one partial over the NT k-steps
template <int NT, int RS>
__device__ __forceinline__ void f32_add_tile(float (&acc)[4],
                                             const Tf32A (&a)[NT],
                                             const float* b, int i) {
  float c[4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const Tf32B y = tf32_b_cols<RS>(b + 8 * j * RS, i);
    if (j == 0)
      tf32_mma3_fresh(c, a[j], y);
    else
      tf32_mma3(c, a[j], y);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += c[e];
}

// The pre-pass: per query row, delta = do . o (float32, o the forward's
// float32 output) beside the forward's statistics, as rows[b, h, t] =
// (m, 1/l, delta, 0).  One warp a row, rows in (b, t, h) order.
template <int D>
__global__ void __launch_bounds__(kF32RowsThreads)
attn_bwd_rows_f32_kernel(const float* __restrict__ o,
                         const float* __restrict__ dout,
                         const float2* __restrict__ stats,
                         float4* __restrict__ rows, long long n_rows, int tq,
                         int heads, Strides os, Strides dos) {
  const long long w = (long long)blockIdx.x * (kF32RowsThreads / 32) +
                      threadIdx.x / 32;
  if (w >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const int h = (int)(w % heads);
  const long long bt = w / heads;
  const int t = (int)(bt % tq);
  const long long b = bt / tq;
  const float* op = o + b * os.b + t * os.t + h * os.h;
  const float* dp = dout + b * dos.b + t * dos.t + h * dos.h;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc += op[c] * dp[c];
  acc = w2v_warp_sum(acc);
  if (lane == 0) {
    const long long i = (b * heads + h) * tq + t;
    const float2 st = stats[i];
    rows[i] = make_float4(st.x, 1.f / st.y, acc, 0.f);
  }
}

// dq: one CTA per (batch, head, 64 query rows), warp w owning rows
// q0 + 16 w .. + 15 (a lane rows g and g + 8); Q and dO stay in shared
// memory, K and V tiles of the visited key tiles stream through two
// cp.async stages.  Per tile:
//   S = Q K^T, dP = dO V^T            (split TF32; columns in kappa order)
//   P = exp2(S c + bias - m) / l,  dS = P (dP - delta)      (registers)
//   dQ += dS K                        (dS, split, is the A fragment)
template <int D>
__global__ void __launch_bounds__(kF32Warps * 32, kF32MinBlocks)
attn_bwd_dq_f32_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const unsigned char* __restrict__ key_mask,
                       const float* __restrict__ dout,
                       const float4* __restrict__ rows,
                       float* __restrict__ dq, int tq, int tk, Strides qs,
                       Strides ks, Strides vs, Strides dos, Strides dqs,
                       float scale_log2, float scale) {
  using L = F32Bwd<D>;
  constexpr int BN = L::BN, RS = L::RS;
  constexpr int NT = BN / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char f32_smem[];
  float* q_s = reinterpret_cast<float*>(f32_smem);
  float* do_s = q_s + L::kOwn;
  float* str_s = q_s + 2 * L::kOwn;
  int* count = reinterpret_cast<int*>(f32_smem + L::kCount);
  int* tiles = reinterpret_cast<int*>(f32_smem + L::kList);
  const int ntiles = (tk + BN - 1) / BN;
  unsigned char* flag_s = f32_smem + L::kList + 4 * ntiles;
  unsigned char* mask_s = flag_s + ntiles;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kF32Rows;
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  tf32_load_rows<D, RS, kF32Rows>(q_s, q + b * qs.b + h * qs.h, qs.t, q0,
                                  tq - q0);
  tf32_load_rows<D, RS, kF32Rows>(do_s, dout + b * dos.b + h * dos.h, dos.t,
                                  q0, tq - q0);
  tf32_cp_commit();
  w2v_key_tiles(key_mask ? key_mask + (long long)b * tk : nullptr, tk, BN,
                mask_s, flag_s, count, tiles);
  const int n = *count;
  auto load_kv = [&](int it) {
    float* st = str_s + (it % 2) * L::kStage;
    const int k0 = tiles[it] * BN;
    tf32_load_rows<D, RS, BN>(st, kb, ks.t, k0, tk - k0);
    tf32_load_rows<D, RS, BN>(st + BN * RS, vb, vs.t, k0, tk - k0);
  };
  load_kv(0);
  tf32_cp_commit();

  // this lane's rows: (m, 1/l, delta); rows past tq get P = 0
  float m[2], il[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const float4 rw = row < tq ? rows[((long long)b * heads + h) * tq + row]
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    m[r] = rw.x;
    il[r] = rw.y;
    dl[r] = rw.z;
  }
  float acc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const float* q_w = q_s + warp * 16 * RS;
  const float* do_w = do_s + warp * 16 * RS;

  for (int it = 0; it < n; ++it) {
    if (it + 1 < n) load_kv(it + 1);
    tf32_cp_commit();
    tf32_cp_wait<1>();
    __syncthreads();
    const float* k_s = str_s + (it % 2) * L::kStage;
    const float* v_s = k_s + BN * RS;

    float s[NT][4], dp[NT][4];
    f32_scores<D, NT, RS>(s, dp, q_w, do_w, k_s, v_s);

    // dS = P (dP - delta), into s
    const int k0 = tiles[it] * BN;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + tf32_kappa(2 * t + (e & 1));
        const int r = e >> 1;
        const float bias =
            key < tk ? (mask_s[key] ? 0.f : -1e30f) : -INFINITY;
        const float p = exp2f(s[j][e] * scale_log2 + bias - m[r]) * il[r];
        s[j][e] = p * (dp[j][e] - dl[r]);
      }

    // dQ += dS K, the tile's one partial: k-step j over its keys 8 j .. + 7
    Tf32A da[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) da[j] = tf32_a_acc(s[j]);
#pragma unroll
    for (int i = 0; i < NO; ++i) f32_add_tile<NT, RS>(acc[i], da, k_s, i);
    __syncthreads();  // the stage is consumed before it is refilled
  }

  float* ob = dq + b * dqs.b + h * dqs.h + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= tq) continue;
    float* orow = ob + (long long)row * dqs.t;
#pragma unroll
    for (int i = 0; i < NO; ++i)
      *reinterpret_cast<float2*>(orow + 8 * i) =
          make_float2(acc[i][2 * r] * scale, acc[i][2 * r + 1] * scale);
  }
}

// rows r0 + g, r0 + g + 8 (this lane's) below n of a [16, D] warp
// accumulator to dst through its time stride, times `mul`, as float pairs
template <int D>
__device__ __forceinline__ void f32_store_rows(float* dst, long long st,
                                               const float (&acc)[D / 8][4],
                                               int r0, int n, float mul) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + lane / 4 + 8 * r;
    if (row >= n) continue;
    float* p = dst + (long long)row * st + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(p + 8 * i) =
          make_float2(acc[i][2 * r] * mul, acc[i][2 * r + 1] * mul);
  }
}

// dk/dv: one CTA per (batch, head, 64 key rows), warp w owning keys
// k0 + 16 w .. + 15; K and V stay in shared memory, and every query tile
// (with the rows table of its queries) streams through two cp.async
// stages.  Per tile:
//   S^T = K Q^T, dP^T = V dO^T        (split TF32; columns in kappa order)
//   P^T = exp2(S^T c + bias - m) / l, dS^T = P^T (dP^T - delta)  (the
//                                      query statistics along columns)
//   dV += P^T dO, dK += dS^T Q        (P^T and dS^T, split, are the A
//                                      fragments)
template <int D>
__global__ void __launch_bounds__(kF32Warps * 32, kF32MinBlocks)
attn_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const unsigned char* __restrict__ key_mask,
                         const float* __restrict__ dout,
                         const float4* __restrict__ rows,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int tq, int tk, Strides qs, Strides ks, Strides vs,
                         Strides dos, Strides dks, Strides dvs,
                         float scale_log2, float scale) {
  using L = F32Bwd<D>;
  constexpr int BN = L::BN, RS = L::RS;
  constexpr int NT = BN / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char f32_smem[];
  float* k_s = reinterpret_cast<float*>(f32_smem);
  float* v_s = k_s + L::kOwn;
  float* str_s = k_s + 2 * L::kOwn;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kF32Rows;
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int r0 = k0 + warp * 16;
  float* dkb = dk + b * dks.b + h * dks.h;
  float* dvb = dv + b * dvs.b + h * dvs.h;

  // skip rule: keys that are all masked, in a batch row with a valid key,
  // get P = 0 from every query, so dk = dv = 0 exactly
  const unsigned char* mrow = key_mask ? key_mask + (long long)b * tk : nullptr;
  int row_any = 1, tile_any = 1;
  if (mrow != nullptr) {
    int any = 0;
    for (int j = tid; j < tk; j += blockDim.x) any |= mrow[j] != 0;
    row_any = __syncthreads_or(any);
    any = 0;
    for (int j = tid; j < kF32Rows; j += blockDim.x)
      any |= k0 + j < tk && mrow[k0 + j] != 0;
    tile_any = __syncthreads_or(any);
  }
  float ka[NO][4], va[NO][4];  // the dk and dv sums
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) ka[i][e] = va[i][e] = 0.f;
  if (row_any && !tile_any) {
    f32_store_rows<D>(dkb, dks.t, ka, r0, tk, 0.f);
    f32_store_rows<D>(dvb, dvs.t, va, r0, tk, 0.f);
    return;
  }

  tf32_load_rows<D, RS, kF32Rows>(k_s, k + b * ks.b + h * ks.h, ks.t, k0,
                                  tk - k0);
  tf32_load_rows<D, RS, kF32Rows>(v_s, v + b * vs.b + h * vs.h, vs.t, k0,
                                  tk - k0);
  tf32_cp_commit();
  const float* qb = q + b * qs.b + h * qs.h;
  const float* db = dout + b * dos.b + h * dos.h;
  const float* rb =
      reinterpret_cast<const float*>(rows + ((long long)b * heads + h) * tq);
  auto load_q = [&](int it) {
    float* st = str_s + (it % 2) * L::kStage;
    const int i0 = it * BN;
    tf32_load_rows<D, RS, BN>(st, qb, qs.t, i0, tq - i0);
    tf32_load_rows<D, RS, BN>(st + BN * RS, db, dos.t, i0, tq - i0);
    // the queries' rows table (zeros past tq: P = 0 there)
    tf32_load_rows<4, 4, BN>(st + 2 * BN * RS, rb, 4, i0, tq - i0);
  };
  const int nq = (tq + BN - 1) / BN;
  load_q(0);
  tf32_cp_commit();

  // this lane's key rows r0 + g, r0 + g + 8: their biases
  float bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r0 + g + 8 * r;
    bias[r] = key >= tk ? -INFINITY
                        : (mrow == nullptr || mrow[key] ? 0.f : -1e30f);
  }
  const float* k_w = k_s + warp * 16 * RS;
  const float* v_w = v_s + warp * 16 * RS;

  for (int it = 0; it < nq; ++it) {
    if (it + 1 < nq) load_q(it + 1);
    tf32_cp_commit();
    tf32_cp_wait<1>();
    __syncthreads();
    const float* q_s = str_s + (it % 2) * L::kStage;
    const float* do_s = q_s + BN * RS;
    const float4* rw_s = reinterpret_cast<const float4*>(q_s + 2 * BN * RS);

    float s[NT][4], dp[NT][4];
    f32_scores<D, NT, RS>(s, dp, k_w, v_w, q_s, do_s);

    // P^T into s, dS^T into dp
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 rw = rw_s[8 * j + tf32_kappa(2 * t + (e & 1))];
        const float p =
            exp2f(s[j][e] * scale_log2 + bias[e >> 1] - rw.x) * rw.y;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - rw.z);
      }

    // dV += P^T dO, dK += dS^T Q, each the tile's one partial: k-step j
    // over its queries 8 j .. + 7
    Tf32A pa[NT], da[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      pa[j] = tf32_a_acc(s[j]);
      da[j] = tf32_a_acc(dp[j]);
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      f32_add_tile<NT, RS>(va[i], pa, do_s, i);
      f32_add_tile<NT, RS>(ka[i], da, q_s, i);
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  f32_store_rows<D>(dkb, dks.t, ka, r0, tk, scale);
  f32_store_rows<D>(dvb, dvs.t, va, r0, tk, 1.f);
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v,
               const unsigned char* key_mask, const void* dout, void* dq,
               void* dk, void* dv, const void* o, const void* stats,
               float* rows, int b, int tq, int tk, int heads,
               const Strides* st, float scale, cudaStream_t stream) {
  using L = F32Bwd<D>;
  const void* in[4] = {q, k, v, dout};
  for (int n = 0; n < 4; ++n)
    if (!tf32_rows_ok(in[n], st[n].b, st[n].t, st[n].h)) return W2V_BAD_ARGS;
  void* out[3] = {dq, dk, dv};
  for (int n = 0; n < 3; ++n)
    if (!tf32_pairs_ok(out[n], st[4 + n].b, st[4 + n].t, st[4 + n].h))
      return W2V_BAD_ARGS;
  if (o == nullptr || stats == nullptr || rows == nullptr ||
      reinterpret_cast<uintptr_t>(rows) % 16)
    return W2V_BAD_ARGS;
  const long long smem1 = L::smem_dq(tk);
  if (smem1 > kF32SmemMax || L::kSmemDkdv > kF32SmemMax) return W2V_BAD_ARGS;
  const float scale_log2 = scale * 1.4426950408889634f;
  const long long n_rows = (long long)b * tq * heads;
  const long long blocks = (n_rows + kF32RowsThreads / 32 - 1) /
                           (kF32RowsThreads / 32);
  if (blocks > 0x7fffffffLL) return W2V_BAD_ARGS;
  attn_bwd_rows_f32_kernel<D><<<(unsigned)blocks, kF32RowsThreads, 0,
                                stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<const float2*>(stats), reinterpret_cast<float4*>(rows),
      n_rows, tq, heads, st[7], st[3]);
  int status = (int)cudaGetLastError();
  if (status != 0) return status;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  const float4* rw = reinterpret_cast<const float4*>(rows);
  status = (int)cudaFuncSetAttribute(
      attn_bwd_dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (status != 0) return status;
  const dim3 grid1((tq + kF32Rows - 1) / kF32Rows, heads, b);
  attn_bwd_dq_f32_kernel<D><<<grid1, kF32Warps * 32, smem1, stream>>>(
      qf, kf, vf, key_mask, df, rw, static_cast<float*>(dq), tq, tk, st[0],
      st[1], st[2], st[3], st[4], scale_log2, scale);
  status = (int)cudaGetLastError();
  if (status != 0) return status;
  status = (int)cudaFuncSetAttribute(
      attn_bwd_dkdv_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmemDkdv);
  if (status != 0) return status;
  const dim3 grid2((tk + kF32Rows - 1) / kF32Rows, heads, b);
  attn_bwd_dkdv_f32_kernel<D><<<grid2, kF32Warps * 32, L::kSmemDkdv,
                                stream>>>(
      qf, kf, vf, key_mask, df, rw, static_cast<float*>(dk),
      static_cast<float*>(dv), tq, tk, st[0], st[1], st[2], st[3], st[5],
      st[6], scale_log2, scale);
  return (int)cudaGetLastError();
}

int dispatch_f32(const void* q, const void* k, const void* v,
                 const unsigned char* key_mask, const void* dout, void* dq,
                 void* dk, void* dv, const void* o, const void* stats,
                 float* rows, int b, int tq, int tk, int heads, int d,
                 const Strides* st, float scale, cudaStream_t stream) {
  if (d == 64)
    return launch_f32<64>(q, k, v, key_mask, dout, dq, dk, dv, o, stats,
                          rows, b, tq, tk, heads, st, scale, stream);
  if (d == 96)
    return launch_f32<96>(q, k, v, key_mask, dout, dq, dk, dv, o, stats,
                          rows, b, tq, tk, heads, st, scale, stream);
  if (d == 128)
    return launch_f32<128>(q, k, v, key_mask, dout, dq, dk, dv, o, stats,
                           rows, b, tq, tk, heads, st, scale, stream);
  return W2V_BAD_ARGS;
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;       // a CTA's own rows: two warpgroups of 64
constexpr int kTcConsumers = 256;  // threads of the two consumer warpgroups
constexpr int kTcThreads = kTcConsumers + 128;  // + the producer warpgroup
constexpr int kTcStages = 2;       // ring depth of the streamed tiles
constexpr int kTcStream64 = 128;   // streamed rows a tile at D=64
constexpr int kTcStream96 = 64;    // at D=96 (D=128's schedule, padded)
constexpr int kTcStream128 = 64;   // and at D=128 (dk and dv: 128 floats)
constexpr int kTcProducerRegs = 24;   // setmaxnreg: the producer gives up
constexpr int kTcConsumerRegs = 240;  // what the consumers take
constexpr int kTcSmemMax = 227 * 1024;
constexpr int kRowsThreads = 256;  // the pre-pass: one warp a query row

template <int D>
struct TcBwd {
  static_assert(D == 64 || D == 96 || D == 128, "head dim");
  static constexpr int BN =
      D == 64 ? kTcStream64 : D == 96 ? kTcStream96 : kTcStream128;
  static constexpr int DP = padded_dim<D>();     // the products' N
  static constexpr int kBoxes = DP / kTcBox;     // 64-column boxes a row
  static constexpr int kOwnBytes = kTcRows * DP * 2;  // Q or dO; K or V
  static constexpr int kStrBytes = BN * DP * 2;       // a streamed tile
  static constexpr int kRowsBytes = BN * 16;         // its (m, 1/l, delta, 0)
  // own tiles at 0 and kOwnBytes; stage s at kStream + s * kStage: two
  // streamed tiles, then (dk/dv kernel) the rows of their queries
  static constexpr int kStream = 2 * kOwnBytes;
  static constexpr int kStage = 2 * kStrBytes + kRowsBytes;
  static constexpr int kBars = kStream + kTcStages * kStage;
  // own_full, full[stages], empty[stages]; then (dq kernel) the key-tile
  // count and list, the per-tile flags and the key mask row
  static constexpr int kCount = kBars + 8 * (1 + 2 * kTcStages);
  static constexpr int kList = kCount + 16;
  static_assert(kOwnBytes % 1024 == 0 && kStage % 1024 == 0, "swizzle atoms");

  // bytes of dynamic shared memory (+1024 to align the base): the dk/dv
  // kernel's, and the dq kernel's for tk keys
  static constexpr long long kSmemDkdv = 1024 + kList;
  static long long smem_dq(int tk) {
    const long long ntiles = (tk + BN - 1) / BN;
    return 1024 + kList + 4 * ntiles + ntiles + tk;
  }
};

// The pre-pass: per query row, delta = do . o (float32 sums of the bf16
// values; o as the forward stored it) beside the forward's statistics, as
// rows[b, h, t] = (m, 1/l, delta, 0).  One warp a row, rows in (b, t, h)
// order so that neighbouring warps read neighbouring heads.
template <int D>
__global__ void __launch_bounds__(kRowsThreads)
attn_bwd_rows_kernel(const __nv_bfloat16* __restrict__ o,
                     const __nv_bfloat16* __restrict__ dout,
                     const float2* __restrict__ stats,
                     float4* __restrict__ rows, long long n_rows, int tq,
                     int heads, Strides os, Strides dos) {
  const long long w = (long long)blockIdx.x * (kRowsThreads / 32) +
                      threadIdx.x / 32;
  if (w >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const int h = (int)(w % heads);
  const long long bt = w / heads;
  const int t = (int)(bt % tq);
  const long long b = bt / tq;
  const __nv_bfloat16* op = o + b * os.b + t * os.t + h * os.h;
  const __nv_bfloat16* dp = dout + b * dos.b + t * dos.t + h * dos.h;
  float acc = 0.f;
#pragma unroll
  for (int c = 2 * lane; c < D; c += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(op + c));
    const float2 g = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dp + c));
    acc += a.x * g.x + a.y * g.y;
  }
  acc = w2v_warp_sum(acc);
  if (lane == 0) {
    const long long i = (b * heads + h) * tq + t;
    const float2 st = stats[i];
    rows[i] = make_float4(st.x, 1.f / st.y, acc, 0.f);
  }
}

// dq: one CTA per (batch, head, 128 query rows); warpgroup wg owns rows
// q0 + 64 wg .. + 63, and a thread rows r0 = q0 + 64 wg + 16 (warp in
// group) + lane / 4 and r0 + 8, columns 8 j + 2 (lane % 4) + {0, 1} of
// every accumulator (the wgmma m64 layout).  Per visited key tile:
//   S = Q K^T, dP = dO V^T            (wgmma, both from shared memory)
//   P = exp2(S c + bias - m) / l,  dS = T(P (dP - delta))   (registers)
//   dQ += dS K                        (dS the register A fragment, K
//                                      MN-major in shared memory)
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
attn_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap domap,
                      const unsigned char* __restrict__ key_mask,
                      const float4* __restrict__ rows,
                      __nv_bfloat16* __restrict__ dq, int tq, int tk,
                      Strides dqs, float scale_log2, float scale) {
  using L = TcBwd<D>;
  constexpr int BN = L::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop_align1024(smem_raw);
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + kTcStages;
  int* count = reinterpret_cast<int*>(smem + L::kCount);
  int* tiles = reinterpret_cast<int*>(smem + L::kList);
  const int ntiles = (tk + BN - 1) / BN;
  unsigned char* flag_s = smem + L::kList + 4 * ntiles;
  unsigned char* mask_s = flag_s + ntiles;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTcRows;
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;

  if (tid == 0) {
    hop_mbar_init(own_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      hop_mbar_init(&full[s], 1);
      hop_mbar_init(&empty[s], kTcConsumers);
    }
    hop_mbar_init_fence();
  }
  w2v_key_tiles(key_mask ? key_mask + (long long)b * tk : nullptr, tk, BN,
                mask_s, flag_s, count, tiles);
  const int n = *count;

  if (tid >= kTcConsumers) {  // the producer warpgroup: one thread issues
    hop_setmaxnreg_dec<kTcProducerRegs>();
    if (tid == kTcConsumers) {
      hop_mbar_expect_tx(own_full, 2 * L::kOwnBytes);
      for (int c = 0; c < L::kBoxes; ++c) {
        hop_tma_load_4d(smem + c * kTcRows * 128, &qmap, own_full,
                        kTcBox * c, h, q0, b);
        hop_tma_load_4d(smem + L::kOwnBytes + c * kTcRows * 128, &domap,
                        own_full, kTcBox * c, h, q0, b);
      }
      for (int it = 0; it < n; ++it) {
        const int s = it % kTcStages;
        unsigned char* st = smem + L::kStream + s * L::kStage;
        hop_mbar_wait(&empty[s], ((it / kTcStages) & 1) ^ 1);
        hop_mbar_expect_tx(&full[s], 2 * L::kStrBytes);
        const int k0 = tiles[it] * BN;
        for (int c = 0; c < L::kBoxes; ++c) {
          hop_tma_load_4d(st + c * BN * 128, &kmap, &full[s], kTcBox * c, h,
                          k0, b);
          hop_tma_load_4d(st + L::kStrBytes + c * BN * 128, &vmap, &full[s],
                          kTcBox * c, h, k0, b);
        }
      }
    }
    return;
  }
  hop_setmaxnreg_inc<kTcConsumerRegs>();

  const int wg = tid / 128;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int r0 = q0 + wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  // this thread's rows: (m, 1/l, delta); rows past tq get P = 0
  float m[2], il[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const float4 rw = row < tq ? rows[((long long)b * heads + h) * tq + row]
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    m[r] = rw.x;
    il[r] = rw.y;
    dl[r] = rw.z;
  }
  float acc[L::DP / 2];  // columns past D stay zero (zero-filled K)
#pragma unroll
  for (int i = 0; i < L::DP / 2; ++i) acc[i] = 0.f;

  const unsigned char* q_s = smem + wg * 64 * 128;
  const unsigned char* do_s = smem + L::kOwnBytes + wg * 64 * 128;
  hop_mbar_wait(own_full, 0);
  for (int it = 0; it < n; ++it) {
    const int s = it % kTcStages;
    hop_mbar_wait(&full[s], (it / kTcStages) & 1);
    const unsigned char* k_s = smem + L::kStream + s * L::kStage;
    const unsigned char* v_s = k_s + L::kStrBytes;

    float sc[BN / 2], dp[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
    hop_fence_regs(sc);
    hop_fence_regs(dp);
    hop_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int box = kk / 4, off = (kk % 4) * 32;
      hop_wgmma_ss<BN>(
          sc, hop_desc_sw128(q_s + box * kTcRows * 128 + off, 16, 1024),
          hop_desc_sw128(k_s + box * BN * 128 + off, 16, 1024), kk > 0);
      hop_wgmma_ss<BN>(
          dp, hop_desc_sw128(do_s + box * kTcRows * 128 + off, 16, 1024),
          hop_desc_sw128(v_s + box * BN * 128 + off, 16, 1024), kk > 0);
    }
    hop_wgmma_commit();
    hop_wgmma_wait<0>();
    hop_fence_regs(sc);
    hop_fence_regs(dp);

    // dS = P (dP - delta), rounded to bf16 pairs: the A fragment of
    // k-step kk is accumulator pairs 8 kk + {0, 2, 4, 6}
    const int k0 = tiles[it] * BN;
    uint32_t ds[BN / 4];
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const int j = k0 + 8 * (i / 4) + 2 * quad;
      float v2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bias =
            j + e < tk ? (mask_s[j + e] ? 0.f : -1e30f) : -INFINITY;
        const float p = exp2f(sc[i + e] * scale_log2 + bias - m[r]) * il[r];
        v2[e] = p * (dp[i + e] - dl[r]);
      }
      ds[i / 2] = w2v_pack_bf16(v2[0], v2[1]);
    }

    // dQ += dS K: K MN-major, k-steps of 16 key rows (2048 bytes), N = DP,
    // the two 64-column boxes of DP=128 one leading byte offset apart
    hop_fence_regs(acc);
    hop_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2],
                             ds[4 * kk + 3]};
      hop_wgmma_rs_tb<L::DP>(acc, a, hop_desc_sw128(k_s + kk * 2048, BN * 128,
                                                1024));
    }
    hop_wgmma_commit();
    hop_wgmma_wait<0>();
    hop_fence_regs(acc);
    hop_mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* ob = dq + b * dqs.b + h * dqs.h + 2 * quad;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= tq) continue;
    __nv_bfloat16* orow = ob + (long long)row * dqs.t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale,
                                acc[4 * j + 2 * r + 1] * scale);
  }
}

// rows of a [64, DP] warpgroup accumulator (this thread's r0, r0 + 8)
// below n to dst through its time stride, times `mul`, as bf16 pairs: the
// first D columns only
template <int D>
__device__ __forceinline__ void store_rows(
    __nv_bfloat16* dst, long long st, const float (&acc)[padded_dim<D>() / 2],
    int r0, int n, float mul) {
  const int quad = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* p = dst + (long long)row * st + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// dk/dv: one CTA per (batch, head, 128 key rows), warpgroup wg owning key
// rows k0 + 64 wg .. + 63 (a thread's rows and columns as in the dq
// kernel).  Per tile of BN query rows (all of them: every query sees every
// key), with their (m, 1/l, delta) in shared memory beside Q and dO:
//   S^T = K Q^T, dP^T = V dO^T        (wgmma, both from shared memory)
//   P^T = exp2(S^T c + bias - m) / l, dS^T = P^T (dP^T - delta)  (the
//                                      statistics broadcast along columns)
//   dV += T(P^T) dO, dK += T(dS^T) Q  (register A fragments, dO and Q
//                                      MN-major in shared memory)
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
attn_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap domap,
                        const __grid_constant__ CUtensorMap rowmap,
                        const unsigned char* __restrict__ key_mask,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int tq, int tk,
                        Strides dks, Strides dvs, float scale_log2,
                        float scale) {
  using L = TcBwd<D>;
  constexpr int BN = L::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop_align1024(smem_raw);
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + kTcStages;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kTcRows;
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int r0 = k0 + wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  __nv_bfloat16* dkb = dk + b * dks.b + h * dks.h;
  __nv_bfloat16* dvb = dv + b * dvs.b + h * dvs.h;

  // skip rule: keys that are all masked, in a batch row with a valid key,
  // get P = 0 from every query, so dk = dv = 0 exactly
  const unsigned char* mrow = key_mask ? key_mask + (long long)b * tk : nullptr;
  int row_any = 1, tile_any = 1;
  if (mrow != nullptr) {
    int any = 0;
    for (int j = tid; j < tk; j += kTcThreads) any |= mrow[j] != 0;
    row_any = __syncthreads_or(any);
    any = tid < kTcRows && k0 + tid < tk && mrow[k0 + tid] != 0;
    tile_any = __syncthreads_or(any);
  }
  float ka[L::DP / 2], va[L::DP / 2];  // the dk and dv sums
#pragma unroll
  for (int i = 0; i < L::DP / 2; ++i) ka[i] = va[i] = 0.f;
  if (row_any && !tile_any) {
    if (tid < kTcConsumers) {
      store_rows<D>(dkb, dks.t, ka, r0, tk, 0.f);
      store_rows<D>(dvb, dvs.t, va, r0, tk, 0.f);
    }
    return;
  }

  if (tid == 0) {
    hop_mbar_init(own_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      hop_mbar_init(&full[s], 1);
      hop_mbar_init(&empty[s], kTcConsumers);
    }
    hop_mbar_init_fence();
  }
  __syncthreads();
  const int nq = (tq + BN - 1) / BN;

  if (tid >= kTcConsumers) {  // the producer warpgroup: one thread issues
    hop_setmaxnreg_dec<kTcProducerRegs>();
    if (tid == kTcConsumers) {
      hop_mbar_expect_tx(own_full, 2 * L::kOwnBytes);
      for (int c = 0; c < L::kBoxes; ++c) {
        hop_tma_load_4d(smem + c * kTcRows * 128, &kmap, own_full,
                        kTcBox * c, h, k0, b);
        hop_tma_load_4d(smem + L::kOwnBytes + c * kTcRows * 128, &vmap,
                        own_full, kTcBox * c, h, k0, b);
      }
      for (int it = 0; it < nq; ++it) {
        const int s = it % kTcStages;
        unsigned char* st = smem + L::kStream + s * L::kStage;
        hop_mbar_wait(&empty[s], ((it / kTcStages) & 1) ^ 1);
        hop_mbar_expect_tx(&full[s], 2 * L::kStrBytes + L::kRowsBytes);
        for (int c = 0; c < L::kBoxes; ++c) {
          hop_tma_load_4d(st + c * BN * 128, &qmap, &full[s], kTcBox * c, h,
                          it * BN, b);
          hop_tma_load_4d(st + L::kStrBytes + c * BN * 128, &domap,
                          &full[s], kTcBox * c, h, it * BN, b);
        }
        hop_tma_load_3d(st + 2 * L::kStrBytes, &rowmap, &full[s], 0, it * BN,
                        b * heads + h);
      }
    }
    return;
  }
  hop_setmaxnreg_inc<kTcConsumerRegs>();

  const int quad = lane % 4;
  // this thread's key rows r0, r0 + 8: their biases
  float bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r0 + 8 * r;
    bias[r] = key >= tk ? -INFINITY
                        : (mrow == nullptr || mrow[key] ? 0.f : -1e30f);
  }
  // shared memory by 32-bit addresses: the own tiles (K, V), and per stage
  // Q, dO and the rows table (m, 1/l, delta, 0) of its queries
  const uint32_t k_addr = hop_smem(smem) + wg * 64 * 128;
  const uint32_t v_addr = k_addr + L::kOwnBytes;
  hop_mbar_wait(own_full, 0);
  for (int it = 0; it < nq; ++it) {
    const int s = it % kTcStages;
    hop_mbar_wait(&full[s], (it / kTcStages) & 1);
    const uint32_t q_addr = hop_smem(smem) + L::kStream + s * L::kStage;
    const uint32_t do_addr = q_addr + L::kStrBytes;
    // rows past tq arrive as zeros: 1/l = 0 there, so P = dS = 0
    const uint32_t rw_addr = q_addr + 2 * L::kStrBytes;

    float sc[BN / 2], dp[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
    hop_fence_regs(sc);
    hop_fence_regs(dp);
    hop_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // the descriptors of k-step kk are built here, one step at a time
      const int box = kk / 4, off = (kk % 4) * 32;
      const uint32_t own = hop_opaque(box * kTcRows * 128 + off);
      const uint32_t str = hop_opaque(box * BN * 128 + off);
      hop_wgmma_ss<BN>(sc, hop_desc_sw128_at(k_addr + own, 16, 1024),
                       hop_desc_sw128_at(q_addr + str, 16, 1024), kk > 0);
      hop_wgmma_ss<BN>(dp, hop_desc_sw128_at(v_addr + own, 16, 1024),
                       hop_desc_sw128_at(do_addr + str, 16, 1024), kk > 0);
    }
    hop_wgmma_commit();
    hop_wgmma_wait<0>();
    hop_fence_regs(sc);
    hop_fence_regs(dp);

    // P^T and dS^T, rounded to bf16 pairs (the A fragments); a column's
    // statistics are loaded where they are used
    uint32_t pa[BN / 4], da[BN / 4];
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const int col = 8 * (i / 4) + 2 * quad;  // query in the tile
      float p2[2], d2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t at = rw_addr + 16 * (col + e);
        const float2 ml = hop_lds_f2(at);
        const float p = exp2f(sc[i + e] * scale_log2 + bias[r] - ml.x) * ml.y;
        p2[e] = p;
        d2[e] = p * (dp[i + e] - hop_lds_f(at + 8));
      }
      pa[i / 2] = w2v_pack_bf16(p2[0], p2[1]);
      da[i / 2] = w2v_pack_bf16(d2[0], d2[1]);
    }

    // dV += T(P^T) dO and dK += T(dS^T) Q: dO and Q MN-major, k-steps of
    // 16 query rows (2048 bytes), N = DP (columns past D stay zero)
    hop_fence_regs(va);
    hop_fence_regs(ka);
    hop_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t ap[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                              pa[4 * kk + 3]};
      const uint32_t ad[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                              da[4 * kk + 3]};
      const uint32_t off = hop_opaque(kk * 2048);
      hop_wgmma_rs_tb<L::DP>(va, ap, hop_desc_sw128_at(do_addr + off, BN * 128,
                                                   1024));
      hop_wgmma_rs_tb<L::DP>(ka, ad, hop_desc_sw128_at(q_addr + off, BN * 128,
                                                   1024));
    }
    hop_wgmma_commit();
    hop_wgmma_wait<0>();
    hop_fence_regs(va);
    hop_fence_regs(ka);
    hop_mbar_arrive(&empty[s]);
  }
  store_rows<D>(dkb, dks.t, ka, r0, tk, scale);
  store_rows<D>(dvb, dvs.t, va, r0, tk, 1.f);
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v,
              const unsigned char* key_mask, const void* dout, void* dq,
              void* dk, void* dv, const void* o, const void* stats,
              float* rows, int b, int tq, int tk, int heads, const Strides* st,
              float scale, cudaStream_t stream) {
  using L = TcBwd<D>;
  // TMA reads q, k, v and do (16-byte-aligned starts, strides of whole
  // 16-byte units, heads apart); the pre-pass reads o, and the epilogues
  // write dq, dk and dv, as bf16 pairs (4-byte alignment, even strides)
  const void* in[4] = {q, k, v, dout};
  for (int n = 0; n < 4; ++n)
    if (!hop_operand_ok(in[n], st[n].b, st[n].t, st[n].h, heads, D))
      return W2V_BAD_ARGS;
  const void* pairs[4] = {dq, dk, dv, o};
  for (int n = 0; n < 4; ++n)
    if (pairs[n] == nullptr || reinterpret_cast<uintptr_t>(pairs[n]) % 4 ||
        st[4 + n].b % 2 || st[4 + n].t % 2 || st[4 + n].h % 2)
      return W2V_BAD_ARGS;
  if (stats == nullptr || rows == nullptr || (long long)b * heads > INT_MAX)
    return W2V_BAD_ARGS;
  const long long smem1 = L::smem_dq(tk);
  if (smem1 > kTcSmemMax || L::kSmemDkdv > kTcSmemMax) return W2V_BAD_ARGS;
  const float scale_log2 = scale * 1.4426950408889634f;
  // the pre-pass: the rows table from the forward's statistics and delta
  const long long n_rows = (long long)b * tq * heads;
  const long long blocks = (n_rows + kRowsThreads / 32 - 1) /
                           (kRowsThreads / 32);
  if (blocks > 0x7fffffffLL) return W2V_BAD_ARGS;
  attn_bwd_rows_kernel<D><<<(unsigned)blocks, kRowsThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float2*>(stats), reinterpret_cast<float4*>(rows),
      n_rows, tq, heads, st[7], st[3]);
  int status = (int)cudaGetLastError();
  if (status != 0) return status;
  // q and do in boxes of `qrows` rows, k and v in boxes of `krows`; 4-D
  // maps with the head dim innermost, so a box past D reads zeros
  auto maps = [&](CUtensorMap* m4, int qrows, int krows) {
    return hop_head_map(&m4[0], q, b, tq, heads, D, st[0].b, st[0].t,
                        st[0].h, qrows) &&
           hop_head_map(&m4[1], k, b, tk, heads, D, st[1].b, st[1].t,
                        st[1].h, krows) &&
           hop_head_map(&m4[2], v, b, tk, heads, D, st[2].b, st[2].t,
                        st[2].h, krows) &&
           hop_head_map(&m4[3], dout, b, tq, heads, D, st[3].b, st[3].t,
                        st[3].h, qrows);
  };
  {  // dq: owns query rows, streams keys
    CUtensorMap m4[4];
    if (!maps(m4, kTcRows, L::BN)) return W2V_BAD_ARGS;
    status = (int)cudaFuncSetAttribute(
        attn_bwd_dq_tc_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
    if (status != 0) return status;
    const dim3 grid((tq + kTcRows - 1) / kTcRows, heads, b);
    attn_bwd_dq_tc_kernel<D><<<grid, kTcThreads, smem1, stream>>>(
        m4[0], m4[1], m4[2], m4[3], key_mask,
        reinterpret_cast<const float4*>(rows),
        static_cast<__nv_bfloat16*>(dq), tq, tk, st[4], scale_log2, scale);
    status = (int)cudaGetLastError();
    if (status != 0) return status;
  }
  {  // dk/dv: owns key rows, streams queries and their rows table
    CUtensorMap m4[4], rowmap;
    const cuuint64_t rdims[3] = {4, static_cast<cuuint64_t>(tq),
                                 static_cast<cuuint64_t>(b) * heads};
    const cuuint64_t rstrides[2] = {16, 16 * static_cast<cuuint64_t>(tq)};
    const cuuint32_t rbox[3] = {4, static_cast<cuuint32_t>(L::BN), 1};
    if (!maps(m4, L::BN, kTcRows) ||
        !hop_make_map(&rowmap, false, 3, rows, rdims, rstrides, rbox))
      return W2V_BAD_ARGS;
    status = (int)cudaFuncSetAttribute(
        attn_bwd_dkdv_tc_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmemDkdv);
    if (status != 0) return status;
    const dim3 grid((tk + kTcRows - 1) / kTcRows, heads, b);
    attn_bwd_dkdv_tc_kernel<D><<<grid, kTcThreads, L::kSmemDkdv, stream>>>(
        m4[0], m4[1], m4[2], m4[3], rowmap, key_mask,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), tq,
        tk, st[5], st[6], scale_log2, scale);
    status = (int)cudaGetLastError();
  }
  return status;
}

int dispatch_tc(const void* q, const void* k, const void* v,
                const unsigned char* key_mask, const void* dout, void* dq,
                void* dk, void* dv, const void* o, const void* stats,
                float* rows, int b, int tq, int tk, int heads, int d,
                const Strides* st, float scale, cudaStream_t stream) {
  if (d == 64)
    return launch_tc<64>(q, k, v, key_mask, dout, dq, dk, dv, o, stats, rows,
                         b, tq, tk, heads, st, scale, stream);
  if (d == 96)
    return launch_tc<96>(q, k, v, key_mask, dout, dq, dk, dv, o, stats, rows,
                         b, tq, tk, heads, st, scale, stream);
  if (d == 128)
    return launch_tc<128>(q, k, v, key_mask, dout, dq, dk, dv, o, stats,
                          rows, b, tq, tk, heads, st, scale, stream);
  return W2V_BAD_ARGS;
}

}  // namespace

// q, do, dq: [b, tq, heads, d]; k, v, dk, dv: [b, tk, heads, d]; element
// (b, t, h, 0..d) of operand n at ptr + b*s[3n] + t*s[3n+1] + h*s[3n+2],
// head dim contiguous, operands in the order q, k, v, do, dq, dk, dv, o of
// the host array `strides` (24 long longs).  key_mask: [b, tk] bytes
// (nonzero = valid key) or NULL.  d is 64, 96 or 128.
// Both dtypes take o [b, tq, heads, d], the forward's output, and stats
// [b, heads, tq, 2] float32, its (m, l) (w2v_attention); rows is a
// [b, heads, tq, 4] float32 workspace, 16-byte aligned.  dtype W2V_F32
// runs the split-TF32 kernels: q, k, v and do need 16-byte-aligned starts
// and strides that are multiples of 4 elements, dq, dk and dv 8-byte
// alignment and even strides.  W2V_BF16 runs the wgmma ones: q, k, v and
// do need 16-byte-aligned starts and strides that are multiples of 8
// elements, o, dq, dk and dv even strides (else W2V_BAD_ARGS).  Launches
// the pre-pass, the dq kernel and the dk/dv kernel on `stream`; returns
// the first non-zero
// cudaError_t.
extern "C" int w2v_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* key_mask, const void* dout,
                                 void* dq, void* dk, void* dv, const void* o,
                                 const void* stats, void* rows,
                                 const void* strides, int b, int tq, int tk,
                                 int heads, int d, float scale, int dtype,
                                 void* stream) {
  if (b <= 0 || tq <= 0 || tk <= 0 || heads <= 0 || b > 65535 ||
      heads > 65535 || strides == nullptr)
    return W2V_BAD_ARGS;
  const long long* s = static_cast<const long long*>(strides);
  Strides st[8];
  for (int n = 0; n < 8; ++n) st[n] = Strides{s[3 * n], s[3 * n + 1],
                                              s[3 * n + 2]};
  const unsigned char* mask = static_cast<const unsigned char*>(key_mask);
  float* ws = static_cast<float*>(rows);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == W2V_F32)
    return dispatch_f32(q, k, v, mask, dout, dq, dk, dv, o, stats, ws, b, tq,
                        tk, heads, d, st, scale, cs);
  if (dtype == W2V_BF16)
    return dispatch_tc(q, k, v, mask, dout, dq, dk, dv, o, stats, ws, b, tq,
                       tk, heads, d, st, scale, cs);
  return W2V_BAD_ARGS;
}
