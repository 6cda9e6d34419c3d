// Multi-head attention forward over key-padded windows, read through strides.
//
// Replaces two Pallas kernels of wav2vecsegmenter_tpu/ops/attention.py:
//   _attn_fwd_packed_kernel (K3): heads read straight from the fused QKV
//       projection [B, T, 3H] (encoder, 16 heads of D=64);
//   _attn_fwd_kernel        (K4): q/k/v [B, T, H, D] (SFC head, 8 heads of
//       D=128, or of D=96 over a base model's 768 channels).
// Both are one computation: out[b,i,h] = softmax_j(q.k * scale + bias_j) . v
// with bias_j = 0 for a valid key and -1e30 for a padded one.  The kernels
// take the operands where they lie (strides for batch, time and head, the
// head dim contiguous), so the packed layout, the [B,T,H,D] views and the
// output need no transpose; on the TPU, lane pairing and transposes did
// that job.  As in the TPU kernel, the unnormalised probabilities are
// rounded to the input type before the PV product, and the division by the
// float32 row sum comes once at the end.  Masked keys score -1e30, not
// -inf: a row whose keys are all masked (batch padding) then averages its
// in-range values with equal weights, as the TPU kernel does, instead of
// producing NaN that would reach the next layer's keys.
//
// Bound on the H100: operations.  4 * T^2 * D FLOP per (batch, head) against
// O(T * D) bytes — ~57 GFLOP per encoder layer at [14, 999].  Two kernels:
//
// bf16: attn_fwd_tc_kernel, Hopper tensor cores.  One CTA per (batch, head,
//   128-query tile): two consumer warpgroups of 64 query rows and one
//   producer warp.  The producer loads the Q tile once and streams K and V
//   tiles through a two-stage ring in shared memory by TMA, with mbarriers
//   (full: bytes landed; empty: both warpgroups done).  Each operand has a
//   4-D tensor map over [B, T, H, D] as it lies in memory (the packed
//   projection's rows of 3*H*D, the SFC's [B, T, 3, 8, D] view), so keys
//   past T arrive as zeros and no tile reads the next window's rows; the
//   128-byte swizzle takes boxes of 64 columns, ceil(D/64) a tile.  At
//   D=96 the second box is half real: the head dim is the map's own
//   innermost dim, so its columns 96-127 arrive as zeros (not the next
//   head's), and the kernel runs the D=128 schedule over the padded width
//   DP = 128 (key tile 64; P V at N = 128, whose output columns past 96
//   are zeros and never stored) with S over the 96 real columns (6 steps
//   of k16).  S = Q K^T is a
//   wgmma with both operands in shared memory (K-major); the online softmax
//   runs on the float32 accumulator in registers (running max from -1e30,
//   running sum, rescale of O by exp(m_old - m_new)), with -1e30 added for a
//   masked key and -inf for a key past tk (a zero-filled row).  The
//   exponentiated scores, packed to bf16 pairs, are already the register
//   fragment of wgmma's A operand, so O += P V takes P from registers and V
//   from shared memory (MN-major, the transposed-B form): the bf16 rounding
//   of P is the kernel's rounding point.  A key tile whose keys are all
//   masked adds exactly 0 to a row with a valid key and is skipped, unless
//   the batch row has no valid key at all (then every tile counts); the
//   kernel works this out from the mask bytes, so a mask that is not a
//   prefix stays right.  Query tiles are never skipped: padded query rows
//   stay finite.  Key tiles: 128 keys at D=64, 64 at D=96 and 128 (S holds
//   BK/2 floats a thread beside O's DP/2).  Under grad (the SFC head in
//   training) the kernel also writes each query row's final running max
//   and sum, (m, l), which the backward kernels (attention_bwd.cu) read
//   instead of sweeping the keys for them; the inference launch passes no
//   pointer and writes nothing more.
// float32 (the precision ladder's float32 arms, float32 training, the
//   oracle of every fidelity check): attn_fwd_f32_kernel, on the tensor
//   cores in split TF32 (tf32.cuh): each operand x = hi + lo, both TF32,
//   and a b = hi hi + hi lo + lo hi in three mma.sync.m16n8k8 into a float32
//   accumulator.  The dropped lo lo term and lo's rounding are ~2^-22 of
//   each product, a few float32 ulps, so the route stays within the float32
//   arm's 1e-4 of its plain version (a single TF32 product, 2^-11, would
//   not); its bound is the products counted three times at the 495 TFLOP/s
//   TF32 peak.  FlashAttention-2's layout: one CTA of four warps per (batch,
//   head, 64 query rows), 16 rows a warp; Q once in shared memory, K and V
//   tiles of 32 keys double-buffered by cp.async (each K/V element is read
//   by all four warps, a tile at a time, not once per query row as in the
//   scalar kernel this replaces), S in float32 registers with the online
//   softmax in log2 units (m from -1e30, the same biases and skip rule as
//   the bf16 kernel), then O += P V with P split from S's accumulator as it
//   lies: S's columns are keys in the order kappa(n) = n ^ (n >> 2) within
//   each 8, which makes the m16n8 accumulator the A fragment of the next
//   k8 step and keeps every shared read free of bank conflicts (tf32.cuh).
//   D=96 runs 12 k-steps over its own columns; nothing is padded.  Under
//   grad it writes (m, l) as the bf16 kernel does.

#include <math.h>

#include "common.cuh"
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

constexpr int kF32Warps = 4;       // warps a CTA, 16 query rows each
constexpr int kF32Rows = 64;       // query rows a CTA
constexpr int kF32KeyTile64 = 32;  // key rows a streamed tile, by head dim
constexpr int kF32KeyTile96 = 32;
constexpr int kF32KeyTile128 = 32;
constexpr int kF32Pad = 8;         // floats past D a shared row (8 banks)
constexpr int kF32Steps = 2;       // k-steps of a partial of S
constexpr int kF32MinBlocks = 2;   // CTAs an SM: up to 255 registers
constexpr int kF32SmemMax = 227 * 1024;

template <int D>
struct F32Fwd {
  static_assert(D == 64 || D == 96 || D == 128, "head dim");
  static_assert(kF32Rows == 16 * kF32Warps, "16 rows a warp");
  static constexpr int BK =
      D == 64 ? kF32KeyTile64 : D == 96 ? kF32KeyTile96 : kF32KeyTile128;
  static constexpr int RS = D + kF32Pad;  // shared row stride (floats)
  // floats: Q at 0, stage s's K at kKV + s * kStage and V BK rows later
  static constexpr int kKV = kF32Rows * RS;
  static constexpr int kStage = 2 * BK * RS;
  // bytes: the tile count and list, the per-tile flags, the key mask row
  static constexpr int kCount = 4 * (kKV + 2 * kStage);
  static constexpr int kList = kCount + 16;
  static_assert(BK % 8 == 0 && D % (8 * kF32Steps) == 0, "whole partials");

  static long long smem_bytes(int tk) {
    const long long ntiles = (tk + BK - 1) / BK;
    return kList + 4 * ntiles + ntiles + tk;
  }
};

// One CTA per (batch, head, 64 query rows); warp w owns query rows
// q0 + 16 w .. + 15, and a lane rows g = lane / 4 and g + 8 of them.  Per
// visited key tile (double-buffered by cp.async):
//   S = Q K^T                      (split TF32; S's columns in kappa order)
//   online softmax in log2 units   (float32 registers, row max over a quad)
//   O += P V                       (P, split, is S's accumulator as it
//                                   lies: the A fragment, no shuffle)
// then O / l is stored, and (under grad) each row's (m, l).
template <int D>
__global__ void __launch_bounds__(kF32Warps * 32, kF32MinBlocks)
attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const unsigned char* __restrict__ key_mask,
                    float* __restrict__ out, float2* __restrict__ stats,
                    int tq, int tk, Strides qs, Strides ks, Strides vs,
                    Strides os, float scale_log2) {
  using L = F32Fwd<D>;
  constexpr int BK = L::BK, RS = L::RS;
  constexpr int NT = BK / 8;  // 8-key column tiles of S
  constexpr int NO = D / 8;   // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char f32_smem[];
  float* q_s = reinterpret_cast<float*>(f32_smem);
  float* kv_s = q_s + L::kKV;
  int* count = reinterpret_cast<int*>(f32_smem + L::kCount);
  int* tiles = reinterpret_cast<int*>(f32_smem + L::kList);
  const int ntiles = (tk + BK - 1) / BK;
  unsigned char* flag_s = f32_smem + L::kList + 4 * ntiles;
  unsigned char* mask_s = flag_s + ntiles;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kF32Rows;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  tf32_load_rows<D, RS, kF32Rows>(q_s, q + b * qs.b + h * qs.h, qs.t, q0,
                                  tq - q0);
  tf32_cp_commit();
  w2v_key_tiles(key_mask ? key_mask + (long long)b * tk : nullptr, tk, BK,
                mask_s, flag_s, count, tiles);
  const int n = *count;
  auto load_kv = [&](int it) {
    float* st = kv_s + (it % 2) * L::kStage;
    const int k0 = tiles[it] * BK;
    tf32_load_rows<D, RS, BK>(st, kb, ks.t, k0, tk - k0);
    tf32_load_rows<D, RS, BK>(st + BK * RS, vb, vs.t, k0, tk - k0);
  };
  load_kv(0);  // n >= 1: every row has a key tile
  tf32_cp_commit();

  float o[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-1e30f, -1e30f};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  const float* q_w = q_s + warp * 16 * RS;

  for (int it = 0; it < n; ++it) {
    if (it + 1 < n) load_kv(it + 1);
    tf32_cp_commit();
    tf32_cp_wait<1>();
    __syncthreads();
    const float* k_s = kv_s + (it % 2) * L::kStage;
    const float* v_s = k_s + BK * RS;

    // S in partials of kF32Steps k-steps (tf32_mma3_fresh)
    float s[NT][4];
#pragma unroll
    for (int kk = 0; kk < D / 8; kk += kF32Steps) {
      float part[NT][4];
#pragma unroll
      for (int u = 0; u < kF32Steps; ++u) {
        const Tf32A a = tf32_a_rows<RS>(q_w, kk + u);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const Tf32B bk = tf32_b_rows<RS>(k_s + 8 * j * RS, kk + u);
          if (u == 0)
            tf32_mma3_fresh(part[j], a, bk);
          else
            tf32_mma3(part[j], a, bk);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = kk == 0 ? part[j][e] : s[j][e] + part[j][e];
    }

    // scores in log2 units with the key biases (0 valid, -1e30 masked,
    // -inf past tk); the tile's row maxima over the quad
    const int k0 = tiles[it] * BK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + tf32_kappa(2 * t + (e & 1));
        const float bias =
            key < tk ? (mask_s[key] ? 0.f : -1e30f) : -INFINITY;
        s[j][e] = s[j][e] * scale_log2 + bias;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    Tf32A pa[NT];  // P, split: k-step j over the tile's keys 8 j .. + 7
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
      pa[j] = tf32_a_acc(s[j]);
    }

    // O = alpha O + P V, the tile's P V one partial
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      float c[4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const Tf32B bv = tf32_b_cols<RS>(v_s + 8 * j * RS, i);
        if (j == 0)
          tf32_mma3_fresh(c, pa[j], bv);
        else
          tf32_mma3(c, pa[j], bv);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] = o[i][e] * alpha[e >> 1] + c[e];
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* ob = out + b * os.b + h * os.h + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= tq) continue;
    if (stats != nullptr && t == 0)
      stats[((long long)b * gridDim.y + h) * tq + row] = make_float2(m[r], l[r]);
    float* orow = ob + (long long)row * os.t;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int i = 0; i < NO; ++i)
      *reinterpret_cast<float2*>(orow + 8 * i) =
          make_float2(o[i][2 * r] * inv, o[i][2 * r + 1] * inv);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v,
               const unsigned char* key_mask, void* out, float2* stats, int b,
               int tq, int tk, int heads, Strides qs, Strides ks, Strides vs,
               Strides os, float scale, cudaStream_t stream) {
  using L = F32Fwd<D>;
  if (!tf32_rows_ok(q, qs.b, qs.t, qs.h) ||
      !tf32_rows_ok(k, ks.b, ks.t, ks.h) ||
      !tf32_rows_ok(v, vs.b, vs.t, vs.h) ||
      !tf32_pairs_ok(out, os.b, os.t, os.h))
    return W2V_BAD_ARGS;
  const long long smem = L::smem_bytes(tk);
  if (smem > kF32SmemMax) return W2V_BAD_ARGS;
  int status = (int)cudaFuncSetAttribute(
      attn_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (status != 0) return status;
  const dim3 grid((tq + kF32Rows - 1) / kF32Rows, heads, b);
  attn_fwd_f32_kernel<D><<<grid, kF32Warps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), key_mask, static_cast<float*>(out),
      stats, tq, tk, qs, ks, vs, os, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

int dispatch_f32(const void* q, const void* k, const void* v,
                 const unsigned char* key_mask, void* out, float2* stats,
                 int b, int tq, int tk, int heads, int d, Strides qs,
                 Strides ks, Strides vs, Strides os, float scale,
                 cudaStream_t stream) {
  if (d == 64)
    return launch_f32<64>(q, k, v, key_mask, out, stats, b, tq, tk, heads,
                          qs, ks, vs, os, scale, stream);
  if (d == 96)
    return launch_f32<96>(q, k, v, key_mask, out, stats, b, tq, tk, heads,
                          qs, ks, vs, os, scale, stream);
  if (d == 128)
    return launch_f32<128>(q, k, v, key_mask, out, stats, b, tq, tk, heads,
                           qs, ks, vs, os, scale, stream);
  return W2V_BAD_ARGS;
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;        // query rows a CTA: two warpgroups of 64
constexpr int kTcConsumers = 256;   // threads of the two consumer warpgroups
constexpr int kTcThreads = kTcConsumers + 32;  // + the producer warp
constexpr int kTcStages = 2;        // K/V ring depth
constexpr int kTcKeyTile64 = 128;   // key rows a tile at D=64
constexpr int kTcKeyTile96 = 64;    // at D=96 (D=128's schedule, padded)
constexpr int kTcKeyTile128 = 64;   // and at D=128
constexpr int kTcSmemMax = 227 * 1024;

template <int D>
struct TcFwd {
  static_assert(D == 64 || D == 96 || D == 128, "head dim");
  static constexpr int BK =
      D == 64 ? kTcKeyTile64 : D == 96 ? kTcKeyTile96 : kTcKeyTile128;
  static constexpr int DP = padded_dim<D>();  // P V's N, O's columns
  static constexpr int kBoxes = DP / kTcBox;  // 64-column boxes a row
  static constexpr int kQBytes = kTcRows * DP * 2;
  static constexpr int kKVBytes = BK * DP * 2;  // one K or V tile
  static constexpr int kK = kQBytes;           // stage s at kK + s*kKVBytes
  static constexpr int kV = kK + kTcStages * kKVBytes;
  static constexpr int kBars = kV + kTcStages * kKVBytes;
  // q_full, full[stages], empty[stages]; then the tile count and list, the
  // per-tile flags and the key mask row
  static constexpr int kCount = kBars + 8 * (1 + 2 * kTcStages);
  static constexpr int kList = kCount + 16;
  static_assert(kQBytes % 1024 == 0 && kKVBytes % 1024 == 0, "swizzle atoms");

  // bytes of dynamic shared memory for tk keys (+1024 to align the base)
  static long long smem_bytes(int tk) {
    const long long ntiles = (tk + BK - 1) / BK;
    return 1024 + kList + 4 * ntiles + ntiles + tk;
  }
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
attn_fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const unsigned char* __restrict__ key_mask,
                   __nv_bfloat16* __restrict__ out,
                   float2* __restrict__ stats, int tq, int tk, Strides os,
                   float scale_log2) {
  using L = TcFwd<D>;
  constexpr int BK = L::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop_align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kTcStages;
  int* count = reinterpret_cast<int*>(smem + L::kCount);
  int* tiles = reinterpret_cast<int*>(smem + L::kList);
  const int ntiles = (tk + BK - 1) / BK;
  unsigned char* flag_s = smem + L::kList + 4 * ntiles;
  unsigned char* mask_s = flag_s + ntiles;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTcRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  if (tid == 0) {
    hop_mbar_init(q_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      hop_mbar_init(&full[s], 1);
      hop_mbar_init(&empty[s], kTcConsumers);
    }
    hop_mbar_init_fence();
  }
  w2v_key_tiles(key_mask ? key_mask + (long long)b * tk : nullptr, tk, BK,
                mask_s, flag_s, count, tiles);
  const int n = *count;

  if (tid >= kTcConsumers) {  // the producer warp: one thread issues TMA
    if (tid == kTcConsumers) {
      hop_mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < L::kBoxes; ++c)
        hop_tma_load_4d(smem + c * kTcRows * 128, &qmap, q_full, kTcBox * c,
                        h, q0, b);
      for (int it = 0; it < n; ++it) {
        const int s = it % kTcStages;
        hop_mbar_wait(&empty[s], ((it / kTcStages) & 1) ^ 1);
        hop_mbar_expect_tx(&full[s], 2 * L::kKVBytes);
        const int k0 = tiles[it] * BK;
        for (int c = 0; c < L::kBoxes; ++c) {
          hop_tma_load_4d(smem + L::kK + s * L::kKVBytes + c * BK * 128,
                          &kmap, &full[s], kTcBox * c, h, k0, b);
          hop_tma_load_4d(smem + L::kV + s * L::kKVBytes + c * BK * 128,
                          &vmap, &full[s], kTcBox * c, h, k0, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; a thread
  // holds rows r0 = (warp in group) * 16 + lane / 4 and r0 + 8, columns
  // 8 j + 2 (lane % 4) + {0, 1} of every accumulator
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int r0 = q0 + wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  float o[L::DP / 2];
#pragma unroll
  for (int i = 0; i < L::DP / 2; ++i) o[i] = 0.f;
  float m[2] = {-1e30f, -1e30f};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  const unsigned char* q_s = smem + wg * 64 * 128;
  hop_mbar_wait(q_full, 0);
  for (int it = 0; it < n; ++it) {
    const int s = it % kTcStages;
    hop_mbar_wait(&full[s], (it / kTcStages) & 1);
    const unsigned char* k_s = smem + L::kK + s * L::kKVBytes;
    const unsigned char* v_s = smem + L::kV + s * L::kKVBytes;

    // S = Q K^T: D/16 steps of k16 (the real columns only), within
    // 64-column boxes by 32 bytes
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    hop_fence_regs(sc);
    hop_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int box = kk / 4, off = (kk % 4) * 32;
      hop_wgmma_ss<BK>(
          sc, hop_desc_sw128(q_s + box * kTcRows * 128 + off, 16, 1024),
          hop_desc_sw128(k_s + box * BK * 128 + off, 16, 1024), kk > 0);
    }
    hop_wgmma_commit();
    hop_wgmma_wait<0>();
    hop_fence_regs(sc);

    // scores in log2 units with the key biases; the tile's row maxima
    const int k0 = tiles[it] * BK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int j = k0 + 8 * (i / 4) + 2 * quad + (i & 1);
      const float bias = j < tk ? (mask_s[j] ? 0.f : -1e30f) : -INFINITY;
      sc[i] = sc[i] * scale_log2 + bias;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    hop_fence_regs(o);
#pragma unroll
    for (int i = 0; i < L::DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // P = exp2(s - m), summed in float32 and packed to bf16 pairs: the A
    // fragment of k-step kk is accumulator pairs 8 kk + {0,2,4,6}
    uint32_t p[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const float e0 = exp2f(sc[i] - m[r]);
      const float e1 = exp2f(sc[i + 1] - m[r]);
      l[r] += e0 + e1;
      p[i / 2] = w2v_pack_bf16(e0, e1);
    }

    // O += P V: V MN-major, k-steps of 16 key rows (2048 bytes), N = DP,
    // the two 64-column boxes of DP=128 one leading byte offset apart
    hop_fence_regs(o);
    hop_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                             p[4 * kk + 3]};
      hop_wgmma_rs_tb<L::DP>(o, a, hop_desc_sw128(v_s + kk * 2048,
                                                  BK * 128, 1024));
    }
    hop_wgmma_commit();
    hop_wgmma_wait<0>();
    hop_fence_regs(o);
    hop_mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* ob = out + b * os.b + h * os.h + 2 * quad;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= tq) continue;
    if (stats != nullptr && quad == 0)
      stats[((long long)b * gridDim.y + h) * tq + row] = make_float2(m[r], l[r]);
    __nv_bfloat16* orow = ob + (long long)row * os.t;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                o[4 * j + 2 * r + 1] * inv);
  }
}

bool make_map(CUtensorMap* map, const void* base, int b, int t, int heads,
              int d, Strides st, int box_rows) {
  return hop_head_map(map, base, b, t, heads, d, st.b, st.t, st.h, box_rows);
}

bool tma_ok(const void* p, Strides st, int heads, int d) {
  return hop_operand_ok(p, st.b, st.t, st.h, heads, d);
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v,
              const unsigned char* key_mask, void* out, float2* stats, int b,
              int tq, int tk, int heads, Strides qs, Strides ks, Strides vs,
              Strides os, float scale, cudaStream_t stream) {
  using L = TcFwd<D>;
  if (!tma_ok(q, qs, heads, D) || !tma_ok(k, ks, heads, D) ||
      !tma_ok(v, vs, heads, D) || reinterpret_cast<uintptr_t>(out) % 4 ||
      os.b % 2 || os.t % 2 || os.h % 2)
    return W2V_BAD_ARGS;
  const long long smem = L::smem_bytes(tk);
  if (smem > kTcSmemMax) return W2V_BAD_ARGS;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(&qmap, q, b, tq, heads, D, qs, kTcRows) ||
      !make_map(&kmap, k, b, tk, heads, D, ks, L::BK) ||
      !make_map(&vmap, v, b, tk, heads, D, vs, L::BK))
    return W2V_BAD_ARGS;
  int status = (int)cudaFuncSetAttribute(
      attn_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (status != 0) return status;
  const dim3 grid((tq + kTcRows - 1) / kTcRows, heads, b);
  attn_fwd_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      qmap, kmap, vmap, key_mask, static_cast<__nv_bfloat16*>(out), stats,
      tq, tk, os, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

int dispatch_tc(const void* q, const void* k, const void* v,
                const unsigned char* key_mask, void* out, float2* stats,
                int b, int tq, int tk, int heads, int d, Strides qs,
                Strides ks, Strides vs, Strides os, float scale,
                cudaStream_t stream) {
  if (d == 64)
    return launch_tc<64>(q, k, v, key_mask, out, stats, b, tq, tk, heads, qs,
                         ks, vs, os, scale, stream);
  if (d == 96)
    return launch_tc<96>(q, k, v, key_mask, out, stats, b, tq, tk, heads, qs,
                         ks, vs, os, scale, stream);
  if (d == 128)
    return launch_tc<128>(q, k, v, key_mask, out, stats, b, tq, tk, heads,
                          qs, ks, vs, os, scale, stream);
  return W2V_BAD_ARGS;
}

}  // namespace

// q, k, v, out: element (b, t, h, 0..d) at ptr + b*sb + t*st + h*sh, head
// dim contiguous; d is 64, 96 or 128.  key_mask: [b, tk] bytes (nonzero =
// valid key) or NULL for no padding.  dtype W2V_F32 runs the split-TF32
// kernel, which needs q, k and v 16-byte aligned with strides that are
// multiples of 4 elements, and out 8-byte aligned with even strides;
// W2V_BF16 the wgmma one, which needs q, k and v 16-byte aligned with
// strides that are multiples of 8 elements, and out's strides even (else
// W2V_BAD_ARGS).  stats: NULL, or a [b, heads, tq] array of float pairs
// that gets each query row's (m, l): its largest score in log2 units and
// sum_j exp2(s_j - m) in float32, so that P_ij = exp2(s_ij - m_i) / l_i
// (the backward kernels' input).  Launches on `stream`; returns the
// launch's cudaError_t.
extern "C" int w2v_attention(
    const void* q, const void* k, const void* v, const void* key_mask,
    void* out, void* stats, int b, int tq, int tk, int heads, int d,
    long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh, float scale, int dtype,
    void* stream) {
  if (b <= 0 || tq <= 0 || tk <= 0 || heads <= 0 || b > 65535 ||
      heads > 65535)
    return W2V_BAD_ARGS;
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, os{o_sb, o_st, o_sh};
  const unsigned char* mask = static_cast<const unsigned char*>(key_mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == W2V_F32)
    return dispatch_f32(q, k, v, mask, out, static_cast<float2*>(stats), b,
                        tq, tk, heads, d, qs, ks, vs, os, scale, s);
  if (dtype == W2V_BF16)
    return dispatch_tc(q, k, v, mask, out, static_cast<float2*>(stats), b,
                       tq, tk, heads, d, qs, ks, vs, os, scale, s);
  return W2V_BAD_ARGS;
}
