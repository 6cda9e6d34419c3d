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
// float32 (the oracle arm, TF32 off): attn_bwd_{dq,dkdv}_kernel, scalar
//   FMAs, as before: a query-major kernel computes each row's max, sum of
//   exponentials and delta in a first sweep over the keys (online, rescaled
//   per tile of keys) and dq in a second, through a [B, H, Tq, 3]
//   workspace; a key-major kernel sweeps all query rows for dk and dv.  A
//   row (query or key) is owned by DP/32 neighbouring lanes, 32 head dims
//   each, its operands and accumulators in registers (DP the head dim
//   rounded up to a multiple of 64: at D=96 the fourth lane holds zeros
//   and stores nothing); the other side streams through shared memory as
//   float32 tiles of 4096/DP rows, each 32-dim segment padded by 4 floats;
//   partial dot products meet through warp shuffles.  TF32 tensor cores
//   would miss the arm's 1e-4 gradient tolerance.

#include <limits.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSeg = 36;    // 32 head dims + 4 floats of bank padding
constexpr int kChunk = 16;  // keys scored before each rescale of sweep 1
constexpr int kTcBox = 64;  // columns of a bf16 TMA box (128 bytes)

// the width both routes compute over: D rounded up to whole 64-column
// boxes (96 -> 128); the columns past D are zeros and never stored
template <int D>
__host__ __device__ constexpr int padded_dim() {
  return (D + kTcBox - 1) / kTcBox * kTcBox;
}

struct Strides {
  long long b, t, h;
};

// this lane's 32-dim share of a dot product: a in registers, b a padded
// float32 segment in shared memory; the same order in every kernel, so a
// score recomputed in kernel 2 equals kernel 1's bit for bit
__device__ __forceinline__ float dot32(const float* a, const float* b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 bb = b4[i];
    dot += a[4 * i] * bb.x + a[4 * i + 1] * bb.y + a[4 * i + 2] * bb.z +
           a[4 * i + 3] * bb.w;
  }
  return dot;
}

// sum over the G lanes that own one row
template <int G>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [r0, r0 + n) of a [.., T, .., D] operand (one batch and head) into a
// padded float32 tile of `rows` rows, padded_dim<D>() columns; rows past n
// and columns past D are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long st, int r0, int n,
                                          int rows) {
  constexpr int DP = padded_dim<D>();
  constexpr int RS = (DP / 32) * kSeg;
  for (int idx = threadIdx.x; idx < rows * DP; idx += kThreads) {
    const int j = idx / DP;
    const int c = idx % DP;
    dst[j * RS + (c / 32) * kSeg + (c % 32)] =
        j < n && c < D ? w2v_load(src + (long long)(r0 + j) * st + c) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v,
                   const unsigned char* __restrict__ key_mask,
                   const T* __restrict__ dout, T* __restrict__ dq,
                   float* __restrict__ stats, int tq, int tk, Strides qs,
                   Strides ks, Strides vs, Strides dos, Strides dqs,
                   float scale) {
  constexpr int G = padded_dim<D>() / 32;  // lanes per query row
  constexpr int BQ = kThreads / G;      // query rows per block
  constexpr int BK = 4096 / padded_dim<D>();  // key rows per shared tile
  constexpr int RS = G * kSeg;          // shared-memory row stride (floats)
  static_assert(BK % kChunk == 0, "key tile must hold whole chunks");

  __shared__ __align__(16) float k_s[BK * RS];
  __shared__ __align__(16) float v_s[BK * RS];
  __shared__ float bias_s[BK];

  const int tid = threadIdx.x;
  const int part = tid % G;
  const int qi = blockIdx.x * BQ + tid / G;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int heads = gridDim.y;
  const bool active = qi < tq;
  const bool real = part * 32 < D;      // not a padding lane (D=96)

  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const unsigned char* mb = key_mask ? key_mask + (long long)b * tk : nullptr;

  float qr[32], dor[32];
  {
    const long long row = active ? qi : 0;
    const T* qp = q + b * qs.b + row * qs.t + h * qs.h + part * 32;
    const T* dp = dout + b * dos.b + row * dos.t + h * dos.h + part * 32;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      qr[i] = active && real ? w2v_load(qp + i) : 0.f;
      dor[i] = active && real ? w2v_load(dp + i) : 0.f;
    }
  }

  // sweep 1: max m, sum of exponentials l and sum of exp * dP, online
  float m = -1e30f, l = 0.f, dsum = 0.f;
  for (int k0 = 0; k0 < tk; k0 += BK) {
    const int kt = min(BK, tk - k0);
    __syncthreads();
    load_tile<T, D>(k_s, kb, ks.t, k0, kt, BK);
    load_tile<T, D>(v_s, vb, vs.t, k0, kt, BK);
    for (int j = tid; j < BK; j += kThreads)
      bias_s[j] = (mb == nullptr || (j < kt && mb[k0 + j])) ? 0.f : -1e30f;
    __syncthreads();
    for (int j0 = 0; j0 < kt; j0 += kChunk) {
      float s[kChunk], dp[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c;
        const float sd = row_sum<G>(dot32(qr, k_s + j * RS + part * kSeg));
        dp[c] = row_sum<G>(dot32(dor, v_s + j * RS + part * kSeg));
        s[c] = j < kt ? sd * scale + bias_s[j] : -INFINITY;
        cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
      dsum *= alpha;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float e = expf(s[c] - m_new);
        l += e;
        dsum += e * dp[c];
      }
      m = m_new;
    }
  }
  const float delta = dsum / l;

  // sweep 2: dq_i = scale * sum_j T(dS_ij) k_j
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < tk; k0 += BK) {
    const int kt = min(BK, tk - k0);
    __syncthreads();
    load_tile<T, D>(k_s, kb, ks.t, k0, kt, BK);
    load_tile<T, D>(v_s, vb, vs.t, k0, kt, BK);
    for (int j = tid; j < BK; j += kThreads)
      bias_s[j] = (mb == nullptr || (j < kt && mb[k0 + j])) ? 0.f : -1e30f;
    __syncthreads();
    for (int j = 0; j < kt; ++j) {
      const float* kr = k_s + j * RS + part * kSeg;
      const float sd = row_sum<G>(dot32(qr, kr));
      const float dpj = row_sum<G>(dot32(dor, v_s + j * RS + part * kSeg));
      const float p = expf(sd * scale + bias_s[j] - m) / l;
      const float ds = w2v_round(p * (dpj - delta), q);
      const float4* k4 = reinterpret_cast<const float4*>(kr);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 kk = k4[i];
        acc[4 * i] += ds * kk.x;
        acc[4 * i + 1] += ds * kk.y;
        acc[4 * i + 2] += ds * kk.z;
        acc[4 * i + 3] += ds * kk.w;
      }
    }
  }

  if (active) {
    T* op = dq + b * dqs.b + (long long)qi * dqs.t + h * dqs.h + part * 32;
    if (real) {
#pragma unroll
      for (int i = 0; i < 32; ++i) w2v_store(op + i, acc[i] * scale);
    }
    if (part == 0) {
      float* st = stats + (((long long)b * heads + h) * tq + qi) * 3;
      st[0] = m;
      st[1] = l;
      st[2] = delta;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const unsigned char* __restrict__ key_mask,
                     const T* __restrict__ dout, T* __restrict__ dk,
                     T* __restrict__ dv, const float* __restrict__ stats,
                     int tq, int tk, Strides qs, Strides ks, Strides vs,
                     Strides dos, Strides dks, Strides dvs, float scale) {
  constexpr int G = padded_dim<D>() / 32;  // lanes per key row
  constexpr int BKR = kThreads / G;     // key rows per block
  constexpr int BQ = 4096 / padded_dim<D>();  // query rows per shared tile
  constexpr int RS = G * kSeg;

  __shared__ __align__(16) float q_s[BQ * RS];
  __shared__ __align__(16) float do_s[BQ * RS];
  __shared__ float st_s[BQ * 3];

  const int tid = threadIdx.x;
  const int part = tid % G;
  const int kj = blockIdx.x * BKR + tid / G;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int heads = gridDim.y;
  const bool active = kj < tk;
  const bool real = part * 32 < D;      // not a padding lane (D=96)

  const T* qb = q + b * qs.b + h * qs.h;
  const T* db = dout + b * dos.b + h * dos.h;
  const float* sb = stats + ((long long)b * heads + h) * tq * 3;

  float kr[32], vr[32], dk_acc[32], dv_acc[32];
  {
    const long long row = active ? kj : 0;
    const T* kp = k + b * ks.b + row * ks.t + h * ks.h + part * 32;
    const T* vp = v + b * vs.b + row * vs.t + h * vs.h + part * 32;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      kr[i] = active && real ? w2v_load(kp + i) : 0.f;
      vr[i] = active && real ? w2v_load(vp + i) : 0.f;
      dk_acc[i] = 0.f;
      dv_acc[i] = 0.f;
    }
  }
  const float bias =
      (key_mask == nullptr || (active && key_mask[(long long)b * tk + kj]))
          ? 0.f
          : -1e30f;

  for (int i0 = 0; i0 < tq; i0 += BQ) {
    const int qt = min(BQ, tq - i0);
    __syncthreads();
    load_tile<T, D>(q_s, qb, qs.t, i0, qt, BQ);
    load_tile<T, D>(do_s, db, dos.t, i0, qt, BQ);
    for (int idx = tid; idx < qt * 3; idx += kThreads)
      st_s[idx] = sb[(long long)i0 * 3 + idx];
    __syncthreads();
    for (int i = 0; i < qt; ++i) {
      const float* qrow = q_s + i * RS + part * kSeg;
      const float* drow = do_s + i * RS + part * kSeg;
      const float sd = row_sum<G>(dot32(kr, qrow));
      const float dpi = row_sum<G>(dot32(vr, drow));
      const float p = expf(sd * scale + bias - st_s[3 * i]) / st_s[3 * i + 1];
      const float pc = w2v_round(p, q);
      const float ds = w2v_round(p * (dpi - st_s[3 * i + 2]), q);
      const float4* q4 = reinterpret_cast<const float4*>(qrow);
      const float4* d4 = reinterpret_cast<const float4*>(drow);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 qq = q4[c];
        const float4 dd = d4[c];
        dv_acc[4 * c] += pc * dd.x;
        dv_acc[4 * c + 1] += pc * dd.y;
        dv_acc[4 * c + 2] += pc * dd.z;
        dv_acc[4 * c + 3] += pc * dd.w;
        dk_acc[4 * c] += ds * qq.x;
        dk_acc[4 * c + 1] += ds * qq.y;
        dk_acc[4 * c + 2] += ds * qq.z;
        dk_acc[4 * c + 3] += ds * qq.w;
      }
    }
  }

  if (active && real) {
    T* kp = dk + b * dks.b + (long long)kj * dks.t + h * dks.h + part * 32;
    T* vp = dv + b * dvs.b + (long long)kj * dvs.t + h * dvs.h + part * 32;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      w2v_store(kp + i, dk_acc[i] * scale);
      w2v_store(vp + i, dv_acc[i]);
    }
  }
}

template <typename T, int D>
int launch_attn_bwd(const void* q, const void* k, const void* v,
                    const unsigned char* key_mask, const void* dout,
                    void* dq, void* dk, void* dv, float* stats, int b, int tq,
                    int tk, int heads, const Strides* st, float scale,
                    cudaStream_t stream) {
  constexpr int G = padded_dim<D>() / 32;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const dim3 grid1((tq + kThreads / G - 1) / (kThreads / G), heads, b);
  attn_bwd_dq_kernel<T, D><<<grid1, kThreads, 0, stream>>>(
      qt, kt, vt, key_mask, dot, static_cast<T*>(dq), stats, tq, tk, st[0],
      st[1], st[2], st[3], st[4], scale);
  int status = (int)cudaGetLastError();
  if (status != 0) return status;
  const dim3 grid2((tk + kThreads / G - 1) / (kThreads / G), heads, b);
  attn_bwd_dkdv_kernel<T, D><<<grid2, kThreads, 0, stream>>>(
      qt, kt, vt, key_mask, dot, static_cast<T*>(dk), static_cast<T*>(dv),
      stats, tq, tk, st[0], st[1], st[2], st[3], st[5], st[6], scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v,
               const unsigned char* key_mask, const void* dout, void* dq,
               void* dk, void* dv, float* stats, int b, int tq, int tk,
               int heads, int d, const Strides* st, float scale,
               cudaStream_t stream) {
  if (d == 64)
    return launch_attn_bwd<T, 64>(q, k, v, key_mask, dout, dq, dk, dv, stats,
                                  b, tq, tk, heads, st, scale, stream);
  if (d == 96)
    return launch_attn_bwd<T, 96>(q, k, v, key_mask, dout, dq, dk, dv, stats,
                                  b, tq, tk, heads, st, scale, stream);
  if (d == 128)
    return launch_attn_bwd<T, 128>(q, k, v, key_mask, dout, dq, dk, dv, stats,
                                   b, tq, tk, heads, st, scale, stream);
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
// dtype W2V_F32 runs the scalar kernels (o and stats unused; rows a
// [b, heads, tq, 3] float32 workspace).  W2V_BF16 runs the
// tensor-core ones: o [b, tq, heads, d] is the forward's output and stats
// [b, heads, tq, 2] float32 its (m, l) (w2v_attention); rows is a
// [b, heads, tq, 4] float32 workspace; q, k, v and do need 16-byte-aligned
// starts and strides that are multiples of 8 elements, o, dq, dk and dv
// even strides (else W2V_BAD_ARGS).  Launches the pre-pass, the dq kernel
// and the dk/dv kernel on `stream`; returns the first non-zero
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
    return dispatch_d<float>(q, k, v, mask, dout, dq, dk, dv, ws, b, tq, tk,
                             heads, d, st, scale, cs);
  if (dtype == W2V_BF16)
    return dispatch_tc(q, k, v, mask, dout, dq, dk, dv, o, stats, ws, b, tq,
                       tk, heads, d, st, scale, cs);
  return W2V_BAD_ARGS;
}
