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
// the work splits by what each output sums over:
//   1. attn_bwd_dq_*kernel, one block per (batch, head, tile of queries): a
//      first sweep over the keys computes each query row's max, sum of
//      exponentials and delta (online, rescaled per tile of keys, as the
//      forward kernel does its softmax); a second sweep forms dS and dq.
//      The row statistics go to a [B, H, Tq, 3] float32 workspace.
//   2. attn_bwd_dkdv_*kernel, one block per (batch, head, tile of keys): a
//      sweep over all query rows (q, do and the statistics through shared
//      memory) forms P and dS for its keys and accumulates dk and dv.
// Masked keys score -1e30, so a row whose keys are all masked gets a
// uniform finite P.  The TPU-only padding of the query axis to block_q =
// 256 and the [B,T,H,D] -> [B,H,T,D] transposes are not rebuilt: the
// kernels take (batch, time, head) strides.  Two designs:
//
// bf16: attn_bwd_{dq,dkdv}_tc_kernel, tensor cores through mma.sync
//   m16n8k16 (bf16 in, float32 sums).  Four warps a block, 16 rows of the
//   block's 64-row tile each (query rows in kernel 1, key rows in kernel 2);
//   the block's own rows (Q and dO, or K and V) sit in shared memory, and
//   the other side streams through a double-buffered cp.async ring of bf16
//   tiles (64 rows at D=64, 32 at D=128, where dk and dv hold 128 floats a
//   thread), rows past T zero-filled by the copy.  Every product is an
//   mma.sync: S = Q K^T and dP = dO V^T (kernel 2: their transposes K Q^T,
//   V dO^T) with both operands by ldmatrix; dq += T(dS) K, dv += T(P)^T dO
//   and dk += T(dS)^T Q take the rounded P or dS from the accumulator (its
//   C fragment is the A fragment) and the other operand by ldmatrix.trans.
//   Shared rows are D + 8 bf16 wide, so the eight rows of an ldmatrix phase
//   hit distinct banks.  Scores are kept in log2 units (exp2).  Skip rules:
//   kernel 1 visits only the key tiles holding a valid key (all of them
//   when the batch row has none), and kernel 2 writes zeros for a key tile
//   whose keys are all masked in a batch row with a valid key (P = 0 there
//   exactly).  Under tensor cores kernel 2's recomputed scores need not
//   equal kernel 1's bit for bit (another summation order), as the scalar
//   kernels' shared dot32 made them; the bf16 tolerances cover that.
// float32 (the oracle arm, TF32 off): attn_bwd_{dq,dkdv}_kernel, scalar
//   FMAs, as before: a row (query or key) is owned by D/32 neighbouring
//   lanes, 32 head dims each, its operands and accumulators in registers;
//   the other side streams through shared memory as float32 tiles of 4096/D
//   rows, each 32-dim segment padded by 4 floats; partial dot products meet
//   through warp shuffles.  TF32 tensor cores would miss the arm's 1e-4
//   gradient tolerance.

#include <math.h>

#include "gemm.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSeg = 36;    // 32 head dims + 4 floats of bank padding
constexpr int kChunk = 16;  // keys scored before each rescale of sweep 1

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
// padded float32 tile of `rows` rows; rows past n are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long st, int r0, int n,
                                          int rows) {
  constexpr int RS = (D / 32) * kSeg;
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int j = idx / D;
    const int c = idx % D;
    dst[j * RS + (c / 32) * kSeg + (c % 32)] =
        j < n ? w2v_load(src + (long long)(r0 + j) * st + c) : 0.f;
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
  constexpr int G = D / 32;             // lanes per query row
  constexpr int BQ = kThreads / G;      // query rows per block
  constexpr int BK = 4096 / D;          // key rows per shared-memory tile
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
      qr[i] = active ? w2v_load(qp + i) : 0.f;
      dor[i] = active ? w2v_load(dp + i) : 0.f;
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
#pragma unroll
    for (int i = 0; i < 32; ++i) w2v_store(op + i, acc[i] * scale);
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
  constexpr int G = D / 32;             // lanes per key row
  constexpr int BKR = kThreads / G;     // key rows per block
  constexpr int BQ = 4096 / D;          // query rows per shared-memory tile
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
      kr[i] = active ? w2v_load(kp + i) : 0.f;
      vr[i] = active ? w2v_load(vp + i) : 0.f;
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

  if (active) {
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
  constexpr int G = D / 32;
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
  if (d == 128)
    return launch_attn_bwd<T, 128>(q, k, v, key_mask, dout, dq, dk, dv, stats,
                                   b, tq, tk, heads, st, scale, stream);
  return W2V_BAD_ARGS;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;      // rows of a CTA's own tile: 4 warps x 16
constexpr int kTcThreads = 128;
constexpr int kTcStream64 = 64;  // rows a streamed tile at D=64
constexpr int kTcStream128 = 32;  // and at D=128 (registers: dk and dv)

template <int D>
struct TcBwd {
  static constexpr int BN = D == 64 ? kTcStream64 : kTcStream128;
  static constexpr int LD = D + 8;   // shared-memory row in bf16: the eight
                                     // rows of an ldmatrix hit distinct banks
  static constexpr int CPR = D / 8;  // 16-byte copies a row
  static constexpr int kOwn = kTcRows * LD;   // bf16 of an own tile
  static constexpr int kStream = BN * LD;     // bf16 of a streamed tile
  // two own tiles, then two ring stages of two streamed tiles
  static constexpr int kTileBytes = 2 * (2 * kOwn + 4 * kStream);
};

// rows [r0, r0 + rows) of one (batch, head) of an operand into a padded
// shared tile by cp.async, rows at or past n as zeros
template <int D>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long st, int r0, int rows,
                                          int n) {
  using L = TcBwd<D>;
  for (int idx = threadIdx.x; idx < rows * L::CPR; idx += kTcThreads) {
    const int r = idx / L::CPR, ch = idx % L::CPR;
    const bool ok = r0 + r < n;
    w2v_cp_async16(dst + r * L::LD + ch * 8,
                   src + (ok ? (long long)(r0 + r) * st : 0) + ch * 8, ok);
  }
}

// acc[NT][4] += A (16 rows of `a`, from row 16 * warp) . B^T, B the rows of
// `bt` (NT * 8 of them): K = D, both operands row-major in shared memory
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4],
                                        const __nv_bfloat16* a,
                                        const __nv_bfloat16* bt) {
  constexpr int LD = TcBwd<D>::LD;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned af[4];
    w2v_ldmatrix_x4(af, a + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < NT / 2; ++nj) {
      unsigned bf[4];
      w2v_ldmatrix_x4(bf, bt + (nj * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                              kk * 16 + ((lane >> 3) & 1) * 8);
      w2v_mma_bf16(acc[2 * nj], af, bf[0], bf[1]);
      w2v_mma_bf16(acc[2 * nj + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[D/8][4] += T(x) . B, x a [16, KT*8] accumulator in registers (rounded
// to bf16 here: its C fragment is the A fragment), B the KT*8 rows of `b`
// in shared memory (row = the product's K, D contiguous; ldmatrix.trans)
template <int D, int KT>
__device__ __forceinline__ void mma_xb(float (&acc)[D / 8][4],
                                       const float (&x)[KT][4],
                                       const __nv_bfloat16* b) {
  constexpr int LD = TcBwd<D>::LD;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < KT / 2; ++kk) {
    const unsigned af[4] = {w2v_pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            w2v_pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            w2v_pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            w2v_pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dj = 0; dj < D / 16; ++dj) {
      unsigned bf[4];
      w2v_ldmatrix_x4_trans(
          bf, b + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                  dj * 16 + (lane >> 4) * 8);
      w2v_mma_bf16(acc[2 * dj], af, bf[0], bf[1]);
      w2v_mma_bf16(acc[2 * dj + 1], af, bf[2], bf[3]);
    }
  }
}

// rows of a [16 * 4, D] accumulator (row0 + 16 warp + lane / 4, + 8) below
// n to dst through its time stride, times `mul`, as bf16 pairs
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long st,
                                           const float (&acc)[D / 8][4],
                                           int row0, int n, float mul) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + lane / 4 + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* p = dst + (long long)row * st + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) = __floats2bfloat162_rn(
          acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
attn_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const unsigned char* __restrict__ key_mask,
                      const __nv_bfloat16* __restrict__ dout,
                      __nv_bfloat16* __restrict__ dq, float* __restrict__ stats,
                      int tq, int tk, Strides qs, Strides ks, Strides vs,
                      Strides dos, Strides dqs, float scale_log2,
                      float scale) {
  using L = TcBwd<D>;
  constexpr int BN = L::BN, NT = BN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* do_s = q_s + L::kOwn;
  __nv_bfloat16* ring = do_s + L::kOwn;  // stage s: k at 2 s kStream, v after
  const int ntiles = (tk + BN - 1) / BN;
  int* count = reinterpret_cast<int*>(smem + L::kTileBytes);
  int* tiles = count + 4;
  unsigned char* flag_s = reinterpret_cast<unsigned char*>(tiles + ntiles);
  unsigned char* mask_s = flag_s + ntiles;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int quad = lane % 4;
  const int q0 = blockIdx.x * kTcRows;
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

  copy_rows<D>(q_s, q + b * qs.b + h * qs.h, qs.t, q0, kTcRows, tq);
  copy_rows<D>(do_s, dout + b * dos.b + h * dos.h, dos.t, q0, kTcRows, tq);
  w2v_cp_async_commit();
  w2v_key_tiles(key_mask ? key_mask + (long long)b * tk : nullptr, tk, BN,
                mask_s, flag_s, count, tiles);
  const int n = *count;

  auto load = [&](int it) {
    __nv_bfloat16* st = ring + (it & 1) * 2 * L::kStream;
    const int k0 = tiles[it % n] * BN;
    copy_rows<D>(st, kb, ks.t, k0, BN, tk);
    copy_rows<D>(st + L::kStream, vb, vs.t, k0, BN, tk);
  };

  // sweep 1 (it < n): row max m, sum of exponentials l and sum of
  // exp * dP online; sweep 2 (it >= n): dS and dq over the same tiles
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  float delta[2];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  load(0);
  w2v_cp_async_commit();
  for (int it = 0; it < 2 * n; ++it) {
    if (it + 1 < 2 * n) load(it + 1);
    w2v_cp_async_commit();
    w2v_cp_async_wait<1>();
    __syncthreads();  // tile it has landed
    if (it == n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
        dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
        delta[r] = dsum[r] / l[r];
      }
    }
    const __nv_bfloat16* k_s = ring + (it & 1) * 2 * L::kStream;
    const __nv_bfloat16* v_s = k_s + L::kStream;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<D, NT>(s, q_s, k_s);
    mma_abt<D, NT>(dp, do_s, v_s);
    const int k0 = tiles[it % n] * BN;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * quad + (e & 1);
        const float bias =
            key < tk ? (mask_s[key] ? 0.f : -1e30f) : -INFINITY;
        s[j][e] = s[j][e] * scale_log2 + bias;
      }
    if (it < n) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        const float alpha = exp2f(m[r] - m_new);
        l[r] *= alpha;
        dsum[r] *= alpha;
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - m[e >> 1]);
          l[e >> 1] += p;
          dsum[e >> 1] += p * dp[j][e];
        }
    } else {
      // dS = P (dP - delta), P normalised; rounded to bf16 in mma_xb
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = exp2f(s[j][e] - m[r]) / l[r];
          s[j][e] = p * (dp[j][e] - delta[r]);
        }
      mma_xb<D, NT>(acc, s, k_s);
    }
    __syncthreads();  // this stage is free for the load of tile it + 2
  }
  w2v_cp_async_wait<0>();

  store_rows<D>(dq + b * dqs.b + h * dqs.h, dqs.t, acc, q0, tq, scale);
  if (quad == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + lane / 4 + 8 * r;
      if (row >= tq) continue;
      float* st = stats + (((long long)b * heads + h) * tq + row) * 3;
      st[0] = m[r];
      st[1] = l[r];
      st[2] = delta[r];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
attn_bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const unsigned char* __restrict__ key_mask,
                        const __nv_bfloat16* __restrict__ dout,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv,
                        const float* __restrict__ stats, int tq, int tk,
                        Strides qs, Strides ks, Strides vs, Strides dos,
                        Strides dks, Strides dvs, float scale_log2,
                        float scale) {
  using L = TcBwd<D>;
  constexpr int BN = L::BN, NT = BN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_s = k_s + L::kOwn;
  __nv_bfloat16* ring = v_s + L::kOwn;  // stage s: q at 2 s kStream, do after
  float* st_s = reinterpret_cast<float*>(smem + L::kTileBytes);  // [2][BN][3]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int quad = lane % 4;
  const int k0 = blockIdx.x * kTcRows;
  const int h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  __nv_bfloat16* dkb = dk + b * dks.b + h * dks.h;
  __nv_bfloat16* dvb = dv + b * dvs.b + h * dvs.h;

  // skip rule: keys that are all masked, in a batch row with a valid key,
  // get P = 0 for every query, so dk = dv = 0 exactly
  const unsigned char* mrow = key_mask ? key_mask + (long long)b * tk : nullptr;
  int row_any = 1, tile_any = 1;
  if (mrow != nullptr) {
    int any = 0;
    for (int j = tid; j < tk; j += kTcThreads) any |= mrow[j] != 0;
    row_any = __syncthreads_or(any);
    any = tid < kTcRows && k0 + tid < tk && mrow[k0 + tid] != 0;
    tile_any = __syncthreads_or(any);
  }
  float ka[D / 8][4], va[D / 8][4];  // dk and dv sums
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ka[j][e] = va[j][e] = 0.f;
  if (row_any && !tile_any) {
    store_rows<D>(dkb, dks.t, ka, k0, tk, 0.f);
    store_rows<D>(dvb, dvs.t, va, k0, tk, 0.f);
    return;
  }

  copy_rows<D>(k_s, k + b * ks.b + h * ks.h, ks.t, k0, kTcRows, tk);
  copy_rows<D>(v_s, v + b * vs.b + h * vs.h, vs.t, k0, kTcRows, tk);
  w2v_cp_async_commit();
  // this thread's key rows k0 + 16 warp + lane / 4 (+ 8): their biases
  float bias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + lane / 4 + 8 * r;
    bias[r] = key >= tk ? -INFINITY
                        : (mrow == nullptr || mrow[key] ? 0.f : -1e30f);
  }
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* db = dout + b * dos.b + h * dos.h;
  const float* sb = stats + ((long long)b * heads + h) * tq * 3;
  const int nq = (tq + BN - 1) / BN;
  auto load = [&](int it) {
    __nv_bfloat16* st = ring + (it & 1) * 2 * L::kStream;
    copy_rows<D>(st, qb, qs.t, it * BN, BN, tq);
    copy_rows<D>(st + L::kStream, db, dos.t, it * BN, BN, tq);
    float* ss = st_s + (it & 1) * BN * 3;
    for (int idx = tid; idx < BN * 3; idx += kTcThreads)
      ss[idx] = it * BN + idx / 3 < tq ? sb[(long long)it * BN * 3 + idx]
                                       : 0.f;
  };

  load(0);
  w2v_cp_async_commit();
  for (int it = 0; it < nq; ++it) {
    if (it + 1 < nq) load(it + 1);
    w2v_cp_async_commit();
    w2v_cp_async_wait<1>();
    __syncthreads();  // query tile it (and its statistics) has landed
    const __nv_bfloat16* q_t = ring + (it & 1) * 2 * L::kStream;
    const __nv_bfloat16* do_t = q_t + L::kStream;
    const float* ss = st_s + (it & 1) * BN * 3;
    // S^T = K Q^T and dP^T = V dO^T: rows = this CTA's keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<D, NT>(s, k_s, q_t);
    mma_abt<D, NT>(dp, v_s, do_t);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * quad + (e & 1);  // query in the tile
        float p = 0.f, ds = 0.f;
        if (it * BN + col < tq) {
          p = exp2f(s[j][e] * scale_log2 + bias[e >> 1] - ss[3 * col]) /
              ss[3 * col + 1];
          ds = p * (dp[j][e] - ss[3 * col + 2]);
        }
        s[j][e] = p;
        dp[j][e] = ds;
      }
    mma_xb<D, NT>(va, s, do_t);  // dv += T(P^T) dO
    mma_xb<D, NT>(ka, dp, q_t);  // dk += T(dS^T) Q
    __syncthreads();  // this stage is free for the load of tile it + 2
  }
  w2v_cp_async_wait<0>();
  store_rows<D>(dkb, dks.t, ka, k0, tk, scale);
  store_rows<D>(dvb, dvs.t, va, k0, tk, 1.f);
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v,
              const unsigned char* key_mask, const void* dout, void* dq,
              void* dk, void* dv, float* stats, int b, int tq, int tk,
              int heads, const Strides* st, float scale,
              cudaStream_t stream) {
  using L = TcBwd<D>;
  // cp.async moves 16-byte chunks: q, k, v and do need 16-byte alignment
  // and strides of whole chunks; the bf16 pair stores of dq, dk and dv
  // 4-byte alignment and even strides
  const void* in[4] = {q, k, v, dout};
  const void* outs[3] = {dq, dk, dv};
  for (int n = 0; n < 4; ++n)
    if (reinterpret_cast<uintptr_t>(in[n]) % 16 || st[n].b % 8 ||
        st[n].t % 8 || st[n].h % 8)
      return W2V_BAD_ARGS;
  for (int n = 0; n < 3; ++n)
    if (reinterpret_cast<uintptr_t>(outs[n]) % 4 || st[4 + n].b % 2 ||
        st[4 + n].t % 2 || st[4 + n].h % 2)
      return W2V_BAD_ARGS;
  const int ntiles = (tk + L::BN - 1) / L::BN;
  const long long smem1 = L::kTileBytes + 16 + 5LL * ntiles + tk;
  const long long smem2 = L::kTileBytes + 2 * L::BN * 3 * 4;
  if (smem1 > 227 * 1024) return W2V_BAD_ARGS;
  const float scale_log2 = scale * 1.4426950408889634f;
  const auto* qt = static_cast<const __nv_bfloat16*>(q);
  const auto* kt = static_cast<const __nv_bfloat16*>(k);
  const auto* vt = static_cast<const __nv_bfloat16*>(v);
  const auto* dot = static_cast<const __nv_bfloat16*>(dout);
  int status = (int)cudaFuncSetAttribute(
      attn_bwd_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (status != 0) return status;
  const dim3 grid1((tq + kTcRows - 1) / kTcRows, heads, b);
  attn_bwd_dq_tc_kernel<D><<<grid1, kTcThreads, smem1, stream>>>(
      qt, kt, vt, key_mask, dot, static_cast<__nv_bfloat16*>(dq), stats, tq,
      tk, st[0], st[1], st[2], st[3], st[4], scale_log2, scale);
  status = (int)cudaGetLastError();
  if (status != 0) return status;
  status = (int)cudaFuncSetAttribute(
      attn_bwd_dkdv_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (status != 0) return status;
  const dim3 grid2((tk + kTcRows - 1) / kTcRows, heads, b);
  attn_bwd_dkdv_tc_kernel<D><<<grid2, kTcThreads, smem2, stream>>>(
      qt, kt, vt, key_mask, dot, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), stats, tq, tk, st[0], st[1], st[2],
      st[3], st[5], st[6], scale_log2, scale);
  return (int)cudaGetLastError();
}

int dispatch_tc(const void* q, const void* k, const void* v,
                const unsigned char* key_mask, const void* dout, void* dq,
                void* dk, void* dv, float* stats, int b, int tq, int tk,
                int heads, int d, const Strides* st, float scale,
                cudaStream_t stream) {
  if (d == 64)
    return launch_tc<64>(q, k, v, key_mask, dout, dq, dk, dv, stats, b, tq,
                         tk, heads, st, scale, stream);
  if (d == 128)
    return launch_tc<128>(q, k, v, key_mask, dout, dq, dk, dv, stats, b, tq,
                          tk, heads, st, scale, stream);
  return W2V_BAD_ARGS;
}

}  // namespace

// q, do, dq: [b, tq, heads, d]; k, v, dk, dv: [b, tk, heads, d]; element
// (b, t, h, 0..d) of operand n at ptr + b*s[3n] + t*s[3n+1] + h*s[3n+2],
// head dim contiguous, operands in the order q, k, v, do, dq, dk, dv of the
// host array `strides` (21 long longs).  key_mask: [b, tk] bytes (nonzero =
// valid key) or NULL.  stats: [b, heads, tq, 3] float32 workspace.  d is 64
// or 128.  dtype W2V_F32 runs the scalar kernels, W2V_BF16 the tensor-core
// ones, which also need q, k, v and do 16-byte aligned with strides that
// are multiples of 8 elements, and dq, dk, dv with even strides (else
// W2V_BAD_ARGS).  Launches two kernels on `stream`; returns the first
// non-zero cudaError_t.
extern "C" int w2v_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* key_mask, const void* dout,
                                 void* dq, void* dk, void* dv, void* stats,
                                 const void* strides, int b, int tq, int tk,
                                 int heads, int d, float scale, int dtype,
                                 void* stream) {
  if (b <= 0 || tq <= 0 || tk <= 0 || heads <= 0 || b > 65535 ||
      heads > 65535 || strides == nullptr)
    return W2V_BAD_ARGS;
  const long long* s = static_cast<const long long*>(strides);
  Strides st[7];
  for (int n = 0; n < 7; ++n) st[n] = Strides{s[3 * n], s[3 * n + 1],
                                              s[3 * n + 2]};
  const unsigned char* mask = static_cast<const unsigned char*>(key_mask);
  float* ws = static_cast<float*>(stats);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == W2V_F32)
    return dispatch_d<float>(q, k, v, mask, dout, dq, dk, dv, ws, b, tq, tk,
                             heads, d, st, scale, cs);
  if (dtype == W2V_BF16)
    return dispatch_tc(q, k, v, mask, dout, dq, dk, dv, ws, b, tq, tk, heads,
                       d, st, scale, cs);
  return W2V_BAD_ARGS;
}
