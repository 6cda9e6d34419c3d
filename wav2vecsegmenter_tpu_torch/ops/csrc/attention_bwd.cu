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
// dP: about 8 * T^2 * D FLOP per (batch, head) against O(T * D) bytes.  The
// products are scalar float32 FMAs here (tensor cores are later work).
// Design: no atomics, so the sums run in a fixed order and two runs give
// the same bits.  The TPU kernel walked query blocks in grid order and
// accumulated dK and dV in revisited output blocks; blocks on the card run
// in parallel, so the work splits by what each output sums over:
//   1. attn_bwd_dq_kernel, one block per (batch, head, tile of queries):
//      a first sweep over the keys computes each query row's max, sum of
//      exponentials and delta (online, rescaled per chunk of keys, as the
//      forward kernel does its softmax); a second sweep forms dS and dq.
//      The row statistics go to a [B, H, Tq, 3] float32 workspace.
//   2. attn_bwd_dkdv_kernel, one block per (batch, head, tile of keys): a
//      sweep over all query rows (q, do and the statistics through shared
//      memory) forms P and dS for its keys and accumulates dk and dv.
// Layout as in the forward kernel: a row (query or key) is owned by D/32
// neighbouring lanes, 32 head dims each, its operands and accumulators in
// registers; the other side streams through shared memory as float32 tiles
// of 4096/D rows, each 32-dim segment padded by 4 floats; partial dot
// products meet through warp shuffles.  Masked keys score -1e30, so a row
// whose keys are all masked gets a uniform finite P.  The TPU-only padding
// of the query axis to block_q = 256 and the [B,T,H,D] -> [B,H,T,D]
// transposes are not rebuilt: the kernels take (batch, time, head) strides.

#include <math.h>

#include "common.cuh"

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

}  // namespace

// q, do, dq: [b, tq, heads, d]; k, v, dk, dv: [b, tk, heads, d]; element
// (b, t, h, 0..d) of operand n at ptr + b*s[3n] + t*s[3n+1] + h*s[3n+2],
// head dim contiguous, operands in the order q, k, v, do, dq, dk, dv of the
// host array `strides` (21 long longs).  key_mask: [b, tk] bytes (nonzero =
// valid key) or NULL.  stats: [b, heads, tq, 3] float32 workspace.  d is 64
// or 128.  Launches two kernels on `stream`; returns the first non-zero
// cudaError_t.
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
    return dispatch_d<__nv_bfloat16>(q, k, v, mask, dout, dq, dk, dv, ws, b,
                                     tq, tk, heads, d, st, scale, cs);
  return W2V_BAD_ARGS;
}
