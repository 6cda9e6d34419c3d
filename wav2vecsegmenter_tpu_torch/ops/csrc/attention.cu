// Multi-head attention forward over key-padded windows, read through strides.
//
// Replaces two Pallas kernels of wav2vecsegmenter_tpu/ops/attention.py:
//   _attn_fwd_packed_kernel (K3): heads read straight from the fused QKV
//       projection [B, T, 3H] (encoder, 16 heads of D=64);
//   _attn_fwd_kernel        (K4): q/k/v [B, T, H, D] (SFC head, 8 heads of
//       D=128).
// Both are one computation: out[b,i,h] = softmax_j(q.k * scale + bias_j) . v
// with bias_j = 0 for a valid key and -1e30 for a padded one.  The kernel
// takes element strides for (batch, time, head) of every operand with the
// head dim contiguous, so the packed layout, the [B,T,H,D] views and the
// output need no transpose; on the TPU, lane pairing and transposes did
// that job.
//
// Bound on the H100: operations.  4 * T^2 * D FLOP per (batch, head) against
// O(T * D) bytes — ~57 GFLOP per encoder layer at [14, 999] — and the
// products here are scalar float32 FMAs (products may move to mma.sync or
// wgmma later).  Design: one block of 128 threads per (batch, head, tile of
// 4096/D queries).  A query row is owned by D/32 neighbouring lanes, 32 head
// dims each, with its q slice and output accumulator in registers; the
// partial dot products meet through warp shuffles.  Keys and values stream
// through shared memory in tiles of 4096/D rows (float32, each 32-dim
// segment padded by 4 floats so the float4 reads of the lanes of one row
// hit distinct banks).  An online softmax with float32 statistics walks the
// key tiles in chunks of 16: running max m (starting at -1e30), running sum
// l, rescale by exp(m_old - m_new); the division by l happens once at the
// end.  Masked keys score -1e30, not -inf: a row whose keys are all masked
// (batch padding, 1-frame windows' tails) then averages its values with
// finite weights, as the TPU kernel does, instead of producing NaN that
// would reach the next layer's keys.  As in the TPU kernel, the unnormalised
// probabilities are rounded to the input type before the PV product.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSeg = 36;    // 32 head dims + 4 floats of bank padding
constexpr int kChunk = 16;  // keys scored before each softmax rescale

struct Strides {
  long long b, t, h;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v,
                const unsigned char* __restrict__ key_mask,
                T* __restrict__ out, int tq, int tk, Strides qs, Strides ks,
                Strides vs, Strides os, float scale) {
  constexpr int G = D / 32;             // lanes per query row
  constexpr int BQ = kThreads / G;      // query rows per block
  constexpr int BK = 4096 / D;          // key rows per shared-memory tile
  constexpr int RS = G * kSeg;          // shared-memory row stride (floats)
  static_assert(BK % kChunk == 0, "key tile must hold whole chunks");

  __shared__ __align__(16) float k_s[BK * RS];
  __shared__ __align__(16) float v_s[BK * RS];
  __shared__ float bias_s[BK];

  const int tid = threadIdx.x;
  const int part = tid % G;             // which 32 head dims
  const int qi = blockIdx.x * BQ + tid / G;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool active = qi < tq;

  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const unsigned char* mb = key_mask ? key_mask + (long long)b * tk : nullptr;

  float qr[32];
  float acc[32];
  {
    const T* qp = q + b * qs.b + (long long)(active ? qi : 0) * qs.t +
                  h * qs.h + part * 32;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      qr[i] = active ? w2v_load(qp + i) : 0.f;
      acc[i] = 0.f;
    }
  }
  float m = -1e30f;
  float l = 0.f;

  for (int k0 = 0; k0 < tk; k0 += BK) {
    const int kt = min(BK, tk - k0);
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int j = idx / D;
      const int c = idx % D;
      const int so = j * RS + (c / 32) * kSeg + (c % 32);
      float kv = 0.f, vv = 0.f;
      if (j < kt) {
        const long long t = k0 + j;
        kv = w2v_load(kb + t * ks.t + c);
        vv = w2v_load(vb + t * vs.t + c);
      }
      k_s[so] = kv;
      v_s[so] = vv;
    }
    for (int j = tid; j < BK; j += kThreads)
      bias_s[j] = (mb == nullptr || (j < kt && mb[k0 + j])) ? 0.f : -1e30f;
    __syncthreads();

    for (int j0 = 0; j0 < kt; j0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c;
        const float4* kr =
            reinterpret_cast<const float4*>(k_s + j * RS + part * kSeg);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 kk = kr[i];
          dot += qr[4 * i] * kk.x + qr[4 * i + 1] * kk.y +
                 qr[4 * i + 2] * kk.z + qr[4 * i + 3] * kk.w;
        }
#pragma unroll
        for (int o = 1; o < G; o <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[c] = j < kt ? dot * scale + bias_s[j] : -INFINITY;
        cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float p = expf(s[c] - m_new);
        l += p;
        const float pv = w2v_round(p, q);
        const float4* vr = reinterpret_cast<const float4*>(
            v_s + (j0 + c) * RS + part * kSeg);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 vv = vr[i];
          acc[4 * i] += pv * vv.x;
          acc[4 * i + 1] += pv * vv.y;
          acc[4 * i + 2] += pv * vv.z;
          acc[4 * i + 3] += pv * vv.w;
        }
      }
      m = m_new;
    }
  }

  if (active) {
    T* op = out + b * os.b + (long long)qi * os.t + h * os.h + part * 32;
#pragma unroll
    for (int i = 0; i < 32; ++i) w2v_store(op + i, acc[i] / l);
  }
}

template <typename T, int D>
int launch_attn(const void* q, const void* k, const void* v,
                const unsigned char* key_mask, void* out, int b, int tq,
                int tk, int heads, Strides qs, Strides ks, Strides vs,
                Strides os, float scale, cudaStream_t stream) {
  constexpr int BQ = kThreads / (D / 32);
  const dim3 grid((tq + BQ - 1) / BQ, heads, b);
  attn_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), key_mask, static_cast<T*>(out), tq, tk, qs,
      ks, vs, os, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v,
               const unsigned char* key_mask, void* out, int b, int tq,
               int tk, int heads, int d, Strides qs, Strides ks, Strides vs,
               Strides os, float scale, cudaStream_t stream) {
  if (d == 64)
    return launch_attn<T, 64>(q, k, v, key_mask, out, b, tq, tk, heads, qs,
                              ks, vs, os, scale, stream);
  if (d == 128)
    return launch_attn<T, 128>(q, k, v, key_mask, out, b, tq, tk, heads, qs,
                               ks, vs, os, scale, stream);
  return W2V_BAD_ARGS;
}

}  // namespace

// q, k, v, out: element (b, t, h, 0..d) at ptr + b*sb + t*st + h*sh, head
// dim contiguous.  key_mask: [b, tk] bytes (nonzero = valid key) or NULL for
// no padding.  Launches on `stream`; returns the launch's cudaError_t.
extern "C" int w2v_attention(
    const void* q, const void* k, const void* v, const void* key_mask,
    void* out, int b, int tq, int tk, int heads, int d, long long q_sb,
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
    return dispatch_d<float>(q, k, v, mask, out, b, tq, tk, heads, d, qs, ks,
                             vs, os, scale, s);
  if (dtype == W2V_BF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, mask, out, b, tq, tk, heads, d,
                                     qs, ks, vs, os, scale, s);
  return W2V_BAD_ARGS;
}
