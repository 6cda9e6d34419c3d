// Row LayerNorm with an optional (conv bias, exact GELU) epilogue.
//
// Replaces two Pallas kernels of wav2vecsegmenter_tpu/ops/layernorm.py:
//   _ln_kernel        (gelu = 0): y = LN(x) * scale + bias
//   _bln_gelu_kernel  (gelu = 1): y = GELU(LN(x + conv_bias) * scale + bias)
// Statistics in float32 (mean, biased variance, eps inside the rsqrt), the
// result cast back to the input type.  GELU is the exact erf form; the TPU
// kernel used the Abramowitz-Stegun polynomial only because Mosaic has no erf.
//
// Bound on the H100: bytes.  Each row is read once and written once, about
// 2 FLOP per byte, far below the card's ~295 FLOP/byte ridge; the largest
// call is the first conv layer's [14 * 63999, 512] bf16 output (~0.9 GB
// each way).  Design: one warp per row, the row held in registers (h/32
// values a lane), so the two reductions (mean, then variance about the
// mean) cost warp shuffles and no second read of memory.  Neighbouring lanes
// touch neighbouring elements, so every load and store is coalesced.  The
// ragged last block needs no padding: a warp whose row is past the end
// returns, and there is no cross-row state.

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // 8 warps = 256 threads

template <typename T, int VPL, bool GELU>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ conv_bias,
               const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ out,
               long long rows, int h, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * h;
  T* outr = out + row * h;

  float v[VPL];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    float a = 0.f;
    if (c < h) {
      a = w2v_load(xr + c);
      if (GELU) a += conv_bias[c];
    }
    v[i] = a;
    sum += a;
  }
  const float mean = w2v_warp_sum(sum) / h;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    const float d = v[i] - mean;
    if (c < h) sq += d * d;
  }
  const float rstd = rsqrtf(w2v_warp_sum(sq) / h + eps);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < h) {
      float y = (v[i] - mean) * rstd * scale[c] + bias[c];
      if (GELU) y = 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
      w2v_store(outr + c, y);
    }
  }
}

template <typename T, bool GELU>
int launch_ln(const void* x, const float* conv_bias, const float* scale,
              const float* bias, void* out, long long rows, int h,
              float eps, cudaStream_t stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (h <= 0 || h > 1024 || rows <= 0 || blocks > 0x7fffffffLL)
    return W2V_BAD_ARGS;
  const dim3 grid((unsigned)blocks), block(kRowsPerBlock * 32);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const int vpl = (h + 31) / 32;
  if (vpl <= 4)
    ln_rows_kernel<T, 4, GELU><<<grid, block, 0, stream>>>(
        xt, conv_bias, scale, bias, ot, rows, h, eps);
  else if (vpl <= 8)
    ln_rows_kernel<T, 8, GELU><<<grid, block, 0, stream>>>(
        xt, conv_bias, scale, bias, ot, rows, h, eps);
  else if (vpl <= 16)
    ln_rows_kernel<T, 16, GELU><<<grid, block, 0, stream>>>(
        xt, conv_bias, scale, bias, ot, rows, h, eps);
  else
    ln_rows_kernel<T, 32, GELU><<<grid, block, 0, stream>>>(
        xt, conv_bias, scale, bias, ot, rows, h, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [rows, h] contiguous; conv_bias (gelu only), scale, bias: [h]
// float32.  Launches on `stream`; returns the launch's cudaError_t.
extern "C" int w2v_layer_norm(const void* x, const void* conv_bias,
                              const void* scale, const void* bias, void* out,
                              long long rows, int h, float eps, int dtype,
                              int gelu, void* stream) {
  const float* cb = static_cast<const float*>(conv_bias);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gelu && cb == nullptr) return W2V_BAD_ARGS;
  if (dtype == W2V_F32)
    return gelu ? launch_ln<float, true>(x, cb, sc, bi, out, rows, h, eps, s)
                : launch_ln<float, false>(x, cb, sc, bi, out, rows, h, eps, s);
  if (dtype == W2V_BF16)
    return gelu ? launch_ln<__nv_bfloat16, true>(x, cb, sc, bi, out, rows, h,
                                                 eps, s)
                : launch_ln<__nv_bfloat16, false>(x, cb, sc, bi, out, rows, h,
                                                  eps, s);
  return W2V_BAD_ARGS;
}

extern "C" const char* w2v_error_string(int status) {
  if (status == W2V_BAD_ARGS) return "arguments refused by the C entry point";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
