// Row LayerNorm with an optional (conv bias, exact GELU) epilogue.
//
// Replaces two Pallas kernels of wav2vecsegmenter_tpu/ops/layernorm.py:
//   _ln_kernel        (gelu = 0): y = LN(x) * scale + bias
//     every LayerNorm of the encoder, the feature projection and the SFC
//     head: [14 * 999, 1024] and [14 * 999, 512] a batch of 14 x 20 s;
//   _bln_gelu_kernel  (gelu = 1): y = GELU(LN(x + conv_bias) * scale + bias)
//     the conv layers' epilogue on the unfused arm (W2VSEG_CONVFUSE=0):
//     [14, t, 512], t = 63999 ... 1999.
// Statistics in float32 (the mean first, then the biased variance about the
// mean, from values held on chip), eps inside the rsqrt, float32 scale, bias
// and conv bias, one cast to the output type.  GELU is the exact erf form;
// the TPU kernel used the Abramowitz-Stegun polynomial only because Mosaic
// has no erf.
//
// Bound on the H100: bytes.  Each row is read once and written once, about
// 2 FLOP per byte against the card's ~295 FLOP/byte ridge; the largest call
// moves [14 * 63999, 512] bf16 each way (~0.9 GB, 0.55 ms at 3.35 TB/s).
// The only way down is to move those bytes with fewer instructions and more
// of them in flight, so the bf16 kernel (ln_vec_kernel) is built for that:
//
// * 16-byte accesses.  A warp owns a row; each lane owns 8 consecutive
//   columns of every 256-column pass, one 16-byte load (ld.global.nc, the
//   read-only path) and one 16-byte store a pass: 4 of each a lane at
//   h = 1024 where a 2-byte-per-instruction warp needs 32.
// * Parameters in registers on a persistent grid.  A lane's columns are the
//   same for every row, so it loads its chunks of scale, bias and conv bias
//   once, with 16-byte loads, and keeps them in registers; the grid holds
//   the CTAs the card keeps resident (the occupancy API) and each warp
//   walks the rows with a grid stride.
// * Rows in flight.  Each warp keeps kDepth rows in a ring of register
//   buffers: the load of row r + depth * stride is issued before row r is
//   reduced, so the two shuffle reductions, the FP32 epilogue and K2's erf
//   run under the memory traffic instead of after it.  The depth trades
//   against registers, and so against the warps an SM holds: K1 (h = 1024)
//   runs 4-warp CTAs with two rows in flight (166 registers, 12 warps an
//   SM); K2 runs 8-warp CTAs with the next row in flight (126 registers, 16
//   warps an SM), since its 48 parameter registers leave no room for a
//   second buffer without losing half the warps that hide the erf
//   (ops/tile_sweep.py has the other configurations and their times).
// * Widths that are not a whole number of passes go through a masked tail
//   in the same kernel (TAIL): parameter and element accesses guarded per
//   column; where h is not a multiple of 8 (rows are then not 16-byte
//   aligned) in 8-, 4- or 2-byte accesses, as the row's alignment allows.
//
// Summation order (tests/test_torch_ln_tiles.py emulates it): each lane sums
// its columns pass by pass, 8 in a pass in column order, then a butterfly
// of xor-shuffles 16, 8, 4, 2, 1; the mean is that sum / h; the squared
// deviations the same way.  float32 keeps the simple kernel below
// (ln_rows_kernel: one warp a row, one element a lane per instruction) as
// the oracle arm.

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "ln_vec.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: the simple kernel
// ---------------------------------------------------------------------------

constexpr int kRowsPerBlock = 8;  // 8 warps = 256 threads

template <int VPL, bool GELU>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
ln_rows_kernel(const float* __restrict__ x,
               const float* __restrict__ conv_bias,
               const float* __restrict__ scale,
               const float* __restrict__ bias, float* __restrict__ out,
               long long rows, int h, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + row * h;
  float* outr = out + row * h;

  float v[VPL];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    float a = 0.f;
    if (c < h) {
      a = xr[c];
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
      if (GELU) y = w2v_gelu(y);
      outr[c] = y;
    }
  }
}

template <bool GELU>
int launch_rows(const void* x, const float* conv_bias, const float* scale,
                const float* bias, void* out, long long rows, int h,
                float eps, cudaStream_t stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return W2V_BAD_ARGS;
  const dim3 grid((unsigned)blocks), block(kRowsPerBlock * 32);
  const float* xt = static_cast<const float*>(x);
  float* ot = static_cast<float*>(out);
  const int vpl = (h + 31) / 32;
  if (vpl <= 4)
    ln_rows_kernel<4, GELU><<<grid, block, 0, stream>>>(
        xt, conv_bias, scale, bias, ot, rows, h, eps);
  else if (vpl <= 8)
    ln_rows_kernel<8, GELU><<<grid, block, 0, stream>>>(
        xt, conv_bias, scale, bias, ot, rows, h, eps);
  else if (vpl <= 16)
    ln_rows_kernel<16, GELU><<<grid, block, 0, stream>>>(
        xt, conv_bias, scale, bias, ot, rows, h, eps);
  else
    ln_rows_kernel<32, GELU><<<grid, block, 0, stream>>>(
        xt, conv_bias, scale, bias, ot, rows, h, eps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: 16-byte vectors, parameters in registers, rows in flight
// ---------------------------------------------------------------------------

// WARPS a CTA (each walks its own rows), DEPTH rows a warp has in flight
// while it reduces one, MINB CTAs an SM that the register allocation must
// allow (__launch_bounds__), PREFETCH rows a warp asks L2 for beyond those
// (one bulk prefetch a row, no registers); one configuration for K1 and one
// for K2
template <int WARPS, int DEPTH, int MINB, int PREFETCH>
struct LnVec {
  static constexpr int kWarps = WARPS;
  static constexpr int kDepth = DEPTH;
  static constexpr int kMinBlocks = MINB;
  static constexpr int kPrefetch = PREFETCH;
};
using LnVecCfg = LnVec<4, 2, 1, 0>;
using LnVecGeluCfg = LnVec<8, 1, 1, 0>;
template <bool GELU>
using LnCfg = typename std::conditional<GELU, LnVecGeluCfg, LnVecCfg>::type;

// row r into L2 ahead of its loads, by the copy engine: one instruction, no
// registers (rows 16-byte aligned only; nothing past the last row)
__device__ __forceinline__ void ln_prefetch_row(const __nv_bfloat16* x,
                                                long long r, long long rows,
                                                int h) {
  if (r < rows && (h & 7) == 0)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                 :
                 : "l"(x + r * h), "r"(2 * h)
                 : "memory");
}

template <int PASSES, bool GELU, bool TAIL>
__global__ void __launch_bounds__(LnCfg<GELU>::kWarps * 32,
                                  LnCfg<GELU>::kMinBlocks)
ln_vec_kernel(const __nv_bfloat16* __restrict__ x,
              const float* __restrict__ conv_bias,
              const float* __restrict__ scale,
              const float* __restrict__ bias,
              __nv_bfloat16* __restrict__ out, long long rows, int h,
              float eps) {
  using C = LnCfg<GELU>;
  constexpr int D = C::kDepth;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * C::kWarps;
  long long row = (long long)blockIdx.x * C::kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: no row for it

  constexpr int P = C::kPrefetch;
  uint4 buf[D][PASSES];
#pragma unroll
  for (int d = 0; d < D; ++d)
    ln_load_row<PASSES, TAIL>(x, row + d * stride, rows, h, lane, buf[d]);
  if (P > 0 && lane == 0)
    for (int k = D; k < D + P; ++k)
      ln_prefetch_row(x, row + k * stride, rows, h);

  // the lane's parameters, once (their loads overlap the rows' above)
  float sc[PASSES][kLnChunk], bi[PASSES][kLnChunk];
  float cb[GELU ? PASSES : 1][kLnChunk];
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int c0 = p * kLnPass + lane * kLnChunk;
    ln_param<TAIL>(scale, c0, h, sc[p]);
    ln_param<TAIL>(bias, c0, h, bi[p]);
    if (GELU) ln_param<TAIL>(conv_bias, c0, h, cb[GELU ? p : 0]);
  }

  for (; row < rows; row += D * stride) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const long long r = row + d * stride;
      if (r >= rows) break;  // warp-uniform; every later r is past too
      float v[PASSES][kLnChunk];
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const uint32_t w[4] = {buf[d][p].x, buf[d][p].y, buf[d][p].z,
                               buf[d][p].w};
#pragma unroll
        for (int j = 0; j < kLnChunk / 2; ++j) {
          v[p][2 * j] = ln_lo(w[j]);
          v[p][2 * j + 1] = ln_hi(w[j]);
        }
        if (GELU) {
#pragma unroll
          for (int j = 0; j < kLnChunk; ++j) v[p][j] += cb[GELU ? p : 0][j];
        }
      }
      // the buffer is free: the row D strides on goes in flight now
      ln_load_row<PASSES, TAIL>(x, r + D * stride, rows, h, lane, buf[d]);
      if (P > 0 && lane == 0)
        ln_prefetch_row(x, r + (D + P) * stride, rows, h);

      float sum = 0.f;
#pragma unroll
      for (int p = 0; p < PASSES; ++p)
#pragma unroll
        for (int j = 0; j < kLnChunk; ++j) sum += v[p][j];
      const float mean = w2v_warp_sum(sum) / h;
      float sq = 0.f;
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const int nv = TAIL ? ln_valid(p * kLnPass + lane * kLnChunk, h)
                            : kLnChunk;
#pragma unroll
        for (int j = 0; j < kLnChunk; ++j) {
          v[p][j] -= mean;
          if (!TAIL || j < nv) sq += v[p][j] * v[p][j];
        }
      }
      const float rstd = rsqrtf(w2v_warp_sum(sq) / h + eps);

      __nv_bfloat16* outr = out + r * h;
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        float y[kLnChunk];
#pragma unroll
        for (int j = 0; j < kLnChunk; ++j) {
          y[j] = v[p][j] * rstd * sc[p][j] + bi[p][j];
          if (GELU) y[j] = w2v_gelu(y[j]);
        }
        const int c0 = p * kLnPass + lane * kLnChunk;
        if (!TAIL || ((h & 7) == 0 && c0 + kLnChunk <= h)) {
          *reinterpret_cast<uint4*>(outr + c0) = make_uint4(
              w2v_pack_bf16(y[0], y[1]), w2v_pack_bf16(y[2], y[3]),
              w2v_pack_bf16(y[4], y[5]), w2v_pack_bf16(y[6], y[7]));
        } else {
          ln_store_part(outr + c0, ln_valid(c0, h), h, y);
        }
      }
    }
  }
}

template <int PASSES, bool GELU, bool TAIL>
int launch_vec_at(const void* x, const float* conv_bias, const float* scale,
                  const float* bias, void* out, long long rows, int h,
                  float eps, cudaStream_t stream) {
  using C = LnCfg<GELU>;
  constexpr int kThreads = C::kWarps * 32;
  static int per_sm = 0;  // CTAs an SM holds at once
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ln_vec_kernel<PASSES, GELU, TAIL>, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm == 0) return W2V_BAD_ARGS;
  }
  const long long need = (rows + C::kWarps - 1) / C::kWarps;
  const long long resident = (long long)hop_sm_count() * per_sm;
  const long long blocks = need < resident ? need : resident;
  ln_vec_kernel<PASSES, GELU, TAIL><<<(unsigned)blocks, kThreads, 0,
                                      stream>>>(
      static_cast<const __nv_bfloat16*>(x), conv_bias, scale, bias,
      static_cast<__nv_bfloat16*>(out), rows, h, eps);
  return (int)cudaGetLastError();
}

template <int PASSES, bool GELU>
int launch_vec_passes(const void* x, const float* conv_bias,
                      const float* scale, const float* bias, void* out,
                      long long rows, int h, float eps, cudaStream_t stream) {
  if (h == PASSES * kLnPass)
    return launch_vec_at<PASSES, GELU, false>(x, conv_bias, scale, bias, out,
                                              rows, h, eps, stream);
  return launch_vec_at<PASSES, GELU, true>(x, conv_bias, scale, bias, out,
                                           rows, h, eps, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool GELU>
int launch_vec(const void* x, const float* conv_bias, const float* scale,
               const float* bias, void* out, long long rows, int h,
               float eps, cudaStream_t stream) {
  if (!aligned16(x) || !aligned16(out) || !aligned16(scale) ||
      !aligned16(bias) || (GELU && !aligned16(conv_bias)) ||
      hop_sm_count() == 0)
    return W2V_BAD_ARGS;
  switch ((h + kLnPass - 1) / kLnPass) {
    case 1:
      return launch_vec_passes<1, GELU>(x, conv_bias, scale, bias, out, rows,
                                        h, eps, stream);
    case 2:
      return launch_vec_passes<2, GELU>(x, conv_bias, scale, bias, out, rows,
                                        h, eps, stream);
    case 3:
      return launch_vec_passes<3, GELU>(x, conv_bias, scale, bias, out, rows,
                                        h, eps, stream);
    default:
      return launch_vec_passes<4, GELU>(x, conv_bias, scale, bias, out, rows,
                                        h, eps, stream);
  }
}

}  // namespace

// x, out: [rows, h] contiguous; conv_bias (gelu only), scale, bias: [h]
// float32; bf16: every pointer 16-byte aligned.  Launches on `stream`;
// returns the launch's cudaError_t.
extern "C" int w2v_layer_norm(const void* x, const void* conv_bias,
                              const void* scale, const void* bias, void* out,
                              long long rows, int h, float eps, int dtype,
                              int gelu, void* stream) {
  const float* cb = static_cast<const float*>(conv_bias);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((gelu && cb == nullptr) || h <= 0 || h > 4 * kLnPass || rows <= 0)
    return W2V_BAD_ARGS;
  if (dtype == W2V_F32)
    return gelu ? launch_rows<true>(x, cb, sc, bi, out, rows, h, eps, s)
                : launch_rows<false>(x, cb, sc, bi, out, rows, h, eps, s);
  if (dtype == W2V_BF16)
    return gelu ? launch_vec<true>(x, cb, sc, bi, out, rows, h, eps, s)
                : launch_vec<false>(x, cb, sc, bi, out, rows, h, eps, s);
  return W2V_BAD_ARGS;
}

extern "C" const char* w2v_error_string(int status) {
  if (status == W2V_BAD_ARGS) return "arguments refused by the C entry point";
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
