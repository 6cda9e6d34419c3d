// Row LayerNorm backward: dx, dscale, dbias.
//
// Replaces the Pallas kernel _ln_bwd_kernel of
// wav2vecsegmenter_tpu/ops/layernorm.py (the custom VJP of every LayerNorm
// that is trained: the SFC head's norm1, norm2 and final LayerNorm).  Per
// row, with float32 statistics recomputed from x:
//   xhat = (x - mean) * rstd,  gs = g * scale,
//   dx   = (gs - mean(gs) - xhat * mean(gs * xhat)) * rstd   (x's type)
// and over all rows, in float32: dscale = sum g * xhat, dbias = sum g.
//
// Bound on the H100: bytes.  x and g are read once and dx written once,
// about 12 operations an element against the card's ~295 FLOP/byte ridge.
// Design: one warp per row, the row held in registers (h/32 values a lane)
// as in the forward kernel (layernorm.cu), so the four row reductions cost
// warp shuffles.  dscale and dbias are deterministic, with no atomics: each
// warp walks kRowsPerWarp rows and keeps its column sums in registers, the
// block adds its warps' sums in a fixed order through shared memory and
// writes one float32 partial row per block to a [n_blocks, 2, h] workspace,
// and a second small kernel adds the partial rows, again in a fixed order.
// The row-to-block assignment depends on the row count only, so two runs on
// the same inputs give the same bits.  The TPU kernel accumulated the two
// column sums in grid order (revisited output blocks); blocks on the card
// run in no order, hence the workspace.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;                               // 256 threads
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;    // 32
constexpr int kMaxH = 1024;
constexpr int kRedCols = 32;    // reduction kernel: columns a block
constexpr int kRedGroups = 8;   // reduction kernel: partial rows in flight

template <typename T, int VPL>
__global__ void __launch_bounds__(kWarps * 32)
ln_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   const T* __restrict__ g, T* __restrict__ dx,
                   float* __restrict__ partial, long long rows, int h,
                   float eps) {
  __shared__ float red[kWarps][kMaxH];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float dsc[VPL], dbi[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) dsc[i] = dbi[i] = 0.f;

  for (int r = 0; r < kRowsPerWarp; ++r) {
    const long long row =
        (long long)blockIdx.x * kRowsPerBlock + r * kWarps + warp;
    if (row >= rows) break;  // later rows of this warp lie further on
    const T* xr = x + row * h;
    const T* gr = g + row * h;
    float xv[VPL], gv[VPL];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      xv[i] = c < h ? w2v_load(xr + c) : 0.f;
      gv[i] = c < h ? w2v_load(gr + c) : 0.f;
      sum += xv[i];
    }
    const float mean = w2v_warp_sum(sum) / h;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const float d = xv[i] - mean;
      if (lane + 32 * i < h) sq += d * d;
    }
    const float rstd = rsqrtf(w2v_warp_sum(sq) / h + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      xv[i] = c < h ? (xv[i] - mean) * rstd : 0.f;  // xhat from here on
      const float gs = c < h ? gv[i] * scale[c] : 0.f;
      s1 += gs;
      s2 += gs * xv[i];
    }
    const float m1 = w2v_warp_sum(s1) / h;
    const float m2 = w2v_warp_sum(s2) / h;
    T* dxr = dx + row * h;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      if (c < h) {
        const float gs = gv[i] * scale[c];
        w2v_store(dxr + c, (gs - m1 - xv[i] * m2) * rstd);
      }
      dsc[i] += gv[i] * xv[i];
      dbi[i] += gv[i];
    }
  }

  // the block's column sums: warps in order, dscale then dbias
  float* out = partial + (long long)blockIdx.x * 2 * h;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      if (c < h) red[warp][c] = which ? dbi[i] : dsc[i];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < h; c += kWarps * 32) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][c];
      out[which * h + c] = s;
    }
    __syncthreads();
  }
}

// dscale[c] and dbias[c]: the partial rows added in a fixed order.  A block
// takes kRedCols of the 2h columns; thread (x, y) adds partial rows
// y, y + kRedGroups, ..., then row y = 0 adds the groups in order.
__global__ void __launch_bounds__(kRedCols * kRedGroups)
ln_bwd_reduce_kernel(const float* __restrict__ partial,
                     float* __restrict__ dscale, float* __restrict__ dbias,
                     int n_blocks, int h) {
  __shared__ float red[kRedGroups][kRedCols + 1];
  const int col = blockIdx.x * kRedCols + threadIdx.x;  // in [0, 2h)
  const int which = col / h;
  const int c = col - which * h;
  float s = 0.f;
  if (col < 2 * h)
    for (int b = threadIdx.y; b < n_blocks; b += kRedGroups)
      s += partial[((long long)b * 2 + which) * h + c];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < 2 * h) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < kRedGroups; ++y) t += red[y][threadIdx.x];
    (which ? dbias : dscale)[c] = t;
  }
}

template <typename T>
int launch_ln_bwd(const void* x, const float* scale, const void* g, void* dx,
                  float* dscale, float* dbias, float* partial, long long rows,
                  int h, long long n_blocks, float eps, cudaStream_t stream) {
  const long long want = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (h <= 0 || h > kMaxH || rows <= 0 || n_blocks != want ||
      n_blocks > 0x7fffffffLL)
    return W2V_BAD_ARGS;
  const dim3 grid((unsigned)n_blocks), block(kWarps * 32);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  const int vpl = (h + 31) / 32;
  if (vpl <= 4)
    ln_bwd_rows_kernel<T, 4><<<grid, block, 0, stream>>>(
        xt, scale, gt, dxt, partial, rows, h, eps);
  else if (vpl <= 8)
    ln_bwd_rows_kernel<T, 8><<<grid, block, 0, stream>>>(
        xt, scale, gt, dxt, partial, rows, h, eps);
  else if (vpl <= 16)
    ln_bwd_rows_kernel<T, 16><<<grid, block, 0, stream>>>(
        xt, scale, gt, dxt, partial, rows, h, eps);
  else
    ln_bwd_rows_kernel<T, 32><<<grid, block, 0, stream>>>(
        xt, scale, gt, dxt, partial, rows, h, eps);
  int status = (int)cudaGetLastError();
  if (status != 0) return status;
  const dim3 rgrid((2 * h + kRedCols - 1) / kRedCols),
      rblock(kRedCols, kRedGroups);
  ln_bwd_reduce_kernel<<<rgrid, rblock, 0, stream>>>(partial, dscale, dbias,
                                                     (int)n_blocks, h);
  return (int)cudaGetLastError();
}

}  // namespace

// x, g, dx: [rows, h] contiguous in the element type; scale: [h] float32;
// dscale, dbias: [h] float32; partial: [n_blocks, 2, h] float32 workspace,
// n_blocks = ceil(rows / 32) (refused otherwise).  h <= 1024.  Launches the
// row kernel and the reduction on `stream`; returns the first non-zero
// cudaError_t.
extern "C" int w2v_layer_norm_bwd(const void* x, const void* scale,
                                  const void* g, void* dx, void* dscale,
                                  void* dbias, void* partial, long long rows,
                                  int h, long long n_blocks, float eps,
                                  int dtype, void* stream) {
  const float* sc = static_cast<const float*>(scale);
  float* ds = static_cast<float*>(dscale);
  float* db = static_cast<float*>(dbias);
  float* pw = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == W2V_F32)
    return launch_ln_bwd<float>(x, sc, g, dx, ds, db, pw, rows, h, n_blocks,
                                eps, s);
  if (dtype == W2V_BF16)
    return launch_ln_bwd<__nv_bfloat16>(x, sc, g, dx, ds, db, pw, rows, h,
                                        n_blocks, eps, s);
  return W2V_BAD_ARGS;
}
