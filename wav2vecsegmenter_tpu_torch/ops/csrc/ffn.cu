// Transformer FFN: y = (GELU(x . w1^T + b1) rounded to x's type) . w2^T + b2.
//
// Replaces the Pallas kernel _ffn_kernel of wav2vecsegmenter_tpu/ops/ffn.py
// (K5).  Weights in torch.nn.Linear layout: w1 [F, H], w2 [H, F]; biases
// float32.  Both products accumulate in float32; the bias and the exact-erf
// GELU act on the float32 sums, and the activation is rounded to x's type
// before the second product, as on the TPU.
//
// Bound on the H100: operations.  4 * rows * H * F FLOP (235 GFLOP a layer
// at [14 * 999, 1024] x 4096) against ~0.26 GB of operands.  The TPU kernel
// kept the [rows, F] activation in 16+ MB of VMEM; on the card even 64 rows
// of it (512 KB in bf16) exceed the 227 KB of shared memory, so this port
// writes it once to device memory instead: two launches of one GEMM
// mainloop, the first with a bias + GELU + cast epilogue, the second with a
// bias epilogue.  The activation's round trip costs ~0.23 GB a layer
// (~0.07 ms at 3.35 TB/s) against a ~0.24 ms tensor-core bound.  The last
// row tile is ragged (T = 999 or 1099 frames a window; 1, 2 or 4 windows
// in the remainder ladder's buckets): its rows past the end read zeros and
// are not written.
//
// bf16: the persistent wgmma + TMA GEMM of wgmma_gemm.cuh: one CTA an SM,
//   a producer warpgroup streaming A and B boxes of 64 K-steps through a
//   ring of stages, two consumer warpgroups taking the CTA's output tiles
//   in turns, so that one's epilogue (bias, the exact-erf GELU, the bf16
//   stores) runs while the other's wgmma mainloop keeps the tensor cores
//   busy.  The tensor maps are built on the host for each call (A over x or
//   the activation, B over w1 or w2).
// float32: two launches of Tf32Gemm (gemm.cuh), split TF32 on the tensor
//   cores (wgmma in TF32, each product as lo_a hi_b + hi_a lo_b + hi_a hi_b,
//   A's fragments split in registers, w1 and w2 split into hi and lo once a
//   call), fed by a 4-stage cp.async ring, with the same epilogues writing
//   float32.  Bound: the products counted three times at the TF32 peak,
//   3 * 235 GFLOP at [14 * 999, 1024] x 4096 = 1.42 ms at 495 TFLOP/s.  On
//   the H100 the scalar mainloop it replaces took 6.8 ms (the FP32 pipes'
//   67 TFLOP/s), and mma.sync in split TF32 3.7 ms, bound by the rate at
//   which its instructions start (PERF.md).  The running sums beside the
//   fresh partials (the accumulation truncates; tf32.cuh) double the
//   accumulator, so a block holds 128 x 128 (one an SM: 192 KB of stages),
//   or 128 x 64 where the large tiles would leave half the SMs idle (one
//   window: 64 tiles of the second product for 132 SMs; at two windows the
//   256 small tiles would need two waves and lose to the 128 large ones).
//   The grid runs the column tiles fastest, so the CTAs in flight share a
//   few A row tiles and every B tile (the split weights, 32 MB, stay in
//   L2).

#include "gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

// 128 x 128 tiles a warpgroup, 4 stages of 32 KB (ops/tile_sweep.py sweeps
// the tile shape and the stage count; PERF.md)
using FfnWg = WgGemm<128, 128, 4>;

// float32: split TF32, partials of kF32GemmSteps k-steps (8 K each), a
// ring of kF32GemmStages stages of 32 K; tiles of kF32GemmRows x
// kF32GemmCols, or of kF32GemmRows x kF32GemmSmallCols (kF32GemmSmallStages
// stages) where the large ones would fill at most half the SMs
constexpr int kF32GemmSteps = 4;
constexpr int kF32GemmStages = 4;
constexpr int kF32GemmSmallStages = 3;
constexpr int kF32GemmRows = 128;
constexpr int kF32GemmCols = 128;
constexpr int kF32GemmSmallCols = 64;
using FfnTf32 = Tf32Gemm<kF32GemmCols, kF32GemmStages, kF32GemmSteps>;
using FfnTf32Small =
    Tf32Gemm<kF32GemmSmallCols, kF32GemmSmallStages, kF32GemmSteps>;
static_assert(FfnTf32::kBM == kF32GemmRows, "row tiles");

// out[m, c] = epilogue(A[m, :] . B[c, :] + bias[c]) over the CTA's tiles
template <class G, bool GELU>
__global__ void __launch_bounds__(G::kThreads, 1)
ffn_wg_kernel(const __grid_constant__ CUtensorMap amap,
              const __grid_constant__ CUtensorMap bmap,
              const float* __restrict__ bias,
              __nv_bfloat16* __restrict__ out, int rows, int n, int k) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop_align1024(smem_raw);
  const int m_tiles = (rows + G::kBM - 1) / G::kBM, n_tiles = n / G::kBN;
  if (threadIdx.x == 0) G::init(smem);
  __syncthreads();
  if (threadIdx.x >= G::kConsumers) {  // the producer warpgroup
    hop_setmaxnreg_dec<G::kProducerRegs>();
    if (threadIdx.x == G::kConsumers)
      G::produce(smem, &amap, &bmap, m_tiles, n_tiles, k / G::kBK);
    return;
  }
  hop_setmaxnreg_inc<G::kConsumerRegs>();
  G g;
  g.consume(smem, m_tiles, n_tiles, k / G::kBK,
            [&](int m, int c, float v0, float v1) {
    if (m >= rows) return;
    const float2 bb = *reinterpret_cast<const float2*>(bias + c);
    v0 += bb.x;
    v1 += bb.y;
    if (GELU) {
      v0 = w2v_gelu(v0);
      v1 = w2v_gelu(v1);
    }
    *reinterpret_cast<__nv_bfloat162*>(out + (long long)m * n + c) =
        __floats2bfloat162_rn(v0, v1);
  });
}

// a 3-D map [1, rows, k] over a row-major bf16 matrix, boxes of 64 x
// box_rows
bool matrix_map(CUtensorMap* map, const void* base, long long rows, int k,
                int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(rows), 1};
  const cuuint64_t strides[2] = {2 * static_cast<cuuint64_t>(k),
                                 2 * static_cast<cuuint64_t>(k) * rows};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  return hop_make_map(map, true, 3, base, dims, strides, box);
}

template <class G, bool GELU>
int launch_wg(const void* a, long long rows, int k, const void* b,
              const float* bias, void* out, int n, cudaStream_t stream) {
  const long long tiles = (rows + G::kBM - 1) / G::kBM * (n / G::kBN);
  if (rows > 0x7fffffffLL || tiles > 0x7fffffffLL || hop_sm_count() == 0)
    return W2V_BAD_ARGS;
  CUtensorMap amap, bmap;
  if (!matrix_map(&amap, a, rows, k, G::kBM) ||
      !matrix_map(&bmap, b, n, k, G::kBN))
    return W2V_BAD_ARGS;
  auto kernel = ffn_wg_kernel<G, GELU>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int sms = hop_sm_count();
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<grid, G::kThreads, G::kSmemBytes, stream>>>(
      amap, bmap, bias, static_cast<__nv_bfloat16*>(out), (int)rows, n, k);
  return (int)cudaGetLastError();
}

// out[m, c] = epilogue(A[m, :] . B[c, :] + bias[c]) for one block tile,
// float32 in split TF32; the column tiles run fastest
template <class G, bool GELU>
__global__ void __launch_bounds__(G::kThreads, 1)
ffn_tf32_kernel(const float* __restrict__ a, long long rows, int k,
                const float* __restrict__ bhi, const float* __restrict__ blo,
                const float* __restrict__ bias, float* __restrict__ out,
                int n) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int n_tiles = n / G::kBN;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * G::kBM;
  const int n0 = (blockIdx.x % n_tiles) * G::kBN;
  G g;
  g.run(a, W2vRows{rows, 0, k}, rows, bhi, blo, k, k, m0, n0, smem);
  g.for_each([&](int r, int c, float v0, float v1) {
    const long long m = m0 + r;
    if (m >= rows) return;
    const float2 bb = *reinterpret_cast<const float2*>(bias + n0 + c);
    v0 += bb.x;
    v1 += bb.y;
    if (GELU) {
      v0 = w2v_gelu(v0);
      v1 = w2v_gelu(v1);
    }
    *reinterpret_cast<float2*>(out + m * n + n0 + c) = make_float2(v0, v1);
  });
}

template <class G, bool GELU>
int launch_tf32(const float* a, long long rows, int k, const float* bhi,
                const float* blo, const float* bias, float* out, int n,
                cudaStream_t stream) {
  const long long blocks = (rows + G::kBM - 1) / G::kBM * (n / G::kBN);
  if (blocks > 0x7fffffffLL) return W2V_BAD_ARGS;
  auto kernel = ffn_tf32_kernel<G, GELU>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, G::kThreads, G::kSmemBytes, stream>>>(
      a, rows, k, bhi, blo, bias, out, n);
  return (int)cudaGetLastError();
}

// one product in float32: the small tiles where twice as many of them as
// of the large ones still fit one wave of CTAs (the large ones would leave
// half the SMs idle), else the large ones
template <bool GELU>
int launch_tf32_product(const float* a, long long rows, int k,
                        const float* bhi, const float* blo, const float* bias,
                        float* out, int n, cudaStream_t stream) {
  const long long large =
      (rows + FfnTf32::kBM - 1) / FfnTf32::kBM * (n / FfnTf32::kBN);
  if (2 * large > hop_sm_count())
    return launch_tf32<FfnTf32, GELU>(a, rows, k, bhi, blo, bias, out, n,
                                      stream);
  return launch_tf32<FfnTf32Small, GELU>(a, rows, k, bhi, blo, bias, out, n,
                                         stream);
}

// both GEMMs: x . w1^T -> hidden (bias, GELU, cast), hidden . w2^T -> out
template <class Gemm>
bool shapes_ok(int h, int f) {
  return h % Gemm::kBN == 0 && f % Gemm::kBN == 0 && h % Gemm::kBK == 0 &&
         f % Gemm::kBK == 0;
}

int launch_ffn_bf16(const void* x, const void* w1, const float* b1,
                    const void* w2, const float* b2, void* hidden, void* out,
                    long long rows, int h, int f, cudaStream_t stream) {
  const void* ptrs[4] = {x, w1, w2, hidden};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return W2V_BAD_ARGS;
  if (!shapes_ok<FfnWg>(h, f) || reinterpret_cast<uintptr_t>(b1) % 8 ||
      reinterpret_cast<uintptr_t>(b2) % 8)
    return W2V_BAD_ARGS;
  const int status =
      launch_wg<FfnWg, true>(x, rows, h, w1, b1, hidden, f, stream);
  if (status != 0) return status;
  return launch_wg<FfnWg, false>(hidden, rows, f, w2, b2, out, h, stream);
}

int launch_ffn_f32(const void* x, const void* w1, const float* b1,
                   const void* w2, const float* b2, void* hidden, void* out,
                   float* split, long long rows, int h, int f,
                   cudaStream_t stream) {
  const void* ptrs[5] = {x, w1, w2, hidden, split};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return W2V_BAD_ARGS;
  if (!shapes_ok<FfnTf32>(h, f) || reinterpret_cast<uintptr_t>(b1) % 8 ||
      reinterpret_cast<uintptr_t>(b2) % 8 || hop_sm_count() == 0)
    return W2V_BAD_ARGS;
  // split: w1's hi and lo, then w2's, each [h * f]
  const long long hf = (long long)h * f;
  float* w1hi = split;
  float* w1lo = split + hf;
  float* w2hi = split + 2 * hf;
  float* w2lo = split + 3 * hf;
  int status =
      launch_tf32_split(static_cast<const float*>(w1), w1hi, w1lo, hf, stream);
  if (status != 0) return status;
  status =
      launch_tf32_split(static_cast<const float*>(w2), w2hi, w2lo, hf, stream);
  if (status != 0) return status;
  status = launch_tf32_product<true>(static_cast<const float*>(x), rows, h,
                                     w1hi, w1lo, b1,
                                     static_cast<float*>(hidden), f, stream);
  if (status != 0) return status;
  return launch_tf32_product<false>(static_cast<const float*>(hidden), rows,
                                    f, w2hi, w2lo, b2,
                                    static_cast<float*>(out), h, stream);
}

}  // namespace

// x, out: [rows, h]; hidden: [rows, f] scratch; w1 [f, h], w2 [h, f] in x's
// type; b1 [f], b2 [h] float32; split: in float32 scratch of 4 * h * f
// floats (the weights' TF32 hi and lo parts), unused in bf16.  All
// contiguous; x, w1, w2, hidden and split 16-byte aligned, b1 and b2 8-byte
// aligned; h, f multiples of 128.  Launches on `stream`; returns the first
// failing launch's cudaError_t, or W2V_BAD_ARGS.
extern "C" int w2v_ffn(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* hidden,
                       void* out, void* split, long long rows, int h, int f,
                       int dtype, void* stream) {
  if (rows <= 0 || h <= 0 || f <= 0) return W2V_BAD_ARGS;
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == W2V_BF16)
    return launch_ffn_bf16(x, w1, b1f, w2, b2f, hidden, out, rows, h, f, s);
  if (dtype == W2V_F32)
    return launch_ffn_f32(x, w1, b1f, w2, b2f, hidden, out,
                          static_cast<float*>(split), rows, h, f, s);
  return W2V_BAD_ARGS;
}
