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
// writes it once to device memory instead: two launches of one tensor-core
// GEMM mainloop (gemm.cuh), the first with a bias + GELU + cast epilogue,
// the second with a bias epilogue.  The activation's round trip costs
// ~0.23 GB a layer (~0.07 ms at 3.35 TB/s) against a ~0.24 ms tensor-core
// bound.  The last row tile is ragged (T = 999 or 1099 frames a window):
// its rows past the end read zeros and are not written.  The float32 arm
// (the oracle run) uses the scalar-FMA mainloop with the same epilogues.

#include "gemm.cuh"

namespace {

// 128 x 128 tiles, 8 warps of 64 x 32, 64 K-steps a stage in 3 stages,
// two blocks an SM (registers capped at 128 a thread): 1.39x the one-block,
// 32-deep-stage variant on the H100 (PERF.md, ops/tile_sweep.py)
using FfnTc = TcGemm<128, 128, 2, 4, 3, 64, 2>;
using FfnSimt = SimtGemm<128, 128, 8, 8>;

// out[m, n] = epilogue(A[m, :] . B[n, :] + bias[n]) for one block tile
template <class Gemm, typename T, bool GELU>
__global__ void __launch_bounds__(Gemm::kThreads, Gemm::kMinBlocks)
ffn_gemm_kernel(const T* __restrict__ a, long long rows, int k,
                const T* __restrict__ b, const float* __restrict__ bias,
                T* __restrict__ out, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long m0 = (long long)blockIdx.x * Gemm::kBM;
  const int n0 = blockIdx.y * Gemm::kBN;
  Gemm g;
  g.run(a, W2vRows{rows, 0, k}, rows, b, k, k, m0, n0, smem);
  g.for_each([&](int r, int c, float v) {
    const long long m = m0 + r;
    if (m >= rows) return;
    v += bias[n0 + c];
    if (GELU) v = w2v_gelu(v);
    w2v_store(out + m * n + n0 + c, v);
  });
}

template <class Gemm, typename T, bool GELU>
int launch_gemm(const T* a, long long rows, int k, const T* b,
                const float* bias, T* out, int n, cudaStream_t stream) {
  const long long row_tiles = (rows + Gemm::kBM - 1) / Gemm::kBM;
  if (row_tiles > 0x7fffffffLL || n / Gemm::kBN > 65535) return W2V_BAD_ARGS;
  auto kernel = ffn_gemm_kernel<Gemm, T, GELU>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Gemm::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)row_tiles, (unsigned)(n / Gemm::kBN));
  kernel<<<grid, Gemm::kThreads, Gemm::kSmemBytes, stream>>>(a, rows, k, b,
                                                             bias, out, n);
  return (int)cudaGetLastError();
}

template <class Gemm, typename T>
int launch_ffn(const void* x, const void* w1, const float* b1,
               const void* w2, const float* b2, void* hidden, void* out,
               long long rows, int h, int f, cudaStream_t stream) {
  if (h % Gemm::kBN || f % Gemm::kBN || h % Gemm::kKAlign ||
      f % Gemm::kKAlign)
    return W2V_BAD_ARGS;
  int status = launch_gemm<Gemm, T, true>(
      static_cast<const T*>(x), rows, h, static_cast<const T*>(w1), b1,
      static_cast<T*>(hidden), f, stream);
  if (status != 0) return status;
  return launch_gemm<Gemm, T, false>(
      static_cast<const T*>(hidden), rows, f, static_cast<const T*>(w2), b2,
      static_cast<T*>(out), h, stream);
}

}  // namespace

// x, out: [rows, h]; hidden: [rows, f] scratch; w1 [f, h], w2 [h, f] in x's
// type; b1 [f], b2 [h] float32.  All contiguous.  Launches on `stream`;
// returns the first failing launch's cudaError_t, or W2V_BAD_ARGS.
extern "C" int w2v_ffn(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* hidden,
                       void* out, long long rows, int h, int f, int dtype,
                       void* stream) {
  if (rows <= 0 || h <= 0 || f <= 0) return W2V_BAD_ARGS;
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == W2V_BF16)
    return launch_ffn<FfnTc, __nv_bfloat16>(x, w1, b1f, w2, b2f, hidden, out,
                                            rows, h, f, s);
  if (dtype == W2V_F32)
    return launch_ffn<FfnSimt, float>(x, w1, b1f, w2, b2f, hidden, out, rows,
                                      h, f, s);
  return W2V_BAD_ARGS;
}
