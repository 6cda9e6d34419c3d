// One LayerNorm-mode conv layer of the wav2vec2 feature extractor:
//   y = GELU(LayerNorm(conv1d(x, w) + conv_bias) * scale + bias)
// over 512 output channels, with no device-memory round trip between the
// product and the epilogue.
//
// Replaces three Pallas kernels of wav2vecsegmenter_tpu/ops/convfuse.py:
//   _kernel_2tap_wide (K6) and _kernel_2tap (K8): layers 1-4 (k=3, s=2);
//   _kernel_1tap (K7): layers 5-6 (k=2, s=2) and the raw-audio layer 0
//       (k=10, s=5, one input channel).
// On the TPU the stride was folded into channels and the taps split, with a
// rolled halo row, so that every block kept the MXU's (8, 128) alignment.
// The card needs none of that: for a VALID conv with kernel k, stride s and
// C input channels, output row r reads the contiguous input span
// x[b, r*s*C : r*s*C + k*C], i.e. row r of an overlapping view with row
// stride s*C and width K = k*C.  The layer is one GEMM [rows, K] x [K, 512]
// against the weight permuted to [512, k*C] (K = 1536 for layers 1-4, not
// the fold's 2048), read in place through W2vRows (gemm.cuh).  K6 and K8 are
// one function; layers 5-6 run the same kernel with K = 1024.
//
// Bound on the H100: operations for layers 1-5 (1.32 TFLOP for layers 1-4
// of a 14-window batch), bytes for layer 0 (K = 10; its 917 MB bf16 output
// alone is ~0.27 ms at 3.35 TB/s).
//
// conv_ln_gelu_kernel: a block owns 64 whole output rows (all 512
// channels), so the LayerNorm reduces on chip.  The tensor-core mainloop
// (TcGemm; SimtGemm in float32) leaves float32 sums in registers; they go to
// a shared-memory tile (the pipeline's buffers, now free), and each warp
// then normalises rows held in registers, 16 channels a lane: mean and
// variance by warp shuffles, float32 straight through as _kernel_2tap_wide
// does, one rounding at the store.
// conv_audio_kernel: K = k*C <= 16.  Tensor-core tiles do not suit a
// 10-deep product over rows that start at 10-byte offsets, so a block stages
// its rows' samples and the [K, 512] weight in shared memory and runs
// scalar FMAs, four rows per warp at a time (each weight read serves four
// rows), then the same row epilogue.

#include "gemm.cuh"

namespace {

constexpr int kConvN = 512;            // output channels
constexpr int kConvLdc = kConvN + 8;   // shared tile row (floats)
constexpr int kPerLane = kConvN / 32;  // channels a lane: lane + 32 * q

// 64 rows x 512 channels, 8 warps of 32 x 128, 64 K-steps a stage in 2
// stages (the float32 tile of the epilogue, 133 KB, leaves room for one
// block an SM)
using ConvTc = TcGemm<64, kConvN, 2, 4, 2, 64, 1>;
using ConvSimt = SimtGemm<64, kConvN, 8, 16>;

// the row's float32 pre-activations v (conv bias added) -> LayerNorm ->
// scale, bias -> GELU -> out_row[lane + 32 * q]
template <typename T>
__device__ __forceinline__ void ln_gelu_row(float (&v)[kPerLane],
                                            const float (&sc)[kPerLane],
                                            const float (&bi)[kPerLane],
                                            float eps, int lane,
                                            T* __restrict__ out_row) {
  float sum = 0.f;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) sum += v[q];
  const float mean = w2v_warp_sum(sum) / kConvN;
  float sq = 0.f;
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const float d = v[q] - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(w2v_warp_sum(sq) / kConvN + eps);
#pragma unroll
  for (int q = 0; q < kPerLane; ++q)
    w2v_store(out_row + lane + 32 * q,
              w2v_gelu((v[q] - mean) * rstd * sc[q] + bi[q]));
}

template <class Gemm, typename T>
__global__ void __launch_bounds__(Gemm::kThreads, Gemm::kMinBlocks)
conv_ln_gelu_kernel(const T* __restrict__ x, W2vRows rows, long long m_rows,
                    int k, const T* __restrict__ w,
                    const float* __restrict__ conv_bias,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, float eps,
                    T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long m0 = (long long)blockIdx.x * Gemm::kBM;
  float* tile = reinterpret_cast<float*>(smem);  // [kBM][kConvLdc]
  {
    Gemm g;
    g.run(x, rows, m_rows, w, k, k, m0, 0, smem);
    g.for_each([&](int r, int c, float v) { tile[r * kConvLdc + c] = v; });
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  float cb[kPerLane], sc[kPerLane], bi[kPerLane];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    cb[q] = conv_bias[lane + 32 * q];
    sc[q] = scale[lane + 32 * q];
    bi[q] = bias[lane + 32 * q];
  }
  for (int r = threadIdx.x >> 5; r < Gemm::kBM; r += Gemm::kThreads / 32) {
    const long long m = m0 + r;
    if (m >= m_rows) break;
    float v[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q)
      v[q] = tile[r * kConvLdc + lane + 32 * q] + cb[q];
    ln_gelu_row(v, sc, bi, eps, lane, out + m * kConvN);
  }
}

constexpr int kAudioMaxK = 16;
constexpr int kAudioRows = 128;      // rows a block
constexpr int kAudioThreads = 256;
constexpr int kAudioGroup = 4;       // rows a warp computes together

template <typename T>
__global__ void __launch_bounds__(kAudioThreads)
conv_audio_kernel(const T* __restrict__ x, W2vRows rows, long long m_rows,
                  int k, const T* __restrict__ w,
                  const float* __restrict__ conv_bias,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, float eps,
                  T* __restrict__ out) {
  __shared__ float w_s[kAudioMaxK * kConvN];       // [k][512]
  __shared__ float x_s[kAudioRows * kAudioMaxK];   // [row][k]
  const long long m0 = (long long)blockIdx.x * kAudioRows;
  for (int i = threadIdx.x; i < k * kConvN; i += kAudioThreads) {
    const int j = i / kConvN, o = i - j * kConvN;
    w_s[i] = w2v_load(w + o * k + j);
  }
  for (int i = threadIdx.x; i < kAudioRows * k; i += kAudioThreads) {
    const int r = i / k, j = i - r * k;
    const long long m = m0 + r;
    x_s[r * kAudioMaxK + j] =
        m < m_rows ? w2v_load(x + rows.offset(m) + j) : 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float cb[kPerLane], sc[kPerLane], bi[kPerLane];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    cb[q] = conv_bias[lane + 32 * q];
    sc[q] = scale[lane + 32 * q];
    bi[q] = bias[lane + 32 * q];
  }
  constexpr int kWarps = kAudioThreads / 32;
  for (int g0 = warp * kAudioGroup; g0 < kAudioRows;
       g0 += kWarps * kAudioGroup) {
    if (m0 + g0 >= m_rows) break;
    float v[kAudioGroup][kPerLane];
#pragma unroll
    for (int i = 0; i < kAudioGroup; ++i)
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) v[i][q] = 0.f;
    for (int j = 0; j < k; ++j) {
      float xv[kAudioGroup];
#pragma unroll
      for (int i = 0; i < kAudioGroup; ++i)
        xv[i] = x_s[(g0 + i) * kAudioMaxK + j];
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const float wv = w_s[j * kConvN + lane + 32 * q];
#pragma unroll
        for (int i = 0; i < kAudioGroup; ++i) v[i][q] = fmaf(xv[i], wv, v[i][q]);
      }
    }
#pragma unroll
    for (int i = 0; i < kAudioGroup; ++i) {
      const long long m = m0 + g0 + i;
      if (m >= m_rows) break;
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) v[i][q] += cb[q];
      ln_gelu_row(v[i], sc, bi, eps, lane, out + m * kConvN);
    }
  }
}

struct ConvArgs {
  const void* x;
  const void* w;
  const float* conv_bias;
  const float* scale;
  const float* bias;
  void* out;
  W2vRows rows;
  long long m_rows;
  int k;  // GEMM depth: kernel taps * input channels
  float eps;
};

ConvArgs conv_args(const void* x, const void* w, const void* conv_bias,
                   const void* scale, const void* bias, void* out, int batch,
                   long long t_in, int c_in, int k, int stride,
                   long long t_out, float eps) {
  return ConvArgs{x, w, static_cast<const float*>(conv_bias),
                  static_cast<const float*>(scale),
                  static_cast<const float*>(bias), out,
                  W2vRows{t_out, t_in * c_in, (long long)stride * c_in},
                  batch * t_out, k * c_in, eps};
}

template <class Gemm, typename T>
int launch_conv(const ConvArgs& a, cudaStream_t stream) {
  // 16-byte copies (cp.async / float4) need every row start aligned
  constexpr int vec = 16 / sizeof(T);
  if (a.k % Gemm::kKAlign || a.rows.row_stride % vec ||
      a.rows.batch_stride % vec)
    return W2V_BAD_ARGS;
  const long long blocks = (a.m_rows + Gemm::kBM - 1) / Gemm::kBM;
  if (blocks > 0x7fffffffLL) return W2V_BAD_ARGS;
  constexpr int tile_bytes = Gemm::kBM * kConvLdc * 4;
  constexpr int smem =
      Gemm::kSmemBytes > tile_bytes ? Gemm::kSmemBytes : tile_bytes;
  auto kernel = conv_ln_gelu_kernel<Gemm, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, Gemm::kThreads, smem, stream>>>(
      static_cast<const T*>(a.x), a.rows, a.m_rows, a.k,
      static_cast<const T*>(a.w), a.conv_bias, a.scale, a.bias, a.eps,
      static_cast<T*>(a.out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_audio(const ConvArgs& a, cudaStream_t stream) {
  if (a.k > kAudioMaxK) return W2V_BAD_ARGS;
  const long long blocks = (a.m_rows + kAudioRows - 1) / kAudioRows;
  if (blocks > 0x7fffffffLL) return W2V_BAD_ARGS;
  conv_audio_kernel<T><<<(unsigned)blocks, kAudioThreads, 0, stream>>>(
      static_cast<const T*>(a.x), a.rows, a.m_rows, a.k,
      static_cast<const T*>(a.w), a.conv_bias, a.scale, a.bias, a.eps,
      static_cast<T*>(a.out));
  return (int)cudaGetLastError();
}

bool conv_shape_ok(int batch, long long t_in, int c_in, int k, int stride,
                   long long t_out, int n_out) {
  return batch > 0 && c_in > 0 && k > 0 && stride > 0 && t_out > 0 &&
         n_out == kConvN && (t_out - 1) * stride + k <= t_in;
}

}  // namespace

// x [batch, t_in, c_in] contiguous; w [512, k * c_in] (torch's [O, C, k]
// permuted to [O, k, C]) in x's type; conv_bias, scale, bias [512] float32;
// out [batch, t_out, 512].  The GEMM kernel takes k * c_in a multiple of 64
// (bf16) or 16 (float32); w2v_conv_audio_ln_gelu takes k * c_in <= 16.
// Launch on `stream`; return the launch's cudaError_t or W2V_BAD_ARGS.
extern "C" int w2v_conv_ln_gelu(const void* x, const void* w,
                                const void* conv_bias, const void* scale,
                                const void* bias, void* out, int batch,
                                long long t_in, int c_in, int k, int stride,
                                long long t_out, int n_out, float eps,
                                int dtype, void* stream) {
  if (!conv_shape_ok(batch, t_in, c_in, k, stride, t_out, n_out))
    return W2V_BAD_ARGS;
  const ConvArgs a = conv_args(x, w, conv_bias, scale, bias, out, batch,
                               t_in, c_in, k, stride, t_out, eps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == W2V_BF16) return launch_conv<ConvTc, __nv_bfloat16>(a, s);
  if (dtype == W2V_F32) return launch_conv<ConvSimt, float>(a, s);
  return W2V_BAD_ARGS;
}

extern "C" int w2v_conv_audio_ln_gelu(const void* x, const void* w,
                                      const void* conv_bias,
                                      const void* scale, const void* bias,
                                      void* out, int batch, long long t_in,
                                      int c_in, int k, int stride,
                                      long long t_out, int n_out, float eps,
                                      int dtype, void* stream) {
  if (!conv_shape_ok(batch, t_in, c_in, k, stride, t_out, n_out))
    return W2V_BAD_ARGS;
  const ConvArgs a = conv_args(x, w, conv_bias, scale, bias, out, batch,
                               t_in, c_in, k, stride, t_out, eps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == W2V_BF16) return launch_audio<__nv_bfloat16>(a, s);
  if (dtype == W2V_F32) return launch_audio<float>(a, s);
  return W2V_BAD_ARGS;
}
