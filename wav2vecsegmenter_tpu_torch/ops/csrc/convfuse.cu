// One LayerNorm-mode conv layer of the wav2vec2 feature extractor:
//   y = GELU(LayerNorm(conv1d(x, w) + conv_bias) * scale + bias)
// over 512 output channels, with no device-memory round trip between the
// product and the epilogue: float32 sums straight through the bias, the
// LayerNorm (mean, then the mean of squared deviations) and the exact-erf
// GELU, one rounding at the store, as _kernel_2tap_wide does.
//
// Replaces three Pallas kernels of wav2vecsegmenter_tpu/ops/convfuse.py:
//   _kernel_2tap_wide (K6) and _kernel_2tap (K8): layers 1-4 (k=3, s=2);
//   _kernel_1tap (K7): layers 5-6 (k=2, s=2) and the raw-audio layer 0
//       (k=10, s=5, one input channel).
// For a VALID conv with kernel k, stride s and C input channels, output row
// r reads the contiguous input span x[b, r*s*C : r*s*C + k*C]: the layer is
// one GEMM [rows, k*C] x [k*C, 512] against the weight permuted to
// [512, k*C] (K = 1536 for layers 1-4, 1024 for layers 5-6).
//
// Bound on the H100: operations for layers 1-6 (0.70 TFLOP for layer 1 of
// a 14-window batch, 0.76 ms at 989 TFLOP/s); bytes for layer 0 (K = 10;
// its 917 MB bf16 output alone is 0.27 ms at 3.35 TB/s).
//
// bf16, layers 1-6: conv_wg_kernel, wgmma + TMA in clusters of two CTAs.  A CTA
// owns 128 rows x 256 channels of the output; its partner (the other rank of
// the cluster) owns the other 256 channels of the same rows, so each CTA
// streams half of the weight.  The A operand comes by TMA as the TPU's stride
// fold, with no zero-padded taps: map A0 over x as it lies with rows of s*C
// elements (taps [0, s)) and, for k > s, map A1 at x + s*C with rows of (k-s)*C
// elements (taps [s, k)); both have t_out rows a batch element, so no box
// reaches past x.  A tile never crosses a batch element (tiles are (batch
// element, 128 rows)); the ragged last tile of each reads zeros past t_out, and
// a second 64-row half that lies wholly past t_out is neither loaded nor
// stored.  A producer warpgroup (setmaxnreg) runs a ring of 4 stages (A 128 x
// 64, the weight's 256 x 64); two consumer warpgroups (64 rows each,
// m64n256k16, 128 float32 sums a thread) run the mainloop and the epilogue.
// The grid is persistent (cluster c walks row tiles c, c + G, ...), so the
// producer loads the next tile's first stages under the epilogue; the epilogue
// itself stays serial with the mainloop (a ping-pong would need a tile per
// warpgroup and twice the weight traffic).  LayerNorm across the pair through
// distributed shared memory: each CTA reduces its 256 channels of a row, writes
// the partial sum into its partner's shared memory and arrives on the partner's
// barrier; the row's sum is the two partials added (the same float32 value in
// both CTAs); then the squared deviations from the mean the same way.  The bf16
// output is staged in shared memory (128-byte swizzle) and written by TMA
// stores, which clip the rows past t_out.  Each CTA loads its whole A box:
// loading half each and multicasting it to the pair (MC), or a 2 x 2 cluster
// that also multicasts the weight's halves (CM = 2), couples the CTAs' rings
// and ran slower (ops/tile_sweep.py; PERF.md).
//
// bf16, layer 0 (k*C <= 16): conv_audio_tc_kernel.  A block tile of
// 16 * STRIPS rows reads one contiguous span of (rows - 1)*s*C + k*C input
// elements, loaded with coalesced loads one tile ahead (prefetched into
// registers); the 10-tap product runs on the tensor cores (mma.sync
// m16n8k16, K padded to 16 with zeros, A fragments built from the staged
// span, the weight's B fragments built once a block and kept in shared
// memory), so the FP32 pipe serves only the LayerNorm and GELU.  Four warps
// share a strip's rows (128 channels each) and merge their partial sums in
// shared memory; the output is staged (two buffers) and stored by TMA.  The
// grid is persistent.
//
// float32, layers 1-6: conv_tf32_kernel, split TF32 on the tensor cores
// (Tf32Gemm of gemm.cuh: wgmma in TF32, each product as lo_a hi_b +
// hi_a lo_b + hi_a hi_b, the A fragments split in registers, the weight
// split into hi and lo once a call, a 4-stage cp.async ring, fresh partials
// added to running sums by IEEE adds) over the input read in place as an
// overlapping strided view (W2vRows).  Bound: the product counted three
// times at the TF32 peak, 3 * 705 GFLOP for layer 1 of a 14-window batch =
// 4.27 ms at 495 TFLOP/s (on the H100 the scalar mainloop it replaces took
// 22 ms, at the FP32 pipes' 67 TFLOP/s).  The running sums double the
// accumulator, so a CTA holds 128 rows x 128 channels (two warpgroups of 64
// rows) and a cluster of four CTAs a row tile's 512 channels; the LayerNorm
// statistics are merged through distributed shared memory (each CTA's row
// partials read by all four, added in rank order, so every CTA gets the
// same float32 mean and variance).  Each CTA streams a quarter of the split
// weight and the whole A tile (the four read it from L2 at about the same
// time).
//
// float32, layer 0 (k*C <= 16, s*C <= 16): conv_audio_f32_kernel<G>.  Bound
// by bytes: its 1.83 GB output at a 14-window batch, 0.55 ms at 3.35 TB/s;
// the taps, LayerNorm and exact-erf GELU take ~40 instructions an element
// (the erf ~25 of them: ops/tile_sweep.py counts the SASS), which on the
// H100 take longer (0.85-0.9 ms without any store), so the design spends
// its issue slots on them and keeps the stores in flight under them.  A
// persistent grid (occupancy x SMs) walks tiles of 16 rows a warp that
// never cross a batch element; the weight and the conv bias, scale and
// bias are loaded once a CTA; the next tile's span of samples is copied
// into shared memory by cp.async (zeros past the batch element's end)
// while this tile computes, one __syncthreads a tile.  A warp holds a
// group of rows at once (their reductions and GELUs interleave): scalar
// FMAs on the weight read from shared memory as float4, a lane's channels
// 4 lane + 128 p + e, and each row stored as four fully coalesced
// 512-byte warp stores of 16 bytes a lane (st.global.cs: the output
// streams past L2).  All layer-0 and the float32 layer 1-6
// kernels end in the same arithmetic: the mean, then the mean of the
// squared deviations, then the exact-erf GELU, rounded once.

#include "gemm.cuh"
#include "hopper.cuh"

namespace {

constexpr int kConvN = 512;  // output channels

// ---------------------------------------------------------------------------
// float32, layers 1-6: split TF32 on wgmma
// ---------------------------------------------------------------------------

// split TF32, partials of kF32GemmSteps k-steps (8 K each), a ring of
// kF32GemmStages stages of 32 K; a cluster of kF32GemmCluster CTAs, each
// kF32GemmRows rows x kF32GemmCols channels (a warp's 16 rows of them)
constexpr int kF32GemmSteps = 4;
constexpr int kF32GemmStages = 4;
constexpr int kF32GemmRows = 128;
constexpr int kF32GemmCols = 128;
constexpr int kF32GemmCluster = 4;
static_assert(kF32GemmCluster * kF32GemmCols == kConvN, "a row a cluster");
using ConvTf32 = Tf32Gemm<kF32GemmCols, kF32GemmStages, kF32GemmSteps>;
static_assert(ConvTf32::kBM == kF32GemmRows, "row tiles");
// shared floats past the stages: the CTA's row sums and squared deviations
// [2][kBM] (read by the cluster), the rows' mean and 1/std [2][kBM]
constexpr int kConvTf32Smem = ConvTf32::kSmemBytes + 4 * ConvTf32::kBM * 4;

// one cluster a row tile of 128 rows; CTA rank r owns channels
// [128 r, 128 r + 128)
__global__ void __launch_bounds__(ConvTf32::kThreads, 1)
conv_tf32_kernel(const float* __restrict__ x, W2vRows rows, long long m_rows,
                 int k, const float* __restrict__ whi,
                 const float* __restrict__ wlo,
                 const float* __restrict__ conv_bias,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, float eps,
                 float* __restrict__ out) {
  using G = ConvTf32;
  extern __shared__ __align__(1024) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + G::kSmemBytes);  // [2][kBM]
  float* stat = xs + 2 * G::kBM;                                // [2][kBM]
  const unsigned rank = hop_cluster_rank();
  const long long m0 = (long long)(blockIdx.x / kF32GemmCluster) * G::kBM;
  const int n0 = rank * G::kBN;
  G g;
  g.run(x, rows, m_rows, whi, wlo, k, k, m0, n0, smem);

  const int tid = threadIdx.x, lane = tid % 32;
  // the row statistic p (0: sums, 1: squared deviations) of the thread's
  // values f(e) (sum[e]'s), merged over the quad (a warp holds its rows'
  // 128 channels) and the cluster's CTAs in rank order; then stat[p][row]
  // = done(the row's total)
  auto row_stat = [&](int p, auto&& f, auto&& done) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < G::kBN / 8; ++j) {
        s += f(4 * j + 2 * h);
        s += f(4 * j + 2 * h + 1);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (lane % 4 == 0) xs[p * G::kBM + G::row_of(h)] = s;
    }
    hop_cluster_sync();  // every CTA's partials are written
    if (tid < G::kBM) {
      const uint32_t at = hop_smem(xs + p * G::kBM + tid);
      float s = hop_ld_cluster_f32(hop_mapa(at, 0));
#pragma unroll
      for (int q = 1; q < kF32GemmCluster; ++q)
        s += hop_ld_cluster_f32(hop_mapa(at, q));
      stat[p * G::kBM + tid] = done(s);
    }
    __syncthreads();
  };

  // conv bias, then the row sums -> the mean
#pragma unroll
  for (int j = 0; j < G::kBN / 8; ++j) {
    const float2 c =
        *reinterpret_cast<const float2*>(conv_bias + n0 + G::col_of(j));
    g.sum[4 * j] += c.x;
    g.sum[4 * j + 1] += c.y;
    g.sum[4 * j + 2] += c.x;
    g.sum[4 * j + 3] += c.y;
  }
  row_stat(0, [&](int e) { return g.sum[e]; },
           [](float s) { return s / kConvN; });
  // the deviations from the mean replace the sums
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mean = stat[G::row_of(h)];
#pragma unroll
    for (int j = 0; j < G::kBN / 8; ++j) {
      g.sum[4 * j + 2 * h] -= mean;
      g.sum[4 * j + 2 * h + 1] -= mean;
    }
  }
  row_stat(1, [&](int e) { return g.sum[e] * g.sum[e]; },
           [eps](float s) { return rsqrtf(s / kConvN + eps); });

  g.for_each([&](int r, int c, float v0, float v1) {
    const long long m = m0 + r;
    if (m >= m_rows) return;
    const float rstd = stat[G::kBM + r];
    const float2 s2 = *reinterpret_cast<const float2*>(scale + n0 + c);
    const float2 b2 = *reinterpret_cast<const float2*>(bias + n0 + c);
    *reinterpret_cast<float2*>(out + m * kConvN + n0 + c) =
        make_float2(w2v_gelu(v0 * rstd * s2.x + b2.x),
                    w2v_gelu(v1 * rstd * s2.y + b2.y));
  });
  hop_cluster_sync();  // no CTA leaves while the cluster reads its partials
}

// ---------------------------------------------------------------------------
// float32, the raw-audio layer 0: persistent, store-bound
// ---------------------------------------------------------------------------

constexpr int kAudioMaxK = 16;        // widest product k*C of layer 0
constexpr int kAudioF32MaxStep = 16;  // widest row step s*C in float32

// a warp holds a group of ROWS rows at once; WARPS warps a CTA, 16 rows a
// warp a tile
template <int ROWS, int WARPS>
struct AudioF32 {
  static constexpr int kGroup = ROWS;
  static constexpr int kWarps = WARPS;
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kTile = 16 * WARPS;      // rows a tile
  static constexpr int kSpan = (kTile - 1) * kAudioF32MaxStep + kAudioMaxK;
  // shared memory: the weight [16 taps][512] floats, the conv bias, scale
  // and bias [3][512], two spans
  static constexpr int kPar = kAudioMaxK * kConvN * 4;
  static constexpr int kSpans = kPar + 3 * kConvN * 4;
  static constexpr int kSmemBytes = kSpans + 2 * kSpan * 4;
  static_assert(16 % kGroup == 0, "whole groups a tile");
  static_assert(kSmemBytes <= 227 * 1024, "shared memory");
};

// 4 bytes global -> shared without registers; zeros where !valid (then
// nothing is read, and src only needs to be a valid address)
__device__ __forceinline__ void audio_cp4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hop_smem(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ float audio_act(float v) { return w2v_gelu(v); }

// a group of ROWS rows: row i's samples at sp + i * step, its output at
// out_rows + i * 512 (rows i < valid stored); the lane's channels
// 4 lane + 128 p + e (p, e < 4), summed in that order
template <class G>
__device__ __forceinline__ void audio_rows(const float* sp, int step,
                                           int kdim, const float* w_s,
                                           const float* par, float eps,
                                           float* out_rows, int valid,
                                           int lane) {
  constexpr int R = G::kGroup;
  const float4* w4 = reinterpret_cast<const float4*>(w_s);
  const float4* cb4 = reinterpret_cast<const float4*>(par);
  const float4* sc4 = cb4 + kConvN / 4;
  const float4* bi4 = sc4 + kConvN / 4;
  float v[R][16];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float4 c = cb4[lane + 32 * p];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      v[i][4 * p] = c.x;
      v[i][4 * p + 1] = c.y;
      v[i][4 * p + 2] = c.z;
      v[i][4 * p + 3] = c.w;
    }
  }
  // the taps in order onto the conv bias, each weight float4 serving the
  // group's rows
  for (int j = 0; j < kdim; ++j) {
    float xs[R];
#pragma unroll
    for (int i = 0; i < R; ++i) xs[i] = sp[i * step + j];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float4 wv = w4[j * (kConvN / 4) + lane + 32 * p];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        v[i][4 * p] = fmaf(xs[i], wv.x, v[i][4 * p]);
        v[i][4 * p + 1] = fmaf(xs[i], wv.y, v[i][4 * p + 1]);
        v[i][4 * p + 2] = fmaf(xs[i], wv.z, v[i][4 * p + 2]);
        v[i][4 * p + 3] = fmaf(xs[i], wv.w, v[i][4 * p + 3]);
      }
    }
  }
  // the rows' reductions side by side: the mean, the deviations in place,
  // the mean of their squares
  float mean[R], rstd[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 16; ++q) s += v[i][q];
    mean[i] = s;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) mean[i] = w2v_warp_sum(mean[i]) / kConvN;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      v[i][q] -= mean[i];
      s += v[i][q] * v[i][q];
    }
    rstd[i] = s;
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    rstd[i] = rsqrtf(w2v_warp_sum(rstd[i]) / kConvN + eps);
  // a lane's 4 channels of a row: one 16-byte evict-first store
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float4 s = sc4[lane + 32 * p], b = bi4[lane + 32 * p];
    const int c = 4 * lane + 128 * p;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 y =
          make_float4(audio_act(v[i][4 * p] * rstd[i] * s.x + b.x),
                      audio_act(v[i][4 * p + 1] * rstd[i] * s.y + b.y),
                      audio_act(v[i][4 * p + 2] * rstd[i] * s.z + b.z),
                      audio_act(v[i][4 * p + 3] * rstd[i] * s.w + b.w));
      if (i < valid)
        __stcs(reinterpret_cast<float4*>(out_rows + i * kConvN + c), y);
    }
  }
}

// x [batch, t_in * c_in] float32, w [512, k * c_in]; the tiles (batch
// element, 16 * WARPS rows) walked from blockIdx.x by gridDim.x
template <class G>
__global__ void __launch_bounds__(G::kThreads, 1)
conv_audio_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ conv_bias,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, float eps,
                      float* __restrict__ out, int batch, long long t_in,
                      int c_in, int k, int stride, int t_out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem);
  float* par = reinterpret_cast<float*>(smem + G::kPar);
  float* spans = reinterpret_cast<float*>(smem + G::kSpans);
  const int kdim = k * c_in, step = stride * c_in;
  const long long len_b = t_in * c_in;  // elements of a batch element
  const int span = (G::kTile - 1) * step + kdim;
  const int tiles_b = (t_out + G::kTile - 1) / G::kTile;
  const int n_tiles = batch * tiles_b;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  // a tile's span into spans[buf]: elements [r0 * s*C, + span) of its
  // batch element, zeros past the element's end
  auto fetch = [&](int tile, int buf) {
    const int b = tile / tiles_b, r0 = (tile % tiles_b) * G::kTile;
    const long long first = (long long)r0 * step;
    const float* src = x + b * len_b + first;
    float* dst = spans + buf * G::kSpan;
    for (int e = threadIdx.x; e < span; e += G::kThreads) {
      const bool ok = first + e < len_b;
      audio_cp4(dst + e, ok ? src + e : x, ok);
    }
    tf32_cp_commit();
  };
  if ((int)blockIdx.x < n_tiles) fetch(blockIdx.x, 0);

  // the weight and the parameters, once a CTA, under the first copies:
  // the weight [16 taps][512] read in w's order (coalesced), zeros past k*C
  for (int i = threadIdx.x; i < kAudioMaxK * kConvN; i += G::kThreads) {
    if (i < kdim * kConvN)
      w_s[(i % kdim) * kConvN + i / kdim] = w[i];
    else
      w_s[i] = 0.f;
  }
  for (int i = threadIdx.x; i < kConvN; i += G::kThreads) {
    par[i] = conv_bias[i];
    par[kConvN + i] = scale[i];
    par[2 * kConvN + i] = bias[i];
  }

  unsigned it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    // this tile's span has landed (the first time also the weight), and
    // every warp is done with the span of the last tile, which the next
    // fetch overwrites
    tf32_cp_wait<0>();
    __syncthreads();
    if (tile + (int)gridDim.x < n_tiles)
      fetch(tile + gridDim.x, (it + 1) & 1);
    const int b = tile / tiles_b, r0 = (tile % tiles_b) * G::kTile;
    const float* sp = spans + (it & 1) * G::kSpan;
    float* out_t = out + ((long long)b * t_out + r0) * kConvN;
    // group q of warp w: rows (q * WARPS + w) * kGroup of the tile, so the
    // warps store neighbouring rows at a time
#pragma unroll 1
    for (int q = 0; q < 16 / G::kGroup; ++q) {
      const int rg = (q * G::kWarps + warp) * G::kGroup;
      const int valid = t_out - r0 - rg;  // rows of the group to store
      if (valid <= 0) break;
      audio_rows<G>(sp + rg * step, step, kdim, w_s, par, eps,
                    out_t + (long long)rg * kConvN, valid, lane);
    }
  }
}

// 2 rows a group, 16 warps a CTA (117 registers: one CTA an SM).  The time
// goes to the exact erf (one polynomial whose coefficients are picked by a
// select each, ~25 instructions an element), not to the taps or the
// stores: taps on the tensor cores in split TF32 ran 0.6% slower, and rows
// staged in shared memory and written by bulk (TMA) copies 10-30% slower,
// so neither route is kept (PERF.md).  ops/tile_sweep.py audio_f32 sweeps
// the rows a group and the warps, and probes the kernel without stores and
// without GELU.
using AudioF32Cfg = AudioF32<2, 16>;

// ---------------------------------------------------------------------------
// bf16, conv layers 1-6: wgmma + TMA in a cluster of CM x 2 CTAs
// ---------------------------------------------------------------------------

// the 16-byte chunk `chunk` (0-7) of row `row` in a 128-byte-swizzled box
__device__ __forceinline__ int sw128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

template <int STAGES, int CM, bool MC>
struct ConvWg {
  static constexpr int kStages = STAGES;
  static constexpr bool kMc = MC;            // A halves multicast
  static constexpr int kCm = CM;             // row groups (tiles) a cluster
  static constexpr int kCluster = 2 * CM;    // rank = 2 * row group + half
  static constexpr int kRows = 128;          // rows of a CTA's tile
  static constexpr int kCols = kConvN / 2;   // channels of a CTA
  static constexpr int kBK = 64;             // K-steps a stage
  static constexpr int kConsumers = 256;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static constexpr int kABytes = kRows * kBK * 2;       // two 64-row boxes
  static constexpr int kBBytes = kCols * kBK * 2;       // CM boxes
  static constexpr int kStage = kABytes + kBBytes;
  static constexpr int kBox = 64 * 64 * 2;  // an output box: 64 rows x 64
  // output boxes a warpgroup stages at a time (of its 4 a tile): all 4
  // where they fit beside the stages, else 2
  static constexpr int kFixed = 1024 + 2 * kRows * 4 + 8 * (2 * STAGES + 2);
  static constexpr int kOutBoxes =
      STAGES * kStage + 8 * kBox + kFixed <= 232448 ? 4 : 2;
  static constexpr int kOut = STAGES * kStage;
  static constexpr int kX = kOut + 2 * kOutBoxes * kBox;  // partner's sums
  static constexpr int kBar = kX + 2 * kRows * 4;    // full, empty, xbar
  static constexpr int kSmemBytes = kBar + kFixed - 2 * kRows * 4;
  // arrivals that free a stage: both consumer warpgroups of every CTA whose
  // shared memory this CTA's loads write (itself; with MC its partner in the
  // row group, rank ^ 1; with CM = 2 its partner in the half, rank ^ 2)
  static constexpr int kEmptyCount = 2 * (CM + (MC ? 1 : 0));
  // arrivals of the partner's sums: one thread a quad, 64 rows a warpgroup
  static constexpr int kXCount = kConsumers / 4;
  static_assert(CM == 1 || CM == 2, "cluster shape");
  static_assert(STAGES >= 2 && kSmemBytes <= 227 * 1024, "shared memory");
};

// the producer thread: every K step of the cluster's row tiles
template <class G>
__device__ __forceinline__ void conv_wg_produce(
    unsigned char* smem, uint64_t* full, uint64_t* empty,
    const CUtensorMap* a0map, const CUtensorMap* a1map,
    const CUtensorMap* wmap, unsigned half, unsigned group, int t_out,
    int tiles_b, int n_tiles, int k0_tiles, int k_tiles) {
  const uint16_t a_mask = 3u << (2 * group);                  // my row group
  const uint16_t b_mask = (1u << half) | (1u << (2 + half));  // my half
  constexpr int kBRows = G::kCols / G::kCm;
  const int n_ct = (n_tiles + G::kCm - 1) / G::kCm;
  int g = 0;
  for (int ct = blockIdx.x / G::kCluster; ct < n_ct;
       ct += gridDim.x / G::kCluster) {
    const int tile = ct * G::kCm + group;
    const int b = tile / tiles_b, r0 = (tile % tiles_b) * G::kRows;
    // the 64-row halves of the A box that hold rows: none for a row group
    // past the last tile (CM = 2), one where a last tile's second half
    // lies wholly past t_out; no box is loaded for the others (their rows
    // are never stored, and a row's epilogue reads only its own sums)
    const int halves = tile >= n_tiles ? 0 : r0 + 64 < t_out ? 2 : 1;
    for (int kt = 0; kt < k_tiles; ++kt, ++g) {
      const int s = g % G::kStages;
      unsigned char* st = smem + s * G::kStage;
      hop_mbar_wait(&empty[s], ((g / G::kStages) & 1) ^ 1);
      hop_mbar_expect_tx(&full[s], G::kStage - (2 - halves) * 64 * 128);
      const bool tap0 = kt < k0_tiles;
      const CUtensorMap* amap = tap0 ? a0map : a1map;
      const int c0 = (tap0 ? kt : kt - k0_tiles) * G::kBK;
      for (int j = 0; j < halves; ++j)
        if (!G::kMc)
          hop_tma_load_3d(st + j * 64 * 128, amap, &full[s], c0, r0 + 64 * j,
                          b);
        else if (j == (int)half)
          hop_tma_load_3d_mc(st + j * 64 * 128, amap, &full[s], c0,
                             r0 + 64 * j, b, a_mask);
      unsigned char* bs = st + G::kABytes + group * kBRows * 128;
      const int n0 = half * G::kCols + group * kBRows;
      if (G::kCm == 1)
        hop_tma_load_3d(bs, wmap, &full[s], kt * G::kBK, n0, 0);
      else
        hop_tma_load_3d_mc(bs, wmap, &full[s], kt * G::kBK, n0, 0, b_mask);
    }
  }
}

template <class G>
__global__ void __launch_bounds__(G::kThreads, 1)
conv_wg_kernel(const __grid_constant__ CUtensorMap a0map,
               const __grid_constant__ CUtensorMap a1map,
               const __grid_constant__ CUtensorMap wmap,
               const __grid_constant__ CUtensorMap omap,
               const float* __restrict__ conv_bias,
               const float* __restrict__ scale,
               const float* __restrict__ bias, float eps, int batch,
               int t_out, int k0_tiles, int k_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop_align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kBar);
  uint64_t* empty = full + G::kStages;
  uint64_t* xbar = empty + G::kStages;  // [2]: sums, squared deviations
  float* xs = reinterpret_cast<float*>(smem + G::kX);  // [2][kRows]
  const unsigned rank = hop_cluster_rank();
  const unsigned half = rank & 1, group = rank >> 1;
  const int tiles_b = (t_out + G::kRows - 1) / G::kRows;
  const int n_tiles = batch * tiles_b;
  const int n_ct = (n_tiles + G::kCm - 1) / G::kCm;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      hop_mbar_init(&full[s], 1);
      hop_mbar_init(&empty[s], G::kEmptyCount);
    }
    hop_mbar_init(&xbar[0], G::kXCount);
    hop_mbar_init(&xbar[1], G::kXCount);
    hop_mbar_init_fence();
  }
  __syncthreads();
  hop_cluster_sync();  // the partners' barriers are initialised

  if (threadIdx.x >= G::kConsumers) {  // the producer warpgroup
    hop_setmaxnreg_dec<G::kProducerRegs>();
    if (threadIdx.x == G::kConsumers)
      conv_wg_produce<G>(smem, full, empty, &a0map, &a1map, &wmap, half,
                         group, t_out, tiles_b, n_tiles, k0_tiles, k_tiles);
    __syncwarp();
    hop_cluster_sync();  // no CTA leaves while a partner may still signal it
    return;
  }
  hop_setmaxnreg_inc<G::kConsumerRegs>();
  const int wg = threadIdx.x / 128;  // rows [64 wg, 64 wg + 64) of the tile
  const int t = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
  const int q = lane % 4;
  // this thread's rows within the warpgroup's 64: r and r + 8
  const int r = (t / 32) * 16 + lane / 4;
  const unsigned partner = rank ^ 1;
  const uint32_t x_remote = hop_mapa(hop_smem(xs), partner);
  const uint32_t xbar_remote = hop_mapa(hop_smem(xbar), partner);
  unsigned char* out_s = smem + G::kOut + wg * G::kOutBoxes * G::kBox;
  // this CTA's channels of the parameters (read through the L1 cache)
  const float2* cb2 =
      reinterpret_cast<const float2*>(conv_bias + half * G::kCols);
  const float2* sc2 = reinterpret_cast<const float2*>(scale + half * G::kCols);
  const float2* bi2 = reinterpret_cast<const float2*>(bias + half * G::kCols);

  // frees stage s in every CTA that writes it
  auto release = [&](int s) {
    if (t == 0) hop_mbar_arrive(&empty[s]);
    if (G::kMc && t == 32)
      hop_mbar_arrive_cluster(hop_mapa(hop_smem(&empty[s]), rank ^ 1));
    if (G::kCm == 2 && t == 64)
      hop_mbar_arrive_cluster(hop_mapa(hop_smem(&empty[s]), rank ^ 2));
  };
  // the quad's row partials va (row r) and vb (row r + 8) to the partner;
  // the partner's added, va and vb become the sums over all 512 channels
  auto exchange = [&](int p, unsigned parity, float& va, float& vb) {
    if (q == 0) {
      const uint32_t dst = x_remote + (p * G::kRows + 64 * wg + r) * 4;
      hop_st_cluster_f32(dst, va);
      hop_st_cluster_f32(dst + 8 * 4, vb);
      hop_mbar_arrive_cluster(xbar_remote + 8 * p);
    }
    hop_mbar_wait_cluster(&xbar[p], parity);
    float pa = 0.f, pb = 0.f;
    if (q == 0) {
      pa = xs[p * G::kRows + 64 * wg + r];
      pb = xs[p * G::kRows + 64 * wg + r + 8];
    }
    va += __shfl_sync(0xffffffffu, pa, lane & ~3);
    vb += __shfl_sync(0xffffffffu, pb, lane & ~3);
  };

  float acc[128];
  int g = 0;
  unsigned it = 0;
  for (int ct = blockIdx.x / G::kCluster; ct < n_ct;
       ct += gridDim.x / G::kCluster, ++it) {
    const int tile = ct * G::kCm + group;
    const int b = tile / tiles_b, r0 = (tile % tiles_b) * G::kRows;
    for (int kt = 0; kt < k_tiles; ++kt, ++g) {
      const int s = g % G::kStages;
      hop_mbar_wait(&full[s], (g / G::kStages) & 1);
      const unsigned char* a_s = smem + s * G::kStage + wg * 64 * 128;
      const unsigned char* b_s = smem + s * G::kStage + G::kABytes;
      hop_fence_regs(acc);
      hop_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < G::kBK / 16; ++kk)
        hop_wgmma_ss<256>(acc, hop_desc_sw128(a_s + kk * 32, 16, 1024),
                          hop_desc_sw128(b_s + kk * 32, 16, 1024),
                          (kt | kk) != 0);
      hop_wgmma_commit();
      // the group of the previous K step has retired: its stage is free
      hop_wgmma_wait<1>();
      hop_fence_regs(acc);
      if (kt > 0) release((g - 1) % G::kStages);
    }
    hop_wgmma_wait<0>();
    hop_fence_regs(acc);
    release((g - 1) % G::kStages);

    // conv bias, then the row sums over this CTA's 256 channels
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float2 c = __ldg(cb2 + 4 * i + q);
      acc[4 * i] += c.x;
      acc[4 * i + 1] += c.y;
      acc[4 * i + 2] += c.x;
      acc[4 * i + 3] += c.y;
      sa += acc[4 * i];
      sa += acc[4 * i + 1];
      sb += acc[4 * i + 2];
      sb += acc[4 * i + 3];
    }
    sa += __shfl_xor_sync(0xffffffffu, sa, 1);
    sa += __shfl_xor_sync(0xffffffffu, sa, 2);
    sb += __shfl_xor_sync(0xffffffffu, sb, 1);
    sb += __shfl_xor_sync(0xffffffffu, sb, 2);
    exchange(0, it & 1, sa, sb);
    // the deviations from the mean replace the sums (no second copy)
    const float mean_a = sa / kConvN, mean_b = sb / kConvN;
    float qa = 0.f, qb = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc[4 * i] -= mean_a;
      acc[4 * i + 1] -= mean_a;
      acc[4 * i + 2] -= mean_b;
      acc[4 * i + 3] -= mean_b;
      qa += acc[4 * i] * acc[4 * i];
      qa += acc[4 * i + 1] * acc[4 * i + 1];
      qb += acc[4 * i + 2] * acc[4 * i + 2];
      qb += acc[4 * i + 3] * acc[4 * i + 3];
    }
    qa += __shfl_xor_sync(0xffffffffu, qa, 1);
    qa += __shfl_xor_sync(0xffffffffu, qa, 2);
    qb += __shfl_xor_sync(0xffffffffu, qb, 1);
    qb += __shfl_xor_sync(0xffffffffu, qb, 2);
    exchange(1, it & 1, qa, qb);
    const float rstd_a = rsqrtf(qa / kConvN + eps);
    const float rstd_b = rsqrtf(qb / kConvN + eps);

    // the warpgroup's 4 output boxes, kOutBoxes at a time through the
    // staging buffer; before a pass writes it, the stores that read it last
    // have finished reading
#pragma unroll
    for (int p = 0; p < 4 / G::kOutBoxes; ++p) {
      if (t == 0) hop_bulk_wait_read<0>();
      hop_bar_sync(1 + wg, 128);
#pragma unroll
      for (int i = 8 * G::kOutBoxes * p; i < 8 * G::kOutBoxes * (p + 1);
           ++i) {
        const float2 s2 = __ldg(sc2 + 4 * i + q), b2 = __ldg(bi2 + 4 * i + q);
        unsigned char* box =
            out_s + (i / 8 - G::kOutBoxes * p) * G::kBox + 4 * q;
        *reinterpret_cast<uint32_t*>(box + sw128(r, i % 8)) = w2v_pack_bf16(
            w2v_gelu(acc[4 * i] * rstd_a * s2.x + b2.x),
            w2v_gelu(acc[4 * i + 1] * rstd_a * s2.y + b2.y));
        *reinterpret_cast<uint32_t*>(box + sw128(r + 8, i % 8)) =
            w2v_pack_bf16(w2v_gelu(acc[4 * i + 2] * rstd_b * s2.x + b2.x),
                          w2v_gelu(acc[4 * i + 3] * rstd_b * s2.y + b2.y));
      }
      hop_fence_async_smem();
      hop_bar_sync(1 + wg, 128);
      if (t == 0 && tile < n_tiles && r0 + 64 * wg < t_out) {
#pragma unroll
        for (int bx = 0; bx < G::kOutBoxes; ++bx)
          hop_tma_store_3d(&omap, out_s + bx * G::kBox,
                           half * G::kCols + 64 * (G::kOutBoxes * p + bx),
                           r0 + 64 * wg, b);
        hop_bulk_commit();
      }
    }
  }
  if (t == 0) hop_bulk_wait<0>();
  hop_cluster_sync();
}

// 4 stages, a pair of CTAs, each loading its whole A box (ops/tile_sweep.py
// sweeps the stages, the 2 x 2 cluster, the A multicast and the grid:
// persistent, or one cluster a tile; PERF.md)
using ConvWgCfg = ConvWg<4, 1, false>;
constexpr bool kConvPersistent = true;

// ---------------------------------------------------------------------------
// bf16, the raw-audio layer 0: tensor-core taps, persistent
// ---------------------------------------------------------------------------

template <int STRIPS>
struct AudioTc {
  static constexpr int kRows = 16 * STRIPS;  // rows a tile
  static constexpr int kThreads = 128 * STRIPS;  // 4 warps a 16-row strip
  static constexpr int kMinBlocks = STRIPS <= 2 ? 2 : 1;
  // span of a tile's rows: s*C <= 64, k*C <= 16
  static constexpr int kMaxSpan = (kRows - 1) * 64 + kAudioMaxK;
  static constexpr int kSpanRegs = (kMaxSpan + kThreads - 1) / kThreads;
  static constexpr int kBoxBytes = kRows * 128;  // 64 channels x kRows rows
  static constexpr int kOutBytes = 8 * kBoxBytes;
  static constexpr int kFrag = 0;  // B fragments [64 n-tiles][32 lanes] uint2
  static constexpr int kOut = kFrag + 64 * 32 * 8;  // two staging buffers
  static constexpr int kPar = kOut + 2 * kOutBytes;  // cb, scale, bias [512]
  static constexpr int kRed = kPar + 3 * kConvN * 4;  // [2][kRows][4] floats
  static constexpr int kSpan = kRed + 2 * kRows * 16;  // [kMaxSpan] bf16
  static constexpr int kSmemBytes = 1024 + kSpan + 2 * kMaxSpan;
  static_assert(kSmemBytes * kMinBlocks <= 227 * 1024, "shared memory");
};

template <class G>
__global__ void __launch_bounds__(G::kThreads, G::kMinBlocks)
conv_audio_tc_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const __grid_constant__ CUtensorMap omap,
                     const float* __restrict__ conv_bias,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, float eps, int batch,
                     long long t_in, int c_in, int k, int stride, int t_out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hop_align1024(smem_raw);
  uint2* frag = reinterpret_cast<uint2*>(smem + G::kFrag);
  float* par = reinterpret_cast<float*>(smem + G::kPar);
  float* red = reinterpret_cast<float*>(smem + G::kRed);
  unsigned short* span_s = reinterpret_cast<unsigned short*>(smem + G::kSpan);
  const unsigned short* xb = reinterpret_cast<const unsigned short*>(x);
  const unsigned short* wb = reinterpret_cast<const unsigned short*>(w);
  const int kdim = k * c_in, row_step = stride * c_in;
  const long long len_b = t_in * c_in;  // elements of a batch element
  const int span = (G::kRows - 1) * row_step + kdim;
  const int tiles_b = (t_out + G::kRows - 1) / G::kRows;
  const int n_tiles = batch * tiles_b;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int q = lane % 4, gr = lane / 4;
  const int strip = warp / 4, quarter = warp % 4;
  const int ra = 16 * strip + gr, rb = ra + 8;  // this thread's tile rows

  // the weight's B fragments: n-tile nt, lane l holds (k 2q, 2q+1) and
  // (k 2q+8, 2q+9) of channel 8 nt + l / 4, zero past k*C
  for (int i = threadIdx.x; i < 64 * 32; i += G::kThreads) {
    const int n = 8 * (i / 32) + (i % 32) / 4, k0 = 2 * (i % 4);
    unsigned short e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = k0 + (j & 1) + 8 * (j >> 1);
      e[j] = kk < kdim ? wb[n * kdim + kk] : 0;
    }
    frag[i] = make_uint2(e[0] | (uint32_t(e[1]) << 16),
                         e[2] | (uint32_t(e[3]) << 16));
  }
  for (int i = threadIdx.x; i < kConvN; i += G::kThreads) {
    par[i] = conv_bias[i];
    par[kConvN + i] = scale[i];
    par[2 * kConvN + i] = bias[i];
  }
  const float2* cb2 = reinterpret_cast<const float2*>(par);
  const float2* sc2 = cb2 + kConvN / 2;
  const float2* bi2 = sc2 + kConvN / 2;

  // a tile's span into registers: elements [r0 * s*C, + span) of its batch
  // element, zeros past the element's end
  unsigned short sp[G::kSpanRegs];
  auto fetch = [&](int tile) {
    const int b = tile / tiles_b, r0 = (tile % tiles_b) * G::kRows;
    const long long first = (long long)r0 * row_step;
    const unsigned short* src = xb + b * len_b + first;
#pragma unroll
    for (int i = 0; i < G::kSpanRegs; ++i) {
      const int e = threadIdx.x + i * G::kThreads;
      sp[i] = e < span && first + e < len_b ? src[e] : 0;
    }
  };
  if (blockIdx.x < n_tiles) fetch(blockIdx.x);

  unsigned it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int b = tile / tiles_b, r0 = (tile % tiles_b) * G::kRows;
#pragma unroll
    for (int i = 0; i < G::kSpanRegs; ++i) {
      const int e = threadIdx.x + i * G::kThreads;
      if (e < span) span_s[e] = sp[i];
    }
    // this buffer's stores of two tiles ago have read it
    if (threadIdx.x == 0) hop_bulk_wait_read<1>();
    __syncthreads();
    if (tile + (int)gridDim.x < n_tiles) fetch(tile + gridDim.x);

    // A fragments: row ra / rb, k 2q, 2q+1 and 2q+8, 2q+9, zero past k*C
    uint32_t a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = (j & 1) ? rb : ra;
      const int kk = 2 * q + 8 * (j >> 1);
      const unsigned short lo = kk < kdim ? span_s[row * row_step + kk] : 0;
      const unsigned short hi =
          kk + 1 < kdim ? span_s[row * row_step + kk + 1] : 0;
      a[j] = lo | (uint32_t(hi) << 16);
    }
    // channels 128 quarter + 8 nt + 2q + {0, 1}: the conv bias as the
    // accumulator's start, the taps' products added by the tensor cores
    float acc[16][4];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const uint2 bf = frag[(16 * quarter + nt) * 32 + lane];
      const float2 c = cb2[64 * quarter + 4 * nt + q];
      acc[nt][0] = c.x;
      acc[nt][1] = c.y;
      acc[nt][2] = c.x;
      acc[nt][3] = c.y;
      w2v_mma_bf16(acc[nt], a, bf.x, bf.y);
    }
    // row partials
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      sa += acc[nt][0];
      sa += acc[nt][1];
      sb += acc[nt][2];
      sb += acc[nt][3];
    }
    // the four warps' partials of a row, merged in channel order
    auto merge = [&](int p, float& va, float& vb) {
      va += __shfl_xor_sync(0xffffffffu, va, 1);
      va += __shfl_xor_sync(0xffffffffu, va, 2);
      vb += __shfl_xor_sync(0xffffffffu, vb, 1);
      vb += __shfl_xor_sync(0xffffffffu, vb, 2);
      float* rp = red + p * G::kRows * 4;
      if (q == 0) {
        rp[ra * 4 + quarter] = va;
        rp[rb * 4 + quarter] = vb;
      }
      __syncthreads();
      const float4 pa = *reinterpret_cast<const float4*>(rp + ra * 4);
      const float4 pb = *reinterpret_cast<const float4*>(rp + rb * 4);
      va = ((pa.x + pa.y) + pa.z) + pa.w;
      vb = ((pb.x + pb.y) + pb.z) + pb.w;
    };
    merge(0, sa, sb);
    // the deviations from the mean replace the sums
    const float mean_a = sa / kConvN, mean_b = sb / kConvN;
    float qa = 0.f, qb = 0.f;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      acc[nt][0] -= mean_a;
      acc[nt][1] -= mean_a;
      acc[nt][2] -= mean_b;
      acc[nt][3] -= mean_b;
      qa += acc[nt][0] * acc[nt][0];
      qa += acc[nt][1] * acc[nt][1];
      qb += acc[nt][2] * acc[nt][2];
      qb += acc[nt][3] * acc[nt][3];
    }
    merge(1, qa, qb);
    const float rstd_a = rsqrtf(qa / kConvN + eps);
    const float rstd_b = rsqrtf(qb / kConvN + eps);

    unsigned char* out_s = smem + G::kOut + (it & 1) * G::kOutBytes;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int c2 = 64 * quarter + 4 * nt + q;
      const float2 s2 = sc2[c2], b2 = bi2[c2];
      // channel 8 (16 quarter + nt) + 2q: box 2 quarter + nt / 8, chunk
      // nt % 8
      unsigned char* box =
          out_s + (2 * quarter + nt / 8) * G::kBoxBytes + 4 * q;
      *reinterpret_cast<uint32_t*>(box + sw128(ra, nt % 8)) = w2v_pack_bf16(
          w2v_gelu(acc[nt][0] * rstd_a * s2.x + b2.x),
          w2v_gelu(acc[nt][1] * rstd_a * s2.y + b2.y));
      *reinterpret_cast<uint32_t*>(box + sw128(rb, nt % 8)) = w2v_pack_bf16(
          w2v_gelu(acc[nt][2] * rstd_b * s2.x + b2.x),
          w2v_gelu(acc[nt][3] * rstd_b * s2.y + b2.y));
    }
    hop_fence_async_smem();
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll
      for (int bx = 0; bx < 8; ++bx)
        hop_tma_store_3d(&omap, out_s + bx * G::kBoxBytes, 64 * bx, r0, b);
      hop_bulk_commit();
    }
  }
  if (threadIdx.x == 0) hop_bulk_wait<0>();
}

// 64-row tiles, one block of 512 threads an SM (ops/tile_sweep.py sweeps
// the strips and the grid)
using AudioTcCfg = AudioTc<4>;
constexpr bool kAudioPersistent = true;

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// a 3-D bf16 map over `base`: dims (d0, d1, d2), byte strides (s1, s2),
// boxes of 64 x box1 x 1, 128-byte swizzle
bool map3(CUtensorMap* map, const void* base, long long d0, long long d1,
          long long d2, long long s1, long long s2, int box1) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s1),
                                 static_cast<cuuint64_t>(s2)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box1), 1};
  return hop_make_map(map, true, 3, base, dims, strides, box);
}

// the output [batch, t_out, 512] as a map of 64-channel x box_rows boxes
bool out_map(CUtensorMap* map, const void* out, int batch, long long t_out,
             int box_rows) {
  return map3(map, out, kConvN, t_out, batch, 2 * kConvN, 2 * kConvN * t_out,
              box_rows);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <class G>
int launch_conv_wg(const void* x, const void* w, const float* conv_bias,
                   const float* scale, const float* bias, void* out,
                   int batch, long long t_in, int c_in, int k, int stride,
                   long long t_out, float eps, cudaStream_t stream) {
  // taps [0, min(k, s)) by map A0, [s, k) by map A1 (k <= 2s: A1's rows do
  // not overlap), each a whole number of 64-wide K steps
  const int taps0 = k < stride ? k : stride;
  if (!aligned16(x) || !aligned16(w) || !aligned16(out) || c_in % 8 ||
      taps0 * c_in % 64 || (k - taps0) * c_in % 64 || k > 2 * stride)
    return W2V_BAD_ARGS;
  const long long tiles = batch * ((t_out + G::kRows - 1) / G::kRows);
  if (t_out > 0x7fffffffLL || tiles > 0x3fffffffLL || hop_sm_count() == 0)
    return W2V_BAD_ARGS;
  const long long row_bytes = 2LL * stride * c_in;
  const long long batch_bytes = 2 * t_in * c_in;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  CUtensorMap a0, a1, wm, om;
  if (!map3(&a0, xb, (long long)taps0 * c_in, t_out, batch, row_bytes,
            batch_bytes, 64) ||
      !map3(&a1, k > stride ? xb + (long long)stride * c_in : xb,
            k > stride ? (long long)(k - stride) * c_in : 64, t_out, batch,
            row_bytes, batch_bytes, 64) ||
      !map3(&wm, w, (long long)k * c_in, kConvN, 1, 2LL * k * c_in,
            2LL * k * c_in * kConvN, G::kCols / G::kCm) ||
      !out_map(&om, out, batch, t_out, 64))
    return W2V_BAD_ARGS;
  auto kernel = conv_wg_kernel<G>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const long long n_ct = (tiles + G::kCm - 1) / G::kCm;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G::kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_ct * G::kCluster));
  cfg.blockDim = dim3(G::kThreads);
  cfg.dynamicSmemBytes = G::kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  long long clusters = n_ct;
  if (kConvPersistent) {
    static int active = 0;  // clusters the card holds at once
    if (active == 0) {
      e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
      if (e != cudaSuccess) return (int)e;
      if (active == 0) return W2V_BAD_ARGS;
    }
    if (clusters > active) clusters = active;
  }
  cfg.gridDim = dim3((unsigned)(clusters * G::kCluster));
  const int k_tiles = k * c_in / 64, k0_tiles = taps0 * c_in / 64;
  e = cudaLaunchKernelEx(&cfg, kernel, a0, a1, wm, om, conv_bias, scale, bias,
                         eps, batch, (int)t_out, k0_tiles, k_tiles);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <class G>
int launch_audio_tc(const void* x, const void* w, const float* conv_bias,
                    const float* scale, const float* bias, void* out,
                    int batch, long long t_in, int c_in, int k, int stride,
                    long long t_out, float eps, cudaStream_t stream) {
  if (k * c_in > kAudioMaxK || stride * c_in > 64 || !aligned16(out) ||
      t_out > 0x7fffffffLL || hop_sm_count() == 0)
    return W2V_BAD_ARGS;
  const long long tiles = batch * ((t_out + G::kRows - 1) / G::kRows);
  if (tiles > 0x7fffffffLL) return W2V_BAD_ARGS;
  CUtensorMap om;
  if (!out_map(&om, out, batch, t_out, G::kRows)) return W2V_BAD_ARGS;
  auto kernel = conv_audio_tc_kernel<G>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  long long grid = tiles;
  if (kAudioPersistent && grid > (long long)hop_sm_count() * G::kMinBlocks)
    grid = (long long)hop_sm_count() * G::kMinBlocks;
  kernel<<<(unsigned)grid, G::kThreads, G::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), om, conv_bias, scale, bias, eps,
      batch, t_in, c_in, k, stride, (int)t_out);
  return (int)cudaGetLastError();
}

// float32: the overlapping strided view of x as GEMM rows
W2vRows conv_rows(long long t_in, int c_in, int stride, long long t_out) {
  return W2vRows{t_out, t_in * c_in, (long long)stride * c_in};
}

int launch_conv_f32(const void* x, const void* w, const float* conv_bias,
                    const float* scale, const float* bias, void* out,
                    float* split, int batch, long long t_in, int c_in, int k,
                    int stride, long long t_out, float eps,
                    cudaStream_t stream) {
  const W2vRows rows = conv_rows(t_in, c_in, stride, t_out);
  // cp.async needs every row start 16-byte aligned
  const int kdim = k * c_in;
  if (kdim % ConvTf32::kBK || rows.row_stride % 4 || rows.batch_stride % 4 ||
      !aligned16(x) || !aligned16(w) || !aligned16(split) ||
      reinterpret_cast<uintptr_t>(out) % 8 ||
      reinterpret_cast<uintptr_t>(conv_bias) % 8 ||
      reinterpret_cast<uintptr_t>(scale) % 8 ||
      reinterpret_cast<uintptr_t>(bias) % 8)
    return W2V_BAD_ARGS;
  const long long m_rows = batch * t_out;
  const long long blocks =
      (m_rows + ConvTf32::kBM - 1) / ConvTf32::kBM * kF32GemmCluster;
  if (blocks > 0x7fffffffLL) return W2V_BAD_ARGS;
  const long long n = (long long)kConvN * kdim;
  float* whi = split;
  float* wlo = split + n;
  int status =
      launch_tf32_split(static_cast<const float*>(w), whi, wlo, n, stream);
  if (status != 0) return status;
  cudaError_t e = cudaFuncSetAttribute(
      conv_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kConvTf32Smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kF32GemmCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(ConvTf32::kThreads);
  cfg.dynamicSmemBytes = kConvTf32Smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, conv_tf32_kernel, static_cast<const float*>(x),
                         rows, m_rows, kdim, (const float*)whi,
                         (const float*)wlo, conv_bias, scale, bias, eps,
                         static_cast<float*>(out));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <class G>
int launch_audio_f32(const void* x, const void* w, const float* conv_bias,
                     const float* scale, const float* bias, void* out,
                     int batch, long long t_in, int c_in, int k, int stride,
                     long long t_out, float eps, cudaStream_t stream) {
  if (k * c_in > kAudioMaxK || stride * c_in > kAudioF32MaxStep ||
      !aligned16(out) || t_out > 0x7fffffffLL || hop_sm_count() == 0)
    return W2V_BAD_ARGS;
  const long long tiles = batch * ((t_out + G::kTile - 1) / G::kTile);
  if (tiles > 0x7fffffffLL) return W2V_BAD_ARGS;
  auto kernel = conv_audio_f32_kernel<G>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  static int per_sm = 0;  // CTAs an SM holds at once
  if (per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, G::kThreads, G::kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    if (per_sm == 0) return W2V_BAD_ARGS;
  }
  const long long resident = (long long)hop_sm_count() * per_sm;
  kernel<<<(unsigned)(tiles < resident ? tiles : resident), G::kThreads,
           G::kSmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), conv_bias,
      scale, bias, eps, static_cast<float*>(out), batch, t_in, c_in, k,
      stride, (int)t_out);
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
// out [batch, t_out, 512].  w2v_conv_ln_gelu takes, in bf16, x, w and out
// 16-byte aligned, c_in a multiple of 8, min(k, s) * c_in and
// (k - min(k, s)) * c_in multiples of 64 and k <= 2s; in float32, x, w and
// split (float32 scratch of 2 * 512 * k * c_in floats: the weight's TF32 hi
// and lo parts; unused in bf16) 16-byte aligned, k * c_in a multiple of 32
// and s * c_in of 4.  w2v_conv_audio_ln_gelu takes k * c_in <= 16, out
// 16-byte aligned, and s * c_in <= 64 in bf16, <= 16 in float32.  Launch
// on `stream`; return the launch's cudaError_t or W2V_BAD_ARGS.
extern "C" int w2v_conv_ln_gelu(const void* x, const void* w,
                                const void* conv_bias, const void* scale,
                                const void* bias, void* out, void* split,
                                int batch, long long t_in, int c_in, int k,
                                int stride, long long t_out, int n_out,
                                float eps, int dtype, void* stream) {
  if (!conv_shape_ok(batch, t_in, c_in, k, stride, t_out, n_out))
    return W2V_BAD_ARGS;
  const float* cb = static_cast<const float*>(conv_bias);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == W2V_BF16)
    return launch_conv_wg<ConvWgCfg>(x, w, cb, sc, bi, out, batch, t_in, c_in,
                                     k, stride, t_out, eps, s);
  if (dtype == W2V_F32)
    return launch_conv_f32(x, w, cb, sc, bi, out, static_cast<float*>(split),
                           batch, t_in, c_in, k, stride, t_out, eps, s);
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
  const float* cb = static_cast<const float*>(conv_bias);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == W2V_BF16)
    return launch_audio_tc<AudioTcCfg>(x, w, cb, sc, bi, out, batch, t_in,
                                       c_in, k, stride, t_out, eps, s);
  if (dtype == W2V_F32)
    return launch_audio_f32<AudioF32Cfg>(x, w, cb, sc, bi, out, batch, t_in,
                                         c_in, k, stride, t_out, eps, s);
  return W2V_BAD_ARGS;
}
