// Row LayerNorm backward: dx, dscale, dbias.
//
// Replaces the Pallas kernel _ln_bwd_kernel of
// wav2vecsegmenter_tpu/ops/layernorm.py (the custom VJP of every LayerNorm
// that is trained: the SFC head's norm1, norm2 and final LayerNorm).  Per
// row, with float32 statistics recomputed from x:
//   xhat = (x - mean) * rstd,  gs = g * scale,
//   dx   = (gs - mean(gs) - xhat * mean(gs * xhat)) * rstd   (x's type)
// and over all rows, in float32: dscale = sum g * xhat, dbias = sum g.
// A null dx pointer (autograd asks no gradient of x: the head's norm1 on the
// frozen backbone's output) skips dx: x and g are read, dscale and dbias
// written, nothing else.
//
// Bound on the H100: bytes.  x and g are read once and dx written once
// ([14 * 999, 1024] bf16: 85.9 MB, 0.0257 ms at 3.35 TB/s; without dx
// 57.3 MB, 0.0171 ms), about 14 operations an element against the card's
// ~295 FLOP/byte ridge.  The bf16 kernel (ln_bwd_vec_kernel) moves those
// bytes as the forward kernel does (ln_vec.cuh, layernorm.cu):
//
// * 16-byte accesses.  A warp owns a row; lane l owns columns
//   [256 p + 8 l, 256 p + 8 l + 8) of every 256-column pass p: one 16-byte
//   ld.global.nc of x and of g and one 16-byte store of dx a pass; other
//   widths take the masked tail (8-, 4- or 2-byte accesses).
// * scale in registers, column sums per warp.  A lane's columns are the
//   same for every row, so it loads its scale chunk once and adds dscale and
//   dbias of its columns (float32) over every row its warp takes, in
//   registers or (SMEM_SUMS) in the warp's slice of shared memory.
// * A persistent grid: the CTAs the card keeps resident (the occupancy
//   API), each warp walking the rows with a grid stride and keeping the next
//   DEPTH rows of x and g in flight while it reduces one: in a ring of
//   packed registers, or (BULK) in a ring of shared-memory slots filled by
//   1-D bulk copies (cp.async.bulk, one mbarrier a slot), which holds no
//   registers.
// * Deterministic column sums, no float atomics.  The CTA adds its warps'
//   sums in warp order and writes one float32 partial row ([n_ctas, 2, h],
//   about 2 MB at h = 1024); then a fixed-order pass adds the partial rows:
//   thread (column, y) adds partial rows y, y + kRedGroups, ..., and the
//   kRedGroups group sums are added in order.  That pass runs either in a
//   second kernel launched with programmatic dependent launch (its launch
//   overlaps the first kernel's tail; griddepcontrol.wait holds it until the
//   partial rows are written), or (HANDOFF) in the same kernel, launched
//   cooperatively, after a grid-wide barrier: each CTA then adds its share
//   of the 2h columns.  Both give the same bits: the order depends on (rows,
//   h, grid) only, so two runs on the same inputs agree bitwise.
//
// Summation order (tests/test_torch_ln_bwd_tiles.py emulates it): the row
// statistics as in the forward kernel; s1 = sum gs and s2 = sum gs * xhat
// lane by lane, pass by pass, 8 columns in order (s2 by fused multiply-adds),
// then the xor butterfly; each lane's dscale += g * xhat (fused) and dbias +=
// g over its warp's rows in order.  float32 keeps the simple kernel below
// (ln_bwd_rows_kernel: one warp a row, 4 rows a warp, 8 warps a CTA) as the
// oracle arm, on the same partial-row layout and second kernel.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "ln_vec.cuh"

namespace {

constexpr int kMaxH = 4 * kLnPass;  // 1024

// ---------------------------------------------------------------------------
// the cross-block pass over the partial rows [n_part, 2, h]
// ---------------------------------------------------------------------------

constexpr int kRedGroups = 32;  // threads that split a column's partial rows
constexpr int kRedCols = 8;     // columns a CTA of the second kernel
constexpr int kRedThreads = kRedGroups * kRedCols;

// Columns [col0, col0 + NCOLS) of the 2h (dscale, then dbias): thread
// (x, y) = (t % NCOLS, t / NCOLS) adds partial rows y, y + kRedGroups, ...
// in order; then y = 0 adds the kRedGroups sums in order.  The block's
// threads are NCOLS * kRedGroups; `red` holds kRedGroups * (NCOLS + 1)
// floats.  Ends with the block synchronised.
template <int NCOLS>
__device__ __forceinline__ void ln_bwd_cross(const float* partial,
                                             float* __restrict__ dscale,
                                             float* __restrict__ dbias,
                                             int n_part, int h, int col0,
                                             float* red) {
  const int x = threadIdx.x % NCOLS, y = threadIdx.x / NCOLS;
  const int col = col0 + x;
  float s = 0.f;
  if (col < 2 * h) {
    const float* p = partial + col;
#pragma unroll 4
    for (int b = y; b < n_part; b += kRedGroups)
      s += __ldcg(p + (long long)b * 2 * h);  // L2: other CTAs wrote them
  }
  red[y * (NCOLS + 1) + x] = s;
  __syncthreads();
  if (y == 0 && col < 2 * h) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kRedGroups; ++k) t += red[k * (NCOLS + 1) + x];
    if (col < h)
      dscale[col] = t;
    else
      dbias[col - h] = t;
  }
  __syncthreads();
}

// the second kernel: kRedCols columns a CTA, after the row kernel's grid
// has finished (griddepcontrol.wait: a no-op without programmatic launch)
__global__ void __launch_bounds__(kRedThreads)
ln_bwd_reduce_kernel(const float* partial, float* __restrict__ dscale,
                     float* __restrict__ dbias, int n_part, int h) {
  __shared__ float red[kRedGroups * (kRedCols + 1)];
  asm volatile("griddepcontrol.wait;" ::: "memory");
  ln_bwd_cross<kRedCols>(partial, dscale, dbias, n_part, h,
                         blockIdx.x * kRedCols, red);
}

// the second kernel on `stream`, its launch overlapping the first's tail
int launch_reduce(const float* partial, float* dscale, float* dbias,
                  int n_part, int h, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((2 * h + kRedCols - 1) / kRedCols);
  cfg.blockDim = dim3(kRedThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, ln_bwd_reduce_kernel,
                                           partial, dscale, dbias, n_part, h);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: the simple kernel
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;                               // 256 threads
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;    // 32

template <int VPL>
__global__ void __launch_bounds__(kWarps * 32)
ln_bwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ g, float* __restrict__ dx,
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
    const float* xr = x + row * h;
    const float* gr = g + row * h;
    float xv[VPL], gv[VPL];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      xv[i] = c < h ? xr[c] : 0.f;
      gv[i] = c < h ? gr[c] : 0.f;
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
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      if (dx != nullptr && c < h) {
        const float gs = gv[i] * scale[c];
        dx[row * h + c] = (gs - m1 - xv[i] * m2) * rstd;
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

long long rows_grid(long long rows) {
  return (rows + kRowsPerBlock - 1) / kRowsPerBlock;
}

int launch_rows(const float* x, const float* scale, const float* g,
                float* dx, float* dscale, float* dbias, float* partial,
                long long rows, int h, long long n_part, float eps,
                cudaStream_t stream) {
  if (n_part != rows_grid(rows) || n_part > 0x7fffffffLL)
    return W2V_BAD_ARGS;
  const dim3 grid((unsigned)n_part), block(kWarps * 32);
  const int vpl = (h + 31) / 32;
  if (vpl <= 4)
    ln_bwd_rows_kernel<4><<<grid, block, 0, stream>>>(x, scale, g, dx,
                                                      partial, rows, h, eps);
  else if (vpl <= 8)
    ln_bwd_rows_kernel<8><<<grid, block, 0, stream>>>(x, scale, g, dx,
                                                      partial, rows, h, eps);
  else if (vpl <= 16)
    ln_bwd_rows_kernel<16><<<grid, block, 0, stream>>>(x, scale, g, dx,
                                                       partial, rows, h, eps);
  else
    ln_bwd_rows_kernel<32><<<grid, block, 0, stream>>>(x, scale, g, dx,
                                                       partial, rows, h, eps);
  const int status = (int)cudaGetLastError();
  if (status != 0) return status;
  return launch_reduce(partial, dscale, dbias, (int)n_part, h, stream);
}

// ---------------------------------------------------------------------------
// bf16: 16-byte vectors, persistent grid, column sums per warp
// ---------------------------------------------------------------------------

// WARPS a CTA (each walks its own rows), DEPTH rows a warp has in flight
// while it reduces one, MINB CTAs an SM that the register allocation must
// allow (__launch_bounds__); SMEM_SUMS keeps the column sums in the warp's
// slice of shared memory instead of registers; HANDOFF adds the partial rows
// in this kernel (cooperative launch, grid barrier) instead of a second
// kernel; BULK stages the rows in flight in shared memory by bulk copies
// instead of registers (widths that are a multiple of 8; others load into
// registers)
template <int WARPS, int DEPTH, int MINB, bool SMEM_SUMS, bool HANDOFF,
          bool BULK>
struct LnBwd {
  static constexpr int kWarps = WARPS;
  static constexpr int kDepth = DEPTH;
  static constexpr int kMinBlocks = MINB;
  static constexpr bool kSmemSums = SMEM_SUMS;
  static constexpr bool kHandoff = HANDOFF;
  static constexpr bool kBulk = BULK;
};
using LnBwdCfg = LnBwd<8, 1, 1, false, false, false>;

// dynamic shared memory of the kernel: each warp's column sums (float32,
// dscale then dbias; the staging of the CTA's sums in either mode), then,
// with BULK, each warp's ring of DEPTH slots of (x row, g row) and one
// mbarrier a slot
template <class C, int PASSES, bool BULK>
struct LnBwdSmem {
  static constexpr int kCols = PASSES * kLnPass;
  static constexpr int kSumFloats = 2 * kCols;  // a warp's
  static constexpr int kSumBytes = C::kWarps * kSumFloats * 4;
  static constexpr int kSlotBytes = 2 * kCols * 2;  // x row, g row (bf16)
  static constexpr int kRingBytes =
      BULK ? C::kWarps * C::kDepth * kSlotBytes : 0;
  static constexpr int kBytes =
      kSumBytes + kRingBytes + (BULK ? C::kWarps * C::kDepth * 8 : 0);
};

__device__ __forceinline__ void ln_f4_get(const float4& v, float (&a)[kLnChunk],
                                          int at) {
  a[at] = v.x, a[at + 1] = v.y, a[at + 2] = v.z, a[at + 3] = v.w;
}
__device__ __forceinline__ float4 ln_f4_put(const float (&a)[kLnChunk],
                                            int at) {
  return make_float4(a[at], a[at + 1], a[at + 2], a[at + 3]);
}

// The column sums' layout in shared memory, a warp's slice: the float4 of
// columns [256 p + 8 l + 4 q, + 4) (pass p, lane l, half q) at float4 index
// (2 p + q) * 32 + l, so that a warp's 16-byte accesses hit every bank once
// per quarter-warp; dbias after dscale's 2 * PASSES * 32 float4s.
__device__ __forceinline__ int ln_sum_index(int c) {
  return (((c >> 8) * 2 + ((c >> 2) & 1)) * 32 + ((c >> 3) & 31)) * 4 +
         (c & 3);
}

template <class C, int PASSES, bool TAIL, bool DX, bool BULK>
__global__ void __launch_bounds__(C::kWarps * 32, C::kMinBlocks)
ln_bwd_vec_kernel(const __nv_bfloat16* __restrict__ x,
                  const float* __restrict__ scale,
                  const __nv_bfloat16* __restrict__ g,
                  __nv_bfloat16* __restrict__ dx, float* partial,
                  float* __restrict__ dscale, float* __restrict__ dbias,
                  long long rows, int h, float eps) {
  using S = LnBwdSmem<C, PASSES, BULK>;
  constexpr int W = C::kWarps, D = C::kDepth, Q = 2 * PASSES * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stride = (long long)gridDim.x * W;
  const long long first = (long long)blockIdx.x * W + warp;
  float4* sums = reinterpret_cast<float4*>(smem) + warp * (S::kSumFloats / 4);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + S::kSumBytes) +
                        warp * D * 2 * S::kCols;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kSumBytes +
                                               S::kRingBytes) + warp * D;

  // the rows in flight: a ring of register buffers, or of shared slots
  uint4 bx[BULK ? 1 : D][PASSES], bg[BULK ? 1 : D][PASSES];
  auto stage = [&](long long r, int d) {  // BULK: row r into slot d
    if (lane == 0 && r < rows) {
      hop_mbar_expect_tx(&bars[d], 4 * h);
      hop_bulk_load(ring + d * 2 * S::kCols, x + r * h, 2 * h, &bars[d]);
      hop_bulk_load(ring + (d * 2 + 1) * S::kCols, g + r * h, 2 * h,
                    &bars[d]);
    }
  };
  if constexpr (BULK) {
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < D; ++d) hop_mbar_init(&bars[d], 1);
      hop_mbar_init_fence();
    }
    __syncwarp();
#pragma unroll
    for (int d = 0; d < D; ++d) stage(first + d * stride, d);
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      ln_load_row<PASSES, TAIL>(x, first + d * stride, rows, h, lane, bx[d]);
      ln_load_row<PASSES, TAIL>(g, first + d * stride, rows, h, lane, bg[d]);
    }
  }
  // the lane's scale chunks, once (their loads overlap the rows' above),
  // and its column sums
  float sc[PASSES][kLnChunk];
  constexpr int RS = C::kSmemSums ? 1 : PASSES;
  float dsc[RS][kLnChunk], dbi[RS][kLnChunk];
#pragma unroll
  for (int p = 0; p < PASSES; ++p)
    ln_param<TAIL>(scale, p * kLnPass + lane * kLnChunk, h, sc[p]);
#pragma unroll
  for (int p = 0; p < RS; ++p)
#pragma unroll
    for (int j = 0; j < kLnChunk; ++j) dsc[p][j] = dbi[p][j] = 0.f;
  if constexpr (C::kSmemSums) {
#pragma unroll
    for (int i = 0; i < 2 * Q / 32; ++i)
      sums[i * 32 + lane] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  uint32_t phase = 0;  // BULK: the parity each slot waits on, bit d
  for (long long row = first; row < rows; row += D * stride) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const long long r = row + d * stride;
      if (r >= rows) break;  // warp-uniform; every later r is past too
      uint4 xv[PASSES], gv[PASSES];
      if constexpr (BULK) {
        hop_mbar_wait(&bars[d], (phase >> d) & 1u);
        phase ^= 1u << d;
        const __nv_bfloat16* sx = ring + d * 2 * S::kCols;
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
          const int c0 = p * kLnPass + lane * kLnChunk;
          const bool in = !TAIL || c0 < h;  // h % 8 == 0: whole chunks
          xv[p] = in ? *reinterpret_cast<const uint4*>(sx + c0)
                     : make_uint4(0u, 0u, 0u, 0u);
          gv[p] = in ? *reinterpret_cast<const uint4*>(sx + S::kCols + c0)
                     : make_uint4(0u, 0u, 0u, 0u);
        }
        __syncwarp();  // every lane has read the slot: refill it
        stage(r + D * stride, d);
      } else {
#pragma unroll
        for (int p = 0; p < PASSES; ++p) xv[p] = bx[d][p], gv[p] = bg[d][p];
        // the buffers are free: the row D strides on goes in flight now
        ln_load_row<PASSES, TAIL>(x, r + D * stride, rows, h, lane, bx[d]);
        ln_load_row<PASSES, TAIL>(g, r + D * stride, rows, h, lane, bg[d]);
      }

      // the row's statistics, as the forward kernel takes them
      float sum = 0.f;
#pragma unroll
      for (int p = 0; p < PASSES; ++p)
#pragma unroll
        for (int j = 0; j < kLnChunk; ++j) sum += ln_elem(xv[p], j);
      const float mean = w2v_warp_sum(sum) / h;
      float sq = 0.f;
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const int nv = TAIL ? ln_valid(p * kLnPass + lane * kLnChunk, h)
                            : kLnChunk;
#pragma unroll
        for (int j = 0; j < kLnChunk; ++j) {
          const float dv = __fsub_rn(ln_elem(xv[p], j), mean);
          if (!TAIL || j < nv) sq = fmaf(dv, dv, sq);
        }
      }
      const float rstd = rsqrtf(w2v_warp_sum(sq) / h + eps);

      // s1, s2 and the column sums (past h: g = 0 and scale = 0 add 0)
      float s1 = 0.f, s2 = 0.f;
      auto add = [&](int p, float(&a)[kLnChunk], float(&b)[kLnChunk]) {
#pragma unroll
        for (int j = 0; j < kLnChunk; ++j) {
          const float xh = __fmul_rn(__fsub_rn(ln_elem(xv[p], j), mean), rstd);
          const float gj = ln_elem(gv[p], j);
          const float gs = __fmul_rn(gj, sc[p][j]);
          s1 = __fadd_rn(s1, gs);
          s2 = fmaf(gs, xh, s2);
          a[j] = fmaf(gj, xh, a[j]);
          b[j] = __fadd_rn(b[j], gj);
        }
      };
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        if constexpr (C::kSmemSums) {
          float a[kLnChunk], b[kLnChunk];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            ln_f4_get(sums[(2 * p + q) * 32 + lane], a, 4 * q);
            ln_f4_get(sums[Q + (2 * p + q) * 32 + lane], b, 4 * q);
          }
          add(p, a, b);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            sums[(2 * p + q) * 32 + lane] = ln_f4_put(a, 4 * q);
            sums[Q + (2 * p + q) * 32 + lane] = ln_f4_put(b, 4 * q);
          }
        } else {
          add(p, dsc[p], dbi[p]);
        }
      }
      if constexpr (DX) {
        const float m1 = w2v_warp_sum(s1) / h;
        const float m2 = w2v_warp_sum(s2) / h;
        __nv_bfloat16* dxr = dx + r * h;
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
          float y[kLnChunk];
#pragma unroll
          for (int j = 0; j < kLnChunk; ++j) {
            const float xh =
                __fmul_rn(__fsub_rn(ln_elem(xv[p], j), mean), rstd);
            const float gs = __fmul_rn(ln_elem(gv[p], j), sc[p][j]);
            y[j] = __fmul_rn(fmaf(-xh, m2, __fsub_rn(gs, m1)), rstd);
          }
          const int c0 = p * kLnPass + lane * kLnChunk;
          if (!TAIL || ((h & 7) == 0 && c0 + kLnChunk <= h))
            *reinterpret_cast<uint4*>(dxr + c0) = make_uint4(
                w2v_pack_bf16(y[0], y[1]), w2v_pack_bf16(y[2], y[3]),
                w2v_pack_bf16(y[4], y[5]), w2v_pack_bf16(y[6], y[7]));
          else
            ln_store_part(dxr + c0, ln_valid(c0, h), h, y);
        }
      }
    }
  }

  // the second kernel may launch now (its CTAs wait for this grid to
  // finish), under the partial rows' writes and the grid's tail
  if constexpr (!C::kHandoff)
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  // the CTA's partial row: its warps' sums added in warp order
  if constexpr (!C::kSmemSums) {
#pragma unroll
    for (int p = 0; p < PASSES; ++p)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        sums[(2 * p + q) * 32 + lane] = ln_f4_put(dsc[p], 4 * q);
        sums[Q + (2 * p + q) * 32 + lane] = ln_f4_put(dbi[p], 4 * q);
      }
  }
  __syncthreads();
  const float* all = reinterpret_cast<const float*>(smem);
  float* out = partial + (long long)blockIdx.x * 2 * h;
  for (int col = threadIdx.x; col < 2 * h; col += W * 32) {
    const int which = col >= h;
    const int f = which * 4 * Q + ln_sum_index(col - which * h);
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) s += all[w * S::kSumFloats + f];
    out[col] = s;
  }

  if constexpr (C::kHandoff) {
    // every CTA's partial row is written (the barrier orders memory); each
    // CTA adds its share of the 2h columns, kRedGroups threads a column
    cooperative_groups::this_grid().sync();
    constexpr int NC = W * 32 / kRedGroups;
    float* red = reinterpret_cast<float*>(smem);  // the sums are spent
    for (int col0 = blockIdx.x * NC; col0 < 2 * h; col0 += gridDim.x * NC)
      ln_bwd_cross<NC>(partial, dscale, dbias, gridDim.x, h, col0, red);
  }
}

// CTAs an SM holds of one instantiation, and its launch
template <int PASSES, bool TAIL, bool DX, bool BULK>
struct VecKernel {
  using C = LnBwdCfg;
  using S = LnBwdSmem<C, PASSES, BULK>;

  static int per_sm() {
    static int n = 0;
    if (n == 0) {
      auto k = ln_bwd_vec_kernel<C, PASSES, TAIL, DX, BULK>;
      if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::kBytes) != cudaSuccess ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &n, k, C::kWarps * 32, S::kBytes) != cudaSuccess)
        n = 0;
    }
    return n;
  }

  // the persistent grid: the rows' warps, at most the CTAs the card holds
  static long long grid(long long rows) {
    const long long need = (rows + C::kWarps - 1) / C::kWarps;
    const long long resident = (long long)hop_sm_count() * per_sm();
    return need < resident ? need : resident;
  }

  static int launch(const void* x, const float* scale, const void* g,
                    void* dx, float* dscale, float* dbias, float* partial,
                    long long rows, int h, long long n_part, float eps,
                    cudaStream_t stream) {
    if (n_part <= 0 || n_part != grid(rows)) return W2V_BAD_ARGS;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)n_part);
    cfg.blockDim = dim3(C::kWarps * 32);
    cfg.dynamicSmemBytes = S::kBytes;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = C::kHandoff ? 1 : 0;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, ln_bwd_vec_kernel<C, PASSES, TAIL, DX, BULK>,
        static_cast<const __nv_bfloat16*>(x), scale,
        static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dx), partial, dscale, dbias, rows, h,
        eps);
    if (e != cudaSuccess) return (int)e;
    const int status = (int)cudaGetLastError();
    if (status != 0 || C::kHandoff) return status;
    return launch_reduce(partial, dscale, dbias, (int)n_part, h, stream);
  }
};

// f(VecKernel<...>{}) for the instantiation of width h (passes, masked tail
// or not), with dx or not, rows staged by bulk copies or not
template <class F>
long long with_vec(int h, bool dx, F&& f) {
  const int passes = (h + kLnPass - 1) / kLnPass;
  const bool tail = h != passes * kLnPass;
  auto pick = [&](auto P, auto T, auto X) -> long long {
    constexpr int kP = decltype(P)::value;
    constexpr bool kT = decltype(T)::value, kX = decltype(X)::value;
    if constexpr (LnBwdCfg::kBulk) {
      if ((h & 7) == 0) return f(VecKernel<kP, kT, kX, true>{});
    }
    return f(VecKernel<kP, kT, kX, false>{});
  };
  auto with_dx = [&](auto P, auto T) {
    return dx ? pick(P, T, std::true_type{}) : pick(P, T, std::false_type{});
  };
  auto with_tail = [&](auto P) {
    return tail ? with_dx(P, std::true_type{})
                : with_dx(P, std::false_type{});
  };
  switch (passes) {
    case 1:
      return with_tail(std::integral_constant<int, 1>{});
    case 2:
      return with_tail(std::integral_constant<int, 2>{});
    case 3:
      return with_tail(std::integral_constant<int, 3>{});
    default:
      return with_tail(std::integral_constant<int, 4>{});
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Partial rows (float32 [n, 2, h]) the call of w2v_layer_norm_bwd with
// these arguments needs (its grid); 0 if it refuses them or the card
// cannot be queried.
extern "C" int w2v_layer_norm_bwd_partials(long long rows, int h, int dtype,
                                           int dx) {
  if (h <= 0 || h > kMaxH || rows <= 0) return 0;
  long long n = 0;
  if (dtype == W2V_F32) n = rows_grid(rows);
  if (dtype == W2V_BF16 && hop_sm_count() > 0)
    n = with_vec(h, dx != 0, [&](auto k) { return decltype(k)::grid(rows); });
  return n > 0x7fffffffLL ? 0 : (int)n;
}

// x, g: [rows, h] contiguous in the element type; dx: the same, or null for
// no dx; scale: [h] float32; dscale, dbias: [h] float32; partial: [n_part,
// 2, h] float32 workspace, n_part = w2v_layer_norm_bwd_partials(...)
// (refused otherwise).  h <= 1024; bf16: x, g, dx and scale 16-byte
// aligned.  Launches on `stream`; returns the first non-zero cudaError_t.
extern "C" int w2v_layer_norm_bwd(const void* x, const void* scale,
                                  const void* g, void* dx, void* dscale,
                                  void* dbias, void* partial, long long rows,
                                  int h, long long n_part, float eps,
                                  int dtype, void* stream) {
  const float* sc = static_cast<const float*>(scale);
  float* ds = static_cast<float*>(dscale);
  float* db = static_cast<float*>(dbias);
  float* pw = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h <= 0 || h > kMaxH || rows <= 0) return W2V_BAD_ARGS;
  if (dtype == W2V_F32)
    return launch_rows(static_cast<const float*>(x), sc,
                       static_cast<const float*>(g), static_cast<float*>(dx),
                       ds, db, pw, rows, h, n_part, eps, s);
  if (dtype != W2V_BF16 || !aligned16(x) || !aligned16(g) ||
      (dx != nullptr && !aligned16(dx)) || !aligned16(scale) ||
      hop_sm_count() == 0)
    return W2V_BAD_ARGS;
  return (int)with_vec(h, dx != nullptr, [&](auto k) -> long long {
    return decltype(k)::launch(x, sc, g, dx, ds, db, pw, rows, h, n_part,
                               eps, s);
  });
}
