// Hopper (sm_90a) primitives of the bf16 attention forward kernel
// (attention.cu): mbarriers, TMA tensor loads, and warpgroup MMA (wgmma) on
// bf16 operands with float32 accumulators.
//
// Shared-memory tiles are written by TMA with the 128-byte swizzle: rows of
// 64 bf16 (128 bytes), 8-row atoms of 1024 bytes, the 16-byte chunks of row
// r XOR-ed with r % 8.  A tile with more than 64 columns is kept as
// consecutive 64-column boxes.  Every tile starts on a 1024-byte boundary,
// so a descriptor's base offset stays 0.
#pragma once

#include <cuda.h>  // CUtensorMap
#include <stdint.h>

#include "common.cuh"

__device__ __forceinline__ uint32_t hop_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void hop_mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   hop_smem(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void hop_mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic for this phase
__device__ __forceinline__ void hop_mbar_expect_tx(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   hop_smem(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void hop_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   hop_smem(bar))
               : "memory");
}

// waits until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0: parity 1 passes at once, parity 0 waits)
__device__ __forceinline__ void hop_mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = hop_smem(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box of a 3-D tensor map at element coordinates (c0 innermost)
// into shared memory; rows outside the tensor arrive as zeros; completion
// (the box's full bytes) is counted on `bar`
__device__ __forceinline__ void hop_tma_load_3d(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int c0, int c1,
                                                int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(hop_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(hop_smem(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset (MN-major: the step between 64-column
// boxes; unused for K-major), stride byte offset (the step between 8-row
// atoms), all >> 4; layout type 1 = 128-byte swizzle
__device__ __forceinline__ uint64_t hop_desc_sw128(const void* smem,
                                                   uint32_t lbo_bytes,
                                                   uint32_t sbo_bytes) {
  uint64_t d = (hop_smem(smem) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFFu) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void hop_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void hop_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void hop_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins accumulator registers in place around the asynchronous MMAs, so the
// compiler moves no read or write of them across a fence or a wait
template <int R>
__device__ __forceinline__ void hop_fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B for one m64n64k16 step, A and B from shared memory (both
// K-major); scale_d 0 discards d's previous value
__device__ __forceinline__ void hop_wgmma_ss_n64(float (&d)[32], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A . B for one m64n128k16 step, A and B from shared memory (both
// K-major); scale_d 0 discards d's previous value
__device__ __forceinline__ void hop_wgmma_ss_n128(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A . B for one m64n64k16 step, A from registers (the m64k16 bf16
// fragment: four packed pairs a thread), B from shared memory MN-major
// (transposed: N contiguous)
__device__ __forceinline__ void hop_wgmma_rs_n64_tb(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B for one m64n128k16 step, A from registers (the m64k16 bf16
// fragment: four packed pairs a thread), B from shared memory MN-major
// (transposed: N contiguous)
__device__ __forceinline__ void hop_wgmma_rs_n128_tb(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void hop_wgmma_ss(float (&d)[N / 2], uint64_t da,
                                             uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma N");
  if constexpr (N == 64)
    hop_wgmma_ss_n64(d, da, db, scale_d);
  else
    hop_wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void hop_wgmma_rs_tb(float (&d)[N / 2],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma N");
  if constexpr (N == 64)
    hop_wgmma_rs_n64_tb(d, a, db);
  else
    hop_wgmma_rs_n128_tb(d, a, db);
}
