// Hopper (sm_90a) primitives of the bf16 attention kernels (attention.cu,
// attention_bwd.cu), the FFN's GEMM mainloop (wgmma_gemm.cuh) and the conv
// kernels (convfuse.cu): mbarriers, TMA tensor loads (also multicast to a
// cluster) and stores, warpgroup MMA (wgmma) on bf16 operands with float32
// accumulators, setmaxnreg, and the cluster's barrier and distributed
// shared memory; on the host, the tensor maps TMA reads and writes.
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

// TMA multicast: the box into the shared memory of every CTA of the
// cluster named in `mask` (bit r: cluster rank r), at dst's offset in each,
// the completion counted on each one's barrier at bar's offset
__device__ __forceinline__ void hop_tma_load_3d_mc(void* dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int c0,
                                                   int c1, int c2,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(
          hop_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(hop_smem(bar)), "r"(c0),
      "r"(c1), "r"(c2), "h"(mask)
      : "memory");
}

// TMA store: a box from shared memory into the tensor of a 3-D map at
// element coordinates (c0 innermost); elements outside the tensor are not
// written.  Completion is tracked by bulk groups (hop_bulk_*).
__device__ __forceinline__ void hop_tma_store_3d(const CUtensorMap* map,
                                                 const void* src, int c0,
                                                 int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(hop_smem(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// 1-D bulk copy (TMA without a tensor map): `bytes` (a multiple of 16) from
// global src to shared dst, both 16-byte aligned, completion counted on `bar`
__device__ __forceinline__ void hop_bulk_load(void* dst, const void* src,
                                              unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(hop_smem(dst)),
      "l"(src), "r"(bytes), "r"(hop_smem(bar))
      : "memory");
}

__device__ __forceinline__ void hop_bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void hop_bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// at most N of this thread's bulk groups are still in flight
template <int N>
__device__ __forceinline__ void hop_bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// orders this thread's shared-memory writes before later reads of them by
// the async proxy (a TMA store)
__device__ __forceinline__ void hop_fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` (1-15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void hop_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- thread block clusters
__device__ __forceinline__ unsigned hop_cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every CTA of the cluster (all warps converged)
__device__ __forceinline__ void hop_cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}
// the shared::cluster address of this CTA's shared address `addr` in the
// CTA of cluster rank `rank`
__device__ __forceinline__ uint32_t hop_mapa(uint32_t addr, unsigned rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void hop_st_cluster_f32(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}
// one arrival on a barrier at a shared::cluster address (this CTA's or
// another's), releasing this thread's earlier writes at cluster scope
__device__ __forceinline__ void hop_mbar_arrive_cluster(uint32_t addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          addr)
      : "memory");
}
// hop_mbar_wait with acquire at cluster scope: what other CTAs released
// with their arrivals is visible after it
__device__ __forceinline__ void hop_mbar_wait_cluster(uint64_t* bar,
                                                      unsigned parity) {
  const uint32_t addr = hop_smem(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at a
// shared-memory address: start address, leading byte offset (MN-major:
// the step between 64-column boxes; unused for K-major), stride byte offset
// (the step between 8-row atoms), all >> 4; layout type 1 = 128-byte
// swizzle
__device__ __forceinline__ uint64_t hop_desc_sw128_at(uint32_t addr,
                                                      uint32_t lbo_bytes,
                                                      uint32_t sbo_bytes) {
  uint64_t d = (addr & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFFu) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ uint64_t hop_desc_sw128(const void* smem,
                                                   uint32_t lbo_bytes,
                                                   uint32_t sbo_bytes) {
  return hop_desc_sw128_at(hop_smem(smem), lbo_bytes, sbo_bytes);
}

// a value the compiler cannot compute ahead of the statement that asks for
// it: a wgmma descriptor built from it is built right before its wgmma, not
// hoisted with the others of a loop, where they would all hold registers
__device__ __forceinline__ uint32_t hop_opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

// shared-memory loads at a 32-bit shared address, issued where they stand
// (volatile: after the mbarrier wait that guards the data, and not hoisted
// ahead of their use, where they would hold registers)
__device__ __forceinline__ float2 hop_lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ float hop_lds_f(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
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

// d (+)= A . B for one m64n256k16 step, A and B from shared memory (both
// K-major); scale_d 0 discards d's previous value
__device__ __forceinline__ void hop_wgmma_ss_n256(float (&d)[128], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
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
  static_assert(N == 64 || N == 128 || N == 256, "wgmma N");
  if constexpr (N == 64)
    hop_wgmma_ss_n64(d, da, db, scale_d);
  else if constexpr (N == 128)
    hop_wgmma_ss_n128(d, da, db, scale_d);
  else
    hop_wgmma_ss_n256(d, da, db, scale_d);
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

// Register budget of a warp-specialised block: the producer warpgroup gives
// registers back, the consumer warpgroups take them (every warp of a
// warpgroup executes it; the two roles never reconverge)
template <int N>
__device__ __forceinline__ void hop_setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void hop_setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 1024-byte-aligned start of dynamic shared memory (the 128-byte swizzle's
// atom); the launch asks for 1024 bytes more than the layout needs
__device__ __forceinline__ unsigned char* hop_align1024(unsigned char* p) {
  const uint32_t a = hop_smem(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

// the card's SM count (0 if it cannot be read): a persistent grid's size
inline int hop_sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

typedef CUresult (*HopEncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                     cuuint32_t, void*, const cuuint64_t*,
                                     const cuuint64_t*, const cuuint32_t*,
                                     const cuuint32_t*, CUtensorMapInterleave,
                                     CUtensorMapSwizzle,
                                     CUtensorMapL2promotion,
                                     CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda function), looked up through the
// runtime: the library links only the runtime
inline HopEncodeTiledFn hop_encode_tiled() {
  static HopEncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<HopEncodeTiledFn>(p);
  }
  return fn;
}

// A map of `rank` (2 or 3) dims over `base`: dims[0] innermost, in
// elements; strides[i] the byte step of dim i + 1; boxes of `box`
// elements; elements outside the dims arrive as zeros.  bf16 maps take
// the 128-byte swizzle (box[0] = 64), float32 ones none.
inline bool hop_make_map(CUtensorMap* map, bool bf16, int rank,
                         const void* base, const cuuint64_t* dims,
                         const cuuint64_t* strides, const cuuint32_t* box) {
  const HopEncodeTiledFn encode = hop_encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map,
                bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                rank, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-D map over one bf16 attention operand as it lies, element
// (b, t, h, 0..d) at base + b sb + t st + h sh (in elements): [b, t, row]
// with the row holding every head ((heads - 1) sh + d elements from the
// operand's first), boxes of 64 columns x box_rows rows x 1, 128-byte
// swizzle; rows past t read as zeros.
inline bool hop_operand_map(CUtensorMap* map, const void* base, int b, int t,
                            int heads, int d, long long sb, long long st,
                            long long sh, int box_rows) {
  const long long row_bytes = 2 * st;
  const long long batch_bytes = b == 1 ? row_bytes * t : 2 * sb;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>((heads - 1) * sh + d),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_bytes),
                                 static_cast<cuuint64_t>(batch_bytes)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  return hop_make_map(map, true, 3, base, dims, strides, box);
}

// what TMA needs of such an operand: a 16-byte-aligned base and strides that
// are whole 16-byte units; heads that do not overlap
inline bool hop_operand_ok(const void* p, long long sb, long long st,
                           long long sh, int heads, int d) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st % 8 == 0 &&
         sb % 8 == 0 && sh % 8 == 0 && (heads == 1 || sh >= d) && st > 0 &&
         (long long)(heads - 1) * sh + d <= st;
}
