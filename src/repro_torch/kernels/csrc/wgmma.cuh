// Hopper tensor-core building blocks of the bf16 kernels (norm_terms.cu,
// compose_mm.cu, compose_mm_bwd.cu): 16-byte cp.async copies into shared
// memory (selective_scan.cu stages its fp32 tiles with them too), the
// 128-byte swizzle of a shared-memory tile, its wgmma matrix
// descriptor, the warpgroup MMA m64n192k16 with bf16 operands and fp32
// accumulators (PTX ISA 8, "Asynchronous warpgroup level matrix
// instructions"; sm_90a only), and the TMA copies and mbarriers that
// compose_mm.cu's pipeline runs on.
//
// A warpgroup (4 warps) runs one wgmma for a 64 x 192 product over 16 k,
// both operands read by the tensor cores from shared memory. Its fp32
// accumulator fragment, 96 registers a thread, has the mma.sync layout
// per 8-column block: thread (warp w, lane 4·g + q) holds d[4j + 2h + e]
// = C[16w + g + 8h, 8j + 2q + e].
//
// Shared-memory tiles use the 128-byte swizzle: a row of the tile is 128
// bytes (64 bf16), 8 rows form a 1 KB atom, and the 16-byte chunk c of row
// `row` sits at chunk c ^ (row % 8), so 8 lanes reading one chunk column
// hit 8 different banks. An atom must start on a 1 KB boundary. A TMA
// copy through a tensor map made with CU_TENSOR_MAP_SWIZZLE_128B writes
// (and a TMA store reads) a box of 64 columns in exactly this layout.
// - K-major operand (rows along M or N, 64 k per row): 8-row groups are
//   1 KB apart (the descriptor's stride offset); the next 16 k start 32
//   bytes further.
// - MN-major operand (rows along k, 64 of N per row): 8-row k groups are
//   1 KB apart (stride offset) and 64-column N blocks `lbo` bytes apart
//   (leading offset); wgmma reads it transposed (imm-trans-b = 1).
// A product of two bf16 values is exact in fp32, so the only difference
// from an fp32 FMA product is the order of summation.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global to shared memory asynchronously; with
// `valid` false the source is not read and the 16 bytes are zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are still in
// flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's shared-memory writes (st.shared and cp.async)
// visible to the tensor cores' reads (the async proxy); a barrier after it
// covers the other threads'.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk `c` of row `row` in a 128-byte-swizzled
// tile.
__device__ __forceinline__ uint32_t swz128(int row, int c) {
  return row * 128 + ((c ^ (row & 7)) << 4);
}

// wgmma descriptor of a 128-byte-swizzled tile at shared address `addr`
// (bits 0-13 start >> 4, 16-29 leading offset >> 4, 32-45 stride offset
// >> 4, 62-63 swizzle mode 1 = 128 bytes).
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | static_cast<uint64_t>(1)
                                                    << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed wgmma groups are
// still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64 x 192] += A[64 x 16] · B[16 x 192], A K-major from descriptor da,
// B from descriptor db, K-major (TRANS_B = 0) or MN-major (TRANS_B = 1).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, %99;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
}

// ---------------------------------------------------------------------------
// TMA copies and mbarriers. A TMA load copies one 2-D box of a tensor map
// (a __grid_constant__ kernel parameter) into shared memory and counts its
// bytes on an mbarrier; a TMA store copies a box back and joins the
// issuing thread's bulk group. Boxes reaching past the tensor's edge load
// zeros there and store nothing there. Each copy carries an L2 eviction
// priority (the createpolicy encodings that CUTLASS's CacheHintSm90
// names): data read once goes first, operands read by many blocks last.
// ---------------------------------------------------------------------------

constexpr uint64_t L2_EVICT_FIRST = 0x12F0000000000000ull;
constexpr uint64_t L2_EVICT_LAST = 0x14F0000000000000ull;

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Make initialised mbarriers visible to the async proxy; a barrier after
// it covers the other threads.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive and add `bytes` to the transaction count the current phase waits
// for (the TMA loads then count them down).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0, so waiting on parity 1 passes at once). A wait that lasts
// about 10 s (2e10 cycles) traps, so a lost arrival fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  long long start = -1;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (start < 0) start = clock64();
    else if (clock64() - start > 20000000000LL) __trap();
  }
}

// Box (x = column, y = row) of tensor map `map` into shared memory at
// `dst`, counted on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map,
                                            uint64_t* bar, int x, int y,
                                            uint64_t l2_policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          smem_addr(dst)),
      "l"(map), "r"(smem_addr(bar)), "r"(x), "r"(y), "l"(l2_policy)
      : "memory");
}

// Shared memory at `src` to box (x, y) of tensor map `map`.
__device__ __forceinline__ void tma_store_2d(const void* map,
                                             const void* src, int x, int y,
                                             uint64_t l2_policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3}], [%1], %4;\n" ::"l"(map),
      "r"(smem_addr(src)), "r"(x), "r"(y), "l"(l2_policy)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read shared
// memory (READ) or are still in flight at all.
template <int N, bool READ>
__device__ __forceinline__ void bulk_wait() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tc
