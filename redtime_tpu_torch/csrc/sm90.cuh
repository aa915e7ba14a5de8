// Hopper (sm_90a) building blocks of K7 oz_fused (oz_fused.cu): mbarriers,
// bulk copies (the TMA engine without a tensor map), release / acquire
// progress counters, and wgmma on int8 operands.
//
// wgmma operand tiles: 8-bit wgmma takes A [64, 32] and B [N, 32] both
// K-major from shared memory, here without swizzle: a core matrix is 8
// rows of 16 contiguous bytes (128 bytes); the two 16-byte halves of a
// row's 32 K lie 128 bytes apart (the descriptor's leading-dimension
// offset) and groups of 8 rows 256 bytes apart (its stride offset), so a
// tile of R rows is R * 32 contiguous bytes:
//   byte (row, k) = (row / 8) * 256 + (k / 16) * 128 + (row % 8) * 16 + k % 16.
// The accumulator of m64nNk32 (N / 2 int32 a thread): with warp w of the
// warpgroup and lane = 4 g + q, d[4 j + e] = D[16 w + g + 8 (e / 2)]
// [8 j + 2 q + e % 2].
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace sm90 {

// the tile offsets above, shared by the operand writers and the descriptors
constexpr uint32_t LBO = 128, SBO = 256;

__host__ __device__ constexpr int tile_byte(int row, int k) {
  return (row / 8) * 256 + (k / 16) * 128 + (row % 8) * 16 + k % 16;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_bar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrive and expect `bytes` more from bulk copies in this phase
__device__ __forceinline__ void bar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          saddr(b)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(b))
               : "memory");
}
// A spin that lasts more than 2^35 cycles (17 s at 1.98 GHz) traps, so a
// fault in a wait protocol ends the launch with an error instead of
// holding the card.
__device__ __forceinline__ void watchdog(long long t0) {
  if (clock64() - t0 > (1LL << 35)) __trap();
}

// wait for the phase of parity `parity` to complete; the waiting threads
// are suspended in try_wait (a hint of up to 1 ms) rather than spinning,
// so they leave the issue slots to the warps that work
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, 1000000;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(b)), "r"(parity)
        : "memory");
    if (done) return;
    watchdog(t0);
  }
}

// Progress counters between CTAs, in global memory: a release store at
// GPU scope publishes this thread's earlier writes (and those it has
// acquired); an acquire load sees them.  Inside a CTA the same pair at CTA
// scope, on shared memory.
__device__ __forceinline__ void st_release_gpu(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ void st_relaxed_gpu(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ uint32_t ld_acquire_gpu(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release_cta(uint32_t* p, uint32_t v) {
  asm volatile("st.release.cta.shared::cta.u32 [%0], %1;\n" ::"r"(saddr(p)),
               "r"(v)
               : "memory");
}
__device__ __forceinline__ uint32_t ld_acquire_cta(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.cta.shared::cta.u32 %0, [%1];\n"
               : "=r"(v)
               : "r"(saddr(p))
               : "memory");
  return v;
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to this CTA's shared memory by the TMA engine; completes on barrier b
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(saddr(dst)),
      "l"(src), "r"(bytes), "r"(saddr(b))
      : "memory");
}

// this thread's generic-proxy writes to global memory become visible to
// the async proxy (bulk copies) that a later synchronisation orders
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
__device__ __forceinline__ void fence_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// named barrier `id` over `count` threads (a multiple of 32)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// the wgmma descriptor of a tile at `p` in the layout above
__device__ __forceinline__ uint64_t desc(const void* p) {
  return static_cast<uint64_t>((saddr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(LBO >> 4) << 16) |
         (static_cast<uint64_t>(SBO >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += A B^T for one warpgroup: A 64 x 32 and B 64 x 32 int8, both
// K-major in shared memory (descriptors da, db); int32 sums, 32 a thread
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db));
}

}  // namespace sm90
