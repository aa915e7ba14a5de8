// The FP64 tensor-core main loop of the engine's hand kernels (out_leg.cu,
// pz_leg.cu).
//
// Both kernels contract a long K against small M and N, so each output
// tile is split over K between the blocks of one thread-block cluster.  A
// block streams its K-slice through a ring of shared-memory stages filled
// by 16-byte cp.async (the next slices load while the current one
// computes) and multiplies on the FP64 tensor cores with mma.sync
// m16n8k{8,16} (Hopper's wgmma has no f64 form).  The partial tiles are
// then summed through distributed shared memory in rank order, so the
// same inputs give the same bits on every run: no atomics.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace rt {

namespace cg = cooperative_groups;

// 16 bytes global -> shared, asynchronously; zero-fills when !valid (the
// source is then not read, but must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += A B for one warp on the FP64 tensor cores, A 16 x KK (row), B KK x 8
// (col).  With lane = 4 g + t, slot i of the fragments holds contraction
// index k = t + 4 i: a[2i] = A[g][k], a[2i+1] = A[g+8][k], b[i] = B[k][g];
// d[0], d[1] = D[g][2t], D[g][2t+1]; d[2], d[3] = D[g+8][2t], D[g+8][2t+1].
// (Any k order serves, as long as A and B share it.)
template <int KK>
struct Dmma;

template <>
struct Dmma<8> {
  static __device__ __forceinline__ void run(double (&d)[4],
                                             const double (&a)[4],
                                             const double (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  }
};

template <>
struct Dmma<16> {
  static __device__ __forceinline__ void run(double (&d)[4],
                                             const double (&a)[8],
                                             const double (&b)[4]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
          "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
};

// A peer block's shared memory may be written only once the peer has
// started.  Every thread of every block of the cluster arrives when its
// kernel starts and waits before its first remote store; the relaxed
// arrive orders no memory, which the start needs none of.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The ring: load(slot, kt) issues the cp.async copies of K-step kt into
// ring slot `slot`; compute(slot) consumes one slot.  Ends with every copy
// landed and the block synchronized, so the caller may reuse the ring.
template <int STAGES, class Load, class Compute>
__device__ __forceinline__ void pipeline(int KT, const Load& load,
                                         const Compute& compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // step kt has landed (for this thread)
    __syncthreads();              // ... for every thread; slot kt-1 is free
    const int next = kt + STAGES - 1;
    if (next < KT) load(next % STAGES, next);
    cp_async_commit();
    compute(kt % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace rt
