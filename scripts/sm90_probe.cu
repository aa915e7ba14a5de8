// Measurements on the card behind K7 oz_fused's design (csrc/oz_fused.cu),
// built and run by scripts/sm90_probe.py:
//  1. the operand layout of 8-bit wgmma (m64n64k32, both operands K-major
//     in shared memory without swizzle): which descriptor offsets give
//     A B^T, with the K halves 128 bytes apart and 8-row groups 256 apart
//     or the other way round;
//  2. distributed shared memory: a cluster of four CTAs, each sending
//     16 KB to each peer a round by bulk copy, on 132 SMs;
//  3. bulk copies from L2 into shared memory: each CTA streams the same
//     1 MB in 16 KB copies, four in flight;
//  4. how many clusters of four CTAs of K7's size (213,160 bytes of
//     shared memory, 480 threads) the card holds at once;
//  5. K7's stage copies alone: 128 CTAs, each copying per K-step a 12 KB
//     slice tile (shared by the four CTAs of a tile) and an 8 KB W tile
//     through four stages, 32 K-steps; then the same with pairs of CTAs
//     (clusters of two) multicasting the slice tile;
//  6. K7's slice-ring writes alone: 128 CTAs of 128 threads, each thread
//     storing 16 bytes six times a K-step (a warp a 512-byte block), 32
//     K-steps into 16 slots of 12 KB a tile (12.6 MB in all); then the
//     same bytes as bulk stores from shared memory, a CTA's 3 KB of a
//     K-step in one, one thread issuing them.
#include <cstdint>
#include <cstdio>
#include <vector>

#include "../redtime_tpu_torch/csrc/sm90.cuh"

using sm90::saddr;

#define CK(x)                                                       \
  do {                                                              \
    cudaError_t e = (x);                                            \
    if (e) {                                                        \
      printf("error %s at %s:%d\n", cudaGetErrorString(e), __FILE__, \
             __LINE__);                                             \
      return 1;                                                     \
    }                                                               \
  } while (0)

__device__ __forceinline__ uint32_t cl_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cl_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t r) {
  uint32_t o;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(o)
               : "r"(a), "r"(r));
  return o;
}
__device__ __forceinline__ void arrive_peer(uint32_t a) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
               ::"r"(a) : "memory");
}
__device__ __forceinline__ bool try_cl(uint64_t* b, uint32_t ph) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster."
      "shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok) : "r"(saddr(b)), "r"(ph) : "memory");
  return ok;
}

// 1 ---------------------------------------------------------------------
__global__ void wg_layout(const int8_t* A, const int8_t* B, int* D,
                          uint32_t lbo, uint32_t sbo) {
  __shared__ __align__(128) int8_t sA[64 * 32], sB[64 * 32];
  const int t = threadIdx.x;
  for (int i = t; i < 64 * 32; i += 128) {
    sA[sm90::tile_byte(i / 32, i % 32)] = A[i];
    sB[sm90::tile_byte(i / 32, i % 32)] = B[i];
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  auto desc = [](const void* p, uint32_t l, uint32_t s) {
    return (uint64_t)((saddr(p) & 0x3FFFF) >> 4) | ((uint64_t)(l >> 4) << 16) |
           ((uint64_t)(s >> 4) << 32);
  };
  int d[32] = {};
  sm90::wg_fence();
  sm90::wgmma_s8_n64(d, desc(sA, lbo, sbo), desc(sB, lbo, sbo));
  sm90::wg_commit();
  sm90::wg_wait<0>();
  const int w = t / 32, g = t % 32 / 4, q = t % 4;
  for (int v = 0; v < 32; ++v)
    D[(16 * w + g + 8 * (v % 4 / 2)) * 64 + 8 * (v / 4) + 2 * q + v % 2] = d[v];
}

// 2 ---------------------------------------------------------------------
__global__ void __cluster_dims__(4, 1, 1) dsmem_rate(int rounds, int bytes) {
  extern __shared__ __align__(128) uint8_t sm[];
  __shared__ uint64_t bar;
  const uint32_t me = cl_rank();
  uint8_t* recv = sm + bytes;
  if (threadIdx.x == 0) {
    sm90::bar_init(&bar, 1);
    sm90::fence_bar_init();
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  cl_sync();
  for (int it = 0; it < rounds; ++it) {
    if (threadIdx.x == 0) {
      sm90::bar_expect(&bar, 3 * bytes);
      for (int p = 1; p < 4; ++p) {
        const uint32_t q = (me + p) % 4;
        asm volatile(
            "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx"
            "::bytes [%0], [%1], %2, [%3];" ::"r"(
                mapa(saddr(recv + me * bytes), q)),
            "r"(saddr(sm)), "r"(bytes), "r"(mapa(saddr(&bar), q))
            : "memory");
      }
    }
    while (!try_cl(&bar, it & 1)) {
    }
    cl_sync();
  }
}

// 3 ---------------------------------------------------------------------
__global__ void l2_rate(const uint8_t* src, int bytes, int chunk, int reps) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t bars[4];
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) sm90::bar_init(&bars[i], 1);
    sm90::fence_bar_init();
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int n = bytes / chunk * reps;
  for (int i = 0; i < n + 4; ++i) {
    const int s = i % 4;
    if (i >= 4) sm90::bar_wait(&bars[s], (i / 4 - 1) & 1);
    if (i >= n) continue;
    sm90::bar_expect(&bars[s], chunk);
    sm90::bulk_load(ring + s * chunk,
                    src + (size_t)(i % (bytes / chunk)) * chunk, chunk,
                    &bars[s]);
  }
}

// 4 ---------------------------------------------------------------------
__global__ void k7_sized() {}

// 5 ---------------------------------------------------------------------
constexpr int S = 4, A_B = 12288, W_B = 8192, ST = A_B + W_B, KT = 32;
template <int MC>
__global__ void stage_copies(const uint8_t* slices, const uint8_t* wp,
                             int* out) {
  extern __shared__ __align__(1024) uint8_t sm[];
  __shared__ uint64_t full[S], empty[S];
  const int tile = blockIdx.x / 4, rank = blockIdx.x % 4;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::bar_init(&full[s], 1);
      sm90::bar_init(&empty[s], MC ? 2 : 1);
    }
    sm90::fence_bar_init();
  }
  __syncthreads();
  if (MC) cl_sync();
  const uint32_t me = MC ? cl_rank() : 0;
  if (threadIdx.x == 0) {
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % S;
      if (kt >= S) sm90::bar_wait(&empty[s], (kt / S - 1) & 1);
      sm90::bar_expect(&full[s], ST);
      const uint8_t* a = slices + ((size_t)tile * 16 + kt % 16) * A_B;
      if (!MC) {
        sm90::bulk_load(sm + s * ST, a, A_B, &full[s]);
      } else if (me == 0) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(
                saddr(sm + s * ST)),
            "l"(a), "r"(A_B), "r"(saddr(&full[s])), "h"((uint16_t)3)
            : "memory");
      }
      sm90::bulk_load(sm + s * ST + A_B, wp + ((size_t)rank * KT + kt) * W_B,
                      W_B, &full[s]);
    }
  } else if (threadIdx.x == 32) {
    int acc = 0;
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % S;
      sm90::bar_wait(&full[s], (kt / S) & 1);
      acc += sm[s * ST + 5];
      if (MC) {  // both stages free before rank 0 multicasts into them
        arrive_peer(mapa(saddr(&empty[s]), 0));
        if (me == 0) arrive_peer(mapa(saddr(&empty[s]), 1));
        else sm90::bar_arrive(&empty[s]);
      } else {
        sm90::bar_arrive(&empty[s]);
      }
    }
    out[blockIdx.x] = acc;
  }
  __syncthreads();
  if (MC) cl_sync();
}

// 6 ---------------------------------------------------------------------
__global__ void ring_writes(uint8_t* ring) {
  const int tile = blockIdx.x / 4, rank = blockIdx.x % 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = 0; j < KT; j += 4) {
    const int kt = j + warp;
    uint8_t* dst = ring + ((size_t)tile * 16 + kt % 16) * A_B +
                   sm90::tile_byte(16 * rank + lane / 2, 16 * (lane % 2));
#pragma unroll
    for (int i = 0; i < 6; ++i)
      *reinterpret_cast<uint4*>(dst + i * 2048) =
          make_uint4(kt, i, lane, rank);
    __syncthreads();
  }
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
      "r"(saddr(src)), "r"(bytes)
      : "memory");
}

__global__ void ring_bulk_writes(uint8_t* ring) {
  __shared__ __align__(128) uint8_t stage[3072];
  const int tile = blockIdx.x / 4, rank = blockIdx.x % 4;
  for (int i = threadIdx.x; i < 3072; i += blockDim.x) stage[i] = i;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int kt = 0; kt < KT; ++kt)
    bulk_store(ring + ((size_t)tile * 16 + kt % 16) * A_B + rank * 3072,
               stage, 3072);
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

int main() {
  cudaDeviceProp pr;
  CK(cudaGetDeviceProperties(&pr, 0));
  const int sms = pr.multiProcessorCount;
  printf("device: %s, %d SMs\n", pr.name, sms);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  auto ms = [&] { float m; cudaEventElapsedTime(&m, e0, e1); return m; };

  // 1
  std::vector<int8_t> A(64 * 32), B(64 * 32);
  for (int i = 0; i < 64 * 32; ++i) {
    A[i] = (int8_t)((i * 37 + 11) % 251 - 125);
    B[i] = (int8_t)((i * 53 + 7) % 241 - 120);
  }
  int8_t *dA, *dB;
  int* dD;
  CK(cudaMalloc(&dA, 2048));
  CK(cudaMalloc(&dB, 2048));
  CK(cudaMalloc(&dD, 64 * 64 * 4));
  CK(cudaMemcpy(dA, A.data(), 2048, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(dB, B.data(), 2048, cudaMemcpyHostToDevice));
  for (int swap = 0; swap < 2; ++swap) {
    const uint32_t lbo = swap ? 256 : 128, sbo = swap ? 128 : 256;
    wg_layout<<<1, 128>>>(dA, dB, dD, lbo, sbo);
    CK(cudaDeviceSynchronize());
    std::vector<int> D(64 * 64);
    CK(cudaMemcpy(D.data(), dD, D.size() * 4, cudaMemcpyDeviceToHost));
    int bad = 0;
    for (int m = 0; m < 64; ++m)
      for (int n = 0; n < 64; ++n) {
        int s = 0;
        for (int k = 0; k < 32; ++k) s += A[m * 32 + k] * B[n * 32 + k];
        bad += s != D[m * 64 + n];
      }
    printf("wgmma m64n64k32 s8, K halves %u bytes apart, 8-row groups %u "
           "apart: %d of 4096 outputs wrong\n", lbo, sbo, bad);
  }

  // 2
  const int grid4 = sms / 4 * 4, bytes = 16384, rounds = 200;
  CK(cudaFuncSetAttribute(dsmem_rate,
                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                          5 * bytes));
  dsmem_rate<<<grid4, 128, 5 * bytes>>>(2, bytes);
  CK(cudaDeviceSynchronize());
  cudaEventRecord(e0);
  dsmem_rate<<<grid4, 128, 5 * bytes>>>(rounds, bytes);
  cudaEventRecord(e1);
  CK(cudaEventSynchronize(e1));
  double tot = (double)grid4 * rounds * 3 * bytes;
  printf("distributed shared memory, bulk copies of %d bytes to each of "
         "three peers: %.2f TB/s in all, %.1f GB/s an SM\n", bytes,
         tot / (ms() * 1e-3) / 1e12, tot / (ms() * 1e-3) / grid4 / 1e9);

  // 3
  uint8_t* src;
  CK(cudaMalloc(&src, 1 << 20));
  CK(cudaMemset(src, 1, 1 << 20));
  const int chunk = 16384;
  CK(cudaFuncSetAttribute(l2_rate, cudaFuncAttributeMaxDynamicSharedMemorySize,
                          4 * chunk));
  l2_rate<<<sms, 32, 4 * chunk>>>(src, 1 << 20, chunk, 1);
  CK(cudaDeviceSynchronize());
  cudaEventRecord(e0);
  l2_rate<<<sms, 32, 4 * chunk>>>(src, 1 << 20, chunk, 4);
  cudaEventRecord(e1);
  CK(cudaEventSynchronize(e1));
  tot = (double)sms * 4 * (1 << 20);
  printf("bulk copies of %d bytes from L2 into shared memory, four in "
         "flight: %.2f TB/s in all, %.1f GB/s an SM\n", chunk,
         tot / (ms() * 1e-3) / 1e12, tot / (ms() * 1e-3) / sms / 1e9);

  // 4
  const int k7_smem = 213160, k7_threads = 480;
  CK(cudaFuncSetAttribute(k7_sized, cudaFuncAttributeMaxDynamicSharedMemorySize,
                          k7_smem));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(128);
  cfg.blockDim = dim3(k7_threads);
  cfg.dynamicSmemBytes = k7_smem;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 4;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int clusters = 0;
  CK(cudaOccupancyMaxActiveClusters(&clusters, k7_sized, &cfg));
  printf("clusters of four CTAs of %d bytes of shared memory and %d threads "
         "resident at once: %d\n", k7_smem, k7_threads, clusters);

  // 5
  uint8_t *sl, *wp;
  int* out;
  CK(cudaMalloc(&sl, (size_t)32 * 16 * A_B));
  CK(cudaMalloc(&wp, (size_t)4 * KT * W_B));
  CK(cudaMalloc(&out, 4096));
  CK(cudaMemset(sl, 1, (size_t)32 * 16 * A_B));
  CK(cudaMemset(wp, 2, (size_t)4 * KT * W_B));
  for (int mc = 0; mc < 2; ++mc) {
    cudaLaunchConfig_t c2 = {};
    c2.gridDim = dim3(128);
    c2.blockDim = dim3(64);
    c2.dynamicSmemBytes = S * ST;
    int na = 0;
    if (mc) {
      at[na].id = cudaLaunchAttributeClusterDimension;
      at[na].val.clusterDim.x = 2;
      at[na].val.clusterDim.y = 1;
      at[na].val.clusterDim.z = 1;
      ++na;
    }
    at[na].id = cudaLaunchAttributeCooperative;
    at[na].val.cooperative = 1;
    ++na;
    c2.attrs = at;
    c2.numAttrs = na;
    auto k = mc ? stage_copies<1> : stage_copies<0>;
    CK(cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            S * ST));
    CK(cudaLaunchKernelEx(&c2, k, (const uint8_t*)sl, (const uint8_t*)wp, out));
    CK(cudaDeviceSynchronize());
    float best = 1e9f;
    for (int r = 0; r < 10; ++r) {
      cudaEventRecord(e0);
      cudaLaunchKernelEx(&c2, k, (const uint8_t*)sl, (const uint8_t*)wp, out);
      cudaEventRecord(e1);
      CK(cudaEventSynchronize(e1));
      best = ms() < best ? ms() : best;
    }
    printf("K7's stage copies alone (%s): %.4f ms for 32 K-steps of 20 KB on "
           "128 CTAs, %.2f TB/s into shared memory\n",
           mc ? "clusters of two, slice tiles multicast" : "each CTA its own",
           best, 128.0 * KT * ST / (best * 1e-3) / 1e12);
  }

  // 6
  uint8_t* ring;
  CK(cudaMalloc(&ring, (size_t)32 * 16 * A_B));
  ring_writes<<<128, 128>>>(ring);
  CK(cudaDeviceSynchronize());
  float best6 = 1e9f;
  for (int r = 0; r < 10; ++r) {
    cudaEventRecord(e0);
    ring_writes<<<128, 128>>>(ring);
    cudaEventRecord(e1);
    CK(cudaEventSynchronize(e1));
    best6 = ms() < best6 ? ms() : best6;
  }
  const double wbytes = 128.0 * KT * 6 * 128 * 16 / 4;
  printf("K7's slice-ring writes alone: %.4f ms for %.1f MB, %.2f TB/s\n",
         best6, wbytes / 1e6, wbytes / (best6 * 1e-3) / 1e12);
  ring_bulk_writes<<<128, 128>>>(ring);
  CK(cudaDeviceSynchronize());
  best6 = 1e9f;
  for (int r = 0; r < 10; ++r) {
    cudaEventRecord(e0);
    ring_bulk_writes<<<128, 128>>>(ring);
    cudaEventRecord(e1);
    CK(cudaEventSynchronize(e1));
    best6 = ms() < best6 ? ms() : best6;
  }
  printf("the same as bulk stores of 3 KB: %.4f ms, %.2f TB/s\n", best6,
         wbytes / (best6 * 1e-3) / 1e12);
  return 0;
}
