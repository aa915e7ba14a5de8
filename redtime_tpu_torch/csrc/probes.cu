// K4 affine, K5 int8_dot, K6 dd_mul: the Pallas feasibility probes of
// scripts/probe_pallas.py, ported to Hopper.
//
// K4 affine replaces probe1.kernel (scripts/probe_pallas.py:29-38),
//   o = 2x + 1 on f32.  Bound on the card: device memory, 8 bytes moved per
//   element and 2 flops; at the probe's [8, 128] tile the launch itself
//   (rt_launch_floor below times an empty kernel).  Each thread moves one
//   float4 (a 16-byte ld.global.nc and st.global) in a grid-stride loop
//   on a grid of at most a few waves, and the last n % 4 elements go one
//   by one; so does every element of a tensor that starts off a 16-byte
//   boundary (a view: the output, newly allocated, never does).  x*2 is
//   exact, so FMA contraction cannot change the result and the kernel
//   rounds as the plain version does.
//
// K5 int8_dot replaces probe2.kernel (scripts/probe_pallas.py:44-57), the
//   TPU's int8 MXU dot with int32 accumulation: out[M,N] = a[M,K] b[K,N].
//   Bound on the card: at the probe's 128x512x256 the work (17 MOP, 0.2 MB)
//   is far too small for 132 SMs, so launch and latency bound; at
//   2016x1024x256 bytes (2.8 MB) and int8 operations take about as long.
//   The products run on the int8 tensor cores (mma.sync m16n8k32 s8,
//   imma_tile.cuh) over a ring of four cp.async slots of K-steps of 64
//   (two steps in flight), with B packed along K by the convert step.  Small outputs would leave most SMs idle, so
//   the tile and a split of K follow the shape (rt_int8_dot): 64 x 64
//   tiles when they make at least half a wave (2016 x 256: 128 blocks),
//   otherwise 32 x 32 tiles with K split over 2, 4 or 8 blocks of a
//   cluster, as long as the blocks stay within one wave and each keeps two
//   K-steps (128 x 512 x 256: 32 tiles x 4 = 128 blocks).  The split's
//   partial tiles are summed through distributed shared memory in rank
//   order; int32 sums are exact in any order, so the result is the exact
//   product.  Ragged M, N and K are zero-filled in the loaders.
//
// K6 dd_mul replaces probe3.kernel (scripts/probe_pallas.py:78-99), the
//   double-double product (hi, lo) x (hi, lo) -> (hi, lo) of
//   redtime_tpu/dd.py mul: Dekker's two_prod, the cross terms, and a
//   fast_two_sum.  Bound on the card: device memory, 24 bytes moved per
//   element for ~30 flops.  Dekker's transform needs every product and
//   sum rounded on its own, and nvcc contracts a*b - p into an FMA by
//   default, which changes lo; every operation is therefore written with
//   the __fmul_rn / __fadd_rn / __fsub_rn intrinsics, which are never
//   contracted, and the kernel equals the plain dd.mul bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

#include "dmma_tile.cuh"
#include "imma_tile.cuh"

namespace {

constexpr int EW_THREADS = 256;

// The first nvec float4 as vectors (x and out 16-byte aligned when
// nvec > 0), the other n - 4 nvec elements one by one.
__global__ void affine_kernel(const float* __restrict__ x,
                              float* __restrict__ out, long long n,
                              long long nvec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float4* xv = reinterpret_cast<const float4*>(x);
  float4* ov = reinterpret_cast<float4*>(out);
  for (long long i = first; i < nvec; i += stride) {
    float4 v = __ldg(xv + i);
    v.x = v.x * 2.0f + 1.0f;
    v.y = v.y * 2.0f + 1.0f;
    v.z = v.z * 2.0f + 1.0f;
    v.w = v.w * 2.0f + 1.0f;
    ov[i] = v;
  }
  for (long long i = 4 * nvec + first; i < n; i += stride)
    out[i] = x[i] * 2.0f + 1.0f;
}

__global__ void empty_kernel() {}

// K5: 4 warps in 2 x 2 over a BM x BN tile, K-steps of 64 bytes, a ring
// of four raw slots
constexpr int DOT_THREADS = 128, DBK = 64, DBKW = DBK / 4, DOT_STAGES = 4;

template <int BM, int BN>
struct DotTile {
  static constexpr int LDA = rt::APitch<DBKW>::value;
  static constexpr int LDB = rt::BPitch<BN>::value;
  // raw slot: A [BM][LDA words] (the mma reads it there), B [DBK][BN]
  // bytes; operand slot: B packed along K
  static constexpr int A_BYTES = BM * LDA * 4, RAW_BYTES = A_BYTES + DBK * BN;
  static constexpr int OP_WORDS = DBKW * LDB;
  static constexpr int SMEM_BYTES =
      DOT_STAGES * RAW_BYTES + 2 * OP_WORDS * 4 + BM * BN * 4;
};

template <int BM, int BN>
__global__ void __launch_bounds__(DOT_THREADS)
    int8_dot_kernel(const int8_t* __restrict__ a,
                    const int8_t* __restrict__ b, int32_t* __restrict__ out,
                    int M, int N, int K, int k_chunk, bool a_vec,
                    bool b_vec) {
  using T = DotTile<BM, BN>;
  constexpr int LDA = T::LDA, LDB = T::LDB;
  constexpr int WM = BM / 2, WN = BN / 2, MA = WM / 16, NA = WN / 8;
  // 16-byte chunks of A and of raw B, 4 x 4 blocks of B, a thread
  constexpr int A_PER = BM * (DBK / 16) / DOT_THREADS;
  constexpr int B_PER = DBK * (BN / 16) / DOT_THREADS;
  constexpr int P_PER = DBKW * (BN / 4) / DOT_THREADS;
  static_assert(A_PER >= 1 && B_PER >= 1 && P_PER >= 1 && MA >= 1 &&
                    NA >= 1, "tile");
  static_assert(BM % 8 == 0, "each of up to eight ranks owns tile rows");
  extern __shared__ __align__(16) unsigned char dot_smem[];
  unsigned* op = reinterpret_cast<unsigned*>(dot_smem + DOT_STAGES *
                                                            T::RAW_BYTES);
  int* recv = reinterpret_cast<int*>(op + 2 * T::OP_WORDS);
  // the cluster spans the grid's z: `ksplit` K-chunks of one output tile
  const int ksplit = gridDim.z, rank = blockIdx.z;
  // peers may push into recv once every block of the cluster has arrived
  if (ksplit > 1) rt::cluster_arrive_relaxed();
  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4,
            t = tid % 4;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = rank * k_chunk, ke = min(K, kb + k_chunk);
  const int KT = ke > kb ? (ke - kb + DBK - 1) / DBK : 0;

  int acc[MA][NA][4];
#pragma unroll
  for (int i = 0; i < MA; ++i)
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  auto load = [&](int raw, int kt) {
    unsigned char* slot = dot_smem + raw * T::RAW_BYTES;
    const int k0 = kb + kt * DBK;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int idx = tid + i * DOT_THREADS, r = idx / 4, c = idx % 4;
      const int m = m0 + r, k = k0 + 16 * c;
      unsigned* dst = reinterpret_cast<unsigned*>(slot) + r * LDA + 4 * c;
      if (a_vec) {
        // K % 16 == 0: a chunk lies wholly inside [kb, ke) or past it
        const bool in = m < M && k < ke;
        rt::cp_async16(dst, in ? a + (size_t)m * K + k : a, in);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          unsigned v = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kk = k + 4 * q + j;
            if (m < M && kk < ke)
              v |= (unsigned)(uint8_t)a[(size_t)m * K + kk] << (8 * j);
          }
          dst[q] = v;
        }
      }
    }
    int8_t* braw = reinterpret_cast<int8_t*>(slot + T::A_BYTES);
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int idx = tid + i * DOT_THREADS;
      const int kr = idx / (BN / 16), c = idx % (BN / 16);
      const int k = k0 + kr, n = n0 + 16 * c;
      int8_t* dst = braw + kr * BN + 16 * c;
      if (b_vec) {
        // N % 16 == 0: a chunk lies wholly inside [0, N) or past it
        const bool in = k < ke && n < N;
        rt::cp_async16(dst, in ? b + (size_t)k * N + n : b, in);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          dst[j] = k < ke && n + j < N ? b[(size_t)k * N + n + j] : 0;
      }
    }
  };
  auto convert = [&](int raw, int o) {
    const unsigned* bw =
        reinterpret_cast<const unsigned*>(dot_smem + raw * T::RAW_BYTES +
                                          T::A_BYTES);
#pragma unroll
    for (int i = 0; i < P_PER; ++i) {
      const int idx = tid + i * DOT_THREADS;
      const int kq = idx / (BN / 4), nb = idx % (BN / 4);
      unsigned w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = bw[(4 * kq + j) * (BN / 4) + nb];
      rt::pack_k(w);
      rt::store_b4x4<LDB>(op + o * T::OP_WORDS, kq, 4 * nb, w);
    }
  };
  auto compute = [&](int raw, int o) {
    const unsigned* As =
        reinterpret_cast<const unsigned*>(dot_smem + raw * T::RAW_BYTES);
    const unsigned* Bs = op + o * T::OP_WORDS;
#pragma unroll
    for (int kw = 0; kw < DBKW; kw += 8) {
      unsigned af[MA][4], bf[NA][2];
#pragma unroll
      for (int i = 0; i < MA; ++i)
        rt::load_a<LDA>(af[i], As, wm * WM + 16 * i, kw, g, t);
#pragma unroll
      for (int j = 0; j < NA; ++j)
        rt::load_b<LDB>(bf[j], Bs, kw, wn * WN + 8 * j, g, t);
#pragma unroll
      for (int i = 0; i < MA; ++i)
#pragma unroll
        for (int j = 0; j < NA; ++j) rt::imma(acc[i][j], af[i], bf[j]);
    }
  };
  rt::ring<DOT_STAGES>(KT, load, [] {}, convert, compute);

  if (ksplit == 1) {
#pragma unroll
    for (int i = 0; i < MA; ++i)
#pragma unroll
      for (int j = 0; j < NA; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm * WM + 16 * i + g + 8 * h;
          const int n = n0 + wn * WN + 8 * j + 2 * t;
          if (m < M && n < N) out[(size_t)m * N + n] = acc[i][j][2 * h];
          if (m < M && n + 1 < N)
            out[(size_t)m * N + n + 1] = acc[i][j][2 * h + 1];
        }
    return;
  }
  // the cluster's sum: rank q owns rows [q rpr, (q+1) rpr) of the tile.
  // Each block pushes its partial rows into their owner's recv, slot
  // [rank], once every block has started; after the barrier each owner
  // adds its slots in rank order.  Remote stores only.
  const int rpr = BM / ksplit;
  rt::cg::cluster_group cluster = rt::cg::this_cluster();
  rt::cluster_wait();
#pragma unroll
  for (int i = 0; i < MA; ++i)
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * WM + 16 * i + g + 8 * h;
        int* dst = cluster.map_shared_rank(recv, r / rpr) +
                   (rank * rpr + r % rpr) * BN + wn * WN + 8 * j + 2 * t;
        *reinterpret_cast<int2*>(dst) =
            make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  cluster.sync();
  for (int idx = tid; idx < rpr * BN; idx += DOT_THREADS) {
    const int rr = idx / BN, c = idx % BN;
    const int m = m0 + rank * rpr + rr, n = n0 + c;
    if (m >= M || n >= N) continue;
    int s = 0;
    for (int q = 0; q < ksplit; ++q) s += recv[(q * rpr + rr) * BN + c];
    out[(size_t)m * N + n] = s;
  }
}

template <int BM, int BN>
int launch_int8_dot(const int8_t* a, const int8_t* b, int32_t* out, int M,
                    int N, int K, int split, cudaStream_t stream) {
  constexpr int SMEM = DotTile<BM, BN>::SMEM_BYTES;
  static bool smem_set[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !smem_set[dev]) {
    cudaFuncSetAttribute(int8_dot_kernel<BM, BN>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    smem_set[dev] = true;
  }
  const int steps = (K + DBK - 1) / DBK;
  const int k_chunk = (steps + split - 1) / split * DBK;
  const bool a_vec =
      K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool b_vec =
      N % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, (M + BM - 1) / BM, split);
  cfg.blockDim = dim3(DOT_THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, int8_dot_kernel<BM, BN>, a, b, out, M, N, K,
                         k_chunk, a_vec, b_vec);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Dekker's split of an f32 at 2^12 + 1, every operation rounded alone.
__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float aa = __fmul_rn(a, 4097.0f);
  hi = __fsub_rn(aa, __fsub_rn(aa, a));
  lo = __fsub_rn(a, hi);
}

__global__ void dd_mul_kernel(const float* __restrict__ ah,
                              const float* __restrict__ al,
                              const float* __restrict__ bh,
                              const float* __restrict__ bl,
                              float* __restrict__ oh, float* __restrict__ ol,
                              long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float a = ah[i], b = bh[i];
    // two_prod(a, b): p + e = a * b exactly
    const float p = __fmul_rn(a, b);
    float ahi, alo, bhi, blo;
    split(a, ahi, alo);
    split(b, bhi, blo);
    float e = __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ahi, bhi), p),
                                  __fmul_rn(ahi, blo)),
                        __fmul_rn(alo, bhi));
    e = __fadd_rn(e, __fmul_rn(alo, blo));
    // the cross terms: e + (ah * bl + al * bh)
    e = __fadd_rn(e, __fadd_rn(__fmul_rn(a, bl[i]), __fmul_rn(al[i], b)));
    // fast_two_sum(p, e)
    const float s = __fadd_rn(p, e);
    oh[i] = s;
    ol[i] = __fsub_rn(e, __fsub_rn(s, p));
  }
}

int ew_blocks(long long n) {
  const long long blocks = (n + EW_THREADS - 1) / EW_THREADS;
  return (int)(blocks < 132 * 32 ? (blocks > 0 ? blocks : 1) : 132 * 32);
}

}  // namespace

// x, out: n contiguous f32 on the current device.
extern "C" int rt_affine(const float* x, float* out, long long n,
                         void* stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const long long nvec = aligned ? n / 4 : 0;
  const long long alone = n - 4 * nvec;
  affine_kernel<<<ew_blocks(nvec > alone ? nvec : alone), EW_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, out, n, nvec);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on one warp: what a launch costs on the card when the
// kernel does nothing (the floor under K4's and K6's probe shapes).
extern "C" int rt_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// The tile and the split of K for an M x N x K product: 64 x 64 tiles
// unsplit when they make half a wave of the 132 SMs; otherwise 32 x 32
// tiles, K split in two while the blocks stay within one wave and each
// keeps two K-steps.  Writes {tile, split}.
extern "C" void rt_int8_dot_plan(int M, int N, int K, int* plan) {
  const long long t64 = (long long)((M + 63) / 64) * ((N + 63) / 64);
  if (t64 >= 66) {
    plan[0] = 64;
    plan[1] = 1;
    return;
  }
  const long long t32 = (long long)((M + 31) / 32) * ((N + 31) / 32);
  const int steps = (K + DBK - 1) / DBK;
  int split = 1;
  while (split < 8 && t32 * split * 2 <= 132 && steps >= 4 * split)
    split *= 2;
  plan[0] = 32;
  plan[1] = split;
}

// a [M, K], b [K, N] int8 and out [M, N] int32, contiguous, on the current
// device; the caller guarantees K * 2^14 < 2^31 (no int32 overflow).
extern "C" int rt_int8_dot(const int8_t* a, const int8_t* b, int32_t* out,
                           int M, int N, int K, void* stream) {
  int plan[2];
  rt_int8_dot_plan(M, N, K, plan);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan[0] == 64)
    return launch_int8_dot<64, 64>(a, b, out, M, N, K, plan[1], st);
  return launch_int8_dot<32, 32>(a, b, out, M, N, K, plan[1], st);
}

// ah, al, bh, bl, oh, ol: n contiguous f32 each on the current device.
extern "C" int rt_dd_mul(const float* ah, const float* al, const float* bh,
                         const float* bl, float* oh, float* ol, long long n,
                         void* stream) {
  dd_mul_kernel<<<ew_blocks(n), EW_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(ah, al, bh, bl, oh, ol,
                                                       n);
  return static_cast<int>(cudaGetLastError());
}
