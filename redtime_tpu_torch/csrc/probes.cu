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
//   Bound on the card: at the probe's 128x512x256 the work (17 MOP) is too
//   small to fill 132 SMs, so launch and latency bound; at 2016x1024x256
//   the integer dot rate.  A first, simple kernel: 64x64 output tiles, K in
//   steps of 64 staged through shared memory packed 4 int8 to a 32-bit
//   word along K, and __dp4a (4 products and a sum per instruction) on
//   each word pair; ragged M, N and K are zero-filled in the loader, so
//   every sum is exact.  The tensor-core form (mma.sync m16n8k32 s8) is a
//   later change.
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

constexpr int DBM = 64, DBN = 64, DBK = 64, DTM = 4, DTN = 4;
constexpr int DOT_THREADS = (DBM / DTM) * (DBN / DTN);  // 256
constexpr int KW = DBK / 4;                             // words along K

__device__ __forceinline__ int pack4(int8_t b0, int8_t b1, int8_t b2,
                                     int8_t b3) {
  return (int)((uint32_t)(uint8_t)b0 | ((uint32_t)(uint8_t)b1 << 8) |
               ((uint32_t)(uint8_t)b2 << 16) | ((uint32_t)(uint8_t)b3 << 24));
}

__global__ void __launch_bounds__(DOT_THREADS)
    int8_dot_kernel(const int8_t* __restrict__ a,
                    const int8_t* __restrict__ b, int32_t* __restrict__ out,
                    int M, int N, int K) {
  __shared__ int As[DBM][KW + 1];  // +1: no bank conflicts on the row walk
  __shared__ int Bs[KW][DBN];
  const int m0 = blockIdx.y * DBM, n0 = blockIdx.x * DBN;
  const int tx = threadIdx.x % (DBN / DTN), ty = threadIdx.x / (DBN / DTN);

  int acc[DTM][DTN];
#pragma unroll
  for (int i = 0; i < DTM; ++i)
#pragma unroll
    for (int j = 0; j < DTN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += DBK) {
    for (int w = threadIdx.x; w < DBM * KW; w += DOT_THREADS) {
      const int r = w / KW, q = w % KW, m = m0 + r;
      int8_t v[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + 4 * q + j;
        if (m < M && k < K) v[j] = a[(size_t)m * K + k];
      }
      As[r][q] = pack4(v[0], v[1], v[2], v[3]);
    }
    for (int w = threadIdx.x; w < KW * DBN; w += DOT_THREADS) {
      const int q = w / DBN, c = w % DBN, n = n0 + c;
      int8_t v[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + 4 * q + j;
        if (n < N && k < K) v[j] = b[(size_t)k * N + n];
      }
      Bs[q][c] = pack4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < KW; ++q) {
      int av[DTM], bv[DTN];
#pragma unroll
      for (int i = 0; i < DTM; ++i) av[i] = As[ty + i * (DBM / DTM)][q];
#pragma unroll
      for (int j = 0; j < DTN; ++j) bv[j] = Bs[q][tx + j * (DBN / DTN)];
#pragma unroll
      for (int i = 0; i < DTM; ++i)
#pragma unroll
        for (int j = 0; j < DTN; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < DTM; ++i) {
    const int m = m0 + ty + i * (DBM / DTM);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < DTN; ++j) {
      const int n = n0 + tx + j * (DBN / DTN);
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
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

// a [M, K], b [K, N] int8 and out [M, N] int32, contiguous, on the current
// device; the caller guarantees K * 2^14 < 2^31 (no int32 overflow).
extern "C" int rt_int8_dot(const int8_t* a, const int8_t* b, int32_t* out,
                           int M, int N, int K, void* stream) {
  dim3 grid((N + DBN - 1) / DBN, (M + DBM - 1) / DBM);
  int8_dot_kernel<<<grid, DOT_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, b, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
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
