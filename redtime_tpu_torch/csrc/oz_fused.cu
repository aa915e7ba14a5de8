// K7 oz_fused replaces probe4.kernel (scripts/probe_pallas.py:145-181, run
// by pallas_path, :185-199): the TPU's fused Ozaki product of an f32 pair
// (xh, xl) [M, K] with four int8 matrices W0..W3 [K, O].  Each row is
// balanced by 2^-exi, exi = floor(log2 max|xh|) + 2 clipped to [-125,
// 125]; six int8 slices of q = 7 bits are peeled off it (xl joins the
// residual after slice 2); slice i meets W[i % 4] in an int8 dot with
// int32 sums; each sum becomes an exact f32 pair, scaled by 2^-7(i+2) and
// added to a double-double total with Knuth's two-sum; the row scale is
// undone and (oh, ol) [M, O] f32 written.
//
// Bound on the card at P4's shape (M = 2016, K = 1024, O = 256): bytes.
// xh and xl (16.5 MB), W (1.0 MB) and oh, ol (4.1 MB) take 6.5 us at
// 3.35 TB/s; the six dots (6.3 GOP) 3.2 us at 1979 TOP/s on the int8
// tensor cores.  What the design does:
//  * the slices never reach device memory: a ring of four raw slots
//    (imma_tile.cuh) holds xh, xl and the four W tiles of K-steps of 32,
//    filled by 16-byte cp.async two steps ahead; the convert step runs
//    the peel recurrence on each staged value and writes six int8 A
//    tiles, and packs W along K, into one of two operand slots;
//  * the products run on the int8 tensor cores (mma.sync m16n8k32 s8),
//    six int32 accumulators a thread per output;
//  * the row maximum is needed before the first slice: each block reads
//    its rows once (four rows a warp at a time, so many loads fly) while
//    the ring's first copies are in flight;
//  * 32 x 128 block tiles (126 blocks at P4's shape): W is read 63 times
//    and xh, xl twice, mostly from L2; a taller tile would slice each row
//    more often, a wider one would leave SMs idle.
// Bits: the plain version (kernels/probes.py oz_fused_plain) is P4's
// body in PyTorch f32 operations, and this kernel equals it bit for bit.
// Every f32 operation that rounds is written with the __f*_rn intrinsics
// (never contracted into FMAs), in P4's order; round() rounds half to
// even, as jnp.round and torch.round (peel4; roundf would round half
// away);
// log2f is the routine torch.log2 runs on the card; no fast-math, so
// subnormals survive as in the plain version.  The int32 sums are exact
// in any order, and r * 2^k, t / 2^k, and the scalings are exact.
#include <cuda_runtime.h>

#include <cstdint>

#include "imma_tile.cuh"

namespace {

constexpr int Q = 7, SA = 6, NW = 4;  // P4's slice width, slices, W's
constexpr int BM = 32, BN = 128, BK = 32, BKW = BK / 4, STAGES = 4;
constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int WN = BN / 4, NA = WN / 8;  // warps 2 (m16) x 4 (32 columns)
constexpr int LDA = rt::APitch<BKW>::value, LDB = rt::BPitch<BN>::value;
// raw slot: xh, xl [BM][BK] f32, W [NW][BK][BN] int8; operand slot: six
// slice tiles [BM][LDA words], four packed W tiles [BKW][LDB words]
constexpr int X_FLOATS = BM * BK, RAW_BYTES = 2 * X_FLOATS * 4 + NW * BK * BN;
constexpr int A_WORDS = BM * LDA, B_WORDS = BKW * LDB;
constexpr int OP_WORDS = SA * A_WORDS + NW * B_WORDS;
constexpr int SMEM_BYTES = STAGES * RAW_BYTES + 2 * OP_WORDS * 4 + 2 * BM * 4;
// a thread's share of a K-step: one float4 of xh and of xl (the mma's
// word of four K), W_PER 16-byte chunks of W, P_PER 4 x 4 blocks to pack
constexpr int W_PER = NW * BK * (BN / 16) / THREADS;
constexpr int P_PER = NW * BKW * (BN / 4) / THREADS;
static_assert(BM * BKW == THREADS, "one float4 of each input a thread");
static_assert(W_PER * THREADS == NW * BK * (BN / 16), "W chunks");
static_assert(P_PER * THREADS == NW * BKW * (BN / 4), "W blocks");

// 2^(e - 127) from its biased exponent e
__device__ __forceinline__ float pow2_biased(int e) {
  return __int_as_float(e << 23);
}

// 1.5 2^23: for |v| < 2^22, v + ROUNDER rounds v to an integer, half to
// even (the sum's unit in the last place is 1), and the sum's low byte is
// that integer's two's-complement byte (2^22 = 0 mod 256)
constexpr float ROUNDER = 12582912.0f;

// Slices 0..5 of the four inputs (x[e], y[e]) = (xh, xl) of a row scaled
// by inv, as P4 peels them: word w[i] holds slice i of input e in byte e.
// round() is v + ROUNDER - ROUNDER, the same integer as rintf (|v| <= 2^7
// here) on the FMA pipe instead of the slower conversion unit, and the
// byte is read off the sum (no float-to-int conversion); t / 2^k is t *
// 2^-k, the same exact product (|t| >= 1, k <= 42).
__device__ __forceinline__ void peel4(const float4& x, const float4& y,
                                      float inv, unsigned (&w)[SA]) {
  float r[4] = {__fmul_rn(x.x, inv), __fmul_rn(x.y, inv),
                __fmul_rn(x.z, inv), __fmul_rn(x.w, inv)};
  const float yl[4] = {__fmul_rn(y.x, inv), __fmul_rn(y.y, inv),
                       __fmul_rn(y.z, inv), __fmul_rn(y.w, inv)};
#pragma unroll
  for (int i = 0; i < SA; ++i) {
    const float sc = (float)(1ull << (Q * (i + 1)));
    unsigned u[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float big = __fadd_rn(__fmul_rn(r[e], sc), ROUNDER);
      const float tq = __fsub_rn(big, ROUNDER);
      r[e] = __fsub_rn(r[e], __fmul_rn(tq, 1.0f / sc));
      if (i == 2) r[e] = __fadd_rn(r[e], yl[e]);
      u[e] = __float_as_uint(big);
    }
    w[i] = __byte_perm(__byte_perm(u[0], u[1], 0x0040),
                       __byte_perm(u[2], u[3], 0x0040), 0x5410);
  }
}

__global__ void __launch_bounds__(THREADS)
    oz_fused_kernel(const float* __restrict__ xh,
                    const float* __restrict__ xl,
                    const int8_t* __restrict__ ws, float* __restrict__ oh,
                    float* __restrict__ ol, int M, int K, int O, bool x_vec,
                    bool w_vec) {
  extern __shared__ __align__(16) unsigned char oz_smem[];
  unsigned* op = reinterpret_cast<unsigned*>(oz_smem + STAGES * RAW_BYTES);
  float* inv_s = reinterpret_cast<float*>(op + 2 * OP_WORDS);
  int* exi_s = reinterpret_cast<int*>(inv_s + BM);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // this thread's float4 of each K-step: row ar, word (four K) ac
  const int ar = tid / BKW, ac = tid % BKW, am = m0 + ar;

  int acc[SA][NA][4];
#pragma unroll
  for (int i = 0; i < SA; ++i)
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  auto load = [&](int raw, int kt) {
    float* rxh = reinterpret_cast<float*>(oz_smem + raw * RAW_BYTES);
    float* rxl = rxh + X_FLOATS;
    int8_t* rw = reinterpret_cast<int8_t*>(rxl + X_FLOATS);
    const int k = kt * BK + 4 * ac;
    if (x_vec) {
      const bool in = am < M && k < K;  // K % 4 == 0
      const size_t off = in ? (size_t)am * K + k : 0;
      rt::cp_async16(rxh + ar * BK + 4 * ac, xh + off, in);
      rt::cp_async16(rxl + ar * BK + 4 * ac, xl + off, in);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = am < M && k + j < K;
        const size_t off = (size_t)am * K + k + j;
        rxh[ar * BK + 4 * ac + j] = in ? xh[off] : 0.0f;
        rxl[ar * BK + 4 * ac + j] = in ? xl[off] : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < W_PER; ++i) {
      const int idx = tid + i * THREADS;
      const int wi = idx / (BK * (BN / 16)), rest = idx % (BK * (BN / 16));
      const int kr = rest / (BN / 16), c = rest % (BN / 16);
      const int kk = kt * BK + kr, n = n0 + 16 * c;
      int8_t* dst = rw + (wi * BK + kr) * BN + 16 * c;
      const size_t off = ((size_t)wi * K + kk) * O + n;
      if (w_vec) {
        const bool in = kk < K && n < O;  // O % 16 == 0
        rt::cp_async16(dst, in ? ws + off : ws, in);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          dst[j] = kk < K && n + j < O ? ws[off + j] : 0;
      }
    }
  };
  // the row exponents, while the first copies fly: warp w reduces rows
  // w, w + 8, w + 16, w + 24 together
  auto start = [&] {
    float mx[BM / WARPS];
#pragma unroll
    for (int q = 0; q < BM / WARPS; ++q) mx[q] = 0.0f;
    if (x_vec) {
#pragma unroll 4
      for (int k = 4 * lane; k < K; k += 128)
#pragma unroll
        for (int q = 0; q < BM / WARPS; ++q) {
          const int m = m0 + warp + WARPS * q;
          if (m < M) {
            const float4 v = __ldg(
                reinterpret_cast<const float4*>(xh + (size_t)m * K + k));
            mx[q] = fmaxf(mx[q], fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                                       fmaxf(fabsf(v.z), fabsf(v.w))));
          }
        }
    } else {
      for (int k = lane; k < K; k += 32)
#pragma unroll
        for (int q = 0; q < BM / WARPS; ++q) {
          const int m = m0 + warp + WARPS * q;
          if (m < M) mx[q] = fmaxf(mx[q], fabsf(xh[(size_t)m * K + k]));
        }
    }
#pragma unroll
    for (int q = 0; q < BM / WARPS; ++q) {
      float v = mx[q];
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (lane == 0) {
        const float ex = floorf(log2f(fmaxf(v, 1e-38f))) + 2.0f;
        const int e = (int)fminf(fmaxf(ex, -125.0f), 125.0f);
        exi_s[warp + WARPS * q] = e;
        inv_s[warp + WARPS * q] = pow2_biased(127 - e);
      }
    }
  };
  auto convert = [&](int raw, int o) {
    const float* rxh = reinterpret_cast<const float*>(oz_smem + raw * RAW_BYTES);
    const float* rxl = rxh + X_FLOATS;
    const unsigned* rw = reinterpret_cast<const unsigned*>(rxl + X_FLOATS);
    unsigned* slot = op + o * OP_WORDS;
    const float4 h = *reinterpret_cast<const float4*>(rxh + ar * BK + 4 * ac);
    const float4 l = *reinterpret_cast<const float4*>(rxl + ar * BK + 4 * ac);
    unsigned w[SA];
    peel4(h, l, inv_s[ar], w);
#pragma unroll
    for (int i = 0; i < SA; ++i) slot[i * A_WORDS + ar * LDA + ac] = w[i];
#pragma unroll
    for (int i = 0; i < P_PER; ++i) {
      const int idx = tid + i * THREADS;
      const int wi = idx / (BKW * (BN / 4)), rest = idx % (BKW * (BN / 4));
      const int kq = rest / (BN / 4), nb = rest % (BN / 4);
      unsigned b4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b4[j] = rw[(wi * BK + 4 * kq + j) * (BN / 4) + nb];
      rt::pack_k(b4);
      rt::store_b4x4<LDB>(slot + SA * A_WORDS + wi * B_WORDS, kq, 4 * nb,
                          b4);
    }
  };
  auto compute = [&](int, int o) {
    const unsigned* slot = op + o * OP_WORDS;
    // the four W's fragments, read once; slices 4 and 5 meet W0 and W1
    unsigned bf[NW][NA][2];
#pragma unroll
    for (int v = 0; v < NW; ++v)
#pragma unroll
      for (int j = 0; j < NA; ++j)
        rt::load_b<LDB>(bf[v][j], slot + SA * A_WORDS + v * B_WORDS, 0,
                        wn * WN + 8 * j, g, t);
#pragma unroll
    for (int i = 0; i < SA; ++i) {
      unsigned af[4];
      rt::load_a<LDA>(af, slot + i * A_WORDS, 16 * wm, 0, g, t);
#pragma unroll
      for (int j = 0; j < NA; ++j) rt::imma(acc[i][j], af, bf[i % NW][j]);
    }
  };
  rt::ring<STAGES>((K + BK - 1) / BK, load, start, convert, compute);

  // the double-double fold, slice by slice in P4's order, then the unscale
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * wm + g + 8 * h, m = m0 + r;
    if (m >= M) continue;
    const float unscale = pow2_biased(exi_s[r] + 127);
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = n0 + wn * WN + 8 * j + 2 * t + c;
        if (n >= O) continue;
        float toth = 0.0f, totl = 0.0f;
#pragma unroll
        for (int i = 0; i < SA; ++i) {
          const int o = acc[i][j][2 * h + c];
          const float hi = __int2float_rn(o);
          const float s = 1.0f / (float)(1ull << (Q * (i + 2)));
          const float ch = __fmul_rn(hi, s);
          const float cl = __fmul_rn(__int2float_rn(o - (int)hi), s);
          const float sh = __fadd_rn(toth, ch);
          const float v = __fsub_rn(sh, toth);
          const float e = __fadd_rn(
              __fadd_rn(__fadd_rn(__fsub_rn(toth, __fsub_rn(sh, v)),
                                  __fsub_rn(ch, v)),
                        totl),
              cl);
          toth = __fadd_rn(sh, e);
          totl = __fsub_rn(e, __fsub_rn(toth, sh));
        }
        oh[(size_t)m * O + n] = __fmul_rn(toth, unscale);
        ol[(size_t)m * O + n] = __fmul_rn(totl, unscale);
      }
  }
}

}  // namespace

// xh, xl [M, K] f32, ws [4, K, O] int8, oh, ol [M, O] f32, contiguous, on
// the current device; the caller guarantees K * 2^13 < 2^31 (the int32
// sums cannot overflow).  Returns cudaGetLastError().
extern "C" int rt_oz_fused(const float* xh, const float* xl,
                           const int8_t* ws, float* oh, float* ol, int M,
                           int K, int O, void* stream) {
  static bool smem_set[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !smem_set[dev]) {
    cudaFuncSetAttribute(oz_fused_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    smem_set[dev] = true;
  }
  const bool x_vec = K % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(xh) |
                      reinterpret_cast<uintptr_t>(xl)) % 16 == 0;
  const bool w_vec = O % 16 == 0 && reinterpret_cast<uintptr_t>(ws) % 16 == 0;
  dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM);
  oz_fused_kernel<<<grid, THREADS, SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(
      xh, xl, ws, oh, ol, M, K, O, x_vec, w_vec);
  return static_cast<int>(cudaGetLastError());
}
