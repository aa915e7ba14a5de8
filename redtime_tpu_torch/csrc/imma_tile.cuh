// The int8 tensor-core main loop of K5 int8_dot (probes.cu).  (K7 oz_fused
// has its own, on wgmma: oz_fused.cu and sm90.cuh.)
//
// It multiplies an int8 A [M, K] (row-major, K-contiguous) by an int8 B
// [K, N] (row-major, N-contiguous) with int32 sums, on the tensor cores
// through mma.sync m16n8k32 s8 x s8 -> s32 (wgmma takes 8-bit operands
// K-major only; that form is later work).  The mma's B fragment ("col")
// holds four K-consecutive bytes of one column in each 32-bit register,
// but B's rows are N-contiguous: a convert step reads 4 x 4 byte blocks
// of the staged tile as four row words and turns them into four column
// words with byte permutes (pack_k), so the operand tile holds B packed
// along K.  Ragged M, N and K are zero-filled, so every sum is the exact
// int32 sum.
//
// The ring (ring): STAGES slots of raw tiles filled by 16-byte cp.async
// (STAGES - 2 K-steps in flight while one computes), then a convert step
// that makes the operand tiles of the next K-step (B packed along K) into
// one of two operand slots while the tensor cores work on the other.  One
// barrier a K-step.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "dmma_tile.cuh"

namespace rt {

// d += A B for one warp on the int8 tensor cores, A 16 x 32 (row), B 32 x
// 8 (col), int32 sums.  With lane = 4 g + t, each 32-bit register holds
// four K-consecutive bytes: a[0] = A[g][4t..4t+3], a[1] = A[g+8][4t..],
// a[2] = A[g][16+4t..], a[3] = A[g+8][16+4t..]; b[0] = B[4t..4t+3][g],
// b[1] = B[16+4t..][g]; d[0], d[1] = D[g][2t], D[g][2t+1] and d[2], d[3]
// the same of row g + 8.
__device__ __forceinline__ void imma(int (&d)[4], const unsigned (&a)[4],
                                     const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared-memory tiles, in 32-bit words.  A: rows of BKW words (BK bytes)
// at a pitch of BKW + 4 words; B: BKW rows (four K each) of BN packed
// columns at a pitch of BN + 8 words.  With those pitches the eight rows
// g and four words t of a fragment read fall in 32 distinct banks.
template <int BKW>
struct APitch {
  static constexpr int value = BKW + 4;
  static_assert(value % 8 == 4, "A pitch must be an odd multiple of 4");
};
template <int BN>
struct BPitch {
  static constexpr int value = BN + 8;
  static_assert(value % 16 == 8, "B pitch must be 8 mod 16");
};

// The A fragment of rows row0 .. row0+15 at word kw0 (a k32 step)
template <int LDA>
__device__ __forceinline__ void load_a(unsigned (&a)[4], const unsigned* As,
                                       int row0, int kw0, int g, int t) {
  const unsigned* p = As + (row0 + g) * LDA + kw0 + t;
  a[0] = p[0];
  a[1] = p[8 * LDA];
  a[2] = p[4];
  a[3] = p[8 * LDA + 4];
}

// The B fragment of columns col0 .. col0+7 at packed row kw0
template <int LDB>
__device__ __forceinline__ void load_b(unsigned (&b)[2], const unsigned* Bs,
                                       int kw0, int col0, int g, int t) {
  const unsigned* p = Bs + (kw0 + t) * LDB + col0 + g;
  b[0] = p[0];
  b[1] = p[4 * LDB];
}

// w[j] holds row k + j of a 4 x 4 byte block (byte c: column n + c);
// afterwards w[c] holds column n + c (byte j: row k + j)
__device__ __forceinline__ void pack_k(unsigned (&w)[4]) {
  const unsigned x0 = __byte_perm(w[0], w[1], 0x5140);  // r0c0 r1c0 r0c1 r1c1
  const unsigned y0 = __byte_perm(w[2], w[3], 0x5140);  // r2c0 r3c0 r2c1 r3c1
  const unsigned x1 = __byte_perm(w[0], w[1], 0x7362);  // r0c2 r1c2 r0c3 r1c3
  const unsigned y1 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(x0, y0, 0x5410);
  w[1] = __byte_perm(x0, y0, 0x7632);
  w[2] = __byte_perm(x1, y1, 0x5410);
  w[3] = __byte_perm(x1, y1, 0x7632);
}

// Four packed columns n .. n+3 (16 bytes) into row kw of a B tile
template <int LDB>
__device__ __forceinline__ void store_b4x4(unsigned* Bs, int kw, int n,
                                           const unsigned (&w)[4]) {
  *reinterpret_cast<uint4*>(Bs + kw * LDB + n) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// The main loop over KT K-steps.  load(raw, kt) issues the copies of
// K-step kt into raw slot `raw` (cp.async, or plain stores for ragged
// shapes); convert(raw, op) makes the operand tiles of a landed raw slot
// in operand slot `op`; compute(raw, op) multiplies one K-step.  start()
// runs once the first copies are in flight.  Each K-step: wait for step kt + 1, one barrier (so every
// thread's copies of step kt + 1 have landed, the convert of step kt is
// visible, and the raw slot of step kt - 1 and the operand slot of step
// kt - 1 are free), issue step kt + STAGES - 1 into the raw slot of step
// kt - 1, convert step kt + 1, multiply step kt.
template <int STAGES, class Load, class Start, class Convert, class Compute>
__device__ __forceinline__ void ring(int KT, const Load& load,
                                     const Start& start,
                                     const Convert& convert,
                                     const Compute& compute) {
  static_assert(STAGES >= 3, "two raw slots besides the one converted");
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  start();
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  if (KT > 0) convert(0, 0);
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 3>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < KT) load(next % STAGES, next);
    cp_async_commit();
    if (kt + 1 < KT) convert((kt + 1) % STAGES, (kt + 1) & 1);
    compute(kt % STAGES, kt & 1);
  }
  cp_async_wait<0>();
}

}  // namespace rt
