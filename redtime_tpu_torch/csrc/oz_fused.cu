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
// tensor cores.  Two kernels a call:
//  * oz_pack_w_kernel writes W once into the operand layout of wgmma
//    (K-major tiles of 8 columns x 16 bytes, sm90.cuh): [OP/64][KT][4]
//    [64 x 32 bytes], the four W tiles a CTA multiplies in a K-step in one
//    8 KB run, K and O zero-padded to K-steps of 32 and to OP, a multiple
//    of 256; it also zeroes the main kernel's counters;
//  * oz_fused_kernel: a group of four CTAs owns a tile of 64 rows and 256
//    columns.  Rank r peels rows 16r..16r+15 once: their xh and xl come
//    into shared memory by bulk copies (a panel of up to 1024 columns),
//    the row maximum is taken from that tile, and the six slices of each
//    K-step go to a ring of 16 K-steps in global memory (6 MB at P4's
//    shape, so it stays in L2).  Each CTA multiplies all 64 rows' slices
//    by its 64 columns of W on the int8 tensor cores (wgmma m64n64k32,
//    both operands from shared memory), so every x element is read once
//    and peeled once and all six int32 sums of an output stay in one CTA.
// Why not a thread-block cluster: at this size a cluster of four fits 30
// times on the card (P4 needs 32 tiles), and distributed shared memory
// moved 18 GB/s an SM where bulk copies from L2 moved 71
// (scripts/sm90_probe.py).  The launch is cooperative instead, so the four
// CTAs of a tile are resident together, and they hand the slices over
// through L2 with release / acquire progress counters.
// Roles (480 threads): warps 0-3 peel four K-steps a round (a warp a
// K-step, 16 elements a thread, so each store writes a whole 512-byte
// block of a slice tile); warpgroups 1 and 2 run wgmma on slices 0-2 and
// 3-5 (32 int32 a slice a thread); warp 12 is the producer: it issues the
// x copies, then keeps the copies of the next K-steps' slices (12 KB) and
// W tiles (8 KB) in flight into a ring of four shared-memory stages
// (mbarriers full / empty); warps 13 and 14 publish this CTA's progress
// as a peeler and as a consumer of the ring to the tile's other CTAs, so
// no peeler and no copy waits for a fence.  The fold: each warpgroup
// folds all six slices of half of its outputs, the other half's sums
// swapped through shared memory.
// Where the time goes (scripts/time_oz_fused.py, PERF.md): the copies of
// the stages, 20 KB a K-step for each of 128 CTAs (82 MB from L2 a call;
// 11.5 us alone, scripts/sm90_probe.py), and the slice ring's writes
// (12.6 MB; 8-10 us alone, as bulk stores too) bound it; the peel, the
// wgmma and the fold follow.  ptxas: 128 registers, 12 bytes of spills
// (chip_smoke.py prints them).
// K beyond one panel: the row maxima come from a first pass over xh in
// global memory, then each panel is loaded and peeled in turn.
// Bits: the plain version (kernels/probes.py oz_fused_plain) is P4's
// body in PyTorch f32 operations, and this kernel equals it bit for bit.
// Every f32 operation that rounds is written with the __f*_rn intrinsics,
// in P4's order; where P4's product and difference are exact (r 2^7(i+1)
// and r - t 2^-7(i+1)) they are fused, which gives the same exact value.
// round() rounds half to even (v + 1.5 2^23 - 1.5 2^23, as jnp.round and
// torch.round); log2f is the routine torch.log2 runs on the card; no
// fast-math, so subnormals survive as in the plain version.  The int32
// sums are exact in any order, and the scalings are exact.
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int Q = 7, SA = 6, NW = 4;  // P4's slice width, slices, W's
constexpr int RANKS = 4;              // CTAs of a tile
constexpr int BM = 64;                // rows of a tile (wgmma's M)
constexpr int PR = BM / RANKS;        // rows a CTA peels
constexpr int BN = 64;                // columns of a CTA (wgmma's N)
constexpr int BK = 32;                // a K-step (wgmma's K in bytes)
constexpr int TILE_N = RANKS * BN;
constexpr int SLICE_TILE = BM * BK;         // one slice of a K-step
constexpr int A_BYTES = SA * SLICE_TILE;    // a K-step's slices (12 KB)
constexpr int W_TILE = BN * BK;             // one W of a K-step
constexpr int STAGE = A_BYTES + NW * W_TILE;
constexpr int STAGES = 4;
constexpr int SLOTS = 16;  // K-steps of slices a tile keeps in its L2 ring
constexpr int PANEL = 1024;                 // x columns held at once
constexpr int PEEL = 128, MMA = 256;
constexpr int ROUND = PEEL / 32;  // K-steps a round of the peelers
constexpr int PRODUCER = PEEL + MMA, SIGNALER = PRODUCER + 32;
constexpr int THREADS = SIGNALER + 64;
// a tile's words in the sync buffer: the peelers' progress (one counter a
// rank: K-steps written to the ring), the consumers' (K-steps copied out
// of it), then the 64 row exponents
constexpr int SYNC_WORDS = 2 * RANKS + BM;
// shared memory: stages | xh, xl panels | inv (own rows) | progress |
// barriers: full, empty, xh, xl, x panel free
constexpr int X_OFF = STAGES * STAGE;
constexpr int X_BYTES = 2 * PR * PANEL * 4;
constexpr int INV_OFF = X_OFF + X_BYTES;
constexpr int DONE_OFF = INV_OFF + PR * 4;  // peeled, consumed (local)
constexpr int BAR_OFF = DONE_OFF + 16;
constexpr int NBAR = 2 * STAGES + 3;
constexpr int SMEM_BYTES = BAR_OFF + NBAR * 8;
static_assert(2 * 48 * 128 * 4 <= X_OFF, "fold exchange in the stages");

// 2^(e - 127) from its biased exponent e
__device__ __forceinline__ float pow2_biased(int e) {
  return __int_as_float(e << 23);
}

// 1.5 2^23: for |v| < 2^22, v + ROUNDER rounds v to an integer, half to
// even (the sum's unit in the last place is 1), and the sum's low byte is
// that integer's two's-complement byte (2^22 = 0 mod 256)
constexpr float ROUNDER = 12582912.0f;

// Slices 0..5 of N consecutive elements (x[e], y[e]) = (xh, xl) of a row
// scaled by inv, as P4 peels them: word w[i][e / 4] holds slice i of
// element e in byte e % 4.  round() is v + ROUNDER - ROUNDER and the byte
// is read off the sum; r 2^7(i+1) and r - t 2^-7(i+1) are exact (|t| <=
// 2^6, the difference is the rounding remainder), so each is fused with
// its neighbour without changing a bit.
template <int N>
__device__ __forceinline__ void peel(const float (&x)[N], const float (&y)[N],
                                     float inv, unsigned (&w)[SA][N / 4]) {
  float r[N], yl[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    r[e] = __fmul_rn(x[e], inv);
    yl[e] = __fmul_rn(y[e], inv);
  }
#pragma unroll
  for (int i = 0; i < SA; ++i) {
    const float sc = (float)(1ull << (Q * (i + 1)));
    unsigned u[N];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float big = __fmaf_rn(r[e], sc, ROUNDER);
      const float tq = __fsub_rn(big, ROUNDER);
      r[e] = __fmaf_rn(-tq, 1.0f / sc, r[e]);
      if (i == 2) r[e] = __fadd_rn(r[e], yl[e]);
      u[e] = __float_as_uint(big);
    }
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      w[i][q] = __byte_perm(__byte_perm(u[4 * q], u[4 * q + 1], 0x0040),
                            __byte_perm(u[4 * q + 2], u[4 * q + 3], 0x0040),
                            0x5410);
  }
}

// exi of a row from its max |xh|, as P4 (and torch.log2 on the card)
__device__ __forceinline__ int row_exponent(float mx) {
  const float ex = floorf(log2f(fmaxf(mx, 1e-38f))) + 2.0f;
  return (int)fminf(fmaxf(ex, -125.0f), 125.0f);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Parts of the kernel a measurement can take out (DROP, a mask; 0 is the
// kernel itself, the others give wrong results and serve only to time
// what each part costs): the peel arithmetic (the slices are x's bits),
// the wgmma, the copies of the slices (no wait for the peelers either)
// and the copies of W.
enum Drop { DROP_PEEL = 1, DROP_MMA = 2, DROP_SLICES = 4, DROP_W = 8 };

template <int DROP>
__global__ void __launch_bounds__(THREADS, 1)
    oz_fused_kernel(const float* __restrict__ xh,
                    const float* __restrict__ xl,
                    const uint8_t* __restrict__ wp, uint8_t* __restrict__ ring,
                    uint32_t* __restrict__ sync, float* __restrict__ oh,
                    float* __restrict__ ol, int M, int K, int O, int KT,
                    int col_groups, int tile0, int panel, int npanel,
                    bool x_vec, bool o_vec) {
  extern __shared__ __align__(1024) uint8_t smem[];
  float* sxh = reinterpret_cast<float*>(smem + X_OFF);
  float* sxl = sxh + PR * panel;
  float* inv_s = reinterpret_cast<float*>(smem + INV_OFF);
  uint32_t* done_s = reinterpret_cast<uint32_t*>(smem + DONE_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* xh_bar = empty + STAGES;
  uint64_t* xl_bar = xh_bar + 1;
  uint64_t* x_free = xl_bar + 1;
  const int tid = threadIdx.x;
  const int tile = tile0 + blockIdx.x / RANKS, rank = blockIdx.x % RANKS;
  const int m0 = (tile / col_groups) * BM;
  const int n0 = (tile % col_groups) * TILE_N + rank * BN;
  const int r0 = m0 + PR * rank;  // the first row this CTA peels
  uint32_t* progress = sync + (size_t)tile * SYNC_WORDS;
  uint32_t* consumed = progress + RANKS;
  int* exi_g = reinterpret_cast<int*>(consumed + RANKS);
  uint8_t* slices = ring + (size_t)tile * SLOTS * A_BYTES;
  const int rows = max(0, min(PR, M - r0));  // of them, inside [0, M)
  const int pstep = panel / BK;              // K-steps of a full panel

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::bar_init(&full[s], 1);
      sm90::bar_init(&empty[s], 2);
    }
    sm90::bar_init(xh_bar, 1);
    sm90::bar_init(xl_bar, 1);
    sm90::bar_init(x_free, 1);
    done_s[0] = done_s[1] = 0;
    sm90::fence_bar_init();
  }
  __syncthreads();

  if (tid < PEEL) {
    // ---- peel rows r0..r0+15, ROUND K-steps at a time: warp w takes
    // K-step j + w, lane l the 16 K of half l % 2 of row l / 2, which make
    // one 16-byte row of a core matrix in each slice; so each store of a
    // warp writes one whole 512-byte block of a slice tile
    const int warp = tid / 32, lane = tid % 32, pr = lane / 2;
    // without 16-byte aligned rows the peelers load the panel themselves
    auto load_plain = [&](int k0, int cols) {
      for (int idx = tid; idx < PR * cols; idx += PEEL) {
        const int r = idx / cols, k = k0 + idx % cols, m = r0 + r;
        const bool in = r < rows && k < K;
        sxh[idx] = in ? xh[(size_t)m * K + k] : 0.0f;
        sxl[idx] = in ? xl[(size_t)m * K + k] : 0.0f;
      }
      sm90::named_sync(1, PEEL);
    };
    // warp w reduces rows RW w .. RW w + RW - 1
    constexpr int RW = PR / (PEEL / 32);
    const int cols0 = min(panel, KT * BK);
    float mx[RW];
    if (npanel == 1) {
      if (x_vec)
        sm90::bar_wait(xh_bar, 0);
      else
        load_plain(0, cols0);
      // (columns beyond K were not copied: the bulk path masks them)
      const int kmax = x_vec ? min(cols0, K) : cols0;
#pragma unroll
      for (int q = 0; q < RW; ++q) {
        const float* row = sxh + (RW * warp + q) * cols0;
        float v = 0.0f;
        if (RW * warp + q < rows) {
#pragma unroll 8
          for (int k = 4 * lane; k < kmax; k += 128) {
            const float4 a = *reinterpret_cast<const float4*>(row + k);
            v = fmaxf(v, fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)),
                               fmaxf(fabsf(a.z), fabsf(a.w))));
          }
        }
        mx[q] = warp_max(v);
      }
    } else {
#pragma unroll
      for (int q = 0; q < RW; ++q) {
        const int r = RW * warp + q;
        float v = 0.0f;
        if (r < rows)
          for (int k = lane; k < K; k += 32)
            v = fmaxf(v, fabsf(xh[(size_t)(r0 + r) * K + k]));
        mx[q] = warp_max(v);
      }
    }
    // lane q of warp w owns row RW w + q: its exponent goes to the tile's
    // sync words (for every CTA's fold) and its scale to inv_s
    float mine = mx[0];
#pragma unroll
    for (int q = 1; q < RW; ++q)
      if (lane == q) mine = mx[q];
    if (lane < RW) {
      const int e = row_exponent(mine);
      exi_g[PR * rank + RW * warp + lane] = e;
      inv_s[RW * warp + lane] = pow2_biased(127 - e);
    }
    sm90::named_sync(1, PEEL);
    const float inv = inv_s[pr];
    for (int p = 0; p < npanel; ++p) {
      const int k0 = p * panel, cols = min(panel, KT * BK - k0);
      const int steps = cols / BK;
      if (npanel > 1) {
        if (x_vec)
          sm90::bar_wait(xh_bar, p & 1);
        else
          load_plain(k0, cols);
      }
      if (x_vec) sm90::bar_wait(xl_bar, p & 1);
      uint32_t seen = 0;  // thread c < RANKS: K-steps rank c copied out
      for (int j = 0; j < steps; j += ROUND) {
        // this round's ring slots are free once every rank has copied
        // out the K-steps SLOTS before
        const uint32_t need = p * pstep + min(j + ROUND, steps) - SLOTS;
        if (tid < RANKS && (int)need > 0) {
          const long long t0 = clock64();
          while (seen < need) {
            seen = sm90::ld_acquire_gpu(consumed + tid);
            if (seen < need) __nanosleep(100);
            sm90::watchdog(t0);
          }
        }
        sm90::named_sync(1, PEEL);
        const int js = j + warp, h16 = lane % 2;
        const int kc = js * BK + 16 * h16;  // in the panel
        // rows beyond M and columns beyond K are zero in the plain path
        // and masked here in the bulk one (the copies skip them)
        const bool in = pr < rows && js < steps;
        float x[16], y[16];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool inq = in && k0 + kc + 4 * q < K;  // K % 4 == 0 if x_vec
          const int off = pr * cols + kc + 4 * q;
          const float4 a = inq ? *reinterpret_cast<const float4*>(sxh + off)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const float4 b = inq ? *reinterpret_cast<const float4*>(sxl + off)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          x[4 * q] = a.x;
          x[4 * q + 1] = a.y;
          x[4 * q + 2] = a.z;
          x[4 * q + 3] = a.w;
          y[4 * q] = b.x;
          y[4 * q + 1] = b.y;
          y[4 * q + 2] = b.z;
          y[4 * q + 3] = b.w;
        }
        unsigned w[SA][4];
        if (DROP & DROP_PEEL) {
#pragma unroll
          for (int i = 0; i < SA; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              w[i][q] = __float_as_uint(x[4 * q + i % 4]) ^
                        __float_as_uint(y[4 * q + (i + 1) % 4]);
        } else {
          peel<16>(x, y, inv, w);
        }
        if (js < steps) {
          uint8_t* dst = slices + (size_t)((p * pstep + js) % SLOTS) * A_BYTES +
                         sm90::tile_byte(PR * rank + pr, 16 * h16);
#pragma unroll
          for (int i = 0; i < SA; ++i)
            *reinterpret_cast<uint4*>(dst + i * SLICE_TILE) =
                make_uint4(w[i][0], w[i][1], w[i][2], w[i][3]);
        }
        sm90::named_sync(1, PEEL);
        if (tid == 0)
          sm90::st_release_cta(done_s, p * pstep + min(j + ROUND, steps));
      }
      if (tid == 0 && p + 1 < npanel) sm90::bar_arrive(x_free);
    }
  } else if (tid < PRODUCER) {
    // ---- wgmma: warpgroup wg multiplies slices 3 wg .. 3 wg + 2
    const int wg = (tid - PEEL) / 128, t = (tid - PEEL) % 128;
    int acc[3][32];
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int v = 0; v < 32; ++v) acc[j][v] = 0;
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % STAGES;
      sm90::bar_wait(&full[s], (kt / STAGES) & 1);
      // the slices of K-step kt are out of the ring
      if (wg == 0 && t == 0) sm90::st_release_cta(done_s + 1, kt + 1);
      const uint8_t* st = smem + s * STAGE;
      sm90::wg_fence();
      if (!(DROP & DROP_MMA))
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int i = 3 * wg + j;
          sm90::wgmma_s8_n64(acc[j], sm90::desc(st + i * SLICE_TILE),
                             sm90::desc(st + A_BYTES + (i % NW) * W_TILE));
        }
      sm90::wg_commit();
      sm90::wg_wait<0>();
      if (t == 0) sm90::bar_arrive(&empty[s]);
    }
    // the fold, slice by slice in P4's order, after both warpgroups are
    // done: each warpgroup folds all six slices of half of the outputs
    // (warpgroup 0 values 0-15, warpgroup 1 values 16-31 of each thread),
    // taking the other warpgroup's three int32 sums from shared memory
    // (the stages are free by then).  Thread t of either warpgroup holds
    // the same outputs.
    int* swap = reinterpret_cast<int*>(smem);  // [warpgroup][48][128]
    sm90::named_sync(2, MMA);
    // (the accumulators are indexed by constants only, so they stay in
    // registers: hence the selects on wg)
#pragma unroll
    for (int vv = 0; vv < 16; ++vv)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        swap[(wg * 48 + vv * 3 + j) * 128 + t] =
            wg ? acc[j][vv] : acc[j][16 + vv];
    sm90::named_sync(2, MMA);
    const int w = t / 32, g = (t % 32) / 4, q = t % 4;
    // the exponents of this thread's two rows: every rank published its
    // 16 before its first K-step, which the producer acquired before the
    // copies this warpgroup waited for (with KT == 0 the totals are zero,
    // whatever they are)
    const int e_lo = __ldcg(exi_g + 16 * w + g);
    const int e_hi = __ldcg(exi_g + 16 * w + g + 8);
    const int mine = wg ? 16 : 0;  // the values this warpgroup folds
#pragma unroll
    for (int vv = 0; vv < 16; vv += 2) {
      const int v = mine + vv;
      float2 tot[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float toth = 0.0f, totl = 0.0f;
#pragma unroll
        for (int i = 0; i < SA; ++i) {
          // slice i's int32 sum as an exact f32 pair: for |o| < 2^22, hi =
          // o (1.5 2^23 + o as an f32, less 1.5 2^23, both exact) and lo =
          // 0, on the FMA pipe; else by the conversion unit
          const int o =
              i / 3 == wg
                  ? (wg ? acc[i % 3][16 + vv + c] : acc[i % 3][vv + c])
                  : swap[((1 - wg) * 48 + (vv + c) * 3 + i % 3) * 128 + t];
          float hi, lo;
          if (o > -(1 << 22) && o < (1 << 22)) {
            hi = __fsub_rn(__int_as_float(0x4B400000 + o), ROUNDER);
            lo = 0.0f;
          } else {
            hi = __int2float_rn(o);
            lo = __int2float_rn(o - (int)hi);
          }
          const float s = pow2_biased(127 - Q * (i + 2));
          const float ch = __fmul_rn(hi, s);
          const float cl = __fmul_rn(lo, s);
          // (toth, totl) += (ch, cl): Knuth's two-sum on the hi words
          const float sh = __fadd_rn(toth, ch);
          const float vv = __fsub_rn(sh, toth);
          const float e = __fadd_rn(
              __fadd_rn(__fadd_rn(__fsub_rn(toth, __fsub_rn(sh, vv)),
                                  __fsub_rn(ch, vv)),
                        totl),
              cl);
          toth = __fadd_rn(sh, e);
          totl = __fsub_rn(e, __fsub_rn(toth, sh));
        }
        tot[c] = make_float2(toth, totl);
      }
      const int r = 16 * w + g + 8 * ((v % 4) / 2), m = m0 + r;
      const int n = n0 + 8 * (v / 4) + 2 * q;
      if (m >= M) continue;
      const float unscale = pow2_biased((v % 4 < 2 ? e_lo : e_hi) + 127);
      const float2 a = tot[0], b = tot[1];
      float* ph = oh + (size_t)m * O + n;
      float* pl = ol + (size_t)m * O + n;
      if (o_vec && n + 1 < O) {
        *reinterpret_cast<float2*>(ph) =
            make_float2(__fmul_rn(a.x, unscale), __fmul_rn(b.x, unscale));
        *reinterpret_cast<float2*>(pl) =
            make_float2(__fmul_rn(a.y, unscale), __fmul_rn(b.y, unscale));
      } else {
        if (n < O) {
          ph[0] = __fmul_rn(a.x, unscale);
          pl[0] = __fmul_rn(a.y, unscale);
        }
        if (n + 1 < O) {
          ph[1] = __fmul_rn(b.x, unscale);
          pl[1] = __fmul_rn(b.y, unscale);
        }
      }
    }
  } else {
    // ---- the loader warps: a producer warp and a signaler thread
    if (tid < SIGNALER) {
      // ---- producer warp: lane 0 issues the bulk copies, lanes 0-3 poll
      // the four ranks' progress at once.  x panels, xh then xl: rows
      // inside [0, M), columns inside [0, K); one copy each when the rows
      // are whole (the panel is all of K), else one a row
      const int lane = tid - PRODUCER;
      auto load_x = [&](int p) {
        const int k0 = p * panel, cols = min(panel, KT * BK - k0);
        const int kv = max(0, min(cols, K - k0));  // a multiple of 4
        for (int a = 0; a < 2; ++a) {
          const float* g = (a ? xl : xh) + (size_t)r0 * K + k0;
          float* d = a ? sxl : sxh;
          uint64_t* bar = a ? xl_bar : xh_bar;
          sm90::bar_expect(bar, rows * kv * 4);
          if (kv == cols && kv == K) {
            if (rows > 0) sm90::bulk_load(d, g, rows * kv * 4, bar);
          } else {
            for (int r = 0; r < rows; ++r)
              sm90::bulk_load(d + r * cols, g + (size_t)r * K, kv * 4, bar);
          }
        }
      };
      if (x_vec && lane == 0) load_x(0);
      uint32_t seen = 0;  // lane c < RANKS: rank c's progress
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        if (lane == 0) {
          if (x_vec && kt > 0 && kt % pstep == 0) {
            const int p = kt / pstep;
            sm90::bar_wait(x_free, (p - 1) & 1);
            load_x(p);
          }
          if (kt >= STAGES) sm90::bar_wait(&empty[s], (kt / STAGES - 1) & 1);
        }
        // K-step kt's slices from all four ranks are in L2
        if (lane < RANKS && !(DROP & DROP_SLICES)) {
          const long long t0 = clock64();
          while (seen <= (uint32_t)kt) {
            seen = sm90::ld_acquire_gpu(progress + lane);
            if (seen <= (uint32_t)kt) __nanosleep(100);
            sm90::watchdog(t0);
          }
        }
        __syncwarp();
        if (lane == 0) {
          uint8_t* st = smem + s * STAGE;
          sm90::bar_expect(&full[s], (DROP & DROP_SLICES ? 0 : A_BYTES) +
                                         (DROP & DROP_W ? 0 : NW * W_TILE));
          if (!(DROP & DROP_SLICES))
            sm90::bulk_load(st, slices + (size_t)(kt % SLOTS) * A_BYTES,
                            A_BYTES,
                            &full[s]);
          if (!(DROP & DROP_W))
            sm90::bulk_load(st + A_BYTES,
                            wp + ((size_t)(n0 / BN) * KT + kt) * NW * W_TILE,
                            NW * W_TILE, &full[s]);
        }
      }
    } else if (tid == SIGNALER || tid == SIGNALER + 32) {
      // ---- signalers: publish to the tile's other CTAs this CTA's
      // progress as a peeler (warp 13: K-steps written to the ring, with
      // one GPU-scope release for every K-step finished since the last)
      // and as a consumer (warp 14: K-steps copied out of it; the copies
      // have completed, so no release is needed for the peelers to write
      // the slots again).  Two warps, so neither waits on the other's
      // fences.
      const int which = (tid - SIGNALER) / 32;
      uint32_t* out = (which ? consumed : progress) + rank;
      uint32_t posted = 0;
      const long long t0 = clock64();
      while (posted < (uint32_t)KT) {
        const uint32_t n = sm90::ld_acquire_cta(done_s + which);
        if (n > posted) {
          // the peelers' slices were written by the generic proxy and are
          // read by bulk copies (the async proxy): one proxy fence here
          // orders them, off the peelers' path
          if (which == 0) {
            sm90::fence_async_global();
            sm90::fence_gpu();
            sm90::st_release_gpu(out, n);
          } else {
            sm90::st_relaxed_gpu(out, n);
          }
          posted = n;
        } else {
          __nanosleep(100);
        }
        sm90::watchdog(t0);
      }
    }
  }
}

// w[j] holds row j of a 4 x 4 byte block (byte c: column c); afterwards
// w[c] holds column c (byte j: row j)
__device__ __forceinline__ void transpose4x4(unsigned (&w)[4]) {
  const unsigned x0 = __byte_perm(w[0], w[1], 0x5140);
  const unsigned y0 = __byte_perm(w[2], w[3], 0x5140);
  const unsigned x1 = __byte_perm(w[0], w[1], 0x7362);
  const unsigned y1 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(x0, y0, 0x5410);
  w[1] = __byte_perm(x0, y0, 0x7632);
  w[2] = __byte_perm(x1, y1, 0x5410);
  w[3] = __byte_perm(x1, y1, 0x7632);
}

// W [4, K, O] int8 -> the wgmma tiles [OP / 64][KT][4][64 x 32 bytes]:
// one thread writes the 16-byte rows of four columns 4 n4 .. 4 n4 + 3, K
// half h of K-step kt of W v (consecutive threads take consecutive
// columns, so the reads of a K row coalesce): sixteen 4-byte loads and
// byte permutes when O % 4 == 0 and ws is 4-byte aligned (w_vec), else
// byte loads.  The first threads also zero `nzero` words of `zero` (the
// main kernel's counters).
__global__ void oz_pack_w_kernel(const int8_t* __restrict__ ws,
                                 uint8_t* __restrict__ wp, int K, int O,
                                 int KT, int OP, bool w_vec,
                                 uint32_t* __restrict__ zero,
                                 long long nzero) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < nzero) zero[idx] = 0;
  if (idx >= 4LL * KT * 2 * (OP / 4)) return;
  const int n4 = idx % (OP / 4);
  long long rest = idx / (OP / 4);
  const int h = rest % 2;
  rest /= 2;
  const int kt = rest % KT, v = rest / KT;
  unsigned rows[16];  // rows[j]: K row 32 kt + 16 h + j, columns 4 n4..
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int k = kt * BK + 16 * h + j, n = 4 * n4;
    const int8_t* src = ws + ((size_t)v * K + k) * O + n;
    if (w_vec) {
      rows[j] = k < K && n < O ? *reinterpret_cast<const unsigned*>(src) : 0u;
    } else {
      rows[j] = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (k < K && n + c < O) rows[j] |= (unsigned)(uint8_t)src[c] << (8 * c);
    }
  }
  unsigned cols[4][4];  // cols[c][q]: column 4 n4 + c, K 4q .. 4q + 3
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned b[4] = {rows[4 * q], rows[4 * q + 1], rows[4 * q + 2],
                     rows[4 * q + 3]};
    transpose4x4(b);
#pragma unroll
    for (int c = 0; c < 4; ++c) cols[c][q] = b[c];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int n = 4 * n4 + c;
    *reinterpret_cast<uint4*>(
        wp + (((size_t)(n / BN) * KT + kt) * NW + v) * W_TILE +
        sm90::tile_byte(n % BN, 16 * h)) =
        make_uint4(cols[c][0], cols[c][1], cols[c][2], cols[c][3]);
  }
}

struct Plan {
  int KT, col_groups, row_tiles, OP, panel, npanel;
  long long wp_bytes, ring_bytes, sync_words;
};

Plan plan_of(int M, int K, int O) {
  Plan p;
  p.KT = (K + BK - 1) / BK;
  p.col_groups = (O + TILE_N - 1) / TILE_N;
  p.row_tiles = (M + BM - 1) / BM;
  p.OP = p.col_groups * TILE_N;
  p.panel = p.KT == 0 ? BK : p.KT * BK < PANEL ? p.KT * BK : PANEL;
  p.npanel = p.KT == 0 ? 1 : (p.KT * BK + p.panel - 1) / p.panel;
  p.wp_bytes = (long long)NW * p.KT * p.OP * BK;
  p.ring_bytes = (long long)p.row_tiles * p.col_groups * SLOTS * A_BYTES;
  p.sync_words = (long long)p.row_tiles * p.col_groups * SYNC_WORDS;
  return p;
}

}  // namespace

// The tiling of oz_fused at (M, K, O): out[0..8] = K-steps, column groups,
// row tiles, padded O, x panel columns, panels, and the bytes of the
// packed W, of the slice scratch and the words of the sync buffer (the
// wrapper allocates all three; kernels/probes.py oz_plan mirrors these);
// out[9..10] = the main kernel's threads and dynamic shared memory
extern "C" void rt_oz_fused_plan(int M, int K, int O, long long* out) {
  const Plan p = plan_of(M, K, O);
  const long long v[11] = {p.KT,       p.col_groups, p.row_tiles,
                           p.OP,       p.panel,      p.npanel,
                           p.wp_bytes, p.ring_bytes, p.sync_words,
                           THREADS,    SMEM_BYTES};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
}

// ws [4, K, O] int8 -> wp (plan's wp_bytes), and `nzero` words of `zero`
// set to 0 (the sync buffer, or none), on `stream`
extern "C" int rt_oz_pack_w(const int8_t* ws, uint8_t* wp, int K, int O,
                            uint32_t* zero, long long nzero, void* stream) {
  const Plan p = plan_of(1, K, O);
  long long n = 4LL * p.KT * 2 * (p.OP / 4);
  if (nzero > n) n = nzero;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const bool w_vec = O % 4 == 0 && reinterpret_cast<uintptr_t>(ws) % 4 == 0;
  oz_pack_w_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      ws, wp, K, O, p.KT, p.OP, w_vec, zero, nzero);
  return static_cast<int>(cudaGetLastError());
}

namespace {

template <int DROP>
int launch(const float* xh, const float* xl, const uint8_t* wp,
           uint8_t* ring, uint32_t* sync, float* oh, float* ol, int M, int K,
           int O, cudaStream_t stream) {
  static int capacity[64] = {};  // tiles a launch may hold, by device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!capacity[dev]) {
    cudaFuncSetAttribute(oz_fused_kernel<DROP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, oz_fused_kernel<DROP>, THREADS, SMEM_BYTES);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (per_sm * sms < RANKS)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    capacity[dev] = per_sm * sms / RANKS;
  }
  const Plan p = plan_of(M, K, O);
  const bool x_vec = K % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(xh) |
                      reinterpret_cast<uintptr_t>(xl)) % 16 == 0;
  const bool o_vec = O % 2 == 0 &&
                     (reinterpret_cast<uintptr_t>(oh) |
                      reinterpret_cast<uintptr_t>(ol)) % 8 == 0;
  const int tiles = p.row_tiles * p.col_groups;
  for (int tile0 = 0; tile0 < tiles; tile0 += capacity[dev]) {
    const int n =
        tiles - tile0 < capacity[dev] ? tiles - tile0 : capacity[dev];
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(RANKS * n);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM_BYTES;
    cfg.stream = stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeCooperative;
    attr.val.cooperative = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, oz_fused_kernel<DROP>, xh, xl, wp, ring, sync, oh, ol, M, K, O,
        p.KT, p.col_groups, tile0, p.panel, p.npanel, x_vec, o_vec);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xh, xl [M, K] f32, wp from rt_oz_pack_w, ring and sync scratch (plan's
// ring_bytes and sync_words, sync zeroed by rt_oz_pack_w), oh, ol [M, O]
// f32, contiguous, on the current device; the caller guarantees K * 2^13
// < 2^31 (the int32 sums cannot overflow).  Cooperative launches of at
// most as many tiles as the card holds at once.  Returns the first error.
extern "C" int rt_oz_fused(const float* xh, const float* xl,
                           const uint8_t* wp, uint8_t* ring, uint32_t* sync,
                           float* oh, float* ol, int M, int K, int O,
                           void* stream) {
  return launch<0>(xh, xl, wp, ring, sync, oh, ol, M, K, O,
                   static_cast<cudaStream_t>(stream));
}

// The same with parts taken out (a mask of Drop: 1, 2, 4, 8 or 12), for
// scripts/time_oz_fused.py; its results are wrong by design.
extern "C" int rt_oz_fused_ablate(const float* xh, const float* xl,
                                  const uint8_t* wp, uint8_t* ring,
                                  uint32_t* sync, float* oh, float* ol, int M,
                                  int K, int O, int drop, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (drop) {
    case DROP_PEEL:
      return launch<DROP_PEEL>(xh, xl, wp, ring, sync, oh, ol, M, K, O, st);
    case DROP_MMA:
      return launch<DROP_MMA>(xh, xl, wp, ring, sync, oh, ol, M, K, O, st);
    case DROP_SLICES:
      return launch<DROP_SLICES>(xh, xl, wp, ring, sync, oh, ol, M, K, O, st);
    case DROP_W:
      return launch<DROP_W>(xh, xl, wp, ring, sync, oh, ol, M, K, O, st);
    case DROP_SLICES | DROP_W:
      return launch<DROP_SLICES | DROP_W>(xh, xl, wp, ring, sync, oh, ol, M,
                                          K, O, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
