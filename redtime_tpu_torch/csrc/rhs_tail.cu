// K8 rhs_tail: the Time-RG right-hand side after the mode-coupling engine,
// one launch an evaluation.
//
// Per lane b and k point, from the state y[b, 0..40, k] at eta[b]:
//   dlnP (rows 0-2)   from Omega(a, k) = ((1, -1), (o10(k), o11)), the I
//                     coupling and the three clamps;
//   dI   (rows 3-16)  2 e^eta A_u - CI . (Of x I14);
//   dQ   (rows 17-40) 2 e^eta R - CQ . (Of x Q24) when Q evolves, else 0.
// A_u / R: in full Time-RG the A/R half of the assembly applied to the
// engine's transforms (J, Jn0 from K1's output as K1 wrote it, PZ from
// K2's); in 1-loop mode the z1l cache's rows rescaled by growth factors,
// pre fz^n A; in linear mode dlnP alone.
//
// Replaces the JAX package's jitted RHS, one XLA fusion on the TPU with no
// Pallas kernel: redtime_tpu/trg.py:178-254 (make_rhs's rhs), :84-98
// (omega_matrix), :136-159 (oneloop_rescale) and the A/R part of
// redtime_tpu/assembly.py:172-524.
//
// The work items and their code are generated (rhs_tail_ar.cuh, written
// at build time by kernels/rhs_tail.py ar_source), one instantiation of
// the kernel a variant (the mode, and whether Q evolves).  A work item is
// a few output rows of dI / dQ (in full TRG their A/R program, traced from
// assembly.ar_rows, each operation one IEEE operation in traced order, so
// that the assembly's cancellation -- A and R are small differences of
// terms up to ~1e4 larger -- rounds as in the plain version; a division
// by a constant is x * (1/c), as torch's CUDA kernels divide by a
// scalar), or dlnP, or the variant's zero rows.  A task is one item at
// KT = 32 k points of one lane, on one warp; tasks are numbered
// item-major and a block takes 1-8 consecutive ones.
//
// What bounds it on the card (NVIDIA H100 80GB HBM3, 700 W; device times
// in a CUDA graph, scripts/time_rhs_tail.py).  Full TRG at 16 lanes and
// nk = 128 must move 3.03 MB (0.91 us at 3.35 TB/s: the 143 rows its
// items read, dy, the scalars) and do ~3.5 MFLOP of f64 (0.10 us), yet
// the kernel's first design (a block of 8 warps a lane and 32 k points,
// each warp 4-5 outputs in turn, dlnP on the last) took 11.6 us.  A second filled the card (8 blocks of 5 warps a lane and
// tile, one output a warp, each block staging its rows in shared memory)
// and took 9.1 us: with parts taken out, the outputs' code cost 4.7 us
// of it, as much again when run twice, and 3.7 us less when every block
// ran one group's five outputs.  The warps an SM held ran ~20 outputs'
// different straight-line code (8,100 instructions in all), and fetching
// it, not the loads or the f64 pipe, set the pace.  So in this design:
//   * the warps an SM holds run one or two items' code: tasks go to
//     blocks item-major, so a block's warps run one item on neighbouring
//     lanes and tiles, and blocks fill the card (at least 264 where the
//     tasks allow: 320 blocks of 2 warps in full TRG at 16 lanes; the
//     wrapper passes the launch, rhs_tail.launch_plan);
//   * a warp loads each row its item reads (features, cache rows, state
//     rows) straight into registers, one coalesced 256-byte load a row,
//     all issued before the arithmetic: no shared memory, no barrier;
//     nothing is loaded that the item does not read;
//   * outputs that share rows share an item, up to ~260 operations in
//     full TRG (10 items, 322 rows a (lane, tile) against 230 staged by
//     the first design, 87 of them never read) and ~120 in 1-loop mode
//     (6 items);
//   * a warp computes the scalars its item reads (k, o10, e^eta, o11;
//     in 1-loop mode pre fz^n) once, with the plain version's operations
//     in its order;
//   * there is no table: the Omega and trace weights are constants in the
//     generated code.
// What is left is latency: a launch whose tasks each store one row of
// zeros takes 1.5-1.8 us, the kernel 3.2 us on the smallest shapes and
// 3.45 us at full TRG 16 lanes; taking out the row loads, the scalars or
// the outputs saves 0.3-0.6 us each.
//
// No tensor cores and no TMA: an Omega term is at most 5 products a k
// point, each with a per-k factor, so there is no GEMM shape; a row is
// 32-512 points (0.25-4 KB), which coalesced __ldg serves.
//
// Semantics kept from the plain version: the clamps are compare-and-select
// (a NaN stays NaN, where fmin/fmax would drop it); divisions are IEEE
// (no fast math); Omega, dlnP, the 1-loop rescale and the assembly are
// written with __dmul_rn / __dadd_rn in the plain version's order; the
// Omega and trace sums are plain `t += w * x` in the table's column order
// (nvcc contracts them to fma), which gives cuBLAS's bits for the plain
// version's matrix products on the card.
//
// Built with -DRT_DROP=<bits> (scripts/time_rhs_tail.py), a part is taken
// out for timing: 1 the row loads (rows from the thread's index), 2 the
// dI / dQ outputs, 4 dlnP, 8 the scalars (from the thread's index), 16
// every task runs item 0 (one item's code on the whole card), 32 every
// task stores one row of zeros and nothing else.
#include <cuda_runtime.h>

#include <cstddef>

#ifndef RT_DROP
#define RT_DROP 0
#endif

namespace {

constexpr int KT = 32;                 // k points a task (a warp's lanes)
constexpr int NU = 41;                 // state rows
constexpr double LNP_MIN = -80.0, LNP_MAX = 20.0;
constexpr double DLNP_GUARD = 1e4, DLNP11_GUARD = 10.0;
constexpr double PI = 3.141592653589793;   // np.pi

struct Args {
  const double *y, *eta, *k, *beta, *Om, *fcb, *den, *o11;
  const double *s0, *s1, *s2, *s3, *s4, *s5;
  double* dy;
  int B, nk, nfam, pitch;
};

// One thread's view: its lane's rows at its k point
struct Ctx {
  const double *Y, *JW, *PZ, *AU, *RR;   // row 0 of y, Jw, PZw, A_u, R
  double* out;                           // dy's row 0
  const double *eta, *kgrid, *beta, *Om, *fcb, *den, *o11;
  const double *D, *dDda, *Dz1l, *z;
  int b, kk, nk, pitch;
  bool valid;
};

// torch.clamp's rule: a NaN stays NaN
__device__ __forceinline__ double clampn(double x, double lo, double hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

__device__ __forceinline__ void store(const Ctx& c, int row, double v) {
  if (c.valid) c.out[(size_t)row * c.nk] = v;
}

// The scalars, as the plain version computes them: k and o10 at the
// thread's point, e^eta and o11 of its lane; in 1-loop mode pre and fz
// (trg.oneloop_rescale: pre = dr^4 e^(-4 eta), dr = D / D_z1l,
// fz = dD/da / (D (1 + z))).
__device__ __forceinline__ size_t at(const Ctx& c) {
  return (size_t)c.b * c.nk + (c.valid ? c.kk : 0);
}
__device__ __forceinline__ double k_at(const Ctx& c) {
  return c.valid ? __ldg(c.kgrid + c.kk) : 1.0;
}
__device__ __forceinline__ double lane_e(const Ctx& c) {
  return exp(__ldg(c.eta + c.b));
}
__device__ __forceinline__ double lane_o11(const Ctx& c) {
  return __ldg(c.o11 + c.b);
}
__device__ __forceinline__ double o10_at(const Ctx& c) {
  return __ddiv_rn(__dmul_rn(__dmul_rn(-1.5, __ldg(c.Om + c.b)),
                             __dadd_rn(__ldg(c.fcb + c.b),
                                       __ldg(c.beta + at(c)))),
                   __ldg(c.den + c.b));
}
__device__ __forceinline__ double fz_at(const Ctx& c) {
  return __ddiv_rn(__ldg(c.dDda + at(c)),
                   __dmul_rn(__ldg(c.D + at(c)),
                             __dadd_rn(1.0, __ldg(c.z + c.b))));
}
__device__ __forceinline__ double pre_at(const Ctx& c) {
  const double dr = __ddiv_rn(__ldg(c.D + at(c)), __ldg(c.Dz1l + at(c)));
  const double dr2 = __dmul_rn(dr, dr);
  return __dmul_rn(__dmul_rn(dr2, dr2),
                   exp(__dmul_rn(-4.0, __ldg(c.eta + c.b))));
}

// dlnP from lnP (y0-2) and, nonlinear, Isum's rows (i0-3)
__device__ __forceinline__ void dlnp(const Ctx& c, double y0, double y1,
                                     double y2, bool nonlinear, double i0,
                                     double i1, double i2, double i3,
                                     double e, double k, double o10,
                                     double o11) {
  const double P0 = exp(clampn(y0, LNP_MIN, LNP_MAX));
  const double P1 = exp(clampn(y1, LNP_MIN, LNP_MAX));
  const double P2 = exp(clampn(y2, LNP_MIN, LNP_MAX));
  // O00 = 1, O01 = -1, as the plain version multiplies them
  double dP0 = __dmul_rn(-2.0, __dadd_rn(__dmul_rn(1.0, P0),
                                         __dmul_rn(-1.0, P1)));
  double dP1 = __dsub_rn(
      -__dadd_rn(__dmul_rn(1.0, P1), __dmul_rn(-1.0, P2)),
      __dadd_rn(__dmul_rn(o10, P0), __dmul_rn(o11, P1)));
  double dP2 = __dmul_rn(-2.0, __dadd_rn(__dmul_rn(o10, P1),
                                         __dmul_rn(o11, P2)));
  if (nonlinear) {
    const double coef = __ddiv_rn(__dmul_rn(__dmul_rn(e, 4.0), PI), k);
    dP0 = __dadd_rn(dP0, __dmul_rn(coef, __dadd_rn(i0, i0)));
    dP1 = __dadd_rn(dP1, __dmul_rn(coef, __dadd_rn(i2, i1)));
    dP2 = __dadd_rn(dP2, __dmul_rn(coef, __dadd_rn(i3, i3)));
  }
  store(c, 0, clampn(__ddiv_rn(dP0, P0), -DLNP_GUARD, DLNP_GUARD));
  store(c, 1, clampn(__ddiv_rn(dP1, P1), -DLNP_GUARD, DLNP_GUARD));
  store(c, 2, clampn(clampn(__ddiv_rn(dP2, P2), -DLNP_GUARD, DLNP_GUARD),
                     -DLNP11_GUARD, DLNP11_GUARD));
}

// The generated code's vocabulary (kernels/rhs_tail.py ar_source)
#if RT_DROP & 1
#define LD_(p, pitch, r) ((double)(c.kk + (r) + 1))
#else
#define LD_(p, pitch, r) \
  (c.valid ? __ldg(c.p + (size_t)(r) * (size_t)(pitch)) : 0.0)
#endif
#define LD_Y(r) LD_(Y, c.nk, r)
#define LD_JW(r) LD_(JW, c.pitch, r)
#define LD_PZ(r) LD_(PZ, c.nk, r)
#define LD_AU(r) LD_(AU, c.nk, r)
#define LD_R(r) LD_(RR, c.nk, r)
#if RT_DROP & 8
#define K_AT() ((double)(c.kk + 2))
#define LANE_E() ((double)(c.b + 3))
#define LANE_O11() ((double)(c.b + 4))
#define O10_AT() ((double)(c.kk + 5))
#define FZ_AT() ((double)(c.kk + 6))
#define PRE_AT() ((double)(c.kk + 7))
#else
#define K_AT() k_at(c)
#define LANE_E() lane_e(c)
#define LANE_O11() lane_o11(c)
#define O10_AT() o10_at(c)
#define FZ_AT() fz_at(c)
#define PRE_AT() pre_at(c)
#endif
#define DIVC_(x, d) __dmul_rn((x), 1.0 / (d))
#define ZERO_(r) store(c, (r), 0.0)
#if RT_DROP & 2
#define OUT_(r, v) ((void)0)
#else
#define OUT_(r, v) store(c, (r), (v))
#endif
#if RT_DROP & 4
#define DLNP_(y0, y1, y2, i0, i1, i2, i3) ((void)0)
#define DLNP_LINEAR_(y0, y1, y2) ((void)0)
#else
#define DLNP_(y0, y1, y2, i0, i1, i2, i3) \
  dlnp(c, (y0), (y1), (y2), true, (i0), (i1), (i2), (i3), E_, K_, O10_, O11_)
#define DLNP_LINEAR_(y0, y1, y2) \
  dlnp(c, (y0), (y1), (y2), false, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, O10_, O11_)
#endif

template <int V>
struct Sched;

#include "rhs_tail_ar.cuh"   // MAX_BLOCK_THREADS; Sched<V>::item

template <int V>
__global__ void __launch_bounds__(MAX_BLOCK_THREADS)
    rhs_tail_kernel(const Args a) {
  using S = Sched<V>;
  const int lane = threadIdx.x & 31;
  // 32-bit task numbers (the wrapper holds tasks below 2^31): a 64-bit
  // division is a long library routine on the card
  const unsigned ntiles = (a.nk + KT - 1) / KT;
  const unsigned pairs = (unsigned)a.B * ntiles;
  const unsigned task = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const unsigned it = task / pairs;
  if (it >= (unsigned)S::ITEMS) return;
  const unsigned pair = task - it * pairs;
  const int b = (int)(pair / ntiles), nk = a.nk;
  Ctx c;
  c.b = b;
  c.kk = (int)(pair - b * ntiles) * KT + lane;
  c.nk = nk;
  c.pitch = a.pitch;
  c.valid = c.kk < nk;
  c.Y = a.y + (size_t)b * NU * nk + c.kk;
  c.out = a.dy + (size_t)b * NU * nk + c.kk;
  c.JW = c.PZ = c.AU = c.RR = nullptr;
  c.D = c.dDda = c.Dz1l = c.z = nullptr;
  if constexpr (S::MODE == 1) {
    c.JW = a.s0 + (size_t)b * 9 * a.nfam * a.pitch + c.kk;
    c.PZ = a.s1 + 63 * (size_t)b * nk + c.kk;
  } else if constexpr (S::MODE == 2) {
    c.AU = a.s0 + 14 * (size_t)b * nk + c.kk;
    c.RR = a.s1 + 24 * (size_t)b * nk + c.kk;
    c.D = a.s2;
    c.dDda = a.s3;
    c.Dz1l = a.s4;
    c.z = a.s5;
  }
  c.eta = a.eta;
  c.kgrid = a.k;
  c.beta = a.beta;
  c.Om = a.Om;
  c.fcb = a.fcb;
  c.den = a.den;
  c.o11 = a.o11;
#if RT_DROP & 32
  store(c, it % NU, 0.0);
#elif RT_DROP & 16
  S::item(0, c);
#else
  S::item(it, c);
#endif
}

template <int V>
int launch(const Args& a, int blocks, int threads, cudaStream_t stream) {
  rhs_tail_kernel<V><<<blocks, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y [B, 41, nk], eta [B], k [nk], beta [B, nk], Om / fcb / den / o11 [B];
// full TRG: s0 = Jw [B, nfam, 3, 3, pitch], s1 = PZw [B, 7, 3, 3, nk];
// 1-loop: s0 = A_u [B, 14, nk], s1 = R [B, 24, nk], s2 = D, s3 = dD/da,
// s4 = D_z1l [B, nk], s5 = z [B]; linear: none.  variant: the index of
// kernels/rhs_tail.py VARIANTS (enum Variant); blocks of threads (a
// multiple of 32, at most MAX_BLOCK_THREADS) as rhs_tail.launch_plan
// sets them, enough warps for every task.
extern "C" int rt_rhs_tail(const double* y, const double* eta,
                           const double* k, const double* beta,
                           const double* Om, const double* fcb,
                           const double* den, const double* o11,
                           const double* s0, const double* s1,
                           const double* s2, const double* s3,
                           const double* s4, const double* s5, double* dy,
                           int B, int nk, int variant, int nfam, int pitch,
                           int blocks, int threads, void* stream) {
  const Args a{y,  eta, k,  beta, Om, fcb, den, o11, s0,   s1,
               s2, s3,  s4, s5,   dy, B,   nk,  nfam, pitch};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (threads % 32 != 0 || threads > MAX_BLOCK_THREADS) {
    return cudaErrorInvalidValue;
  }
  switch (variant) {
    case V_LINEAR: return launch<V_LINEAR>(a, blocks, threads, st);
    case V_FULL: return launch<V_FULL>(a, blocks, threads, st);
    case V_FULL_Q: return launch<V_FULL_Q>(a, blocks, threads, st);
    case V_ONELOOP: return launch<V_ONELOOP>(a, blocks, threads, st);
    case V_ONELOOP_Q: return launch<V_ONELOOP_Q>(a, blocks, threads, st);
  }
  return cudaErrorInvalidValue;
}
