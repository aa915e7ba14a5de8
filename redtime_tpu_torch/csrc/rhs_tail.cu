// K8 rhs_tail: the Time-RG right-hand side after the mode-coupling engine,
// one launch an evaluation, its lookups included.
//
// Per lane b and k point, from the state y[b, 0..40, k] at eta[b]:
//   dlnP (rows 0-2)   from Omega(a, k) = ((1, -1), (o10(k), o11)), the I
//                     coupling and the three clamps;
//   dI   (rows 3-16)  2 e^eta A_u - CI . (Of x I14);
//   dQ   (rows 17-40) 2 e^eta R - CQ . (Of x Q24) when Q evolves, else 0.
// A_u / R: in full Time-RG the A/R half of the assembly applied to the
// engine's transforms (J, Jn0 from K1's output as K1 wrote it, PZ from
// K2's); in 1-loop mode the z1l cache's rows rescaled by growth factors,
// pre fz^n A; in linear mode dlnP alone.  Omega's inputs and the 1-loop
// growth are looked up here, from the model's tables: a = a_in e^eta,
// beta_P(min(a, 1), k) on the beta table (f_nu beta/f_nu, 0 below
// f_nu = 1e-10 or with no table), a^3 H^2/H0^2 and 3 + dlnH/dlna from the
// cosmology's constants; in 1-loop mode D and dD/da at z = e^-eta (1 +
// z_in) - 1 on the growth table (ln a nodes).
//
// Replaces the JAX package's jitted RHS, one XLA fusion on the TPU with no
// Pallas kernel: redtime_tpu/trg.py:178-254 (make_rhs's rhs), :84-98
// (omega_matrix), :136-159 (oneloop_rescale, with the growth lookup of
// :143-144), the A/R part of redtime_tpu/assembly.py:172-524, and the
// lookups it inlines: redtime_tpu/model.py:126-148 (beta_P_solver),
// :509-518 (growth_D_f), redtime_tpu/background.py:71-88 (H2_H02,
// dlnH_dlna).
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
//     in 1-loop mode pre and fz) once (prologue), with the plain
//     version's operations in its order;
//   * there is no table: the Omega and trace weights are constants in the
//     generated code.
// What is left is latency: a launch whose tasks each store one row of
// zeros takes 1.5-1.8 us, the kernel 3.2 us on the smallest shapes and
// 3.45 us at full TRG 16 lanes; taking out the row loads, the scalars or
// the outputs saves 0.3-0.6 us each.
//
// The lookups (since the prologue moved here) are per task: every warp
// computes its lane's scalars and its 32 points' lookups before its item
// (prologue): it brackets a (and, 1-loop, ln a) with a ballot over 32
// table nodes at a time, forms the 4 weights, loads 4 rows of beta/f_nu
// (1-loop: 4 each of G and dD/da, Dnorm and D_z1l) and computes the
// Omega scalars (three pow, ~10 divisions in three stages).  They add 4
// rows a lane to the bytes (1-loop 10) and a dependent chain to each
// task's latency.  Inlined at each item's first use they cost ~6.5 us
// (0.0101 ms at full TRG 16 lanes against 0.0035 without them): each
// item carried its own copy of three pow, ~25 divisions and the loops,
// after its scalars and before its loads.  So the warp computes them once
// a task, before the item, issues every load first (the nodes before a
// is known, a bracket's rows as soon as it is placed) and spreads each
// stage over its threads (one pow, one division a stage, read back by
// shuffles): 2.5 us at full TRG 16, 3.7 us at 1-loop 32 (the growth's
// chain is longer), ~2.4 us of it the chain's latency, which a task
// that only stores zeros now also waits.
//
// No tensor cores and no TMA: an Omega term is at most 5 products a k
// point, each with a per-k factor, so there is no GEMM shape; a row is
// 32-512 points (0.25-4 KB), which coalesced __ldg serves.
//
// Semantics kept from the plain version: the clamps are compare-and-select
// (a NaN stays NaN, where fmin/fmax would drop it); divisions are IEEE
// (no fast math); the lookups, Omega, dlnP, the 1-loop rescale and the
// assembly are written with __dmul_rn / __dadd_rn / __ddiv_rn in the plain
// version's order; the Omega and trace sums are plain `t += w * x` in the
// table's column order (nvcc contracts them to fma), which gives cuBLAS's
// bits for the plain version's matrix products on the card; a table
// lookup sums its 4 nodes by fma in the order cuBLAS reduces the plain
// version's dense weight row (whose other entries are 0).  A NaN a or
// ln a brackets at the table's end (as torch.searchsorted), so no index
// leaves the table.
//
// Built with -DRT_DROP=<bits> (scripts/time_rhs_tail.py), a part is taken
// out for timing: 1 the row loads (rows from the thread's index), 2 the
// dI / dQ outputs, 4 dlnP, 8 the scalars (from the thread's index), 16
// every task runs item 0 (one item's code on the whole card), 32 every
// task stores one row of zeros and nothing else, 64 the lookups' prologue
// (fixed a and z, no bracketing: the rows of nodes 0-3 with fixed
// weights, no pow / exp / log, fixed Omega scalars); 128 (not a timing
// build) item 0's tasks write the lookups' values (den, o11, beta, o10;
// 1-loop D, dD/da, fz, pre) in rows 0-7 and nothing else.
#include <cuda_runtime.h>

#include <cstddef>

#ifndef RT_DROP
#define RT_DROP 0
#endif
#define LOOKUP_FIXED (RT_DROP & 64)

#include "lookups.cuh"

namespace {

constexpr int KT = 32;                 // k points a task (a warp's lanes)
constexpr int NU = 41;                 // state rows
constexpr double LNP_MIN = -80.0, LNP_MAX = 20.0;
constexpr double DLNP_GUARD = 1e4, DLNP11_GUARD = 10.0;
constexpr double PI = 3.141592653589793;   // np.pi

// bg.OmegaConsts' fields, in its order
enum Const {
  C_FCB, C_FCB_OM, C_OL, C_OG, C_OG4, C_ANU, C_YCOLD, C_YHOT, C_DYHOT,
  C_WA, C_W1, C_EPOW, C_EWA, NCONST
};
// rt_rhs_tail's pointer table (kernels/rhs_tail.py launch)
constexpr int SRC_SLOTS = 7;
constexpr int N_POINTERS = 3 + 4 + NCONST + SRC_SLOTS + 1;

struct Args {
  const double *y, *eta, *k;
  const double *beta_a, *beta_solver, *f_nu, *Om;
  const double* cst[NCONST];
  const double* s[SRC_SLOTS];
  double* dy;
  double a_in, zc;                     // a_in; 1 + z_in (1-loop)
  int B, nk, nz, nn, nfam, pitch;
};

// One thread's view: its lane's rows at its k point, and the scalars the
// items read (prologue)
struct Ctx {
  const double *Y, *JW, *PZ, *AU, *RR;   // row 0 of y, Jw, PZw, A_u, R
  const double *BS, *GG, *GD;            // row 0 of beta_solver, g_G,
                                         // g_dDda
  double* out;                           // dy's row 0
  const double *eta, *kgrid, *beta_a, *f_nu, *Om, *glna;
  const double *Dnorm, *Dz1l;            // at the thread's k
  const double* cst[NCONST];             // bg.OmegaConsts [B] each
  double a_in, zc;
  int b, kk, nk, pitch, nz, nn;
  bool valid;
  // prologue's: k, e^eta, o10 (beta_P, a^3 H^2/H0^2 beside), o11; 1-loop
  // fz and pre (D, dD/da beside)
  double k, e, o10, o11, fz, pre, beta, den, D, dDda;
};

// torch.clamp's rule: a NaN stays NaN
__device__ __forceinline__ double clampn(double x, double lo, double hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

__device__ __forceinline__ void store(const Ctx& c, int row, double v) {
  if (c.valid) c.out[(size_t)row * c.nk] = v;
}

__device__ __forceinline__ double cst(const Ctx& c, Const i) {
  return __ldg(c.cst[i] + c.b);
}

using namespace rt_lookup;

// bg.omega_scalars at a: den = a^3 H^2/H0^2 and o11 = 3 + dlnH/dlna, the
// plain version's operations in its order, as torch's CUDA kernels run
// them: a ** 3 is a * a * a, a ** 4, a ** e_pow, a ** 5 are pow; the
// selects at a >= a_nu compute both sides.  Three stages of pieces: the
// powers; the divisions by a, a^4, a^5; those by a^3, a^4.
__device__ __forceinline__ void omega_scalars(const Ctx& c, double a,
                                              double& den, double& o11) {
  const int t = threadIdx.x & 31;
  const double fcb_om = cst(c, C_FCB_OM), OL = cst(c, C_OL);
  const double pw = pow(a, t == 1 ? cst(c, C_EPOW) : t == 2 ? 5.0 : 4.0);
  const double a4 = piece(pw, 0), a5 = piece(pw, 2);
  const double a3 = __dmul_rn(__dmul_rn(a, a), a);
  const double E = __dmul_rn(
      piece(pw, 1), exp(__dmul_rn(cst(c, C_EWA), __dsub_rn(1.0, a))));
  const bool cold = a >= cst(c, C_ANU);
  const double fa = __dmul_rn(fcb_om, a);
  // Y_nu's hot side, w1 / a, dY's hot side, Og / a^4, 4 Og / a^5
  const double q1 = __ddiv_rn(
      t == 0 ? cst(c, C_YHOT) : t == 1 ? cst(c, C_W1)
          : t == 2 ? cst(c, C_DYHOT) : t == 3 ? cst(c, C_OG) : cst(c, C_OG4),
      t == 0 ? fa : t == 1 ? a : t == 2 ? __dmul_rn(fa, a) : t == 3 ? a4 : a5);
  const double Y1 = __dadd_rn(1.0, cold ? cst(c, C_YCOLD) : piece(q1, 0));
  const double dY = cold ? 0.0 : piece(q1, 2);
  const double dE = __dmul_rn(__dmul_rn(3.0, E),
                              __dsub_rn(cst(c, C_WA), piece(q1, 1)));
  // f_cb Omega_m Y1 / a^3, f_cb Omega_m (-3 Y1 + a dY) / a^4
  const double q2 = __ddiv_rn(
      __dmul_rn(fcb_om, t == 0 ? Y1
                               : __dadd_rn(__dmul_rn(-3.0, Y1),
                                           __dmul_rn(a, dY))),
      t == 0 ? a3 : a4);
  const double H2 = __dadd_rn(
      __dadd_rn(piece(q2, 0), __dmul_rn(OL, E)), piece(q1, 3));
  const double inner = __dsub_rn(
      __dadd_rn(piece(q2, 1), __dmul_rn(OL, dE)), piece(q1, 4));
  den = __dmul_rn(a3, H2);
  o11 = __dadd_rn(3.0, __dmul_rn(__ddiv_rn(__dmul_rn(0.5, a), H2), inner));
}

// The scalars the items read, once a task, as the plain version computes
// them (rhs_tail.prologue_plain, then omega_from and oneloop_rescale):
// k at the thread's point; e^eta and a = a_in e^eta of its lane; o10 =
// -1.5 Omega_m (f_cb + beta) / den with beta_P = where(f_nu < 1e-10, 0,
// f_nu raw) at min(a, 1) (torch.clamp: a NaN stays NaN; 0 with no table)
// and den, o11 from omega_scalars; in 1-loop mode, at z = e^-eta (1 +
// z_in) - 1 and a = 1 / (1 + z) (torch.reciprocal divides), D = (Gv a) /
// Dnorm and dD/da = dDv / Dnorm on the growth table at ln a, then fz =
// dD/da / (D (1 + z)) and pre = dr^4 e^(-4 eta), dr = D / D_z1l.  In
// issue order: every load that does not wait on a bracket, the brackets
// and their rows' loads, then the arithmetic (pow and the divisions)
// while the rows arrive.  RT_DROP 8: the scalars from the thread's index;
// 64: fixed a, z, nodes and Omega scalars.
template <int MODE>
__device__ __forceinline__ void prologue(Ctx& c) {
#if RT_DROP & 8
  c.k = c.kk + 2;
  c.e = c.b + 3;
  c.o11 = c.b + 4;
  c.o10 = c.kk + 5;
  c.fz = c.kk + 6;
  c.pre = c.kk + 7;
  c.den = c.beta = c.D = c.dDda = 0.0;
#else
  const double eta = __ldg(c.eta + c.b);
  c.k = c.valid ? __ldg(c.kgrid + c.kk) : 1.0;
  const double f_nu = __ldg(c.f_nu + c.b);
  const double om15 = __dmul_rn(-1.5, __ldg(c.Om + c.b));
  const double fcb = cst(c, C_FCB);
  const bool has_b = c.nz > 0;
  const int nzb = max(c.nz, 4);
  const double* bnodes = c.beta_a + (size_t)c.b * c.nz;
  const double* gnodes = c.glna + (size_t)c.b * c.nn;
  const Nodes hb = load_nodes(bnodes, c.nz);
  Nodes hg;
  if constexpr (MODE == 2) hg = load_nodes(gnodes, c.nn);
  c.e = exp(eta);
#if RT_DROP & 64
  const double a = 0.5;
#else
  const double a = __dmul_rn(c.e, c.a_in);
#endif
  const double am = a > 1.0 ? 1.0 : a;
  Bracket rb = place(count_below(hb, bnodes, c.nz, am), nzb);
  double vb[4];
  rows4(c.valid, c.nk, rb, c.BS, has_b, vb);
  Bracket rg;
  double vG[4], vD[4], z = 0.0, ag = 1.0, lx = 0.0, Dn = 1.0, Dz = 1.0;
  if constexpr (MODE == 2) {
#if RT_DROP & 64
    z = 1.0;
    ag = 0.5;
#else
    z = __dsub_rn(__dmul_rn(exp(-eta), c.zc), 1.0);
    ag = __ddiv_rn(1.0, __dadd_rn(1.0, z));
#endif
    lx = log(ag);
    rg = place(count_below(hg, gnodes, c.nn, lx), c.nn);
    rows4(c.valid, c.nk, rg, c.GG, true, vG);
    rows4(c.valid, c.nk, rg, c.GD, true, vD);
    Dn = c.valid ? __ldg(c.Dnorm) : 1.0;
    Dz = c.valid ? __ldg(c.Dz1l) : 1.0;
  }
#if RT_DROP & 64
  c.den = 1.0 + c.b;
  c.o11 = 2.0 + c.b;
#else
  omega_scalars(c, a, c.den, c.o11);
#endif
  weights(rb, bnodes, nzb, am, has_b);
  c.beta = !has_b     ? 0.0
           : f_nu < 1e-10 ? 0.0
                          : __dmul_rn(f_nu, dot4_pairs(rb, vb));
  c.o10 = __ddiv_rn(__dmul_rn(om15, __dadd_rn(fcb, c.beta)), c.den);
  if constexpr (MODE == 2) {
    weights(rg, gnodes, c.nn, lx, true);
    c.D = __ddiv_rn(__dmul_rn(dot4_chunks(rg, vG), ag), Dn);
    c.dDda = __ddiv_rn(dot4_chunks(rg, vD), Dn);
    c.fz = __ddiv_rn(c.dDda, __dmul_rn(c.D, __dadd_rn(1.0, z)));
    const double dr = __ddiv_rn(c.D, Dz);
    const double dr2 = __dmul_rn(dr, dr);
    c.pre = __dmul_rn(__dmul_rn(dr2, dr2), exp(__dmul_rn(-4.0, eta)));
  }
#endif
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
#define K_AT() (c.k)
#define LANE_E() (c.e)
#define LANE_O11() (c.o11)
#define O10_AT() (c.o10)
#define FZ_AT() (c.fz)
#define PRE_AT() (c.pre)
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
  c.nz = a.nz;
  c.nn = a.nn;
  c.valid = c.kk < nk;
  c.Y = a.y + (size_t)b * NU * nk + c.kk;
  c.out = a.dy + (size_t)b * NU * nk + c.kk;
  c.JW = c.PZ = c.AU = c.RR = c.GG = c.GD = nullptr;
  c.glna = c.Dnorm = c.Dz1l = nullptr;
  if constexpr (S::MODE == 1) {
    c.JW = a.s[0] + (size_t)b * 9 * a.nfam * a.pitch + c.kk;
    c.PZ = a.s[1] + 63 * (size_t)b * nk + c.kk;
  } else if constexpr (S::MODE == 2) {
    c.AU = a.s[0] + 14 * (size_t)b * nk + c.kk;
    c.RR = a.s[1] + 24 * (size_t)b * nk + c.kk;
    c.glna = a.s[2];
    c.GG = a.s[3] + (size_t)b * a.nn * nk + c.kk;
    c.GD = a.s[4] + (size_t)b * a.nn * nk + c.kk;
    c.Dnorm = a.s[5] + (size_t)b * nk + c.kk;
    c.Dz1l = a.s[6] + (size_t)b * nk + c.kk;
  }
  c.eta = a.eta;
  c.kgrid = a.k;
  c.beta_a = a.beta_a;
  c.BS = a.beta_solver + (size_t)b * a.nz * nk + c.kk;
  c.f_nu = a.f_nu;
  c.Om = a.Om;
#pragma unroll
  for (int i = 0; i < NCONST; ++i) c.cst[i] = a.cst[i];
  c.a_in = a.a_in;
  c.zc = a.zc;
  prologue<S::MODE>(c);
#if RT_DROP & 128
  // item 0's tasks write the lookups' values in rows 0-7 and nothing else
  // (scripts/probe_rhs_prologue.py)
  if (it == 0) {
    store(c, 0, c.den);
    store(c, 1, c.o11);
    store(c, 2, c.beta);
    store(c, 3, c.o10);
    if constexpr (S::MODE == 2) {
      store(c, 4, c.D);
      store(c, 5, c.dDda);
      store(c, 6, c.fz);
      store(c, 7, c.pre);
    }
  }
#elif RT_DROP & 32
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

// ptrs[N_POINTERS] (read here, at the call): y [B, 41, nk], eta [B],
// k [nk]; the Omega tables beta_a [B, nz], beta_solver [B, nz, nk], f_nu,
// Omega_m [B] and bg.OmegaConsts' 13 fields [B]; SRC_SLOTS sources (full
// TRG: Jw [B, nfam, 3, 3, pitch], PZw [B, 7, 3, 3, nk]; 1-loop: A_u
// [B, 14, nk], R [B, 24, nk], g_lna [B, nn], g_G, g_dDda [B, nn, nk],
// g_Dnorm, D_z1l [B, nk]; linear: none; the rest null); dy [B, 41, nk].
// a_in; zc = 1 + z_in (1-loop).  nz: 0 (no beta_P table) or >= 4; nn >=
// 4 (1-loop).  variant: the index of kernels/rhs_tail.py VARIANTS (enum
// Variant); blocks of threads (a multiple of 32, at most
// MAX_BLOCK_THREADS) as rhs_tail.launch_plan sets them, enough warps for
// every task.
extern "C" int rt_rhs_tail(const double* const* ptrs, int nptrs,
                           double a_in, double zc, int B, int nk, int nz,
                           int nn, int variant, int nfam, int pitch,
                           int blocks, int threads, void* stream) {
  if (nptrs != N_POINTERS || (nz > 0 && nz < 4) ||
      (variant >= V_ONELOOP && nn < 4)) {
    return cudaErrorInvalidValue;
  }
  Args a;
  int p = 0;
  a.y = ptrs[p++];
  a.eta = ptrs[p++];
  a.k = ptrs[p++];
  a.beta_a = ptrs[p++];
  a.beta_solver = ptrs[p++];
  a.f_nu = ptrs[p++];
  a.Om = ptrs[p++];
  for (int i = 0; i < NCONST; ++i) a.cst[i] = ptrs[p++];
  for (int i = 0; i < SRC_SLOTS; ++i) a.s[i] = ptrs[p++];
  a.dy = const_cast<double*>(ptrs[p++]);
  a.a_in = a_in;
  a.zc = zc;
  a.B = B;
  a.nk = nk;
  a.nz = nz;
  a.nn = nn;
  a.nfam = nfam;
  a.pitch = pitch;
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
