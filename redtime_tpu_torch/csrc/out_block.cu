// K11 out_block: the output block of one driver._finalize, every output
// redshift's columns, sigma_v^2 and H in one launch.
//
// For lane b, output redshift s and k point, from the evolved state
// ys[b, s, 0..40, k] it writes the row table[b, s, k, 0..ncol-1] in the
// layout's printed column order, and for (b, s) sigma_v^2 and H (h/Mpc):
//   k | D, f = a dD/da / D, P_cb, beta / (beta(a=1) + 1e-100),
//   dln beta/dln a, P_nu (print_lin) | exp(ln P_ab) r^2 | A_u (print_a) |
//   I (print_i) | P_B r^3, P_T r^4, P_MR r^4 (print_rsd; summed without
//   print_bias) | Q r^3 (print_q),  r = a / a_in, a = 1 / (1 + z).
// The lookups come from the model's tables: D and dD/da on the growth
// table at ln a; beta_P at min(a, 1), 1, a 0.999 and min(1, a 1.001) on
// the beta table (0 below f_nu = 1e-10 or with no table); the linear
// power norm k^n_s T^2 F^2 D^2, F = 1 - f_nu + beta; H = sqrt(H^2/H0^2)
// H0 from the cosmology's parameters; sigma_v^2 = D(k = 1e-3)^2
// sigma_v^2(z = 0).  A_u, P_T and P_MR come from the engine's transforms of
// the states' ln P rows (K9 -> K10 -> K1 + K2 over the B S lanes, run by
// the caller), J and Jn0 from K1's output as K1 wrote it (J_lo at column
// nk of row 0), PZ from K2's; where the layout prints them and the mode
// does not compute them, 0.
//
// Replaces the JAX package's output block, one XLA graph on the TPU with
// no Pallas kernel: redtime_tpu/driver.py:133-198 (build_output_block),
// :240-268 (_finalize), redtime_tpu/trg.py:563 (pbis_j), :161
// (_collapse_pt), the A rows, P_T and P_MR of redtime_tpu/assembly.py:
// 172-524, and the lookups redtime_tpu/model.py:135 (beta_P_solver),
// :509 (growth_D_f), :521 (plin_all), :581 (sigma_v2),
// redtime_tpu/background.py:78 (H_H0).
//
// The traced programs and the layouts' switch are generated
// (out_block_gen.cuh, written at build time by kernels/out_block.py
// out_source): the A rows (assembly.ar_rows), P_T / P_MR
// (assembly.pt_pmr_rows) and P_B (trg.pbis_rows), each traced operation
// one IEEE operation in traced order (A and P_T are small differences of
// terms up to ~1e4 larger: another order moves them by ~1e-12 of their
// scale); a division by a constant is x * (1/c), as torch's CUDA kernels
// divide by a scalar; one case a column layout, which names the layout's
// column groups and their first columns.
//
// What bounds it on the card: the bytes (full TRG 16 lanes x 8 redshifts
// at nk = 128: ~4.7 MB, 1.4 us at 3.35 TB/s, about half of it the table)
// and not the f64 operations, but what sets its pace is latency.  The
// first design (a warp a (lane, z) and 32 k points, each thread running
// the whole chain of its point: the growth bracket, the four beta
// brackets, k^n_s, then every column group, then one thread sigma_v^2
// and H; each thread writing its own row of the table) ran at 10-20% of
// that bound: a few warps an SM, each a long dependent chain, its stores
// ncol x 8 bytes apart.  This design (scripts/time_out_block.py):
//   * a block owns one (lane, z) and a range of its k points: all of
//     them where the pairs are at least half the card's 132 SMs or have
//     at most 64 points, else the ranges of one pair are the blocks of a
//     cluster (launch_plan);
//   * the pair's scalars are computed once, by three warps of the
//     cluster's rank 0 at once: the growth bracket and weights at ln a,
//     f_nu and the power's norm (then sigma_v^2, then H, its pows and
//     exp on four threads); the four beta brackets on two warps (each
//     warp's 4-thread groups weigh one x each);
//   * the hand-over: in a block of its own pair, two named barriers, the
//     brackets' first nodes as soon as they are placed (the lin warps
//     load their rows while the weights are divided), then the weights;
//     in a cluster, remote stores into every block once every block
//     started, then one cluster barrier phase (costlier: full TRG 16 x 8
//     in clusters of 2 took 0.0083 ms against 0.0077);
//   * the column groups of each 32 k points go to warps of their own: the
//     lin group (the only one that waits for the lookups) to one warp a
//     32 points, which computes k^n_s and loads T, D's norm and k first;
//     the traced programs and the copy groups (k, P, I, Q, the zero
//     columns) to units that the block's other warps take in turn from a
//     shared counter, heaviest first, each thread one k point;
//   * every column goes to a staging tile in shared memory (rows of an
//     odd pitch, so a warp's column writes do not conflict), and the
//     block writes the tile's rows out as the contiguous doubles they
//     are in the table, 16-byte stores on consecutive addresses; a range
//     longer than the tile goes in passes.
// The chains left are f64 ones (on the H100 a pow ~1,000 cycles, a
// division a few hundred, whether its code is cached or not): the growth
// bracket (log, 3 divisions), the lin warps' rows and ~10 divisions, then
// the tile's stores.
// Nothing is called out of line, so no stack frame.
//
// Semantics kept from the plain version (kernels/out_block.py
// out_block_plain): every operation __d*_rn in its order; torch's CUDA
// powers (x ** 2 is x * x, x ** 3 x * x * x, x ** 4 and tensor exponents
// pow; r ** 3, r ** 4 of the Python floats come from the host, as the
// plain version computes them); a NaN state gives NaN columns; the
// lookups sum their 4 nodes in K8's orders (dot4_pairs for beta,
// dot4_chunks for the growth).
//
// Timing builds (scripts/time_out_block.py --drops): OB_DROP 1 writes no
// table (the tile is still filled), 4 runs no traced program (their
// outputs are k); LOOKUP_FIXED 1 (csrc/lookups.cuh) fixes the lookups.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "lookups.cuh"

#ifndef OB_DROP
#define OB_DROP 0
#endif

namespace {

namespace cg = cooperative_groups;
using namespace rt_lookup;

constexpr int KT = 32;                 // k points a chunk (a warp's lanes)
constexpr int NU = 41;                 // state rows
constexpr int NUP = 3, NUI = 14, NUQ = 24;
constexpr int MAX_Z = 64;              // redshifts a launch
constexpr int MAX_BLOCK_THREADS = 512;
constexpr int MAX_CLUSTER = 8;         // the portable cluster size
constexpr int S_WARPS = 3;             // rank 0's scalar warps, the last 3
// the named barriers of the scalars' hand-over (a pair of one block)
constexpr int BAR_SCALARS = 1, BAR_INDEX = 2;
constexpr int MAX_TILE = 200 * 1024;  // the staging tile's bytes, at most

// rt_out_block's pointer table (kernels/out_block.py _tensors, then the
// outputs): ys, k, the cosmology's n_s, h, Omega_m, Omega_nu, T_cmb, w0,
// wa, the model's norm, sigmaV2_z0, T_solver, beta_a, beta_solver, g_lna,
// g_G, g_dDda, g_Dnorm, the engine's Jw, PZw (null without it), table,
// sigma_v2, H
enum Ptr {
  P_YS, P_K, P_NS, P_H, P_OM, P_ONU, P_TCMB, P_W0, P_WA, P_NORM, P_SV0,
  P_T, P_BA, P_BS, P_GLNA, P_GG, P_GD, P_GDN, P_JW, P_PZ, P_TABLE, P_SV2,
  P_HOUT, N_POINTERS
};

struct Args {
  const double* p[N_POINTERS];
  // the launch's redshifts: a = 1 / (1 + z), r^2, r^3, r^4 (r = a / a_in)
  double av[MAX_Z], r2[MAX_Z], r3[MAX_Z], r4[MAX_Z];
  double sv_w[4];
  double a_in, h0h, c_rho_gam, c_nu_hot;
  // B lanes of S redshifts; this launch s0 .. s0 + n - 1; sv_i0 < 0:
  // sigma_v^2 at k index 0, else the 4 points sv_i0.. with sv_w
  int B, S, s0, n, nk, nz, nn, nfam, sv_i0, layout, ncol;
  // the plan: blocks of a cluster (a pair's), 32-point chunks a block,
  // chunks a pass, the tile's row pitch (ncol, made odd)
  int cluster, chunks, pass_chunks, pitch;
};

// A layout's column groups: each one's first column, -1 where the layout
// has none or prints it as zeros (the zero ranges z0, z1)
struct Plan {
  int k = 0, lin = -1, p = -1, a = -1, i = -1, pb = -1, pt = -1, q = -1;
  bool pb_bias = false, pt_bias = false;
  int z0 = 0, zn0 = 0, z1 = 0, zn1 = 0;
};

__device__ __forceinline__ void g_k(Plan& c, int col) { c.k = col; }
__device__ __forceinline__ void g_lin(Plan& c, int col) { c.lin = col; }
__device__ __forceinline__ void g_p(Plan& c, int col) { c.p = col; }
__device__ __forceinline__ void g_a(Plan& c, int col) { c.a = col; }
__device__ __forceinline__ void g_i(Plan& c, int col) { c.i = col; }
__device__ __forceinline__ void g_pb_bias(Plan& c, int col) {
  c.pb = col;
  c.pb_bias = true;
}
__device__ __forceinline__ void g_pb_sum(Plan& c, int col) { c.pb = col; }
__device__ __forceinline__ void g_pt_bias(Plan& c, int col) {
  c.pt = col;
  c.pt_bias = true;
}
__device__ __forceinline__ void g_pt_sum(Plan& c, int col) { c.pt = col; }
__device__ __forceinline__ void g_q(Plan& c, int col) { c.q = col; }
__device__ __forceinline__ void g_zero(Plan& c, int col, int n) {
  if (c.zn0 == 0) {
    c.z0 = col;
    c.zn0 = n;
  } else {
    c.z1 = col;
    c.zn1 = n;
  }
}

// One thread's view for the traced programs: its (lane, redshift)'s rows
// at its k point
struct Ctx {
  const double *Y, *JW, *PZ;     // ys, Jw, PZw at row 0 and the thread's k
  double k, jlo;
  int nk, pitch;
  bool valid;
};

// The generated code's vocabulary (kernels/out_block.py out_source)
#define LD_Y(r) (c.valid ? __ldg(c.Y + (size_t)(r) * (size_t)c.nk) : 0.0)
#define LD_JW(r) \
  (c.valid ? __ldg(c.JW + (size_t)(r) * (size_t)c.pitch) : 0.0)
#define LD_PZ(r) (c.valid ? __ldg(c.PZ + (size_t)(r) * (size_t)c.nk) : 0.0)
#define JLO_ (c.jlo)
#define K_ (c.k)
#define DIVC_(x, d) __dmul_rn((x), 1.0 / (d))

#include "out_block_gen.cuh"   // a_rows, pt_pmr_rows, pbis_rows, columns

// w[m] for a thread's own m (a dynamic index would put w in local memory)
__device__ __forceinline__ double pick4(const double (&w)[4], int m) {
  return m == 0 ? w[0] : m == 1 ? w[1] : m == 2 ? w[2] : w[3];
}

#if OB_DROP & 4
#define RUN_PROGRAM(name, n) \
  for (int j_ = 0; j_ < (n); ++j_) o[j_] = c.k
#else
#define RUN_PROGRAM(name, n) name(c, o)
#endif

// A pair's scalars, computed once by rank 0's scalar warps and stored
// into every block of the cluster: the growth bracket at ln a (i0 and
// weights), the beta brackets at a, 1, min(1, a 1.001), a 0.999, f_nu and
// the power's norm
struct Scal {
  double wg[4];
  double wb[4][4];
  double f_nu, norm;
  int ig, ib[4];
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// x into `field` of every block of the cluster (ranks 0 .. C - 1)
template <class T>
__device__ __forceinline__ void push(T* field, T x, int C) {
  if (C == 1) {
    *field = x;
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  for (int r = 0; r < C; ++r) *cluster.map_shared_rank(field, r) = x;
}

// The scalars' hand-over, where the layout prints lin.  A pair of one
// block: two named barriers over the scalar and the lin warps (`count`
// threads), BAR_INDEX once the brackets' first nodes are in shared memory
// (so the lin warps start their row loads while the weights are
// computed), BAR_SCALARS once the weights are too; a cluster: phase 1 of
// the cluster's barrier (see the kernel) once all of them are in every
// block.
__device__ __forceinline__ void publish_index(int C, int count) {
  if (C == 1) bar_arrive(BAR_INDEX, count);
}
__device__ __forceinline__ void publish(int C, int count) {
  if (C > 1) {
    cluster_arrive_release();
  } else {
    bar_arrive(BAR_SCALARS, count);
  }
}

// D at k index kk of lane b's growth table on the bracket (the rows'
// 4-node sum times a over Dnorm, model.growth_at's order)
__device__ __forceinline__ double growth_D(const Args& a, int b, int kk,
                                           const Bracket& r, double av) {
  const size_t nk = a.nk;
  double v[4];
  rows4(true, a.nk, r, a.p[P_GG] + (size_t)b * a.nn * nk + kk, true, v);
  return __ddiv_rn(__dmul_rn(dot4_chunks(r, v), av),
                   __ldg(a.p[P_GDN] + (size_t)b * nk + kk));
}

// H = sqrt(H^2/H0^2) H0 at a = x (every thread of the warp; thread 0
// stores it), the plain version's bg.derived and H2_H02 in their order (a
// ** 3 is a * a * a, a ** 4, T_cmb ** 4 and a ** e_pow CUDA's pow, one
// each on threads 0-3 with the exp)
__device__ __forceinline__ void lane_h(const Args& a, int b, size_t lz,
                                       double x, double Om, double f_nu) {
  const int t = threadIdx.x & 31;
  const double h = __ldg(a.p[P_H] + b), T = __ldg(a.p[P_TCMB] + b);
  const double w0 = __ldg(a.p[P_W0] + b), wa = __ldg(a.p[P_WA] + b);
  const double e_pow = __dmul_rn(-3.0, __dadd_rn(__dadd_rn(1.0, w0), wa));
  // thread 0 T_cmb^4, 1 a^e_pow, 2 exp(-3 wa (1 - a)), 3 a^4
  const double mine =
      t == 2 ? exp(__dmul_rn(__dmul_rn(-3.0, wa), __dsub_rn(1.0, x)))
             : pow(t == 0 ? T : x, t == 1 ? e_pow : 4.0);
  const double T4 = piece(mine, 0), aE = piece(mine, 1);
  const double ex = piece(mine, 2), a4 = piece(mine, 3);
  if (t != 0) return;
  const double Og = __ddiv_rn(__dmul_rn(a.c_rho_gam, T4), __dmul_rn(h, h));
  const double f_cb = __dsub_rn(1.0, f_nu);
  const double On_hot = __dmul_rn(a.c_nu_hot, Og);
  const double a_nu =
      __ddiv_rn(On_hot, __dadd_rn(__dmul_rn(f_nu, Om), 1e-15));
  const double Or = __dadd_rn(Og, __dmul_rn(On_hot, a_nu > 1.0 ? 1.0 : 0.0));
  const double OL = __dsub_rn(__dsub_rn(1.0, Om), Or);
  const double fcb_om = __dmul_rn(f_cb, Om);
  const double a3 = __dmul_rn(__dmul_rn(x, x), x);
  const double E = __dmul_rn(aE, ex);
  const double Y = x >= a_nu ? __ddiv_rn(f_nu, f_cb)
                             : __ddiv_rn(On_hot, __dmul_rn(fcb_om, x));
  const double H2 = __dadd_rn(
      __dadd_rn(__ddiv_rn(__dmul_rn(fcb_om, __dadd_rn(1.0, Y)), a3),
                __dmul_rn(OL, E)),
      __ddiv_rn(Og, a4));
  const_cast<double*>(a.p[P_HOUT])[lz] = __dmul_rn(sqrt(H2), a.h0h);
}

// Scalar warp 0: the growth bracket at ln a (model.growth_at), f_nu and
// the power's norm into the cluster (where the layout prints lin), then
// sigma_v^2 = Dv^2 sigma_v^2(z = 0), Dv = D at k = 1e-3 (k index 0, or
// sv_w over 4 points on 4 threads, summed in order), then H
__device__ __forceinline__ void scalar_growth(const Args& a, Scal& sc,
                                              const Nodes& h, int b,
                                              size_t lz, double av,
                                              bool lin, int count) {
  const int t = threadIdx.x & 31;
  const double* glna = a.p[P_GLNA] + (size_t)b * a.nn;
  const double Om = __ldg(a.p[P_OM] + b), Onu = __ldg(a.p[P_ONU] + b);
  const double norm = __ldg(a.p[P_NORM] + b);
  const double lx = log(av);
  Bracket rg = place(count_below(h, glna, a.nn, lx), a.nn);
  if (lin && a.cluster == 1) {
    if (t == 0) sc.ig = rg.i0;
    publish_index(a.cluster, count);
  }
  weights(rg, glna, a.nn, lx, true);
  const double f_nu = __ddiv_rn(Onu, Om);
  if (lin) {
    if (a.cluster > 1) {
      cluster_wait();                        // every block has started
      if (t == 0) push(&sc.ig, rg.i0, a.cluster);
    }
    if (t < 4) push(&sc.wg[t], pick4(rg.w, t), a.cluster);
    if (t == 4) push(&sc.f_nu, f_nu, a.cluster);
    if (t == 5) push(&sc.norm, norm, a.cluster);
    publish(a.cluster, count);
  }
  const bool four = a.sv_i0 >= 0;
  const double gd = t < (four ? 4 : 1)
                        ? growth_D(a, b, four ? a.sv_i0 + t : 0, rg, av)
                        : 0.0;
  double Dv = piece(gd, 0);
  if (four) {
    Dv = 0.0;
#pragma unroll
    for (int j = 0; j < 4; ++j) Dv = __fma_rn(a.sv_w[j], piece(gd, j), Dv);
  }
  if (t == 0) {
    const_cast<double*>(a.p[P_SV2])[lz] =
        __dmul_rn(__dmul_rn(Dv, Dv), __ldg(a.p[P_SV0] + b));
  }
  lane_h(a, b, lz, av, Om, f_nu);
}

// Scalar warps 1 and 2: beta_P's brackets at min(x, 1) for x = a, 1
// (half 0) or min(1, a 1.001), a 0.999 (half 1) (model.beta_P_at) on lane
// b's beta nodes, thread group g (threads 4g .. 4g + 3) weighing x_g,
// into the cluster as brackets 2 half + g
__device__ __forceinline__ void scalar_beta(const Args& a, Scal& sc,
                                            const Nodes& h, int b,
                                            double av, int half,
                                            int count) {
  const int t = threadIdx.x & 31;
  const int nzb = max(a.nz, 4);
  const double* beta_a = a.p[P_BA] + (size_t)b * a.nz;
  const double aR1 = __dmul_rn(av, 1.001);
  const double aL = __dmul_rn(av, 0.999);
  // half 0: a (min(a, 1)), 1; half 1: min(1.0, a 1.001), min(a 0.999, 1)
  const double x0 = half == 0 ? (av > 1.0 ? 1.0 : av)
                              : (aR1 < 1.0 ? aR1 : 1.0);
  const double x1 = half == 0 ? 1.0 : (aL > 1.0 ? 1.0 : aL);
  const Bracket r0 = place(count_below(h, beta_a, a.nz, x0), nzb);
  const Bracket r1 = place(count_below(h, beta_a, a.nz, x1), nzb);
  if (a.cluster == 1) {
    if (t == 0) {
      sc.ib[2 * half] = r0.i0;
      sc.ib[2 * half + 1] = r1.i0;
    }
    publish_index(a.cluster, count);
  }
  const int g = min(t >> 2, 1);
  Bracket r;   // the group's, field by field (a struct select goes local)
  r.i0 = g == 0 ? r0.i0 : r1.i0;
  r.n = g == 0 ? r0.n : r1.n;
  weights_at(r, beta_a, nzb, g == 0 ? x0 : x1, true, 4 * g);
  const int i = 2 * half + g;
  if (a.cluster > 1) {
    cluster_wait();
    if (t < 8 && (t & 3) == 0) push(&sc.ib[i], r.i0, a.cluster);
  }
  if (t < 8) push(&sc.wb[i][t & 3], pick4(r.w, t & 3), a.cluster);
  publish(a.cluster, count);
}


// The lin group at k index kk into the tile row: D, f, P_cb, beta /
// (beta(1) + 1e-100), dln beta / dln a, P_nu, the plain version's
// print_lin block and model.plin_at in their order.  k^n_s, T, k and
// Dnorm are read before the wait for the lookups.
__device__ __forceinline__ void lin_unit(const Args& a, const Scal& sc,
                                         int b, int kk, double av,
                                         double* row, int col, bool wait,
                                         int count) {
  const int nk = a.nk;
  const bool valid = kk < nk;
  const double k = valid ? __ldg(a.p[P_K] + kk) : 1.0;
  const double T = valid ? __ldg(a.p[P_T] + (size_t)b * nk + kk) : 0.0;
  const double dn = valid ? __ldg(a.p[P_GDN] + (size_t)b * nk + kk) : 1.0;
  const double kn = pow(k, __ldg(a.p[P_NS] + b));
  if (wait) {
    if (a.cluster > 1) {
      cluster_wait();
    } else {
      bar_sync(BAR_INDEX, count);
    }
  }
  // the rows at the brackets' first nodes, loaded while the weights are
  // computed
  Bracket rg, rb[4];
  rg.i0 = sc.ig;
  double vG[4], vD[4], vb[4][4];
  const size_t gro = (size_t)b * a.nn * nk + kk;
  rows4(valid, nk, rg, a.p[P_GG] + gro, true, vG);
  rows4(valid, nk, rg, a.p[P_GD] + gro, true, vD);
  const bool has = a.nz > 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rb[i].i0 = has ? sc.ib[i] : 0;
    rows4(valid, nk, rb[i], a.p[P_BS] + (size_t)b * a.nz * nk + kk, has,
          vb[i]);
  }
  if (wait && a.cluster == 1) bar_sync(BAR_SCALARS, count);
#pragma unroll
  for (int m = 0; m < 4; ++m) rg.w[m] = sc.wg[m];
  const double f_nu = sc.f_nu;
  double bv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int m = 0; m < 4; ++m) rb[i].w[m] = has ? sc.wb[i][m] : 0.0;
    bv[i] = !has            ? 0.0
            : f_nu < 1e-10 ? 0.0
                           : __dmul_rn(f_nu, dot4_pairs(rb[i], vb[i]));
  }
  const double beta = bv[0], b1 = bv[1], bR = bv[2], bL = bv[3];
  const double D = __ddiv_rn(__dmul_rn(dot4_chunks(rg, vG), av), dn);
  const double dDda = __ddiv_rn(dot4_chunks(rg, vD), dn);
  const double aL = __dmul_rn(av, 0.999);
  const double aR1 = __dmul_rn(av, 1.001);
  const double aR = aR1 < 1.0 ? aR1 : 1.0;          // min(1.0, a 1.001)
  const double f = __ddiv_rn(__dmul_rn(dDda, av), D);
  const double F = __dadd_rn(__dsub_rn(1.0, f_nu), beta);
  double P = __dmul_rn(sc.norm, kn);
  P = __dmul_rn(P, __dmul_rn(T, T));
  P = __dmul_rn(P, F);
  P = __dmul_rn(P, F);
  P = __dmul_rn(P, D);
  P = __dmul_rn(P, D);
  const bool massless = f_nu <= 1e-10;
  const double cb = __dadd_rn(__dsub_rn(1.0, f_nu), beta);
  const double Pcb = massless ? P : __ddiv_rn(P, __dmul_rn(cb, cb));
  const double R = __ddiv_rn(beta, __dadd_rn(__dmul_rn(f_nu, F), 1e-300));
  const double Pnu = massless ? 0.0 : __dmul_rn(__dmul_rn(P, R), R);
  // (beta(aR) - beta(aL)) / (aR - aL): a tensor over a Python float
  const double num = __dmul_rn(__dsub_rn(bR, bL),
                               __ddiv_rn(1.0, __dsub_rn(aR, aL)));
  const double dlnB = f_nu < 1e-10
                          ? 0.0
                          : __dmul_rn(__dmul_rn(__drcp_rn(beta), av), num);
  row[col] = D;
  row[col + 1] = f;
  row[col + 2] = Pcb;
  row[col + 3] = __ddiv_rn(beta, __dadd_rn(b1, 1e-100));
  row[col + 4] = dlnB;
  row[col + 5] = Pnu;
}

enum Unit { U_A, U_PT, U_PB, U_COPY };

// The ti-th unit kind of the layout, heaviest first: the A rows, P_T /
// P_MR, P_B, then the copy groups
__device__ __forceinline__ int unit_kind(const Plan& pl, int ti) {
  if (pl.a >= 0 && ti-- == 0) return U_A;
  if (pl.pt >= 0 && ti-- == 0) return U_PT;
  if (pl.pb >= 0 && ti-- == 0) return U_PB;
  return U_COPY;
}

// One unit at k index kk into the tile row
__device__ __forceinline__ void run_unit(const Args& a, const Plan& pl,
                                         int kind, size_t lz, int kk,
                                         double r2, double r3, double r4,
                                         double* row) {
  const int nk = a.nk;
  Ctx c;
  c.valid = kk < nk;
  c.nk = nk;
  c.pitch = nk + 1;
  c.Y = a.p[P_YS] + lz * NU * nk + kk;
  c.k = c.valid ? __ldg(a.p[P_K] + kk) : 1.0;
  c.JW = c.PZ = nullptr;
  c.jlo = 0.0;
  if (a.nfam > 0) {
    const double* jw = a.p[P_JW] + lz * 9 * a.nfam * (size_t)c.pitch;
    c.JW = jw + kk;
    c.jlo = __ldg(jw + nk);
    c.PZ = a.p[P_PZ] + lz * 63 * nk + kk;
  }
  switch (kind) {
    case U_A: {
      double o[NUI];
      RUN_PROGRAM(a_rows, NUI);
#pragma unroll
      for (int j = 0; j < NUI; ++j) row[pl.a + j] = o[j];
      break;
    }
    case U_PT: {
      double o[17];
      RUN_PROGRAM(pt_pmr_rows, 17);
      if (pl.pt_bias) {
#pragma unroll
        for (int j = 0; j < 17; ++j) row[pl.pt + j] = __dmul_rn(o[j], r4);
      } else {
        // trg._collapse_pt: PT2/4/6/8 = (PT0 + PT1) + PT2, (PT3 + PT4) +
        // PT5, PT6 + PT7, PT8, each times r^4
        row[pl.pt] = __dmul_rn(__dadd_rn(__dadd_rn(o[0], o[1]), o[2]), r4);
        row[pl.pt + 1] =
            __dmul_rn(__dadd_rn(__dadd_rn(o[3], o[4]), o[5]), r4);
        row[pl.pt + 2] = __dmul_rn(__dadd_rn(o[6], o[7]), r4);
        row[pl.pt + 3] = __dmul_rn(o[8], r4);
      }
      break;
    }
    case U_PB: {
      double o[5];
      RUN_PROGRAM(pbis_rows, 5);
#pragma unroll
      for (int j = 0; j < 5; ++j) o[j] = __dmul_rn(o[j], r3);
      if (pl.pb_bias) {
#pragma unroll
        for (int j = 0; j < 5; ++j) row[pl.pb + j] = o[j];
      } else {
        row[pl.pb] = __dadd_rn(o[0], o[1]);
        row[pl.pb + 1] = __dadd_rn(o[2], o[3]);
        row[pl.pb + 2] = o[4];
      }
      break;
    }
    default: {
      row[pl.k] = c.k;
#pragma unroll
      for (int r = 0; r < NUP; ++r)
        row[pl.p + r] = __dmul_rn(exp(LD_Y(r)), r2);
      if (pl.i >= 0) {
#pragma unroll
        for (int j = 0; j < NUI; ++j) row[pl.i + j] = LD_Y(NUP + j);
      }
      if (pl.q >= 0) {
#pragma unroll
        for (int j = 0; j < NUQ; ++j)
          row[pl.q + j] = __dmul_rn(LD_Y(NUP + NUI + j), r3);
      }
      for (int j = 0; j < pl.zn0; ++j) row[pl.z0 + j] = 0.0;
      for (int j = 0; j < pl.zn1; ++j) row[pl.z1 + j] = 0.0;
      break;
    }
  }
}

// The tile's nv rows to the table at `out`: element e of the rows' ncol
// doubles is tile[e + (pitch - ncol) (e / ncol)]; pairs on 16-byte
// addresses as one store each, the odd ends alone.  e / ncol is
// (e + 1/2) (1/ncol) in f32, cut: exact while the rounding error, below
// e 2^-23, stays under the 1/(2 ncol) that (e + 1/2) / ncol keeps from an
// integer (e < 25,600 = MAX_TILE's doubles at ncol <= 84;
// tests/test_torch_out_block.py checks every e)
__device__ __forceinline__ void store_tile(const double* tile, double* out,
                                           int nv, int ncol, int pitch) {
#if !(OB_DROP & 1)
  const int n = nv * ncol, pad = pitch - ncol;
  const int head = (int)((reinterpret_cast<uintptr_t>(out) >> 3) & 1);
  const float inv = 1.0f / (float)ncol;
  const auto at = [&](int e) {
    return tile[e + pad * (int)(((float)e + 0.5f) * inv)];
  };
  for (int e = head + 2 * (int)threadIdx.x; e + 1 < n;
       e += 2 * (int)blockDim.x) {
    *reinterpret_cast<double2*>(out + e) = make_double2(at(e), at(e + 1));
  }
  if (threadIdx.x == 0 && head && n > 0) out[0] = at(0);
  if (threadIdx.x == 0 && n > head && (n - head) % 2) out[n - 1] = at(n - 1);
#else
  (void)tile;
  (void)out;
  (void)nv;
  (void)ncol;
  (void)pitch;
#endif
}

__global__ void __launch_bounds__(MAX_BLOCK_THREADS)
    out_block_kernel(const Args a) {
  extern __shared__ double tile[];
  __shared__ Scal sc;
  __shared__ int next_unit;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int C = a.cluster;
  const int rank = (int)cg::this_cluster().block_rank();
  const unsigned pair = blockIdx.x / C;
  const int b = (int)(pair / a.n), s = (int)(pair - (unsigned)b * a.n);
  const size_t lz = (size_t)b * a.S + (a.s0 + s);   // (lane, redshift)
  const int nk = a.nk, nkt = (nk + KT - 1) / KT;
  const int c0 = rank * a.chunks, nch = min(a.chunks, nkt - c0);
  Plan pl;
  columns(a.layout, pl);
  const bool lin = pl.lin >= 0;
  // rank 0's scalar warps, the last S_WARPS: 0 the growth, f_nu, norm,
  // then sigma_v^2 and H, 1 the betas at a and 1, 2 the betas at min(1,
  // a 1.001) and a 0.999; their nodes are loaded first
  const int role = rank == 0 ? warp - (nw - S_WARPS) : -1;
  const bool betas = lin && a.nz > 0;
  const bool beta_warp = (role == 1 || role == 2) && betas;
  Nodes h{};
  if (role == 0) h = load_nodes(a.p[P_GLNA] + (size_t)b * a.nn, a.nn);
  if (beta_warp) h = load_nodes(a.p[P_BA] + (size_t)b * a.nz, a.nz);
  const double av = a.av[s], r2 = a.r2[s], r3 = a.r3[s], r4 = a.r4[s];
  if (threadIdx.x == 0) next_unit = 0;
  __syncthreads();
  // The scalars' hand-over, where the layout prints lin.  A pair of one
  // block: the scalar warps arrive at the named barriers BAR_INDEX and
  // BAR_SCALARS once they stored, the pass's first lin warps sync on them
  // (`count` threads: publish_index, publish).  A cluster: phase 0 of its
  // barrier, every block has started (the
  // scalar warps wait for it just before their remote stores), phase 1
  // the scalars are in every block (the scalar warps arrive after their
  // stores, the others now; the lin warps wait for it).  Every thread
  // arrives once a phase and waits for phase 0 before it arrives at 1.
  const bool scalar = role == 0 || beta_warp;
  const int nlin = min(a.pass_chunks, nch);   // pass 0's lin warps
  const int count = 32 * (1 + 2 * betas + nlin);
  if (lin && C > 1) {
    cluster_arrive_relaxed();
    if (!scalar) {
      cluster_wait();
      cluster_arrive_release();
    }
  }
  if (role == 0) scalar_growth(a, sc, h, b, lz, av, lin, count);
  if (beta_warp) scalar_beta(a, sc, h, b, av, role == 2, count);

  double* out = const_cast<double*>(a.p[P_TABLE]) + lz * nk * a.ncol;
  for (int p0 = 0; p0 < nch; p0 += a.pass_chunks) {
    const int np = min(a.pass_chunks, nch - p0);
    const int kb = (c0 + p0) * KT;            // the pass's first k
    if (lin && warp < np) {
      lin_unit(a, sc, b, kb + warp * KT + lane, av,
               tile + (warp * KT + lane) * a.pitch, pl.lin, p0 == 0, count);
    }
    const int nunits =
        (1 + (pl.a >= 0) + (pl.pt >= 0) + (pl.pb >= 0)) * np;
    for (;;) {
      int u = 0;
      if (lane == 0) u = atomicAdd(&next_unit, 1);
      u = __shfl_sync(0xffffffffu, u, 0);
      if (u >= nunits) break;
      const int ti = u / np, j = u - ti * np;
      run_unit(a, pl, unit_kind(pl, ti), lz, kb + j * KT + lane, r2, r3, r4,
               tile + (j * KT + lane) * a.pitch);
    }
    __syncthreads();
    store_tile(tile, out + (size_t)kb * a.ncol, min(np * KT, nk - kb),
               a.ncol, a.pitch);
    if (p0 + a.pass_chunks < nch) {
      if (threadIdx.x == 0) next_unit = 0;
      __syncthreads();
    }
  }
}

}  // namespace

// ptrs[N_POINTERS] (read here, at the call): ys [B, S, 41, nk], k [nk];
// n_s, h, Omega_m, Omega_nu, T_cmb, w0, wa, norm, sigmaV2_z0 [B];
// T_solver [B, nk], beta_a [B, nz], beta_solver [B, nz, nk], g_lna [B,
// nn], g_G, g_dDda [B, nn, nk], g_Dnorm [B, nk]; Jw [B S, nfam, 3, 3, nk +
// 1] and PZw [B S, 7, 3, 3, nk] (nfam 7 or 14; null and nfam 0 where the
// layout takes no engine); the outputs table [B, S, nk, ncol], sigma_v2
// and H [B, S]; all f64, contiguous, on the current device.  av, r2, r3,
// r4: of the n <= MAX_Z redshifts s0 .. s0 + n - 1 of this launch, a = 1
// / (1 + z) and r^2, r^3, r^4 of r = a / a_in (the host's, as the plain
// version's); sv_w, sv_i0: sigma_v^2's interpolation (sv_i0 < 0: k
// index 0).  layout: the index of kernels/out_block.py LAYOUTS, ncol its
// columns.  The plan (out_block.launch_plan): clusters of `cluster`
// blocks a (lane, redshift), each `chunks` chunks of 32 k points (the
// last block of a cluster may have fewer, none none), `pass_chunks` a
// pass; blocks of `threads` (a multiple of 32, at most
// MAX_BLOCK_THREADS, S_WARPS warps more than pass_chunks).
extern "C" int rt_out_block(const double* const* ptrs, int nptrs,
                            const double* av, const double* r2,
                            const double* r3, const double* r4,
                            const double* sv_w,
                            double a_in, double h0h, double c_rho_gam,
                            double c_nu_hot, int B, int S, int s0, int n,
                            int nk, int nz, int nn, int nfam, int sv_i0,
                            int layout, int ncol, int cluster, int chunks,
                            int pass_chunks, int threads, void* stream) {
  const int nkt = (nk + KT - 1) / KT;
  const int pitch = ncol | 1;
  const size_t smem = (size_t)pass_chunks * KT * pitch * sizeof(double);
  if (nptrs != N_POINTERS || n < 1 || n > MAX_Z || s0 < 0 || s0 + n > S ||
      B < 1 || nk < 1 || layout < 0 || layout >= N_LAYOUTS ||
      LAYOUT_NCOL[layout] != ncol || (nz > 0 && nz < 4) || nn < 4 ||
      (nfam != 0 && nfam != 7 && nfam != 14) || sv_i0 > nk - 4 ||
      cluster < 1 || cluster > MAX_CLUSTER || chunks < 1 ||
      (cluster - 1) * chunks >= nkt || cluster * chunks < nkt ||
      pass_chunks < 1 || pass_chunks > chunks || threads % 32 != 0 ||
      threads > MAX_BLOCK_THREADS || pass_chunks + S_WARPS > threads / 32 ||
      smem > MAX_TILE) {
    return cudaErrorInvalidValue;
  }
  // the tile's shared memory above 48 KB, once a device
  static unsigned long long smem_set = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64 && !(smem_set >> dev & 1ull)) {
    e = cudaFuncSetAttribute(out_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_TILE);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set |= 1ull << dev;
  }
  Args a;
  for (int i = 0; i < N_POINTERS; ++i) a.p[i] = ptrs[i];
  for (int i = 0; i < MAX_Z; ++i) {
    a.av[i] = i < n ? av[i] : 0.0;
    a.r2[i] = i < n ? r2[i] : 0.0;
    a.r3[i] = i < n ? r3[i] : 0.0;
    a.r4[i] = i < n ? r4[i] : 0.0;
  }
  for (int i = 0; i < 4; ++i) a.sv_w[i] = sv_w[i];
  a.a_in = a_in;
  a.h0h = h0h;
  a.c_rho_gam = c_rho_gam;
  a.c_nu_hot = c_nu_hot;
  a.B = B;
  a.S = S;
  a.s0 = s0;
  a.n = n;
  a.nk = nk;
  a.nz = nz;
  a.nn = nn;
  a.nfam = nfam;
  a.sv_i0 = sv_i0;
  a.layout = layout;
  a.ncol = ncol;
  a.cluster = cluster;
  a.chunks = chunks;
  a.pass_chunks = pass_chunks;
  a.pitch = pitch;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * n * cluster));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, out_block_kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
