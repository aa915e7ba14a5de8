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
// The traced programs and the layouts' column switch are generated
// (out_block_gen.cuh, written at build time by kernels/out_block.py
// out_source): the A rows (assembly.ar_rows), P_T / P_MR
// (assembly.pt_pmr_rows) and P_B (trg.pbis_rows), each traced operation
// one IEEE operation in traced order (A and P_T are small differences of
// terms up to ~1e4 larger: another order moves them by ~1e-12 of their
// scale); a division by a constant is x * (1/c), as torch's CUDA kernels
// divide by a scalar; one case a column layout, which writes the
// layout's groups at their first columns.
//
// The design is the simple one: a task is one (lane, redshift) at KT = 32
// k points on one warp, the warp computing the lookups together (the
// bracketing and weights of csrc/lookups.cuh, K8's), each thread its k
// point's columns and writing them straight to the table (a thread's
// columns are contiguous; the warp's stores are ncol apart).  The A rows
// and P_T / P_MR are functions of their own, called from the layouts that
// print them, so the switch's cases stay short.
//
// Semantics kept from the plain version (kernels/out_block.py
// out_block_plain): every operation __d*_rn in its order; torch's CUDA
// powers (x ** 2 is x * x, x ** 3 x * x * x, x ** 4 and tensor exponents
// pow; r ** 3, r ** 4 of the Python floats come from the host, as the
// plain version computes them); a NaN state gives NaN columns; the
// lookups sum their 4 nodes in K8's orders (dot4_pairs for beta,
// dot4_chunks for the growth).
#include <cuda_runtime.h>

#include <cstddef>

#include "lookups.cuh"

namespace {

using namespace rt_lookup;

constexpr int KT = 32;                 // k points a task (a warp's lanes)
constexpr int NU = 41;                 // state rows
constexpr int NUP = 3, NUI = 14, NUQ = 24;
constexpr int MAX_Z = 64;              // redshifts a launch
constexpr int MAX_BLOCK_THREADS = 256;

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
  double z[MAX_Z], r3[MAX_Z], r4[MAX_Z];   // the launch's redshifts
  double sv_w[4];
  double a_in, h0h, c_rho_gam, c_nu_hot;
  // B lanes of S redshifts; this launch s0 .. s0 + n - 1; sv_i0 < 0:
  // sigma_v^2 at k index 0, else the 4 points sv_i0.. with sv_w
  int B, S, s0, n, nk, nz, nn, nfam, sv_i0, layout, ncol;
};

// One thread's view: its (lane, redshift)'s rows at its k point and the
// values the column groups read
struct Ctx {
  const double *Y, *JW, *PZ;     // ys, Jw, PZw at row 0 and the thread's k
  const double *beta_a, *BS;     // the lane's beta nodes; beta_solver row 0
  const double* T;               // T_solver at k
  double* out;                   // the table row's column 0
  double k, z, a, r2, r3, r4, jlo;
  double D, dDda;                // growth at k
  double f_nu, norm, n_s;
  int nk, nz, pitch;
  bool valid;
};

__device__ __forceinline__ void put(const Ctx& c, int col, double v) {
  if (c.valid) c.out[col] = v;
}

// The generated code's vocabulary (kernels/out_block.py out_source)
#define LD_Y(r) (c.valid ? __ldg(c.Y + (size_t)(r) * (size_t)c.nk) : 0.0)
#define LD_JW(r) \
  (c.valid ? __ldg(c.JW + (size_t)(r) * (size_t)c.pitch) : 0.0)
#define LD_PZ(r) (c.valid ? __ldg(c.PZ + (size_t)(r) * (size_t)c.nk) : 0.0)
#define JLO_ (c.jlo)
#define K_ (c.k)
#define DIVC_(x, d) __dmul_rn((x), 1.0 / (d))

// the column groups, each writing its columns from `col` on
__device__ __forceinline__ void g_k(const Ctx& c, int col);
__device__ __noinline__ void g_lin(const Ctx& c, int col);
__device__ __forceinline__ void g_p(const Ctx& c, int col);
__device__ __noinline__ void g_a(const Ctx& c, int col);
__device__ __forceinline__ void g_i(const Ctx& c, int col);
__device__ __noinline__ void g_pb_bias(const Ctx& c, int col);
__device__ __noinline__ void g_pt_bias(const Ctx& c, int col);
__device__ __noinline__ void g_pb_sum(const Ctx& c, int col);
__device__ __noinline__ void g_pt_sum(const Ctx& c, int col);
__device__ __forceinline__ void g_q(const Ctx& c, int col);
__device__ __forceinline__ void g_zero(const Ctx& c, int col, int n);

#include "out_block_gen.cuh"   // a_rows, pt_pmr_rows, pbis_rows, columns

__device__ __forceinline__ void g_k(const Ctx& c, int col) {
  put(c, col, c.k);
}

// beta_P at x, as model.beta_P_at: min(x, 1) (a NaN stays NaN) on the
// lane's table, f_nu times the 4-node sum, 0 below f_nu = 1e-10 or with
// no table (nz = 0)
__device__ __forceinline__ double beta_at(const Ctx& c, const Nodes& h,
                                          double x) {
  const bool has = c.nz > 0;
  const int nzb = max(c.nz, 4);
  const double xc = x > 1.0 ? 1.0 : x;
  Bracket r = place(count_below(h, c.beta_a, c.nz, xc), nzb);
  double v[4];
  rows4(c.valid, c.nk, r, c.BS, has, v);
  weights(r, c.beta_a, nzb, xc, has);
  return !has            ? 0.0
         : c.f_nu < 1e-10 ? 0.0
                          : __dmul_rn(c.f_nu, dot4_pairs(r, v));
}

// D, f, P_cb, beta / (beta(1) + 1e-100), dln beta / dln a, P_nu: the
// plain version's print_lin block and model.plin_at, in their order
__device__ __noinline__ void g_lin(const Ctx& c, int col) {
  const Nodes h = load_nodes(c.beta_a, c.nz);
  const double a = c.a;
  const double aL = __dmul_rn(a, 0.999);
  const double aR1 = __dmul_rn(a, 1.001);
  const double aR = aR1 < 1.0 ? aR1 : 1.0;          // min(1.0, a 1.001)
  const double beta = beta_at(c, h, a);
  const double b1 = beta_at(c, h, 1.0);
  const double bR = beta_at(c, h, aR);
  const double bL = beta_at(c, h, aL);
  const double D = c.D;
  const double f = __ddiv_rn(__dmul_rn(c.dDda, a), D);
  const double F = __dadd_rn(__dsub_rn(1.0, c.f_nu), beta);
  const double T = c.valid ? __ldg(c.T) : 0.0;
  double P = __dmul_rn(c.norm, pow(c.k, c.n_s));
  P = __dmul_rn(P, __dmul_rn(T, T));
  P = __dmul_rn(P, F);
  P = __dmul_rn(P, F);
  P = __dmul_rn(P, D);
  P = __dmul_rn(P, D);
  const bool massless = c.f_nu <= 1e-10;
  const double cb = __dadd_rn(__dsub_rn(1.0, c.f_nu), beta);
  const double Pcb = massless ? P : __ddiv_rn(P, __dmul_rn(cb, cb));
  const double R =
      __ddiv_rn(beta, __dadd_rn(__dmul_rn(c.f_nu, F), 1e-300));
  const double Pnu = massless ? 0.0 : __dmul_rn(__dmul_rn(P, R), R);
  // (beta(aR) - beta(aL)) / (aR - aL): a tensor over a Python float
  const double num = __dmul_rn(__dsub_rn(bR, bL),
                               __ddiv_rn(1.0, __dsub_rn(aR, aL)));
  const double dlnB = c.f_nu < 1e-10
                          ? 0.0
                          : __dmul_rn(__dmul_rn(__drcp_rn(beta), a), num);
  put(c, col, D);
  put(c, col + 1, f);
  put(c, col + 2, Pcb);
  put(c, col + 3, __ddiv_rn(beta, __dadd_rn(b1, 1e-100)));
  put(c, col + 4, dlnB);
  put(c, col + 5, Pnu);
}

__device__ __forceinline__ void g_p(const Ctx& c, int col) {
#pragma unroll
  for (int r = 0; r < NUP; ++r) put(c, col + r, __dmul_rn(exp(LD_Y(r)), c.r2));
}

__device__ __noinline__ void g_a(const Ctx& c, int col) {
  double o[NUI];
  a_rows(c, o);
#pragma unroll
  for (int j = 0; j < NUI; ++j) put(c, col + j, o[j]);
}

__device__ __forceinline__ void g_i(const Ctx& c, int col) {
#pragma unroll
  for (int j = 0; j < NUI; ++j) put(c, col + j, LD_Y(NUP + j));
}

__device__ __noinline__ void g_pb_bias(const Ctx& c, int col) {
  double o[5];
  pbis_rows(c, o);
#pragma unroll
  for (int j = 0; j < 5; ++j) put(c, col + j, __dmul_rn(o[j], c.r3));
}

__device__ __noinline__ void g_pb_sum(const Ctx& c, int col) {
  double o[5];
  pbis_rows(c, o);
#pragma unroll
  for (int j = 0; j < 5; ++j) o[j] = __dmul_rn(o[j], c.r3);
  put(c, col, __dadd_rn(o[0], o[1]));
  put(c, col + 1, __dadd_rn(o[2], o[3]));
  put(c, col + 2, o[4]);
}

__device__ __noinline__ void g_pt_bias(const Ctx& c, int col) {
  double o[17];
  pt_pmr_rows(c, o);
#pragma unroll
  for (int j = 0; j < 17; ++j) put(c, col + j, __dmul_rn(o[j], c.r4));
}

// trg._collapse_pt: PT2/4/6/8 = (PT0 + PT1) + PT2, (PT3 + PT4) + PT5,
// PT6 + PT7, PT8, each times r^4
__device__ __noinline__ void g_pt_sum(const Ctx& c, int col) {
  double o[17];
  pt_pmr_rows(c, o);
  put(c, col, __dmul_rn(__dadd_rn(__dadd_rn(o[0], o[1]), o[2]), c.r4));
  put(c, col + 1, __dmul_rn(__dadd_rn(__dadd_rn(o[3], o[4]), o[5]), c.r4));
  put(c, col + 2, __dmul_rn(__dadd_rn(o[6], o[7]), c.r4));
  put(c, col + 3, __dmul_rn(o[8], c.r4));
}

__device__ __forceinline__ void g_q(const Ctx& c, int col) {
#pragma unroll
  for (int j = 0; j < NUQ; ++j)
    put(c, col + j, __dmul_rn(LD_Y(NUP + NUI + j), c.r3));
}

__device__ __forceinline__ void g_zero(const Ctx& c, int col, int n) {
  for (int j = 0; j < n; ++j) put(c, col + j, 0.0);
}

// D at k index kk of lane b's growth table on the warp's bracket (the
// rows' 4-node sum times a over Dnorm, model.growth_at's order)
__device__ __forceinline__ double growth_D(const Args& a, int b, int kk,
                                           const Bracket& r, double ag) {
  const size_t nk = a.nk;
  double v[4];
  rows4(true, a.nk, r, a.p[P_GG] + (size_t)b * a.nn * nk + kk, true, v);
  return __ddiv_rn(__dmul_rn(dot4_chunks(r, v), ag),
                   __ldg(a.p[P_GDN] + (size_t)b * nk + kk));
}

// sigma_v^2 = Dv^2 sigma_v^2(z=0) (Dv: D at k = 1e-3) and H = sqrt(H^2/
// H0^2) H0 at a, the plain version's bg.derived, H2_H02 and sigma_v2 in
// their order (a ** 3 is a * a * a, a ** 4, T_cmb ** 4 and a ** e_pow
// CUDA's pow)
__device__ void lane_outputs(const Args& a, const Ctx& c, int b,
                             size_t lz, const Bracket& rg) {
  double Dv = c.D;
  if (a.sv_i0 >= 0) {
    Dv = 0.0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Dv = __fma_rn(a.sv_w[j], growth_D(a, b, a.sv_i0 + j, rg, c.a), Dv);
  }
  const_cast<double*>(a.p[P_SV2])[lz] =
      __dmul_rn(__dmul_rn(Dv, Dv), __ldg(a.p[P_SV0] + b));

  const double h = __ldg(a.p[P_H] + b), Om = __ldg(a.p[P_OM] + b);
  const double Onu = __ldg(a.p[P_ONU] + b), T = __ldg(a.p[P_TCMB] + b);
  const double w0 = __ldg(a.p[P_W0] + b), wa = __ldg(a.p[P_WA] + b);
  const double Og =
      __ddiv_rn(__dmul_rn(a.c_rho_gam, pow(T, 4.0)), __dmul_rn(h, h));
  const double f_nu = __ddiv_rn(Onu, Om);
  const double f_cb = __dsub_rn(1.0, f_nu);
  const double On_hot = __dmul_rn(a.c_nu_hot, Og);
  const double a_nu =
      __ddiv_rn(On_hot, __dadd_rn(__dmul_rn(f_nu, Om), 1e-15));
  const double Or = __dadd_rn(Og, __dmul_rn(On_hot, a_nu > 1.0 ? 1.0 : 0.0));
  const double OL = __dsub_rn(__dsub_rn(1.0, Om), Or);
  const double fcb_om = __dmul_rn(f_cb, Om);
  const double x = c.a;
  const double a3 = __dmul_rn(__dmul_rn(x, x), x);
  const double e_pow = __dmul_rn(-3.0, __dadd_rn(__dadd_rn(1.0, w0), wa));
  const double E = __dmul_rn(
      pow(x, e_pow), exp(__dmul_rn(__dmul_rn(-3.0, wa), __dsub_rn(1.0, x))));
  const double Y = x >= a_nu ? __ddiv_rn(f_nu, f_cb)
                             : __ddiv_rn(On_hot, __dmul_rn(fcb_om, x));
  const double H2 = __dadd_rn(
      __dadd_rn(__ddiv_rn(__dmul_rn(fcb_om, __dadd_rn(1.0, Y)), a3),
                __dmul_rn(OL, E)),
      __ddiv_rn(Og, pow(x, 4.0)));
  const_cast<double*>(a.p[P_HOUT])[lz] = __dmul_rn(sqrt(H2), a.h0h);
}

__global__ void __launch_bounds__(MAX_BLOCK_THREADS)
    out_block_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  // 32-bit task numbers (the wrapper's launches stay far below 2^31)
  const unsigned ntiles = (a.nk + KT - 1) / KT;
  const unsigned task = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const unsigned pair = task / ntiles;
  if (pair >= (unsigned)a.B * (unsigned)a.n) return;   // the whole warp
  const int b = (int)(pair / a.n), s = (int)(pair - (unsigned)b * a.n);
  const int tile = (int)(task - pair * ntiles);
  const int nk = a.nk, kk = tile * KT + lane;
  const size_t lz = (size_t)b * a.S + (a.s0 + s);   // (lane, redshift)
  Ctx c;
  c.valid = kk < nk;
  c.nk = nk;
  c.nz = a.nz;
  c.pitch = nk + 1;
  c.Y = a.p[P_YS] + lz * NU * nk + kk;
  c.out = const_cast<double*>(a.p[P_TABLE]) + (lz * nk + kk) * a.ncol;
  c.k = c.valid ? __ldg(a.p[P_K] + kk) : 1.0;
  c.z = a.z[s];
  c.a = __ddiv_rn(1.0, __dadd_rn(1.0, c.z));       // torch.reciprocal
  const double r = __ddiv_rn(c.a, a.a_in);
  c.r2 = __dmul_rn(r, r);
  c.r3 = a.r3[s];
  c.r4 = a.r4[s];
  c.JW = c.PZ = nullptr;
  c.jlo = 0.0;
  if (a.nfam > 0) {
    const double* jw = a.p[P_JW] + lz * 9 * a.nfam * (size_t)c.pitch;
    c.JW = jw + kk;
    c.jlo = __ldg(jw + nk);
    c.PZ = a.p[P_PZ] + lz * 63 * nk + kk;
  }
  c.beta_a = a.p[P_BA] + (size_t)b * a.nz;
  c.BS = a.p[P_BS] + (size_t)b * a.nz * nk + kk;
  c.T = a.p[P_T] + (size_t)b * nk + kk;
  c.f_nu = __ddiv_rn(__ldg(a.p[P_ONU] + b), __ldg(a.p[P_OM] + b));
  c.norm = __ldg(a.p[P_NORM] + b);
  c.n_s = __ldg(a.p[P_NS] + b);

  // the growth at ln a (model.growth_at), every thread of the warp
  const double* glna = a.p[P_GLNA] + (size_t)b * a.nn;
  const double lx = log(c.a);
  const Nodes hg = load_nodes(glna, a.nn);
  Bracket rg = place(count_below(hg, glna, a.nn, lx), a.nn);
  double vG[4], vD[4];
  const size_t gro = (size_t)b * a.nn * nk + kk;
  rows4(c.valid, nk, rg, a.p[P_GG] + gro, true, vG);
  rows4(c.valid, nk, rg, a.p[P_GD] + gro, true, vD);
  const double dn = c.valid ? __ldg(a.p[P_GDN] + (size_t)b * nk + kk) : 1.0;
  weights(rg, glna, a.nn, lx, true);
  c.D = __ddiv_rn(__dmul_rn(dot4_chunks(rg, vG), c.a), dn);
  c.dDda = __ddiv_rn(dot4_chunks(rg, vD), dn);

  columns(a.layout, c);
  if (tile == 0 && lane == 0) lane_outputs(a, c, b, lz, rg);
}

}  // namespace

// ptrs[N_POINTERS] (read here, at the call): ys [B, S, 41, nk], k [nk];
// n_s, h, Omega_m, Omega_nu, T_cmb, w0, wa, norm, sigmaV2_z0 [B];
// T_solver [B, nk], beta_a [B, nz], beta_solver [B, nz, nk], g_lna [B,
// nn], g_G, g_dDda [B, nn, nk], g_Dnorm [B, nk]; Jw [B S, nfam, 3, 3, nk +
// 1] and PZw [B S, 7, 3, 3, nk] (nfam 7 or 14; null and nfam 0 where the
// layout takes no engine); the outputs table [B, S, nk, ncol], sigma_v2
// and H [B, S]; all f64, contiguous, on the current device.  z, r3, r4:
// the n <= MAX_Z redshifts s0 .. s0 + n - 1 of this launch and their
// (a / a_in)^3, ^4; sv_w, sv_i0: sigma_v^2's interpolation (sv_i0 < 0: k
// index 0).  layout: the index of kernels/out_block.py LAYOUTS, ncol its
// columns; blocks of threads (a multiple of 32, at most
// MAX_BLOCK_THREADS) as out_block.launch_plan sets them.
extern "C" int rt_out_block(const double* const* ptrs, int nptrs,
                            const double* z, const double* r3,
                            const double* r4, const double* sv_w,
                            double a_in, double h0h, double c_rho_gam,
                            double c_nu_hot, int B, int S, int s0, int n,
                            int nk, int nz, int nn, int nfam, int sv_i0,
                            int layout, int ncol, int blocks, int threads,
                            void* stream) {
  if (nptrs != N_POINTERS || n < 1 || n > MAX_Z || s0 < 0 || s0 + n > S ||
      layout < 0 || layout >= N_LAYOUTS || LAYOUT_NCOL[layout] != ncol ||
      (nz > 0 && nz < 4) || nn < 4 || (nfam != 0 && nfam != 7 &&
                                       nfam != 14) ||
      sv_i0 > nk - 4 || threads % 32 != 0 || threads > MAX_BLOCK_THREADS) {
    return cudaErrorInvalidValue;
  }
  Args a;
  for (int i = 0; i < N_POINTERS; ++i) a.p[i] = ptrs[i];
  for (int i = 0; i < MAX_Z; ++i) {
    a.z[i] = i < n ? z[i] : 0.0;
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
  out_block_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}
