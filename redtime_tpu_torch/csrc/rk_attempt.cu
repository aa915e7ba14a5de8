// K3: one embedded Runge-Kutta controller attempt on every lane, the part
// of it that is the integrator's own (the RHS evaluations aside).
//
//   rt_rk_stage    y_i = y + h_try * sum_{j<i} a_ij k_j, one stage input
//   rt_rk_finish   the attempt's tail: y_new = y + h_try sum_j b_j k_j,
//                  yerr = h_try sum_j e_j k_j, the lane's error norm
//                  r = max_i |yerr_i| / (eabs + erel |y_new_i|), GSL's
//                  standard controller (accept / reject, next step), and
//                  the chosen state; lanes that are not active stay frozen
//
// Replaces redtime_tpu/ode.py:130 (the stage input of rk_step) and
// redtime_tpu/ode.py:161-181 (one attempt under a vmapped while_loop),
// which the TPU ran inside XLA's while_loop fusion, and the packed
// scheduler's lane attempt (redtime_tpu/trg.py:440-459): its final-step
// rule, h >= t1 - t where the chunked path has h > t1 - t, is a launch
// argument, and every lane also writes reached = final & accepted &
// active (JAX's final & ~dec), which the packed scheduler advances its
// segment on.
//
// Bound on the card: bytes.  The finish reads y and the s stage rows of
// every lane once and writes the state once: (s + 2) B D f64, 1.6 us at
// 3.35 TB/s for RKF45 on 16 lanes of D = 41 * 128 = 5248; the stage reads
// y and i rows and writes one.  The arithmetic is 2 s + 4 flops an
// element.  What the design does about it:
//  * one thread-block cluster per lane: the CL blocks of a cluster split
//    the lane's D elements, so 16 lanes spread over 128 SMs instead of 16,
//    and a block's slice (256 threads, at most 8 accesses each) stays in
//    registers: y and the s rows are read once, in 16-byte accesses, and
//    the chosen state is written from registers.  No y_new or yerr array
//    reaches device memory and nothing is read twice;
//  * the stage count is a template argument, one instance for each of the
//    solver's tableaux (6, 7, 12 stages: RKF45, DOPRI5, DOP853), and no
//    load sits behind a branch, so the loads of two accesses' rows are
//    all issued before the first sum waits on one;
//  * the lane's norm: warp shuffles, then shared memory, then every block
//    writes its partial maximum into slot [rank] of every peer's shared
//    memory; after one cluster barrier each block takes the maximum of the
//    CL slots itself.  max is independent of the order, so every block
//    finds the same r, the same bits on every call: no atomics and no
//    second kernel.  fmax drops a NaN, so a NaN is carried as a flag and
//    put back, as torch.amax propagates it;
//  * the tableau's weights and the controller's scalars are kernel
//    parameters (the constant bank), copied from the host by the launcher:
//    no load waits on another, and every thread's loads of y, the stage
//    rows and the lane's t, h, t1 are in flight together;
//  * every block decides accept / reject from r (one compare) and writes
//    its slice; rank 0 alone evaluates the step factor, the one pow the
//    lane's branch needs (a rejected lane's, a growing lane's, or none),
//    and writes the lane's t, h, n and r;
//  * a lane larger than eight blocks hold in registers (D > 32768 with
//    16-byte accesses, nk > 799) goes to rk_finish_passes_kernel: each
//    block loops over its slice, writes y_new as it goes and, when the
//    lane is not taken, copies y over it in a second pass.  The same
//    operations in the same order: the same bits.
// Each block arrives at a cluster barrier when it starts and waits on it
// before its first write into a peer's shared memory; the barrier after
// the writes is the last access to a peer, so no block exits while one
// may still write to it.
//
// Rounding: every product and sum is written with __dmul_rn / __dadd_rn,
// which nvcc never contracts into an FMA, in the order of the plain
// PyTorch version (stages summed in index order), so y, t, n and the
// accept / reject decisions equal the plain version's bit for bit.  A
// contracted y + h * acc changes r near the controller's 1.1 and 0.5
// thresholds and with it the step sequence.

#include <cstdint>

#include "dmma_tile.cuh"

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int MAX_CL = 8;       // blocks of a cluster (the portable limit)
constexpr int MAX_UPT = 8;      // accesses a thread keeps in registers
constexpr int ROUND = 2;        // accesses whose loads fly together
constexpr int MAX_S = 12;       // stages of the largest tableau (DOP853)

// b, e: the tableau's solution and error weights; prm: eabs, erel, the
// step-factor exponents -1/ord and -1/(ord+1), then the controller's
// safety factor, reject-above and grow-below thresholds, smallest and
// largest step factors (kernels/rk_finish.py controller_params);
// final_ge: the final-step rule, h >= dt (1) or h > dt (0)
struct Coeffs {
  double b[MAX_S], e[MAX_S], prm[9];
  int final_ge;
};

// The final-step rule: whether the lane's step reaches t1 this attempt.
// h_try = final ? dt : h is the same under both rules.
__device__ __forceinline__ bool is_final(const Coeffs& c, double h,
                                         double dt) {
  return c.final_ge ? h >= dt : h > dt;
}

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}

// W doubles in one access (16 bytes for W = 2), read through the
// read-only path
template <int W>
__device__ __forceinline__ void load(const double* p, double (&v)[W]) {
  if constexpr (W == 2) {
    const double2 t = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int W>
__device__ __forceinline__ void store(double* p, const double (&v)[W]) {
  if constexpr (W == 2)
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  else
    p[0] = v[0];
}

__device__ __forceinline__ double quiet_nan() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// torch.clamp: a NaN stays a NaN (fmax and fmin would drop it)
__device__ __forceinline__ double clamp(double x, double lo, double hi) {
  return x != x ? x : fmin(fmax(x, lo), hi);
}

// The lane's error norm r from each thread's share (q_max, and whether it
// met a NaN): warp shuffles, then shared memory, then, for a lane split
// over cl blocks, every block writes its partial maximum into slot [rank]
// of every peer's shared memory and takes the maximum of the cl slots
// after one cluster barrier.  fmax drops a NaN, so a NaN is carried as a
// flag and put back, as torch.amax propagates it.
__device__ __forceinline__ double lane_norm(double q_max, bool q_nan, int cl,
                                            int rank) {
  __shared__ double warp_max[WARPS];
  __shared__ double peer_max[MAX_CL];
  const int tid = threadIdx.x;
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    q_max = fmax(q_max, __shfl_xor_sync(0xffffffffu, q_max, off));
  q_nan = __any_sync(0xffffffffu, q_nan);
  if (tid % 32 == 0) warp_max[tid / 32] = q_nan ? quiet_nan() : q_max;
  __syncthreads();
  // a NaN slot sets the flag and passes through fmax unseen
  double r = 0.0;
  bool r_nan = false;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const double v = warp_max[w];
    r_nan |= v != v;
    r = fmax(r, v);
  }
  if (cl > 1) {
    rt::cg::cluster_group cluster = rt::cg::this_cluster();
    rt::cluster_wait();  // every peer has started
    if (tid < cl)
      *cluster.map_shared_rank(&peer_max[rank], tid) =
          r_nan ? quiet_nan() : r;
    cluster.sync();
    r = 0.0;
    r_nan = false;
    for (int p = 0; p < cl; ++p) {
      const double v = peer_max[p];
      r_nan |= v != v;
      r = fmax(r, v);
    }
  }
  return r_nan ? quiet_nan() : r;
}

// GSL's standard controller on the lane's r (dec: r > reject_above): the
// step factor, the one pow the lane's branch needs (a rejected lane's, a
// growing lane's, or none), and the lane's t, h, n, r and reached.
__device__ __forceinline__ void controller_tail(
    const Coeffs& c, double r, bool dec, bool final, double h_try,
    double t_l, double h_l, double t1_l, long long n_l, bool act, int lane,
    double* t_out, double* h_out, long long* n_out, double* r_out,
    unsigned char* reached_out) {
  const double p_dec = c.prm[2], p_inc = c.prm[3], safety = c.prm[4];
  const double grow_below = c.prm[6], fac_min = c.prm[7], fac_max = c.prm[8];
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  double fac = 1.0;  // also for a NaN r, as the plain version's where
  if (dec)
    fac = clamp(mul(safety, pow(r, p_dec)), fac_min, inf);
  else if (r < grow_below)
    fac = clamp(mul(safety, pow(r, p_inc)), 1.0, fac_max);
  const double h_next = mul(h_try, fac);
  const double t_acc = final ? t1_l : add(t_l, h_try);
  const double t_new = dec ? t_l : t_acc;
  t_out[lane] = act ? t_new : t_l;
  h_out[lane] = act ? h_next : h_l;
  n_out[lane] = n_l + (act ? 1 : 0);
  r_out[lane] = r;
  reached_out[lane] = final && act && !dec;
}

// S: the stage count; UPT: accesses a thread holds; W: doubles an access.
template <int S, int UPT, int W>
__global__ void __launch_bounds__(THREADS)
    rk_finish_kernel(const double* __restrict__ y,
                     const double* __restrict__ ks,
                     const double* __restrict__ t,
                     const double* __restrict__ h,
                     const double* __restrict__ t1,
                     const long long* __restrict__ n,
                     const unsigned char* __restrict__ active,
                     const __grid_constant__ Coeffs c,
                     double* __restrict__ y_out, double* __restrict__ t_out,
                     double* __restrict__ h_out,
                     long long* __restrict__ n_out,
                     double* __restrict__ r_out,
                     unsigned char* __restrict__ reached_out, int B, int D,
                     int cl) {
  static_assert(UPT % ROUND == 0, "whole rounds");
  if (cl > 1) rt::cluster_arrive_relaxed();
  const int tid = threadIdx.x;
  const int lane = blockIdx.y, rank = blockIdx.x;  // cluster dims (cl, 1, 1)
  const double t_l = t[lane], h_l = h[lane], t1_l = t1[lane];
  const long long n_l = n[lane];
  const bool act = active[lane] != 0;
  const double eabs = c.prm[0], erel = c.prm[1], reject_above = c.prm[5];
  const double dt = __dsub_rn(t1_l, t_l);
  const bool final = is_final(c, h_l, dt);
  const double h_try = final ? dt : h_l;

  // this block's slice of the lane, in accesses of W doubles
  const int units = D / W;
  const int per_block = (units + cl - 1) / cl;
  const int u0 = rank * per_block;
  const int u_end = min(u0 + per_block, units);
  const size_t row = (size_t)lane * D, stage = (size_t)B * D;

  // Every load reads a valid address: a thread past the end of its slice
  // reads the lane's last access again and drops what it computes from
  // it.  So no load hides behind a branch, and the S + 1 loads of each of
  // a round's ROUND accesses are all in flight before the first sum waits
  // on one (a load behind a branch waits for the sum before it: one trip
  // to memory a stage).
  double yv[UPT][W], acc_b[UPT][W], acc_e[UPT][W];
  bool ok[UPT];
  size_t at[UPT];
#pragma unroll
  for (int i = 0; i < UPT; ++i) {
    const int u = u0 + tid + i * THREADS;
    ok[i] = u < u_end;
    at[i] = row + (size_t)min(u, units - 1) * W;
  }
#pragma unroll
  for (int i0 = 0; i0 < UPT; i0 += ROUND) {
    // a round past the block's slice (the same for every thread)
    if (i0 > 0 && u0 + i0 * THREADS >= u_end) continue;
    double k[S][ROUND][W];
#pragma unroll
    for (int i = 0; i < ROUND; ++i) load<W>(y + at[i0 + i], yv[i0 + i]);
#pragma unroll
    for (int j = 0; j < S; ++j)
#pragma unroll
      for (int i = 0; i < ROUND; ++i)
        load<W>(ks + j * stage + at[i0 + i], k[j][i]);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const double bj = c.b[j], ej = c.e[j];
#pragma unroll
      for (int i = 0; i < ROUND; ++i)
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const double kw = k[j][i][w];
          double& ab = acc_b[i0 + i][w];
          double& ae = acc_e[i0 + i][w];
          ab = j == 0 ? mul(bj, kw) : add(ab, mul(bj, kw));
          ae = j == 0 ? mul(ej, kw) : add(ae, mul(ej, kw));
        }
    }
  }

  // y_new takes acc_b's place; the thread's share of the norm
  double q_max = 0.0;
  bool q_nan = false;
#pragma unroll
  for (int i = 0; i < UPT; ++i) {
    if (!ok[i]) continue;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const double y_new = add(yv[i][w], mul(h_try, acc_b[i][w]));
      const double yerr = mul(h_try, acc_e[i][w]);
      const double q =
          __ddiv_rn(fabs(yerr), add(eabs, mul(erel, fabs(y_new))));
      acc_b[i][w] = y_new;
      if (q != q)
        q_nan = true;
      else
        q_max = fmax(q_max, q);
    }
  }
  const double r = lane_norm(q_max, q_nan, cl, rank);

  const bool dec = r > reject_above;
  const bool take = act && !dec;
#pragma unroll
  for (int i = 0; i < UPT; ++i) {
    if (!ok[i]) continue;
    double* dst = y_out + row + (size_t)(u0 + tid + i * THREADS) * W;
    if (take)
      store<W>(dst, acc_b[i]);
    else
      store<W>(dst, yv[i]);
  }

  if (rank == 0 && tid == 0)
    controller_tail(c, r, dec, final, h_try, t_l, h_l, t1_l, n_l, act, lane,
                    t_out, h_out, n_out, r_out, reached_out);
}

// A lane whose slice a block cannot keep in registers: each block loops
// over its slice once, writing y_new and keeping its share of the norm,
// and, when the lane is not taken, a second time, copying y over y_new.
// Every value is computed as in rk_finish_kernel (the same operations in
// the same order), so y_out, t, h, n and r are the same bits.
template <int S, int W>
__global__ void __launch_bounds__(THREADS)
    rk_finish_passes_kernel(const double* __restrict__ y,
                            const double* __restrict__ ks,
                            const double* __restrict__ t,
                            const double* __restrict__ h,
                            const double* __restrict__ t1,
                            const long long* __restrict__ n,
                            const unsigned char* __restrict__ active,
                            const __grid_constant__ Coeffs c,
                            double* __restrict__ y_out,
                            double* __restrict__ t_out,
                            double* __restrict__ h_out,
                            long long* __restrict__ n_out,
                            double* __restrict__ r_out,
                            unsigned char* __restrict__ reached_out, int B,
                            int D, int cl) {
  if (cl > 1) rt::cluster_arrive_relaxed();
  const int tid = threadIdx.x;
  const int lane = blockIdx.y, rank = blockIdx.x;  // cluster dims (cl, 1, 1)
  const double t_l = t[lane], h_l = h[lane], t1_l = t1[lane];
  const long long n_l = n[lane];
  const bool act = active[lane] != 0;
  const double eabs = c.prm[0], erel = c.prm[1], reject_above = c.prm[5];
  const double dt = __dsub_rn(t1_l, t_l);
  const bool final = is_final(c, h_l, dt);
  const double h_try = final ? dt : h_l;

  const int units = D / W;
  const int per_block = (units + cl - 1) / cl;
  const int u0 = rank * per_block;
  const int u_end = min(u0 + per_block, units);
  const size_t row = (size_t)lane * D, stage = (size_t)B * D;

  double q_max = 0.0;
  bool q_nan = false;
  for (int u = u0 + tid; u < u_end; u += THREADS) {
    const size_t at = row + (size_t)u * W;
    double yv[W], k[S][W], acc_b[W], acc_e[W];
    load<W>(y + at, yv);
#pragma unroll
    for (int j = 0; j < S; ++j) load<W>(ks + j * stage + at, k[j]);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const double bj = c.b[j], ej = c.e[j];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        acc_b[w] = j == 0 ? mul(bj, k[j][w]) : add(acc_b[w], mul(bj, k[j][w]));
        acc_e[w] = j == 0 ? mul(ej, k[j][w]) : add(acc_e[w], mul(ej, k[j][w]));
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const double y_new = add(yv[w], mul(h_try, acc_b[w]));
      const double yerr = mul(h_try, acc_e[w]);
      const double q =
          __ddiv_rn(fabs(yerr), add(eabs, mul(erel, fabs(y_new))));
      acc_b[w] = y_new;
      if (q != q)
        q_nan = true;
      else
        q_max = fmax(q_max, q);
    }
    store<W>(y_out + at, acc_b);
  }
  const double r = lane_norm(q_max, q_nan, cl, rank);
  const bool dec = r > reject_above;
  if (!(act && !dec)) {
    for (int u = u0 + tid; u < u_end; u += THREADS) {
      const size_t at = row + (size_t)u * W;
      double yv[W];
      load<W>(y + at, yv);
      store<W>(y_out + at, yv);
    }
  }
  if (rank == 0 && tid == 0)
    controller_tail(c, r, dec, final, h_try, t_l, h_l, t1_l, n_l, act, lane,
                    t_out, h_out, n_out, r_out, reached_out);
}

// NJ: the number of rows summed (the stage index i).
template <int NJ, int W>
__global__ void __launch_bounds__(THREADS)
    rk_stage_kernel(const double* __restrict__ y,
                    const double* __restrict__ ks,
                    const double* __restrict__ h,
                    const double* __restrict__ a_row,
                    double* __restrict__ out, int B, int D) {
  const int lane = blockIdx.y;
  const int u = blockIdx.x * THREADS + threadIdx.x;
  if (u >= D / W) return;
  const size_t at = (size_t)lane * D + (size_t)u * W, stage = (size_t)B * D;
  const double h_l = h[lane];
  double yv[W], acc[W];
  load<W>(y + at, yv);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const double aj = __ldg(a_row + j);
    double k[W];
    load<W>(ks + j * stage + at, k);
#pragma unroll
    for (int w = 0; w < W; ++w)
      acc[w] = j == 0 ? mul(aj, k[w]) : add(acc[w], mul(aj, k[w]));
  }
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = add(yv[w], mul(h_l, acc[w]));
  store<W>(out + at, acc);
}

// The launches run on `device`, whatever device the caller's thread has
// current.
struct DeviceGuard {
  int prev = -1;
  bool switched = false;
  explicit DeviceGuard(int device) {
    cudaGetDevice(&prev);
    if (device != prev) switched = cudaSetDevice(device) == cudaSuccess;
  }
  ~DeviceGuard() {
    if (switched) cudaSetDevice(prev);
  }
};

struct FinishArgs {
  const double *y, *ks, *t, *h, *t1;
  const long long* n;
  const unsigned char* active;
  Coeffs c;
  double *y_out, *t_out, *h_out;
  long long* n_out;
  double* r_out;
  unsigned char* reached_out;
  int B, D, s, cl;
  cudaStream_t stream;
};

template <class Kernel>
int launch_finish(const FinishArgs& a, Kernel kernel) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cl, a.B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, a.y, a.ks, a.t, a.h, a.t1, a.n,
      a.active, a.c, a.y_out, a.t_out, a.h_out, a.n_out, a.r_out,
      a.reached_out, a.B, a.D, a.cl);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int S, int W>
int finish_by_upt(const FinishArgs& a, int per_block) {
  if (per_block <= 2 * THREADS)
    return launch_finish(a, rk_finish_kernel<S, 2, W>);
  if (per_block <= MAX_UPT * THREADS)
    return launch_finish(a, rk_finish_kernel<S, MAX_UPT, W>);
  return launch_finish(a, rk_finish_passes_kernel<S, W>);
}

template <int W>
int finish_by_stages(const FinishArgs& a, int per_block) {
  switch (a.s) {
    case 6: return finish_by_upt<6, W>(a, per_block);
    case 7: return finish_by_upt<7, W>(a, per_block);
    case 12: return finish_by_upt<12, W>(a, per_block);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int W>
int launch_stage(const double* y, const double* ks, const double* h,
                 const double* a_row, double* out, int B, int D, int nj,
                 cudaStream_t stream) {
  const dim3 grid((D / W + THREADS - 1) / THREADS, B);
#define RT_STAGE(NJ)                                                     \
  case NJ:                                                               \
    rk_stage_kernel<NJ, W><<<grid, THREADS, 0, stream>>>(y, ks, h, a_row, \
                                                         out, B, D);     \
    break;
  switch (nj) {
    RT_STAGE(1) RT_STAGE(2) RT_STAGE(3) RT_STAGE(4) RT_STAGE(5) RT_STAGE(6)
    RT_STAGE(7) RT_STAGE(8) RT_STAGE(9) RT_STAGE(10) RT_STAGE(11)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RT_STAGE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y [B, D], ks [s, B, D], y_out [B, D]; t, h, t1, t_out, h_out, r_out [B]
// f64; n, n_out [B] int64; active, reached_out [B] bytes; all contiguous
// on `device`; coef: 2 s + 9 f64 in host memory, b [s], e [s], prm [9],
// copied into the kernel's parameters; final_ge: the final-step rule
// (1: h >= dt, the packed scheduler's; 0: h > dt); s in {6, 7, 12}.  cl in {1, 2, 4, 8}: the
// blocks that split a lane.  vec != 0: 16-byte accesses (D even; y, ks and
// y_out 16-byte aligned), else 8-byte ones.  A block keeps at most
// MAX_UPT * THREADS accesses of its lane in registers; a larger slice runs
// in passes.  Returns the launch's CUDA error (cudaErrorInvalidValue for a
// shape the kernel does not take).
extern "C" int rt_rk_finish(const double* y, const double* ks, const double* t,
                            const double* h, const double* t1,
                            const long long* n, const unsigned char* active,
                            const double* coef, int final_ge, double* y_out,
                            double* t_out, double* h_out, long long* n_out,
                            double* r_out, unsigned char* reached_out, int B,
                            int D, int s, int cl, int vec, int device,
                            void* stream) {
  const int W = vec ? 2 : 1;
  const bool aligned =
      D % 2 == 0 && (reinterpret_cast<uintptr_t>(y) |
                     reinterpret_cast<uintptr_t>(ks) |
                     reinterpret_cast<uintptr_t>(y_out)) % 16 == 0;
  if (B < 1 || B > 65535 || D < 1 || (s != 6 && s != 7 && s != 12) ||
      (cl != 1 && cl != 2 && cl != 4 && cl != 8) || (vec && !aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = (D / W + cl - 1) / cl;
  FinishArgs a = {y,     ks,    t,     h,     t1,          n, active, {},
                  y_out, t_out, h_out, n_out, r_out, reached_out, B, D,
                  s,     cl,    static_cast<cudaStream_t>(stream)};
  a.c.final_ge = final_ge != 0;
  for (int j = 0; j < s; ++j) {
    a.c.b[j] = coef[j];
    a.c.e[j] = coef[s + j];
  }
  for (int j = 0; j < 9; ++j) a.c.prm[j] = coef[2 * s + j];
  DeviceGuard guard(device);
  return vec ? finish_by_stages<2>(a, per_block)
             : finish_by_stages<1>(a, per_block);
}

// out [B, D] = y + h[:, None] * sum_{j < nj} a_row[j] ks[j]; y [B, D],
// ks [s, B, D] with s > nj, 1 <= nj <= 11, h [B], a_row [>= nj]; f64,
// contiguous, on `device`; vec as in rt_rk_finish (y, ks and out 16-byte
// aligned).
extern "C" int rt_rk_stage(const double* y, const double* ks, const double* h,
                           const double* a_row, double* out, int B, int D,
                           int nj, int vec, int device, void* stream) {
  const bool aligned =
      D % 2 == 0 && (reinterpret_cast<uintptr_t>(y) |
                     reinterpret_cast<uintptr_t>(ks) |
                     reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (B < 1 || B > 65535 || D < 1 || nj < 1 || (vec && !aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec ? launch_stage<2>(y, ks, h, a_row, out, B, D, nj, st)
             : launch_stage<1>(y, ks, h, a_row, out, B, D, nj, st);
}
