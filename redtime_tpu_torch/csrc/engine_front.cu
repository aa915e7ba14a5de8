// K9 engine_front: the front of the windowed FAST-PT engine, from the
// state's ln P rows to the extended spectrum and the forward leg.
//
//   x[b,a,m]     = sum_{t<4} lnP[b,a,j0[m]+t] w[m,t] + (n_s[b] - 3) pab_v[m]
//   P_ext[b,a,m] = exp(clip(x, -80, 20)) wp[m]
//   ci[b,a,c]    = wc[c] sum_m P_ext[b,a,m] kbias[m] exp(-2 pi i m c / np)
//
// for c < half = np / 2, re in ci[..., c] and im in ci[..., half + c],
// with lnP first clipped to [LNP_MIN, LNP_MAX] when the caller asks (the
// RHS's clip of its state).  (j0, w) is the band of the Pab extension
// matrix pab_M [np, nk] (at most 4 non-zeros a row: the Lagrange cubic,
// the linear edge intervals, the right extrapolation; grids.pab_band);
// the plain version (kernels/engine_front.py) multiplies by the dense
// pab_M and by dft_fwd_half [np, 2 half] = [fc wc | -fs wc], and this
// kernel reads neither.  Replaces redtime_tpu/fastpt.py extend_power
// (:908-931, its clip at :930), the forward leg of compute_J_PZ_windowed
// (:1193) and the RHS's clip of lnP (redtime_tpu/trg.py:185), which on
// the TPU ran as XLA fusions around a dot (no Pallas kernel).  P_ext
// feeds K2 pz_leg and ci K10 tab_leg.
//
// Design: one block a row (b, a), no cluster.  Every load of the
// prologue is issued at once: the row's ln P, each thread's first points'
// band, bias, windows and wc, the first twiddles.  The block stages the
// row (clipped) in shared memory, then each thread extends its points m
// (four FMAs from the staged row, then the plain version's bias add,
// clip, exp and window in its order), stores P_ext and keeps q = P_ext
// kbias in shared memory.  The forward leg is a real-input FFT of length
// np through one complex FFT of length np / 2 (csrc/fft_smem.cuh) of p_j
// = q_{2j} + i q_{2j+1}, its twiddles w_{np/2}^e copied to shared memory:
// with P its transform, E_c = (P_c + conj P_{-c}) / 2, O_c = (P_c - conj
// P_{-c}) / 2i, ci_c = wc_c (E_c + w_np^{-c} O_c).
//
// Bound on the card: bytes, and those few.  At nk=128, np=512 and 16
// lanes it reads ln P (49 KB), the band, windows and twiddles (~48 KB)
// and writes P_ext and ci (0.2 MB each): 0.15 us at 3.35 TB/s, far under
// the ~1.2 us launch floor; its 48 x 1.7e4 flops take 0.02 us on the FP64
// pipes.  So the design aims at latency: 48 blocks, six barriers at np =
// 512 (two counts of the row, the extension, two between the FFT's three
// stages, one before the real split), one or two warps a stage.
//
// Non-finite ln P: the plain version's dense product sums all nk terms
// of a row, so a NaN anywhere in the row's ln P (after the clip) makes x
// NaN at every m, and an inf makes it NaN at every m whose row of pab_M
// is zero there (inf * 0) and +-inf where it is not (then clipped, or
// NaN when two infinities of opposite signs meet).  The band reads only
// its 4 columns, so the block counts the row's NaNs and infs while it
// stages it (__syncthreads_count), and each m gives NaN where the row has
// a NaN or more infs than its non-zero weights meet; elsewhere its own
// sum carries the infs as the dense one does.  So P_ext and ci are NaN
// and inf exactly where the plain version's are.  The clips are
// comparisons (fmin / fmax would drop a NaN).
#include <cmath>

#include "fft_smem.cuh"

namespace {

constexpr int THREADS = 256;                     // engine_front.THREADS
constexpr int U = 2;  // points (and ci columns) a thread takes a pass
constexpr double LNP_MIN = -80.0, LNP_MAX = 20.0;  // trg's state clip
constexpr double EXT_MIN = -80.0, EXT_MAX = 20.0;  // extend_power's

// torch.clamp's rule: a NaN stays NaN
__device__ __forceinline__ double clampn(double x, double lo, double hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// what the extension reads of point m besides the ln P row
struct Point {
  int j0;
  double2 w01, w23;
  double v, wp, kb;
};

__device__ __forceinline__ Point fetch(const int* j0, const double* w4,
                                       const double* pab_v, const double* wp,
                                       const double* kbias, int m) {
  const double2* w = reinterpret_cast<const double2*>(w4) + 2 * m;
  return Point{__ldg(j0 + m), __ldg(w), __ldg(w + 1), __ldg(pab_v + m),
               __ldg(wp + m), __ldg(kbias + m)};
}

__global__ void __launch_bounds__(THREADS)
    engine_front_kernel(const double* __restrict__ lnP, long long lane_st,
                        long long row_st, const double* __restrict__ n_s,
                        long long ns_st, int ns_rep,
                        const int* __restrict__ j0,
                        const double* __restrict__ w4,
                        const double* __restrict__ pab_v,
                        const double* __restrict__ wp,
                        const double* __restrict__ kbias,
                        const double* __restrict__ wc,
                        const double2* __restrict__ tw,
                        double* __restrict__ P_ext, double* __restrict__ ci,
                        int nk, int np, int clip, rt_fft::Plan plan) {
  extern __shared__ __align__(16) double smem[];
  const int row = blockIdx.x, b = row / 3, a = row % 3, tid = threadIdx.x;
  const int half = np / 2;
  double2* buf0 = reinterpret_cast<double2*>(smem);
  double2* buf1 = buf0 + rt_fft::padded(half);
  double2* T1 = buf1 + rt_fft::padded(half);  // w_half^e = tw[4e]
  double2* T2 = T1 + half;                      // w_np^k = tw[2k]
  double* L = reinterpret_cast<double*>(T2 + half);  // the ln P row
  double* q = reinterpret_cast<double*>(buf1);       // P_ext kbias

  // every load of the prologue in flight at once: the row's first pass,
  // the first pass's constants and windows, the first twiddles (stored
  // to shared memory after the extension, when they have long arrived)
  const double* src = lnP + b * lane_st + a * row_st;
  const double v0 = tid < nk ? src[tid] : 0.0;
  Point pt[U];
  double wcu[U];
  double2 t1[U], t2[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int m = tid + u * THREADS;
    if (m < np) pt[u] = fetch(j0, w4, pab_v, wp, kbias, m);
    wcu[u] = m < half ? __ldg(wc + m) : 0.0;
    if (m < half) {
      t1[u] = __ldg(tw + 4 * m);
      t2[u] = __ldg(tw + 2 * m);
    }
  }
  // stage the row, counting its NaNs and infs (every thread runs every
  // pass: each count is a barrier, the last one orders the stores)
  int nans = 0, infs = 0;
  for (int base = 0; base < nk; base += THREADS) {
    const int j = base + tid;
    double v = 0.0;
    if (j < nk) {
      v = base ? src[j] : v0;
      if (clip) v = clampn(v, LNP_MIN, LNP_MAX);
      L[j] = v;
    }
    nans += __syncthreads_count(isnan(v));
    infs += __syncthreads_count(isinf(v));
  }

  const double c = __dsub_rn(n_s[(b / ns_rep) * ns_st], 3.0);
  double* P_row = P_ext + (size_t)row * np;
  auto extend = [&](int m, const Point& p) {
    const double* l = L + p.j0;
    const double s =
        fma(l[3], p.w23.y,
            fma(l[2], p.w23.x, fma(l[1], p.w01.y, l[0] * p.w01.x)));
    const int met = (p.w01.x != 0.0 && isinf(l[0])) +
                    (p.w01.y != 0.0 && isinf(l[1])) +
                    (p.w23.x != 0.0 && isinf(l[2])) +
                    (p.w23.y != 0.0 && isinf(l[3]));
    const double x =
        nans || infs > met
            ? __longlong_as_double(0x7ff8000000000000LL)
            : clampn(__dadd_rn(s, __dmul_rn(c, p.v)), EXT_MIN, EXT_MAX);
    const double P = __dmul_rn(exp(x), p.wp);
    P_row[m] = P;
    q[m] = __dmul_rn(P, p.kb);
  };
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (tid + u * THREADS < np) extend(tid + u * THREADS, pt[u]);
  for (int m = tid + U * THREADS; m < np; m += THREADS)
    extend(m, fetch(j0, w4, pab_v, wp, kbias, m));
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (tid + u * THREADS < half) {
      T1[tid + u * THREADS] = t1[u];
      T2[tid + u * THREADS] = t2[u];
    }
  for (int e = tid + U * THREADS; e < half; e += THREADS) {
    T1[e] = __ldg(tw + 4 * e);
    T2[e] = __ldg(tw + 2 * e);
  }
  __syncthreads();

  // the complex FFT of p_j = (q_{2j}, q_{2j+1}), j < half: stage 0 reads
  // q (buf1), the result lands in buffer `res`
  double2* res = (plan.nst - 1) % 2 ? buf1 : buf0;
  auto first = [&](int, int j) { return buf1[j]; };
  auto last = [&](int, int o, double2 v) { res[o] = v; };
  rt_fft::run<false>(plan, 1, half, T1, half, buf0, buf1, first, last);
  __syncthreads();

  // the real split: E = (p + conj r) / 2, O = (p - conj r) / 2i, Q = E +
  // w_np^{-k} O, with p = P_k, r = P_{-k}
  double* ci_row = ci + (size_t)row * np;
  auto split = [&](int k, double wk) {
    const double2 p = res[k], r = res[k ? half - k : 0];
    const double2 E = make_double2(0.5 * (p.x + r.x), 0.5 * (p.y - r.y));
    const double2 O = make_double2(0.5 * (p.y + r.y), 0.5 * (r.x - p.x));
    const double2 Q =
        rt_fft::cadd(E, rt_fft::cmul(rt_fft::twid<false>(T2, k), O));
    ci_row[k] = wk * Q.x;
    ci_row[half + k] = wk * Q.y;
  };
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (tid + u * THREADS < half) split(tid + u * THREADS, wcu[u]);
  for (int k = tid + U * THREADS; k < half; k += THREADS)
    split(k, __ldg(wc + k));
}

}  // namespace

// lnP [B, 3, nk] with lane stride lane_st, row stride row_st and unit
// column stride; n_s [B / ns_rep] with stride ns_st, lane b reading
// entry b / ns_rep (the output block runs B lanes x n_z redshifts at once,
// ns_rep = n_z); j0 [np] (int32), w4 [np, 4]
// the band (j0 + 3 < nk), pab_v, wp, kbias [np], wc [np / 2], tw [2np]
// (w_{2np}^j as (cos, sin) pairs) contiguous; P_ext [B, 3, np] and ci [B,
// 3, np] contiguous outputs; f64 on the current device, w4 and tw
// 16-byte aligned; np even, plan[nst] the radices of the length-np/2 FFT
// (fourier.fft_plan), smem the block's shared memory (the wrapper's
// smem_bytes).  Returns cudaGetLastError().
extern "C" int rt_engine_front(const double* lnP, long long lane_st,
                               long long row_st, const double* n_s,
                               long long ns_st, int ns_rep,
                               const int* j0,
                               const double* w4, const double* pab_v,
                               const double* wp, const double* kbias,
                               const double* wc, const double* tw,
                               double* P_ext, double* ci, int B, int nk,
                               int np, int clip, int smem, const int* plan,
                               int nst, void* stream) {
  rt_fft::Plan p = {};
  if (nst < 1 || nst > rt_fft::MAX_STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  p.nst = nst;
  for (int s = 0; s < nst; ++s) p.radix[s] = plan[s];
  static int smem_set[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && smem_set[dev] < smem) {
    cudaFuncSetAttribute(engine_front_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    smem_set[dev] = smem;
  }
  engine_front_kernel<<<3 * B, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      lnP, lane_st, row_st, n_s, ns_st, ns_rep, j0, w4, pab_v, wp, kbias, wc,
      reinterpret_cast<const double2*>(tw), P_ext, ci, nk, np, clip, p);
  return static_cast<int>(cudaGetLastError());
}
