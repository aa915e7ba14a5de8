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
// redtime_tpu/assembly.py:172-524.  In the eager port the same work was
// ~1,700 launches of elementwise kernels an evaluation.
//
// The A/R code is generated from the port's assembly (rhs_tail_ar.cuh,
// written at build time by kernels/rhs_tail.py ar_source from a trace of
// assembly.ar_rows): the plain version's operations in its order, each
// one IEEE operation, so that the assembly's cancellation (A and R are
// small differences of terms up to ~1e4 times larger) rounds as in the
// plain version.  A division by a constant is x * (1/c), as torch's CUDA
// kernels divide by a scalar.  The Omega terms (CI, CQ) and
// dlnP's I coupling (TR14) are a table (kernels/rhs_tail.py
// kernel_table), uniform across a warp.
//
// Bound on the card: bytes.  Full TRG at 16 lanes and nk = 128 reads Jw
// (2.08 MB), PZw (1.03 MB) and y (0.67 MB) and writes dy (0.67 MB):
// 1.33 us at 3.35 TB/s; the arithmetic (~1,000 f64 operations a k point)
// is 2 MFLOP.  So a block stages all it reads for 32 k points of one
// lane (y, the features or the 1-loop cache's rows) and the table into
// shared memory with coalesced loads, a warp's loads in flight together,
// then eight warps work through the 38 outputs (a warp an output and 32
// k points at a time) out of shared memory, and each output row is
// written once, coalesced.
//
// Semantics kept from the plain version: the clamps are compare-and-select
// (a NaN stays NaN, where fmin/fmax would drop it); divisions are IEEE
// (no fast math); Omega, dlnP, the 1-loop rescale and the assembly are
// written with __dmul_rn / __dadd_rn in the plain version's order.  The
// plain version's matrix products (TR14 @ I, CI @ (Of x I), CQ @
// (Of x Q)) sum in cuBLAS's order, the kernel in the table's, so dlnP, dI
// and dQ differ from it by that rounding.
#include <cuda_runtime.h>

namespace {

constexpr int KT = 32;                 // k points a block (a warp's lanes)
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 16;             // staged rows a warp has in flight
constexpr int NUP = 3, NUI = 14, NUQ = 24, NU = NUP + NUI + NUQ;
constexpr int HDR = 8, OUT_WORDS = 3;  // table header; words an output
constexpr int MAX_ROWS = NU + 14 * 9 + 7 * 9;
constexpr int MAX_TABLE = 4096;        // bytes of the table's words, weights
constexpr int MAX_SMEM = MAX_ROWS * KT * 8 + MAX_TABLE;
constexpr double LNP_MIN = -80.0, LNP_MAX = 20.0;
constexpr double DLNP_GUARD = 1e4, DLNP11_GUARD = 10.0;
constexpr double PI = 3.141592653589793;   // np.pi

enum Mode { LINEAR = 0, FULL = 1, ONE_LOOP = 2 };

// torch.clamp's rule: a NaN stays NaN
__device__ __forceinline__ double clampn(double x, double lo, double hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

#include "rhs_tail_ar.cuh"   // ar_out(o, f, nj, k)

// rows of y, features or cache rows a block stages
__host__ __device__ __forceinline__ int staged_rows(int mode, int evolve_q,
                                                    int nj) {
  return NU + (mode == FULL ? nj + 63
               : mode == ONE_LOOP ? NUI + (evolve_q ? NUQ : 0) : 0);
}

__device__ __forceinline__ double pick4(int i, double a, double b, double c,
                                        double d) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

__global__ void __launch_bounds__(THREADS) rhs_tail_kernel(
    const double* __restrict__ y, const double* __restrict__ eta,
    const double* __restrict__ kgrid, const double* __restrict__ beta,
    const double* __restrict__ Om, const double* __restrict__ fcb,
    const double* __restrict__ den, const double* __restrict__ o11v,
    const double* __restrict__ s0, const double* __restrict__ s1,
    const double* __restrict__ s2, const double* __restrict__ s3,
    const double* __restrict__ s4, const double* __restrict__ s5,
    const int* __restrict__ tab, const double* __restrict__ wt,
    double* __restrict__ dy, int nk, int mode, int evolve_q, int nfam,
    int pitch, int nw, int nint) {
  // [rows][KT]: y's 41 rows, then the features (full TRG) or the cache's
  // rows (1-loop); then the table's weights and words
  extern __shared__ double sm[];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kk = blockIdx.x * KT + lane;
  const bool valid = kk < nk;
  const int nj = 9 * nfam;         // Jw rows staged (J, then Jn0)

  // --- stage, for this block's k points, y and, in full TRG, the
  // features (J, Jn0 as K1 wrote them, then PZ), in 1-loop mode the
  // cache's A_u and R rows; then the table.  A warp's rows are
  // r = warp + 8 i, up to UNROLL of them loaded before any is stored, so
  // their loads are in flight together.
  const int rows = staged_rows(mode, evolve_q, nj);
  for (int r0 = warp; r0 < rows; r0 += WARPS * UNROLL) {
    double v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * WARPS, q = r - NU;
      const double* p =
          r < NU ? y + ((size_t)b * NU + r) * nk
          : mode == FULL
              ? (q < nj ? s0 + ((size_t)b * nj + q) * pitch
                        : s1 + ((size_t)b * 63 + (q - nj)) * nk)
              : (q < NUI ? s0 + ((size_t)b * NUI + q) * nk
                         : s1 + ((size_t)b * NUQ + (q - NUI)) * nk);
      v[u] = valid && r < rows ? __ldg(p + kk) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * WARPS;
      if (r < rows) sm[r * KT + lane] = v[u];
    }
  }
  double* swt = sm + rows * KT;
  int* stab = reinterpret_cast<int*>(swt + nw);
  for (int i = threadIdx.x; i < nw; i += THREADS) swt[i] = wt[i];
  for (int i = threadIdx.x; i < nint; i += THREADS) stab[i] = tab[i];
  __syncthreads();
  const int* T = stab;      // the table, from here on in shared memory
  const double* W = swt;
  if (!valid) return;   // no barrier follows
  const double* sy = sm;
  const double* sf = sm + NU * KT;

  // --- Omega: Of = (1, -1, o10, o11)
  const double e = exp(eta[b]);
  const double kv = kgrid[kk];
  const double o10 = __ddiv_rn(
      __dmul_rn(__dmul_rn(-1.5, Om[b]),
                __dadd_rn(fcb[b], beta[(size_t)b * nk + kk])),
      den[b]);
  const double o11 = o11v[b];
  const int off_tr = T[0], off_term = T[1];
  const int* term = T + off_term;

  // --- 1-loop: pre fz^n (trg.oneloop_rescale)
  double pre = 0.0, fz = 0.0, f2 = 0.0;
  if (mode == ONE_LOOP) {
    const size_t i = (size_t)b * nk + kk;
    const double D = s2[i];
    fz = __ddiv_rn(s3[i], __dmul_rn(D, __dadd_rn(1.0, s5[b])));
    const double dr = __ddiv_rn(D, s4[i]);
    const double dr2 = __dmul_rn(dr, dr);
    pre = __dmul_rn(__dmul_rn(dr2, dr2), exp(__dmul_rn(-4.0, eta[b])));
    f2 = __dmul_rn(fz, fz);
  }

  // --- dI, dQ: a warp an output row
  const int nout = mode == LINEAR ? 0 : NUI + (evolve_q ? NUQ : 0);
  for (int o = warp; o < NUI + NUQ; o += WARPS) {
    double d = 0.0;
    if (o < nout) {
      const int* h = T + HDR + o * OUT_WORDS;
      double src;
      if (mode == FULL) {
        src = ar_out(o, sf + lane, nj, kv);
      } else {
        const double c = sf[o * KT + lane];
        const double fp = pick4(h[2], fz, f2, __dmul_rn(f2, fz),
                                __dmul_rn(f2, f2));
        src = __dmul_rn(__dmul_rn(pre, fp), c);
      }
      double t = 0.0;
      for (int w = h[0]; w < h[1]; ++w) {
        const int code = term[w];
        const double Of = pick4(code >> 8, 1.0, -1.0, o10, o11);
        t += W[w] * __dmul_rn(Of, sy[(code & 255) * KT + lane]);
      }
      d = __dsub_rn(__dmul_rn(__dmul_rn(2.0, e), src), t);
    }
    dy[((size_t)b * NU + NUP + o) * nk + kk] = d;
  }

  // --- dlnP (the last warp, which has the fewest output rows)
  if (warp != WARPS - 1) return;
  const double P0 = exp(clampn(sy[0 * KT + lane], LNP_MIN, LNP_MAX));
  const double P1 = exp(clampn(sy[1 * KT + lane], LNP_MIN, LNP_MAX));
  const double P2 = exp(clampn(sy[2 * KT + lane], LNP_MIN, LNP_MAX));
  // O00 = 1, O01 = -1, as the plain version multiplies them
  double dP0 = __dmul_rn(-2.0, __dadd_rn(__dmul_rn(1.0, P0),
                                         __dmul_rn(-1.0, P1)));
  double dP1 = __dsub_rn(
      -__dadd_rn(__dmul_rn(1.0, P1), __dmul_rn(-1.0, P2)),
      __dadd_rn(__dmul_rn(o10, P0), __dmul_rn(o11, P1)));
  double dP2 = __dmul_rn(-2.0, __dadd_rn(__dmul_rn(o10, P1),
                                         __dmul_rn(o11, P2)));
  if (mode != LINEAR) {
    double Is[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      double s = 0.0;
      for (int t = T[off_tr + r]; t < T[off_tr + r + 1]; ++t)
        s += W[t] * sy[term[t] * KT + lane];
      Is[r] = s;
    }
    const double coef = __ddiv_rn(__dmul_rn(__dmul_rn(e, 4.0), PI), kv);
    dP0 = __dadd_rn(dP0, __dmul_rn(coef, __dadd_rn(Is[0], Is[0])));
    dP1 = __dadd_rn(dP1, __dmul_rn(coef, __dadd_rn(Is[2], Is[1])));
    dP2 = __dadd_rn(dP2, __dmul_rn(coef, __dadd_rn(Is[3], Is[3])));
  }
  double* out = dy + (size_t)b * NU * nk + kk;
  out[0] = clampn(__ddiv_rn(dP0, P0), -DLNP_GUARD, DLNP_GUARD);
  out[nk] = clampn(__ddiv_rn(dP1, P1), -DLNP_GUARD, DLNP_GUARD);
  out[2 * nk] = clampn(clampn(__ddiv_rn(dP2, P2), -DLNP_GUARD, DLNP_GUARD),
                       -DLNP11_GUARD, DLNP11_GUARD);
}

}  // namespace

// y [B, 41, nk], eta [B], k [nk], beta [B, nk], Om / fcb / den / o11 [B];
// full TRG (mode 1): s0 = Jw [B, nfam, 3, 3, pitch], s1 = PZw
// [B, 7, 3, 3, nk]; 1-loop (mode 2): s0 = A_u [B, 14, nk], s1 = R
// [B, 24, nk], s2 = D, s3 = dD/da, s4 = D_z1l [B, nk], s5 = z [B];
// linear (mode 0): none.  tab / wt: kernel_table's nint words and nw
// weights.
extern "C" int rt_rhs_tail(const double* y, const double* eta,
                           const double* k, const double* beta,
                           const double* Om, const double* fcb,
                           const double* den, const double* o11,
                           const double* s0, const double* s1,
                           const double* s2, const double* s3,
                           const double* s4, const double* s5,
                           const int* tab, const double* wt, int nint,
                           int nw, double* dy, int B, int nk, int mode,
                           int evolve_q, int nfam, int pitch,
                           void* stream) {
  if (8 * nw + 4 * nint > MAX_TABLE) return cudaErrorInvalidValue;
  static bool smem_set[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !smem_set[dev]) {
    cudaFuncSetAttribute(rhs_tail_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         MAX_SMEM);
    smem_set[dev] = true;
  }
  const int rows = staged_rows(mode, evolve_q, 9 * nfam);
  dim3 grid((nk + KT - 1) / KT, B);
  rhs_tail_kernel<<<grid, THREADS, rows * KT * 8 + 8 * nw + 4 * nint,
                    static_cast<cudaStream_t>(stream)>>>(
      y, eta, k, beta, Om, fcb, den, o11, s0, s1, s2, s3, s4, s5, tab, wt,
      dy, nk, mode, evolve_q, nfam, pitch, nw, nint);
  return static_cast<int>(cudaGetLastError());
}
