// K9 engine_front: the front of the windowed FAST-PT engine, from the
// state's ln P rows to the extended spectrum and the forward leg.
//
//   x[b,a,m]     = sum_j lnP[b,a,j] pab_M[m,j] + (n_s[b] - 3) pab_v[m]
//   P_ext[b,a,m] = exp(clip(x, -80, 20)) wp[m]
//   ci[b,a,c]    = sum_m (P_ext[b,a,m] kbias[m]) fwd[m,c]
//
// with lnP first clipped to [LNP_MIN, LNP_MAX] when the caller asks (the
// RHS's clip of its state).  Replaces redtime_tpu/fastpt.py extend_power
// (:908-931, its clip at :930), the forward leg of compute_J_PZ_windowed
// (:1193) and the RHS's clip of lnP (redtime_tpu/trg.py:185), which on
// the TPU ran as XLA fusions around a dot (no Pallas kernel).  P_ext feeds
// K2 pz_leg and ci K10 tab_leg.
//
// Bound on the card: bytes.  At nk=128, np=512 and 16 lanes it reads
// pab_M (0.52 MB) and dft_fwd_half (2.1 MB) once and writes P_ext and ci
// (0.2 MB each): 3.05 MB, 0.91 us at 3.35 TB/s, against 31.5 MFLOP, 0.47
// us on the FP64 tensor cores; below the ~1.2 us launch floor.  So the
// design aims at latency, with every lane's work spread over 8 SMs:
//  * one cluster of 8 blocks for one lane, or for two where one lane a
//    cluster would take more waves of clusters (the wrapper asks the
//    CUDA runtime how many fit at once: 15 of these 512-thread blocks'
//    clusters on an H100) and two lanes' rows fit shared memory: rank r
//    extends the lanes' rows on the r-th eighth of the extended grid (a
//    warp four m's at once: coalesced pab_M rows against the staged ln P
//    rows, 16 loads a lane in flight, a butterfly sum), and pushes its
//    slice of P_ext kbias into every block of the cluster through
//    distributed shared memory; after the cluster's barrier each block
//    holds the whole rows without having computed them;
//  * each block then owns 64 columns of ci (a second cluster recomputes
//    the rows when 2 half passes 512): eight threads a column, each over
//    an eighth of m, reading dft_fwd_half's rows coalesced, 16 rows in
//    flight, and feeding three FMAs a lane from each element; the eighths
//    are summed in a fixed order, so the same inputs give the same bits
//    on every run;
//  * latency and the clusters' placement set the pace at these sizes: a
//    first version with one load in flight a thread took 19 us at 16
//    lanes, two waves of clusters (PERF.md);
//  * NaN stays NaN: both clips are comparisons (fmin / fmax would drop
//    a NaN lane's NaN), and no lane's work mixes with another's.
// The dot products run on the FP64 pipes, in another order than the plain
// version's GEMM: held to the forward-error bound.
#include "dmma_tile.cuh"

namespace {

constexpr int CLUSTER = 8;            // blocks of a lane group's cluster
constexpr int COLS = 64;              // ci columns a block
constexpr int THREADS = 512, WARPS = THREADS / 32;
constexpr int PARTS = THREADS / COLS; // threads a column, each over np/8
// loads in flight: a warp extends MG m's at once over JU j-steps of 32,
// a forward thread loads FU rows of dft_fwd_half before it multiplies
constexpr int MG = 4, JU = 4, FU = 16;
constexpr double LNP_MIN = -80.0, LNP_MAX = 20.0;    // trg's state clip
constexpr double EXT_MIN = -80.0, EXT_MAX = 20.0;    // extend_power's

// torch.clamp's rule: a NaN stays NaN
__device__ __forceinline__ double clampn(double x, double lo, double hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// LG lanes a cluster (their 3 LG rows share every load of pab_M and
// dft_fwd_half); lanes past B are zero rows that nothing stores
template <int LG>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
    engine_front_kernel(const double* __restrict__ lnP, long long lane_st,
                        long long row_st, const double* __restrict__ n_s,
                        long long ns_st, const double* __restrict__ pab_M,
                        const double* __restrict__ pab_v,
                        const double* __restrict__ wp,
                        const double* __restrict__ kbias,
                        const double* __restrict__ fwd,
                        double* __restrict__ P_ext, double* __restrict__ ci,
                        int B, int nk, int np, int nc, int clip) {
  constexpr int R = 3 * LG, G = MG;  // rows; m's a warp extends at once
  extern __shared__ __align__(16) double smem[];
  // this block has started: peers may push into its Q rows once every
  // block of the cluster has arrived here
  rt::cluster_arrive_relaxed();
  double* L = smem;             // [R][nk] the lanes' ln P rows
  double* Q = L + R * nk;       // [R][np] P_ext kbias, whole rows
  double* red = Q + R * np;     // [PARTS][R][COLS] the parts' sums
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b0 = blockIdx.y * LG;
  rt::cg::cluster_group cluster = rt::cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());

  for (int i = tid; i < R * nk; i += THREADS) {
    const int r = i / nk, b = b0 + r / 3;
    const double v = b < B ? lnP[b * lane_st + (r % 3) * row_st + i % nk]
                           : 0.0;
    L[i] = clip ? clampn(v, LNP_MIN, LNP_MAX) : v;
  }
  __syncthreads();

  // this rank's slice of the extended grid, a warp G m's at once: each
  // lane sums its j = lane + 32 i, all of a batch's JU x G loads issued
  // before the first FMA
  const int ms = (np + CLUSTER - 1) / CLUSTER;
  const int m_hi = min(np, (rank + 1) * ms);
  const bool store_P = blockIdx.x < CLUSTER;  // the group's first cluster
  rt::cluster_wait();
  for (int m0 = rank * ms + warp * G; m0 < m_hi; m0 += WARPS * G) {
    double s[G][R] = {};
    for (int j0 = lane; j0 < nk; j0 += 32 * JU) {
      double w[JU][G];
#pragma unroll
      for (int u = 0; u < JU; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int j = j0 + 32 * u, m = m0 + g;
          w[u][g] = j < nk && m < m_hi ? pab_M[(size_t)m * nk + j] : 0.0;
        }
#pragma unroll
      for (int u = 0; u < JU; ++u) {
        const int j = j0 + 32 * u;
        if (j >= nk) break;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const double l = L[r * nk + j];
#pragma unroll
          for (int g = 0; g < G; ++g) s[g][r] = fma(l, w[u][g], s[g][r]);
        }
      }
    }
    // a butterfly: every lane ends with the same bits (a + b = b + a)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int r = 0; r < R; ++r)
          s[g][r] += __shfl_xor_sync(0xffffffffu, s[g][r], o);
    // lane R g + r finishes row r at m0 + g
    double sum = 0.0;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (lane == R * g + r) sum = s[g][r];
    const int r = lane % R, m = m0 + lane / R, b = b0 + r / 3;
    if (lane < R * G && m < m_hi) {
      // the plain version's operations from the dot on, in its order
      const double c = b < B ? __dsub_rn(n_s[b * ns_st], 3.0) : 0.0;
      const double x = clampn(__dadd_rn(sum, __dmul_rn(c, pab_v[m])),
                              EXT_MIN, EXT_MAX);
      const double P = __dmul_rn(exp(x), wp[m]);
      if (store_P && b < B) P_ext[((size_t)b0 * 3 + r) * np + m] = P;
      const double q = __dmul_rn(P, kbias[m]);
#pragma unroll
      for (int k = 0; k < CLUSTER; ++k)
        cluster.map_shared_rank(Q, k)[r * np + m] = q;
    }
  }
  // every slice has landed in every block (the barrier orders the remote
  // stores before the reads); no block touches a peer's memory after it
  cluster.sync();

  // the forward leg: column n, eighth `part` of m
  const int col = tid % COLS, part = tid / COLS;
  const int n = blockIdx.x * COLS + col;
  const int kc = (np + PARTS - 1) / PARTS;
  const int k_lo = part * kc, k_hi = min(np, k_lo + kc);
  double acc[R] = {};
  if (n < nc) {
    const double* F = fwd + n;
    auto step = [&](int m, double f) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fma(Q[r * np + m], f, acc[r]);
    };
    int m = k_lo;
    for (; m + FU <= k_hi; m += FU) {
      double f[FU];
#pragma unroll
      for (int u = 0; u < FU; ++u) f[u] = F[(size_t)(m + u) * nc];
#pragma unroll
      for (int u = 0; u < FU; ++u) step(m + u, f[u]);
    }
    for (; m < k_hi; ++m) step(m, F[(size_t)m * nc]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) red[(part * R + r) * COLS + col] = acc[r];
  __syncthreads();
  if (part == 0 && n < nc) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (b0 + r / 3 >= B) break;
      double s = red[r * COLS + col];
#pragma unroll
      for (int p = 1; p < PARTS; ++p) s += red[(p * R + r) * COLS + col];
      ci[((size_t)b0 * 3 + r) * nc + n] = s;
    }
  }
}

// Shared memory of one block of LG lanes: the ln P rows, the whole Q rows
// and the parts' sums (the wrapper checks it against the SM's 227 KB).
size_t smem_bytes(int lg, int nk, int np) {
  return 8 * (size_t)(3 * lg) * ((size_t)nk + np + PARTS * COLS);
}

template <int LG>
void allow_smem() {
  static bool set[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !set[dev]) {
    cudaFuncSetAttribute(engine_front_kernel<LG>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         232448);
    set[dev] = true;
  }
}

template <int LG>
int launch(const double* lnP, long long lane_st, long long row_st,
           const double* n_s, long long ns_st, const double* pab_M,
           const double* pab_v, const double* wp, const double* kbias,
           const double* fwd, double* P_ext, double* ci, int B, int nk,
           int np, int nc, int clip, cudaStream_t stream) {
  allow_smem<LG>();
  // column tiles, rounded up to whole clusters (a block with no columns
  // still extends its slice)
  const int tiles = (nc + COLS - 1) / COLS;
  const int grid_x = (tiles + CLUSTER - 1) / CLUSTER * CLUSTER;
  engine_front_kernel<LG><<<dim3(grid_x, (B + LG - 1) / LG), THREADS,
                            smem_bytes(LG, nk, np), stream>>>(
      lnP, lane_st, row_st, n_s, ns_st, pab_M, pab_v, wp, kbias, fwd, P_ext,
      ci, B, nk, np, nc, clip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lnP [B, 3, nk] with lane stride lane_st, row stride row_st and unit
// column stride; n_s [B] with stride ns_st; pab_M [np, nk], pab_v, wp,
// kbias [np], fwd [np, nc] contiguous; P_ext [B, 3, np] and ci [B, 3, nc]
// contiguous outputs; f64 on the current device.  lanes: 1 or 2 lanes a
// cluster (the wrapper's choice, engine_front.lanes).  Returns
// cudaGetLastError().
extern "C" int rt_engine_front(const double* lnP, long long lane_st,
                               long long row_st, const double* n_s,
                               long long ns_st, const double* pab_M,
                               const double* pab_v, const double* wp,
                               const double* kbias, const double* fwd,
                               double* P_ext, double* ci, int B, int nk,
                               int np, int nc, int clip, int lanes,
                               void* stream) {
  auto run = lanes == 2 ? launch<2> : launch<1>;
  return run(lnP, lane_st, row_st, n_s, ns_st, pab_M, pab_v, wp, kbias, fwd,
             P_ext, ci, B, nk, np, nc, clip,
             static_cast<cudaStream_t>(stream));
}

// How many clusters of `lanes` lanes at (nk, np) the current device runs at
// once (cudaOccupancyMaxActiveClusters); 0 when it cannot say.
extern "C" int rt_engine_front_clusters(int lanes, int nk, int np) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(lanes, nk, np);
  int n = 0;
  cudaError_t err;
  if (lanes == 2) {
    allow_smem<2>();
    err = cudaOccupancyMaxActiveClusters(&n, engine_front_kernel<2>, &cfg);
  } else {
    allow_smem<1>();
    err = cudaOccupancyMaxActiveClusters(&n, engine_front_kernel<1>, &cfg);
  }
  return err == cudaSuccess ? n : 0;
}
