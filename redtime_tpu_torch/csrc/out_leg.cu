// K1 out_leg: the per-family output leg of the windowed FAST-PT engine.
//
//   Jw[b,f,a,c,o] = sum_n (tab[b,0,f,a,n] * tab[b,1,f,c,n] / 2np) * G[f,n,o]
//
// Replaces redtime_tpu/fastpt.py:1228-1303 (compute_J_PZ_windowed's output
// leg), which has no Pallas kernel; on the TPU it ran as XLA fusions, with
// out_leg='ozaki' as int8 slice dots: the TPU split each f64 operand into
// 7-bit int8 slices so its MXU could emulate f64 (the Pallas probe of that
// technique, probe4.kernel, is K7 oz_fused).  Hopper multiplies f64
// natively, so here the composite matrix G
// (per family: the f/tau phase, the restricted even-sample backward DFT
// and the prek factor, built in f64 on the host) is contracted directly.
//
// Bound on the card: bytes.  At nk=128 and 16 lanes the contraction is 14
// families x (M = 9B = 144 rows, K = 2np = 1024, N = nk+1 = 129): tab
// (11.0 MB), G (14.8 MB) and Jw (2.1 MB) are 27.9 MB, 8.3 us at 3.35 TB/s,
// against 533 MFLOP, 7.9 us at 67 TFLOP/s on the FP64 tensor cores.  What
// the design does about each limit:
//  * the FP64 tensor cores (mma.sync m16n8k8, dmma_tile.cuh): warps 0-7
//    each own an m16 row atom over the tile's nine n8 column atoms, so one
//    B fragment read serves one mma and the A fragment nine; the ninth m16
//    atom is split over warps 8-11, one on each of the SM's schedulers
//    (see WARPS below);
//  * a block tile of 16 lanes x 72 columns: M = 144 is exactly nine m16
//    atoms, and 129 columns take two tiles of 72 (10% padding, against
//    50% for 64 x 64 tiles);
//  * the pair product never reaches device memory: the ring stages the
//    3 a-rows and 3 c-rows of each lane (6 rows, not 9 products), and the
//    A fragments multiply them while they are read; the 1/2np is applied
//    once to the sums, as a multiply (exact when 2np is a power of two,
//    as on the reference's grids; else within the dot product's error
//    bound);
//  * a 2-stage cp.async ring over K-steps of 32, so one step loads while
//    the other computes; each thread's copies are the same in every stage,
//    so their addresses are set up once; G's row pitch is a multiple of 16
//    bytes (the caller pads it), so its rows load in 16-byte copies;
//  * K split 4 ways inside a cluster (112 blocks of 384 threads, one per
//    SM), the partial tiles summed through distributed shared memory in
//    rank order: no atomics, the same bits on every run;
//  * any even 2np: the K-steps are dealt out to the ranks in whole steps,
//    and the copies past 2np are zero-filled (a rank may get none), so
//    every grid the solver takes (nk, np_factor) runs here.
// What still bounds it (PERF.md): the main loop's mma steps, below the
// tensor cores' peak rate, then the cluster's sum.

#include <type_traits>

#include "dmma_tile.cuh"

namespace {

constexpr int LANES = 16;             // lanes b of one block tile
constexpr int BM = 9 * LANES;         // 144 rows (b, a, c): nine m16 atoms
constexpr int BN = 72;                // columns o: nine n8 atoms
constexpr int BK = 32, STAGES = 2;    // K-step and stages of the ring
constexpr int KSPLIT = 4;             // blocks of a cluster, each 1/4 of K
constexpr int KK = 8, SLOTS = KK / 4; // mma.sync m16n8k8
constexpr int NATOM = BN / 8;
// Warps 0-7 each own m16 atom w over the tile's nine n8 atoms.  The
// ninth m16 atom (rows 128 ..) is split by n8 atoms over warps 8-11
// (3, 2, 2, 2 atoms), one on each of the SM's four schedulers (warp w
// runs on scheduler w % 4), so each scheduler issues 20 or 21 of the 81
// products of an mma step: nine whole-atom warps gave one scheduler 27.
constexpr int MAIN_WARPS = BM / 16 - 1;
constexpr int WARPS = MAIN_WARPS + 4;
constexpr int THREADS = 32 * WARPS;   // 384
// threads that copy G: a multiple of the BN / 2 = 36 copies of a G row
constexpr int COPY_THREADS = 8 * (BN / 2);
constexpr int TROWS = 6 * LANES;      // staged tab rows: (lane, side, a)
// pitches (doubles) chosen so that a half-warp's fragment reads fall in
// distinct banks: 2 * pitch = 8 or 24 (mod 32)
constexpr int TP = BK + 4;
constexpr int GP = BN + 4;
constexpr int STAGE_T = TROWS * TP;
constexpr int STAGE = STAGE_T + BK * GP;
constexpr int ROWS_PER_RANK = BM / KSPLIT;      // rows each block sums
// the ring, then the receive buffer of the KSPLIT partials of this
// block's rows, a region of its own: peers push into it while this block
// may still be in its main loop
constexpr int SLOT = ROWS_PER_RANK * BN;
constexpr int RING = STAGES * STAGE, RECV = KSPLIT * SLOT;
constexpr int SMEM_BYTES = 8 * (RING + RECV);
static_assert(SMEM_BYTES <= 232448, "ring and receive buffer fit the SM");
static_assert(BN % 8 == 0 && BK % KK == 0, "tile and mma shapes");
static_assert(BM % KSPLIT == 0, "rows must split over the cluster");
static_assert(NATOM == 9 && MAIN_WARPS == 8, "the split 3 + 2 + 2 + 2");

__global__ void __cluster_dims__(1, 1, KSPLIT) __launch_bounds__(THREADS, 1)
    out_leg_kernel(const double* __restrict__ tab,
                   const double* __restrict__ G, double* __restrict__ out,
                   int B, int nfam, int K, int O, long long g_fam,
                   int g_row, double inv_n2) {
  extern __shared__ __align__(16) double smem[];
  // this block has started: peers may push into its receive buffer once
  // every block of the cluster has arrived here (waited on before the
  // pushes, so the main loop hides the wait)
  rt::cluster_arrive_relaxed();
  const int tid = threadIdx.x;
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int n0 = blockIdx.x * BN;
  const int b0 = blockIdx.y * LANES;
  const int f = blockIdx.z / KSPLIT;
  rt::cg::cluster_group cluster = rt::cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  // this rank's K-steps: whole steps of BK, dealt out in rank order; the
  // last step may pass K, and a rank may get none
  const int KT = (K + BK - 1) / BK, kt_per = (KT + KSPLIT - 1) / KSPLIT;
  const int kt_n = max(0, min(kt_per, KT - rank * kt_per));
  const int k0 = rank * kt_per * BK;

  // the copies of one K-step: tab row (lane, side, a) pair kp, and G row
  // kk column pair o; lanes past B, columns past O and K-indices past K
  // are zero-filled (from a mapped address, tab's or G's first element)
  const double* tab_f = tab + (size_t)f * 3 * K + k0;
  const int tab_lane = 2 * nfam * 3 * K;  // tab's stride along b
  const double* Gf = G + f * g_fam + (size_t)k0 * g_row;
  // Each thread's copies are the same in every stage: 16-byte chunk t_kp
  // of the staged tab rows t_row0 + T_RS n and column pair g_o of the G
  // rows g_kk0 + G_RS n.  Their offsets are set up here, once, so a copy
  // costs an add and the cp.async.
  constexpr int T_RS = THREADS / (BK / 2), T_N = (TROWS + T_RS - 1) / T_RS;
  constexpr int G_RS = COPY_THREADS / (BN / 2), G_N = BK / G_RS;
  static_assert(THREADS % (BK / 2) == 0 && COPY_THREADS % (BN / 2) == 0 &&
                    BK % G_RS == 0, "copies fixed per thread");
  const int t_kp = 2 * (tid % (BK / 2)), t_row0 = tid / (BK / 2);
  int t_src[T_N];  // offset in tab_f; -1: a lane past B (zero-filled)
#pragma unroll
  for (int n = 0; n < T_N; ++n) {
    const int row = t_row0 + T_RS * n;
    const int b = b0 + row / 6, side = (row % 6) / 3, a = row % 3;
    t_src[n] = b < B ? b * tab_lane + (side * nfam * 3 + a) * K + t_kp : -1;
  }
  const int g_o = 2 * (tid % (BN / 2)), g_kk0 = tid / (BN / 2);
  const bool g_ok = n0 + g_o < O;
  // o + 1 may pass O: it stays inside the row pitch
  const double* g_src = Gf + (size_t)g_kk0 * g_row + (g_ok ? n0 + g_o : 0);
  auto load = [&](int slot, int kt) {
    double* st = smem + slot * STAGE;
    const int kb = k0 + kt * BK;  // the step's first K-index
    const bool t_in = kb + t_kp < K;
#pragma unroll
    for (int n = 0; n < T_N; ++n) {
      const int row = t_row0 + T_RS * n;
      const bool ok = t_in && t_src[n] >= 0;
      if (TROWS % T_RS == 0 || row < TROWS)
        rt::cp_async16(st + row * TP + t_kp,
                       ok ? tab_f + t_src[n] + kt * BK : tab, ok);
    }
    const double* gs = g_src + (size_t)kt * BK * g_row;
    if (tid >= COPY_THREADS) return;
#pragma unroll
    for (int n = 0; n < G_N; ++n) {
      const bool ok = g_ok && kb + g_kk0 + G_RS * n < K;
      rt::cp_async16(st + STAGE_T + (g_kk0 + G_RS * n) * GP + g_o,
                     ok ? gs + (size_t)(G_RS * n) * g_row : G, ok);
    }
  };

  // the warp's two fragment rows r = 16 m_atom + g (+8) are pairs (a, c)
  // of lane r / 9: their a-row and c-row in the stage; a split warp's n8
  // atoms are n_first .. n_first + n_cnt - 1
  const bool split = warp >= MAIN_WARPS;
  const int m_atom = split ? MAIN_WARPS : warp;
  const int sw = warp - MAIN_WARPS;
  const int n_cnt = split ? (sw == 0 ? 3 : 2) : NATOM;
  const int n_first = split ? (sw == 0 ? 0 : 1 + 2 * sw) : 0;
  int ta[2], tb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * m_atom + g + 8 * h;
    const int lane = r / 9, a = (r % 9) / 3, c = r % 3;
    ta[h] = (lane * 6 + a) * TP + t;
    tb[h] = (lane * 6 + 3 + c) * TP + t;
  }
  const int gb = STAGE_T + t * GP + g + 8 * n_first;

  double acc[NATOM][4];
#pragma unroll
  for (int j = 0; j < NATOM; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0;

  // one mma step: the pair products (unscaled: see the epilogue), then
  // the first NA n8 atoms of the warp's range
  auto step = [&](const double* st, int k, auto na) {
    constexpr int NA = decltype(na)::value;
    double a[2 * SLOTS];
#pragma unroll
    for (int i = 0; i < SLOTS; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[2 * i + h] = st[ta[h] + k + 4 * i] * st[tb[h] + k + 4 * i];
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      if (NA < NATOM && j >= n_cnt) break;
      double b[SLOTS];
#pragma unroll
      for (int i = 0; i < SLOTS; ++i)
        b[i] = st[gb + (k + 4 * i) * GP + 8 * j];
      rt::Dmma<KK>::run(acc[j], a, b);
    }
  };
  auto compute = [&](int slot) {
    const double* st = smem + slot * STAGE;
    if (!split) {
#pragma unroll
      for (int k = 0; k < BK; k += KK)
        step(st, k, std::integral_constant<int, NATOM>());
    } else {
#pragma unroll
      for (int k = 0; k < BK; k += KK)
        step(st, k, std::integral_constant<int, 3>());
    }
  };
  rt::pipeline<STAGES>(kt_n, load, compute);

  // the cluster's sum: rank q owns rows [q ROWS_PER_RANK, (q+1)
  // ROWS_PER_RANK).  Each block pushes its partial rows into their
  // owner's receive buffer, slot [rank], once every block of the cluster
  // has started; after the barrier each owner adds its KSPLIT slots in
  // rank order.  Remote stores only: no block waits on a remote load, and
  // none touches a peer's memory after the barrier.
  double* recv = smem + RING;
  rt::cluster_wait();
  auto push = [&](int r, int col, double x, double y) {
    double* dst = cluster.map_shared_rank(recv, r / ROWS_PER_RANK)
        + (rank * ROWS_PER_RANK + r % ROWS_PER_RANK) * BN + col;
    *reinterpret_cast<double2*>(dst) = make_double2(x, y);
  };
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NATOM; ++j)
      if (j < n_cnt)
        push(16 * m_atom + g + 8 * h, 8 * (n_first + j) + 2 * t,
             acc[j][2 * h], acc[j][2 * h + 1]);
  cluster.sync();
  constexpr int PAIRS = ROWS_PER_RANK * BN / 2;
  for (int i = tid; i < PAIRS; i += THREADS) {
    const int rr = i / (BN / 2), o = n0 + 2 * (i % (BN / 2));
    const int r = rank * ROWS_PER_RANK + rr, b = b0 + r / 9;
    if (b < B && o < O) {
      const double* src = recv + rr * BN + o - n0;
      double2 s = *reinterpret_cast<const double2*>(src);
#pragma unroll
      for (int q = 1; q < KSPLIT; ++q) {
        const double2 v = *reinterpret_cast<const double2*>(
            src + q * SLOT);
        s.x += v.x;
        s.y += v.y;
      }
      // the 1/2np of the pair products, on the sums: the same bits as on
      // the products when 2np is a power of two
      s.x *= inv_n2;
      s.y *= inv_n2;
      double* dst = out + (((size_t)b * nfam + f) * 9 + r % 9) * O + o;
      dst[0] = s.x;
      if (o + 1 < O) dst[1] = s.y;
    }
  }
}

}  // namespace

// tab [B, 2, nfam, 3, K] contiguous; G [nfam, K, O] with unit stride along
// O, row stride g_row (even, >= O) and family stride g_fam; out [B, nfam,
// 3, 3, O] contiguous; f64, 16-byte aligned, on the current device.  K
// even (the wrapper checks).  Returns cudaGetLastError().
extern "C" int rt_out_leg(const double* tab, const double* G, double* out,
                          int B, int nfam, int K, int O, long long g_fam,
                          int g_row, void* stream) {
  static bool smem_set[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !smem_set[dev]) {
    cudaFuncSetAttribute(out_leg_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    smem_set[dev] = true;
  }
  dim3 grid((O + BN - 1) / BN, (B + LANES - 1) / LANES, nfam * KSPLIT);
  out_leg_kernel<<<grid, THREADS, SMEM_BYTES,
                   static_cast<cudaStream_t>(stream)>>>(
      tab, G, out, B, nfam, K, O, g_fam, g_row, 1.0 / K);
  return static_cast<int>(cudaGetLastError());
}
