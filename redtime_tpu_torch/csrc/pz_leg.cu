// K2 pz_leg: the Z-kernel Toeplitz contraction of the windowed engine,
// with its outer-factor epilogue fused.
//
//   conv[b,n,a,i]   = sum_m T[n,i,m] * P[b,a,m]
//   PZ[b,n,a,c,i]   = (kfac[i] * conv[b,n,a,i]) * P[b,c,nshift+i]
//
// Replaces redtime_tpu/fastpt.py _pz_windowed, which on the TPU ran the
// contraction as Ozaki int8 slice dots (the oz_t_* packs) to emulate f64
// on the MXU.  The contraction cancels about 1e8 of its operand scale per
// element, so it is accumulated in f64 on the tensor cores, with no split
// and no reduced precision.
//
// Bound on the card: bytes.  At nk=128 and 16 lanes the product is
// R = 7nk = 896 rows of T by Q = 3B = 48 spectra over K = np = 512: T
// (3.67 MB), P (0.2 MB) and PZ (1.03 MB) are 4.9 MB, 1.46 us at 3.35
// TB/s, against 44 MFLOP, 0.66 us at 67 TFLOP/s.  Too small a product to
// fill the card by tiles alone, so:
//  * each block owns a strip of 32 T rows and 48 spectra (two m16 by six
//    n8 atoms, one m16 x 24 slab per warp on the FP64 tensor cores) and
//    streams its K-slice of both through a 4-stage cp.async ring: T is
//    read once (for up to 16 lanes), the spectra from L2;
//  * K is split 8 ways inside a cluster (224 blocks at nk=128, B=16), the
//    partial tiles summed through distributed shared memory in rank order
//    (no atomics: the same bits on every run);
//  * the outer factor is applied after that sum, so conv never reaches
//    device memory and PZ is written once.
// What bounds it: with 4 K-steps a block, the ring's fill, the cluster's
// sum and the epilogue weigh as much as the main loop.
#include "dmma_tile.cuh"

namespace {

constexpr int BM = 32;                // T rows r = n nk + i
constexpr int BN = 48;                // spectra q = 3 b + a
constexpr int BK = 16, STAGES = 4;
constexpr int KSPLIT = 8;             // blocks of a cluster, each 1/8 of K
constexpr int KK = 16, SLOTS = KK / 4; // mma.sync m16n8k16
constexpr int WARPS = 2 * (BM / 16);  // warp w: m atom w / 2, n atoms
constexpr int NATOM = BN / 16;        //   3 (w % 2) .. 3 (w % 2) + 2
constexpr int THREADS = 32 * WARPS;
constexpr int TP = BK + 4;            // 2 * pitch = 8 (mod 32): no conflicts
constexpr int STAGE = (BM + BN) * TP;
constexpr int CHUNKS = (BM + BN) * BK / 2;      // 16-byte copies a stage
constexpr int COLS_PER_RANK = BN / KSPLIT;      // spectra each block sums
constexpr int ELEMS = BM * COLS_PER_RANK;       // outputs each block sums
constexpr int EITER = (ELEMS + THREADS - 1) / THREADS;
// the ring, then the receive buffer of the KSPLIT partials of this
// block's columns, [rank][column][row]
constexpr int RING = STAGES * STAGE;
constexpr int SMEM_BYTES = 8 * (RING + BM * BN);
static_assert(BK % KK == 0, "mma shape");
static_assert(BN % KSPLIT == 0, "columns must split over the cluster");

__global__ void __cluster_dims__(1, 1, KSPLIT) __launch_bounds__(THREADS)
    pz_leg_kernel(const double* __restrict__ T, const double* __restrict__ P,
                  const double* __restrict__ kfac, double* __restrict__ out,
                  int B, int nk, int np, int nshift) {
  extern __shared__ __align__(16) double smem[];
  // this block has started: peers may push into its receive buffer once
  // every block of the cluster has arrived here (waited on before the
  // pushes)
  rt::cluster_arrive_relaxed();
  const int R = 7 * nk, Q = 3 * B;
  const int tid = threadIdx.x;
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int q0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  rt::cg::cluster_group cluster = rt::cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int k_len = np / KSPLIT;
  const int k0 = rank * k_len;

  // the epilogue's operands, which do not depend on the contraction: read
  // now, so their latency hides behind the main loop.  Output e of this
  // block is row e % BM of column rank COLS_PER_RANK + e / BM:
  // consecutive threads take consecutive rows i, so a warp's PZ stores
  // are contiguous.
  double e_kfac[EITER], e_p[EITER][3];
#pragma unroll
  for (int it = 0; it < EITER; ++it) {
    const int e = tid + it * THREADS;
    const int r = r0 + e % BM, q = q0 + rank * COLS_PER_RANK + e / BM;
    const bool ok = e < ELEMS && r < R && q < Q;
    const int i = ok ? r % nk : 0, b = ok ? q / 3 : 0;
    e_kfac[it] = kfac[i];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      e_p[it][c] = P[((size_t)b * 3 + c) * np + nshift + i];
  }

  // stage rows 0..BM-1 are T rows, BM..BM+BN-1 spectra; both K-contiguous
  auto load = [&](int slot, int kt) {
    double* st = smem + slot * STAGE;
    for (int i = tid; i < CHUNKS; i += THREADS) {
      const int row = i / (BK / 2), kp = i % (BK / 2);
      const bool is_t = row < BM;
      const int src_row = is_t ? r0 + row : q0 + row - BM;
      const bool ok = src_row < (is_t ? R : Q);
      const double* src = (is_t ? T : P) + (size_t)(ok ? src_row : 0) * np
          + k0 + kt * BK + 2 * kp;
      rt::cp_async16(st + row * TP + 2 * kp, src, ok);
    }
  };

  const int ma = (warp / 2) * 16 + g;              // fragment rows ma, ma+8
  const int nb = BM + 8 * NATOM * (warp % 2) + g;  // first column's row
  double acc[NATOM][4];
#pragma unroll
  for (int j = 0; j < NATOM; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0;
  auto compute = [&](int slot) {
    const double* st = smem + slot * STAGE + t;
#pragma unroll
    for (int k = 0; k < BK; k += KK) {
      double a[2 * SLOTS];
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        a[2 * i] = st[ma * TP + k + 4 * i];
        a[2 * i + 1] = st[(ma + 8) * TP + k + 4 * i];
      }
#pragma unroll
      for (int j = 0; j < NATOM; ++j) {
        double b[SLOTS];
#pragma unroll
        for (int i = 0; i < SLOTS; ++i)
          b[i] = st[(nb + 8 * j) * TP + k + 4 * i];
        rt::Dmma<KK>::run(acc[j], a, b);
      }
    }
  };
  rt::pipeline<STAGES>(k_len / BK, load, compute);

  // the sum over the cluster: rank q owns columns [q COLS_PER_RANK, ...).
  // Each block pushes its partial columns into their owner's receive
  // buffer, slot [rank], once every block of the cluster has started;
  // after the barrier each owner adds its KSPLIT
  // slots in rank order.  Remote stores only: no block waits on a remote
  // load, and none touches a peer's memory after the barrier.
  double* recv = smem + RING;
  rt::cluster_wait();
#pragma unroll
  for (int j = 0; j < NATOM; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * NATOM * (warp % 2) + 8 * j + 2 * t + e % 2;
      const int row = ma + 8 * (e / 2);
      double* dst = cluster.map_shared_rank(recv, col / COLS_PER_RANK);
      dst[(rank * COLS_PER_RANK + col % COLS_PER_RANK) * BM + row] =
          acc[j][e];
    }
  cluster.sync();
#pragma unroll
  for (int it = 0; it < EITER; ++it) {
    const int e = tid + it * THREADS;
    const int r = r0 + e % BM, q = q0 + rank * COLS_PER_RANK + e / BM;
    if (e < ELEMS && r < R && q < Q) {
      double s = recv[e];
#pragma unroll
      for (int k = 1; k < KSPLIT; ++k) s += recv[k * ELEMS + e];
      const int n = r / nk, i = r % nk, b = q / 3, a = q % 3;
      const double w = e_kfac[it] * s;
      double* o = out + ((((size_t)b * 7 + n) * 3 + a) * 3) * nk + i;
#pragma unroll
      for (int c = 0; c < 3; ++c) o[(size_t)c * nk] = w * e_p[it][c];
    }
  }
}

}  // namespace

// T [7, nk, np], P [B, 3, np], kfac [nk], out [B, 7, 3, 3, nk]; f64,
// contiguous, 16-byte aligned, on the current device; np a multiple of
// KSPLIT * BK (the wrapper checks).  Returns cudaGetLastError().
extern "C" int rt_pz_leg(const double* T, const double* P, const double* kfac,
                         double* out, int B, int nk, int np, int nshift,
                         void* stream) {
  static bool smem_set[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !smem_set[dev]) {
    cudaFuncSetAttribute(pz_leg_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    smem_set[dev] = true;
  }
  dim3 grid((3 * B + BN - 1) / BN, (7 * nk + BM - 1) / BM, KSPLIT);
  pz_leg_kernel<<<grid, THREADS, SMEM_BYTES,
                  static_cast<cudaStream_t>(stream)>>>(T, P, kfac, out, B, nk,
                                                       np, nshift);
  return static_cast<int>(cudaGetLastError());
}

// np must be a multiple of this (the wrapper checks)
extern "C" int rt_pz_leg_k_step() { return KSPLIT * BK; }
