// K10 tab_leg: the convolution backward leg of the windowed FAST-PT
// engine, with the coefficient windows formed on the way in.
//
//   sab[b,s,f,a,:] = [Re | Im](ci[b,a] * g_s[f])   s = 0: ga, s = 1: gb
//   tab[b,s,f,a,n] = sum_k sab[b,s,f,a,k] dft_bwd_half[k,n]
//
// ci [B, 3, 2 half] = [re | im] is K9's output, g_s [NFAM, half] the
// gamma-function coefficients (re and im apart), dft_bwd_half [2 half,
// 2np] = [bc[:half]; bs[:half]] the length-2np backward DFT on the first
// half frequencies; tab [B, 2, nfam, 3, 2np] is what K1 out_leg reads.
// Replaces redtime_tpu/fastpt.py:1194-1203 (coeff, sab) and :1227 (tab =
// sab @ dft_bwd_half), on the TPU XLA fusions around a dot (Ozaki int8
// slice dots with tab_leg='ozaki'); no Pallas kernel.
//
// Bound on the card: operations.  At nk=128, 16 lanes, with RSD (nfam =
// 14) it is a product of M = 16 x 2 x 14 x 3 = 1344 rows, K = 2 half =
// 512 and N = 2np = 1024: 1.41 GFLOP, 21 us at 67 TFLOP/s on the FP64
// tensor cores, against 15.4 MB (dft_bwd_half 4.2 MB, tab 11.0 MB), 4.6
// us at 3.35 TB/s.  So:
//  * the FP64 tensor cores (mma.sync m16n8k8, dmma_tile.cuh): 64 x 64
//    block tiles (21 x 16 = 336 blocks at the main shape, two a SM),
//    eight warps of 16 x 32 each;
//  * sab never reaches device memory: a K-step takes 16 frequencies; the
//    ci and g rows the tile's products read (each once: a 64-row tile
//    touches at most 12 lanes' ci and the 2 nfam g rows) stream through a
//    2-stage cp.async ring beside dft_bwd_half's matching rows (bc, then
//    bs), and each thread forms 4 of the tile's 64 x 16 complex products
//    from them into the step's A tile, its real part in columns 0-15 and
//    its imaginary part in 16-31, with the plain version's roundings (no
//    FMA), so sab's bits are the plain version's.  A first version loaded
//    each product's four operands itself: 4x the loads, and 24 us of its
//    67 at the main shape (PERF.md);
//  * the next step's copies fly while the current step's A tile is formed
//    and multiplied: two barriers a step;
//  * ragged edges: rows past M, frequencies past half and columns past
//    2np are zero in both operands (never read, so a NaN there cannot
//    reach a product), so any nfam up to 14, lane count and grid runs
//    here.
// The sums run in another order than cuBLAS's: held to the dot product's
// forward-error bound, 2K eps (|sab| @ |dft_bwd_half|).
#include "dmma_tile.cuh"

namespace {

constexpr int BM = 64, BN = 64;        // block tile: rows (b,s,f,a) x n
constexpr int BKH = 16, BK = 2 * BKH;  // frequencies a step; re | im
constexpr int WM = 16, WN = 32;        // a warp's tile: 1 m16 x 4 n8 atoms
constexpr int THREADS = 32 * (BM / WM) * (BN / WN);
constexpr int KK = 8, SLOTS = KK / 4;  // mma.sync m16n8k8
constexpr int MATOM = WM / 16, NATOM = WN / 8;
constexpr int NFAM_MAX = 14;
// the operands of a step's complex products, staged as rows of BKH: for
// each lane the tile touches (at most BM / 6 + 2) and a, ci's re and im
// rows; for each side and family, g's re and im rows
constexpr int LANES_MAX = BM / 6 + 2;
constexpr int CI_ROWS = 6 * LANES_MAX, RAW_ROWS = CI_ROWS + 4 * NFAM_MAX;
constexpr int AP = BK + 4;             // pitches: 2 * pitch = 8 (mod 32),
constexpr int DP = BN + 4;             //   no bank conflicts
constexpr int D_STAGE = BK * DP, RAW_STAGE = RAW_ROWS * BKH;
constexpr int STAGE = D_STAGE + RAW_STAGE;
constexpr int SMEM_BYTES = 8 * (BM * AP + 2 * STAGE);
constexpr int PRODS = BM * BKH / THREADS;     // products a thread a step
constexpr int COPIES = BK * BN / 2 / THREADS; // 16-byte copies a thread
constexpr int RAW_RS = THREADS / BKH;         // raw rows a pass of copies
constexpr int RAW_COPIES = (RAW_ROWS + RAW_RS - 1) / RAW_RS;
static_assert(PRODS == 4 && COPIES == 4 && RAW_COPIES == 8,
              "a thread's share of a step");
static_assert(2 * SMEM_BYTES <= 232448, "two blocks a SM");

// 8 bytes global -> shared, asynchronously; zero-fills when !valid (the
// source is then not read, but must still be a mapped address)
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 8 : 0)
               : "memory");
}

__global__ void __launch_bounds__(THREADS, 2)
    tab_leg_kernel(const double* __restrict__ ci,
                   const double* __restrict__ ga_re,
                   const double* __restrict__ ga_im,
                   const double* __restrict__ gb_re,
                   const double* __restrict__ gb_im,
                   const double* __restrict__ D, double* __restrict__ tab,
                   int B, int nfam, int half, int N) {
  extern __shared__ __align__(16) double smem[];
  double* A = smem;                    // [BM][AP] the step's sab tile
  double* ring = smem + BM * AP;       // 2 x (D tile, raw rows)
  const int tid = threadIdx.x;
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  const int M = 6 * nfam * B;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (half + BKH - 1) / BKH;
  const int kq = tid % BKH;
  // the lanes the tile touches: b0 .. b0 + LANES_MAX - 1 at most
  const int b0 = m0 / (6 * nfam);

  // a thread's copies of the raw rows: row tid / BKH + RAW_RS i, frequency
  // kq of the step; its source row (nullptr: a lane past B or a family
  // past nfam, zero-filled)
  const double* raw_src[RAW_COPIES];
#pragma unroll
  for (int i = 0; i < RAW_COPIES; ++i) {
    const int row = tid / BKH + RAW_RS * i;
    const double* src = nullptr;
    if (row < CI_ROWS) {
      const int b = b0 + row / 6, a = row % 6 / 2, part = row % 2;
      if (b < B) src = ci + (size_t)(b * 3 + a) * 2 * half + part * half;
    } else if (row < RAW_ROWS) {
      const int q = row - CI_ROWS, s = q / (2 * NFAM_MAX);
      const int f = q % (2 * NFAM_MAX) / 2, part = q % 2;
      if (f < nfam)
        src = (s ? (part ? gb_im : gb_re) : (part ? ga_im : ga_re)) +
              (size_t)f * half;
    }
    raw_src[i] = src;
  }
  // a thread's copies of dft_bwd_half: chunk q = tid + THREADS i of the
  // stage's BK rows x BN / 2 column pairs; stage row j < BKH is bc's row
  // k0 + j, row BKH + j bs's row half + k0 + j
  const int d_col = 2 * (tid % (BN / 2)), d_row0 = tid / (BN / 2);
  constexpr int D_RS = THREADS / (BN / 2);
  const bool d_col_ok = n0 + d_col < N;

  auto load = [&](int slot, int kt) {
    double* st = ring + slot * STAGE;
#pragma unroll
    for (int i = 0; i < COPIES; ++i) {
      const int j = d_row0 + D_RS * i;
      const int k = kt * BKH + j % BKH;
      const bool ok = d_col_ok && k < half;
      const double* src = D + (size_t)(j / BKH * half + k) * N + n0 + d_col;
      rt::cp_async16(st + j * DP + d_col, ok ? src : D, ok);
    }
    const int k = kt * BKH + kq;
#pragma unroll
    for (int i = 0; i < RAW_COPIES; ++i) {
      const int row = tid / BKH + RAW_RS * i;
      const bool ok = raw_src[i] != nullptr && k < half;
      if (row < RAW_ROWS)
        cp_async8(st + D_STAGE + row * BKH + kq, ok ? raw_src[i] + k : D,
                  ok);
    }
  };
  // a thread's products: element e = tid + THREADS p of the tile's
  // BM x BKH, row e / BKH, frequency kq; the raw rows of its ci (re, then
  // im) and of its g (re, then im); rows past M multiply zeros
  int c_row[PRODS], g_row[PRODS];
#pragma unroll
  for (int p = 0; p < PRODS; ++p) {
    const int r = m0 + (tid + THREADS * p) / BKH;
    const int a = r % 3, f = (r / 3) % nfam, s = (r / (3 * nfam)) % 2;
    const bool in = r < M;
    c_row[p] = in ? (r / (6 * nfam) - b0) * 6 + 2 * a : CI_ROWS;
    g_row[p] = in ? CI_ROWS + (s * NFAM_MAX + f) * 2 : CI_ROWS;
  }
  // the plain version's complex product: (cr wr - cm wi, cr wi + cm wr)
  auto form_A = [&](int slot) {
    const double* raw = ring + slot * STAGE + D_STAGE + kq;
#pragma unroll
    for (int p = 0; p < PRODS; ++p) {
      const bool in = c_row[p] < CI_ROWS;
      const double cr = in ? raw[c_row[p] * BKH] : 0.0;
      const double cm = in ? raw[(c_row[p] + 1) * BKH] : 0.0;
      const double wr = raw[g_row[p] * BKH], wi = raw[(g_row[p] + 1) * BKH];
      double* row = A + ((tid + THREADS * p) / BKH) * AP + kq;
      row[0] = __dsub_rn(__dmul_rn(cr, wr), __dmul_rn(cm, wi));
      row[BKH] = __dadd_rn(__dmul_rn(cr, wi), __dmul_rn(cm, wr));
    }
  };

  // warp (wm, wn) owns rows WM wm .. and columns WN wn .. of the tile
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int a_off = (WM * wm + g) * AP + t;
  const int d_off = t * DP + WN * wn + g;
  double acc[MATOM][NATOM][4] = {};
  auto mma = [&](int slot) {
    const double* Ds = ring + slot * STAGE;
#pragma unroll
    for (int k = 0; k < BK; k += KK) {
      double a[MATOM][2 * SLOTS], bf[NATOM][SLOTS];
#pragma unroll
      for (int im = 0; im < MATOM; ++im)
#pragma unroll
        for (int i = 0; i < SLOTS; ++i) {
          a[im][2 * i] = A[a_off + 16 * im * AP + k + 4 * i];
          a[im][2 * i + 1] = A[a_off + (16 * im + 8) * AP + k + 4 * i];
        }
#pragma unroll
      for (int j = 0; j < NATOM; ++j)
#pragma unroll
        for (int i = 0; i < SLOTS; ++i)
          bf[j][i] = Ds[d_off + (k + 4 * i) * DP + 8 * j];
#pragma unroll
      for (int im = 0; im < MATOM; ++im)
#pragma unroll
        for (int j = 0; j < NATOM; ++j)
          rt::Dmma<KK>::run(acc[im][j], a[im], bf[j]);
    }
  };

  if (KT > 0) load(0, 0);
  rt::cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    // step kt's copies landed, and every warp is done with the sab tile
    // and the ring slot of step kt - 1
    rt::cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < KT) load((kt + 1) % 2, kt + 1);
    rt::cp_async_commit();
    form_A(kt % 2);
    __syncthreads();
    mma(kt % 2);
  }

  // d[0], d[1] = rows g, columns 2t, 2t+1; d[2], d[3] = row g + 8
#pragma unroll
  for (int im = 0; im < MATOM; ++im)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + WM * wm + 16 * im + g + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < NATOM; ++j) {
        const int n = n0 + WN * wn + 8 * j + 2 * t;
        if (n < N)  // N is even: n + 1 < N too
          *reinterpret_cast<double2*>(tab + (size_t)r * N + n) =
              make_double2(acc[im][j][2 * h], acc[im][j][2 * h + 1]);
      }
    }
}

}  // namespace

// ci [B, 3, 2 half], ga/gb re/im [>= nfam, half] with nfam <= NFAM_MAX,
// D [2 half, N], tab [B, 2, nfam, 3, N] (M = 6 nfam B rows), all
// contiguous f64, 16-byte aligned, on the current device; N = 2np even
// (the wrapper checks).
// Returns cudaGetLastError().
extern "C" int rt_tab_leg(const double* ci, const double* ga_re,
                          const double* ga_im, const double* gb_re,
                          const double* gb_im, const double* D, double* tab,
                          int B, int nfam, int half, int N, void* stream) {
  static bool smem_set[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !smem_set[dev]) {
    cudaFuncSetAttribute(tab_leg_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    smem_set[dev] = true;
  }
  const int M = 6 * nfam * B;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  tab_leg_kernel<<<grid, THREADS, SMEM_BYTES,
                   static_cast<cudaStream_t>(stream)>>>(
      ci, ga_re, ga_im, gb_re, gb_im, D, tab, B, nfam, half, N);
  return static_cast<int>(cudaGetLastError());
}
