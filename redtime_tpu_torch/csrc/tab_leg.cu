// K10 tab_leg: the convolution backward leg of the windowed FAST-PT
// engine, with the coefficient windows formed on the way in.
//
//   X[b,s,f,a,k]   = ci[b,a,k] g_s[f,k]        k < half, s = 0: ga, 1: gb
//   tab[b,s,f,a,n] = Re sum_{k<half} c_k X[b,s,f,a,k] exp(2 pi i k n / N)
//
// with N = 2np, half = np / 2 = N / 4, c_0 = 1 and c_k = 2 otherwise: the
// inverse real DFT of length N of a spectrum that is zero from N / 4 on.
// ci [B, 3, 2 half] = [re | im] is K9's output, g_s [NFAM, half] the gamma
// coefficients (re and im apart); tab [B, 2, nfam, 3, N] is what K1
// out_leg reads.  The plain version (kernels/tab_leg.py) forms sab = [Re
// X | Im X] and multiplies it by the dense matrix dft_bwd_half [2 half,
// N]; this kernel reads no such matrix.  Replaces
// redtime_tpu/fastpt.py:1194-1203 (coeff, sab) and :1227 (tab = sab @
// dft_bwd_half), on the TPU XLA fusions around a dot (the TPU has no f64
// FFT); no Pallas kernel.
//
// Design: a real-output (C2R) FFT of the row, through one complex FFT of
// length np = N / 2 (csrc/fft_smem.cuh).  With w = w_N^k, the sequence
//   Z_0 = (Re X_0)(1 + i),  Z_k = X_k + i w X_k,
//   Z_{np-k} = conj(X_k - i w X_k)  (0 < k < half),  Z_half = 0
// has z = IDFT_np(Z) with z_m = tab[2m] + i tab[2m+1]: the transform's
// output, written as pairs of doubles, is the tab row itself.  (Four
// complex transforms of length N / 4, one a residue of n mod 4, would do
// twice the operations for real outputs.)  X keeps the plain version's
// roundings (__dmul_rn, __dsub_rn, __dadd_rn), so its bits are sab's.
//
// A block owns RB rows of one (b, a), which share ci[b, a] (read from L1
// by each row).  A first pass forms each X_k once and from it Z_k and
// Z_{np-k} in shared memory (each pair with one twiddle product); the
// stages then run the RB transforms side by side through the padded
// buffers, and the last writes tab straight from registers, 16 bytes a
// thread, consecutive threads on consecutive pairs.  Where rows alone
// leave the card's 132 SMs short of blocks (the presets' 2 lanes: 84
// rows of np = 2048), S blocks share a row: block h computes the outputs
// m = S m' + h, from the S-fold sums Z'_{k'} = w_np^{k' h} sum_t Z_{k' +
// t np/S} w_S^{t h} (one step of decimation in frequency) through an FFT
// of length np / S.  The wrapper picks RB, S and the block's threads
// (kernels/tab_leg.py launch_plan).
//
// Bound on the card: bytes.  At nk=128, 16 lanes, with RSD (nfam = 14)
// the kernel reads ci (0.2 MB), g and the twiddles and writes tab (11.0
// MB, 1344 rows of 1024): 3.4 us at 3.35 TB/s; the FFT's 1344 x 2.4e4
// flops take about 1 us on the FP64 pipes at 34 TFLOP/s.  Measured
// (PERF.md): the stages, not the stores, set the pace.
//
// Rounding: the FFT's order, held to tab_leg.error_bound.  NaN: a
// non-finite X anywhere in a row makes the whole row NaN, as in the plain
// version's product (X_0's imaginary part, which the transform does not
// read, enters as Im X_0 * 0).
#include "fft_smem.cuh"

namespace {

constexpr int MAX_THREADS = 256;  // tab_leg.MAX_THREADS

__global__ void __launch_bounds__(MAX_THREADS)
    tab_leg_kernel(const double* __restrict__ ci,
                   const double* __restrict__ ga_re,
                   const double* __restrict__ ga_im,
                   const double* __restrict__ gb_re,
                   const double* __restrict__ gb_im,
                   const double2* __restrict__ tw, double* __restrict__ tab,
                   int nfam, int half, int RB, int G, int S,
                   rt_fft::Plan plan) {
  extern __shared__ __align__(16) double smem[];
  const int np = 2 * half, N = 2 * np, ns = np / S;
  const int h = blockIdx.x % S, grp = blockIdx.x / S % G;
  const int pair = blockIdx.x / S / G, b = pair / 3, a = pair % 3;
  const int q0 = grp * RB, rows = min(RB, 2 * nfam - q0);
  double2* buf0 = reinterpret_cast<double2*>(smem);
  double2* buf1 = buf0 + rt_fft::padded(RB * ns);
  double2* Zs = buf1;  // [rows][np]: Z, read by stage 0 only
  // the block's tab rows, as offsets of pairs
  long long* out_row = reinterpret_cast<long long*>(
      buf1 + max(rt_fft::padded(RB * ns), RB * np));
  if (threadIdx.x < rows) {
    const int q = q0 + threadIdx.x, s = q / nfam, f = q - s * nfam;
    out_row[threadIdx.x] =
        (((long long)(b * 2 + s) * nfam + f) * 3 + a) * np;
  }

  double2* out = reinterpret_cast<double2*>(tab);
  auto last = [&](int row, int m, double2 v) {
    out[out_row[row] + S * m + h] = v;
  };
  const double* cr = ci + (size_t)pair * np;
  // X = ci[b, a] g_s[f] for the block's rows (ci's row is read by every
  // row of the block, from L1), and from it Z_k and Z_{np-k}
  for (int t = threadIdx.x; t < rows * half; t += blockDim.x) {
    const int row = t / half, k = t - row * half;
    const int q = q0 + row, s = q / nfam, f = q - s * nfam;
    const size_t g = (size_t)f * half + k;
    const double wr = s ? gb_re[g] : ga_re[g], wi = s ? gb_im[g] : ga_im[g];
    const double c = cr[k], m = cr[half + k];
    const double2 x =
        make_double2(__dsub_rn(__dmul_rn(c, wr), __dmul_rn(m, wi)),
                     __dadd_rn(__dmul_rn(c, wi), __dmul_rn(m, wr)));
    double2* z = Zs + row * np;
    if (k == 0) {
      const double re = __dadd_rn(x.x, __dmul_rn(x.y, 0.0));
      z[0] = make_double2(re, re);
      z[half] = make_double2(0.0, 0.0);
    } else {
      const double2 wx = rt_fft::cmul(__ldg(tw + k), x);
      z[k] = make_double2(x.x - wx.y, x.y + wx.x);
      z[np - k] = make_double2(x.x + wx.y, wx.x - x.y);
    }
  }
  __syncthreads();

  // stage 0 reads Z, or (S > 1) the S-fold sums of decimation in
  // frequency for the outputs S m + h
  auto first = [&](int row, int k) {
    const double2* z = Zs + row * np;
    if (S == 1) return z[k];
    double2 acc = make_double2(0.0, 0.0);
    for (int t = 0; t < S; ++t)
      acc = rt_fft::cadd(acc, rt_fft::cmul(z[k + t * ns],
                                           __ldg(tw + t * h % S * (N / S))));
    return rt_fft::cmul(acc, __ldg(tw + 2 * k * h));
  };
  rt_fft::run<true>(plan, rows, ns, tw, N, buf0, buf1, first, last);
}

}  // namespace

// ci [B, 3, np], ga/gb re/im [>= nfam, half] with np = 2 half, tw [2np]
// (w_{2np}^j as (cos, sin) pairs), tab [B, 2, nfam, 3, 2np], all
// contiguous f64 on the current device, 16-byte aligned; plan[nst] the
// radices of the length-np/S FFT (fourier.fft_plan); RB rows a block, S
// blocks a row (S divides np), `threads` threads a block, smem bytes of
// shared memory (the wrapper's launch_plan).
// Returns cudaGetLastError().
extern "C" int rt_tab_leg(const double* ci, const double* ga_re,
                          const double* ga_im, const double* gb_re,
                          const double* gb_im, const double* tw, double* tab,
                          int B, int nfam, int half, int RB, int S,
                          int threads, int smem, const int* plan, int nst,
                          void* stream) {
  rt_fft::Plan p = {};
  if (nst < 1 || nst > rt_fft::MAX_STAGES || threads > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  p.nst = nst;
  for (int s = 0; s < nst; ++s) p.radix[s] = plan[s];
  static int smem_set[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && smem_set[dev] < smem) {
    cudaFuncSetAttribute(tab_leg_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    smem_set[dev] = smem;
  }
  const int G = (2 * nfam + RB - 1) / RB;
  tab_leg_kernel<<<3 * B * G * S, threads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      ci, ga_re, ga_im, gb_re, gb_im, reinterpret_cast<const double2*>(tw),
      tab, nfam, half, RB, G, S, p);
  return static_cast<int>(cudaGetLastError());
}
