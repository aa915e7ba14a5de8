// K1 out_leg: the per-family output leg of the windowed FAST-PT engine.
//
//   Jw[b,f,a,c,o] = sum_n (tab[b,0,f,a,n] * tab[b,1,f,c,n] / 2np) * G[f,n,o]
//
// Replaces, on the TPU side, the fused Ozaki output leg (the Pallas kernel
// probe4.kernel in scripts/probe_pallas.py, and the int8 slice dots of
// redtime_tpu/fastpt.py compute_J_PZ_windowed, out_leg='ozaki'): the TPU
// split each f64 operand into 7-bit int8 slices so its MXU could emulate
// f64.  Hopper multiplies f64 natively, so here the composite matrix G
// (per family: the f/tau phase, the restricted even-sample backward DFT
// and the prek factor, built in f64 on the host) is contracted directly.
//
// Bound on the card: f64 FMA throughput.  At nk=128 the contraction is
// 14 families x (M = 9B rows, K = 2np = 1024, N = nk+1 = 129).  The pair
// product is 9x the size of tab ([B,14,3,3,1024] f64 is 66 MB at B=64), so
// it is formed in the tile loader and never written to device memory:
// device traffic is tab and G once per tile, and the FMAs run from shared
// memory and registers.  A first, simple kernel: no tensor-core DMMA, no
// TMA pipeline.
#include <cuda_runtime.h>

#include "tile_product.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);

__global__ void __launch_bounds__(THREADS)
    out_leg_kernel(const double* __restrict__ tab,
                   const double* __restrict__ G, double* __restrict__ out,
                   int B, int nfam, int K, int O, double inv_n2) {
  const int f = blockIdx.z;
  const int M = B * 9;
  const int m0 = blockIdx.y * BM;
  const int o0 = blockIdx.x * BN;
  const double* Gf = G + (size_t)f * K * O;

  // A row m = (b, a, c): the pair product of the two spectra rows
  auto load_a = [&](int mm, int k) -> double {
    const int m = m0 + mm;
    if (m >= M) return 0.0;
    const int b = m / 9, a = (m % 9) / 3, c = m % 3;
    const double ta = tab[(((size_t)b * 2 + 0) * nfam + f) * 3 * K +
                          (size_t)a * K + k];
    const double tb = tab[(((size_t)b * 2 + 1) * nfam + f) * 3 * K +
                          (size_t)c * K + k];
    return ta * tb * inv_n2;  // 2np is a power of two: exact scaling
  };
  auto load_b = [&](int k, int nn) -> double {
    const int o = o0 + nn;
    return o < O ? Gf[(size_t)k * O + o] : 0.0;
  };

  double acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0;
  tile_product<BM, BN, BK, TM, TN, false>(acc, K, load_a, load_b);

  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * (BM / TM);
    if (m >= M) continue;
    const int b = m / 9, ac = m % 9;
    double* row = out + (((size_t)b * nfam + f) * 9 + ac) * O;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = o0 + tx + j * (BN / TN);
      if (o < O) row[o] = acc[i][j];
    }
  }
}

}  // namespace

// tab [B, 2, nfam, 3, K], G [nfam, K, O], out [B, nfam, 3, 3, O]; f64,
// contiguous, on the current device.  Returns cudaGetLastError().
extern "C" int rt_out_leg(const double* tab, const double* G, double* out,
                          int B, int nfam, int K, int O, void* stream) {
  const int M = B * 9;
  dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM, nfam);
  out_leg_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      tab, G, out, B, nfam, K, O, 1.0 / K);
  return static_cast<int>(cudaGetLastError());
}
