// K2 pz_leg: the Z-kernel Toeplitz contraction of the windowed engine,
// with its outer-factor epilogue fused.
//
//   conv[b,n,a,i]   = sum_m T[n,i,m] * P[b,a,m]
//   PZ[b,n,a,c,i]   = (kfac[i] * conv[b,n,a,i]) * P[b,c,nshift+i]
//
// Replaces redtime_tpu/fastpt.py _pz_windowed, which on the TPU ran the
// contraction as Ozaki int8 slice dots (the oz_t_* packs) to emulate f64
// on the MXU.  The contraction cancels about 1e8 of its operand scale per
// element, so it is accumulated here in plain f64 FMAs, with no split and
// no reduced precision.
//
// Bound on the card: f64 FMA throughput on a small product (rows
// (n,i) = 7nk = 896, columns (b,a) = 3B, K = np = 512 at nk=128), so the
// tiles are small (32 x 16) to put enough blocks on the SMs.  The outer
// factor is applied in the epilogue, so conv never reaches device memory
// and PZ is written once.
#include <cuda_runtime.h>

#include "tile_product.cuh"

namespace {

constexpr int BM = 32, BN = 16, BK = 16, TM = 2, TN = 1;
constexpr int THREADS = (BM / TM) * (BN / TN);

__global__ void __launch_bounds__(THREADS)
    pz_leg_kernel(const double* __restrict__ T, const double* __restrict__ P,
                  const double* __restrict__ kfac, double* __restrict__ out,
                  int B, int nk, int np, int nshift) {
  const int R = 7 * nk;   // rows r = n * nk + i
  const int Q = 3 * B;    // columns q = b * 3 + a
  const int r0 = blockIdx.y * BM;
  const int q0 = blockIdx.x * BN;

  auto load_a = [&](int rr, int m) -> double {
    const int r = r0 + rr;
    return r < R ? T[(size_t)r * np + m] : 0.0;
  };
  auto load_b = [&](int m, int qq) -> double {
    const int q = q0 + qq;
    return q < Q ? P[(size_t)q * np + m] : 0.0;
  };

  double acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0;
  tile_product<BM, BN, BK, TM, TN, true>(acc, np, load_a, load_b);

  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + i * (BM / TM);
    if (r >= R) continue;
    const int n = r / nk, ii = r % nk;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int q = q0 + tx + j * (BN / TN);
      if (q >= Q) continue;
      const int b = q / 3, a = q % 3;
      const double v = kfac[ii] * acc[i][j];
      double* dst = out + ((((size_t)b * 7 + n) * 3 + a) * 3) * nk + ii;
      const double* pb = P + (size_t)b * 3 * np + nshift + ii;
#pragma unroll
      for (int c = 0; c < 3; ++c) dst[(size_t)c * nk] = v * pb[(size_t)c * np];
    }
  }
}

}  // namespace

// T [7, nk, np], P [B, 3, np], kfac [nk], out [B, 7, 3, 3, nk]; f64,
// contiguous, on the current device.  Returns cudaGetLastError().
extern "C" int rt_pz_leg(const double* T, const double* P, const double* kfac,
                         double* out, int B, int nk, int np, int nshift,
                         void* stream) {
  dim3 grid((3 * B + BN - 1) / BN, (7 * nk + BM - 1) / BM, 1);
  pz_leg_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      T, P, kfac, out, B, nk, np, nshift);
  return static_cast<int>(cudaGetLastError());
}
