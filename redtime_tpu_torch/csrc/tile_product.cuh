// Shared-memory tiled f64 product, the main loop of the engine's hand
// kernels (out_leg.cu, pz_leg.cu).
//
// One thread block computes a BM x BN tile of C = A @ B over a K-long
// contraction: it stages BK-deep slices of A and B in shared memory and
// each thread accumulates a TM x TN register block with f64 FMAs.  The
// operands are never materialized by the caller: `load_a(mm, k)` and
// `load_b(k, nn)` produce the element for tile row mm / tile column nn, so
// a kernel can form its A operand in this prologue (out_leg's pair
// product) or read B through any layout (pz_leg's spectra).
//
// Thread (tx, ty) owns rows ty + i*(BM/TM) and columns tx + j*(BN/TN):
// neighbouring threads read neighbouring shared-memory columns and store
// neighbouring output columns.
#pragma once

template <int BM, int BN, int BK, int TM, int TN, bool B_K_CONTIGUOUS,
          class LoadA, class LoadB>
__device__ __forceinline__ void tile_product(double (&acc)[TM][TN], int K,
                                             const LoadA& load_a,
                                             const LoadB& load_b) {
  constexpr int THX = BN / TN;
  constexpr int THY = BM / TM;
  constexpr int NT = THX * THY;
  __shared__ double As[BK][BM + 1];
  __shared__ double Bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % THX;
  const int ty = tid / THX;
  for (int k0 = 0; k0 < K; k0 += BK) {
    // A is contiguous along k for every caller: neighbouring threads load
    // neighbouring k of one row
    for (int i = tid; i < BM * BK; i += NT) {
      const int mm = i / BK, kk = i % BK;
      As[kk][mm] = (k0 + kk < K) ? load_a(mm, k0 + kk) : 0.0;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int nn = B_K_CONTIGUOUS ? i / BK : i % BN;
      const int kk = B_K_CONTIGUOUS ? i % BK : i / BN;
      Bs[kk][nn] = (k0 + kk < K) ? load_b(k0 + kk, nn) : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      double ar[TM], br[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ar[i] = As[kk][ty + i * THY];
#pragma unroll
      for (int j = 0; j < TN; ++j) br[j] = Bs[kk][tx + j * THX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
}
