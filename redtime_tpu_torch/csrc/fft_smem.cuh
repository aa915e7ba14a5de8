// Complex f64 FFTs in shared memory, for the engine's hand kernels K9
// engine_front (a forward transform) and K10 tab_leg (an inverse one).
//
// A block transforms `rows` rows of length n together, stage by stage,
// in Stockham's self-sorting order (the output comes out in natural
// order, with no bit reversal): stage s of radix p reads element j + r n/p
// (r < p) of each of its n/p butterflies, multiplies by the twiddles
// w_{Ns p}^{(j mod Ns) r} (Ns: the product of the earlier radices), runs a
// p-point DFT in registers and writes element (j - j mod Ns) p + j mod Ns
// + r Ns.  The plan (fourier.fft_plan, built on the host) takes radix 8 as
// often as it can, one radix-2 or -4 stage first for the rest of n's
// power of two, and the odd part R of n last as one direct R-point stage
// (each output sums its R inputs), so any n = 2^a R runs.  The stages
// ping-pong between two shared-memory buffers, a barrier between two
// stages; the caller gives the first stage's loader and the last stage's
// storer, so the first can read (or compute) its inputs where they are
// and the last can write straight to device memory.
//
// Twiddles come from a table of the N-th roots of unity w_N^j = exp(2 pi i
// j / N), j < N (fourier.twiddles, built on the host from reduced
// angles, or the kernel's copy in shared memory of its entries at a
// stride), for an N that n divides: w_m^e is entry e N / m.  The forward
// transform takes their conjugates.  Rounding: each stage's butterflies
// and products are plain f64 operations (contracted into FMAs where the
// compiler finds them); the kernels' error bounds count the levels
// (fourier.fft_levels).
#pragma once

#include <cuda_runtime.h>

namespace rt_fft {

constexpr int MAX_STAGES = 12;  // fourier.MAX_STAGES

struct Plan {
  int nst;
  int radix[MAX_STAGES];
};

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// w_N^i, or its conjugate for the forward transform (the table may lie in
// shared or in device memory)
template <bool INV>
__device__ __forceinline__ double2 twid(const double2* tw, int i) {
  const double2 t = __isGlobal(tw) ? __ldg(tw + i) : tw[i];
  return INV ? t : make_double2(t.x, -t.y);
}

// v times i (inverse) or -i (forward): w_4 of the transform
template <bool INV>
__device__ __forceinline__ double2 rot(double2 v) {
  return INV ? make_double2(-v.y, v.x) : make_double2(v.y, -v.x);
}

template <bool INV>
__device__ __forceinline__ void dft4(double2& v0, double2& v1, double2& v2,
                                     double2& v3) {
  const double2 t0 = cadd(v0, v2), t1 = csub(v0, v2);
  const double2 t2 = cadd(v1, v3), t3 = rot<INV>(csub(v1, v3));
  v0 = cadd(t0, t2);
  v1 = cadd(t1, t3);
  v2 = csub(t0, t2);
  v3 = csub(t1, t3);
}

// v[q] <- sum_r v[r] w_P^{r q} in place, P = 2, 4 or 8
template <int P, bool INV>
__device__ __forceinline__ void dft(double2* v) {
  if constexpr (P == 2) {
    const double2 a = v[0];
    v[0] = cadd(a, v[1]);
    v[1] = csub(a, v[1]);
  } else if constexpr (P == 4) {
    dft4<INV>(v[0], v[1], v[2], v[3]);
  } else {
    static_assert(P == 8, "radix 2, 4 or 8");
    // two 4-point DFTs of the even and odd inputs, then w_8^q on the odd
    double2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
    double2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
    dft4<INV>(e0, e1, e2, e3);
    dft4<INV>(o0, o1, o2, o3);
    constexpr double h = 0.70710678118654752440;  // 1 / sqrt 2
    constexpr double s = INV ? 1.0 : -1.0;
    o1 = make_double2(h * (o1.x - s * o1.y), h * (o1.y + s * o1.x));
    o2 = rot<INV>(o2);
    o3 = make_double2(-h * (o3.x + s * o3.y), h * (s * o3.x - o3.y));
    v[0] = cadd(e0, o0);
    v[4] = csub(e0, o0);
    v[1] = cadd(e1, o1);
    v[5] = csub(e1, o1);
    v[2] = cadd(e2, o2);
    v[6] = csub(e2, o2);
    v[3] = cadd(e3, o3);
    v[7] = csub(e3, o3);
  }
}

// One Stockham stage of radix P (2, 4 or 8) over rows x n; the block's
// threads take the rows x n/P butterflies in turn, consecutive threads on
// consecutive butterflies of a row.  Ns is a power of two (the odd stage
// comes last).
template <int P, bool INV, class Load, class Store>
__device__ __forceinline__ void pow2_stage(int rows, int n, int Ns,
                                           const double2* tw, int N,
                                           Load& load, Store& store) {
  const int q = n / P, step = N / (Ns * P);
  for (int t = threadIdx.x; t < rows * q; t += blockDim.x) {
    const int row = t / q, j = t - row * q, k = j & (Ns - 1);
    double2 v[P];
#pragma unroll
    for (int r = 0; r < P; ++r) v[r] = load(row, j + r * q);
    if (k) {  // k = 0: every twiddle is 1
#pragma unroll
      for (int r = 1; r < P; ++r)
        v[r] = cmul(v[r], twid<INV>(tw, k * r * step));
    }
    dft<P, INV>(v);
    const int base = (j - k) * P + k;
#pragma unroll
    for (int r = 0; r < P; ++r) store(row, base + r * Ns, v[r]);
  }
}

// The odd stage, always the last (Ns = n / R): output o of a row sums
// input j + r Ns times w_n^{r o}, r < R, with j = o mod Ns
template <bool INV, class Load, class Store>
__device__ __forceinline__ void odd_stage(int rows, int n, int R,
                                          const double2* tw, int N,
                                          Load& load, Store& store) {
  const int Ns = n / R, step = N / n;
  for (int t = threadIdx.x; t < rows * n; t += blockDim.x) {
    const int row = t / n, o = t - row * n, j = o % Ns;
    double2 s = load(row, j);
    int e = o;  // r o mod n
    for (int r = 1; r < R; ++r) {
      s = cadd(s, cmul(load(row, j + r * Ns), twid<INV>(tw, e * step)));
      e += o;
      if (e >= n) e -= n;
    }
    store(row, o, s);
  }
}

// Shared-memory buffers are padded: element e of a buffer lies at pad(e)
// = e + e / 8, so the strided stores of the first stages (element P j +
// r, 16 bytes each, 8 threads a shared-memory wavefront) fall in 8
// different bank groups; a buffer of e elements takes padded(e)
__device__ __forceinline__ int pad(int e) { return e + (e >> 3); }
__host__ __device__ constexpr int padded(int e) { return e + (e >> 3) + 1; }

// one stage of radix P from load to store
template <bool INV, class Load, class Store>
__device__ __forceinline__ void stage(int P, int rows, int n, int Ns,
                                      const double2* tw, int N, Load& load,
                                      Store& store) {
  if (P == 8)
    pow2_stage<8, INV>(rows, n, Ns, tw, N, load, store);
  else if (P == 4)
    pow2_stage<4, INV>(rows, n, Ns, tw, N, load, store);
  else if (P == 2)
    pow2_stage<2, INV>(rows, n, Ns, tw, N, load, store);
  else
    odd_stage<INV>(rows, n, P, tw, N, load, store);
}

// The whole transform of rows x n: stage 0 reads first(row, i), the last
// stage writes last(row, o, v); stage s writes buffer s % 2 for stage s +
// 1 (row pitch n, padded), which reads it after a barrier.  No barrier
// after the last stage.  A first loader that reads shared memory must
// not read buf0 (stage 0 writes it).  Each stage is compiled for where
// it reads and writes, so the middle ones hold no branch to the caller's.
template <bool INV, class First, class Last>
__device__ __forceinline__ void run(const Plan& plan, int rows, int n,
                                    const double2* tw, int N, double2* buf0,
                                    double2* buf1, First first, Last last) {
  int Ns = 1;
  for (int s = 0; s < plan.nst; ++s) {
    const double2* src = s % 2 ? buf0 : buf1;
    double2* dst = s % 2 ? buf1 : buf0;
    auto load = [&](int row, int i) { return src[pad(row * n + i)]; };
    auto store = [&](int row, int o, double2 v) { dst[pad(row * n + o)] = v; };
    const int P = plan.radix[s];
    const bool to_last = s + 1 == plan.nst;
    if (s == 0 && to_last)
      stage<INV>(P, rows, n, Ns, tw, N, first, last);
    else if (s == 0)
      stage<INV>(P, rows, n, Ns, tw, N, first, store);
    else if (to_last)
      stage<INV>(P, rows, n, Ns, tw, N, load, last);
    else
      stage<INV>(P, rows, n, Ns, tw, N, load, store);
    Ns *= P;
    if (!to_last) __syncthreads();
  }
}

}  // namespace rt_fft
