// Table lookups shared by K8 rhs_tail and K11 out_block: the bracketing
// and weights of interp.axis_weights on one lane's nodes, computed by a
// warp whose threads share the lane and the query point (each its own k
// point), and the 4-node sums in the orders cuBLAS reduces the plain
// versions' dense weight rows.  Every thread of the warp takes part in
// each call (ballots and shuffles over the full warp).
//
// Built with LOOKUP_FIXED 1 (K8's timing build RT_DROP 64), the lookups
// read no nodes: i0 = 0 and fixed weights.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#ifndef LOOKUP_FIXED
#define LOOKUP_FIXED 0
#endif

namespace rt_lookup {

// A bracket of interp.axis_weights: f(x) = sum_j w[j] f[i0 + j]
struct Bracket {
  int i0, n;
  double w[4];
};

// A table's nodes as the warp holds them: thread t node 32 q + t of round q
// (tables of up to 32 NODE_ROUNDS nodes in registers; the rest are read
// again by count_below)
constexpr int NODE_ROUNDS = 4;
struct Nodes {
  double v[NODE_ROUNDS];
};

// The warp computes a lane's scalars a stage at a time, thread t the t-th
// value of the stage (one call site of pow or a division for the stage,
// so the code an item runs stays short); piece(v, t) reads thread t's.
// Every thread of the warp takes part.
__device__ __forceinline__ double piece(double v, int t) {
  return __shfl_sync(0xffffffffu, v, t);
}

// interp.axis_weights on one lane's nodes [nn] (nn >= 4) at x, in
// phases, every thread of the warp with the same x, so that a task issues
// its loads before the arithmetic that waits on them (prologue):
//   load_nodes: the nodes into registers, before x is known;
//   count_below: pos = torch.searchsorted(nodes, x, side="left"), the
//     count of nodes with !(node >= x), a ballot a round (torch's lower
//     bound: a NaN x counts them all, pos = nn, so every index below
//     stays in range);
//   place: n = clamp(pos - 1, 0, nn - 2), i0 = clamp(n - 1, 0, nn - 4);
//   weights: 0 < n < nn - 2: _lagrange4's, each factor (num (x - x_l)) /
//     (x_j - x_l) over l != j in increasing order (thread j & 3 computes
//     weight j); else linear on nodes n, n + 1 at offset n - i0, as
//     (1 - t) e_off + t e_off+1 (the plain version's zeros included);
//     weights_at(..., src) reads the 4 weights from threads src .. src + 3,
//     so that the 4 threads of each group of a warp can weigh their own x
//     and bracket (K11's warp of beta brackets; weights is src 0).
// LOOKUP_FIXED: no nodes, i0 = 0 and fixed weights.
__device__ __forceinline__ Nodes load_nodes(const double* nodes, int nn) {
  Nodes h;
  const int t = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < NODE_ROUNDS; ++q) {
    const int j = 32 * q + t;
#if LOOKUP_FIXED
    h.v[q] = 0.0 * j;
#else
    h.v[q] = j < nn ? __ldg(nodes + j) : 0.0;
#endif
  }
  return h;
}

__device__ __forceinline__ int count_below(const Nodes& h,
                                           const double* nodes, int nn,
                                           double x) {
#if LOOKUP_FIXED
  (void)h;
  (void)nodes;
  (void)nn;
  (void)x;
  return 1;
#else
  const int t = threadIdx.x & 31;
  int pos = 0;
#pragma unroll
  for (int q = 0; q < NODE_ROUNDS; ++q) {
    const int j = 32 * q + t;
    pos += __popc(__ballot_sync(0xffffffffu, j < nn && !(h.v[q] >= x)));
  }
  for (int j0 = 32 * NODE_ROUNDS; j0 < nn; j0 += 32) {
    const int j = j0 + t;
    const double v = j < nn ? __ldg(nodes + j) : 0.0;
    pos += __popc(__ballot_sync(0xffffffffu, j < nn && !(v >= x)));
  }
  return pos;
#endif
}

__device__ __forceinline__ Bracket place(int pos, int nn) {
  Bracket r;
  r.n = min(max(pos - 1, 0), nn - 2);
  r.i0 = min(max(r.n - 1, 0), nn - 4);
  return r;
}

__device__ __forceinline__ void weights_at(Bracket& r, const double* nodes,
                                           int nn, double x, bool has,
                                           int src) {
#if LOOKUP_FIXED
  (void)nodes;
  (void)nn;
  (void)has;
  (void)src;
#pragma unroll
  for (int m = 0; m < 4; ++m) r.w[m] = 0.25 * x;
#else
  double xs[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) xs[m] = has ? __ldg(nodes + r.i0 + m) : m;
  const auto at = [&xs](int m) {
    return m == 0 ? xs[0] : m == 1 ? xs[1] : m == 2 ? xs[2] : xs[3];
  };
  const int j = threadIdx.x & 3;
  const double xj = at(j);
  double wc = 1.0;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const double xl = at(f + (f >= j));
    wc = __ddiv_rn(__dmul_rn(wc, __dsub_rn(x, xl)), __dsub_rn(xj, xl));
  }
  const int off = r.n - r.i0;        // 0 (n = 0) or 2 (n = nn - 2)
  const double xn = at(off), xn1 = at(off + 1);
  const double t = __ddiv_rn(__dsub_rn(x, xn), __dsub_rn(xn1, xn));
  const double wl =
      __dadd_rn(__dmul_rn(__dsub_rn(1.0, t), j == off ? 1.0 : 0.0),
                __dmul_rn(t, j == off + 1 ? 1.0 : 0.0));
  const double w = r.n > 0 && r.n < nn - 2 ? wc : wl;
#pragma unroll
  for (int m = 0; m < 4; ++m) r.w[m] = piece(w, src + m);
#endif
}

__device__ __forceinline__ void weights(Bracket& r, const double* nodes,
                                        int nn, double x, bool has) {
  weights_at(r, nodes, nn, x, has, 0);
}

// The 4 rows of a bracket at the thread's k (rows: row 0 of the lane's
// table at k, rows nk apart; 0 where !valid), then their sum, w_j t_j in
// the order cuBLAS takes the plain version's contraction of the dense weight row
// (whose other terms are +0) at the tables' sizes, 8 or 4 beta nodes and
// 101 growth nodes (scripts/probe_rhs_prologue.py): its bits there, an
// ulp or so apart where cuBLAS reduces another way
__device__ __forceinline__ void rows4(bool valid, int nk, const Bracket& r,
                                      const double* rows, bool has,
                                      double v[4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    v[m] = has && valid ? __ldg(rows + (size_t)(r.i0 + m) * (size_t)nk)
                        : 0.0;
  }
}

// beta's: nodes 0, 2 and 1, 3 each an fma on its first product, then the
// two added (cuBLAS splits the beta table's row by k mod 2)
__device__ __forceinline__ double dot4_pairs(const Bracket& r,
                                             const double v[4]) {
  return __dadd_rn(__fma_rn(r.w[2], v[2], __dmul_rn(r.w[0], v[0])),
                   __fma_rn(r.w[3], v[3], __dmul_rn(r.w[1], v[1])));
}

// the growth's: the nodes of each chunk of 4 (by k = i0 + j) an fma
// chain from 0, the chunks added in order (cuBLAS's reduction of the
// growth table's row)
__device__ __forceinline__ double dot4_chunks(const Bracket& r,
                                              const double v[4]) {
  const int first = 4 - (r.i0 & 3);       // nodes in i0's chunk
  double lo = 0.0, hi = 0.0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if (m < first) {
      lo = __fma_rn(r.w[m], v[m], lo);
    } else {
      hi = __fma_rn(r.w[m], v[m], hi);
    }
  }
  return first == 4 ? lo : __dadd_rn(lo, hi);
}

}  // namespace rt_lookup
