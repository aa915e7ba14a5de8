"""The yardstick's operations and bytes: frozen copies of chip_smoke.py's
cost functions and H100 peaks at the commit that added the benchmark,
taking shapes instead of tensors.  tests/test_copies.py holds each to its
source.

Each `*_cost` returns least_time's dict: the least time the card could
take for one launch (the larger of bytes over the HBM rate and operations
over the peak of the pipe the kernel runs on), each input byte read once
and each output byte written once.
"""

from __future__ import annotations

# H100 SXM peaks (NVIDIA's data sheet, dense): HBM bytes/s; FP64 on the
# tensor cores, FP64 outside them
HBM_BYTES_S = 3.35e12
PEAK_FP64_TC, PEAK_FP64 = 67e12, 34e12

NU_STATE = 41           # the Time-RG state's rows
N_OMEGA_CONSTS = 13     # background.OmegaConsts' fields
# K8 rhs_tail's variants at the commit: (feature rows its work items
# read, outputs, Omega table terms of those outputs, distinct A/R
# operations of those outputs: None where no A/R program runs)
RT_VARIANTS = {"linear": (3, 0, 0, None), "full": (98, 14, 62, 366),
               "full_q": (143, 38, 176, 1294),
               "oneloop": (31, 14, 62, None),
               "oneloop_q": (79, 38, 176, None)}
MAX_STAGES = 12         # fourier.MAX_STAGES


def least_time(nbytes: float, ops: float, peak: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over `peak`."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / peak
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=nbytes, bound_ops=ops)


def rk_finish_cost(B: int, D: int, s: int) -> dict:
    """One K3 rk_finish on a [B, D] state with s stages: y, ks, t, h, t1,
    n, active, b, e and prm in; y, t, h, n, r and reached out; 2 s + 4
    flops an element."""
    return least_time(8.0 * (2 * B * D + s * B * D + 8 * B + 2 * s + 9)
                      + 2 * B, 2.0 * B * D * (2 * s + 4), PEAK_FP64)


def rk_stage_cost(B: int, D: int, i: int) -> dict:
    """One K3 rk_stage forming stage i's input: y, the i rows of ks, h and
    a's row in, the stage input out; 2 i + 1 flops an element."""
    return least_time(8.0 * ((i + 2) * B * D + B + i),
                      (2.0 * i + 1.0) * B * D, PEAK_FP64)


def fft_plan(n: int) -> tuple:
    """The radices of the kernels' FFT of length n (fourier.fft_plan)."""
    if n < 2:
        raise ValueError(f"fft_plan: n must be at least 2, got {n}")
    a = (n & -n).bit_length() - 1
    radices = ([1 << (a % 3)] if a % 3 else []) + [8] * (a // 3)
    if n >> a > 1:
        radices.append(n >> a)
    if len(radices) > MAX_STAGES:
        raise ValueError(f"fft_plan: n={n} needs more than {MAX_STAGES} "
                         "stages")
    return tuple(radices)


def fft_flops(n: int) -> float:
    """Floating-point operations of a complex FFT of length n along
    fft_plan(n): 5 n log2 p a radix-p stage (p = 2, 4, 8), 8 n R the
    direct odd R-point stage."""
    return float(sum(5.0 * n * (p.bit_length() - 1) if p & (p - 1) == 0
                     else 8.0 * n * p for p in fft_plan(n)))


def engine_costs(B: int, nk: int, npts: int, nc: int, nfam: int) -> tuple:
    """least_time of K9 engine_front and of K10 tab_leg, FFTs on the FP64
    pipes (each input read once, each output written once, the twiddle
    table [2np, 2] whole).  K9: the band's 4 FMAs, the real split (10
    flops an output) and a complex FFT of length np / 2 a row; K10:
    forming X and Z (16 flops a frequency) and a complex FFT of length np
    a row."""
    N, half, rows = 2 * npts, nc // 2, 3 * B
    k9 = least_time(8.0 * (3 * B * nk + B + 3 * npts + half + 2 * N
                           + 3 * B * npts + 3 * B * nc) + 36.0 * npts,
                    rows * (8.0 * npts + 10.0 * half + fft_flops(half)),
                    PEAK_FP64)
    M = 6 * nfam * B
    k10 = least_time(8.0 * (3 * B * nc + 4 * nfam * half + 2 * N + M * N),
                     M * (16.0 * half + fft_flops(npts)), PEAK_FP64)
    return k9, k10


def out_leg_cost(B: int, nfam: int, K: int, O: int) -> dict:
    """One K1 out_leg: tab [B, 2, nfam, 3, K] and G [nfam, K, O] in, J
    [B, nfam, 3, 3, O] out; 2 nfam 9 B K O flops on the FP64 tensor
    cores."""
    return least_time(8.0 * (B * 2 * nfam * 3 * K + nfam * K * O
                             + B * nfam * 9 * O),
                      2.0 * nfam * 9 * B * K * O, PEAK_FP64_TC)


def pz_leg_cost(B: int, nk: int, npts: int) -> dict:
    """One K2 pz_leg: the Toeplitz slices [7 nk, np], P_e [3 B, np] and
    kfac [nk] in, PZ [B, 7, 3, 3, nk] out; 2 7 nk 3 B np flops on the
    FP64 tensor cores."""
    return least_time(8.0 * (7 * nk * npts + 3 * B * npts + nk
                             + B * 7 * 9 * nk),
                      2.0 * 7 * nk * 3 * B * npts, PEAK_FP64_TC)


def rt_cost(B: int, nk: int, nz: int, variant: str, nn: int = 0) -> dict:
    """One K8 rhs_tail of `variant` at B lanes: read once, the feature rows
    its work items read, k, the 4 beta rows each lane's a brackets (with a
    table of nz nodes) and its nodes, in 1-loop mode the 4 rows each of G
    and dD/da, Dnorm, D_z1l and the nn ln a nodes, and the 15 lane
    scalars and eta; dy written once.  Operations: the distinct ones a k
    point, the lookups' 4-node sums (8 a table) and o10, D, dD/da, fz,
    pre; a lane's bracketing and Omega scalars (~40, pow and exp counted
    as 20 each)."""
    rows, nout, omega, ar = RT_VARIANTS[variant]
    oneloop = variant.startswith("oneloop")
    per_point = rows + NU_STATE + 4 * (nz > 0) + 10 * oneloop
    per_lane = 1 + 2 + N_OMEGA_CONSTS + nz + nn
    nbytes = 8.0 * (B * nk * per_point + B * per_lane + nk)
    ops_pt = ar if ar is not None else 12 + 3 * nout
    ops_pt += 2 * omega + 40
    ops_pt += 8 * (nz > 0) + 4 + oneloop * (2 * 8 + 3)
    ops_lane = 140 + nz + 24 + oneloop * (nn + 24 + 60)
    return least_time(nbytes, float(ops_pt) * B * nk + ops_lane * B,
                      PEAK_FP64)
