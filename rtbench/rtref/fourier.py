"""Static DFT matrices, twiddle tables and FFT plans (numpy).

The plain versions of the engine's legs multiply by the JAX package's DFT
matrices (`_dft_matrices`); the hand kernels K9 engine_front and K10
tab_leg run the same transforms as FFTs in shared memory, from a table of
twiddles (`twiddles`) along a plan of radices (`fft_plan`).
"""

from __future__ import annotations

import functools

import numpy as np

# the largest number of stages an FFT plan may have (csrc/fft_smem.cuh)
MAX_STAGES = 12


@functools.lru_cache(maxsize=16)
def _dft_matrices(n: int):
    """DFT matrices for length n: (fc, fs, bc, bs), numpy f64.

    rfft: re = x @ fc, im = -x @ fs ([n, n//2+1]); unnormalized Hermitian
    backward transform: t = re @ bc + im @ bs ([n//2+1, n])."""
    j = np.arange(n)
    m = np.arange(n // 2 + 1)
    ang = 2.0 * np.pi * np.outer(j, m) / n          # [n, n//2+1]
    fc = np.cos(ang)
    fs = np.sin(ang)
    c = np.full(n // 2 + 1, 2.0)
    c[0] = 1.0
    if n % 2 == 0:
        c[-1] = 1.0
    bc = (c[:, None] * np.cos(ang.T))               # [n//2+1, n]
    bs = (-c[:, None] * np.sin(ang.T))
    return fc, fs, bc, bs


def twiddles(n: int) -> np.ndarray:
    """[n, 2]: (cos, sin) of 2 pi j / n for j < n, n a multiple of 4.

    Each entry comes from the reduced angle of its quadrant, 2 pi j' / n
    with j' = j mod n/4 (at most pi/2), and the quadrant's exact symmetry,
    so an entry is within an ulp or two of the exact value (the DFT
    matrices' entries, from the unreduced angle 2 pi j m / n, are off by
    up to eps times that angle)."""
    if n % 4:
        raise ValueError(f"twiddles: n must be a multiple of 4, got {n}")
    q = n // 4
    t = 2.0 * np.pi * np.arange(q) / n
    c, s = np.cos(t), np.sin(t)
    # exp(i (t + k pi/2)) = i^k exp(i t)
    out = np.concatenate([np.stack([c, s], 1), np.stack([-s, c], 1),
                          np.stack([-c, -s], 1), np.stack([s, -c], 1)])
    return np.ascontiguousarray(out)


def fft_plan(n: int) -> tuple:
    """The radices of an FFT of length n >= 2 in shared memory, in stage
    order: n = 2^a R with R odd; a radix-2 or -4 stage first when 3 does
    not divide a, then radix-8 stages, then one direct R-point stage last
    (the kernels' odd stage assumes it is the last)."""
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


def fft_levels(n: int) -> int:
    """The rounding levels of a plan's FFT for its error bound: a radix-p
    stage (p a power of two) adds log2 p levels of butterflies and one
    twiddle product, the odd R-point stage R - 1 sums and one product."""
    return sum(p.bit_length() if p & (p - 1) == 0 else p
               for p in fft_plan(n))
