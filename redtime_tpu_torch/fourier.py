"""Static DFT matrices (numpy f64).

The port computes the engine in its GEMM form, so of the JAX package's
`fourier` module it needs only the matrices the engine constants are
built from; `torch.fft` covers any transform run directly.
"""

from __future__ import annotations

import functools

import numpy as np


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
