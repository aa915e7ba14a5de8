"""Double-double (two-float32) arithmetic on float32 tensors.

The port of `redtime_tpu/dd.py`: the Dekker/Knuth error-free transforms
with no FMA assumption (Dekker splitting at 2^12+1 for the 24-bit
mantissa), giving ~1e-14-relative products and sums.  A DD value is a
(hi, lo) pair of f32 tensors with hi = fl(hi + lo).  On the TPU these
helpers carried f64-grade arithmetic inside Pallas kernels, which cannot
take f64 operands; the card computes f64 natively, so in the port they
serve the P3 probe (`kernels/probes.py` dd_mul, whose CUDA kernel
computes `mul` operation for operation) and its tests.

Every function is written op by op, in the JAX package's order, so an
eager evaluation of each rounds exactly as the JAX one does.
"""

from __future__ import annotations

import torch

_SPLIT = 4097.0        # 2^12 + 1 (Dekker split for f32)
F32 = torch.float32


def two_sum(a, b):
    """Knuth two-sum: a + b = s + e exactly (any magnitudes)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def fast_two_sum(a, b):
    """Dekker two-sum requiring |a| >= |b|: a + b = s + e exactly."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a, b):
    """Dekker two-product: a * b = p + e exactly (f32, no FMA)."""
    p = a * b
    aa = a * _SPLIT
    ahi = aa - (aa - a)
    alo = a - ahi
    bb = b * _SPLIT
    bhi = bb - (bb - b)
    blo = b - bhi
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def add(ah, al, bh, bl):
    """DD + DD -> DD (accurate variant, ~1 ulp of dd)."""
    sh, se = two_sum(ah, bh)
    tl, te = two_sum(al, bl)
    se = se + tl
    sh, se = fast_two_sum(sh, se)
    se = se + te
    return fast_two_sum(sh, se)


def add_f32(ah, al, b):
    """DD + f32 -> DD."""
    sh, se = two_sum(ah, b)
    se = se + al
    return fast_two_sum(sh, se)


def mul(ah, al, bh, bl):
    """DD * DD -> DD."""
    p, e = two_prod(ah, bh)
    e = e + (ah * bl + al * bh)
    return fast_two_sum(p, e)


def mul_f32(ah, al, b):
    """DD * f32 -> DD."""
    p, e = two_prod(ah, b)
    e = e + al * b
    return fast_two_sum(p, e)


def scale_pow2(ah, al, s):
    """DD * s for s an exact power of two (exact, componentwise)."""
    return ah * s, al * s


def neg(ah, al):
    return -ah, -al


def from_f64(x: torch.Tensor):
    """f64 tensor -> (hi, lo) f32 pair."""
    hi = x.to(F32)
    lo = (x - hi.to(x.dtype)).to(F32)
    return hi, lo


def to_f64(ah: torch.Tensor, al: torch.Tensor) -> torch.Tensor:
    """(hi, lo) -> f64."""
    return ah.to(torch.float64) + al.to(torch.float64)


def from_i32(o: torch.Tensor):
    """int32 -> DD exactly (hi keeps the top 24 bits, the residual fits
    f32 exactly)."""
    hi = o.to(F32)
    # the residual in int64: hi may round up to 2^31, outside int32
    lo = (o.to(torch.int64) - hi.to(torch.int64)).to(F32)
    return hi, lo


def exp2i(e_i32: torch.Tensor) -> torch.Tensor:
    """2^e for integer e in [-125, 127], exact, by writing the f32
    exponent bits."""
    biased = (e_i32 + 127) << 23
    return biased.to(torch.int32).view(F32)


def inv_pow2(e_i32: torch.Tensor) -> torch.Tensor:
    """2^-e for integer e in [-125, 125], exact."""
    return exp2i(-e_i32)
