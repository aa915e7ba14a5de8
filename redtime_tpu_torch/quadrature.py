"""GSL-replica adaptive Gauss-Kronrod quadrature over a batch of lanes.

`qag_gk61` reproduces gsl_integration_qag(key=6) (QUADPACK dqage) as the
JAX package's `redtime_tpu.quadrature.qag_gk61` does, with one adaptive
bisection per lane: every lane keeps its own workspace of intervals and
stops on its own tolerance.  Only the GK61 part of the JAX module is
ported; its continuum oracles (`j_quadrature`, `pz_quadrature`) are test
tools of the JAX engine.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from redtime_tpu_torch._gk61 import WG30, WGK61, XGK61

_EPS50 = 50.0 * np.finfo(np.float64).eps
_TINY = np.finfo(np.float64).tiny


def _rule(fv: torch.Tensor, hh: torch.Tensor, wgk: torch.Tensor,
          wg: torch.Tensor):
    """GK61 result and QUADPACK error estimate from the 61 samples fv
    [..., 61] of an interval with half-width hh [...]."""
    resk = fv @ wgk
    resg = fv[..., 1::2] @ wg
    resabs = torch.abs(fv) @ wgk * torch.abs(hh)
    resasc = torch.abs(fv - 0.5 * resk[..., None]) @ wgk * torch.abs(hh)
    res = resk * hh
    err = torch.abs((resk - resg) * hh)
    scaled = resasc * torch.clamp(
        (200.0 * err / torch.clamp(resasc, min=1e-300)) ** 1.5, max=1.0)
    err = torch.where((resasc != 0.0) & (err != 0.0), scaled, err)
    err = torch.where(resabs > _TINY / _EPS50,
                      torch.maximum(_EPS50 * resabs, err), err)
    return res, err


def qag_gk61(f: Callable, a: float, b: float, B: int, device,
             epsabs: float = 0.0, epsrel: float = 1e-4,
             limit: int = 1000):
    """Adaptive quadrature of f over [a, b] on B lanes, replicating
    gsl_integration_qag(key=6): apply GK61, then repeatedly bisect each
    lane's interval with the largest error estimate until

        sum_i abserr_i <= max(epsabs, epsrel * |sum_i result_i|).

    GSL keeps the left half in the bisected interval's slot and appends
    the right half; the result is the slot-order sum.  f maps points
    x [B, m] to values [B, m] (lane by lane).  A lane that hits `limit`
    is POISONED with NaN (GSL's default error handler aborts there).

    Returns (result [B], abserr [B])."""
    f64 = dict(dtype=torch.float64, device=device)
    xgk = torch.as_tensor(XGK61, **f64)
    wgk = torch.as_tensor(WGK61, **f64)
    wg = torch.as_tensor(WG30, **f64)
    lanes = torch.arange(B, device=device)

    c0, h0 = 0.5 * (a + b), 0.5 * (b - a)
    fv = f((c0 + h0 * xgk).expand(B, 61).contiguous())
    r0, e0 = _rule(fv, torch.full((B,), h0, **f64), wgk, wg)
    A = torch.zeros((B, limit), **f64)
    Bv = torch.zeros((B, limit), **f64)
    R = torch.zeros((B, limit), **f64)
    E = torch.zeros((B, limit), **f64)
    A[:, 0], Bv[:, 0], R[:, 0], E[:, 0] = a, b, r0, e0
    n = torch.ones(B, dtype=torch.int64, device=device)

    def errbnd(R):
        return torch.clamp(epsrel * torch.abs(R.sum(1)), min=epsabs)

    def running():
        return (E.sum(1) > errbnd(R)) & (n < limit)

    active = running()
    while bool(active.any()):
        i = torch.argmax(E, dim=1)
        ai, bi = A[lanes, i], Bv[lanes, i]
        m = 0.5 * (ai + bi)
        c1, h1 = 0.5 * (ai + m), 0.5 * (m - ai)
        c2, h2 = 0.5 * (m + bi), 0.5 * (bi - m)
        xs = torch.stack([c1[:, None] + h1[:, None] * xgk,
                          c2[:, None] + h2[:, None] * xgk], dim=1)
        fv = f(xs.reshape(B, 122)).reshape(B, 2, 61)
        res, err = _rule(fv, torch.stack([h1, h2], dim=1), wgk, wg)
        ni = torch.clamp(n, max=limit - 1)
        for buf, left, right in ((A, ai, m), (Bv, m, bi),
                                 (R, res[:, 0], res[:, 1]),
                                 (E, err[:, 0], err[:, 1])):
            buf[lanes, i] = torch.where(active, left, buf[lanes, i])
            buf[lanes, ni] = torch.where(active, right, buf[lanes, ni])
        n = n + active.to(n.dtype)
        active = running()
    done = E.sum(1) <= errbnd(R)
    total = torch.where(done, R.sum(1), torch.full_like(r0, np.nan))
    return total, E.sum(1)
