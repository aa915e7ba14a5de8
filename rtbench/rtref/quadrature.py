"""Quadrature: GSL-replica adaptive Gauss-Kronrod over a batch of lanes,
and the continuum oracle of the FFT-log engine.

`qag_gk61` reproduces gsl_integration_qag(key=6) (QUADPACK dqage) as the
JAX package's `redtime_tpu.quadrature.qag_gk61` does, with one adaptive
bisection per lane: every lane keeps its own workspace of intervals and
stops on its own tolerance.  `qk61` is its one-interval rule.

The oracle (`j_quadrature`, `pz_quadrature`, `jreg_ir_counterterm`)
evaluates the mode-coupling integrals that the engine (fastpt: K9 -> K10
-> K1 + K2) discretizes, directly by Gauss-Legendre panels over (ln q,
x): no FFTs and no grid conventions of the engine.  The FAST-PT J
transforms (reference `src/redTime.cc:514-597`) are the
McEwen-Fang-Hirata-Blazek (arXiv:1603.04826) integrals

    J_{alpha,beta,ell}(k) = 1/(4 pi^2) * int_0^inf q^3 dln q
                            int_{-1}^{1} dx  (q/k)^alpha (s/k)^beta
                            P_ell(mu) P(q) P(s),

with s = |k - q| = sqrt(k^2 + q^2 - 2 k q x) and mu = (k x - q)/s.  The
six unregularised families (UNREG_FAMILIES) are well defined as they
stand; family 1 (ell = 0, alpha = 2) is regularised in FAST-PT, and its
naive integral differs from the engine's by jreg_ir_counterterm; the
Jn0 (RSD) families carry their own DC regularisation and are not
covered.  The oracle is a yardstick, not a path: its f64 tensors live on
the `device` the caller names (the card, to hold the hand engine to it).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
from numpy.polynomial.legendre import leggauss

from rtbench.rtref._gk61 import WG30, WGK61, XGK61
from rtbench.rtref.config import SolverConfig
from rtbench.rtref.grids import make_grids

F64 = torch.float64

# the unregularised J families: (family index in fastpt, alpha, beta, ell)
UNREG_FAMILIES = ((0, 0, 0, 0), (2, 1, -1, 1), (3, 0, 0, 2),
                  (4, 2, -2, 2), (5, 1, -1, 3), (6, 0, 0, 4))

_EPS50 = 50.0 * np.finfo(np.float64).eps
_TINY = np.finfo(np.float64).tiny


def bbks_lnP(k: np.ndarray) -> np.ndarray:
    """ln P of the smooth CDM-like spectrum the engine is held to the
    oracle on: P ~ k^0.96 T^2(k) with a BBKS transfer, as in the JAX
    package's tests/test_quadrature.py."""
    q = k / 0.15
    T = (np.log(1 + 2.34 * q) / (2.34 * q)
         / (1 + 3.89 * q + (16.1 * q) ** 2 + (5.46 * q) ** 3
            + (6.71 * q) ** 4) ** 0.25)
    return np.log(4.0e6 * k ** 0.96 * T * T)


def _rule(fv: torch.Tensor, hh: torch.Tensor, wgk: torch.Tensor,
          wg: torch.Tensor):
    """GK61 (result, error estimate, resabs, resasc) by QUADPACK's rules
    from the 61 samples fv [..., 61] of an interval with half-width hh
    [...]."""
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
    return res, err, resabs, resasc


def _f64(device) -> dict:
    return dict(dtype=F64, device=device)


def qk61(f: Callable, a: float, b: float, device):
    """One 61-point Gauss-Kronrod application on [a, b] with QUADPACK's
    error estimate (GSL's qag rule at key=6; dqk61 / gsl qk61.c):

        resk   = Kronrod result, resg = embedded Gauss-30 result
        resasc = int |f - resk/(b-a)|  (Kronrod-weighted)
        err    = |resk - resg| -> resasc * min(1, (200 err / resasc)^1.5)
        err    = max(50 eps * resabs, err)   (roundoff floor)

    f maps the 61 points [61] to values [61].  Returns (result, abserr,
    resabs, resasc), 0-d f64 tensors on `device`."""
    xgk, wgk, wg = (torch.as_tensor(w, **_f64(device))
                    for w in (XGK61, WGK61, WG30))
    a = torch.as_tensor(a, **_f64(device))
    b = torch.as_tensor(b, **_f64(device))
    c, h = 0.5 * (a + b), 0.5 * (b - a)
    return _rule(f(c + h * xgk), h, wgk, wg)


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
    f64 = _f64(device)
    xgk = torch.as_tensor(XGK61, **f64)
    wgk = torch.as_tensor(WGK61, **f64)
    wg = torch.as_tensor(WG30, **f64)
    lanes = torch.arange(B, device=device)

    c0, h0 = 0.5 * (a + b), 0.5 * (b - a)
    fv = f((c0 + h0 * xgk).expand(B, 61).contiguous())
    r0, e0, _, _ = _rule(fv, torch.full((B,), h0, **f64), wgk, wg)
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
        res, err, _, _ = _rule(fv, torch.stack([h1, h2], dim=1), wgk, wg)
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


# ---------------------------------------------------------------------------
# The continuum oracle of the engine

def _legendre(ell: int, x: torch.Tensor) -> torch.Tensor:
    if ell == 0:
        return torch.ones_like(x)
    pkm, pk = torch.ones_like(x), x
    for n in range(2, ell + 1):
        pkm, pk = pk, ((2 * n - 1) * x * pk - (n - 1) * pkm) / n
    return pk


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
            ) -> torch.Tensor:
    """np.interp(x, xp, fp) for increasing xp: fp[0] left of xp[0], fp[-1]
    from xp[-1] on, else slope * (x - xp[j]) + fp[j] on the bracket
    xp[j] <= x < xp[j + 1], in numpy's operations."""
    n = xp.shape[0]
    j = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0, n - 2)
    slope = (fp[j + 1] - fp[j]) / (xp[j + 1] - xp[j])
    v = slope * (x - xp[j]) + fp[j]
    v = torch.where(x < xp[0], fp[0], v)
    return torch.where(x >= xp[-1], fp[-1], v)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu()
    return np.atleast_1d(np.asarray(x, np.float64))


def _p_interp(cfg: SolverConfig, P_ext, device):
    """(lo, hi, P_of): the support bounds in ln k and the masked
    log-log-linear interpolant of the windowed extended spectrum P_ext
    [npts] (the engine's own input, zero outside its support)."""
    lnk_ext = torch.as_tensor(make_grids(cfg).lnk_ext, **_f64(device))
    P = torch.as_tensor(P_ext, **_f64(device))
    sup = P > 0.0
    lo, hi = float(lnk_ext[sup][0]), float(lnk_ext[sup][-1])
    lnP = torch.where(sup, torch.log(torch.clamp(P, min=1e-300)), -700.0)

    def P_of(q):
        lq = torch.log(torch.clamp(q, min=1e-300))
        v = _interp(lq, lnk_ext, lnP)
        return torch.where((lq < lo) | (lq > hi), 0.0, torch.exp(v))

    return lo, hi, P_of


_leggauss = functools.lru_cache(maxsize=8)(leggauss)   # shared: never written


def _gl_lnq(lo: float, hi: float, n_q: int):
    """Gauss-Legendre nodes and weights mapped onto ln q in [lo, hi]
    (numpy, on the host)."""
    uq, wq = _leggauss(n_q)
    lq = 0.5 * (hi + lo) + 0.5 * (hi - lo) * uq
    return lq, 0.5 * (hi - lo) * wq


def j_quadrature(cfg: SolverConfig, P_ext, k, alpha: int, beta: int,
                 ell: int, n_q: int = 400, n_x: int = 64, *,
                 device) -> torch.Tensor:
    """J_{alpha,beta,ell}(k) by 2-D Gauss-Legendre quadrature.

    P_ext: the windowed power spectrum on the extended grid [npts] (a row
    of fastpt.extend_power).  k: the points to evaluate at.  Returns
    [len(k)] on `device`."""
    f64 = _f64(device)
    lo, hi, P_of = _p_interp(cfg, P_ext, device)
    lq, wlq = _gl_lnq(lo, hi, n_q)
    q = torch.as_tensor(np.exp(lq), **f64)
    wlq = torch.as_tensor(wlq, **f64)
    ux, wx = (torch.as_tensor(v, **f64) for v in _leggauss(n_x))

    k = torch.as_tensor(_host(k), **f64)[:, None, None]
    qb = q[None, :, None]
    xb = ux[None, None, :]
    s = torch.sqrt(torch.clamp(k * k + qb * qb - 2.0 * k * qb * xb,
                               min=1e-300))
    mu = (k * xb - qb) / s
    f = ((qb / k) ** alpha * (s / k) ** beta * _legendre(ell, mu)
         * P_of(qb) * P_of(s))
    return torch.einsum("i,j,kij->k", wlq * q ** 3, wx, f) / (
        4.0 * np.pi ** 2)


def pz_quadrature(cfg: SolverConfig, P_ext, k, n: int, n_q: int = 2000, *,
                  device) -> torch.Tensor:
    """The Z-kernel spectra by direct 1-D quadrature:

        PZ_n(k) = 1/(2 pi^2) * int dln q  q^3 Z_n(q/k) P(q),

    the integral the engine's PZ Toeplitz contraction (K2; reference
    `redTime.cc:689-727`) discretizes, with the Taylor-switched kernels
    fastpt._z_reg (evaluated on the host).  Returns [len(k)] on `device`,
    WITHOUT the assembly's P_b(k) outer factor."""
    from rtbench.rtref.fastpt import _z_reg

    f64 = _f64(device)
    lo, hi, P_of = _p_interp(cfg, P_ext, device)
    lq, wlq = _gl_lnq(lo, hi, n_q)
    q_host = np.exp(lq)
    q = torch.as_tensor(q_host, **f64)
    Z = torch.as_tensor(np.array([
        [_z_reg(n, float(r), cfg.z_taylor_eps, cfg.z_taylor_terms)
         for r in q_host / kv] for kv in _host(k)]), **f64)
    w = torch.as_tensor(wlq, **f64) * q ** 3
    return (w * Z * P_of(q)).sum(-1) / (2.0 * np.pi ** 2)


def jreg_ir_counterterm(cfg: SolverConfig, P_ext, k, *,
                        device) -> torch.Tensor:
    """The piece the FAST-PT regularisation removes from J_{2,-2,0}.

    The naive (alpha, beta, ell) = (2, -2, 0) integral holds an IR s -> 0
    part: the integrand approaches (k/s)^2 P(k) P(s), whose angular
    integral collapses to

        Delta(k) = k^2 P(k) / (2 pi^2) * int_0^inf dq P(q).

    The engine's regularised transform (reference `src/redTime.cc:411-511`,
    the MFHB (2,-2,0) special case) excludes it: J_naive = J_reg + Delta.
    Returns Delta(k) [len(k)] on `device` for the windowed spectrum
    P_ext."""
    f64 = _f64(device)
    lo, hi, P_of = _p_interp(cfg, P_ext, device)
    lq, wlq = _gl_lnq(lo, hi, 4000)
    q = torch.as_tensor(np.exp(lq), **f64)
    i_p = torch.sum(torch.as_tensor(wlq, **f64) * q * P_of(q))
    k = torch.as_tensor(_host(k), **f64)
    lnk_ext = torch.as_tensor(make_grids(cfg).lnk_ext, **f64)
    lnP = torch.log(torch.clamp(torch.as_tensor(P_ext, **f64), min=1e-300))
    pk = torch.exp(_interp(torch.log(k), lnk_ext, lnP))
    return k * k * pk * i_p / (2.0 * np.pi ** 2)
