"""Adaptive embedded Runge-Kutta integration over a batch of lanes.

Replaces the reference's GSL odeiv stack (`gsl_odeiv_evolve_apply` +
`gsl_odeiv_control_y_new` + `gsl_odeiv_step_rkf45`, used at
`src/redTime.cc:1589-1630` and `AU_cosmological_parameters.h:170-190`).
The accept/reject/step-size logic is GSL's "standard controller":

  D0_i = eps_abs + eps_rel * |y_i|          (a_y = 1, a_dydt = 0)
  r    = max_i |yerr_i| / D0_i
  r > 1.1  -> reject, h *= max(0.9 * r^(-1/ord), 0.2)
  r < 0.5  -> accept, h *= clip(0.9 * r^(-1/(ord+1)), 1, 5)
  else     -> accept, h unchanged

with the step clipped to land exactly on t1 and the clipped step's
adjusted size carried on as the next suggestion.

Every lane of a batch runs its own controller (its own t, h, attempt
count and error norm over its own state), exactly as the JAX package's
vmapped `lax.while_loop` does; lanes that reached t1 stay frozen.  There
is one controller attempt (`attempt`), shared by the growth tables and
the eta evolution; the hand kernel K3 (kernels.rk_finish) forms each stage
input (`rk_stage`) and finishes the attempt (`rk_finish`), so an attempt's
own arithmetic is one launch per stage and one for its tail.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from rtbench.rtref.kernels.rk_finish import (REJECT_ABOVE,
                                                 AttemptConsts,
                                                 attempt_consts, rk_finish,
                                                 rk_stage)

F64 = torch.float64

# Attempts between two host checks for a still-running lane.  Each check
# waits for the device; attempts on finished lanes are no-ops, so the
# value changes the run time and never the result.  Not tuned.
CHECK_EVERY = 4

class Tableau(NamedTuple):
    c: np.ndarray      # [s]    stage times
    a: np.ndarray      # [s, s] stage coefficients (strictly lower triangular)
    b: np.ndarray      # [s]    solution weights (higher order)
    e: np.ndarray      # [s]    error weights (y_high - y_low)
    order: int         # controller order (GSL step "order")


def _frac(num, den):
    return float(num) / float(den)


# GSL's rkf45 tableau (gsl/ode-initval/rkf45.c); solution is the 5th-order
# combination, error = y5 - y4.
RKF45 = Tableau(
    c=np.array([0.0, 0.25, 0.375, _frac(12, 13), 1.0, 0.5]),
    a=np.array([
        [0, 0, 0, 0, 0, 0],
        [0.25, 0, 0, 0, 0, 0],
        [_frac(3, 32), _frac(9, 32), 0, 0, 0, 0],
        [_frac(1932, 2197), _frac(-7200, 2197), _frac(7296, 2197), 0, 0, 0],
        [_frac(8341, 4104), _frac(-32832, 4104), _frac(29440, 4104),
         _frac(-845, 4104), 0, 0],
        [_frac(-6080, 20520), _frac(41040, 20520), _frac(-28352, 20520),
         _frac(9295, 20520), _frac(-5643, 20520), 0],
    ]),
    b=np.array([_frac(902880, 7618050), 0.0, _frac(3953664, 7618050),
                _frac(3855735, 7618050), _frac(-1371249, 7618050),
                _frac(277020, 7618050)]),
    e=np.array([_frac(1, 360), 0.0, _frac(-128, 4275), _frac(-2197, 75240),
                _frac(1, 50), _frac(2, 55)]),
    order=5,
)

# Dormand-Prince 5(4) (the growth table region).
DOPRI5 = Tableau(
    c=np.array([0.0, 0.2, 0.3, 0.8, _frac(8, 9), 1.0, 1.0]),
    a=np.array([
        [0, 0, 0, 0, 0, 0, 0],
        [0.2, 0, 0, 0, 0, 0, 0],
        [_frac(3, 40), _frac(9, 40), 0, 0, 0, 0, 0],
        [_frac(44, 45), _frac(-56, 15), _frac(32, 9), 0, 0, 0, 0],
        [_frac(19372, 6561), _frac(-25360, 2187), _frac(64448, 6561),
         _frac(-212, 729), 0, 0, 0],
        [_frac(9017, 3168), _frac(-355, 33), _frac(46732, 5247),
         _frac(49, 176), _frac(-5103, 18656), 0, 0],
        [_frac(35, 384), 0, _frac(500, 1113), _frac(125, 192),
         _frac(-2187, 6784), _frac(11, 84), 0],
    ]),
    b=np.array([_frac(35, 384), 0, _frac(500, 1113), _frac(125, 192),
                _frac(-2187, 6784), _frac(11, 84), 0]),
    e=np.array([_frac(71, 57600), 0, _frac(-71, 16695), _frac(71, 1920),
                _frac(-17253, 339200), _frac(22, 525), _frac(-1, 40)]),
    order=5,
)


def _dop853_tableau() -> Tableau:
    """Hairer's 8th-order Dormand-Prince DOP853, 12 stages, with the
    5th-order embedded error weights, from scipy's published table (the
    same public constants as Hairer's dopri853.f; redtime_tpu/ode.py:92-112).
    Controller order 8 (GSL convention: the method order)."""
    from scipy.integrate._ivp import dop853_coefficients as _d
    s = int(_d.N_STAGES)     # 12; E5[12] == 0 so the FSAL stage is unused
    return Tableau(c=np.array(_d.C[:s]), a=np.array(_d.A[:s, :s]),
                   b=np.array(_d.B), e=np.array(_d.E5[:s]), order=8)


DOP853 = _dop853_tableau()


def rk_stages(rhs: Callable, t, h, y, consts: AttemptConsts):
    """The s stage derivatives of one embedded RK step, stacked [s, B, D].

    y [B, D] flat; t, h [B].  rhs(t [B], y [B, D]) -> [B, D].  Stage i is
    evaluated at t + c_i h on y + h sum_{j<i} a_ij k_j (the JAX package's
    full-row tensordot adds only exact zeros beyond j < i); K3's rk_stage
    forms that input in one launch."""
    s = consts.s
    ks = torch.empty((s,) + tuple(y.shape), dtype=y.dtype, device=y.device)
    ts = t + consts.c * h                      # [s, B]: every stage time
    for i in range(s):
        yi = y if i == 0 else rk_stage(y, ks, h, consts, i)
        ks[i] = rhs(ts[i], yi)
    return ks


def rk_step(rhs: Callable, t, h, y, tab: Tableau):
    """One embedded RK step on every lane: returns (y_new, yerr).

    y [B, D]; t, h [B].  Sums stages in index order."""
    ks = rk_stages(rhs, t, h, y, attempt_consts(tab, 0.0, 0.0, y.device))
    hy = h[:, None]
    acc_b, acc_e = float(tab.b[0]) * ks[0], float(tab.e[0]) * ks[0]
    for j in range(1, len(tab.c)):
        acc_b = acc_b + float(tab.b[j]) * ks[j]
        acc_e = acc_e + float(tab.e[j]) * ks[j]
    return y + hy * acc_b, hy * acc_e


def _clipped_stages(rhs: Callable, t, h, y, t1, consts: AttemptConsts):
    """(ks, h_try): the stages of an attempt at the step h clipped to the
    interval end t1 (the same step under either final-step rule)."""
    dt = t1 - t
    h_try = torch.where(h > dt, dt, h)
    return rk_stages(rhs, t, h_try, y, consts), h_try


def attempt(rhs: Callable, t, h, y, t1, n, active, consts: AttemptConsts):
    """One controller attempt on every lane (frozen where not active).

    The step is clipped to the interval end; the stages run at the
    clipped step and K3 finishes the attempt under consts' final-step
    rule (h > t1 - t, the chunked path's, redtime_tpu/ode.py:164, or
    h >= t1 - t, the packed lanes', redtime_tpu/trg.py:446: the clipped
    step is the same under both).  Returns (y, t, h, n, r, reached)."""
    ks, _ = _clipped_stages(rhs, t, h, y, t1, consts)
    return rk_finish(y, ks, t, h, t1, n, active, consts)


def lane_values(x, B: int, device) -> torch.Tensor:
    """A float or [B] tensor as an f64 [B] tensor on device (a view when
    x is a scalar: clone before writing to it)."""
    v = torch.as_tensor(x, dtype=F64, device=device)
    return v.expand(B) if v.dim() == 0 else v


def integrate_interval(rhs: Callable, t0, t1, y0: torch.Tensor, h0,
                       eps_abs: float, eps_rel: float,
                       tab: Tableau = RKF45,
                       max_steps: int = 1_000_000,
                       return_stats: bool = False):
    """Integrate y' = rhs(t, y) from t0 to t1 (t1 >= t0) on every lane.

    y0 [B, ...]; t0, t1, h0: floats or [B] tensors.  rhs(t [B], y) takes
    and returns tensors shaped like y0.  Mirrors the reference's evolve
    loop `while ((t1 - t)*h > 0) apply(...)` per lane (redTime.cc:
    1614-1630) and the JAX package's vmapped `integrate_interval`.
    Returns (y(t1), h_suggest [B]) and, with return_stats, the per-lane
    attempt counts n [B] (accepted + rejected).

    A lane still short of t1 at max_steps (or stalled with h -> 0) is
    POISONED with NaN, so batch fault isolation (driver.finite_report)
    names it.

    The host checks whether any lane is still running once every
    CHECK_EVERY attempts; attempts on lanes that have finished are
    no-ops, so the result is the same as checking after every attempt."""
    shape = y0.shape
    B, dev = shape[0], y0.device
    y = y0.reshape(B, -1).contiguous()
    t = lane_values(t0, B, dev).contiguous()
    t1v = lane_values(t1, B, dev).contiguous()
    h = lane_values(h0, B, dev).contiguous()
    n = torch.zeros(B, dtype=torch.int64, device=dev)
    # validated once here, trusted by every attempt below
    consts = attempt_consts(tab, eps_abs, eps_rel, dev)

    def flat_rhs(tt, yy):
        return rhs(tt, yy.reshape(shape)).reshape(B, -1)

    def running():
        return (t < t1v) & (n < max_steps)

    active = running()
    while bool(active.any()):
        for _ in range(CHECK_EVERY):
            y, t, h, n, *_ = attempt(flat_rhs, t, h, y, t1v, n, active,
                                     consts)
            active = running()
    y = torch.where((t >= t1v)[:, None], y, torch.full_like(y, np.nan))
    y = y.reshape(shape)
    if return_stats:
        return y, h, n
    return y, h


def _rejected(r: torch.Tensor) -> torch.Tensor:
    """The controller's reject decision on K3's error norms r [B] (a NaN
    norm accepts, as in JAX's `r > 1.1`)."""
    return r > REJECT_ABOVE


def integrate_nodes(rhs: Callable, t0, nodes, y0: torch.Tensor, h0,
                    eps_abs: float, eps_rel: float,
                    tab: Tableau = RKF45,
                    max_steps: int = 1_000_000,
                    return_stats: bool = False):
    """Integrate from t0 through the sorted stop `nodes` [m] (all > t0) on
    every lane, recording y at every node, in one loop of attempts (the
    port of redtime_tpu/ode.py:199-295).

    Each lane runs its own controller, with the arithmetic and boundary
    clipping of a chain of `integrate_interval` calls over the node
    segments with the step suggestion carried across: a lane's segment
    ends on an accepted attempt that reaches (or, by rounding of a
    non-final step, passes) its node, and t is then pinned to the node.
    Returns (rows [B, m, ...], h_suggest [B][, n_attempts [B]]); rows from
    the first node a lane did not reach (max_steps exhausted or h -> 0)
    on are NaN."""
    shape = y0.shape
    B, dev = shape[0], y0.device
    nodes = torch.as_tensor(nodes, dtype=F64, device=dev)
    m = nodes.shape[0]
    y = y0.reshape(B, -1).contiguous()
    t = lane_values(t0, B, dev).contiguous()
    h = lane_values(h0, B, dev).contiguous()
    n = torch.zeros(B, dtype=torch.int64, device=dev)
    seg = torch.zeros(B, dtype=torch.int64, device=dev)
    rows = y.new_zeros((B, m, y.shape[1]))
    lanes = torch.arange(B, device=dev)
    consts = attempt_consts(tab, eps_abs, eps_rel, dev)

    def flat_rhs(tt, yy):
        return rhs(tt, yy.reshape(shape)).reshape(B, -1)

    def running():
        return (seg < m) & (n < max_steps)

    active = running()
    while bool(active.any()):
        for _ in range(CHECK_EVERY):
            at = torch.clamp(seg, max=m - 1)
            t1 = nodes[at]
            y, t, h, n, r, _ = attempt(flat_rhs, t, h, y, t1, n, active,
                                       consts)
            reached = active & ~_rejected(r) & (t >= t1)
            rows[lanes, at] = torch.where(reached[:, None], y,
                                          rows[lanes, at])
            t = torch.where(reached, t1, t)
            seg = seg + reached.to(seg.dtype)
            active = running()
    done = torch.arange(m, device=dev)[None, :] < seg[:, None]
    rows = torch.where(done[..., None], rows, torch.full_like(rows, np.nan))
    rows = rows.reshape((B, m) + tuple(shape[1:]))
    if return_stats:
        return rows, h, n
    return rows, h


# Dormand-Prince 5(4) continuous extension (4th-order dense output): the
# published d-coefficients of Hairer/Norsett/Wanner's DOPRI5 (Solving ODEs
# I; dopri5.f's CONTD5), as in redtime_tpu/ode.py:282-295.  Over an
# accepted step [t, t+h]:
#   y(t + theta h) = y + theta (dy + (1-theta)(r3 + theta (r4 + (1-theta) r5)))
DOPRI5_D = np.array([
    _frac(-12715105075.0, 11282082432.0),
    0.0,
    _frac(87487479700.0, 32700410799.0),
    _frac(-10690763975.0, 1880347072.0),
    _frac(701980252875.0, 199316789632.0),
    _frac(-1453857185.0, 822651844.0),
    _frac(69997945.0, 29380423.0),
])


def integrate_dense(rhs: Callable, t0, t1, y0: torch.Tensor, h0,
                    eps_abs: float, eps_rel: float, xs,
                    tab: Tableau = DOPRI5,
                    max_steps: int = 1_000_000,
                    return_stats: bool = False):
    """Integrate t0 -> t1 with free adaptive stepping on every lane and
    fill y at the output nodes `xs` [m] (sorted, all in (t0, t1]) from the
    4th-order continuous extension of each accepted step (the port of
    redtime_tpu/ode.py:296-372).

    The attempts are integrate_interval's (K3 forms the stage inputs and
    finishes each attempt); the dense fill of the nodes inside an
    accepted step is plain torch.  Returns (ys [B, m, ...], y(t1),
    h_suggest [B][, n_attempts [B]]); a lane that did not reach t1 has
    NaN in both.  Only DOPRI5 has a continuous extension here."""
    if tab is not DOPRI5:
        raise ValueError("integrate_dense: dense output is implemented for "
                         "DOPRI5 only")
    shape = y0.shape
    B, dev = shape[0], y0.device
    xs = torch.as_tensor(xs, dtype=F64, device=dev)
    m = xs.shape[0]
    y = y0.reshape(B, -1).contiguous()
    t = lane_values(t0, B, dev).contiguous()
    t1v = lane_values(t1, B, dev).contiguous()
    h = lane_values(h0, B, dev).contiguous()
    n = torch.zeros(B, dtype=torch.int64, device=dev)
    table = torch.full((B, m, y.shape[1]), np.nan, dtype=y.dtype,
                       device=dev)
    d_vec = torch.as_tensor(DOPRI5_D, dtype=y.dtype, device=dev)
    consts = attempt_consts(tab, eps_abs, eps_rel, dev)

    def flat_rhs(tt, yy):
        return rhs(tt, yy.reshape(shape)).reshape(B, -1)

    def running():
        return (t < t1v) & (n < max_steps)

    active = running()
    while bool(active.any()):
        for _ in range(CHECK_EVERY):
            ks, h_try = _clipped_stages(flat_rhs, t, h, y, t1v, consts)
            y_out, t_out, h, n, r, _ = rk_finish(y, ks, t, h, t1v, n, active,
                                                 consts)
            # dense fill of every node inside the accepted step (t, t_out]
            hy = h_try[:, None]
            dy = y_out - y
            r3 = hy * ks[0] - dy
            r4 = dy - hy * ks[-1] - r3
            r5 = hy * torch.einsum("s,sbd->bd", d_vec, ks)
            th = ((xs[None, :] - t[:, None]) / h_try[:, None])[..., None]
            vals = y[:, None] + th * (dy[:, None] + (1.0 - th) * (
                r3[:, None] + th * (r4[:, None] + (1.0 - th) * r5[:, None])))
            fill = ((active & ~_rejected(r))[:, None]
                    & (xs[None, :] > t[:, None])
                    & (xs[None, :] <= t_out[:, None]))
            table = torch.where(fill[..., None], vals, table)
            y, t = y_out, t_out
            active = running()
    ok = (t >= t1v)[:, None]
    y = torch.where(ok, y, torch.full_like(y, np.nan)).reshape(shape)
    table = torch.where(ok[..., None], table, torch.full_like(table, np.nan))
    table = table.reshape((B, m) + tuple(shape[1:]))
    if return_stats:
        return table, y, h, n
    return table, y, h
