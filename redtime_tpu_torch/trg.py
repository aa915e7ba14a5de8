"""Time-RG evolution: state layout, the full-TRG RHS, and the eta
integration.

State tensor y [B, nU=41, nk] (reference redTime.cc:150, 1418-1423):
  rows 0..2   : ln P_00, ln P_01, ln P_11
  rows 3..16  : the 14 unique I_{acd,bef} components (JU order)
  rows 17..40 : 24 Q^ell_{abc} components, ell-major then (4a+2b+c)

The RHS (reference derivatives(), :1416-1547) is whole-grid tensor algebra
on every lane: the Omega x I / Omega x Q index contractions are the JAX
package's bilinear forms (assembly.OMEGA_BILINEAR), and the mode-coupling
A/R sources come from the full FAST-PT engine at every evaluation
(full Time-RG, :740-1282) or, in 1-loop mode, from the z1l cache
rescaled by growth factors (:1287-1340).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from redtime_tpu_torch import assembly, fastpt, profiling
from redtime_tpu_torch import background as bg
from redtime_tpu_torch import model as mdl
from redtime_tpu_torch.config import RunSettings, SolverConfig
from redtime_tpu_torch.grids import make_grids
from redtime_tpu_torch.kernels import rhs_tail as rt
from redtime_tpu_torch.kernels.rhs_tail import (ABC_IDX, BEF_IDX, NU_STATE,
                                                NUI, NUP, NUQ)
from redtime_tpu_torch.kernels.rk_finish import attempt_consts
from redtime_tpu_torch.ode import (CHECK_EVERY, DOP853, DOPRI5, RKF45,
                                   attempt, integrate_interval, lane_values)
from redtime_tpu_torch.profiling import span

NELL = 3

F64 = torch.float64

_PT_IDX = [3 - m for m in assembly.M_N]


class OneLoopCache(NamedTuple):
    """Mode coupling evaluated once at z1l from the linear spectrum
    (reference :1291-1313), per lane."""

    A64: torch.Tensor     # [B, 64, nk]
    R: torch.Tensor       # [B, 3, 8, nk]
    PT: torch.Tensor      # [B, 9, nk]
    PMR: torch.Tensor     # [B, 8, nk]
    D_z1l: torch.Tensor   # [B, nk]


def omega_tables(model: mdl.Model, a_in: float) -> rt.OmegaIn:
    """The tables Omega(a, k) is looked up in (K8's OmegaIn), at
    a = a_in e^eta: the model's beta_P table, f_nu, Omega_m and the
    cosmology's constants (bg.omega_consts)."""
    c = model.cosmo
    consts = bg.omega_consts(c)
    return rt.OmegaIn(model.beta_a.contiguous(),
                      model.beta_solver.contiguous(),
                      model.f_nu.contiguous(), c.Omega_m.contiguous(),
                      bg.OmegaConsts(*[x.contiguous() for x in consts]),
                      float(a_in))


def omega_inputs(model: mdl.Model, a: torch.Tensor) -> rt.OmegaAt:
    """What Omega(a, k) is built from at per-lane a [B]: beta_P [B, nk]
    and the lane scalars Omega_m, f_cb, a^3 H^2/H0^2, 3 + dlnH/dlna."""
    a = lane_values(a, model.batch, model.norm.device)
    return rt.omega_at(omega_tables(model, 1.0), a)


def omega_matrix(cfg: SolverConfig, model: mdl.Model, a: torch.Tensor):
    """Omega(a, k) [B, 2, 2, nk] at per-lane a [B] (reference
    :1383-1411)."""
    return rt.omega_from(omega_inputs(model, a))


def compute_mode_coupling_full(cfg: SolverConfig, lnP3: torch.Tensor, n_s,
                               with_rsd: bool, k: torch.Tensor,
                               ec: fastpt.EngineConsts):
    """Full FAST-PT evaluation from the current spectra lnP3 [B, 3, nk];
    returns (A_unique [B,14,nk], R [B,3,8,nk], PT [B,9,nk],
    PMR [B,8,nk])."""
    return mode_coupling(*fastpt.compute_J_PZ(cfg, lnP3, n_s, with_rsd, ec),
                         k, with_rsd)


def mode_coupling(Jw: torch.Tensor, PZw: torch.Tensor, k: torch.Tensor,
                  with_rsd: bool):
    """assembly.assemble on the engine's outputs (fastpt.compute_J_PZ: Jw
    [B, nfam, 3, 3, nk+1], PZw [B, 7, 3, 3, nk]) cut to the solver window
    (J_lo: column nk of J[0, 0, 0]; without RSD no Jn0 row is read);
    returns (A_unique, R, PT, PMR) as compute_mode_coupling_full."""
    nk = k.shape[0]
    Jf = Jw[..., :nk]
    return assembly.assemble(Jf[:, :7], PZw, Jf[:, 7:], Jw[:, 0, 0, 0, nk],
                             k, with_rsd)


def build_oneloop_cache(cfg: SolverConfig, settings: RunSettings,
                        model: mdl.Model,
                        ec: fastpt.EngineConsts) -> OneLoopCache:
    """Evaluate the mode coupling at z1l from the LINEAR cb spectrum
    (reference :1295-1313: all three rows are ln P_lin_cb, no f factors)."""
    g = make_grids(cfg)
    _, Pcb, _ = mdl.plin_all(cfg, model, cfg.z1l)
    lnP3 = torch.log(Pcb)[:, None, :].expand(-1, 3, -1)
    engine_rsd = settings.print_rsd or cfg.print_q  # Q evolution needs R
    k = torch.as_tensor(g.k, dtype=F64, device=Pcb.device)
    A_u, R, PT, PMR = compute_mode_coupling_full(
        cfg, lnP3, model.cosmo.n_s, engine_rsd, k, ec)
    D_z1l, _ = mdl.growth_D_f(model, cfg.z1l)
    return OneLoopCache(assembly.expand64(A_u), R, PT, PMR, D_z1l)


def oneloop_rescale(cfg: SolverConfig, settings: RunSettings,
                    model: mdl.Model, cache: OneLoopCache,
                    eta: torch.Tensor):
    """Rescale the z1l mode coupling to per-lane eta [B] (reference
    :1316-1337); returns (A64 [B,64,nk], R [B,3,8,nk], PT [B,9,nk],
    PMR [B,8,nk]).  The powers of fz are multiply chains, in the JAX
    package's order."""
    z = torch.exp(-eta) * (1.0 + settings.z_in) - 1.0   # [B]
    D, dDda = mdl.growth_D_f(model, z)                   # [B, nk]
    fz = dDda / (D * (1.0 + z)[:, None])
    dr = D / cache.D_z1l
    dr2 = dr * dr
    pre = (dr2 * dr2 * torch.exp(-4.0 * eta)[:, None])[:, None]  # [B,1,nk]

    f2 = fz * fz
    fpow = torch.stack([fz, f2, f2 * fz, f2 * f2], dim=1)  # [B, 4, nk]
    A64 = pre * fpow[:, BEF_IDX] * cache.A64
    R = pre[:, None] * fpow[:, ABC_IDX][:, None] * cache.R
    PT = pre * fpow[:, _PT_IDX] * cache.PT
    PMR = pre * cache.PMR
    return A64, R, PT, PMR


def _collapse_pt(PT: torch.Tensor) -> torch.Tensor:
    """PTjm [B, 9, nk] -> PT2/4/6/8 [B, 4, nk] (reference :1353-1357)."""
    return torch.stack([PT[:, 0] + PT[:, 1] + PT[:, 2],
                        PT[:, 3] + PT[:, 4] + PT[:, 5],
                        PT[:, 6] + PT[:, 7], PT[:, 8]], dim=1)


def rhs_prologue(cfg: SolverConfig, settings: RunSettings,
                 model: mdl.Model, ec: fastpt.EngineConsts,
                 cache: OneLoopCache | None = None):
    """What one RHS evaluation runs before K8: prologue(eta [B],
    y [B, 41*nk]) returns the arguments of kernels.rhs_tail.rhs_tail
    (y [B, 41, nk], eta, k, OmegaIn, src, evolve_q): in full Time-RG the
    engine, K9, K10, K1 and K2 (FullSrc); in 1-loop mode `cache`'s rows
    and the growth tables (OneLoopSrc); in linear mode src None.  The
    tables (OmegaIn, OneLoopSrc) are made once here: K8 looks a, beta_P,
    the Omega scalars and the 1-loop growth up in them itself."""
    one_loop = settings.nonlinear and settings.one_loop
    if one_loop and cache is None:
        raise ValueError("1-loop mode needs the z1l cache "
                         "(trg.build_oneloop_cache)")
    g = make_grids(cfg)
    nk = g.nk
    k = torch.as_tensor(g.k, dtype=F64, device=model.norm.device)
    evolve_q = settings.print_rsd or cfg.print_q
    nonlinear = settings.nonlinear
    om = omega_tables(model, settings.a_in)
    # once per model: the cache's unique A rows (the RHS reads no others)
    # and the growth tables
    src = (rt.OneLoopSrc(cache.A64[:, assembly.JU].contiguous(),
                         cache.R.contiguous(), model.g_lna.contiguous(),
                         model.g_G.contiguous(), model.g_dDda.contiguous(),
                         model.g_Dnorm.contiguous(),
                         cache.D_z1l.contiguous(), float(settings.z_in))
           if one_loop else None)

    def prologue(eta, yflat):
        B = yflat.shape[0]
        y = yflat.reshape(B, NU_STATE, nk)
        if nonlinear and not one_loop:
            return (y.contiguous(), eta.contiguous(), k, om,
                    rt.FullSrc(*fastpt.compute_J_PZ(
                        cfg, y[:, 0:3], model.cosmo.n_s, evolve_q, ec,
                        clip=True)), evolve_q)
        return y.contiguous(), eta.contiguous(), k, om, src, evolve_q

    return prologue


def make_rhs(cfg: SolverConfig, settings: RunSettings, model: mdl.Model,
             ec: fastpt.EngineConsts, cache: OneLoopCache | None = None):
    """The flattened-state RHS dy/deta (reference derivatives()):
    rhs(eta [B], y [B, 41*nk]) -> [B, 41*nk].  In 1-loop mode the
    mode coupling comes from `cache` (build_oneloop_cache).  Each
    evaluation is rhs_prologue (in full Time-RG the engine: K9, K10, K1,
    K2), then K8 rhs_tail for all that follows the engine."""
    prologue = rhs_prologue(cfg, settings, model, ec, cache)

    def rhs(eta, yflat):
        with span("trg.rhs"):
            args = prologue(eta, yflat)
            with span("rhs_tail"):
                return rt.rhs_tail(*args).reshape(yflat.shape[0], -1)

    return rhs


def initial_state(cfg: SolverConfig, settings: RunSettings,
                  model: mdl.Model) -> torch.Tensor:
    """y(eta=0) [B, 41*nk] (reference :1570-1586): lnP rows from
    P_lin_cb(z_in) with growth-rate f factors; I and Q start at zero."""
    nk = make_grids(cfg).nk
    D, dDda = mdl.growth_D_f(model, settings.z_in)
    f_in = settings.a_in * dDda / D
    _, Pcb, _ = mdl.plin_all(cfg, model, settings.z_in)
    lnP = torch.stack([torch.log(Pcb), torch.log(Pcb * f_in),
                       torch.log(Pcb * f_in * f_in)], dim=1)
    B = lnP.shape[0]
    return torch.cat([lnP, lnP.new_zeros((B, NUI + NUQ, nk))],
                     dim=1).reshape(B, -1)


def eta_tableau(cfg: SolverConfig):
    """The embedded RK pair of the eta evolution ('rkf45' is the
    reference's gsl rkf45, redTime.cc:1593)."""
    return {"rkf45": RKF45, "dopri5": DOPRI5,
            "dop853": DOP853}[cfg.eta_tableau]


def evolve(cfg: SolverConfig, settings: RunSettings, model: mdl.Model,
           ec: fastpt.EngineConsts, return_stats: bool = False):
    """Integrate the Time-RG system through all output redshifts.

    Returns ys [B, n_eta, 41, nk], the state at each output (and, with
    return_stats, the per-lane controller attempts [B] summed over the
    intervals).  Mirrors the reference main loop (:1589-1630): RKF45 with
    control_y_new(eabs_P, erel_P), initial step 1e-2*(eta_fin - eta_in),
    the step suggestion carried across output boundaries."""
    nk = make_grids(cfg).nk
    cache = (build_oneloop_cache(cfg, settings, model, ec)
             if settings.nonlinear and settings.one_loop else None)
    y = initial_state(cfg, settings, model)
    rhs = make_rhs(cfg, settings, model, ec, cache)
    h = 1e-2 * float(np.log(1.0 / settings.a_in))
    etasteps = settings.etasteps()
    t0s = np.concatenate([[0.0], etasteps[:-1]])
    outs = []
    attempts = torch.zeros(y.shape[0], dtype=torch.int64, device=y.device)
    ns, rounds = [], 0
    for t0, t1 in zip(t0s, etasteps):
        y, h, n, r = integrate_interval(rhs, float(t0), float(t1), y, h,
                                        cfg.eabs_P, cfg.erel_P,
                                        eta_tableau(cfg), return_stats=True)
        attempts = attempts + n
        outs.append(y)
        ns.append(n)
        rounds += r
    if profiling.counting():
        profiling.count_lockstep(rounds * CHECK_EVERY, rounds + len(ns),
                                 ns)
    ys = torch.stack(outs, dim=1).reshape(y.shape[0], len(etasteps),
                                          NU_STATE, nk)
    return (ys, attempts) if return_stats else ys


def evolve_packed(cfg: SolverConfig, settings: RunSettings,
                  models: mdl.Model, ec: fastpt.EngineConsts,
                  n_lanes: int = 8, max_iters: int = 1_000_000,
                  return_iters: bool = False, return_stats: bool = False):
    """Work-queue batched evolution: the JAX package's packed scheduler
    (redtime_tpu/trg.py:374-560).

    L = min(n_lanes, N) lanes each advance their own controller through
    all output redshifts of one model; a lane that passes its last output
    flushes its rows and takes the next model off the queue (lanes take
    distinct models in lane order), or goes inactive when none is left.
    The loop ends when no lane is active or after max_iters attempts; a
    model it never finished keeps zero rows, as in the JAX package.
    Every attempt is one controller attempt on all L lanes (K3 under the
    packed rule, h >= t1 - t, redtime_tpu/trg.py:446), with the same
    controller arithmetic as evolve, so results agree with the chunked
    scheduler within the controller band, not bit for bit.

    The queue lives on the host: after each attempt the host reads which
    lanes finished (one wait for the device an attempt) and gathers the
    next models' rows by index.  Every model's initial state (and its z1l
    cache in 1-loop mode) is built once, up front.

    models: a prepared Model of N lanes.  Returns ys [N, S, 41, nk]
    (S output redshifts), then, with return_iters, the attempts the loop
    ran and, with return_stats, each model's attempts [N]."""
    nk = make_grids(cfg).nk
    N, S = models.batch, len(settings.z_out)
    L = min(n_lanes, N)
    dev = models.norm.device
    etasteps = torch.as_tensor(settings.etasteps(), dtype=F64, device=dev)
    h_init = 1e-2 * float(np.log(1.0 / settings.a_in))
    consts = attempt_consts(eta_tableau(cfg), cfg.eabs_P, cfg.erel_P, dev,
                            final_at_equal=True)
    one_loop = settings.nonlinear and settings.one_loop
    caches = (build_oneloop_cache(cfg, settings, models, ec)
              if one_loop else None)
    y0_all = initial_state(cfg, settings, models)        # [N, 41 nk]

    lanes = torch.arange(L, device=dev)
    m = mdl.take_lanes(models, lanes)
    cache = mdl.take_lanes(caches, lanes) if one_loop else None
    rhs = make_rhs(cfg, settings, m, ec, cache)
    y = y0_all[:L].clone()
    t = torch.zeros(L, dtype=F64, device=dev)
    h = torch.full((L,), h_init, dtype=F64, device=dev)
    n = torch.zeros(L, dtype=torch.int64, device=dev)
    seg = torch.zeros(L, dtype=torch.int64, device=dev)
    active = torch.ones(L, dtype=torch.bool, device=dev)
    outloc = y.new_zeros((L, S, y.shape[1]))      # each lane's outputs
    out = y.new_zeros((N, S, y.shape[1]))
    attempts = torch.zeros(N, dtype=torch.int64, device=dev)
    # the queue, on the host: each lane's model, which lanes are live and
    # the next model's index
    midx, live, counter = list(range(L)), [True] * L, L
    it = 0
    while any(live) and it < max_iters:
        t1 = etasteps[seg.clamp(max=S - 1)]
        y, t, h, n, _, reached = attempt(rhs, t, h, y, t1, n, active,
                                         consts)
        it += 1
        # a lane that reached its segment's end records its state there
        at = seg.clamp(max=S - 1)
        outloc[lanes, at] = torch.where(reached[:, None], y,
                                        outloc[lanes, at])
        seg = seg + reached
        finished = ((seg >= S) & active).tolist()       # waits for the card
        if not any(finished):
            continue
        done = [i for i in range(L) if finished[i]]
        d_idx = torch.tensor(done, device=dev)
        m_idx = torch.tensor([midx[i] for i in done], device=dev)
        out.index_copy_(0, m_idx, outloc[d_idx])
        attempts.index_copy_(0, m_idx, n[d_idx])
        take = [(i, counter + k) for k, i in enumerate(done)
                if counter + k < N]
        counter += len(done)
        for i in done[len(take):]:
            live[i] = False
        if len(take) < len(done):
            active = torch.tensor(live, device=dev)
        if not take:
            continue
        for i, j in take:
            midx[i] = j
        t_idx = torch.tensor([i for i, _ in take], device=dev)
        n_idx = torch.tensor([j for _, j in take], device=dev)
        m = mdl.put_lanes(m, t_idx, mdl.take_lanes(models, n_idx))
        if one_loop:
            cache = mdl.put_lanes(cache, t_idx, mdl.take_lanes(caches, n_idx))
        rhs = make_rhs(cfg, settings, m, ec, cache)
        y.index_copy_(0, t_idx, y0_all[n_idx])
        t.index_fill_(0, t_idx, 0.0)
        h.index_fill_(0, t_idx, h_init)
        n.index_fill_(0, t_idx, 0)
        seg.index_fill_(0, t_idx, 0)
    ys = out.reshape(N, S, NU_STATE, nk)
    extra = ((it,) if return_iters else ()) + (
        (attempts,) if return_stats else ())
    return (ys,) + extra if extra else ys


def pbis_j(cfg: SolverConfig, ys: torch.Tensor) -> torch.Tensor:
    """A(k, mu) columns from the evolved Q (reference Pbisj, :265-298).

    ys: [B, 41, nk] states at one output.  Returns [B, 5, nk]: the
    (j_mu, m_b) combos (2,2), (2,1), (4,1), (4,0), (6,0)."""
    g = make_grids(cfg)
    k = torch.as_tensor(g.k, dtype=ys.dtype, device=ys.device)
    B = ys.shape[0]
    Q = ys[:, NUP + NUI:].reshape(B, NELL, 2, 2, 2, g.nk)
    return torch.stack(pbis_rows(lambda l, a, b, c: Q[:, l, a, b, c], k),
                       dim=1)


def pbis_rows(Q, k) -> list:
    """pbis_j's 5 rows from the reader Q(l, a, b, c) of Q^(l+1)_abc (state
    row NUP + NUI + 8 l + 4 a + 2 b + c) and k.  Arithmetic operators
    only, so that K11 out_block's code can be traced from it."""
    p22 = -2.0 * Q(0, 0, 1, 0) + (4.0 / 3.0) * Q(1, 0, 1, 0)
    p21 = (4.0 / 3.0) * Q(1, 0, 1, 1) + (6.0 / 5.0) * Q(2, 0, 1, 1)
    p41 = (-2.0 * Q(0, 1, 1, 0) + (4.0 / 3.0) * Q(1, 1, 1, 0)
           - 2.0 * Q(0, 0, 1, 1) - 2.0 * Q(2, 0, 1, 1))
    p40 = (4.0 / 3.0) * Q(1, 1, 1, 1) + (6.0 / 5.0) * Q(2, 1, 1, 1)
    p60 = -2.0 * Q(0, 1, 1, 1) - 2.0 * Q(2, 1, 1, 1)
    pk = np.pi * k
    return [pk * p for p in (p22, p21, p41, p40, p60)]
