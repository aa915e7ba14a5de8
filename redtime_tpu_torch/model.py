"""Per-cosmology model preparation: growth tables, beta_P, linear power.

The reference's lazily-initialized `cosmological_parameters` singleton
(`AU_cosmological_parameters.h`) becomes an explicit `prepare_model` step
returning a `Model` of tensors: the (lna, lnk) growth tables (:639-731),
the beta_P neutrino table (:513-630), the transfer table (:790-832) and the
sigma_8 normalization (:834-891), pre-reduced onto the static solver
k-grid so the hot path does only 1-D interpolation in time.

Everything is batched: a Model holds B cosmologies along a leading
dimension, and every growth integration and quadrature runs one adaptive
controller per lane, as the JAX package's vmapped `prepare_model` does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from redtime_tpu_torch import background as bg
from redtime_tpu_torch import interp
from redtime_tpu_torch.config import CosmoParams, SolverConfig
from redtime_tpu_torch.grids import make_grids
from redtime_tpu_torch.io.camb import LinearData
from redtime_tpu_torch.ode import (DOP853, DOPRI5, integrate_dense,
                                   integrate_interval, lane_values)
from redtime_tpu_torch.profiling import span
from redtime_tpu_torch.quadrature import qag_gk61

F64 = torch.float64


class Model(NamedTuple):
    """Prepared per-cosmology state, batched along dimension 0."""

    cosmo: CosmoParams       # fields [B]
    g_lna: torch.Tensor      # [B, n_lna+1]
    g_G: torch.Tensor        # [B, n_lna+1, nk]  G = D/a (x a_early)
    g_dDda: torch.Tensor     # [B, n_lna+1, nk]  dD/da (x a_early)
    g_Dnorm: torch.Tensor    # [B, nk]           G interpolated at lna=0
    beta_a: torch.Tensor     # [B, nz]
    beta_solver: torch.Tensor  # [B, nz, nk] beta/f_nu on the solver grid
    T_solver: torch.Tensor   # [B, nk] z=0 cb transfer, T(k_min)=1
    norm: torch.Tensor       # [B] sigma_8 normalization of P_lin
    sigmaV2_z0: torch.Tensor  # [B] velocity dispersion at z=0

    @property
    def f_nu(self):
        return self.cosmo.Omega_nu / self.cosmo.Omega_m

    @property
    def f_cb(self):
        return 1.0 - self.f_nu

    @property
    def batch(self) -> int:
        return self.norm.shape[0]


def _col(v: torch.Tensor) -> torch.Tensor:
    """A per-lane value [B] as a column [B, 1]."""
    return v[:, None]


# ---------------------------------------------------------------------------
# static helpers (numpy, cached per config)

@functools.lru_cache(maxsize=8)
def growth_nodes(cfg: SolverConfig):
    """Growth-table axes (reference :677-687), inclusive endpoints."""
    lna_min = np.log(cfg.growth_a_min)
    dlna = np.log(cfg.growth_a_max / cfg.growth_a_min) / cfg.growth_n_lna
    lna = lna_min + dlna * np.arange(cfg.growth_n_lna + 1)
    lnk_min = np.log(cfg.growth_k_min)
    dlnk = np.log(cfg.growth_k_max / cfg.growth_k_min) / cfg.growth_n_lnk
    lnk = lnk_min + dlnk * np.arange(cfg.growth_n_lnk + 1)
    return lna, lnk


@functools.lru_cache(maxsize=8)
def growth_k_reduction(cfg: SolverConfig) -> np.ndarray:
    """Static weight matrix W [nk, n_lnk+1]: growth-table values at the
    solver k-grid = table @ W.T (k clamped to the table range, reference
    :651-659)."""
    grids = make_grids(cfg)
    _, lnk_nodes = growth_nodes(cfg)
    lnk_q = np.clip(grids.lnk, np.log(cfg.growth_k_min),
                    np.log(cfg.growth_k_max))
    return interp.weight_matrix_np(lnk_nodes, lnk_q)


@functools.lru_cache(maxsize=8)
def quad_nodes(cfg: SolverConfig):
    """Composite Gauss-Legendre nodes/weights on [quad_lnk_lo, quad_lnk_hi]
    (quad_impl='gl': a fixed-order panel rule in place of the reference's
    gsl_integration_qag, key=6, rel 1e-4, :849-874)."""
    x, w = np.polynomial.legendre.leggauss(cfg.quad_order)
    edges = np.linspace(cfg.quad_lnk_lo, cfg.quad_lnk_hi, cfg.quad_panels + 1)
    lo, hi = edges[:-1, None], edges[1:, None]
    nodes = (0.5 * (hi - lo) * x[None, :] + 0.5 * (hi + lo)).ravel()
    weights = (0.5 * (hi - lo) * w[None, :]).ravel()
    return nodes, weights


# ---------------------------------------------------------------------------
# beta_P evaluation

def _nz(lin: LinearData) -> int:
    return lin.beta_raw.shape[-2]


def _beta_reduce_k(lin: LinearData, k_query: torch.Tensor) -> torch.Tensor:
    """Reduce each lane's raw beta table over its k axis at the (clamped)
    query points k_query [m] or [B, m] -> [B, nz, m].  The 2-D
    tabulated_function interpolation is separable, so reducing one axis
    first is exact."""
    B = lin.t_lnk.shape[0]
    if _nz(lin) == 0:
        return lin.beta_raw.new_zeros((B, 0, k_query.shape[-1]))
    kq = k_query.expand(B, k_query.shape[-1])
    i0, w = interp.axis_weights(lin.beta_k, kq)          # [B, m], [B, m, 4]
    nz = _nz(lin)
    idx = (i0[..., None] + torch.arange(4, device=kq.device))   # [B, m, 4]
    idx = idx.reshape(B, 1, -1).expand(B, nz, idx.shape[1] * 4)
    block = torch.gather(lin.beta_raw, 2, idx).reshape(B, nz, -1, 4)
    return (block * w[:, None]).sum(-1)


def beta_raw_at_a(beta_a: torch.Tensor, beta_cols: torch.Tensor,
                  a: torch.Tensor) -> torch.Tensor:
    """Interpolate each lane's k-reduced beta table [B, nz, ...] in a [B]
    (tabulated_function rules; a already clamped).  Returns beta/f_nu
    [B, ...]."""
    w = interp.axis_weights_full(beta_a, a)              # [B, nz]
    return torch.einsum("bz,bz...->b...", w, beta_cols)


def beta_P_solver(model: Model, a) -> torch.Tensor:
    """beta_P(a, k) on the solver grid [B, nk] (reference :513-637):
    a > 1 evaluates at a = 1; zero when f_nu < 1e-10 or the table is
    empty."""
    B = model.batch
    return beta_P_at(model.beta_a, model.beta_solver, model.f_nu,
                     lane_values(a, B, model.norm.device))


def beta_P_at(beta_a: torch.Tensor, beta_solver: torch.Tensor,
              f_nu: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """beta_P_solver on a model's tables: beta_a [B, nz], beta_solver
    [B, nz, nk], f_nu [B] at a [B]."""
    B, nz, nk = beta_solver.shape
    if nz == 0:
        return beta_solver.new_zeros((B, nk))
    raw = beta_raw_at_a(beta_a, beta_solver, torch.clamp(a, max=1.0))
    f_nu = _col(f_nu)
    return torch.where(f_nu < 1e-10, torch.zeros_like(raw), f_nu * raw)


# ---------------------------------------------------------------------------
# growth ODE

def _growth_rhs(c, d, f_nu, beta_a, beta_col, x, y):
    """d/d(ln a) of the scaled growth state (w, v) = (D a_early / a,
    dD/da a_early) on every k lane (reference :133-158, F_MG = 0; the JAX
    package's bounded factorization, redtime_tpu/model.py:151-183):

        dw/dx = v - w
        dv/dx = -(3 + dlnH/dlna) v + 1.5 Om (f_c + beta) (a / s) w

    x [B]; y [B, n_lanes, 2]; beta_col [B, nz, n_lanes]."""
    a = torch.exp(x)
    s = bg.a4H2_H02(c, a, d)
    C0 = _col(1.5 * c.Omega_m * a / s)
    F1 = _col(3.0 + bg.dlnH_dlna_bounded(c, a, d))
    fn = _col(f_nu)
    early = _col(a) < 1e-3
    if beta_a.shape[1] == 0:
        beta = torch.where(early, fn, torch.zeros_like(fn))
    else:
        tab = fn * beta_raw_at_a(beta_a, beta_col, torch.clamp(a, max=1.0))
        beta = torch.where(early, fn,
                           torch.where(fn < 1e-10, torch.zeros_like(tab),
                                       tab))
    fc = 1.0 - fn
    return torch.stack([y[..., 1] - y[..., 0],
                        -F1 * y[..., 1] + C0 * (fc + beta) * y[..., 0]],
                       dim=-1)


def _growth_rhs_ramp(c, d, f_nu, x, y):
    """The growth RHS on the a_early -> min(a_min, 1e-3) ramp, where the
    reference's clamp fixes Beta == f_nu (:148): k-independent, one [2]
    state per lane.  x [B], y [B, 2]."""
    a = torch.exp(x)
    s = bg.a4H2_H02(c, a, d)
    C0 = 1.5 * c.Omega_m * a / s
    F1 = 3.0 + bg.dlnH_dlna_bounded(c, a, d)
    fc = 1.0 - f_nu
    return torch.stack([y[:, 1] - y[:, 0],
                        -F1 * y[:, 1] + C0 * (fc + f_nu) * y[:, 0]], dim=1)


def build_growth_tables(cfg: SolverConfig, c: CosmoParams,
                        lin: LinearData):
    """Integrate the growth ODE over all k nodes and tabulate G = D/a and
    dD/da on the (lna, lnk) grid (reference :661-724), as the JAX package
    does (redtime_tpu/model.py:202-308):

    * the k-independent a_early -> a_min ramp once per lane (DOP853 by
      default);
    * the table region as one [n_lnk+1, 2] state per lane under one
      controller, node-stopped by DOPRI5 with the step carried across
      segments (or reset to 1e-6 with growth_h_reset), or, with
      growth_dense (ignored under growth_h_reset), stepped freely over
      the whole table range with DOPRI5's dense output at the lna nodes
      (integrate_dense);
    * one k lane when the stack is empty (massless nu: no k dependence).

    Returns (lna_nodes numpy, G [B, n_lna+1, n_lnk+1], dDda [same])."""
    d = bg.derived(c)
    f_nu = c.Omega_nu / c.Omega_m
    dev = lin.t_lnk.device
    B = lin.t_lnk.shape[0]
    lna_nodes, lnk_nodes = growth_nodes(cfg)
    k_nodes = np.exp(lnk_nodes)
    kq = torch.as_tensor(np.clip(k_nodes, cfg.beta_k_min, cfg.beta_k_max),
                         dtype=F64, device=dev)
    beta_cols = _beta_reduce_k(lin, kq)                  # [B, nz, n_lnk+1]
    rtol = cfg.growth_rtol
    x_early = float(np.log(cfg.a_early))
    x_min = float(np.log(cfg.growth_a_min))
    x_share = min(x_min, float(np.log(1e-3)))
    ramp_tab = DOP853 if cfg.growth_ramp_tableau == "dop853" else DOPRI5

    y_r, h_r = integrate_interval(
        lambda x, y: _growth_rhs_ramp(c, d, f_nu, x, y),
        x_early, x_share, torch.ones((B, 2), dtype=F64, device=dev), 1e-6,
        0.0, rtol, ramp_tab)

    n_lanes = len(k_nodes) if _nz(lin) else 1
    bc = beta_cols if _nz(lin) else beta_cols.new_zeros((B, 0, n_lanes))

    def rhs(x, y):
        return _growth_rhs(c, d, f_nu, lin.beta_a, bc, x, y)

    y = y_r[:, None, :].expand(B, n_lanes, 2).contiguous()
    h = h_r
    if x_share < x_min:
        y, h = integrate_interval(rhs, x_share, x_min, y, h, 0.0, rtol,
                                  ramp_tab)
    if cfg.growth_dense and not cfg.growth_h_reset:
        rows, _, _ = integrate_dense(rhs, x_min, float(lna_nodes[-1]), y, h,
                                     0.0, rtol, lna_nodes[1:], DOPRI5)
        tabs = torch.cat([y[:, None], rows], dim=1)
    else:
        rows = [y]
        for x0, x1 in zip(lna_nodes[:-1], lna_nodes[1:]):
            hseg = 1e-6 if cfg.growth_h_reset else h
            y, h = integrate_interval(rhs, float(x0), float(x1), y, hseg,
                                      0.0, rtol, DOPRI5)
            rows.append(y)
        tabs = torch.stack(rows, dim=1)          # [B, n_lna+1, n_lanes, 2]
    G, dDda = tabs[..., 0], tabs[..., 1]
    if n_lanes != len(k_nodes):
        G = G.expand(B, G.shape[1], len(k_nodes))
        dDda = dDda.expand(B, dDda.shape[1], len(k_nodes))
    return lna_nodes, G, dDda


# ---------------------------------------------------------------------------
# linear power spectrum pieces

def _transfer_lnT(c: CosmoParams, lin: LinearData) -> torch.Tensor:
    """ln T_cb(ln k) table [B, nT] from the z=0 transfer file (reference
    :804-816): T_cb = f_b_cb*T_b + (1-f_b_cb)*T_c, normalized to the first
    row."""
    f_b_cb = _col(c.Omega_b / (c.Omega_m - c.Omega_nu))
    T = f_b_cb * lin.t_Tb + (1.0 - f_b_cb) * lin.t_Tc
    return torch.log(T / T[:, :1])


def transfer_at(c: CosmoParams, lin: LinearData,
                lnk_query: torch.Tensor) -> torch.Tensor:
    """T_cb at query points lnk_query [m] or [B, m] -> [B, m]
    (tabulated_function 1-D rules on _transfer_lnT; linear extrapolation
    of ln T beyond both table ends)."""
    lnT = _transfer_lnT(c, lin)
    q = lnk_query.expand(lnT.shape[0], lnk_query.shape[-1])
    return torch.exp(interp.interp1(lin.t_lnk, lnT, q))


def sigma8_normalization(cfg: SolverConfig, c: CosmoParams,
                         lin: LinearData,
                         beta_quad_a1: torch.Tensor) -> torch.Tensor:
    """Norm = sigma_8^2 / integral [B] on the fixed Gauss-Legendre panels
    (quad_impl='gl'; reference :849-875).

    Integrand (reference :204-217): W(kR)^2 T^2 F^2 k^(ns+3) / (2 pi^2)
    over ln kR in [-15, 15], R = 8, F = f_cb + beta_P(a=1, k) (beta_quad_a1
    [B, m] at k = e^nodes / R), with the Taylor-switched window below
    kR = 1e-2."""
    nodes, weights = quad_nodes(cfg)
    dev = lin.t_lnk.device
    t = lambda x: torch.as_tensor(x, dtype=F64, device=dev)
    R = 8.0
    kR = np.exp(nodes)
    k = kR / R
    T = transfer_at(c, lin, t(np.log(k)))
    F = 1.0 - _col(c.Omega_nu / c.Omega_m) + beta_quad_a1
    W = np.where(kR > 1e-2,
                 3.0 * (np.sin(kR) / kR ** 3 - np.cos(kR) / kR ** 2),
                 1.0 - 0.1 * kR * kR)
    integrand = t(W * W) * T * T * F * F * t(k) ** (_col(c.n_s) + 3.0) / \
        (2.0 * np.pi ** 2)
    return c.sigma_8 ** 2 / (integrand @ t(weights))


def sigma_v2_z0(cfg: SolverConfig, c: CosmoParams, lin: LinearData, norm,
                beta_quad_a1_full: torch.Tensor) -> torch.Tensor:
    """sigma_v^2(z=0) = int k P_lin(0,k) dlnk / (6 pi^2) [B] on the fixed
    Gauss-Legendre panels (quad_impl='gl'; reference :932-962), with
    P_lin(0,k) = Norm k^ns T^2 F^2 since D(0,k) == 1; beta_quad_a1_full
    [B, m] at k = e^nodes."""
    nodes, weights = quad_nodes(cfg)
    dev = lin.t_lnk.device
    t = lambda x: torch.as_tensor(x, dtype=F64, device=dev)
    k = t(np.exp(nodes))
    T = transfer_at(c, lin, t(nodes))
    F = 1.0 - _col(c.Omega_nu / c.Omega_m) + beta_quad_a1_full
    P = _col(norm) * k ** _col(c.n_s) * T * T * F * F
    return (k * P) @ t(weights) / (6.0 * np.pi ** 2)


def _beta_a1_traced(cfg: SolverConfig, c: CosmoParams, lin: LinearData,
                    k: torch.Tensor) -> torch.Tensor:
    """beta_P(a=1, k) at k [B, m] (the adaptive quadratures' points)."""
    f_nu = _col(c.Omega_nu / c.Omega_m)
    if _nz(lin) == 0:
        return torch.zeros_like(k)
    cols = _beta_reduce_k(lin, torch.clamp(k, cfg.beta_k_min,
                                           cfg.beta_k_max))
    raw = beta_raw_at_a(lin.beta_a, cols, torch.ones_like(k[:, 0]))
    return torch.where(f_nu < 1e-10, torch.zeros_like(raw), f_nu * raw)


def sigma8_normalization_qag(cfg: SolverConfig, c: CosmoParams,
                             lin: LinearData) -> torch.Tensor:
    """Norm = sigma_8^2 / integral via the GSL-replica GK61 quadrature
    (gsl_integration_qag key=6, epsabs 0, epsrel 1e-4 over ln kR in
    [-15, 15]; reference AU_cosmological_parameters.h:849-874)."""
    f_nu = _col(c.Omega_nu / c.Omega_m)
    ns = _col(c.n_s)
    R = 8.0

    def integrand(lnkR):
        kR = torch.exp(lnkR)
        k = kR / R
        T = transfer_at(c, lin, torch.log(k))
        F = 1.0 - f_nu + _beta_a1_traced(cfg, c, lin, k)
        W = torch.where(kR > 1e-2,
                        3.0 * (torch.sin(kR) / kR ** 3
                               - torch.cos(kR) / kR ** 2),
                        1.0 - 0.1 * kR * kR)
        return (W * W) * T * T * F * F * k ** (ns + 3.0) / \
            (2.0 * np.pi ** 2)

    integral, _ = qag_gk61(integrand, cfg.quad_lnk_lo, cfg.quad_lnk_hi,
                           lin.t_lnk.shape[0], lin.t_lnk.device,
                           0.0, 1e-4, cfg.qag_limit)
    return c.sigma_8 ** 2 / integral


def sigma_v2_z0_qag(cfg: SolverConfig, c: CosmoParams, lin: LinearData,
                    norm: torch.Tensor) -> torch.Tensor:
    """sigma_v^2(0) via the GSL-replica qag (reference :940-952)."""
    f_nu = _col(c.Omega_nu / c.Omega_m)
    ns = _col(c.n_s)
    nrm = _col(norm)

    def integrand(lnk):
        k = torch.exp(lnk)
        T = transfer_at(c, lin, lnk)
        F = 1.0 - f_nu + _beta_a1_traced(cfg, c, lin, k)
        return nrm * k ** (ns + 1.0) * T * T * F * F

    integral, _ = qag_gk61(integrand, cfg.quad_lnk_lo, cfg.quad_lnk_hi,
                           lin.t_lnk.shape[0], lin.t_lnk.device,
                           0.0, 1e-4, cfg.qag_limit)
    return integral / (6.0 * np.pi ** 2)


# ---------------------------------------------------------------------------
# model assembly and evaluation

def prepare_model(cfg: SolverConfig, c: CosmoParams, lin: LinearData,
                  norm_override=None) -> Model:
    """Build all per-cosmology tables for a batch, on the device that holds
    `c` and `lin` (state.linear_from_numpy puts inputs there).

    norm_override: [B] P_lin normalization constants to use instead of the
    sigma_8 integral (reference :849-875)."""
    grids = make_grids(cfg)
    dev = lin.t_lnk.device
    B = lin.t_lnk.shape[0]
    t = lambda x: torch.as_tensor(x, dtype=F64, device=dev)

    with span("model.growth"):
        lna_nodes, G, dDda = build_growth_tables(cfg, c, lin)
    W = t(growth_k_reduction(cfg))                 # [nk, n_lnk+1]
    G_red = G @ W.T                                # [B, n_lna+1, nk]
    dDda_red = dDda @ W.T
    # Dnorm: G interpolated at lna = 0 per k column (reference :715-718)
    i0, wx = interp.axis_weights(torch.as_tensor(lna_nodes),
                                 torch.tensor(0.0, dtype=F64))
    i0 = int(i0)
    Dnorm = torch.einsum("j,bjk->bk", wx.to(dev), G_red[:, i0:i0 + 4])
    # range guard (redtime_tpu/model.py:447-466): only ratios enter
    # growth_D_f, so a table whose common scale leaves [1e-25, 1e30]
    # (early-DE-dominated models, a_early=1e-50 ramps) is rescaled by
    # Dnorm; physical models keep s == 1 and stay bit-identical
    dmax = torch.amax(torch.abs(Dnorm), dim=1, keepdim=True)
    s = torch.where((dmax > 1e30) | (dmax < 1e-25), Dnorm,
                    torch.ones_like(Dnorm))
    G_red = G_red / s[:, None]
    dDda_red = dDda_red / s[:, None]
    Dnorm = Dnorm / s

    with span("model.beta_transfer"):
        kq = t(np.clip(grids.k, cfg.beta_k_min, cfg.beta_k_max))
        beta_solver = _beta_reduce_k(lin, kq)     # [B, nz, nk]
        T_solver = transfer_at(c, lin, t(grids.lnk))

    override = None if norm_override is None else lane_values(
        norm_override, B, dev).clone()
    if cfg.quad_impl == "qag":
        with span("model.sigma8"):
            norm = sigma8_normalization_qag(cfg, c, lin) if override is \
                None else override
        with span("model.sigma_v"):
            sv2 = sigma_v2_z0_qag(cfg, c, lin, norm)
    else:
        # beta_P(a=1, k) at the quadrature nodes, in the two k mappings
        k_q = np.exp(quad_nodes(cfg)[0])
        beta_s8 = _beta_a1_traced(cfg, c, lin, t(k_q / 8.0).expand(B, -1))
        beta_sv = _beta_a1_traced(cfg, c, lin, t(k_q).expand(B, -1))
        norm = sigma8_normalization(cfg, c, lin, beta_s8) if override is \
            None else override
        sv2 = sigma_v2_z0(cfg, c, lin, norm, beta_sv)

    return Model(cosmo=c, g_lna=t(lna_nodes).expand(B, -1).contiguous(),
                 g_G=G_red, g_dDda=dDda_red, g_Dnorm=Dnorm,
                 beta_a=lin.beta_a, beta_solver=beta_solver,
                 T_solver=T_solver, norm=norm, sigmaV2_z0=sv2)


def take_lanes(x, idx):
    """Lanes idx (an index tensor, a list or a slice) of a batched Model,
    its CosmoParams or a 1-loop cache (trg.OneLoopCache): any NamedTuple
    of [B, ...] tensors, nested.  Plain indexing, where the JAX package's
    packed scheduler contracts with one-hot matrices
    (redtime_tpu/trg.py:468-491); a gather of finite f64 values is the
    same bits."""
    if isinstance(x, torch.Tensor):
        return x[idx]
    return type(x)(*[take_lanes(f, idx) for f in x])


def put_lanes(dst, idx, src):
    """dst with its lanes idx (an index tensor) replaced by the lanes of
    src, in order: a new NamedTuple of the same structure as dst (the
    packed scheduler's reload, redtime_tpu/trg.py:493-518)."""
    if isinstance(dst, torch.Tensor):
        return dst.index_copy(0, idx, src)
    return type(dst)(*[put_lanes(d, idx, s) for d, s in zip(dst, src)])


def growth_D_f(model: Model, z):
    """D(z, k) and dD/da(z, k) on the solver grid, [B, nk] each
    (reference :727-730).  z: float or [B]."""
    B = model.batch
    return growth_at(model.g_lna, model.g_G, model.g_dDda, model.g_Dnorm,
                     lane_values(z, B, model.norm.device))


def growth_at(g_lna: torch.Tensor, g_G: torch.Tensor, g_dDda: torch.Tensor,
              g_Dnorm: torch.Tensor, z: torch.Tensor):
    """growth_D_f on a model's growth tables (g_lna [B, nn], g_G and
    g_dDda [B, nn, nk], g_Dnorm [B, nk]) at z [B]."""
    a = torch.reciprocal(1.0 + z)       # 1 / (1 + z), as torch divides so
    wx = interp.axis_weights_full(g_lna, torch.log(a))   # [B, nn]
    Gv = torch.einsum("bn,bnk->bk", wx, g_G)
    dDv = torch.einsum("bn,bnk->bk", wx, g_dDda)
    D = Gv * _col(a) / g_Dnorm
    dDda = dDv / g_Dnorm
    return D, dDda


def plin_all(cfg: SolverConfig, model: Model, z):
    """P_lin, P_lin_cb, P_lin_nu [B, nk] at redshift z (reference
    :834-930)."""
    k = torch.as_tensor(make_grids(cfg).k, dtype=F64,
                        device=model.norm.device)
    return plin_at(model, z, k)


def plin_at(model: Model, z, k: torch.Tensor):
    """plin_all on the solver grid k [nk] (a tensor on the model's
    device)."""
    c = model.cosmo
    B = model.batch
    z = lane_values(z, B, model.norm.device)
    a = 1.0 / (1.0 + z)
    D, _ = growth_D_f(model, z)
    beta = beta_P_solver(model, a)
    f_nu = _col(model.f_nu)
    F = 1.0 - f_nu + beta
    P = (_col(model.norm) * k ** _col(c.n_s) * model.T_solver ** 2
         * F * F * D * D)
    massless = f_nu <= 1e-10
    Pcb = torch.where(massless, P, P / (_col(model.f_cb) + beta) ** 2)
    R = beta / (f_nu * F + 1e-300)
    Pnu = torch.where(massless, torch.zeros_like(P), P * R * R)
    return P, Pcb, Pnu


def sigma_v2(model: Model, z, lnk_sv2_weights=None) -> torch.Tensor:
    """sigma_v^2(z) = D(z, k=1e-3)^2 sigma_v^2(0), [B] (reference
    :963-970; k = 1e-3 is the first solver column on the default grid,
    otherwise pass the static interpolation row over the solver lnk)."""
    D, _ = growth_D_f(model, z)
    Dv = D[:, 0] if lnk_sv2_weights is None else D @ lnk_sv2_weights
    return Dv * Dv * model.sigmaV2_z0


def comoving_distance_table(cfg: SolverConfig, c: CosmoParams,
                            a_in: float, n: int = 1000):
    """H0*chi(eta) table (reference H0chi_eta_init, :742-784): cumulative
    integral of dz/(H/H0) over a 1000-point log-z grid in [1e-4, 1e4],
    16-point Gauss-Legendre per panel in place of gsl qag (rel 1e-4).
    Returns (eta_nodes ascending [n], H0chi [B, n]).  The reference never
    calls it from main(); it is library surface."""
    dev = c.h.device
    zmin, zmax = 1e-4, 1e4
    dlnz = np.log(zmax / zmin) / (n - 1)
    z_nodes = zmin * np.exp(dlnz * np.arange(n))
    edges = np.concatenate([[0.0], z_nodes])
    x, w = np.polynomial.legendre.leggauss(16)
    lo, hi = edges[:-1, None], edges[1:, None]
    zq = 0.5 * (hi - lo) * x[None, :] + 0.5 * (hi + lo)   # [n, 16]
    wq = torch.as_tensor(0.5 * (hi - lo) * w[None, :], device=dev)
    a = torch.as_tensor(1.0 / (1.0 + zq), device=dev).expand(
        c.h.shape[0], n, 16)
    panels = torch.sum(wq * (1.0 / bg.H_H0(c, a)), dim=-1)   # [B, n]
    chi = torch.cumsum(panels, dim=-1)                    # H0chi(z_nodes)
    eta = np.log((1.0 / (1.0 + z_nodes)) / a_in)
    # ascending eta = descending z
    return (torch.as_tensor(eta[::-1].copy(), device=dev),
            torch.flip(chi, dims=[-1]))


def h0_chi(cfg: SolverConfig, c: CosmoParams, a_in: float, eta):
    """H0*chi at eta = ln(a/a_in), one eta (float or [B]) per lane
    (reference H0chi, :773-784): z itself below z = 1e-4, the table's
    interpolation otherwise.  Builds the 1000-node table per call; a
    caller looping over eta builds comoving_distance_table once."""
    eta_nodes, chi = comoving_distance_table(cfg, c, a_in)
    e = lane_values(eta, chi.shape[0], chi.device).contiguous()
    z = 1.0 / (a_in * torch.exp(e)) - 1.0
    val = interp.interp1(eta_nodes, chi, e)
    return torch.where(z <= 1e-4, z, val)
