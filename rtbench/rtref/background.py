"""Background expansion history: w(a), E(a), Y(a), H^2/H0^2, dlnH/dlna.

Functions of (CosmoParams, a) on tensors; semantics follow the reference
`AU_cosmological_parameters.h:394-500` (CPL dark energy, photon radiation
from T_cmb, massive neutrinos with an abrupt hot->cold transition at a_nu).

Batching: the cosmology fields are [B] (or scalars) and `a` is [B] or
[B, ...]; each field is viewed with trailing unit dimensions so it
broadcasts against `a` lane by lane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rtbench.rtref.config import C_NU_HOT, C_RHO_GAM, CosmoParams


def _b(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """View a per-lane parameter [B] so it broadcasts against a [B, ...]."""
    return v.reshape(v.shape + (1,) * (a.dim() - v.dim()))


class DerivedParams(NamedTuple):
    """Derived density parameters (reference :342-349)."""

    Omega_gam: torch.Tensor
    f_nu: torch.Tensor
    f_cb: torch.Tensor
    Omega_nu_hot: torch.Tensor
    a_nu: torch.Tensor
    Omega_r: torch.Tensor
    Omega_L: torch.Tensor


def derived(c: CosmoParams) -> DerivedParams:
    Og = C_RHO_GAM * c.T_cmb ** 4 / (c.h * c.h)
    f_nu = c.Omega_nu / c.Omega_m
    f_cb = 1.0 - f_nu
    On_hot = C_NU_HOT * Og
    a_nu = C_NU_HOT * Og / (f_nu * c.Omega_m + 1e-15)
    Or = Og + On_hot * (a_nu > 1.0)
    OL = 1.0 - c.Omega_m - Or
    return DerivedParams(Og, f_nu, f_cb, On_hot, a_nu, Or, OL)


def w_de(c: CosmoParams, a):
    """CPL dark-energy equation of state (reference :395)."""
    return _b(c.w0, a) + _b(c.wa, a) * (1.0 - a)


def E_de(c: CosmoParams, a):
    """rho_DE(a)/rho_DE(1) (reference :406-413)."""
    w0, wa = _b(c.w0, a), _b(c.wa, a)
    return a ** (-3.0 * (1.0 + w0 + wa)) * torch.exp(-3.0 * wa * (1.0 - a))


def dE_da(c: CosmoParams, a):
    w0, wa = _b(c.w0, a), _b(c.wa, a)
    return 3.0 * E_de(c, a) * (wa - (1.0 + w0 + wa) / a)


def Y_nu(c: CosmoParams, a, d: DerivedParams | None = None):
    """rho_nu(a)/rho_cb(a) (reference :428-445)."""
    d = derived(c) if d is None else d
    cold = _b(d.f_nu / d.f_cb, a)
    hot = _b(C_NU_HOT * d.Omega_gam, a) / (_b(d.f_cb * c.Omega_m, a) * a)
    return torch.where(a >= _b(d.a_nu, a), cold.expand_as(hot), hot)


def dY_da(c: CosmoParams, a, d: DerivedParams | None = None):
    d = derived(c) if d is None else d
    hot = _b(-C_NU_HOT * d.Omega_gam, a) / (
        _b(d.f_cb * c.Omega_m, a) * a * a)
    return torch.where(a >= _b(d.a_nu, a), torch.zeros_like(hot), hot)


def H2_H02(c: CosmoParams, a, d: DerivedParams | None = None):
    """(H/H0)^2 (reference :461-468)."""
    d = derived(c) if d is None else d
    return (_b(d.f_cb * c.Omega_m, a) * (1.0 + Y_nu(c, a, d)) / a ** 3
            + _b(d.Omega_L, a) * E_de(c, a) + _b(d.Omega_gam, a) / a ** 4)


def H_H0(c: CosmoParams, a, d: DerivedParams | None = None):
    return torch.sqrt(H2_H02(c, a, d))


def dlnH_dlna(c: CosmoParams, a, d: DerivedParams | None = None):
    """(reference :480-485)."""
    d = derived(c) if d is None else d
    return 0.5 * a / H2_H02(c, a, d) * (
        _b(d.f_cb * c.Omega_m, a)
        * (-3.0 * (1.0 + Y_nu(c, a, d)) + a * dY_da(c, a, d)) / a ** 4
        + _b(d.Omega_L, a) * dE_da(c, a)
        - 4.0 * _b(d.Omega_gam, a) / a ** 5)


class OmegaConsts(NamedTuple):
    """The per-lane constants [B] of omega_scalars (the cosmology's), each
    computed as H2_H02 and dlnH_dlna compute it."""

    f_cb: torch.Tensor
    fcb_om: torch.Tensor    # f_cb Omega_m
    OL: torch.Tensor        # Omega_L
    Og: torch.Tensor        # Omega_gam
    og4: torch.Tensor       # 4 Omega_gam
    a_nu: torch.Tensor
    y_cold: torch.Tensor    # Y_nu's f_nu / f_cb
    y_hot: torch.Tensor     # Y_nu's C_NU_HOT Omega_gam
    dy_hot: torch.Tensor    # dY_da's -C_NU_HOT Omega_gam
    wa: torch.Tensor
    w1: torch.Tensor        # 1 + w0 + wa
    e_pow: torch.Tensor     # E_de's -3 (1 + w0 + wa)
    e_wa: torch.Tensor      # E_de's -3 wa


def omega_consts(c: CosmoParams,
                 d: DerivedParams | None = None) -> OmegaConsts:
    d = derived(c) if d is None else d
    return OmegaConsts(
        d.f_cb, d.f_cb * c.Omega_m, d.Omega_L, d.Omega_gam,
        4.0 * d.Omega_gam, d.a_nu, d.f_nu / d.f_cb, C_NU_HOT * d.Omega_gam,
        -C_NU_HOT * d.Omega_gam, c.wa, 1.0 + c.w0 + c.wa,
        -3.0 * (1.0 + c.w0 + c.wa), -3.0 * c.wa)


def omega_scalars(a, k: OmegaConsts):
    """(a^3 H^2/H0^2, 3 + dlnH/dlna) at per-lane a [B], the RHS's Omega
    scalars: the operations of H2_H02 and dlnH_dlna in their order, with
    the cosmology's constants (omega_consts) and the values the two share
    (a^3, a^4, E_de, 1 + Y_nu, a >= a_nu, H^2/H0^2) computed once, so the
    bits are theirs in fewer operations."""
    a3, a4 = a ** 3, a ** 4
    E = a ** k.e_pow * torch.exp(k.e_wa * (1.0 - a))
    cold = a >= k.a_nu
    Y1 = 1.0 + torch.where(cold, k.y_cold, k.y_hot / (k.fcb_om * a))
    H2 = k.fcb_om * Y1 / a3 + k.OL * E + k.Og / a4
    dE = 3.0 * E * (k.wa - k.w1 / a)
    dY_hot = k.dy_hot / (k.fcb_om * a * a)
    dY = torch.where(cold, torch.zeros_like(dY_hot), dY_hot)
    dlnH = 0.5 * a / H2 * (k.fcb_om * (-3.0 * Y1 + a * dY) / a4
                           + k.OL * dE - k.og4 / a ** 5)
    return a3 * H2, 3.0 + dlnH


def Omega_m_a(c: CosmoParams, a, d: DerivedParams | None = None):
    """Time-dependent Omega_m(a) (reference :497-500)."""
    return _b(c.Omega_m, a) / (a ** 3 * H2_H02(c, a, d))


# --- range-bounded forms for deep-radiation-era evaluation -----------------
# H2_H02 contains Og/a^4, which is huge near a_early = 1e-20 (where the
# growth ODE starts); these factorizations stay in [Og, ~1] on a in
# (0, 1.1] and are the ones the growth ODE uses (same physics as
# :461-485, the same formulas as the JAX package).

def a4H2_H02(c: CosmoParams, a, d: DerivedParams | None = None):
    """s(a) = a^4 (H/H0)^2, bounded on (0, 1.1]."""
    d = derived(c) if d is None else d
    Ya = torch.where(a >= _b(d.a_nu, a), _b(d.f_nu / d.f_cb, a) * a,
                     _b(C_NU_HOT * d.Omega_gam / (d.f_cb * c.Omega_m), a)
                     .expand_as(a))
    cb = _b(d.f_cb * c.Omega_m, a) * (a + Ya)
    w0, wa = _b(c.w0, a), _b(c.wa, a)
    de = _b(d.Omega_L, a) * torch.exp((1.0 - 3.0 * (w0 + wa)) * torch.log(a)
                                      - 3.0 * wa * (1.0 - a))
    return cb + de + _b(d.Omega_gam, a)


def dlnH_dlna_bounded(c: CosmoParams, a, d: DerivedParams | None = None):
    """dlnH/dlna = (dln s/dlna - 4)/2 with s = a^4 H^2/H0^2; equals
    dlnH_dlna (:480-485) but evaluates safely down to a_early."""
    d = derived(c) if d is None else d
    s = a4H2_H02(c, a, d)
    dYa = torch.where(a >= _b(d.a_nu, a), _b(d.f_nu / d.f_cb, a) * a,
                      torch.zeros_like(a))
    dcb = _b(d.f_cb * c.Omega_m, a) * (a + dYa)
    w0, wa = _b(c.w0, a), _b(c.wa, a)
    de = _b(d.Omega_L, a) * torch.exp((1.0 - 3.0 * (w0 + wa)) * torch.log(a)
                                      - 3.0 * wa * (1.0 - a))
    dde = de * (1.0 - 3.0 * (w0 + wa) + 3.0 * wa * a)
    return 0.5 * ((dcb + dde) / s - 4.0)
