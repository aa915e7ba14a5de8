"""Typed configuration for the PyTorch solver.

The physics and numerics fields of `redtime_tpu.config`, with the same
names and defaults, so one configuration reads the same in both packages:

  * `SolverConfig` — static numerical configuration: grid sizes, windows,
    tolerances, print switches.  Frozen and hashable, so per-config host
    constants can be cached on it.
  * `CosmoParams`  — the 9 cosmological parameters as f64 tensors; a batch
    of cosmologies is one `CosmoParams` whose fields have a leading batch
    dimension.
  * `RunSettings`  — per-run evolution settings (mode switches, z_in,
    output redshifts).

The JAX package's TPU knobs (the DFT-matmul and split-DIT backends, the
matmul-form assembly, the Ozaki budget) have no counterpart here: the
port computes in native f64 with the GEMM form of the engine.  The leg
switches and dtypes are kept so a shared configuration reads alike, and
an 'ozaki' leg or a float32 dtype raises.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

# Physical constants (reference AU_cosmological_parameters.h:64-66)
C_RHO_GAM = 4.46911743913795e-07  # Omega_gamma * h^2 / T_cmb[K]^4
C_NU_HOT = 0.681321952980717      # 3*(7/8)*(4/11)^(4/3)
H0H = 0.00033356754857714242474   # H0 / (h/Mpc)   (reference redTime.cc:69)

F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static numerical configuration.

    Defaults reproduce the reference's default (non-HIGH_ACCURACY) build:
    reference `src/redTime.cc:90-145`.  Field meanings and sources are
    documented on `redtime_tpu.config.SolverConfig`.
    """

    # --- k grid (reference redTime.cc:90-110) ---
    nk: int = 128
    np_factor: int = 4           # extended FFT grid: np = np_factor * nk
    kmin: float = 1e-3           # h/Mpc
    kmax: float = 1.0            # h/Mpc

    # window taper zones, in units of nk/16 (reference redTime.cc:102-103)
    s_padL: int = 23
    s_tapL: int = 9
    s_extL: int = 24
    s_extR: int = 24
    s_tapR: int = 9

    # --- FAST-PT (reference redTime.cc:71-72, 599-600) ---
    nu_bias: float = -2.0
    z_taylor_eps: float = 1e-2
    z_taylor_terms: int = 10

    # --- eta integration (reference redTime.cc:140-145, 1593) ---
    eabs_P: float = 1e-7
    erel_P: float = 1e-2
    eta_tableau: str = "rkf45"   # 'rkf45' | 'dopri5' | 'dop853'

    # --- 1-loop evaluation redshift (reference redTime.cc:1285) ---
    z1l: float = 10.0

    # --- growth tables (reference AU_cosmological_parameters.h:644-697) ---
    growth_n_lna: int = 100
    growth_n_lnk: int = 50
    growth_a_min: float = 1e-3
    growth_a_max: float = 1.1
    growth_k_min: float = 1.5e-4
    growth_k_max: float = 9.0
    a_early: float = 1e-20
    growth_rtol: float = 1e-6
    growth_h_reset: bool = False
    growth_dense: bool = False
    growth_ramp_tableau: str = "dop853"

    # --- beta_P clamping (reference AU_cosmological_parameters.h:536-537) ---
    beta_k_min: float = 1e-3
    beta_k_max: float = 1.0

    # --- sigma_8 / sigma_v^2 quadrature (reference :849-874) ---
    quad_lnk_lo: float = -15.0
    quad_lnk_hi: float = 15.0
    quad_panels: int = 256
    quad_order: int = 16
    quad_impl: str = "qag"
    qag_limit: int = 1000

    # --- output print switches (reference redTime.cc:64-65) ---
    print_a: bool = False
    print_i: bool = False
    print_q: bool = False
    print_bias: bool = False
    fill_pt_full_trg: bool = False

    # --- engine legs: the port runs every leg as a native-f64 GEMM form
    # ('auto' or 'dot'); the TPU's int8 'ozaki' legs raise ---
    out_leg: str = "auto"
    tab_leg: str = "auto"
    fwd_leg: str = "auto"
    pz_leg: str = "auto"
    engine_transform_dtype: str = "float64"
    dtype: str = "float64"

    def __post_init__(self):
        for leg in ("out_leg", "tab_leg", "fwd_leg", "pz_leg"):
            value = getattr(self, leg)
            if value == "ozaki":
                raise ValueError(
                    f"{leg}='ozaki': the int8 Ozaki legs emulate f64 on the "
                    "TPU's MXU; the port computes in native f64")
            if value not in ("auto", "dot"):
                raise ValueError(f"unknown {leg} {value!r}")
        if self.quad_impl not in ("qag", "gl"):
            raise ValueError(f"unknown quad_impl {self.quad_impl!r}")
        if self.growth_ramp_tableau not in ("dop853", "dopri5"):
            raise ValueError(
                f"unknown growth_ramp_tableau {self.growth_ramp_tableau!r}")
        if self.dtype != "float64":
            raise ValueError(f"dtype={self.dtype!r}: the PyTorch port runs "
                             "in float64 only")
        if self.engine_transform_dtype != "float64":
            raise ValueError(
                f"engine_transform_dtype={self.engine_transform_dtype!r}: "
                "the PyTorch port runs the engine in float64 only")
        if self.eta_tableau not in ("rkf45", "dopri5", "dop853"):
            raise ValueError(f"unknown eta_tableau {self.eta_tableau!r}")

    @classmethod
    def high_accuracy(cls, **overrides) -> "SolverConfig":
        """The reference's HIGH_ACCURACY build (redTime.cc:90-94, 141-142)."""
        kw = dict(nk=512, eabs_P=1e-15, erel_P=1e-6)
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def v01_compat(cls, **overrides) -> "SolverConfig":
        """redTime v0.1-compatible settings (reference README.md:123-155)."""
        kw = dict(nk=256, np_factor=8, eabs_P=1e-15, erel_P=1e-6,
                  beta_k_min=1e-5, beta_k_max=20.0,
                  growth_n_lnk=1000, a_early=1e-50,
                  growth_h_reset=True)
        kw.update(overrides)
        return cls(**kw)

    @property
    def npts(self) -> int:
        return self.np_factor * self.nk

    @property
    def nshift(self) -> int:
        return (self.npts - self.nk) // 2


class CosmoParams(NamedTuple):
    """The 9 cosmological input parameters (reference params_redTime.dat
    schema, `AU_cosmological_parameters.h:325-333`), each an f64 tensor:
    a scalar for one cosmology, [B] for a batch."""

    n_s: torch.Tensor
    sigma_8: torch.Tensor
    h: torch.Tensor
    Omega_m: torch.Tensor
    Omega_b: torch.Tensor
    Omega_nu: torch.Tensor
    T_cmb: torch.Tensor
    w0: torch.Tensor
    wa: torch.Tensor

    @classmethod
    def make(cls, n_s, sigma_8, h, Omega_m, Omega_b, Omega_nu,
             T_cmb=2.726, w0=-1.0, wa=0.0, device="cpu") -> "CosmoParams":
        return cls(*[torch.as_tensor(np.asarray(v, dtype=np.float64),
                                     dtype=F64, device=device)
                     for v in (n_s, sigma_8, h, Omega_m, Omega_b, Omega_nu,
                               T_cmb, w0, wa)])


@dataclasses.dataclass(frozen=True)
class RunSettings:
    """Per-run evolution settings (the four integer switches of
    params_redTime.dat, reference `AU_cosmological_parameters.h:336-339`,
    plus the z_initial / output-redshift entries)."""

    nonlinear: bool = True       # SWITCH_NONLINEAR
    one_loop: bool = True        # SWITCH_1LOOP
    print_lin: bool = True       # PRINTLIN
    print_rsd: bool = True       # PRINTRSD
    z_in: float = 200.0
    z_out: Sequence[float] = (5.0, 4.0, 3.0, 2.0, 1.0, 0.5, 0.0)

    @property
    def a_in(self) -> float:
        return 1.0 / (1.0 + self.z_in)

    def etasteps(self) -> np.ndarray:
        """eta = ln(a/a_in) of each output redshift."""
        a = 1.0 / (1.0 + np.asarray(self.z_out, dtype=np.float64))
        return np.log(a / self.a_in)
