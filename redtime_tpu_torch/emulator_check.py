"""Emulator-comparison harness: the reference CI's accuracy criteria (the
port's copy of redtime_tpu/emulator_check.py, numpy only).

Ports the comparison logic of `tests/emulator_comparison/test_models.py` so
a CAMB-equipped environment can run the full 32-model validation against
stored high-accuracy outputs or Mira-Titan emulator arrays.  No CAMB
dependency here — it compares any two redTime-format outputs.

Recipes (reference test_models.py):
  * dimensionless spectrum: Delta^2-like = P/h^3/(2 pi^2) * k^1.5
    (:22-26); pure ratios on a shared k grid cancel these factors;
  * massive-nu total-matter correction (:29-40):
      trans_p = sqrt(P_lin_nu / P_lin_cb)        (cols 6, 3)
      beta_p  = trans_p * (om_nu / om_m)
      f       = 1 - om_nu/om_m + beta_p
      P_mm    = P_dd * f^2                        (col 7)
  * criteria: massless max|ratio-1| < 1e-3 for k < 0.1 (:86-89);
    massive max < 5e-3 and 95th pct < 1e-3 (:156-159).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from redtime_tpu_torch.convert import read_redtime_table


class ComparisonResult(NamedTuple):
    k: np.ndarray              # selected k (code units)
    ratio: np.ndarray          # P/P_target - 1
    max_abs: float
    q95: float


def corrected_nonlinear_power(table: np.ndarray, om_nu: float = 0.0,
                              om_m: float = 1.0, iz: int = -1):
    """(k, P) of the z-block `iz`, with the massive-nu total-matter
    correction applied when om_nu > 0 (reference get_neutrino_nlin)."""
    blk = table[iz]
    k, P = blk[:, 0], blk[:, 7].copy()
    if om_nu > 0:
        trans_p = np.sqrt(blk[:, 6] / blk[:, 3])
        beta_p = trans_p * (om_nu / om_m)
        f = 1.0 - om_nu / om_m + beta_p
        P = P * f * f
    return k, P


def compare_outputs(ours: str, target: str, nk: int = 128,
                    k_max: float = 0.1, om_nu: float = 0.0,
                    om_m: float = 1.0) -> ComparisonResult:
    """z=0 P_dd comparison between two redTime-format outputs (identical
    k grids required, as the reference test asserts)."""
    ka, Pa = corrected_nonlinear_power(read_redtime_table(ours, nk),
                                       om_nu, om_m)
    kb, Pb = corrected_nonlinear_power(read_redtime_table(target, nk),
                                       om_nu, om_m)
    if not np.allclose(ka, kb, rtol=1e-12):
        raise ValueError("k grids differ between outputs")
    sel = ka < k_max
    ratio = Pa[sel] / Pb[sel] - 1.0
    return ComparisonResult(ka[sel], ratio, float(np.max(np.abs(ratio))),
                            float(np.quantile(np.abs(ratio), 0.95)))


def assert_reference_criteria(res: ComparisonResult,
                              massive: bool = False) -> None:
    """The reference CI thresholds (test_models.py:86-89, 156-159).

    Raises AssertionError explicitly — bare `assert` statements are
    stripped under `python -O`, silently disabling the validation."""
    if massive:
        if not res.max_abs < 5e-3:
            raise AssertionError(
                f"massive-nu max |dP/P| = {res.max_abs} >= 5e-3")
        if not res.q95 < 1e-3:
            raise AssertionError(
                f"massive-nu q95 |dP/P| = {res.q95} >= 1e-3")
    elif not res.max_abs < 1e-3:
        raise AssertionError(
            f"massless-nu max |dP/P| = {res.max_abs} >= 1e-3")


# ---------------------------------------------------------------------------
# CosmicEmu (Mira-Titan emulator) cross-check — the second half of the
# reference golden suite (tests/emulator_comparison/test_models.py:5-10,
# 53-89: emulator arrays yFull/logk/params_ce, z=0 block, low-k points).

class CosmicEmu(NamedTuple):
    logP: np.ndarray      # [351, n_models] log10 dimensionless P at z=0
    logk: np.ndarray      # [351] log10 k (physical 1/Mpc)
    params: np.ndarray    # [9, n_models] (om_m, om_b, s8, h, ns, w0, wa,
    #                        om_nu, z?) — columns per test_models.py usage


def load_cosmicemu(emu_dir: str) -> CosmicEmu:
    """Load the bundled Mira-Titan emulator arrays (test_models.py:6-10).
    yFull holds log10 of the dimensionless spectrum for every output z
    stacked along rows; the final 351 rows are z=0."""
    yfull = np.loadtxt(f"{emu_dir}/yFull.txt")
    logk = np.loadtxt(f"{emu_dir}/logk.txt")
    params = np.loadtxt(f"{emu_dir}/params_ce.txt")
    return CosmicEmu(yfull[-351:, :], logk, params)


def dimensionless_power(k_phys: np.ndarray, P_code: np.ndarray,
                        h: float) -> np.ndarray:
    """The emulator's Delta^2-like convention (test_models.py:22-26):
    P [code units, (Mpc/h)^3] / h^3 / (2 pi^2) * k_phys^1.5."""
    return P_code / h ** 3 / (2.0 * np.pi ** 2) * k_phys ** 1.5


def emulator_rel_err(k_code: np.ndarray, P_corrected: np.ndarray, h: float,
                     emu: CosmicEmu, model_index: int,
                     n_low: int = 40) -> np.ndarray:
    """|P/P_emu - 1| at the emulator's first ``n_low`` k points (z=0),
    following the reference recipe exactly (test_models.py:56-73):
    log-log interpolation of the dimensionless spectrum from the code's
    k grid (converted to physical 1/Mpc) onto logk[:n_low].

    ``P_corrected`` is the z=0 P_dd column with the massive-nu f^2
    total-matter correction already applied where relevant."""
    k_phys = np.asarray(k_code) * h
    nlin = dimensionless_power(k_phys, np.asarray(P_corrected), h)
    nlin_int = 10.0 ** np.interp(emu.logk[:n_low], np.log10(k_phys),
                                 np.log10(nlin))
    emu_P = 10.0 ** emu.logP[:n_low, model_index]
    return np.abs(nlin_int / emu_P - 1.0)
