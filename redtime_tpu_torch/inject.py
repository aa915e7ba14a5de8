"""Injected-linear-input reconstruction: validate without CAMB (the port
of redtime_tpu/inject.py; numpy arrays in and out).

A redTime output table printed with PRINTLIN (reference
`src/redTime.cc:1670-1741`) carries, per output redshift, the linear
columns

    k | D | f | P_lin_cb | beta_P(a)/beta_P(1) | dln beta_P/dln a | P_lin_nu

which together determine every linear-theory input the solver needs:

  * the cb transfer shape over the solver k-range — from
    P_lin_cb(z=0, k) = Norm * k^ns * T_cb(k)^2 (the reference's
    `Plin_cb`, `AU_cosmological_parameters.h:917-923`, with
    D(z=0, k) == 1 by normalization :727-730);
  * the exact normalization constant Norm (closed form at the first
    grid point once T is normalized to T(k_min) = 1);
  * the neutrino ratio beta_P(a, k) = f_nu * sqrt(P_lin_nu / P_lin_cb)
    (inverting :900-923, exactly the reconstruction the reference's own
    golden test applies, `tests/emulator_comparison/test_models.py:29-40`),
    densified in `a` by monotone ln-ln Hermite interpolation using the
    printed dln beta/dln a column, and extrapolated to earlier epochs as
    the power law frozen at the earliest output.

This unlocks the reference's 32-model emulator-comparison golden suite
(`tests/emulator_comparison/test_models.py`) in environments without a
CAMB binary: the early-epoch beta extrapolation error cancels at linear
order because the growth tables and the evolution's Omega matrix consume
the *same* injected beta — the evolved linear spectrum at any output a
where beta is exact equals P_lin_cb(0,k) * D(z,k)^2 regardless of the
early history.
"""

from __future__ import annotations

import numpy as np

from redtime_tpu_torch.config import SolverConfig
from redtime_tpu_torch.convert import read_redtime_table
from redtime_tpu_torch.io.camb import LinearData
from redtime_tpu_torch.io.params import ParamsFile, read_params_file

# printed column indices with PRINTLIN on (reference :1670-1741)
COL_K, COL_D, COL_F, COL_PCB, COL_BRAT, COL_DLNB, COL_PNU = range(7)


def read_output_blocks(path: str, nk: int = 128) -> np.ndarray:
    """Parse a redTime output table -> [n_eta, nk, ncol] (data rows only;
    '#' headers stripped, consistent with the downstream parsers the
    reference relies on, `src/convert_pt.c:126`).  One parser for the
    format: delegates to convert.read_redtime_table."""
    return read_redtime_table(path, nk)


def _hermite_lnln(a_nodes: np.ndarray, lnb: np.ndarray, slope: np.ndarray,
                  a_query: np.ndarray) -> np.ndarray:
    """Cubic Hermite interpolation of ln beta over ln a, vectorized over the
    trailing k axis; power-law (frozen first-node slope) below the first
    node.  lnb/slope: [n_nodes, nk]; returns [n_query, nk]."""
    x = np.log(a_nodes)
    xq = np.log(a_query)
    out = np.empty((len(xq), lnb.shape[1]))
    for j, q in enumerate(xq):
        if q <= x[0]:
            out[j] = lnb[0] + slope[0] * (q - x[0])
        elif q >= x[-1]:
            out[j] = lnb[-1] + slope[-1] * (q - x[-1])
        else:
            i = np.searchsorted(x, q) - 1
            h = x[i + 1] - x[i]
            t = (q - x[i]) / h
            h00 = (1 + 2 * t) * (1 - t) ** 2
            h10 = t * (1 - t) ** 2
            h01 = t * t * (3 - 2 * t)
            h11 = t * t * (t - 1)
            out[j] = (h00 * lnb[i] + h10 * h * slope[i]
                      + h01 * lnb[i + 1] + h11 * h * slope[i + 1])
    return out


def reconstruct_linear(cfg: SolverConfig, p: ParamsFile,
                       blocks: np.ndarray) -> tuple[LinearData, float]:
    """(LinearData, norm_override) from a PRINTLIN output table.

    blocks: [n_eta, nk, ncol] from `read_output_blocks`, output redshifts
    ordered greatest-first (the params-file convention), last block z=0.
    """
    if blocks.shape[0] != len(p.z_out):
        raise ValueError(
            f"output table has {blocks.shape[0]} redshift blocks but the "
            f"params file lists {len(p.z_out)} outputs — mismatched "
            "params/output pair (the beta densification would pair blocks "
            "with the wrong scale factors)")
    if not p.print_lin or blocks.shape[2] < 10:
        raise ValueError(
            "injected-linear reconstruction needs a PRINTLIN table (the "
            "linear columns D/f/P_lin_cb/B/dlnB/P_lin_nu must be present; "
            f"switch_print_linear={p.print_lin}, "
            f"ncol={blocks.shape[2]})")
    if abs(p.z_out[-1]) > 1e-12:
        raise ValueError("injected-linear reconstruction needs a z=0 block "
                         f"(last output z is {p.z_out[-1]})")
    k = blocks[-1, :, COL_K]
    Pcb0 = blocks[-1, :, COL_PCB]
    T = np.sqrt(Pcb0 / k ** p.n_s)
    # prepare_model re-normalizes T to T(k_min)=1 (reference :804-816);
    # the matching normalization constant is then exactly T(k_min)^2
    norm = float(Pcb0[0] / k[0] ** p.n_s)

    f_nu = p.Omega_nu / p.Omega_m
    if f_nu < 1e-10:
        return (LinearData(np.log(k), T, T, np.zeros(0), np.zeros(0),
                           np.zeros((0, 0))), norm)

    a_blocks = 1.0 / (1.0 + np.asarray(p.z_out, dtype=np.float64))
    beta = f_nu * np.sqrt(blocks[:, :, COL_PNU] / blocks[:, :, COL_PCB])
    dlnB = blocks[:, :, COL_DLNB]

    # densify on the production a-grid (the 33-redshift nu-interp list the
    # stored params carry) so the table's interpolation/extrapolation zones
    # match the reference's
    z_dense = np.asarray(p.z_interp, dtype=np.float64)
    a_dense = 1.0 / (1.0 + z_dense)
    if np.any(np.diff(a_dense) <= 0):
        raise ValueError("nu-interp redshifts must be strictly decreasing")
    lnb_dense = _hermite_lnln(a_blocks, np.log(beta), dlnB, a_dense)
    beta_raw = np.exp(lnb_dense) / f_nu          # delta_nu / delta_c

    lin = LinearData(np.log(k), T, T, a_dense, k, beta_raw)
    return lin, norm


def load_injected(cfg: SolverConfig, params_path: str, output_path: str):
    """One-call loader: (ParamsFile, LinearData, norm_override), the
    LinearData of one cosmology (numpy arrays) and its P_lin normalization,
    as driver.run_pipeline(norm_override=...) takes them (stack them for
    driver.run_batch)."""
    p = read_params_file(params_path)
    blocks = read_output_blocks(output_path, cfg.nk)
    lin, norm = reconstruct_linear(cfg, p, blocks)
    return p, lin, norm
