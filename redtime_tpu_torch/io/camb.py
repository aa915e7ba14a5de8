"""CAMB transfer-function inputs.

Standard CAMB format: 7 columns (k [h/Mpc], delta_c/k^2, delta_b/k^2, ...,
delta_nu/k^2 at column 5), or 13 columns for modern pip CAMB (reference
`AU_cosmological_parameters.h:76-80`).

`LinearData` holds the cosmology-independent raw arrays:
  * the z=0 transfer columns used to build T_cb (combined with the
    cosmology's baryon fraction, reference :804-816);
  * the beta_P neutrino-ratio stack delta_nu/delta_c over (a, k) (combined
    with f_nu, reference :513-630).
The fields are numpy arrays (one cosmology, or stacked with a leading
batch dimension); `state.linear_from_numpy` puts them on a device.

The files are read by the native parser (`native.parse_table`, and
`native.parse_stack` for the beta_P stack), with the JAX package's native
semantics: '#' comments and lines with no number are skipped, columns
past 7 (13) ignored, a shorter numeric row rejected.
`read_transfer_file_plain` is the numpy version the tests hold it to.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Sequence

import numpy as np

from redtime_tpu_torch.io import native
from redtime_tpu_torch.io.params import ParamsFile

# column indices (reference AU_cosmological_parameters.h:76-80)
I_K, I_DC, I_DB, I_DNU = 0, 1, 2, 5
MAX_BETA_ROWS = 30000  # reference :548


def _ncols(modern: bool) -> int:
    return 13 if modern else 7


def _checked(path, data: np.ndarray, ncols: int) -> np.ndarray:
    if data.shape[0] == 0:
        raise ValueError(f"{path}: no parseable {ncols}-column rows "
                         "(corrupt or wrong-format transfer file)")
    return data


def read_transfer_file(path: str, modern: bool = False) -> np.ndarray:
    """Read a CAMB transfer file -> array [n_rows, n_cols] (float64)."""
    ncols = _ncols(modern)
    return _checked(path, native.parse_table(path, ncols), ncols)


def read_transfer_file_plain(path: str, modern: bool = False) -> np.ndarray:
    """read_transfer_file by np.loadtxt: the plain version of the native
    parser on well-formed files (no text-only lines, a fixed column
    count)."""
    ncols = _ncols(modern)
    data = np.loadtxt(path, ndmin=2)
    if data.shape[0] == 0 or data.shape[1] < ncols:
        raise ValueError(f"{path}: no parseable {ncols}-column rows "
                         "(corrupt or wrong-format transfer file)")
    return np.ascontiguousarray(data[:, :ncols])


class LinearData(NamedTuple):
    """Raw linear-theory inputs (numpy arrays or f64 tensors)."""

    t_lnk: np.ndarray      # [nT]  ln k of the z=0 transfer file
    t_Tc: np.ndarray       # [nT]  delta_c column
    t_Tb: np.ndarray       # [nT]  delta_b column
    beta_a: np.ndarray     # [nz]  scale factors of the transfer stack
    beta_k: np.ndarray     # [nkb] k nodes of the stack
    beta_raw: np.ndarray   # [nz, nkb]  delta_nu/delta_c


def load_linear_data(transfer_file: str,
                     nu_files: Sequence[str],
                     nu_redshifts: Sequence[float],
                     modern: bool = False) -> LinearData:
    """Load the z=0 transfer file and the beta_P transfer stack
    (greatest redshift first; empty sequences for massless neutrinos)."""
    t = read_transfer_file(transfer_file, modern)
    t_lnk = np.log(t[:, I_K])
    t_Tc, t_Tb = t[:, I_DC].copy(), t[:, I_DB].copy()

    if len(nu_files) == 0:
        return LinearData(t_lnk, t_Tc, t_Tb, np.zeros((0,)), np.zeros((0,)),
                          np.zeros((0, 0)))
    if len(nu_files) < 4:
        raise ValueError(
            f"beta_P transfer stack needs >= 4 redshift nodes for cubic "
            f"interpolation in a; got {len(nu_files)} files.  Pass an empty "
            f"stack for massless-neutrino runs instead.")
    ncols = _ncols(modern)
    tables = [_checked(path, d, ncols) for path, d in
              zip(nu_files, native.parse_stack(list(nu_files), ncols))]
    first = tables[0][:MAX_BETA_ROWS]
    beta_k = first[:, I_K].copy()
    nkb = len(beta_k)
    beta_raw = np.empty((len(nu_files), nkb))
    beta_raw[0] = first[:, I_DNU] / first[:, I_DC]
    for i, path in enumerate(nu_files[1:], start=1):
        d = tables[i][:nkb]
        if d.shape[0] != nkb:
            raise ValueError(
                f"{path}: {d.shape[0]} rows, expected {nkb} "
                "(corrupt transfer file or mismatched stack)")
        fdiff = 2.0 * np.abs(beta_k - d[:, I_K]) / (
            np.abs(beta_k) + np.abs(d[:, I_K]))
        if np.any(fdiff > 1e-5):
            raise ValueError(f"{path}: k grid differs from {nu_files[0]} "
                             "(reference aborts here too, :605-610)")
        beta_raw[i] = d[:, I_DNU] / d[:, I_DC]
    beta_a = 1.0 / (1.0 + np.asarray(nu_redshifts, dtype=np.float64))
    return LinearData(t_lnk, t_Tc, t_Tb, beta_a, beta_k, beta_raw)


def load_from_params(p: ParamsFile, base_dir: str = "",
                     modern: bool = False) -> LinearData:
    transfer = os.path.join(base_dir, p.transfer_file)
    if p.Omega_nu / p.Omega_m < 1e-10:
        return load_linear_data(transfer, [], [], modern)
    if len(p.z_interp_str) == 0:
        raise ValueError(
            f"Omega_nu={p.Omega_nu} is massive but the params file lists "
            "no neutrino interpolation redshifts — the beta_P(a, k) table "
            "cannot be built (provide the transfer stack, or set "
            "Omega_nu=0 for a massless run)")
    return load_linear_data(transfer, p.nu_transfer_files(base_dir),
                            p.z_interp, modern)
