"""The comparison that decides `correct`: the program's outputs for the
sampled cosmologies against the plain reference's (reference.py).

  * table: the widest gap of a printed column, max over k of |program -
    reference| over the column's scale (max over k of |reference|), per
    cosmology, redshift and column; a column that the reference prints
    as 0 must read 0;
  * headers: the widest relative gap of sigma_v^2 and H at each output
    redshift and of sigmaV2(z=0).

The prepared Model's tables are held through what they print (the
linear columns, sigmaV2(z=0)): a number of their own had no upper
reading, since the control prepares in float64 (PERF.md).

A NaN or inf where the reference has a finite value reads inf.  Each
number is held to the cell's limit in rtbench/limits/<cell>.json.
"""

from __future__ import annotations

import numpy as np


def _gap(got: np.ndarray, ref: np.ndarray, axes) -> float:
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        return float("inf")
    scale = np.max(np.abs(ref), axis=axes, keepdims=True)
    diff = np.abs(got - ref)
    diff = np.where(np.isfinite(diff), diff, np.inf)
    diff = np.where(np.isnan(ref) & np.isnan(got), 0.0, diff)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(scale > 0, diff / np.where(scale > 0, scale, 1.0),
                       np.where(diff > 0, np.inf, 0.0))
    return float(np.max(rel)) if rel.size else 0.0


def gaps(got: dict, ref: dict) -> dict:
    """The compared numbers, by name, for the sampled cosmologies: got and
    ref hold "table" [n, n_z, nk, ncol], "sigma_v2" and "H" [n, n_z] and
    "sigmaV2_z0" [n]."""
    return {"table": _gap(got["table"], ref["table"], (2,)),
            "headers": max(
                _gap(got[name][..., None], ref[name][..., None], (-1,))
                for name in ("sigma_v2", "H", "sigmaV2_z0"))}


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: [value, limit]}): every number at or under its
    limit; a number with no limit fails."""
    checks = {k: [v, limits.get(k)] for k, v in values.items()}
    ok = all(lim is not None and v <= lim for v, lim in checks.values())
    return ok, checks
