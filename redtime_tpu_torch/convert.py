"""Emulator post-processing: the `convertPt` equivalent (the port's copy
of redtime_tpu/convert.py, numpy only).

Extracts per-HACC-step k / P files from redTime-format output tables for
emulator construction (reference `src/convert_pt.c`): HACC step numbers map
to redshift-block indices, k is rescaled by h (1/Mpc units), P by 1/h^3
(Mpc^3), and P_dd gets the f_cb^2 total-matter correction (convert_pt.c:
54-56, 145-146, 158-160).

`convert_pk_full` generalizes the legacy `convertPkFull` merger
(src/convert_pk.c): the reference build is a one-off with hardcoded
absolute paths and per-model column quirks; here the file locations are
templates and the step->redshift maps are arguments, with the same math
(f_cb^2 on PT, natural-cubic D(k)^2 growth correction on PM/HACC, h-unit
rescalings, err = P/sqrt(counts)).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

# HACC analysis step -> redshift-block index in a 33-z redTime output
# (reference convert_pt.c:145-146)
STEP_TO_ZBLOCK = {163: 9, 189: 11, 247: 14, 300: 18,
                  347: 24, 401: 28, 453: 31, 499: 32}


def read_models_file(path: str) -> List[Dict[str, float]]:
    """Design file: name om_m om_b s8 h ns w0 wa om_nu per line, 5 header
    lines skipped (reference convert_pt.c:80-91; little omegas = Om*h^2)."""
    models = []
    with open(path) as f:
        lines = f.readlines()[5:]
    for line in lines:
        parts = line.split()
        if len(parts) < 9:
            continue
        name, om, omb, s8, h, ns, w0, wa, omnu = parts[:9]
        models.append(dict(name=name, om_m=float(om), om_b=float(omb),
                           sigma_8=float(s8), h=float(h), n_s=float(ns),
                           w0=float(w0), wa=float(wa), om_nu=float(omnu)))
    return models


def read_redtime_table(path: str, nk: int = 128) -> np.ndarray:
    """Parse a redTime-format output file -> [n_z, nk, ncol]."""
    rows = []
    for line in open(path):
        if line.startswith("#") or not line.strip():
            continue
        rows.append([float(x) for x in line.split()])
    arr = np.asarray(rows)
    if arr.shape[0] % nk != 0:
        raise ValueError(f"{path}: {arr.shape[0]} rows not divisible by "
                         f"nk={nk}")
    return arr.reshape(-1, nk, arr.shape[1])


def convert_pt_one(table: np.ndarray, h: float, f_cb: float,
                   step_no: int) -> Tuple[np.ndarray, np.ndarray]:
    """One model's (k, pk) arrays for a HACC step (reference
    process_PT_runs + main loop)."""
    iz = STEP_TO_ZBLOCK[step_no]
    k = table[0, :, 0] * h                      # k in 1/Mpc
    P = table[iz, :, 7] / h ** 3                # P_dd in Mpc^3
    return k, P * f_cb * f_cb


def convert_pt(n_models: int, step_no: int, nk_pt: int, params_file: str,
               red_dir: str, suffix: str = "no_interp_test") -> None:
    """CLI-equivalent batch conversion (reference convert_pt.c main):
    writes {red_dir}/STEP{step}/[k|pk]_M###_{suffix}.dat."""
    models = read_models_file(params_file)
    outdir = os.path.join(red_dir, f"STEP{step_no}")
    os.makedirs(outdir, exist_ok=True)
    for mn in range(1, n_models + 1):
        m = models[mn - 1]
        f_cb = (m["om_m"] - m["om_nu"]) / m["om_m"]
        table = read_redtime_table(
            os.path.join(red_dir, f"redTime_M{mn:03d}.dat"), nk_pt)
        k, pk = convert_pt_one(table, m["h"], f_cb, step_no)
        # reference writes "%lf " sequences on one line (convert_pt.c:53-58)
        with open(os.path.join(outdir,
                               f"k_M{mn:03d}_{suffix}.dat"), "w") as f:
            f.write("".join(f"{x:f} " for x in k))
        with open(os.path.join(outdir,
                               f"pk_M{mn:03d}_{suffix}.dat"), "w") as f:
            f.write("".join(f"{x:f} " for x in pk))


# ---------------------------------------------------------------------------
# convertPkFull: PT + PM + HACC merger (reference src/convert_pk.c),
# generalized — the reference hardcodes /Users/jkwan/... paths and
# per-model column/redshift quirks; here paths are templates and the maps
# are arguments.

def mt_emulator_kgrid(nk: int = 3000, kmin: float = 1e-3,
                      kmax: float = 5.0) -> np.ndarray:
    """The Mira-Titan emulator k spacing (reference convert_pk.c:27-43):
    50 log-spaced points on [kmin, 0.04), 150 linear on [0.04, 0.2],
    log-spaced to kmax beyond.  nk=3000 (production) or 351 (emulator)."""
    nk1, nk2 = 50, 200
    if nk <= nk2:
        raise ValueError(
            f"mt_emulator_kgrid needs nk > {nk2} (fixed 50-log + 150-linear "
            f"segments, reference convert_pk.c:31-43); got {nk}")
    k = np.empty(nk)
    k[:nk1] = 10 ** (np.log10(kmin)
                     + np.arange(nk1) * (np.log10(0.04) - np.log10(kmin))
                     / nk1)
    k[nk1:nk2] = 0.04 + np.arange(nk2 - nk1) * (0.200 - 0.04) / (nk2 - nk1 - 1)
    k[nk2:] = 10 ** (np.log10(0.201)
                     + np.arange(nk - nk2) * (np.log10(kmax)
                                              - np.log10(0.201))
                     / (nk - nk2 - 1))
    return k


def read_pk_file(path: str, h: float,
                 counts_col: int | None = None) -> np.ndarray:
    """An N-body P(k) file (PM or HACC runs): '#'-header + columns
    (k, P, [junk,] counts).  Returns [n, 3] = (k*h, P/h^3, err) with
    err = P / sqrt(counts).  Counts default to the LAST column, matching
    the reference's PM reader exactly (3-column files put counts at
    index 2, 4-column files at index 3 with junk at 2 —
    convert_pk.c:336-346).  The HACC counts column varies per model in
    the legacy data (convert_pk.c:241-244 comment: any[2]/any[3]/any[4]
    depending on the model); pass counts_col explicitly there."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            rows.append([float(x) for x in line.split()])
    a = np.asarray(rows)
    k = a[:, 0] * h
    P = a[:, 1] / h ** 3
    cc = a.shape[1] - 1 if counts_col is None else counts_col
    err = P / np.sqrt(a[:, cc])
    return np.column_stack([k, P, err])


def process_pt_full(path: str, h: float, step_no: int, nk_pt: int = 128,
                    step_to_z: Dict[int, int] | None = None):
    """redTime output -> (k*h, P_dd/h^3, D, P_nu/h^3) at the step's
    z-block (reference process_PT_runs, convert_pk.c:405-470; the
    reference's step->z-index map varies per design generation, so it is
    an argument; default = STEP_TO_ZBLOCK for 33-z production outputs)."""
    table = read_redtime_table(path, nk_pt)
    iz = (step_to_z or STEP_TO_ZBLOCK)[step_no]
    k = table[iz, :, 0] * h
    D = table[iz, :, 1]
    Pnu = table[iz, :, 6] / h ** 3
    P = table[iz, :, 7] / h ** 3
    return k, P, D, Pnu


def _natural_cubic(x: np.ndarray, y: np.ndarray):
    """Natural cubic spline evaluator (== gsl_interp_cspline,
    convert_pk.c:80-85)."""
    from scipy.interpolate import CubicSpline
    return CubicSpline(x, y, bc_type="natural")


def _interp_to_grid(kq: np.ndarray, k: np.ndarray, y: np.ndarray
                    ) -> np.ndarray:
    """Natural-cubic interpolation of (k, y) onto the shared grid kq with
    zeros outside the data range — the reference's (commented-out)
    emulator-grid path, convert_pk.c:258-271: gsl cspline in linear k,
    `Pk[kk] = 0` for kq outside (k[0], k[n-1])."""
    out = np.zeros_like(kq)
    sel = (kq > k[0]) & (kq < k[-1])
    out[sel] = _natural_cubic(k, y)(kq[sel])
    return out


def convert_pk_full(design_file: str, step_no: int, out_dir: str,
                    pt_template: str, pm_template: str, hacc_template: str,
                    models: List[int] | None = None,
                    nk_pt: int = 128, n_pm: int = 16,
                    step_to_z: Dict[int, int] | None = None,
                    suffix: str = "no_interp_test",
                    hacc_counts_col: int | None = 2,
                    interp_grid: np.ndarray | None = None) -> None:
    """Merge PT + PM + HACC spectra into per-model k/pk/err tables
    (reference convert_pk.c main, :13-130).

    Per model: PT P_dd gets the f_cb^2 total-matter correction; each PM
    realization and the HACC spectrum get the PT growth-factor correction
    D(k)^2 interpolated by natural cubic spline (D == 1 beyond the PT
    range).  Output rows: one k-grid index; columns: PT, n_pm PM
    realizations, HACC — written as k_/pk_/err_ files, the layout the
    Mira-Titan pipeline consumed.

    Templates receive (model=model number, step=step number, pm=PM run
    number), e.g. 'runs/M{model:03d}/PM{pm:03d}/m{model:03d}.pk.{step}'.

    interp_grid: when given (e.g. mt_emulator_kgrid()), every spectrum is
    natural-cubic-splined onto this ONE shared k grid (zeros outside each
    source's k range) instead of the shipped ragged no-interp layout —
    the emulator-grid path the reference sets up at convert_pk.c:31-43
    and carries as commented-out spline blocks (:258-271).  The k_ file
    then holds a single column.
    """
    design = read_models_file(design_file)
    models = models if models is not None else list(range(1,
                                                          len(design) + 1))
    os.makedirs(out_dir, exist_ok=True)
    for mn in models:
        m = design[mn - 1]
        h = m["h"]
        f_cb = (m["om_m"] - m["om_nu"]) / m["om_m"]

        k_pt, P_pt, D, _ = process_pt_full(
            pt_template.format(model=mn, step=step_no), h, step_no, nk_pt,
            step_to_z)
        spl = _natural_cubic(k_pt, D)

        def growth_corr(kq):
            out = np.ones_like(kq)
            sel = kq < k_pt[-1]
            out[sel] = spl(kq[sel])
            return out * out

        pms = [read_pk_file(pm_template.format(model=mn, step=step_no,
                                               pm=pm), h)
               for pm in range(n_pm)]
        # HACC counts: the reference reads column 2 literally but its
        # own comment records the true column varying per model
        # (convert_pk.c:241-244); col 2 is the literal-parity default
        hacc = read_pk_file(hacc_template.format(model=mn, step=step_no),
                            h, counts_col=hacc_counts_col)

        if interp_grid is not None:
            kq = np.asarray(interp_grid, dtype=float)
            # Reference order of operations (the commented emulator-grid
            # path, convert_pk.c:258-271 + main loop): spline the RAW
            # P/err onto the shared grid first, then apply the growth
            # correction evaluated AT the grid k — not the other way
            # around (the two differ at second order where D(k) curves).
            gq = growth_corr(kq)
            pk_cols = [_interp_to_grid(kq, k_pt, P_pt * f_cb * f_cb)]
            err_cols = []
            for p in pms:
                pk_cols.append(_interp_to_grid(kq, p[:, 0], p[:, 1]) * gq)
                err_cols.append(_interp_to_grid(kq, p[:, 0], p[:, 2]) * gq)
            pk_cols.append(_interp_to_grid(kq, hacc[:, 0], hacc[:, 1]) * gq)
            err_cols.append(_interp_to_grid(kq, hacc[:, 0], hacc[:, 2]) * gq)
            for tag, cols in (("k", [kq]), ("pk", pk_cols),
                              ("err", err_cols)):
                path = os.path.join(out_dir,
                                    f"{tag}_M{mn:03d}_{suffix}.dat")
                np.savetxt(path, np.column_stack(cols), fmt="%f")
            continue

        n_rows = max([len(k_pt), len(hacc)] + [len(p) for p in pms])

        def pad(a, n):
            return np.pad(a, (0, n - len(a)))

        k_cols = [pad(k_pt, n_rows)]
        pk_cols = [pad(P_pt * f_cb * f_cb, n_rows)]
        err_cols = []
        for p in pms:
            g = growth_corr(p[:, 0])
            k_cols.append(pad(p[:, 0], n_rows))
            pk_cols.append(pad(p[:, 1] * g, n_rows))
            err_cols.append(pad(p[:, 2] * g, n_rows))
        g = growth_corr(hacc[:, 0])
        k_cols.append(pad(hacc[:, 0], n_rows))
        pk_cols.append(pad(hacc[:, 1] * g, n_rows))
        err_cols.append(pad(hacc[:, 2] * g, n_rows))

        for tag, cols in (("k", k_cols), ("pk", pk_cols),
                          ("err", err_cols)):
            path = os.path.join(out_dir,
                                f"{tag}_M{mn:03d}_{suffix}.dat")
            np.savetxt(path, np.column_stack(cols), fmt="%f")


def tns_ab(block: np.ndarray, mu) -> Tuple[np.ndarray, np.ndarray]:
    """Combine a 17-column output block into A(k, mu) and B(k, mu).

    The solver prints the TNS (Taruya, Nishimichi & Saito 2010) RSD
    corrections as mu-power components: columns 11-13 (1-based) are the
    mu^{2,4,6} components of A and columns 14-17 the mu^{2,4,6,8}
    components of B (reference `README.md:104-113`).  This performs the
    downstream combination the reference leaves to its users:

        A(k, mu) = mu^2 A_2 + mu^4 A_4 + mu^6 A_6
        B(k, mu) = mu^2 B_2 + mu^4 B_4 + mu^6 B_6 + mu^8 B_8

    block: [nk, 17] (one redshift block); mu: scalar or [n_mu].
    Returns (A [n_mu, nk], B [n_mu, nk]) — squeezed to [nk] for a
    scalar mu.
    """
    block = np.asarray(block, np.float64)
    if block.ndim != 2 or block.shape[1] != 17:
        raise ValueError(f"expected a [nk, 17] block, got {block.shape}")
    mu_arr = np.atleast_1d(np.asarray(mu, np.float64))
    m2 = (mu_arr * mu_arr)[:, None]              # [n_mu, 1]
    A = m2 * block[:, 10] + m2 ** 2 * block[:, 11] + m2 ** 3 * block[:, 12]
    B = (m2 * block[:, 13] + m2 ** 2 * block[:, 14]
         + m2 ** 3 * block[:, 15] + m2 ** 4 * block[:, 16])
    if np.ndim(mu) == 0:
        return A[0], B[0]
    return A, B
