"""k-grid, extended FFT-log grid, and the smoothstep windows.

Reproduces the grid/window geometry of the reference (`src/redTime.cc:
79-138`): an nk-point log-spaced solver grid on [kmin, kmax] extended by
np_factor with zero-pad / taper / extrapolation zones, the power-spectrum
window WP(lnk) and the Fourier-coefficient window WC(m).

Everything here is static grid geometry, computed once in numpy at setup;
the port builds its device constants from these arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rtbench.rtref.config import SolverConfig


def w_edge(x):
    """Smoothstep window: x - sin(2 pi x)/(2 pi)  (reference redTime.cc:113)."""
    return x - np.sin(2.0 * np.pi * np.asarray(x)) / (2.0 * np.pi)


@dataclasses.dataclass(frozen=True)
class Grids:
    """Static grid geometry (all numpy arrays)."""

    nk: int
    npts: int
    nshift: int
    dlnk: float
    lnk: np.ndarray        # [nk]   solver grid ln k
    k: np.ndarray          # [nk]
    lnk_ext: np.ndarray    # [npts] extended grid ln k
    k_ext: np.ndarray      # [npts]
    wp: np.ndarray         # [npts] power-spectrum window on extended grid
    wc: np.ndarray         # [npts//2+1] coefficient window vs rfft frequency


def make_grids(cfg: SolverConfig) -> Grids:
    nk, npts, nshift = cfg.nk, cfg.npts, cfg.nshift
    lnkmin, lnkmax = np.log(cfg.kmin), np.log(cfg.kmax)
    dlnk = (lnkmax - lnkmin) / (nk - 1)
    lnk = lnkmin + dlnk * np.arange(nk)
    lnk_pad_min = lnkmin - dlnk * nshift
    lnk_ext = lnk_pad_min + dlnk * np.arange(npts)

    # --- WP: power-spectrum window, evaluated by extended-grid index.
    # Region boundaries in grid-index units (integer division matches the
    # reference's integer expressions nk*s/16, reference redTime.cc:105-110).
    i_lo = nk * cfg.s_padL // 16
    i_li = i_lo + nk * cfg.s_tapL // 16
    i_ri = i_li + (nk * (16 + cfg.s_extL + cfg.s_extR) // 16 - 1)
    i_ro = i_ri + nk * cfg.s_tapR // 16
    i = np.arange(npts, dtype=np.float64)
    wp = np.where(
        i <= i_lo, 0.0,
        np.where(i < i_li, w_edge((i - i_lo) / (i_li - i_lo)),
                 np.where(i < i_ri, 1.0,
                          np.where(i < i_ro,
                                   w_edge((i_ro - i) / (i_ro - i_ri)), 0.0))))

    # --- WC: Fourier-coefficient window vs rfft frequency m in [0, npts/2].
    # The reference applies WC(n) over the GSL halfcomplex index n
    # (redTime.cc:130-138); that is symmetric in frequency, so on the rfft
    # layout it reduces to a function of m alone.
    nl, nc, dn = npts // 8, npts // 2, 3 * npts // 8
    m = np.arange(npts // 2 + 1, dtype=np.float64)
    wc = np.where(m <= nl, 1.0, w_edge((nc - m) / dn))

    return Grids(nk=nk, npts=npts, nshift=nshift, dlnk=float(dlnk),
                 lnk=lnk, k=np.exp(lnk), lnk_ext=lnk_ext,
                 k_ext=np.exp(lnk_ext), wp=wp, wc=wc)


def pab_extension_matrix(grids: Grids):
    """Static linear map extending ln P from the solver grid to the padded
    grid.

    The reference's `Pab` (redTime.cc:181-232) interpolates ln P on the
    solver lnk grid with 4-point Lagrange cubic in the interior, linear on
    the edge intervals (extrapolating linearly to the left), and
    right-extrapolates with slope (n_s - 3) beyond the last node.  Because
    both source nodes and extended-grid targets are static, this is an
    affine map:  lnP_ext = M @ lnP + (n_s - 3) * v.

    Returns (M [npts, nk], v [npts]).
    """
    nk, npts, nshift = grids.nk, grids.npts, grids.nshift
    lnk, lnk_ext = grids.lnk, grids.lnk_ext
    M = np.zeros((npts, nk))
    v = np.zeros(npts)

    for ii in range(npts):
        x = lnk_ext[ii]
        # findN (AU_interp.h:68-78): first n with lnk[n+1] >= x, capped.
        n = int(np.searchsorted(lnk, x, side="left")) - 1
        n = min(max(n, 0), nk - 1)
        if n >= nk - 1 or x > lnk[nk - 1]:
            # right extrapolation with slope n_s - 3 (redTime.cc:213-216)
            M[ii, nk - 1] = 1.0
            v[ii] = x - lnk[nk - 1]
        elif n == 0 or n == nk - 2:
            # linear on [n, n+1] (left branch extrapolates; redTime.cc:211,220)
            t = (x - lnk[n]) / (lnk[n + 1] - lnk[n])
            M[ii, n] = 1.0 - t
            M[ii, n + 1] = t
        else:
            # 4-point Lagrange cubic on nodes [n-1 .. n+2] (redTime.cc:208)
            xs = lnk[n - 1:n + 3]
            for j in range(4):
                w = 1.0
                for l in range(4):
                    if l != j:
                        w *= (x - xs[l]) / (xs[j] - xs[l])
                M[ii, n - 1 + j] = w
    return M, v


def pab_band(M: np.ndarray):
    """The band of the extension matrix M [npts, nk] (pab_extension_matrix):
    (j0 [npts] int32, w [npts, 4]) with M[m, j0[m] + t] = w[m, t] and every
    other entry of row m zero.  Each row holds at most 4 non-zeros on
    consecutive columns (the Lagrange cubic's 4, the linear intervals' 2,
    the right extrapolation's 1); j0 is clamped to nk - 4 so that the 4
    columns stay inside the grid.  Needs nk >= 4."""
    npts, nk = M.shape
    if nk < 4:
        raise ValueError(f"pab_band: nk must be at least 4, got {nk}")
    j0 = np.empty(npts, dtype=np.int32)
    w = np.zeros((npts, 4))
    for m in range(npts):
        nz = np.flatnonzero(M[m])
        j0[m] = min(nz[0], nk - 4) if len(nz) else 0
        if len(nz) and nz[-1] >= j0[m] + 4:
            raise ValueError(f"pab_band: row {m} spans more than 4 columns")
        w[m] = M[m, j0[m]:j0[m] + 4]
    return j0, w
