"""FAST-PT mode-coupling engine (McEwen, Fang, Hirata, Blazek 1603.04826),
in the windowed GEMM form.

Computes the J_{alpha,beta,ell} FFT-log transforms and the regularized
Z-kernel convolutions PZ_n that feed the Time-RG A/R/PT/PMR assemblies,
restricted to what the assembly reads (the solver window plus the PMR
low-k point).  Semantics follow the reference engine (`src/redTime.cc:
300-811`) and the JAX package's `compute_J_PZ_windowed` in its matmul
form (redtime_tpu/fastpt.py:1155-1307):

  * front (hand kernel K9): the Pab extension of ln P, its clip, exp and
    window (P_ext), then the forward leg (P_ext k^-nu) @ dft_fwd_half (on
    the card from pab_M's 4-wide band and a real FFT in shared memory);
  * tab leg (hand kernel K10): the per-family gamma coefficients ga/gb
    (complex products on split re/im halves) and both convolution
    backward transforms in one product, sab @ dft_bwd_half (on the card a
    pruned real-output FFT in shared memory);
  * output leg (hand kernel K1): J_f = (tab_a tab_b / 2np) @ G_f with the
    f64 composite matrix G_f = [FC|-FS] . diag(fh_f) . [Bc;Bs] . prek_f
    (the f/tau phase, the restricted even-sample backward DFT and prek
    folded into one [2np, nk+1] matrix per family);
  * PZ leg (hand kernel K2): the Toeplitz contraction with its outer
    factor.

The host constants are the JAX package's numpy formulas, bit for bit.
Every tensor carries a leading batch dimension B.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from scipy.special import loggamma

from rtbench.rtref import fourier
from rtbench.rtref.config import SolverConfig
from rtbench.rtref.grids import (make_grids, pab_band,
                                    pab_extension_matrix)
from rtbench.rtref.kernels.engine_front import (
    engine_front as engine_front_kernel, forward_plain)
from rtbench.rtref.kernels.out_leg import out_leg, padded
from rtbench.rtref.kernels.pz_leg import pz_leg
from rtbench.rtref.kernels.tab_leg import tab_leg

F64 = torch.float64

# transform-family tables (reference redTime.cc:731-738)
ELL_N = (0, 0, 1, 2, 2, 3, 4)
ALPHA_N = (0, 2, 1, 0, 2, 1, 0)
ELLN0_N = (0, 2, 4, 0, 2, 4, 6)
ALPHAN0_N = (0, 0, 0, 2, 2, 2, 2)
Z_N = (0, 1, -1, 3, -3, 5, -5)
NFAM_J = 7      # families 0..6: J_{alpha,-alpha,ell}; family 1 regularized
NFAM = 14       # families 7..13: Jn0_{alpha,2,ell} (RSD path)


# ---------------------------------------------------------------------------
# gamma-function coefficients (host, numpy/scipy)

def _g_raw(mu: float, re_kappa: float, im_kappa: float):
    """|g| and arg(g) of Gamma((mu+kappa+1)/2) / Gamma((mu-kappa+1)/2)
    (reference g_MFHB, redTime.cc:306-319).  Phases only enter through
    cos/sin, so branch conventions don't matter."""
    top = loggamma(complex(0.5 * (mu + re_kappa + 1.0), 0.5 * im_kappa))
    bot = loggamma(complex(0.5 * (mu - re_kappa + 1.0), -0.5 * im_kappa))
    return float(np.exp(top.real - bot.real)), float(top.imag - bot.imag)


def _f_raw(re_rho: float, im_rho: float):
    """f_MFHB (reference redTime.cc:321-328)."""
    g0, g1 = _g_raw(0.5, re_rho - 0.5, im_rho)
    pre = 0.5 * np.sqrt(np.pi) * 2.0 ** re_rho
    return pre * g0, im_rho * np.log(2.0) + g1


class FastPTCoeffs(NamedTuple):
    """Static per-config coefficient pack (numpy)."""

    ga_re: np.ndarray     # [14, np/2]
    ga_im: np.ndarray
    gb_re: np.ndarray
    gb_im: np.ndarray
    fh_re: np.ndarray     # [14, np+1]
    fh_im: np.ndarray
    prek: np.ndarray      # [14, np]
    kbias: np.ndarray     # [np]  k^{-nu} on the extended grid
    toeplitz: np.ndarray  # [7, np, np]  Z-kernel convolution matrices
    pz_kfac: np.ndarray   # [np]  dlnk/(2 pi^2) * k^3


def _z_reg(n: int, r: float, eps: float, terms: int) -> float:
    """Regularized Z kernels Z_n(r), n in {0,+-1,+-3,+-5} with the Taylor
    switches of the reference (redTime.cc:599-687)."""
    if n < 0:
        return _z_reg(-n, 1.0 / r, eps, terms)
    if n == 0:
        return 1.0
    lnkq = np.log(abs((1.0 + r) / (1.0 - r))) if r != 1.0 else 0.0
    Z = 0.0
    if n == 1:
        if r < eps:
            for m in range(terms):
                Z += 2.0 * r ** (2 * m + 1) * (1.0 - r) / (2 * m + 1)
        elif r > 1.0 / eps:
            for m in range(terms):
                Z += 2.0 * r ** (-2 * m - 1) * (1.0 - r) / (2 * m + 1)
        elif r == 1.0:
            Z = 0.0
        else:
            Z = (1.0 - r) * lnkq
    elif n == 3:
        if r < eps:
            Z = r * r
            for m in range(terms):
                Z += (1.0 - r ** 3) * r ** (2 * m + 1) / (2 * m + 1)
        elif r > 1.0 / eps:
            for m in range(terms):
                Z += r ** (-2 * m) * ((2 * m + 3) / r - 2 * m - 1) / \
                    ((2 * m + 1) * (2 * m + 3))
        elif r == 1.0:
            Z = 1.0
        else:
            Z = r ** 2 + 0.5 * (1.0 - r ** 3) * lnkq
    elif n == 5:
        if r < eps:
            Z = r ** 4 + r ** 2 / 3.0
            for m in range(terms):
                Z += (1.0 - r ** 5) * r ** (2 * m + 1) / (2 * m + 1)
        elif r > 1.0 / eps:
            for m in range(terms):
                Z += r ** (-2 * m) * ((2 * m + 5) / r - 2 * m - 1) / \
                    ((2 * m + 1) * (2 * m + 5))
        elif r == 1.0:
            Z = 4.0 / 3.0
        else:
            Z = r ** 4 + r ** 2 / 3.0 + 0.5 * (1.0 - r ** 5) * lnkq
    else:  # n in {2, 4} defined by the reference but unused by Z_N
        raise ValueError(f"Z kernel n={n} not required")
    return Z


@functools.lru_cache(maxsize=4)
def fastpt_coeffs(cfg: SolverConfig) -> FastPTCoeffs:
    g = make_grids(cfg)
    npts, dlnk, nu = g.npts, g.dlnk, cfg.nu_bias
    nu_int = int(round(nu))
    half = npts // 2
    ln2 = np.log(2.0)

    def tau(idx: int) -> float:
        return 2.0 * np.pi * idx / (dlnk * npts)

    def g_dispatch(ell: int, alpha: int, m: int):
        """g_MFHB frontend (reference redTime.cc:344-355)."""
        if m == 0 and alpha == ell - nu_int:
            return 0.0, 0.0
        if alpha == -2 and ell == 0:
            return _f_raw(nu, tau(m))      # g_reg (reference :338-342)
        return _g_raw(0.5 + ell, 1.5 + nu + alpha, tau(m))

    ga = np.zeros((NFAM, half), dtype=np.complex128)
    gb = np.zeros((NFAM, half), dtype=np.complex128)
    fh = np.zeros((NFAM, npts + 1), dtype=np.complex128)
    prek = np.zeros((NFAM, npts))

    for fam in range(NFAM):
        if fam < NFAM_J:
            ell, alpha = ELL_N[fam], ALPHA_N[fam]
            beta = -alpha
        else:
            n = fam - NFAM_J
            ell, alpha, beta = ELLN0_N[n], ALPHAN0_N[n], 2
        reg = (ell == 0 and alpha == 2 and beta == -2)
        sl = 1.0 if ell % 2 == 0 else -1.0
        expo = 3.0 + 2.0 * nu + alpha + beta

        if not reg:
            for m in range(half):
                g0a, g1a = g_dispatch(ell, alpha, m)
                g0b, g1b = g_dispatch(ell, beta, m)
                if m == 0:
                    # DC quirk: cga[0] = ca[0]*|g| (phase dropped,
                    # reference redTime.cc:547)
                    ga[fam, 0] = g0a
                    gb[fam, 0] = g0b
                else:
                    ga[fam, m] = g0a * np.exp(1j * g1a)
                    gb[fam, m] = g0b * np.exp(1j * g1b)
            for h in range(npts + 1):
                f0, f1 = _f_raw(-4.0 - 2.0 * nu - (alpha + beta), -tau(h))
                ph = f1 + ln2 * tau(h)
                if h == 0:
                    fh[fam, h] = f0 * np.cos(f1)     # reference :568
                elif h == npts:
                    fh[fam, h] = f0 * np.cos(ph)     # Nyquist slot is real
                else:
                    fh[fam, h] = f0 * np.exp(1j * ph)
            prek[fam] = sl * (2.0 * g.k_ext) ** expo / \
                (2.0 * np.pi ** 2 * npts ** 2)
        else:
            # regularized J_{2,-2,0} (reference Jreg_MFHB, :411-511):
            # the 2^{1.5+nu+alpha} magnitude and ln2*tau phase sit on the
            # a-side coefficients; the b-side uses g_reg; no tau phase after
            # the convolution; Nyquist phase forced to zero.
            for m in range(half):
                if m > 0:
                    g0, g1 = _g_raw(0.5 + ell, 1.5 + nu + alpha, tau(m))
                    g0 *= 2.0 ** (1.5 + nu + alpha)
                    g1 += ln2 * tau(m)
                    ga[fam, m] = g0 * np.exp(1j * g1)
                # m == 0: g zeroed (alpha == ell - nu_int), stays 0
                g0b, g1b = _f_raw(nu, tau(m))
                if m == 0:
                    # keep the real part only (the ~1e-16 sin(pi) leak the
                    # C++ carries is below any tolerance here)
                    gb[fam, 0] = g0b * np.cos(g1b)
                else:
                    gb[fam, m] = g0b * np.exp(1j * g1b)
            for h in range(npts + 1):
                f0, f1 = _f_raw(-4.0 - 2.0 * nu - (alpha + beta), -tau(h))
                if h == 0:
                    fh[fam, h] = f0 * np.cos(f1)
                elif h == npts:
                    fh[fam, h] = f0        # reference :493-494 (ACf = 0)
                else:
                    fh[fam, h] = f0 * np.exp(1j * f1)
            prek[fam] = sl * np.sqrt(2.0 / np.pi) * g.k_ext ** expo / \
                (2.0 * np.pi ** 2 * npts ** 2)

    # Z-kernel Toeplitz matrices: T_n[i, m] = G_n[np + i - m] where
    # G_n[j] = Z_n(r_j) r_j^3, r_j = exp(-dlnk (j - np))  (reference
    # PZ_reg, :689-727; brute-force convolution :396-408 restricted to the
    # outputs actually read)
    Gn = np.zeros((NFAM_J, 2 * npts))
    for fi, n in enumerate(Z_N):
        for j in range(2 * npts):
            r = np.exp(-dlnk * (j - npts)) if j != npts else 1.0
            Gn[fi, j] = _z_reg(n, r, cfg.z_taylor_eps,
                               cfg.z_taylor_terms) * r ** 3
    i_idx = np.arange(npts)[:, None]
    m_idx = np.arange(npts)[None, :]
    toeplitz = Gn[:, npts + i_idx - m_idx]          # [7, np, np]

    return FastPTCoeffs(
        ga_re=ga.real, ga_im=ga.imag, gb_re=gb.real, gb_im=gb.imag,
        fh_re=fh.real, fh_im=fh.imag, prek=prek,
        kbias=np.exp(-nu * g.lnk_ext),
        toeplitz=toeplitz,
        pz_kfac=dlnk / (2.0 * np.pi ** 2) * g.k_ext ** 3)


@functools.lru_cache(maxsize=4)
def _pab_ext(cfg: SolverConfig):
    return pab_extension_matrix(make_grids(cfg))


def _out_columns(g) -> np.ndarray:
    """Extended-grid columns the assembly actually reads: the solver
    window [nshift, nshift+nk) plus the PMR low-k index (reference
    :1252)."""
    nlo = g.nshift - g.nk // 2
    return np.concatenate([np.arange(g.nshift, g.nshift + g.nk), [nlo]])


@functools.lru_cache(maxsize=8)
def _restricted_out_consts(cfg: SolverConfig):
    """Output-leg DFT matrices restricted to the _out_columns: the shared
    forward pair [FC | -FS] [2np, 2(np+1)] and the even-sample backward
    pair [Bc_o ; Bs_o] [2(np+1), nk+1] (numpy f64)."""
    g = make_grids(cfg)
    n2 = 2 * g.npts
    fc, fs, bc, bs = fourier._dft_matrices(n2)
    cols = _out_columns(g)
    fwd = np.concatenate([fc, -fs], axis=1)        # [2np, 2(np+1)]
    bwd = np.concatenate([bc[:, ::2][:, cols],
                          bs[:, ::2][:, cols]], axis=0)
    return fwd, bwd


@functools.lru_cache(maxsize=8)
def _half_leg_consts(cfg: SolverConfig):
    """Single-product matrices of the forward and convolution-backward
    legs (numpy f64): fwd [np, 2*half] = [fc.wc | -fs.wc] on the frequencies
    below half, bwd [2*half, 2np] = [bc[:half] ; bs[:half]] of the
    length-2np backward transform."""
    g = make_grids(cfg)
    half = g.npts // 2
    fc, fs, _, _ = fourier._dft_matrices(g.npts)
    wc = g.wc[:half]
    fwd = np.concatenate([fc[:, :half] * wc, -fs[:, :half] * wc], axis=1)
    _, _, bc2, bs2 = fourier._dft_matrices(2 * g.npts)
    bwd = np.concatenate([bc2[:half], bs2[:half]], axis=0)
    return fwd, bwd


@functools.lru_cache(maxsize=8)
def composite_out_matrix(cfg: SolverConfig) -> np.ndarray:
    """The f64 composite output matrix G [NFAM, 2np, nk+1].

    The windowed output leg (rfft of the convolution product -> per-family
    f/tau phase -> restricted backward DFT -> prek) is linear per family,
    J_f = prod_f @ G_f, with G built as at redtime_tpu/fastpt.py:403-418
    (where the TPU then sliced it to int8; here it stays f64)."""
    g = make_grids(cfg)
    co = fastpt_coeffs(cfg)
    npts = g.npts
    fwd, bwd = _restricted_out_consts(cfg)
    n2h = npts + 1
    FC, FSn = fwd[:, :n2h], fwd[:, n2h:]
    Bc, Bs = bwd[:n2h], bwd[n2h:]
    prek_out = np.asarray(co.prek)[:, _out_columns(g)]
    G = np.empty((NFAM, 2 * npts, g.nk + 1))
    for f in range(NFAM):
        fr, fi = np.asarray(co.fh_re[f]), np.asarray(co.fh_im[f])
        G[f] = (FC @ (fr[:, None] * Bc + fi[:, None] * Bs)
                + FSn @ (fr[:, None] * Bs - fi[:, None] * Bc))
        G[f] *= prek_out[f][None, :]
    return G


def engine_consts_np(cfg: SolverConfig) -> dict:
    """The engine's host constants (numpy f64), by EngineConsts field."""
    g = make_grids(cfg)
    co = fastpt_coeffs(cfg)
    M, v = _pab_ext(cfg)
    fwd, bwd = _half_leg_consts(cfg)
    j0, w = pab_band(M)
    return dict(
        pab_M=M, pab_v=v, wp=g.wp, kbias=co.kbias, dft_fwd_half=fwd,
        pab_j0=j0, pab_w=w, wc_half=g.wc[:g.npts // 2],
        twiddle=fourier.twiddles(2 * g.npts),
        ga_re=co.ga_re, ga_im=co.ga_im, gb_re=co.gb_re, gb_im=co.gb_im,
        dft_bwd_half=bwd, G=composite_out_matrix(cfg),
        toeplitz_sl=np.ascontiguousarray(
            co.toeplitz[:, g.nshift:g.nshift + g.nk, :]),
        pz_kfac_sl=co.pz_kfac[g.nshift:g.nshift + g.nk])


class EngineConsts(NamedTuple):
    """The engine's constants on one device: what the plain versions of
    the legs read (the dense matrices of the GEMM form) and what the hand
    kernels read instead (pab_M's band, the window wc, the twiddles); the
    JAX package's pack also carries its FFT/DFT-matmul and Ozaki
    variants."""

    pab_M: torch.Tensor         # [np, nk] Pab extension (used transposed)
    pab_v: torch.Tensor         # [np]
    wp: torch.Tensor            # [np] power-spectrum window
    kbias: torch.Tensor         # [np] k^-nu
    dft_fwd_half: torch.Tensor  # [np, 2*half] = [fc.wc | -fs.wc]
    pab_j0: torch.Tensor        # [np] int32: pab_M's band (pab_band),
    pab_w: torch.Tensor         # [np, 4]    M[m, j0[m] + t] = w[m, t]
    wc_half: torch.Tensor       # [half] coefficient window
    twiddle: torch.Tensor       # [2np, 2] (cos, sin)(2 pi j / 2np)
    ga_re: torch.Tensor         # [NFAM, half]
    ga_im: torch.Tensor
    gb_re: torch.Tensor
    gb_im: torch.Tensor
    dft_bwd_half: torch.Tensor  # [2*half, 2np] = [bc[:half]; bs[:half]]
    G: torch.Tensor             # [NFAM, 2np, nk+1] composite output matrix,
                                # rows padded to 8 ceil((nk+1)/8) (padded)
    toeplitz_sl: torch.Tensor   # [7, nk, np] Toeplitz rows in the window
    pz_kfac_sl: torch.Tensor    # [nk]


def device_of(device) -> torch.device:
    """`device` as a torch.device.  Raises when it names a CUDA card and
    none is present: the port never falls back to the CPU, which runs
    only when the caller asks for it (device="cpu")."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA card is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


@functools.lru_cache(maxsize=8)
def _engine_consts(cfg: SolverConfig, device: str) -> EngineConsts:
    arrs = engine_consts_np(cfg)
    ec = EngineConsts(**{
        k: torch.as_tensor(np.ascontiguousarray(v), device=device,
                           dtype=torch.int32 if k == "pab_j0"
                           else F64)
        for k, v in arrs.items()})
    return ec._replace(G=padded(ec.G))


def engine_consts(cfg: SolverConfig, device="cuda") -> EngineConsts:
    """The engine constant pack on `device` (built once per config and
    device, then cached); the card unless the caller asks for the CPU."""
    return _engine_consts(cfg, str(device_of(device)))


def engine_front(cfg: SolverConfig, lnP3: torch.Tensor, n_s: torch.Tensor,
                 ec: EngineConsts, clip: bool = False, n_rep: int = 1):
    """ln P [B, 3, nk] -> (P_ext [B, 3, np], ci [B, 3, 2 half]) through K9:
    the windowed P on the extended grid (reference redTime.cc:771-778: Pab
    extrapolation times the WP window, with the JAX package's clip(-80, 20)
    of the extrapolated log, redtime_tpu/fastpt.py:930: identity on
    physical spectra, it decides which rejected trial steps stay finite)
    and the forward leg (P_ext k^-nu) @ dft_fwd_half.  clip: first clip
    lnP to [LNP_MIN, LNP_MAX], as the RHS clips its state.  n_rep: each
    n_s entry serves n_rep lanes in a row (kernels.engine_front)."""
    return engine_front_kernel(lnP3, n_s, ec.pab_M, ec.pab_v, ec.wp,
                               ec.kbias, ec.dft_fwd_half, ec.pab_j0,
                               ec.pab_w, ec.wc_half, ec.twiddle, clip, n_rep)


def extend_power(cfg: SolverConfig, lnP3: torch.Tensor, n_s: torch.Tensor,
                 ec: EngineConsts) -> torch.Tensor:
    """ln P [B, 3, nk] -> windowed P on the extended grid [B, 3, np]
    (engine_front's P_ext)."""
    return engine_front(cfg, lnP3, n_s, ec)[0]


def _legs(cfg: SolverConfig, P_ext: torch.Tensor, ci: torch.Tensor,
          with_rsd: bool, ec: EngineConsts):
    """K10, K1 and K2 from the front's (P_ext, ci)."""
    nfam = NFAM if with_rsd else NFAM_J
    tab = tab_leg(ci, ec.ga_re, ec.ga_im, ec.gb_re, ec.gb_im,
                  ec.dft_bwd_half, ec.twiddle, nfam)    # [B, 2, nfam, 3, 2np]
    Jw = out_leg(tab, ec.G[:nfam])                      # [B, nfam, 3, 3, nk+1]
    PZw = pz_leg(ec.toeplitz_sl, P_ext, ec.pz_kfac_sl, make_grids(cfg).nshift)
    return Jw, PZw


def compute_J_PZ(cfg: SolverConfig, lnP3: torch.Tensor, n_s: torch.Tensor,
                 with_rsd: bool, ec: EngineConsts, clip: bool = False,
                 n_rep: int = 1):
    """The engine restricted to the assembly's read set (the RHS hot path):
    K9 engine_front, K10 tab_leg, K1 out_leg and K2 pz_leg.

    lnP3 [B, 3, nk] (rows ln P_00, P_01, P_11; any lane and row strides),
    n_s [B / n_rep]; clip and n_rep as in engine_front.  Returns (Jw [B,
    nfam, 3, 3, nk+1], PZ_w [B, 7, 3, 3, nk]): J on the solver window in
    columns 0..nk-1 and J at the PMR low-k point in column nk (reference
    reads redTime.cc:813-1279 [nshift+i], :1252 nloMR); nfam is NFAM (J,
    then the RSD Jn0 transforms) with RSD, NFAM_J without."""
    P_ext, ci = engine_front(cfg, lnP3, n_s, ec, clip, n_rep)
    return _legs(cfg, P_ext, ci, with_rsd, ec)


def window(cfg: SolverConfig, Jw: torch.Tensor, PZw: torch.Tensor,
           with_rsd: bool):
    """compute_J_PZ's outputs cut to the solver window: (J_w [B, NFAM, 3, 3,
    nk], J_lo [B], PZ_w), J_lo the J[0,0,0] at the PMR low-k point.
    Families 7..13 (the RSD Jn0 transforms) are zero unless with_rsd."""
    nk = make_grids(cfg).nk
    if not with_rsd:
        B = Jw.shape[0]
        Jw = torch.cat([Jw, Jw.new_zeros((B, NFAM - NFAM_J) + Jw.shape[2:])],
                       dim=1)
    return Jw[..., :nk], Jw[:, 0, 0, 0, nk], PZw


def compute_J_PZ_windowed(cfg: SolverConfig, P_ext: torch.Tensor,
                          with_rsd: bool, ec: EngineConsts):
    """The windowed engine from an extended spectrum P_ext [B, 3, np], as
    the JAX package's compute_J_PZ_windowed takes it (the CPU tests hold
    the two against each other): the forward leg as K9's plain version
    runs it, then K10, K1 and K2.  CPU tensors only: on the card the engine
    starts from ln P (compute_J_PZ), where K9 runs the forward leg."""
    if P_ext.device.type != "cpu":
        raise ValueError("compute_J_PZ_windowed takes CPU tensors: on the "
                         "card call compute_J_PZ with ln P")
    ci = forward_plain(P_ext, ec.kbias, ec.dft_fwd_half)
    return window(cfg, *_legs(cfg, P_ext, ci, with_rsd, ec), with_rsd)
