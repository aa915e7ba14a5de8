"""K9 engine_front and K10 tab_leg (redtime_tpu_torch/kernels/
engine_front.py, tab_leg.py) on the CPU, where each wrapper takes its
plain version.

  * engine_front_plain against the JAX package's extend_power and its
    forward leg, (P_ext kbias) @ dft_fwd_half, on JAX's own matmul-mode
    constants: P_ext within 1e-14 relative (the same operations; the lnP
    product's GEMM sums in another order, and exp and the window carry
    that), ci within its dot products' forward-error bound;
  * tab_leg_plain against sab @ dft_bwd_half built from JAX's constants:
    sab bit for bit (the same roundings), tab within 2K eps (|sab| @ |D|);
  * the whole engine, compute_J_PZ from ln P (the RHS's path: the state's
    rows, clipped) and compute_J_PZ_windowed from P_ext, against JAX's
    extend_power + compute_J_PZ_windowed at nk = 32, 48, 64, np_factor 4
    and 8, with and without RSD: J within 1e-11 of each (family, a, c)
    maximum (the bound of tests/test_torch_engine.py: the composite G
    rounds the same linear map differently), PZ within the Toeplitz dot's
    forward-error bound;
  * a NaN lane stays NaN and leaves the other lane's bits alone; a lane
    past the clip on both sides gives the clipped lane's bits;
  * numpy models of the kernels' stage order (csrc/engine_front.cu,
    csrc/tab_leg.cu, csrc/fft_smem.cuh): the band extension with the
    dense product's NaN / inf rule, the real-input FFT and its split
    (K9), the window products, the pruned real-output FFT with its S-fold
    split over the blocks of launch_plan (K10), every stage writing each
    element once, at ragged grids (nk 37 / 16 / 12 / 48, np_factor 8, the
    presets' np = 2048): within the kernels' stated bounds of the plain
    versions and within a stated tolerance of JAX's FFT path
    (_coeff_spectra_pair, _conv_prod);
  * pab_M's band, the twiddle tables against long-double roots, the FFT
    plans against numpy.fft, K10's launch plans;
  * the wrappers' errors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redtime_tpu import fastpt as jf
from redtime_tpu import fourier as jfourier
from redtime_tpu.config import SolverConfig as JCfg
from redtime_tpu_torch import fastpt as tf
from redtime_tpu_torch import fourier
from redtime_tpu_torch.config import SolverConfig as TCfg
from redtime_tpu_torch.grids import (make_grids, pab_band,
                                     pab_extension_matrix)
from redtime_tpu_torch.kernels import counts
from redtime_tpu_torch.kernels import engine_front as k9
from redtime_tpu_torch.kernels import tab_leg as k10
from redtime_tpu_torch.kernels.rhs_tail import LNP_MAX, LNP_MIN

EPS = np.finfo(np.float64).eps
# the JAX engine's matmul form with every leg an f64 dot
DOT = dict(out_leg="dot", tab_leg="dot", pz_leg="dot", fwd_leg="dot")


@functools.lru_cache(maxsize=None)
def _consts(nk: int, np_factor: int):
    jc = JCfg(nk=nk, np_factor=np_factor, **DOT)
    tc = TCfg(nk=nk, np_factor=np_factor)
    return jc, tc, jf.engine_consts(jc, "matmul"), tf.engine_consts(tc,
                                                                    "cpu")


def _state_lnP(nk: int, B: int, seed: int) -> np.ndarray:
    """[B, 41, nk] states whose ln P rows look like evolved spectra (P ~
    k / (1 + (k/k0)^2)^2 on the solver's k grid, 1e-3 .. 1 h/Mpc, times a
    lane's amplitude, with 1% noise; rows 1-2 scaled as by growth rates),
    the other rows noise: the RHS hands K9 rows 0-2 of such a state."""
    rng = np.random.default_rng(seed)
    k = np.geomspace(1e-3, 1.0, nk)
    y = rng.standard_normal((B, 41, nk))
    base = np.log(2e4 * (k / 0.02) / (1.0 + (k / 0.02) ** 2) ** 2)
    amp = rng.uniform(-1.0, 1.0, (B, 1))
    for a in range(3):
        y[:, a] = base + amp + a * np.log(0.8) + 0.01 * y[:, a]
    return y


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


@pytest.mark.parametrize("nk,np_factor", [(32, 4), (48, 8)])
def test_engine_front_plain_matches_jax(nk, np_factor):
    jc, _, ec_j, ec = _consts(nk, np_factor)
    lnP = _state_lnP(nk, 2, nk)[:, :3]
    ns = np.array([0.96, 0.93])
    P, ci = k9.engine_front_plain(_t(lnP), _t(ns), ec.pab_M, ec.pab_v,
                                  ec.wp, ec.kbias, ec.dft_fwd_half)
    for b in range(2):
        P_j = jf.extend_power(jc, jnp.asarray(lnP[b]), ns[b], ec_j)
        np.testing.assert_allclose(P[b].numpy(), np.asarray(P_j),
                                   rtol=1e-14, atol=0)
        Q = np.asarray(P_j * ec_j.kbias)
        ci_j = np.asarray(jnp.asarray(Q) @ ec_j.dft_fwd_half)
        # two np-term dot products in different orders, on inputs 1e-14
        # apart
        F = np.abs(np.asarray(ec_j.dft_fwd_half))
        bound = (2 * jc.npts * EPS + 2e-14) * (np.abs(Q) @ F)
        assert np.all(np.abs(ci[b].numpy() - ci_j) <= bound)


def _jax_sab(ec_j, ci: np.ndarray, nfam: int, half: int):
    """sab as redtime_tpu/fastpt.py:1194-1203 forms it, on one lane."""
    ca_re, ca_im = jnp.asarray(ci[:, :half]), jnp.asarray(ci[:, half:])

    def coeff(gr, gi):
        sr, si = jf._cmul(ca_re[None], ca_im[None], gr[:nfam, None],
                          gi[:nfam, None])
        return jnp.concatenate([sr, si], axis=-1)

    return np.asarray(jnp.stack([coeff(ec_j.ga_re, ec_j.ga_im),
                                 coeff(ec_j.gb_re, ec_j.gb_im)]))


@pytest.mark.parametrize("nfam", [7, 14])
def test_tab_leg_plain_matches_jax(nfam):
    jc, tc, ec_j, ec = _consts(32, 4)
    half = tc.npts // 2
    _, ci = k9.engine_front_plain(_t(_state_lnP(32, 2, 5)[:, :3]),
                                  _t([0.96, 0.97]), ec.pab_M, ec.pab_v,
                                  ec.wp, ec.kbias, ec.dft_fwd_half)
    g = (ec.ga_re, ec.ga_im, ec.gb_re, ec.gb_im)
    sab = k10.sab_plain(ci, *g, nfam)
    tab = k10.tab_leg_plain(ci, *g, ec.dft_bwd_half, nfam)
    assert tab.shape == (2, 2, nfam, 3, 2 * tc.npts)
    D = np.asarray(ec_j.dft_bwd_half)
    for b in range(2):
        sab_j = _jax_sab(ec_j, ci[b].numpy(), nfam, half)
        np.testing.assert_array_equal(sab[b].numpy(), sab_j)
        tab_j = sab_j @ D
        bound = 2 * D.shape[0] * EPS * (np.abs(sab_j) @ np.abs(D))
        assert np.all(np.abs(tab[b].numpy() - tab_j) <= bound)


@functools.lru_cache(maxsize=None)
def _jax_windowed(nk, np_factor, with_rsd):
    """JAX's extend_power + compute_J_PZ_windowed on the clipped rows of
    two states, per lane."""
    jc, _, ec_j, _ = _consts(nk, np_factor)
    lnP = np.clip(_state_lnP(nk, 2, 7 * nk)[:, :3], LNP_MIN, LNP_MAX)

    def lane(lnP3, n_s):
        P_j = jf.extend_power(jc, lnP3, n_s, ec_j)
        return (P_j,) + jf.compute_J_PZ_windowed(jc, P_j, with_rsd,
                                                 "matmul", ec_j)

    out = jax.jit(jax.vmap(lane))(jnp.asarray(lnP),
                                  jnp.asarray([0.96, 0.99]))
    return [[np.asarray(x[b]) for x in out] for b in range(2)]


@pytest.mark.parametrize("with_rsd", [True, False])
@pytest.mark.parametrize("nk,np_factor", [(32, 4), (48, 4), (64, 4),
                                          (32, 8), (48, 8)])
def test_whole_engine_matches_jax(nk, np_factor, with_rsd):
    _, tc, _, ec = _consts(nk, np_factor)
    g = make_grids(tc)
    y = _t(_state_lnP(nk, 2, 7 * nk))
    ns = _t([0.96, 0.99])
    Jw, J_lo, PZw = tf.window(tc, *tf.compute_J_PZ(
        tc, y[:, :3], ns, with_rsd, ec, clip=True), with_rsd)
    P = tf.extend_power(tc, torch.clamp(y[:, :3], LNP_MIN, LNP_MAX), ns, ec)
    from_P = tf.compute_J_PZ_windowed(tc, P, with_rsd, ec)
    assert Jw.shape == (2, tf.NFAM, 3, 3, nk) and PZw.shape == (2, 7, 3, 3,
                                                                 nk)
    if not with_rsd:
        assert torch.all(Jw[:, tf.NFAM_J:] == 0)
    T = ec.toeplitz_sl.numpy()
    sl = slice(g.nshift, g.nshift + nk)
    for b, (P_j, J, lo, PZ) in enumerate(_jax_windowed(nk, np_factor,
                                                       with_rsd)):
        scale = np.abs(J).max(axis=-1, keepdims=True) + 1e-300
        bound_pz = (2 * g.npts * EPS * np.einsum(
            "nim,am->nai", np.abs(T), np.abs(P_j))[:, :, None, :]
            * np.abs(ec.pz_kfac_sl.numpy() * P_j[None, :, sl]))
        for Jt, lot, PZt in ((Jw, J_lo, PZw), from_P):
            assert np.max(np.abs(Jt[b].numpy() - J) / scale) < 1e-11
            assert abs(float(lot[b]) - float(lo)) < 1e-11 * scale[0, 0, 0, 0]
            assert np.all(np.abs(PZt[b].numpy() - PZ) <= bound_pz)


def test_nan_lane_stays_nan_and_alone():
    """The chunked scheduler poisons unfinished lanes with NaN: through
    the whole engine that lane stays NaN in every output and the other
    lane keeps its bits (the same batch shape, so the same GEMM
    blocking)."""
    _, tc, _, ec = _consts(32, 4)
    y = _t(_state_lnP(32, 2, 11))
    ns = _t([0.96, 0.99])
    ref = tf.compute_J_PZ(tc, y[:, :3], ns, True, ec, clip=True)
    y[1] = float("nan")
    got = tf.compute_J_PZ(tc, y[:, :3], ns, True, ec, clip=True)
    P, ci = tf.engine_front(tc, y[:, :3], ns, ec, clip=True)
    tab = k10.tab_leg(ci, ec.ga_re, ec.ga_im, ec.gb_re, ec.gb_im,
                      ec.dft_bwd_half, ec.twiddle, tf.NFAM)
    for x in (*got, P, ci, tab):
        assert bool(x[1].isnan().all())
    for a, b in zip(got, ref):
        assert torch.equal(a[0], b[0])


def test_clip_on_both_sides():
    """A lane past the RHS's clip on both sides: with clip=True the engine
    gives the bits of the lane clipped beforehand, and finite outputs;
    without it (the 1-loop cache and finalize) the extension's own clip
    keeps P_ext finite."""
    _, tc, _, ec = _consts(32, 4)
    y = _t(_state_lnP(32, 2, 13))
    y[0, 0, :16], y[0, 2, 16:] = 400.0, -400.0
    ns = _t([0.96, 0.99])
    got = tf.compute_J_PZ(tc, y[:, :3], ns, True, ec, clip=True)
    want = tf.compute_J_PZ(tc, torch.clamp(y[:, :3], LNP_MIN, LNP_MAX), ns,
                           True, ec)
    for a, b in zip(got, want):
        assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    P = tf.extend_power(tc, y[:, :3], ns, ec)
    assert bool(torch.isfinite(P).all())
    assert float(P.max()) <= float(np.exp(k9.EXT_MAX) * ec.wp.max())


# --- numpy models of the kernels' stage order -----------------------------

def _cplx_tw(tw: np.ndarray, inv: bool) -> np.ndarray:
    t = tw[:, 0] + 1j * tw[:, 1]
    return t if inv else np.conj(t)


def _rot(v, inv):
    """v times i (inverse) or -i (forward), as fft_smem.cuh's rot."""
    return (-v.imag + 1j * v.real) if inv else (v.imag - 1j * v.real)


def _dft4(v0, v1, v2, v3, inv):
    t0, t1, t2, t3 = v0 + v2, v0 - v2, v1 + v3, _rot(v1 - v3, inv)
    return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]


def _dft(v, inv):
    """fft_smem.cuh's dft<P>: the P-point butterflies, P = 2, 4, 8."""
    if len(v) == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if len(v) == 4:
        return _dft4(*v, inv)
    e, o = _dft4(*v[0::2], inv), _dft4(*v[1::2], inv)
    h, s = 0.70710678118654752440, 1.0 if inv else -1.0
    o[1] = h * (o[1].real - s * o[1].imag) + 1j * h * (o[1].imag
                                                        + s * o[1].real)
    o[2] = _rot(o[2], inv)
    o[3] = -h * (o[3].real + s * o[3].imag) + 1j * h * (s * o[3].real
                                                         - o[3].imag)
    return [e[q] + o[q] for q in range(4)] + [e[q] - o[q] for q in range(4)]


def _fft_model(load, rows: int, n: int, inv: bool, tw: np.ndarray):
    """fft_smem.cuh's run over rows x n: the Stockham stages of
    fourier.fft_plan(n) with its index arithmetic, stage 0 reading
    load(i) ([rows, len(i)] complex), twiddle w_m^e read as entry e N / m
    of the table (N = len(tw)); every stage writes each element once."""
    N, T = len(tw), _cplx_tw(tw, inv)
    data, Ns = None, 1
    for s, P in enumerate(fourier.fft_plan(n)):
        src = load if s == 0 else (lambda i, d=data: d[:, i])
        out = np.full((rows, n), np.nan + 0j)
        writes = np.zeros(n, dtype=np.int64)
        if P in (2, 4, 8):
            q = n // P
            j = np.arange(q)
            k, step = j % Ns, N // (Ns * P)
            v = [src(j + r * q) for r in range(P)]
            for r in range(1, P):
                v[r] = np.where(k > 0, v[r] * T[k * r * step], v[r])
            v = _dft(v, inv)
            base = (j - k) * P + k
            for r in range(P):
                out[:, base + r * Ns] = v[r]
                np.add.at(writes, base + r * Ns, 1)
        else:   # the odd stage, last: o sums inputs o mod Ns + r Ns
            o = np.arange(n)
            j, Ns_, step = o % (n // P), n // P, N // n
            acc, e = src(j), o.copy()
            for r in range(1, P):
                acc = acc + src(j + r * Ns_) * T[e * step]
                e = (e + o) % n
            out, writes = acc, np.ones(n, dtype=np.int64)
        assert np.all(writes == 1), (n, s, P)
        data, Ns = out, Ns * P
    assert Ns == n
    return data


def _tab_leg_model(ci, ga_re, ga_im, gb_re, gb_im, tw, nfam, sms):
    """tab as csrc/tab_leg.cu computes it: the blocks of launch_plan (RB
    rows of one (b, a), S blocks a row), each row's X = ci g with the
    plain version's operations, the C2R sequence Z, the S-fold split and
    the FFT of length np / S (_fft_model), its outputs written as pairs
    to tab row ((b 2 + s) nfam + f) 3 + a at m = S m' + h.  Returns tab
    and how often each element was written (once each)."""
    B, _, npts = ci.shape
    half, N = npts // 2, 2 * npts
    RB, S, _ = k10.launch_plan(B, nfam, npts, sms)
    G, ns, T = -(-2 * nfam // RB), npts // S, _cplx_tw(tw, True)
    tab = np.full((B * 6 * nfam, npts), np.nan + 0j)
    writes = np.zeros((B * 6 * nfam, npts), dtype=np.int64)
    g = ((ga_re, ga_im), (gb_re, gb_im))
    for blk in range(3 * B * G * S):
        h, grp, pair = blk % S, blk // S % G, blk // S // G
        b, a, q0 = pair // 3, pair % 3, (blk // S % G) * RB
        qs = np.arange(q0, min(q0 + RB, 2 * nfam))
        s_, f_ = qs // nfam, qs % nfam
        cr, cm = ci[b, a, :half], ci[b, a, half:]
        wr = np.stack([g[s][0][f] for s, f in zip(s_, f_)])
        wi = np.stack([g[s][1][f] for s, f in zip(s_, f_)])
        X = (cr * wr - cm * wi) + 1j * (cr * wi + cm * wr)

        def Z(k):
            kk = np.where(k < half, k, npts - k) % half
            x = X[:, kk]
            wx = T[kk] * x
            z = np.where(k < half, x + 1j * wx, np.conj(x - 1j * wx))
            z = np.where(k == half, 0.0, z)
            re0 = X[:, :1].real + X[:, :1].imag * 0.0
            return np.where(k == 0, re0 + 1j * re0, z)

        def first(k):
            if S == 1:
                return Z(k)
            acc = sum(Z(k + t * ns) * T[t * h % S * (N // S)]
                      for t in range(S))
            return acc * T[2 * k * h]

        z = _fft_model(first, len(qs), ns, True, tw)
        r = ((b * 2 + s_) * nfam + f_) * 3 + a
        cols = S * np.arange(ns) + h
        tab[np.ix_(r, cols)] = z
        writes[np.ix_(r, cols)] += 1
    out = np.empty((B * 6 * nfam, N))
    out[:, 0::2], out[:, 1::2] = tab.real, tab.imag
    return out.reshape(B, 2, nfam, 3, N), writes


def _engine_front_model(lnP, n_s, j0, w, pab_v, wp, kbias, wc, tw, clip):
    """(P_ext, ci) as csrc/engine_front.cu computes them, a row (b, a) a
    block: the staged row (clipped) and its NaN and inf counts; x from
    the band, NaN where the row has a NaN or more infs than the point's
    non-zero weights meet; clip, exp and window in the plain version's
    order; q = P_ext kbias; the FFT of length np / 2 of p_j = q_2j + i
    q_2j+1 (_fft_model, forward) and the real split times wc."""
    B, _, nk = lnP.shape
    npts = len(j0)
    half = npts // 2
    L = lnP.reshape(B * 3, nk)
    if clip:
        L = np.clip(L, LNP_MIN, LNP_MAX)    # NaN stays NaN
    nans = np.isnan(L).sum(1)[:, None]
    infs = np.isinf(L).sum(1)[:, None]
    taps = L[:, j0[:, None] + np.arange(4)]              # [rows, np, 4]
    with np.errstate(invalid="ignore"):
        s = taps[..., 0] * w[:, 0]
        for t in (1, 2, 3):
            s = s + taps[..., t] * w[:, t]
        met = ((w != 0) & np.isinf(taps)).sum(-1)
        c = np.repeat(n_s - 3.0, 3)[:, None]
        x = np.clip(s + c * pab_v, k9.EXT_MIN, k9.EXT_MAX)
        x = np.where((nans > 0) | (infs > met), np.nan, x)
        P = np.exp(x) * wp
        q = P * kbias
        p = q[:, 0::2] + 1j * q[:, 1::2]
        R = _fft_model(lambda i: p[:, i], B * 3, half, False, tw)
        k = np.arange(half)
        pk, rk = R[:, k], R[:, (half - k) % half]
        E = 0.5 * (pk + np.conj(rk))
        O = 0.5 * (pk - np.conj(rk)) / 1j
        Q = E + _cplx_tw(tw, False)[2 * k] * O
    ci = np.concatenate([wc * Q.real, wc * Q.imag], axis=1)
    return P.reshape(B, 3, npts), ci.reshape(B, 3, npts)


def _band(ec):
    return (ec.pab_j0, ec.pab_w, ec.wc_half, ec.twiddle)


def _front(ec, lnP, ns):
    return (lnP, ns, ec.pab_M, ec.pab_v, ec.wp, ec.kbias, ec.dft_fwd_half)


def _model_front(ec, lnP, ns, clip):
    n = lambda x: x.numpy()
    return _engine_front_model(n(lnP), n(ns), n(ec.pab_j0), n(ec.pab_w),
                               n(ec.pab_v), n(ec.wp), n(ec.kbias),
                               n(ec.wc_half), n(ec.twiddle), clip)


def _jax_fft_consts(ec, g):
    """What JAX's FFT path reads of its engine pack, from the port's
    constants (bit-equal to JAX's: tests/test_torch_engine.py)."""
    import types
    return types.SimpleNamespace(
        kbias=jnp.asarray(ec.kbias.numpy()), wc=jnp.asarray(g.wc),
        ga_re=jnp.asarray(ec.ga_re.numpy()), ga_im=jnp.asarray(ec.ga_im
                                                               .numpy()),
        gb_re=jnp.asarray(ec.gb_re.numpy()), gb_im=jnp.asarray(ec.gb_im
                                                               .numpy()),
        dft_np=None, dft_2np=None)


# (nk, np_factor, lanes): the ragged grids (nk = 37: np / 2 = 74 = 2 x
# 37; nk = 12 at np_factor 8 and nk = 48: a radix-3 stage), the main
# grid and the presets' (np = 2048)
MODEL_GRIDS = [(37, 4, 2), (16, 4, 3), (12, 8, 2), (48, 4, 2), (128, 4, 2),
               (128, 8, 1), (512, 4, 1)]


@pytest.mark.parametrize("nk,np_factor,B", MODEL_GRIDS)
def test_engine_front_model_within_bound_and_near_jax_fft(nk, np_factor, B):
    """K9's stage order (_engine_front_model) on a state's clipped ln P
    rows: P_ext and ci within engine_front.error_bound of the plain
    version, and ci within twice the bound's FFT term (16 eps l wc_c sum
    |Q|, l = fft_levels(np / 2) + 3) of JAX's FFT path
    (_coeff_spectra_pair: jnp.fft.rfft of P_ext kbias, times wc) on the
    same P_ext."""
    tc = TCfg(nk=nk, np_factor=np_factor)
    ec, g = tf.engine_consts(tc, "cpu"), make_grids(tc)
    y = _t(_state_lnP(nk, B, nk * B))
    ns = _t(np.linspace(0.92, 0.99, B))
    P, ci = _model_front(ec, y[:, :3], ns, True)
    P_ref, ci_ref, dP, dci = k9.error_bound(*_front(ec, y[:, :3], ns),
                                            clip=True)
    assert np.all(np.abs(P - P_ref.numpy()) <= dP.numpy())
    assert np.all(np.abs(ci - ci_ref.numpy()) <= dci.numpy())
    half = tc.npts // 2
    jec = _jax_fft_consts(ec, g)
    re, im = jfourier.rfft(jnp.asarray(P) * jec.kbias, "fft")
    ci_j = np.concatenate([np.asarray(re * jec.wc)[..., :half],
                           np.asarray(im * jec.wc)[..., :half]], -1)
    Q = np.abs(P * ec.kbias.numpy()).sum(-1, keepdims=True)
    tol = (2 * 16 * EPS * (fourier.fft_levels(half) + 3) * Q
           * np.tile(g.wc[:half], 2))
    assert np.all(np.abs(ci - ci_j) <= tol)


@pytest.mark.parametrize("nk,np_factor,B,nfam,sms", [
    (37, 4, 2, 14, 132), (16, 4, 3, 7, 132), (12, 8, 2, 14, 132),
    (48, 4, 1, 1, 132), (128, 4, 2, 14, 4), (128, 4, 1, 7, 132),
    (512, 4, 1, 14, 132)])
def test_tab_leg_model_within_bound_and_near_jax_fft(nk, np_factor, B, nfam,
                                                     sms):
    """K10's stage order (_tab_leg_model) on the ci of a state's rows, at
    launch plans with S = 1 (sms = 4: 4 rows a block), 2, 4 and 8: every
    tab element written once, within tab_leg.error_bound of the plain
    version; and on JAX's own coefficient spectra (_coeff_spectra_pair,
    FFT path) the model's tab_a tab_b / 2np within the products' share
    of twice the bound's FFT term (d = 32 eps l sum_k c_k |X_k| on each
    factor) of JAX's _conv_prod."""
    tc = TCfg(nk=nk, np_factor=np_factor)
    ec, g = tf.engine_consts(tc, "cpu"), make_grids(tc)
    half, n2 = tc.npts // 2, 2 * tc.npts
    y = _t(_state_lnP(nk, B, 3 * nk + B))
    ns = _t(np.linspace(0.93, 0.98, B))
    P, ci = k9.engine_front_plain(*_front(ec, y[:, :3], ns), clip=True)
    gs = (ec.ga_re, ec.ga_im, ec.gb_re, ec.gb_im)
    tab, writes = _tab_leg_model(ci.numpy(), *(x.numpy() for x in gs),
                                 ec.twiddle.numpy(), nfam, sms)
    assert np.all(writes == 1)
    ref, bound = k10.error_bound(ci, *gs, ec.dft_bwd_half, nfam)
    assert np.all(np.abs(tab - ref.numpy()) <= bound.numpy())
    jec = _jax_fft_consts(ec, g)
    levels = fourier.fft_levels(tc.npts) + k10.S_MAX + 4
    for b in range(B):
        sa_re, sa_im, sb_re, sb_im = jf._coeff_spectra_pair(
            jnp.asarray(P[b].numpy()), nfam, "fft", jec, half)
        conv = np.asarray(jf._conv_prod(sa_re, sa_im, sb_re, sb_im,
                                        tc.npts, "fft", jec))
        # the model fed JAX's ci: ca = rfft * wc, first half frequencies
        re, im = jfourier.rfft(jnp.asarray(P[b].numpy()) * jec.kbias,
                                 "fft")
        ci_b = np.concatenate([np.asarray(re * jec.wc)[..., :half],
                               np.asarray(im * jec.wc)[..., :half]], -1)
        t, _ = _tab_leg_model(ci_b[None], *(x.numpy() for x in gs),
                              ec.twiddle.numpy(), nfam, sms)
        ta, tb = t[0, 0], t[0, 1]                   # [nfam, 3, 2np]
        X = [np.hypot(np.asarray(x_re), np.asarray(x_im))
             for x_re, x_im in ((sa_re, sa_im), (sb_re, sb_im))]
        c = np.full(half, 2.0)
        c[0] = 1.0
        da, db = (32 * EPS * levels * (x @ c)[..., None] for x in X)
        tol = (np.abs(ta)[:, :, None] * db[:, None] + da[:, :, None]
               * np.abs(tb)[:, None] + da[:, :, None] * db[:, None]) / n2
        got = ta[:, :, None] * tb[:, None] / n2
        assert np.all(np.abs(got - conv) <= tol)


@pytest.mark.parametrize("nk,np_factor", [(12, 4), (16, 4), (37, 4),
                                          (48, 8), (128, 4), (512, 8)])
def test_pab_band_reproduces_pab_M(nk, np_factor):
    """The band (grids.pab_band, in EngineConsts as pab_j0 / pab_w) holds
    every non-zero of pab_M and nothing else: scattered back it is pab_M
    bit for bit, inside the grid (j0 + 3 < nk)."""
    tc = TCfg(nk=nk, np_factor=np_factor)
    M = pab_extension_matrix(make_grids(tc))[0]
    j0, w = pab_band(M)
    assert j0.dtype == np.int32 and np.all(j0 + 3 < nk)
    if nk <= 48:       # the pack carries it (a small grid: G is slow)
        ec = tf.engine_consts(tc, "cpu")
        assert ec.pab_j0.dtype == torch.int32
        np.testing.assert_array_equal(ec.pab_j0.numpy(), j0)
        np.testing.assert_array_equal(ec.pab_w.numpy(), w)
    R = np.zeros_like(M)
    for m in range(len(j0)):
        R[m, j0[m]:j0[m] + 4] = w[m]
    np.testing.assert_array_equal(R, M)
    assert np.all((M != 0).sum(1) <= 4)


@pytest.mark.parametrize("n", [64, 74, 96, 148, 512, 2048])
def test_twiddles_and_plans_against_numpy_fft(n):
    """fourier.twiddles(2n) within an ulp or two of the exact roots (long
    double), with the quadrants' exact symmetries; fourier.fft_plan(n)'s
    radices multiply to n, the odd part last; the plan's FFT
    (_fft_model) of random rows, both ways, within 16 eps l sum |x| of
    numpy.fft."""
    N = 2 * n
    tw = fourier.twiddles(N)
    j = np.arange(N, dtype=np.longdouble)
    ang = 2 * np.pi * j / N
    assert np.all(np.abs(tw[:, 0] - np.cos(ang)) <= 2 * EPS)
    assert np.all(np.abs(tw[:, 1] - np.sin(ang)) <= 2 * EPS)
    q = N // 4
    np.testing.assert_array_equal(tw[q:2 * q, 0], -tw[:q, 1])
    np.testing.assert_array_equal(tw[2 * q:3 * q], -tw[:q])
    plan = fourier.fft_plan(n)
    assert int(np.prod(plan)) == n
    assert all(p in (2, 4, 8) for p in plan[:-1])
    assert plan[-1] in (2, 4, 8) or plan[-1] % 2 == 1
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    tol = 16 * EPS * fourier.fft_levels(n) * np.abs(x).sum(1, keepdims=True)
    for inv, ref in ((False, np.fft.fft(x)), (True, np.fft.ifft(x) * n)):
        got = _fft_model(lambda i: x[:, i], 3, n, inv, tw)
        assert np.all(np.abs(got - ref) <= tol)


@pytest.mark.parametrize("bad,clip", [(np.nan, True), (np.nan, False),
                                      (np.inf, False), (-np.inf, False)])
def test_non_finite_ln_p_as_the_dense_product(bad, clip):
    """One NaN or inf in a row of ln P: the model of K9 gives NaN in P_ext
    exactly where the plain version's dense product does (a NaN: the whole
    row; an inf: every point whose row of pab_M is zero there, inf * 0)
    and a whole NaN row of ci, and leaves the other rows finite; with the
    clip an inf is clipped and stays finite."""
    tc = TCfg(nk=16)
    ec = tf.engine_consts(tc, "cpu")
    y = _t(_state_lnP(16, 2, 17))
    y[1, 1, 5] = bad
    ns = _t([0.96, 0.97])
    P, ci = _model_front(ec, y[:, :3], ns, clip)
    P_ref, ci_ref = k9.engine_front_plain(*_front(ec, y[:, :3], ns),
                                          clip=clip)
    np.testing.assert_array_equal(np.isnan(P), P_ref.isnan().numpy())
    np.testing.assert_array_equal(np.isnan(ci), ci_ref.isnan().numpy())
    assert np.isnan(ci[1, 1]).all() and np.isfinite(np.delete(
        ci.reshape(6, -1), 4, 0)).all()
    if np.isnan(bad):
        assert np.isnan(P[1, 1]).all()
    else:
        assert 0 < np.isfinite(P[1, 1]).sum() <= 4


@pytest.mark.parametrize("B,nfam,npts,sms,want", [
    (16, 14, 512, 132, (4, 1, 256)), (2, 14, 2048, 132, (1, 2, 128)),
    (2, 7, 2048, 132, (1, 4, 64)), (64, 7, 512, 132, (4, 1, 256)),
    (1, 1, 148, 132, (1, 2, 64)), (16, 14, 4096, 132, (1, 1, 256))])
def test_tab_leg_launch_plan(B, nfam, npts, sms, want):
    """launch_plan: 4 rows a block where the blocks fill every SM twice,
    fewer rows and then S blocks a row where they do not (the presets' 2
    lanes), fewer rows where a block's shared memory would pass the SM's
    (np = 4096 at 16 lanes), S dividing np, threads one a radix-8
    butterfly; a row whose Z alone passes the SM's shared memory raises
    (np = 16384), where the wrapper checks its inputs."""
    RB, S, threads = got = k10.launch_plan(B, nfam, npts, sms)
    assert got == want
    assert npts % S == 0 and k10.smem_bytes(RB, S, npts) <= k10.SMEM_MAX
    assert 64 <= threads <= k10.MAX_THREADS and threads % 32 == 0
    with pytest.raises(ValueError, match="shared memory"):
        k10.launch_plan(2, 14, 16384, sms)


# --- the wrappers --------------------------------------------------------

def _front_args(B=2, nk=16, npts=64, nc=64):
    rng = np.random.default_rng(3)
    t = lambda *s: torch.as_tensor(rng.standard_normal(s))
    j0 = torch.as_tensor(rng.integers(0, nk - 3, npts), dtype=torch.int32)
    return [t(B, 3, nk), t(B), t(npts, nk), t(npts), t(npts), t(npts),
            t(npts, nc), j0, t(npts, 4), t(nc // 2), t(2 * npts, 2)]


def _tab_args(B=2, half=8, N=32):
    rng = np.random.default_rng(4)
    t = lambda *s: torch.as_tensor(rng.standard_normal(s))
    return [t(B, 3, 2 * half), t(14, half), t(14, half), t(14, half),
            t(14, half), t(2 * half, N), t(N, 2)]


def test_wrappers_validate_and_cpu_takes_plain():
    before = counts.snapshot()
    args = _front_args()
    for got, want in zip(k9.engine_front(*args, clip=True),
                         k9.engine_front_plain(*args[:7], clip=True)):
        assert torch.equal(got, want)
    targs = _tab_args()
    assert torch.equal(k10.tab_leg(*targs, 7),
                       k10.tab_leg_plain(*targs[:6], 7))
    assert counts.snapshot() == before      # the plain path never counts
    bad_front = [
        (TypeError, 0, lambda x: x.float()),            # dtype
        (TypeError, 7, lambda x: x.double()),
        (ValueError, 0, lambda x: x[:, :2]),            # shape
        (ValueError, 1, lambda x: x[:1]),
        (ValueError, 2, lambda x: x[:, :5]),
        (ValueError, 3, lambda x: x[:7]),
        (ValueError, 6, lambda x: x[:9]),
        (ValueError, 7, lambda x: x[:9]),
        (ValueError, 8, lambda x: x[:, :3]),
        (ValueError, 9, lambda x: x[:5]),
        (ValueError, 10, lambda x: x[:9]),
        (ValueError, 4, lambda x: x.to("meta")),        # device
    ]
    for err, i, f in bad_front:
        a = list(args)
        a[i] = f(a[i])
        with pytest.raises(err):
            k9.engine_front(*a)
    bad_tab = [
        (TypeError, 0, lambda x: x.float()),
        (ValueError, 0, lambda x: x[:, :2]),
        (ValueError, 2, lambda x: x[:, :5]),
        (ValueError, 5, lambda x: x[:9]),
        (ValueError, 6, lambda x: x[:9]),
        (ValueError, 5, lambda x: x.t().contiguous().t()),  # stride
        (ValueError, 0, lambda x: x.transpose(1, 2).contiguous()
         .transpose(1, 2)),
        (ValueError, 3, lambda x: x.to("meta")),
    ]
    for err, i, f in bad_tab:
        a = list(targs)
        a[i] = f(a[i])
        with pytest.raises(err):
            k10.tab_leg(*a, 7)
    for nfam in (0, 15):
        with pytest.raises(ValueError, match="nfam"):
            k10.tab_leg(*targs, nfam)


def test_kernel_checks_refuse_what_the_kernels_cannot_take():
    """What only the card's path checks: K9's lnP needs a unit column
    stride, an even np with all its np / 2 frequencies, and its shared
    memory must fit; K10's transform must be the inverse of length 2np =
    4 half."""
    args = _front_args()
    bad = list(args)
    bad[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="column stride"):
        k9._check_kernel_shape(bad[0], *args[2:])
    k9._check_kernel_shape(args[0][:, :, :8], *_front_args(nk=8)[2:])
    odd = _front_args(npts=63, nc=62)
    with pytest.raises(ValueError, match="even np"):
        k9._check_kernel_shape(odd[0], *odd[2:])
    npts = 16384       # 2 np + nk doubles: more than an SM's 227 KB
    big = _front_args(npts=64, nc=64)
    big[2] = torch.zeros((npts, 16), dtype=torch.float64)
    big[6] = torch.zeros((1, 1), dtype=torch.float64).expand(npts, npts)
    big[7:] = [torch.zeros(npts, dtype=torch.int32),
               torch.zeros((npts, 4), dtype=torch.float64),
               torch.zeros(npts // 2, dtype=torch.float64),
               torch.zeros((2 * npts, 2), dtype=torch.float64)]
    with pytest.raises(ValueError, match="shared memory"):
        k9._check_kernel_shape(big[0], *big[2:])
    targs = _tab_args()
    k10._check_kernel_shape(targs[0], targs[5], targs[6])
    with pytest.raises(ValueError, match="4 half"):
        k10._check_kernel_shape(targs[0], targs[5][:, :24],
                                targs[6][:24])


def test_wrappers_raise_off_the_cpu_without_a_kernel():
    """A tensor that is not on the CPU never reaches a plain version: on a
    device with no kernel (here `meta`) the wrappers raise, and so does
    compute_J_PZ_windowed, whose forward leg runs only on the CPU."""
    meta = torch.device("meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        k9.engine_front(*[x.to(meta) for x in _front_args()])
    with pytest.raises(RuntimeError, match="no kernel"):
        k10.tab_leg(*[x.to(meta) for x in _tab_args()], 7)
    tc = TCfg(nk=16)
    ec = tf.EngineConsts(*[x.to(meta) for x in tf.engine_consts(tc, "cpu")])
    with pytest.raises(ValueError, match="CPU tensors"):
        tf.compute_J_PZ_windowed(tc, torch.empty((1, 3, tc.npts),
                                                 dtype=torch.float64,
                                                 device=meta), True, ec)
