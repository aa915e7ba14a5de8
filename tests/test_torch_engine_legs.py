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
  * CPU models of the kernels' tilings (csrc/tab_leg.cu, csrc/
    engine_front.cu): every (row, column, K) product once, ragged edges
    zero-filled in both operands, so stages left unfilled (NaN here) never
    reach an output;
  * the wrappers' errors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from redtime_tpu import fastpt as jf
from redtime_tpu.config import SolverConfig as JCfg
from redtime_tpu_torch import fastpt as tf
from redtime_tpu_torch.config import SolverConfig as TCfg
from redtime_tpu_torch.grids import make_grids
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
                      ec.dft_bwd_half, tf.NFAM)
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


# --- CPU models of the kernels' tilings ----------------------------------

def _tab_leg_model(ci, ga_re, ga_im, gb_re, gb_im, D, nfam):
    """tab as csrc/tab_leg.cu computes it, block by block and K-step by
    K-step, with its index arithmetic: each stage starts as NaN (memory
    the kernel never wrote), the ring's copies fill it (the step's ci and
    g rows, dft_bwd_half's tile; zeros past the edges), each thread forms
    its products from the staged rows, and the warps' m16n8k8 products
    add tile by tile.  Returns (tab, cover): cover[r, n, k] counts the
    products of row r, column n and sab column k that reached the sums."""
    B, _, K = ci.shape
    half, N = K // 2, D.shape[1]
    M = 6 * nfam * B
    BM, BN, BKH, TH = k10.BM, k10.BN, k10.BKH, k10.THREADS
    BK, NF, CI = 2 * BKH, k10.NFAM_MAX, k10.CI_ROWS
    g = ((ga_re, ga_im), (gb_re, gb_im))
    out = np.full((M, N), np.nan)
    cover = np.zeros((M, N, K), dtype=np.int64)
    tid = np.arange(TH)
    kq = tid % BKH
    # a thread's products: rows (tid + TH p) / BKH, frequency kq
    e = tid[:, None] + TH * np.arange(BM * BKH // TH)
    row_l, kq_p = e // BKH, np.broadcast_to(kq[:, None], e.shape)
    for m0 in range(0, M, BM):
        b0 = m0 // (6 * nfam)
        r = m0 + row_l
        a, f, s = r % 3, (r // 3) % nfam, (r // (3 * nfam)) % 2
        c_row = np.where(r < M, (r // (6 * nfam) - b0) * 6 + 2 * a, CI)
        g_row = np.where(r < M, CI + (s * NF + f) * 2, CI)
        for n0 in range(0, N, BN):
            acc = np.zeros((BM, BN))
            for kt in range(-(-half // BKH)):
                A = np.full((BM, BK), np.nan)
                Ds = np.full((BK, BN), np.nan)
                raw = np.full((k10.RAW_ROWS, BKH), np.nan)
                k = kt * BKH + kq
                # the staged rows: row tid / BKH + (TH / BKH) i, column kq
                for i in range(-(-k10.RAW_ROWS // (TH // BKH))):
                    for t_ in tid:
                        row = t_ // BKH + TH // BKH * i
                        src = None
                        if row < CI:
                            b = b0 + row // 6
                            if b < B:
                                src = ci[b, row % 6 // 2,
                                         (row % 2) * half:][:half]
                        else:
                            q = row - CI
                            s_, f_ = q // (2 * NF), q % (2 * NF) // 2
                            if f_ < nfam:
                                src = g[s_][q % 2][f_]
                        ok = src is not None and k[t_] < half
                        raw[row, kq[t_]] = src[k[t_]] if ok else 0.0
                cr = np.where(c_row < CI, raw[np.minimum(c_row, CI - 1),
                                              kq_p], 0.0)
                cm = np.where(c_row < CI, raw[np.minimum(c_row, CI - 1) + 1,
                                              kq_p], 0.0)
                wr, wi = raw[g_row, kq_p], raw[g_row + 1, kq_p]
                A[row_l, kq_p] = cr * wr - cm * wi
                A[row_l, BKH + kq_p] = cr * wi + cm * wr
                # the ring: chunk (row j, column pair) of the stage
                j = (tid // (BN // 2))[:, None] + (TH // (BN // 2)) \
                    * np.arange(BK * BN // 2 // TH)
                col = np.broadcast_to(2 * (tid % (BN // 2))[:, None],
                                      j.shape)
                kd = kt * BKH + j % BKH
                okd = (n0 + col < N) & (kd < half)
                src = (j // BKH) * half + kd
                for dc in (0, 1):
                    Ds[j, col + dc] = np.where(
                        okd, D[np.where(okd, src, 0),
                               np.where(okd, n0 + col + dc, 0)], 0.0)
                # warp (wm, wn): rows WM wm .., columns WN wn ..; atoms
                # of 16 rows x 8 columns; m16n8k8 steps over the stage's K
                seen = np.zeros((BM, BN, BK), dtype=np.int64)
                for w in range(TH // 32):
                    wm, wn = divmod(w, BN // k10.WN)
                    for im, jn in np.ndindex(k10.WM // 16, k10.WN // 8):
                        r0 = k10.WM * wm + 16 * im
                        c0 = k10.WN * wn + 8 * jn
                        rs, cs = slice(r0, r0 + 16), slice(c0, c0 + 8)
                        for k8 in range(0, BK, 8):
                            acc[rs, cs] += A[rs, k8:k8 + 8] @ Ds[k8:k8 + 8,
                                                                 cs]
                            seen[rs, cs, k8:k8 + 8] += 1
                # stage column kcol is sab's column (kcol // BKH) half + kf
                rows, cols = min(BM, M - m0), min(BN, N - n0)
                for kcol in range(BK):
                    kf = kt * BKH + kcol % BKH
                    if kf < half:
                        cover[m0:m0 + rows, n0:n0 + cols,
                              (kcol // BKH) * half + kf] += \
                            seen[:rows, :cols, kcol]
            out[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
    return out.reshape(B, 2, nfam, 3, N), cover


@pytest.mark.parametrize("B,nfam,nk,np_factor", [
    (1, 7, 37, 4), (3, 14, 16, 4), (2, 7, 12, 8), (5, 1, 16, 4),
    (23, 1, 12, 4)])
def test_tab_leg_tiling_covers_once_and_zero_fills(B, nfam, nk, np_factor):
    """K10's tiling on ragged shapes (rows, columns and frequencies that
    end mid-tile; with one family a tile's 64 rows touch 12 lanes, the
    most its staged rows hold): every (row, column, K) product once, and
    the tiles' edges zero in both operands, so the model starting from NaN
    stages equals the plain version within its bound."""
    tc = TCfg(nk=nk, np_factor=np_factor)
    ec = tf.engine_consts(tc, "cpu")
    rng = np.random.default_rng(B * nfam + nk)
    half = tc.npts // 2
    ci = torch.as_tensor(rng.standard_normal((B, 3, 2 * half)))
    g = (ec.ga_re, ec.ga_im, ec.gb_re, ec.gb_im)
    tab, cover = _tab_leg_model(ci.numpy(), *(x.numpy() for x in g),
                                ec.dft_bwd_half.numpy(), nfam)
    assert np.all(cover == 1)
    ref, bound = k10.error_bound(ci, *g, ec.dft_bwd_half, nfam)
    assert bool(np.isfinite(tab).all())
    assert np.all(np.abs(tab - ref.numpy()) <= bound.numpy())


@pytest.mark.parametrize("nk,npts,nc", [(128, 512, 512), (512, 2048, 2048),
                                        (37, 148, 148), (16, 64, 64),
                                        (48, 384, 384), (512, 4096, 4096)])
def test_engine_front_tiling_covers_once(nk, npts, nc):
    """K9's split (csrc/engine_front.cu, engine_front.grid): the ranks of
    every cluster extend each m of the grid once, the blocks own each
    column of ci once (with a cluster of blocks a lane group, the column
    tiles rounded up to whole clusters), and a column's PARTS threads sum
    each m once; one block's shared memory stays within the SM's, with
    one lane a cluster at every grid the solver takes."""
    grid_x, ms = k9.grid(nk, npts, nc)
    assert grid_x % k9.CLUSTER == 0
    assert k9.smem_bytes(1, nk, npts) <= k9.SMEM_MAX
    for q in range(grid_x // k9.CLUSTER):
        m_seen = np.concatenate([np.arange(r * ms, min(npts, (r + 1) * ms))
                                 for r in range(k9.CLUSTER)])
        np.testing.assert_array_equal(m_seen, np.arange(npts))
    n = (np.arange(grid_x)[:, None] * k9.COLS
         + np.arange(k9.COLS)).ravel()
    np.testing.assert_array_equal(n[n < nc], np.arange(nc))
    kc = -(-npts // k9.PARTS)
    parts = np.concatenate([np.arange(p * kc, min(npts, (p + 1) * kc))
                            for p in range(k9.PARTS)])
    np.testing.assert_array_equal(parts, np.arange(npts))


@pytest.mark.parametrize("B,clusters,want", [
    (16, 15, 2), (15, 15, 1), (8, 15, 1), (2, 15, 1), (64, 15, 2),
    (16, 0, 1), (16, 16, 1)])
def test_engine_front_takes_two_lanes_a_cluster_only_to_save_a_wave(
        B, clusters, want):
    """Two lanes a cluster halve the clusters and double each one's
    work: the wrapper takes them only where one lane a cluster needs more
    waves of the clusters the device runs at once (15 on an H100), and
    never where two lanes' rows overflow shared memory."""
    assert k9.lanes(B, 128, 512, 512, lambda n: clusters) == want
    assert k9.lanes(64, 512, 4096, 4096, lambda n: 15) == 1


# --- the wrappers --------------------------------------------------------

def _front_args(B=2, nk=16, npts=64, nc=64):
    rng = np.random.default_rng(3)
    t = lambda *s: torch.as_tensor(rng.standard_normal(s))
    return [t(B, 3, nk), t(B), t(npts, nk), t(npts), t(npts), t(npts),
            t(npts, nc)]


def _tab_args(B=2, half=8, N=32):
    rng = np.random.default_rng(4)
    t = lambda *s: torch.as_tensor(rng.standard_normal(s))
    return [t(B, 3, 2 * half), t(14, half), t(14, half), t(14, half),
            t(14, half), t(2 * half, N)]


def test_wrappers_validate_and_cpu_takes_plain():
    before = counts.snapshot()
    args = _front_args()
    for got, want in zip(k9.engine_front(*args, clip=True),
                         k9.engine_front_plain(*args, clip=True)):
        assert torch.equal(got, want)
    targs = _tab_args()
    assert torch.equal(k10.tab_leg(*targs, 7),
                       k10.tab_leg_plain(*targs, 7))
    assert counts.snapshot() == before      # the plain path never counts
    bad_front = [
        (TypeError, 0, lambda x: x.float()),            # dtype
        (ValueError, 0, lambda x: x[:, :2]),            # shape
        (ValueError, 1, lambda x: x[:1]),
        (ValueError, 2, lambda x: x[:, :5]),
        (ValueError, 3, lambda x: x[:7]),
        (ValueError, 6, lambda x: x[:9]),
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
    stride and its shared memory must fit; K10's 2np must be even."""
    args = _front_args()
    bad = list(args)
    bad[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="column stride"):
        k9._check_kernel_shape(bad[0], *args[2:])
    k9._check_kernel_shape(args[0][:, :, :8], *_front_args(nk=8)[2:])
    big = _front_args(nk=16, npts=9472, nc=16)
    with pytest.raises(ValueError, match="shared memory"):
        k9._check_kernel_shape(big[0], *big[2:])


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
