"""The PyTorch port's FAST-PT engine (windowed GEMM form, with the plain
versions of the K1 out_leg and K2 pz_leg kernels on the CPU) against the
JAX package's engine in both of its modes.

* Host constants: the port builds them with the JAX package's numpy
  formulas, so they are bit-identical; the composite output matrix G
  matches the formula at redtime_tpu/fastpt.py:413-418 to 1e-15 of its
  maximum.
* J and J_lo: within 1e-11 of each (family, a, b) maximum against JAX's
  FFT path (mode='fft', the CPU default, which runs the full engine and
  slices) and its matmul path with every leg set to 'dot' (the f64 dots
  of the TPU form).  The bound covers the composite matrix's different
  rounding of the same linear map.
* PZ: within the f64 dot-product forward-error bound
  2np eps (|T| @ |P_e|) |kfac P_e| — a max-relative bound would be wrong,
  the Toeplitz contraction cancels ~1e8 of its operand scale per element.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import jax_batch
from redtime_tpu import fastpt as jf
from redtime_tpu import model as jm
from redtime_tpu.config import SolverConfig as JCfg
from redtime_tpu_torch import fastpt as tf
from redtime_tpu_torch.config import SolverConfig as TCfg
from redtime_tpu_torch.grids import make_grids

EPS = np.finfo(np.float64).eps
DOT = dict(out_leg="dot", tab_leg="dot", pz_leg="dot", fwd_leg="dot")


@pytest.mark.parametrize("nk", [32, 64])
def test_engine_consts_bit_identical(nk):
    jc, tc = JCfg(nk=nk), TCfg(nk=nk)
    co_j, co_t = jf.fastpt_coeffs(jc), tf.fastpt_coeffs(tc)
    for name in co_j._fields:
        np.testing.assert_array_equal(getattr(co_t, name),
                                      getattr(co_j, name), err_msg=name)
    g = jf.make_grids(jc)
    fwd_j, bwd_j = jf._half_leg_consts(jc)
    M_j, v_j = jf._pab_ext(jc)
    ref = dict(pab_M=M_j, pab_v=v_j, wp=g.wp, kbias=co_j.kbias,
               dft_fwd_half=fwd_j, ga_re=co_j.ga_re, ga_im=co_j.ga_im,
               gb_re=co_j.gb_re, gb_im=co_j.gb_im, dft_bwd_half=bwd_j,
               toeplitz_sl=co_j.toeplitz[:, g.nshift:g.nshift + nk, :],
               pz_kfac_sl=co_j.pz_kfac[g.nshift:g.nshift + nk])
    got = tf.engine_consts_np(tc)
    assert set(got) == set(ref) | {"G"}
    for name, arr in ref.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    for a, b in zip(tf._restricted_out_consts(tc),
                    jf._restricted_out_consts(jc)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tf._out_columns(g), jf._out_columns(g))
    # the device pack holds exactly these arrays
    ec = tf.engine_consts(tc, "cpu")
    for name in ref:
        np.testing.assert_array_equal(getattr(ec, name).numpy(), got[name])


@pytest.mark.parametrize("nk", [32, 64])
def test_composite_G_matches_formula(nk):
    """G_f = (FC (fr Bc + fi Bs) + (-FS)(fr Bs - fi Bc)) prek_f, from the
    JAX package's own numpy constants."""
    jc = JCfg(nk=nk)
    g = jf.make_grids(jc)
    co = jf.fastpt_coeffs(jc)
    fwd, bwd = jf._restricted_out_consts(jc)
    n2h = g.npts + 1
    FC, FSn, Bc, Bs = fwd[:, :n2h], fwd[:, n2h:], bwd[:n2h], bwd[n2h:]
    prek = co.prek[:, jf._out_columns(g)]
    G = tf.composite_out_matrix(TCfg(nk=nk))
    assert G.shape == (jf.NFAM, 2 * g.npts, nk + 1)
    for f in range(jf.NFAM):
        fr, fi = co.fh_re[f][:, None], co.fh_im[f][:, None]
        ref = (FC @ (fr * Bc + fi * Bs) + FSn @ (fr * Bs - fi * Bc)) \
            * prek[f][None, :]
        np.testing.assert_allclose(G[f], ref, rtol=0,
                                   atol=1e-15 * np.abs(ref).max())


@functools.lru_cache(maxsize=2)
def _spectra(nk: int):
    """lnP [2, 3, nk] of two prepared cosmologies (the linear cb spectrum
    at z = 2 and 0, rows scaled by growth-rate-like factors) and their n_s,
    from the JAX package's prepare_model."""
    jc = JCfg(nk=nk)
    cosmos, lins = jax_batch(2, jc)
    ms = jax.jit(jax.vmap(lambda c, l: jm.prepare_model(jc, c, l)))(
        cosmos, lins)
    out = []
    for b, z in enumerate((2.0, 0.0)):
        m = jax.tree_util.tree_map(lambda x: x[b], ms)
        _, Pcb, _ = jm.plin_all(jc, m, z)
        lp = np.log(np.asarray(Pcb))
        out.append(np.stack([lp, lp + np.log(0.8), lp + 2 * np.log(0.8)]))
    return np.stack(out), np.asarray(cosmos.n_s[:2])


@pytest.mark.parametrize("nk", [32, 64])
@pytest.mark.parametrize("mode", ["fft", "matmul"])
def test_engine_matches_jax(nk, mode):
    jc = JCfg(nk=nk, **(DOT if mode == "matmul" else {}))
    tc = TCfg(nk=nk)
    lnP, ns = _spectra(nk)
    ec_t = tf.engine_consts(tc, "cpu")
    P_t = tf.extend_power(tc, torch.tensor(lnP), torch.tensor(ns),
                          ec_t)
    Jw, J_lo, PZw = tf.compute_J_PZ_windowed(tc, P_t, True, ec_t)
    assert Jw.shape == (2, jf.NFAM, 3, 3, nk) and J_lo.shape == (2,)
    assert PZw.shape == (2, 7, 3, 3, nk)
    ec_j = jf.engine_consts(jc, mode)
    g = jf.make_grids(jc)
    sl = slice(g.nshift, g.nshift + nk)
    for b in range(2):
        P_j = jf.extend_power(jc, jnp.asarray(lnP[b]), ns[b], ec_j)
        np.testing.assert_allclose(P_t[b].numpy(), np.asarray(P_j),
                                   rtol=1e-14, atol=0)
        J, lo, PZ = (np.asarray(x) for x in jf.compute_J_PZ_windowed(
            jc, P_j, True, mode, ec_j))
        scale = np.abs(J).max(axis=-1, keepdims=True) + 1e-300
        assert np.max(np.abs(Jw[b].numpy() - J) / scale) < 1e-11
        assert abs(float(J_lo[b]) - float(lo)) < 1e-11 * scale[0, 0, 0, 0]
        P = np.asarray(P_j)
        T = np.asarray(ec_t.toeplitz_sl)
        bound = (2 * g.npts * EPS * np.einsum("nim,am->nai", np.abs(T),
                                               np.abs(P))[:, :, None, :]
                 * np.abs(np.asarray(ec_t.pz_kfac_sl) * P[None, :, sl]))
        assert np.all(np.abs(PZw[b].numpy() - PZ) <= bound)


def test_engine_without_rsd_zeroes_the_rsd_families():
    """Without RSD the seven Jn0 families are zero and the other seven
    are the same map as with RSD.  The tab leg (sab @ dft_bwd_half) and
    the output leg contract 7 or 14 families in one GEMM each, and the
    CPU's f64 GEMM (MKL) blocks by the operands' shapes, so the two
    agree within twice the forward-error bound of that chain: the tab
    leg's np-term dots (|delta tab| <= np eps |sab| @ |D|, D =
    dft_bwd_half), the pair product and the output leg's 2np-term dot,
    (2 np + 4 + 2np) eps (|tab_a| |tab_c| / 2np) @ |G| with |tab|
    bounded by |sab| @ |D|.  The PZ leg does not depend on the families:
    the same bits."""
    tc = TCfg(nk=32)
    lnP, ns = _spectra(32)
    ec = tf.engine_consts(tc, "cpu")
    P = tf.extend_power(tc, torch.tensor(lnP), torch.tensor(ns), ec)
    J7, lo7, PZ7 = tf.compute_J_PZ_windowed(tc, P, False, ec)
    J14, lo14, PZ14 = tf.compute_J_PZ_windowed(tc, P, True, ec)
    assert torch.all(J7[:, 7:] == 0)
    # |tab| bound of the first 7 families and the output leg's |.| map
    g = make_grids(tc)
    half, K = g.npts // 2, 2 * g.npts
    Pn = P.numpy()
    ci = (Pn * ec.kbias.numpy()) @ ec.dft_fwd_half.numpy()
    ca = np.abs(ci[:, None, :, :half] + 1j * ci[:, None, :, half:])
    gam = [np.abs(getattr(ec, f"g{s}_re").numpy()[:7, None]
                  + 1j * getattr(ec, f"g{s}_im").numpy()[:7, None])
           for s in "ab"]
    # |s_r|, |s_i| <= |ca| |g| (the coefficients' complex products)
    sab = np.stack([np.concatenate([ca * g_] * 2, axis=-1) for g_ in gam],
                   axis=1)                          # [B, 2, 7, 3, 2 half]
    tab_abs = sab @ np.abs(ec.dft_bwd_half.numpy())  # [B, 2, 7, 3, 2np]
    prod = tab_abs[:, 0, :, :, None, :] * tab_abs[:, 1, :, None, :, :] / K
    G = np.abs(ec.G.numpy()[:7])
    lin = (prod.reshape(2, 7, 9, K) @ G).reshape(2, 7, 3, 3, -1)
    bound = 2 * (2 * (g.npts + 2) + K) * EPS * lin
    # the bound's own rounding: one more relative eps of margin
    bound *= 1 + 4 * K * EPS
    err = (J7[:, :7] - J14[:, :7]).abs().numpy()
    assert np.all(err <= bound[..., :32])
    assert abs(float(lo7[0] - lo14[0])) <= bound[0, 0, 0, 0, 32]
    assert abs(float(lo7[1] - lo14[1])) <= bound[1, 0, 0, 0, 32]
    torch.testing.assert_close(PZ7, PZ14, rtol=0, atol=0)


def test_extend_power_clips_the_extrapolated_log():
    """The clip(-80, 20) of the extended log spectrum binds on rejected
    trial states and decides which of them stay finite."""
    tc = TCfg(nk=32)
    ec = tf.engine_consts(tc, "cpu")
    wild = torch.full((1, 3, 32), 400.0, dtype=torch.float64)
    P = tf.extend_power(tc, wild, torch.tensor([0.96], dtype=torch.float64),
                        ec)
    assert torch.isfinite(P).all()
    assert float(P.max()) <= float(np.exp(20.0))
