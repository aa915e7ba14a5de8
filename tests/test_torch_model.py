"""The PyTorch port's model preparation against the JAX package's.

prepare_model at nk=32 (one adaptive growth controller and one GK61
quadrature per lane): every Model field within 1e-10 relative, norm and
sigmaV2_z0 within 1e-12.  The lookups (growth_D_f, plin_all,
beta_P_solver, sigma_v2) on a JAX-prepared Model carried through
state.py: within 1e-13 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import jax_batch, port_inputs
from redtime_tpu import model as jm
from redtime_tpu import quadrature as jq
from redtime_tpu.config import CosmoParams as JCosmo
from redtime_tpu.config import SolverConfig as JCfg
from redtime_tpu_torch import model as tm
from redtime_tpu_torch import quadrature as tq
from redtime_tpu_torch import state
from redtime_tpu_torch.config import SolverConfig as TCfg

NK = 32


@functools.lru_cache(maxsize=4)
def _prepared(nu: bool, n: int = 3):
    jc = JCfg(nk=NK)
    cosmos, lins = jax_batch(n, jc, nu)
    mj = jax.jit(jax.vmap(lambda c, l: jm.prepare_model(jc, c, l)))(
        cosmos, lins)
    mt = tm.prepare_model(TCfg(nk=NK), *port_inputs(cosmos, lins))
    return mj, mt


def _assert_rel(got, ref, rtol, name):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=0, err_msg=name)


@pytest.mark.parametrize("nu", [True, False], ids=["massive_nu",
                                                   "massless_nu"])
def test_prepare_model_matches_jax(nu):
    mj, mt = _prepared(nu)
    for name in ("g_lna", "g_G", "g_dDda", "g_Dnorm", "beta_a",
                 "beta_solver", "T_solver"):
        _assert_rel(getattr(mt, name), getattr(mj, name), 1e-10, name)
    _assert_rel(mt.norm, mj.norm, 1e-12, "norm")
    _assert_rel(mt.sigmaV2_z0, mj.sigmaV2_z0, 1e-12, "sigmaV2_z0")


def test_prepare_model_dnorm_rescale_guard():
    """A ramp from a_early = 1e-50 leaves the stored growth-table scale
    near 1e-45, below the guard's 1e-25; both packages rescale by Dnorm
    (redtime_tpu/model.py:447-466) and the tables agree."""
    jc = JCfg(nk=NK, growth_n_lna=20, a_early=1e-50)
    from __graft_entry__ import _example_inputs
    lin = _example_inputs(jc)
    c = JCosmo.make(n_s=0.96, sigma_8=0.8, h=0.68, Omega_m=0.3,
                    Omega_b=0.048, Omega_nu=0.005)
    cs = jax.tree_util.tree_map(lambda x: jnp.stack([x]), c)
    ls = jax.tree_util.tree_map(lambda x: jnp.stack([jnp.asarray(x)]), lin)
    mj = jax.jit(jax.vmap(lambda cc, ll: jm.prepare_model(jc, cc, ll)))(
        cs, ls)
    mt = tm.prepare_model(TCfg(nk=NK, growth_n_lna=20, a_early=1e-50),
                          *port_inputs(cs, ls))
    raw_scale = np.abs(np.asarray(mj.g_Dnorm)).max()
    assert abs(raw_scale - 1.0) < 1e-12     # the guard fired (Dnorm -> 1)
    for name in ("g_G", "g_dDda", "g_Dnorm"):
        _assert_rel(getattr(mt, name), getattr(mj, name), 1e-10, name)


@pytest.mark.parametrize("z", [0.0, 0.43, 2.02, 10.0, 200.0])
def test_lookups_on_a_jax_model_match(z):
    jc = JCfg(nk=NK)
    mj, _ = _prepared(True)
    mt = state.model_from_numpy(mj)
    D, dDda = tm.growth_D_f(mt, z)
    P, Pcb, Pnu = tm.plin_all(TCfg(nk=NK), mt, z)
    beta = tm.beta_P_solver(mt, 1.0 / (1.0 + z))
    sv2 = tm.sigma_v2(mt, z)
    for b in range(3):
        m = jax.tree_util.tree_map(lambda x: x[b], mj)
        Dj, dDj = jm.growth_D_f(m, z)
        for got, ref in zip((D, dDda, *(x for x in (P, Pcb, Pnu)),
                             beta, sv2),
                            (Dj, dDj, *jm.plin_all(jc, m, z),
                             jm.beta_P_solver(m, 1.0 / (1.0 + z)),
                             jm.sigma_v2(m, z))):
            np.testing.assert_allclose(got[b].numpy(), np.asarray(ref),
                                       rtol=1e-13, atol=0)


def test_model_from_numpy_single_and_batched():
    mj, _ = _prepared(True)
    one = jax.tree_util.tree_map(lambda x: x[1], mj)
    m1 = state.model_from_numpy(one)
    m3 = state.model_from_numpy(mj)
    assert m1.batch == 1 and m3.batch == 3
    for name in tm.Model._fields[1:]:
        np.testing.assert_array_equal(getattr(m1, name)[0].numpy(),
                                      getattr(m3, name)[1].numpy())
    np.testing.assert_array_equal(m1.cosmo.n_s.numpy(),
                                  np.asarray(mj.cosmo.n_s[1:2]))


def test_qag_gk61_matches_jax_per_lane():
    """Adaptive GK61 with per-lane integrands that need different numbers
    of bisections (sharper peaks bisect more)."""
    widths = np.array([1.0, 0.05, 0.003])

    def f_t(x):
        w = torch.as_tensor(widths)[:, None]
        return torch.exp(-x * x / (2 * w * w)) + 0.1 * torch.sin(3 * x)

    got, err = tq.qag_gk61(f_t, -2.0, 3.0, 3, "cpu", 0.0, 1e-10, 200)
    for b, w in enumerate(widths):
        ref, ref_err = jq.qag_gk61(
            lambda x: jnp.exp(-x * x / (2 * w * w)) + 0.1 * jnp.sin(3 * x),
            -2.0, 3.0, 0.0, 1e-10, 200)
        np.testing.assert_allclose(float(got[b]), float(ref), rtol=1e-14)
        np.testing.assert_allclose(float(err[b]), float(ref_err), rtol=1e-6)
    # a lane that runs out of intervals is poisoned, the others are not
    got, _ = tq.qag_gk61(f_t, -2.0, 3.0, 3, "cpu", 0.0, 1e-10, 3)
    assert np.isnan(float(got[1]))
    assert np.isfinite(float(got[0])) and np.isfinite(float(got[2]))
