"""The PyTorch port's off-by-default numerics and library surface against
the JAX package: `ode.integrate_nodes` / `integrate_dense`, the
`growth_dense` growth tables, `quad_impl='gl'` prepare, the comoving
distance table and `h0_chi`, `background.w_de` / `Omega_m_a` and
`interp.interp1_vec` / `interp2`.

Bounds: the integrators run the same controller arithmetic (one
controller per lane against JAX's vmapped loop), so the attempt counts
are equal and rows agree within 1e-12 (the packages sum the stages in
other orders, and the ulps add up over the pendulum's 23 nodes to
~4e-13); the prepared tables within 1e-10
relative, norm and sigmaV2_z0 within 1e-12 (as tests/test_torch_model.py
holds the default path); the closed-form functions within a few ulp
(5e-15 relative, the comoving table 1e-13: a 1000-panel cumulative sum).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import jax_batch, port_inputs
from redtime_tpu import background as jbg
from redtime_tpu import interp as jinterp
from redtime_tpu import model as jm
from redtime_tpu import ode as jode
from redtime_tpu.config import SolverConfig as JCfg
from redtime_tpu_torch import background as tbg
from redtime_tpu_torch import interp as tinterp
from redtime_tpu_torch import model as tm
from redtime_tpu_torch import ode as tode
from redtime_tpu_torch import state
from redtime_tpu_torch.config import SolverConfig as TCfg

NK = 32
NODES = np.linspace(0.5, 8.0, 23)
Y0 = np.array([[1.2, 0.0], [0.4, 0.3], [2.0, -0.5]])


def _pendulum_jax(t, y):
    return jnp.array([y[1], -jnp.sin(y[0])])


def _pendulum_torch(t, y):
    return torch.stack([y[:, 1], -torch.sin(y[:, 0])], dim=1)


def test_integrate_nodes_matches_jax():
    """Three pendulum lanes through 23 stop nodes (tests/test_ode.py's
    case): the same attempts per lane, rows within 1e-12."""
    def one(y0):
        return jode.integrate_nodes(_pendulum_jax, 0.0, jnp.asarray(NODES),
                                    y0, 0.01, 0.0, 1e-8, jode.DOPRI5,
                                    return_stats=True)

    rows_j, h_j, n_j = jax.vmap(one)(jnp.asarray(Y0))
    rows, h, n = tode.integrate_nodes(_pendulum_torch, 0.0, NODES,
                                      torch.as_tensor(Y0), 0.01, 0.0, 1e-8,
                                      tode.DOPRI5, return_stats=True)
    assert rows.shape == (3, len(NODES), 2)
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(rows.numpy(), np.asarray(rows_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), rtol=1e-6)


def test_integrate_nodes_equals_a_chain_of_intervals():
    """The one loop of attempts gives, bit for bit, the rows and the step
    of integrate_interval chained over the node segments with h carried
    (redtime_tpu/ode.py:207-212)."""
    y0 = torch.as_tensor(Y0)
    rows, hf = tode.integrate_nodes(_pendulum_torch, 0.0, NODES, y0, 0.01,
                                    0.0, 1e-8, tode.DOPRI5)
    y, h, t = y0, 0.01, 0.0
    exp = []
    for t1 in NODES:
        y, h = tode.integrate_interval(_pendulum_torch, t, float(t1), y, h,
                                       0.0, 1e-8, tode.DOPRI5)
        exp.append(y)
        t = float(t1)
    assert torch.equal(rows, torch.stack(exp, dim=1))
    assert torch.equal(hf, h)


def test_integrate_nodes_truncation_poisons():
    """Rows from the first node a lane did not reach are NaN."""
    rows, _ = tode.integrate_nodes(lambda t, y: -y, 0.0, [1.0, 2.0, 3.0],
                                   torch.ones((2, 1), dtype=torch.float64),
                                   0.01, 0.0, 1e-8, tode.DOPRI5,
                                   max_steps=25)
    r = rows.numpy()
    assert np.isfinite(r[:, 0]).all() and np.isnan(r[:, -1]).all()


def test_integrate_dense_matches_jax_and_the_exact_solution():
    """y' = -t y from 0 to 3, dense output at 12 nodes, the last on t1:
    within 1e-12 of JAX's vmapped integrate_dense with the same attempts,
    and within 3e-8 of exp(-t^2/2) (tests/test_ode.py's bound)."""
    xs = np.linspace(0.25, 3.0, 12)
    y0 = np.array([[1.0, 2.0], [0.5, -1.0]])

    def one(y):
        return jode.integrate_dense(lambda t, yy: -yy * t, 0.0, 3.0, y,
                                    0.01, 0.0, 1e-9, jnp.asarray(xs),
                                    jode.DOPRI5, return_stats=True)

    tab_j, y1_j, _, n_j = jax.vmap(one)(jnp.asarray(y0))
    tab, y1, _, n = tode.integrate_dense(
        lambda t, y: -y * t[:, None], 0.0, 3.0, torch.as_tensor(y0), 0.01,
        0.0, 1e-9, xs, tode.DOPRI5, return_stats=True)
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(tab.numpy(), np.asarray(tab_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(y1.numpy(), np.asarray(y1_j), rtol=0,
                               atol=1e-13)
    exact = np.exp(-xs[None, :, None] ** 2 / 2) * y0[:, None, :]
    np.testing.assert_allclose(tab.numpy(), exact, rtol=3e-8)


def test_integrate_dense_refuses_other_tableaux_and_poisons():
    y0 = torch.ones((1, 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="DOPRI5"):
        tode.integrate_dense(lambda t, y: -y, 0.0, 1.0, y0, 0.01, 0.0,
                             1e-8, [0.5, 1.0], tode.RKF45)
    tab, y1, _ = tode.integrate_dense(lambda t, y: -y, 0.0, 3.0, y0, 0.01,
                                      0.0, 1e-8, [1.0, 3.0], tode.DOPRI5,
                                      max_steps=5)
    assert np.isnan(tab.numpy()).all() and np.isnan(y1.numpy()).all()


@pytest.mark.parametrize("kw", [dict(growth_dense=True),
                                dict(quad_impl="gl"),
                                dict(growth_dense=True, quad_impl="gl")],
                         ids=["growth_dense", "gl", "both"])
def test_prepare_with_the_numerics_matches_jax(kw):
    """prepare_model at nk=32 over 3 cosmologies (massive nu) with the
    dense growth integration and / or the Gauss-Legendre quadratures:
    every table within 1e-10 relative, norm and sigmaV2_z0 within 1e-12
    (tests/test_ode.py holds JAX's dense tables to its node-stopped
    ones)."""
    jc = JCfg(nk=NK, **kw)
    cosmos, lins = jax_batch(3, jc)
    mj = jax.jit(jax.vmap(lambda c, l: jm.prepare_model(jc, c, l)))(
        cosmos, lins)
    mt = tm.prepare_model(TCfg(nk=NK, **kw), *port_inputs(cosmos, lins))
    for name in ("g_G", "g_dDda", "g_Dnorm", "T_solver", "beta_solver"):
        np.testing.assert_allclose(getattr(mt, name).numpy(),
                                   np.asarray(getattr(mj, name)), rtol=1e-10,
                                   atol=0, err_msg=name)
    for name in ("norm", "sigmaV2_z0"):
        np.testing.assert_allclose(getattr(mt, name).numpy(),
                                   np.asarray(getattr(mj, name)), rtol=1e-12,
                                   atol=0, err_msg=name)


def test_growth_dense_is_ignored_under_h_reset():
    cosmos, lins = jax_batch(1, JCfg(nk=NK))
    c, lin = port_inputs(cosmos, lins)
    cfg = TCfg(nk=NK, growth_n_lna=20, growth_h_reset=True)
    _, G_a, _ = tm.build_growth_tables(cfg, c, lin)
    _, G_b, _ = tm.build_growth_tables(
        dataclasses.replace(cfg, growth_dense=True), c, lin)
    assert torch.equal(G_a, G_b)


def test_quad_nodes_bit_identical():
    for cfg_kw in (dict(), dict(quad_panels=8, quad_order=8)):
        nj, wj = jm.quad_nodes(JCfg(**cfg_kw))
        nt, wt = tm.quad_nodes(TCfg(**cfg_kw))
        np.testing.assert_array_equal(nt, nj)
        np.testing.assert_array_equal(wt, wj)


def test_comoving_distance_and_h0_chi_match_jax():
    """The H0 chi(eta) table of two cosmologies within 1e-13 relative;
    h0_chi at z = 0.5 and 3 (the table) and below z = 1e-4 (z itself)."""
    cosmos, _ = jax_batch(2, JCfg(nk=NK))
    c = state.cosmo_from_numpy(cosmos)
    a_in = 1.0 / 201.0
    eta_t, chi_t = tm.comoving_distance_table(TCfg(), c, a_in)
    for b in range(2):
        cb = jax.tree_util.tree_map(lambda x: x[b], cosmos)
        eta_j, chi_j = jm.comoving_distance_table(JCfg(), cb, a_in)
        np.testing.assert_array_equal(eta_t.numpy(), np.asarray(eta_j))
        np.testing.assert_allclose(chi_t[b].numpy(), np.asarray(chi_j),
                                   rtol=1e-13, atol=0)
        for z in (0.5, 3.0, 5e-5):
            eta = np.log((1.0 / (1.0 + z)) / a_in)
            got = tm.h0_chi(TCfg(), c, a_in, eta)[b].item()
            want = float(jm.h0_chi(JCfg(), cb, a_in, eta))
            assert got == pytest.approx(want, rel=1e-13, abs=0), z
    eta = torch.as_tensor([np.log(1.0 / 1.5 / a_in), np.log(0.25 / a_in)])
    both = tm.h0_chi(TCfg(), c, a_in, eta)
    assert both[0] < both[1]


def test_w_de_and_omega_m_a_match_jax():
    cosmos, _ = jax_batch(3, JCfg(nk=NK))
    c = state.cosmo_from_numpy(cosmos)
    a = np.array([[1e-3, 0.1, 0.5, 1.0, 1.1]] * 3)
    w_t = tbg.w_de(c, torch.as_tensor(a)).numpy()
    om_t = tbg.Omega_m_a(c, torch.as_tensor(a)).numpy()
    w_j = jax.vmap(jbg.w_de)(cosmos, jnp.asarray(a))
    om_j = jax.vmap(jbg.Omega_m_a)(cosmos, jnp.asarray(a))
    np.testing.assert_allclose(w_t, np.asarray(w_j), rtol=5e-15, atol=0)
    np.testing.assert_allclose(om_t, np.asarray(om_j), rtol=5e-15, atol=0)
    assert np.all((om_t > 0) & (om_t < 1.0 + 1e-12))


def test_interp1_vec_and_interp2_match_jax():
    """Interior (cubic), edge (linear) and extrapolated points of a 1-D
    table and a 2-D table, against the JAX functions point by point."""
    rng = np.random.default_rng(11)
    xn = np.sort(rng.uniform(0.0, 3.0, 9))
    yn = np.linspace(-1.0, 1.0, 7)
    vals = np.sin(xn)
    table = np.cos(xn[:, None]) * np.exp(yn[None, :])
    xq = np.concatenate([[xn[0] - 0.2], rng.uniform(xn[0], xn[-1], 15),
                         [xn[-1] + 0.3]])
    yq = np.concatenate([[yn[0] - 0.1], rng.uniform(-1.0, 1.0, 15),
                         [yn[-1] + 0.2]])
    got1 = tinterp.interp1_vec(torch.as_tensor(xn), torch.as_tensor(vals),
                               torch.as_tensor(xq)).numpy()
    want1 = np.asarray(jinterp.interp1_vec(jnp.asarray(xn),
                                           jnp.asarray(vals),
                                           jnp.asarray(xq)))
    np.testing.assert_allclose(got1, want1, rtol=5e-15, atol=5e-16)
    got2 = tinterp.interp2(torch.as_tensor(xn), torch.as_tensor(yn),
                           torch.as_tensor(table), torch.as_tensor(xq),
                           torch.as_tensor(yq)).numpy()
    want2 = np.array([float(jinterp.interp2(jnp.asarray(xn),
                                            jnp.asarray(yn),
                                            jnp.asarray(table), x, y))
                      for x, y in zip(xq, yq)])
    np.testing.assert_allclose(got2, want2, rtol=5e-15, atol=5e-16)
    one = tinterp.interp2(torch.as_tensor(xn), torch.as_tensor(yn),
                          torch.as_tensor(table), torch.tensor(xq[3]),
                          torch.tensor(yq[3]))
    assert one.shape == () and one.item() == got2[3]
