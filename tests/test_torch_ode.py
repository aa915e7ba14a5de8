"""The PyTorch port's batched integrator (one GSL controller per lane,
with the plain versions of K3's rk_stage and rk_finish kernels on the CPU)
against the JAX package's vmapped `integrate_interval`.

On a small per-lane ODE both run the same controller arithmetic, so the
attempt counts must be identical and y agree within 1e-13 (BOUNDS below
states the one exception and the step-size bounds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread per worker)
from redtime_tpu import ode as jode
from redtime_tpu_torch import ode as tode
from redtime_tpu_torch.kernels import counts
from redtime_tpu_torch.kernels import rk_finish as k3

TABLEAUX = ("RKF45", "DOPRI5", "DOP853")
# per-lane rates of a damped oscillator + a growing mode: lanes differ in
# stiffness, so each lane's controller takes its own step sequence
RATES = np.array([[0.5, 3.0, 0.2], [1.5, 1.0, 0.4], [4.0, 7.0, -0.3],
                  [0.1, 0.5, 0.9]])


def _rhs_jax(rate):
    def rhs(t, y):
        g, w, s = rate[0], rate[1], rate[2]
        return jnp.stack([y[1], -w * w * y[0] - g * y[1],
                          s * y[2] * jnp.cos(t)])
    return rhs


def _rhs_torch(rates):
    g, w, s = (torch.as_tensor(rates[:, i])[:, None] for i in range(3))

    def rhs(t, y):
        return torch.stack([y[:, 1], -w[:, 0] * w[:, 0] * y[:, 0]
                            - g[:, 0] * y[:, 1],
                            s[:, 0] * y[:, 2] * torch.cos(t)], dim=1)
    return rhs


@pytest.mark.parametrize("name", TABLEAUX)
def test_tableaux_bit_identical(name):
    a, b = getattr(tode, name), getattr(jode, name)
    for f in ("c", "a", "b", "e"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.order == b.order


# (y atol, h rtol) per tableau and tolerance.  y: 1e-13, except DOP853 at
# the loose tolerance, whose large steps carry the step-size difference
# below into y at ~3e-13.  h: the error norm r comes from the estimate
# h sum_j e_j k_j, which cancels most of its terms; the packages sum the
# stages in different orders, so r and the step factor r^(-1/ord) differ
# at ~1e-9 relative (RKF45/DOPRI5) and up to ~5e-5 for DOP853, whose
# 5th-order error weights cancel far more.
BOUNDS = {("RKF45", 0): (1e-13, 1e-7), ("RKF45", 1): (1e-13, 1e-7),
          ("DOPRI5", 0): (1e-13, 1e-6), ("DOPRI5", 1): (1e-13, 1e-6),
          ("DOP853", 0): (1e-13, 1e-4), ("DOP853", 1): (1e-12, 1e-7)}
TOLS = [(1e-10, 1e-8), (1e-7, 1e-2)]


@pytest.mark.parametrize("name", TABLEAUX)
@pytest.mark.parametrize("itol", [0, 1])
def test_integrate_interval_matches_vmapped_jax(name, itol):
    eabs, erel = TOLS[itol]
    y_atol, h_rtol = BOUNDS[name, itol]
    tab_j, tab_t = getattr(jode, name), getattr(tode, name)
    y0 = np.array([[1.0, 0.0, 1.0]] * len(RATES))
    t1 = np.array([2.0, 1.5, 3.0, 2.5])
    h0 = np.array([0.1, 0.02, 0.5, 1e-3])

    def one(rate, y, t_end, h):
        return jode.integrate_interval(
            lambda t, yy: _rhs_jax(rate)(t, yy), 0.0, t_end, y, h, eabs,
            erel, tab_j, return_stats=True)

    yj, hj, nj = jax.jit(jax.vmap(one))(jnp.asarray(RATES), jnp.asarray(y0),
                                        jnp.asarray(t1), jnp.asarray(h0))
    yt, ht, nt = tode.integrate_interval(
        _rhs_torch(RATES), 0.0, torch.as_tensor(t1), torch.tensor(y0),
        torch.as_tensor(h0), eabs, erel, tab_t, return_stats=True)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=y_atol)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=h_rtol)


@pytest.mark.parametrize("max_steps", [40, 41])
def test_truncated_lane_is_poisoned(max_steps):
    """A lane that has not reached t1 at max_steps is NaN (the JAX
    package's truncation guard, redtime_tpu/ode.py:186-193); the others
    are untouched.  The lane stops at max_steps exactly, whether or not
    max_steps is a multiple of the host-check interval ode.CHECK_EVERY."""
    t1 = torch.tensor([0.01, 50.0, 0.02], dtype=torch.float64)
    rates = RATES[:3]
    y, _, n = tode.integrate_interval(
        _rhs_torch(rates), 0.0, t1, torch.ones((3, 3), dtype=torch.float64),
        1e-3, 1e-12, 1e-10, tode.RKF45, max_steps=max_steps,
        return_stats=True)
    assert torch.isnan(y[1]).all() and int(n[1]) == max_steps
    assert torch.isfinite(y[[0, 2]]).all()


def test_rk_step_matches_jax():
    y = np.array([[1.0, -0.5, 2.0], [0.3, 0.2, 0.1]])
    t, h = np.array([0.2, 1.0]), np.array([0.1, 0.05])
    yt, et = tode.rk_step(_rhs_torch(RATES[:2]), torch.tensor(t),
                          torch.tensor(h), torch.tensor(y), tode.RKF45)
    for b in range(2):
        yj, ej = jode.rk_step(_rhs_jax(RATES[b]), t[b], h[b],
                              jnp.asarray(y[b]), jode.RKF45)
        np.testing.assert_allclose(yt[b].numpy(), np.asarray(yj), rtol=0,
                                   atol=1e-15)
        np.testing.assert_allclose(et[b].numpy(), np.asarray(ej), rtol=0,
                                   atol=1e-17)


STAGES = [(name, i) for name in TABLEAUX
          for i in range(1, len(getattr(tode, name).c))]


@pytest.mark.parametrize("name,i", STAGES)
def test_rk_stage_plain_equals_the_inline_chain(name, i):
    """K3's rk_stage on the CPU (its plain version, through the wrapper)
    equals the eager chain it replaced, y + h (a_i0 k_0 + a_i1 k_1 + ...)
    with Python-float coefficients, bit for bit, at every stage of every
    tableau."""
    tab = getattr(tode, name)
    rng = np.random.default_rng(100 * len(tab.c) + i)
    B, D = 3, 7
    y = torch.as_tensor(rng.standard_normal((B, D)))
    ks = torch.as_tensor(rng.standard_normal((len(tab.c), B, D)))
    h = torch.as_tensor(10.0 ** rng.uniform(-6, 0, B))
    acc = float(tab.a[i, 0]) * ks[0]
    for j in range(1, i):
        acc = acc + float(tab.a[i, j]) * ks[j]
    chain = y + h[:, None] * acc
    consts = k3.attempt_consts(tab, 0.0, 1e-3, "cpu")
    assert torch.equal(k3.rk_stage(y, ks, h, consts, i), chain)
    assert torch.equal(k3.rk_stage_plain(y, ks, h, consts.a[i], i), chain)


@pytest.mark.parametrize("name", TABLEAUX)
def test_rk_stages_times_and_inputs(name):
    """rk_stages evaluates stage i at t + c_i h, every stage time from one
    broadcast, bit-equal to the per-stage form, on the input rk_stage
    gives; on the CPU no launch is counted."""
    tab = getattr(tode, name)
    rng = np.random.default_rng(len(tab.c))
    t = torch.as_tensor(rng.uniform(0, 1, 4))
    h = torch.as_tensor(10.0 ** rng.uniform(-3, 0, 4))
    y = torch.as_tensor(rng.standard_normal((4, 3)))
    seen = []

    def rhs(tt, yy):
        seen.append((tt.clone(), yy.clone()))
        return torch.sin(yy) + tt[:, None]

    consts = k3.attempt_consts(tab, 1e-7, 1e-2, "cpu")
    before = counts.snapshot()
    ks = tode.rk_stages(rhs, t, h, y, consts)
    assert counts.snapshot() == before
    assert ks.shape == (len(tab.c), 4, 3)
    for i, (tt, yy) in enumerate(seen):
        assert torch.equal(tt, t + float(tab.c[i]) * h)
        want = y if i == 0 else k3.rk_stage_plain(y, ks, h, consts.a[i], i)
        assert torch.equal(yy, want)
        assert torch.equal(ks[i], torch.sin(yy) + tt[:, None])
