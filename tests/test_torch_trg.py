"""The PyTorch port's Time-RG RHS and evolution pieces against the JAX
package's, on a JAX-prepared Model carried through state.py.

One full-TRG RHS evaluation (FAST-PT engine with the plain K1/K2, the
direct assembly, the Omega x I / Omega x Q bilinear forms and the
clamps): within 1e-11 of each state row's scale.  The JAX reference runs
its CPU default, mode='fft'.
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
from redtime_tpu import trg as jt
from redtime_tpu.config import RunSettings as JSet
from redtime_tpu.config import SolverConfig as JCfg
from redtime_tpu_torch import fastpt as tf
from redtime_tpu_torch import state
from redtime_tpu_torch import trg as tt
from redtime_tpu_torch.config import RunSettings as TSet
from redtime_tpu_torch.config import SolverConfig as TCfg

NK = 32
FULL = dict(one_loop=False, z_out=(2.0, 1.0, 0.5, 0.0))


@functools.lru_cache(maxsize=1)
def _models():
    jc = JCfg(nk=NK)
    cosmos, lins = jax_batch(2, jc)
    return jax.jit(jax.vmap(lambda c, l: jm.prepare_model(jc, c, l)))(
        cosmos, lins)


def _lane(mj, b):
    return jax.tree_util.tree_map(lambda x: x[b], mj)


def _state(settings_kw, eta=1.3):
    """An evolved-looking state: the initial lnP rows grown by e^eta and
    nonzero I/Q rows, so every contraction of the RHS is exercised."""
    mj = _models()
    jc = JCfg(nk=NK)
    rng = np.random.default_rng(4)
    ys = []
    for b in range(2):
        y0 = np.asarray(jt.initial_state(jc, JSet(**settings_kw),
                                         _lane(mj, b))).reshape(41, NK)
        y0 = y0.copy()
        y0[:3] += 2.0 * eta
        scale = np.exp(y0[:1])
        y0[3:] = 1e-3 * scale * rng.standard_normal((38, NK))
        ys.append(y0.reshape(-1))
    return np.stack(ys), eta


@pytest.mark.parametrize("settings_kw", [
    FULL, dict(FULL, print_rsd=False), dict(FULL, nonlinear=False)],
    ids=["full_trg", "full_trg_no_rsd", "linear"])
def test_rhs_matches_jax(settings_kw):
    mj = _models()
    jc, tc = JCfg(nk=NK), TCfg(nk=NK)
    ys, eta = _state(settings_kw)
    mt = state.model_from_numpy(mj)
    rhs_t = tt.make_rhs(tc, TSet(**settings_kw), mt, tf.engine_consts(tc, "cpu"))
    got = rhs_t(torch.full((2,), eta, dtype=torch.float64),
                torch.tensor(ys)).numpy().reshape(2, 41, NK)
    ec = jf.engine_consts(jc, "fft")
    for b in range(2):
        rhs_j = jt.make_rhs(jc, JSet(**settings_kw), _lane(mj, b), None,
                            mode="fft", ec=ec)
        ref = np.asarray(rhs_j(eta, jnp.asarray(ys[b]))).reshape(41, NK)
        scale = np.abs(ref).max(axis=1, keepdims=True) + 1e-300
        assert np.max(np.abs(got[b] - ref) / scale) < 1e-11


def test_initial_state_omega_and_pbis_match_jax():
    mj = _models()
    jc, tc = JCfg(nk=NK), TCfg(nk=NK)
    mt = state.model_from_numpy(mj)
    y0 = tt.initial_state(tc, TSet(**FULL), mt).numpy()
    a = np.array([0.02, 0.7])
    O = tt.omega_matrix(tc, mt, torch.tensor(a)).numpy()
    ys, _ = _state(FULL)
    pb = tt.pbis_j(tc, torch.tensor(ys).reshape(2, 41, NK)).numpy()
    for b in range(2):
        m = _lane(mj, b)
        np.testing.assert_allclose(
            y0[b], np.asarray(jt.initial_state(jc, JSet(**FULL), m)),
            rtol=1e-13, atol=0)
        np.testing.assert_allclose(
            O[b], np.asarray(jt.omega_matrix(jc, m, a[b])), rtol=1e-13,
            atol=0)
        np.testing.assert_allclose(
            pb[b], np.asarray(jt.pbis_j(jc, jnp.asarray(ys[b]).reshape(
                41, NK))), rtol=1e-13, atol=1e-300)
