"""1-loop mode of the PyTorch port against the JAX package's, on the CPU.

The pieces run on one JAX-prepared Model (2 cosmologies, nk=32) carried
across with state.model_from_numpy:
  * build_oneloop_cache: the FAST-PT engine at z1l (the port's plain
    K1/K2), within 1e-11 of each row's scale — the engine's bound
    (tests/test_torch_engine.py);
  * oneloop_rescale: growth-factor arithmetic in the JAX package's order;
    the JAX package selects the f powers with one-hot matmuls, the port
    indexes (exact for finite f64), so 1e-13 relative;
  * the 1-loop RHS on the JAX cache: within 1e-11 of each state row's
    scale.
Then run_batch end to end for 3 cosmologies, z_out = (2, 1, 0.5, 0):
within 3e-5 of column scale of JAX run_batch (the controller band,
tests/test_segmented.py:50-51), the linear columns within 1e-10.  The
JAX reference runs its CPU default, mode='fft'.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import col_scale_dev, jax_batch, port_inputs
from redtime_tpu import driver as jd
from redtime_tpu import fastpt as jf
from redtime_tpu import model as jm
from redtime_tpu import trg as jt
from redtime_tpu.config import RunSettings as JSet
from redtime_tpu.config import SolverConfig as JCfg
from redtime_tpu_torch import driver as td
from redtime_tpu_torch import fastpt as tf
from redtime_tpu_torch import state
from redtime_tpu_torch import trg as tt
from redtime_tpu_torch.config import RunSettings as TSet
from redtime_tpu_torch.config import SolverConfig as TCfg

NK = 32
ONE_LOOP = dict(one_loop=True, z_out=(2.0, 1.0, 0.5, 0.0))
SETTINGS = [ONE_LOOP, dict(ONE_LOOP, print_rsd=False)]
IDS = ["one_loop", "one_loop_no_rsd"]


@functools.lru_cache(maxsize=1)
def _models():
    jc = JCfg(nk=NK)
    cosmos, lins = jax_batch(2, jc)
    return jax.jit(jax.vmap(lambda c, l: jm.prepare_model(jc, c, l)))(
        cosmos, lins)


def _lane(tree, b):
    return jax.tree_util.tree_map(lambda x: x[b], tree)


@functools.lru_cache(maxsize=2)
def _jax_caches(print_rsd: bool):
    """The JAX 1-loop cache of each lane, as numpy [2, ...] per field."""
    jc = JCfg(nk=NK)
    ec = jf.engine_consts(jc, "fft")
    s = JSet(**dict(ONE_LOOP, print_rsd=print_rsd))
    caches = [jt.build_oneloop_cache(jc, s, _lane(_models(), b), "fft", ec)
              for b in range(2)]
    return jt.OneLoopCache(*[np.stack([np.asarray(x) for x in xs])
                             for xs in zip(*caches)])


def _port_cache(cache_np) -> tt.OneLoopCache:
    return tt.OneLoopCache(*[torch.tensor(x) for x in cache_np])


@pytest.mark.parametrize("settings_kw", SETTINGS, ids=IDS)
def test_oneloop_cache_matches_jax(settings_kw):
    tc = TCfg(nk=NK)
    mt = state.model_from_numpy(_models())
    got = tt.build_oneloop_cache(tc, TSet(**settings_kw), mt,
                                 tf.engine_consts(tc, "cpu"))
    ref = _jax_caches(settings_kw.get("print_rsd", True))
    for name, g, r in zip(tt.OneLoopCache._fields, got, ref):
        g = g.numpy()
        assert g.shape == r.shape, name
        if name == "D_z1l":
            np.testing.assert_allclose(g, r, rtol=1e-13, atol=0)
            continue
        scale = np.abs(r).max(axis=-1, keepdims=True) + 1e-300
        assert np.max(np.abs(g - r) / scale) < 1e-11, name
    if not settings_kw.get("print_rsd", True):
        assert torch.all(got.R == 0) and torch.all(got.PT == 0)
    else:
        assert torch.any(got.R != 0) and torch.any(got.PT != 0)


def test_oneloop_rescale_matches_jax():
    jc, tc = JCfg(nk=NK), TCfg(nk=NK)
    mt = state.model_from_numpy(_models())
    cache_np = _jax_caches(True)
    eta = np.array([0.7, 3.9])
    got = tt.oneloop_rescale(tc, TSet(**ONE_LOOP), mt, _port_cache(cache_np),
                             torch.tensor(eta))
    for b in range(2):
        cj = jt.OneLoopCache(*[jnp.asarray(x[b]) for x in cache_np])
        ref = jt.oneloop_rescale(jc, JSet(**ONE_LOOP), _lane(_models(), b),
                                 cj, eta[b])
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(r),
                                       rtol=1e-13, atol=0)
    # the collapsed PT2/4/6/8 are the m-sums of PTjm (reference :1353-1357)
    PT = got[2]
    PT4 = tt._collapse_pt(PT)
    torch.testing.assert_close(PT4[:, 1], PT[:, 3] + PT[:, 4] + PT[:, 5],
                               rtol=0, atol=0)
    torch.testing.assert_close(PT4[:, 3], PT[:, 8], rtol=0, atol=0)


def _state(settings_kw, eta=1.3):
    """An evolved-looking state (lnP grown by e^eta, nonzero I/Q rows)."""
    jc = JCfg(nk=NK)
    rng = np.random.default_rng(9)
    ys = []
    for b in range(2):
        y0 = np.asarray(jt.initial_state(jc, JSet(**settings_kw),
                                         _lane(_models(), b)))
        y0 = y0.reshape(41, NK).copy()
        y0[:3] += 2.0 * eta
        y0[3:] = 1e-3 * np.exp(y0[:1]) * rng.standard_normal((38, NK))
        ys.append(y0.reshape(-1))
    return np.stack(ys), eta


@pytest.mark.parametrize("settings_kw", SETTINGS, ids=IDS)
def test_oneloop_rhs_matches_jax(settings_kw):
    jc, tc = JCfg(nk=NK), TCfg(nk=NK)
    ys, eta = _state(settings_kw)
    cache_np = _jax_caches(settings_kw.get("print_rsd", True))
    rhs_t = tt.make_rhs(tc, TSet(**settings_kw),
                        state.model_from_numpy(_models()),
                        tf.engine_consts(tc, "cpu"), _port_cache(cache_np))
    got = rhs_t(torch.full((2,), eta, dtype=torch.float64),
                torch.tensor(ys)).numpy().reshape(2, 41, NK)
    ec = jf.engine_consts(jc, "fft")
    for b in range(2):
        cj = jt.OneLoopCache(*[jnp.asarray(x[b]) for x in cache_np])
        rhs_j = jt.make_rhs(jc, JSet(**settings_kw), _lane(_models(), b), cj,
                            mode="fft", ec=ec)
        ref = np.asarray(rhs_j(eta, jnp.asarray(ys[b]))).reshape(41, NK)
        scale = np.abs(ref).max(axis=1, keepdims=True) + 1e-300
        assert np.max(np.abs(got[b] - ref) / scale) < 1e-11


def test_oneloop_rhs_needs_the_cache():
    tc = TCfg(nk=NK)
    with pytest.raises(ValueError, match="cache"):
        tt.make_rhs(tc, TSet(**ONE_LOOP), state.model_from_numpy(_models()),
                    tf.engine_consts(tc, "cpu"))


PRINT_ALL = dict(print_a=True, print_i=True, print_q=True, print_bias=True)


def _runs(print_all: bool):
    cfg_kw = PRINT_ALL if print_all else {}
    jc = JCfg(nk=NK, fft_mode="fft", **cfg_kw)
    cosmos, lins = jax_batch(3, jc)
    rj = jd.run_batch(jc, JSet(**ONE_LOOP), cosmos, lins, mode="fft")
    cs, lt = port_inputs(cosmos, lins)
    rt = td.run_batch(TCfg(nk=NK, **cfg_kw), TSet(**ONE_LOOP), cs, lt,
                      device="cpu")
    return rj, rt


@pytest.mark.parametrize("print_all, ncol, pt_cols", [
    (False, 17, slice(13, 17)), (True, 84, slice(38 + 5, 38 + 22))],
    ids=["default_columns", "every_print_column"])
def test_run_batch_oneloop_matches_jax(print_all, ncol, pt_cols):
    rj, rt = _runs(print_all)
    tj, tt_ = np.asarray(rj.table), rt.table.numpy()
    assert tt_.shape == tj.shape == (3, 4, NK, ncol)
    assert col_scale_dev(tt_, tj, (0, 2)) < 3e-5
    np.testing.assert_allclose(tt_[..., :7], tj[..., :7], rtol=1e-10, atol=0)
    # 1-loop mode recomputes the mode coupling at each output: the PT
    # (and PMR) columns are populated in both packages
    for t in (tt_, tj):
        assert np.all(np.any(t[..., pt_cols] != 0.0, axis=2))
    for name in ("sigma_v2", "sigmaV2_z0", "H"):
        np.testing.assert_allclose(getattr(rt, name).numpy(),
                                   np.asarray(getattr(rj, name)),
                                   rtol=1e-12, atol=0, err_msg=name)
    assert len(td.finite_report(rt)) == 0
