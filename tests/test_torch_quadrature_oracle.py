"""The port's continuum oracle (redtime_tpu_torch.quadrature:
j_quadrature, pz_quadrature, jreg_ir_counterterm, qk61) against the JAX
package's, and the port's engine (fastpt.extend_power and
compute_J_PZ_windowed: the plain versions of K9, K10, K1 and K2 on the
CPU) against the port's oracle.

* Oracle against JAX on the same windowed spectrum: J, PZ and the Jreg
  counterterm within 1e-12 of the engine family's peak (the two differ
  in summation order and in torch's and numpy's pow); qk61's four
  outputs within 5e-15 of resabs, and the rule exact on monomials to
  5e-15 (tests/test_quadrature.py:179-195's bound).
* Engine against oracle at tests/test_quadrature.py's own bounds and
  orders: the six unregularised J families within 5e-3 of peak, PZ
  within 3e-3 (n < 0) / 4e-2 (n > 0) of peak, and the Jreg identity
  J_naive - J_reg == Delta within 5e-3 relative.

The spectrum is tests/test_quadrature.py's BBKS-like P(k)
(quadrature.bbks_lnP, which chip_smoke.py's oracle phase also feeds
the card's engine) at SolverConfig() defaults (nk = 128).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (torch threads, JAX on CPU)
from redtime_tpu import quadrature as jq
from redtime_tpu.config import SolverConfig as JCfg
from redtime_tpu_torch import fastpt as tf
from redtime_tpu_torch import quadrature as tq
from redtime_tpu_torch.config import SolverConfig as TCfg
from redtime_tpu_torch.grids import make_grids

CPU = dict(device="cpu")
F64 = dict(dtype=torch.float64)
IDX = np.array([24, 48, 72, 96])          # mid solver-grid columns


@pytest.fixture(scope="module")
def engine():
    """The port's engine on the BBKS spectrum: (cfg, grids, P_ext [npts]
    numpy, Jw [NFAM, nk], PZw [7, nk])."""
    cfg = TCfg()
    g = make_grids(cfg)
    lnP3 = torch.as_tensor(
        np.broadcast_to(tq.bbks_lnP(g.k), (1, 3, g.nk)).copy())
    ec = tf.engine_consts(cfg, "cpu")
    P_ext = tf.extend_power(cfg, lnP3, torch.tensor([0.96], **F64), ec)
    Jw, _, PZw = tf.compute_J_PZ_windowed(cfg, P_ext, True, ec)
    return (cfg, g, P_ext[0, 0].numpy(), Jw[0, :, 0, 0].numpy(),
            PZw[0, :, 0, 0].numpy())


def _peak(x: np.ndarray) -> float:
    return float(np.abs(x).max())


FAMILIES = tq.UNREG_FAMILIES + ((1, 2, -2, 0),)


@pytest.mark.parametrize("fam,alpha,beta,ell", FAMILIES)
def test_j_quadrature_matches_jax(engine, fam, alpha, beta, ell):
    cfg, g, P_ext, Jw, _ = engine
    k = g.k[IDX]
    got = tq.j_quadrature(cfg, P_ext, k, alpha, beta, ell, 200, 48, **CPU)
    ref = jq.j_quadrature(JCfg(), P_ext, k, alpha, beta, ell, 200, 48)
    assert got.dtype == torch.float64 and got.shape == (4,)
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * _peak(Jw[fam])


@pytest.mark.parametrize("fi,n", list(enumerate(tf.Z_N)))
def test_pz_quadrature_matches_jax(engine, fi, n):
    cfg, g, P_ext, _, PZw = engine
    k = torch.as_tensor(g.k[IDX])
    Pk = P_ext[g.nshift:g.nshift + g.nk][IDX]
    got = tq.pz_quadrature(cfg, P_ext, k, n, 300, **CPU).numpy() * Pk
    ref = jq.pz_quadrature(JCfg(), P_ext, g.k[IDX], n, 300) * Pk
    assert np.abs(got - ref).max() <= 1e-12 * _peak(PZw[fi])


def test_jreg_ir_counterterm_matches_jax(engine):
    cfg, g, P_ext, Jw, _ = engine
    k = g.k[[48, 64, 80, 96]]
    got = tq.jreg_ir_counterterm(cfg, P_ext, k, **CPU).numpy()
    ref = jq.jreg_ir_counterterm(JCfg(), P_ext, k)
    assert np.abs(got - ref).max() <= 1e-12 * _peak(Jw[1])


QK61_CASES = [
    (lambda x: torch.exp(x), lambda x: jnp.exp(x), -1.0, 3.0),
    (lambda x: 1.0 / (1.0 + x * x), lambda x: 1.0 / (1.0 + x * x),
     -15.0, 15.0),
    (lambda x: torch.sin(20.0 * x), lambda x: jnp.sin(20.0 * x), -1.5, 2.0),
    (lambda x: torch.sqrt(x), lambda x: jnp.sqrt(x), 0.0, 2.0),
]


@pytest.mark.parametrize("case", range(len(QK61_CASES)))
def test_qk61_matches_jax(case):
    f_t, f_j, a, b = QK61_CASES[case]
    got = [float(v) for v in tq.qk61(f_t, a, b, "cpu")]
    ref = [float(v) for v in jq.qk61(f_j, a, b)]
    resabs = ref[2]
    assert np.abs(np.array(got) - np.array(ref)).max() <= 5e-15 * resabs


def test_qk61_rule_exact_on_monomials():
    for deg in (0, 17, 60, 89, 90):
        exact = 2.0 / (deg + 1) if deg % 2 == 0 else 0.0
        got, *_ = tq.qk61(lambda x: x ** deg, -1.0, 1.0, "cpu")
        assert abs(float(got) - exact) < 5e-15, (deg, float(got), exact)


def test_interp_equals_numpy():
    rng = np.random.default_rng(4)
    xp = np.sort(rng.uniform(-5, 5, 64))
    fp = rng.standard_normal(64)
    x = np.concatenate([rng.uniform(-6, 6, 500), xp, [xp[0], xp[-1]]])
    got = tq._interp(torch.as_tensor(x), torch.as_tensor(xp),
                     torch.as_tensor(fp)).numpy()
    assert got.tobytes() == np.interp(x, xp, fp).tobytes()


@pytest.mark.parametrize("fam,alpha,beta,ell", tq.UNREG_FAMILIES)
def test_engine_matches_oracle(engine, fam, alpha, beta, ell):
    cfg, g, P_ext, Jw, _ = engine
    # n_q = 600: the beta = -2 families need fine ln q resolution near
    # the s -> 0 endpoint to converge below the engine's own error
    got = tq.j_quadrature(cfg, P_ext, g.k[IDX], alpha, beta, ell, 600, 96,
                          **CPU).numpy()
    assert np.abs(got - Jw[fam][IDX]).max() <= 5e-3 * _peak(Jw[fam])


@pytest.mark.parametrize("fi,n", list(enumerate(tf.Z_N)))
def test_engine_pz_matches_oracle(engine, fi, n):
    cfg, g, P_ext, _, PZw = engine
    Pk = P_ext[g.nshift:g.nshift + g.nk][IDX]
    got = tq.pz_quadrature(cfg, P_ext, g.k[IDX], n, **CPU).numpy() * Pk
    tol = 3e-3 if n < 0 else 4e-2
    assert np.abs(got - PZw[fi][IDX]).max() <= tol * _peak(PZw[fi])


def test_engine_jreg_identity(engine):
    """J_naive(2, -2, 0) - J_reg(engine) is the IR piece the
    regularisation removes, where that piece is well above the 2-D
    quadrature's noise."""
    cfg, g, P_ext, Jw, _ = engine
    idx = [48, 64, 80, 96]
    naive = tq.j_quadrature(cfg, P_ext, g.k[idx], 2, -2, 0, 800, 1024,
                            **CPU).numpy()
    model = tq.jreg_ir_counterterm(cfg, P_ext, g.k[idx], **CPU).numpy()
    ratio = (naive - Jw[1][idx]) / model
    assert np.abs(ratio - 1.0).max() <= 5e-3, ratio
