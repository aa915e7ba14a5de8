"""K8 rhs_tail's lookups (the RHS prologue it took over) on the CPU.

  * kernels.rhs_tail.prologue_plain (a = a_in e^eta, beta_P, a^3 H^2/H0^2,
    3 + dlnH/dlna, and the 1-loop D and dD/da at eta's z) against the JAX
    package's model.beta_P_solver, trg.omega_matrix, background.H2_H02 /
    dlnH_dlna and model.growth_D_f, per lane under jax.vmap, on tables
    made from a numpy seed, at the edge cases of the kernel's bracketing:
    a on an interior node and on the first and last (a > 1 clamped), a
    below the first node, a on either side of a_nu, f_nu = 0, a NaN lane,
    ln a on a growth node and outside the growth table, nz = 4 and nz = 0;
  * the kernel's per-warp bracketing and 4-node sum (the numpy model
    torch_port_util.k8_bracket / k8_lookup) against interp.axis_weights
    and the dense-row einsum the plain version contracts.

Tolerance against JAX: 1e-13 relative (of each (lane, row)'s scale): the
two read the same tables at the same a and z, and differ only in their
libraries' exp, log and pow (a few ulps) and the order in which their
dense weight rows are contracted (the extra terms are +0).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import k8_bracket, k8_lookup, k8_prologue
from redtime_tpu import background as jbg
from redtime_tpu import model as jm
from redtime_tpu import trg as jt
from redtime_tpu.config import CosmoParams as JCosmo
from redtime_tpu.config import SolverConfig as JCfg
from redtime_tpu_torch import background as bg
from redtime_tpu_torch import interp, state, trg
from redtime_tpu_torch.kernels import rhs_tail as rt

NK, NN = 12, 21
Z_IN = 200.0
A_IN = 1.0 / (1.0 + Z_IN)
F64 = torch.float64
# the lanes: eta or a target, and what each one exercises
LANES = ("plain", "beta node", "first node", "below the table", "a > 1",
         "below a_nu", "above a_nu", "f_nu = 0", "NaN")


def _tables(nz: int, seed: int = 21):
    """A JAX Model batch [len(LANES)] from a numpy seed: cosmologies near
    the example's (f_nu = 0 on its lane), beta_P tables of nz nodes in a
    (the last at a = 1), growth tables on NN ln a nodes over [1e-3, 1.1],
    and each lane's eta, with the tables' nodes moved onto the lane's a
    (and ln a) where its case asks for it."""
    rng = np.random.default_rng(seed)
    B = len(LANES)
    k = np.geomspace(1e-3, 2.0, NK)
    on = np.array([0.2 * (i - 4) for i in range(B)])
    Omega_nu = np.where(np.array(LANES) == "f_nu = 0", 0.0,
                        0.005 + 0.001 * rng.uniform(size=B))
    cosmo = JCosmo(*[jnp.asarray(v) for v in (
        0.96 + 0.01 * on, 0.8 + 0.01 * on, np.full(B, 0.68),
        0.3 + 0.01 * on, np.full(B, 0.048), Omega_nu, np.full(B, 2.726),
        -1.0 + 0.05 * on, 0.1 * on)])
    zs = np.concatenate([[200.0], np.geomspace(60.0, 0.3, max(nz - 2, 0)),
                         [0.0]])[:nz]
    beta_a = np.tile(1.0 / (1.0 + np.sort(zs)[::-1]), (B, 1))
    beta_a[:, 1:-1] *= 1.0 + 0.02 * rng.uniform(-1, 1, (B, max(nz - 2, 0)))
    beta_s = ((0.3 + 0.7 * beta_a[..., None])
              / (1.0 + (k / 0.1) ** 2) * (1.0 + 0.05 * rng.uniform(
                  size=(B, nz, NK))))
    g_lna = np.tile(np.linspace(np.log(1e-3), np.log(1.1), NN), (B, 1))
    g_G = np.exp(0.9 * g_lna[..., None]) * (1.0 + 0.1 * rng.uniform(
        size=(B, NN, NK)))
    g_dD = 0.8 * g_G * (1.0 + 0.1 * rng.uniform(size=(B, NN, NK)))
    g_Dn = 1.0 + 0.1 * rng.uniform(size=(B, NK))
    eta = 0.3 + 3.0 * rng.uniform(size=B)
    a_nu = np.asarray(jbg.derived(cosmo).a_nu)
    for b, case in enumerate(LANES):
        targets = {"below the table": 0.5 * A_IN, "a > 1": 1.4,
                   "below a_nu": a_nu[b] * (1.0 - 1e-6),
                   "above a_nu": a_nu[b] * (1.0 + 1e-6)}
        if case in targets:
            eta[b] = np.log(targets[case] / A_IN)
        if case == "NaN":
            eta[b] = np.nan
        if nz >= 4 and case in ("beta node", "first node"):
            # a between nodes 1 and 3 (or below node 1), then a node on it
            m = 2 if case == "beta node" else 0
            lo = beta_a[b, m - 1] if m else 0.5 * beta_a[b, 0]
            eta[b] = np.log(0.5 * (lo + beta_a[b, m + 1]) / A_IN)
            beta_a[b, m] = A_IN * torch.exp(torch.tensor(eta[b])).item()
        if case == "beta node":
            # and ln a of its z on growth node 7
            z = (torch.exp(-torch.tensor(eta[b])) * (1.0 + Z_IN) - 1.0)
            lna = torch.log(torch.reciprocal(1.0 + z)).item()
            g_lna[b, np.argmin(np.abs(g_lna[b] - lna))] = lna
    zero = np.zeros(B)
    m = jm.Model(cosmo, *[jnp.asarray(x) for x in (
        g_lna, g_G, g_dD, g_Dn, beta_a, beta_s, np.ones((B, NK)), zero,
        zero)])
    return m, eta


@functools.lru_cache(maxsize=4)
def _results(nz: int):
    """(port, JAX) of each lookup at the lanes' eta for tables of nz
    nodes: beta, o10, den, o11, D, dD/da as numpy."""
    m, eta = _tables(nz)
    mt = state.model_from_numpy(m)
    om = trg.omega_tables(mt, A_IN)
    f = lambda *shape: torch.zeros(shape, dtype=F64)
    src = rt.OneLoopSrc(f(len(LANES), 14, NK), f(len(LANES), 3, 8, NK),
                        mt.g_lna, mt.g_G, mt.g_dDda, mt.g_Dnorm,
                        f(len(LANES), NK), Z_IN)
    eta_t = torch.tensor(eta)
    at, (D, dDda, z) = rt.prologue_plain(eta_t, om, src)
    a = A_IN * torch.exp(eta_t)
    port = dict(beta=at.beta, o10=rt.omega_from(at)[:, 1, 0], den=at.den,
                o11=at.o11, D=D, dDda=dDda)
    jc = JCfg(nk=NK)

    def lane(mb, ab, zb):
        d = jbg.derived(mb.cosmo)
        Dj, dDj = jm.growth_D_f(mb, zb)
        return dict(beta=jm.beta_P_solver(mb, ab),
                    o10=jt.omega_matrix(jc, mb, ab)[1, 0],
                    den=ab ** 3 * jbg.H2_H02(mb.cosmo, ab, d),
                    o11=3.0 + jbg.dlnH_dlna(mb.cosmo, ab, d), D=Dj,
                    dDda=dDj)

    ref = jax.jit(jax.vmap(lane))(m, jnp.asarray(a.numpy()),
                                  jnp.asarray(z.numpy()))
    return ({n: v.numpy() for n, v in port.items()},
            {n: np.asarray(v) for n, v in ref.items()}, eta)


def _rel_dev(got: np.ndarray, ref: np.ndarray) -> float:
    """max |got - ref| over each lane's max |ref| (its row scale), where
    ref is finite; NaN must sit in the same places."""
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    fin = np.isfinite(ref)
    r2, g2 = ref.reshape(len(ref), -1), got.reshape(len(got), -1)
    scale = np.where(np.isfinite(r2), np.abs(r2), 0.0).max(-1, keepdims=True)
    d = np.where(fin.reshape(r2.shape), np.abs(g2 - r2), 0.0)
    return float(np.max(d / (scale + 1e-300)))


@pytest.mark.parametrize("nz", [8, 4, 0])
@pytest.mark.parametrize("what", ["beta", "o10", "den", "o11", "D", "dDda"])
def test_prologue_matches_jax(nz, what):
    got, ref, _ = _results(nz)
    assert _rel_dev(got[what], ref[what]) < 1e-13, (nz, what)
    nan = [LANES.index("NaN")]
    if what != "beta" or nz:
        assert np.isnan(got[what][nan]).all()
    if what == "beta":
        assert (got[what][LANES.index("f_nu = 0")] == 0).all()
        if nz == 0:
            assert (got[what] == 0).all()


def test_edge_lanes_take_the_edge_branches():
    """The lanes reach what they name: the node cases bracket a on a
    node, the table's ends extrapolate (linear) or clamp, a_nu's lanes sit
    on its two sides."""
    m, eta = _tables(8)
    a = A_IN * torch.exp(torch.tensor(eta)).numpy()
    beta_a = np.asarray(m.beta_a)
    b = LANES.index("beta node")
    assert a[b] == beta_a[b, 2]
    pos, i0, cubic, w = k8_bracket(beta_a[b], a[b])
    assert (pos, i0, cubic) == (2, 0, True) and w[2] == 1.0
    lna = np.log(1.0 / (np.exp(-eta[b]) * (1.0 + Z_IN)))
    assert np.isclose(np.asarray(m.g_lna)[b], lna, rtol=0,
                      atol=1e-15).sum() == 1
    b = LANES.index("first node")
    assert a[b] == beta_a[b, 0]
    assert k8_bracket(beta_a[b], a[b])[:3] == (0, 0, False)
    b = LANES.index("below the table")
    assert a[b] < beta_a[b, 0]
    assert k8_bracket(beta_a[b], a[b])[:3] == (0, 0, False)
    b = LANES.index("a > 1")
    assert a[b] > 1.0 and beta_a[b, -1] == 1.0
    assert k8_bracket(beta_a[b], 1.0)[:3] == (7, 4, False)
    a_nu = np.asarray(jbg.derived(m.cosmo).a_nu)
    assert a[LANES.index("below a_nu")] < a_nu[LANES.index("below a_nu")]
    assert a[LANES.index("above a_nu")] >= a_nu[LANES.index("above a_nu")]
    assert k8_bracket(beta_a[0], np.nan)[:3] == (8, 4, False)


def test_bracket_model_matches_axis_weights():
    """The kernel's bracketing (a count of !(node >= x), then the branch
    and weights) against interp.axis_weights on random sorted nodes (nn 4
    to 101) at points inside, outside, on nodes and NaN: the same pos
    (torch.searchsorted's), i0, branch and weights bit for bit; its 4-node
    sum within 4 ulps of its terms' scale (sum_j |w_j t_j|) of the plain
    version's dense-row einsum (axis_weights_full)."""
    rng = np.random.default_rng(7)
    for nn in (4, 5, 6, 9, 33, 101):
        nodes = np.sort(rng.uniform(-3.0, 2.0, nn))
        rows = rng.standard_normal((nn, NK)) * np.geomspace(1.0, 1e3, NK)
        xs = np.concatenate([rng.uniform(-4.0, 3.0, 40), nodes,
                             [nodes[0] - 1.0, nodes[-1] + 1.0, np.nan]])
        nt = torch.tensor(nodes)[None].expand(len(xs), nn).contiguous()
        xt = torch.tensor(xs)
        i0_t, w_t = interp.axis_weights(nt, xt)
        pos_t = torch.searchsorted(nt, xt[:, None], side="left")[:, 0]
        dense = torch.einsum("bn,nk->bk", interp.axis_weights_full(nt, xt),
                             torch.tensor(rows)).numpy()
        for j, x in enumerate(xs):
            pos, i0, cubic, w = k8_bracket(nodes, x)
            n = min(max(pos - 1, 0), nn - 2)
            assert pos == int(pos_t[j]) and i0 == int(i0_t[j]), (nn, x)
            assert cubic == (0 < n < nn - 2)
            np.testing.assert_array_equal(w, w_t[j].numpy())
            got = k8_lookup(i0, w, rows)
            if np.isnan(x):
                assert np.isnan(got).all() and np.isnan(dense[j]).all()
                continue
            scale = (np.abs(w[:, None]) * np.abs(rows[i0:i0 + 4])).sum(0)
            assert np.all(np.abs(got - dense[j]) <= 4 * np.spacing(scale))


def test_numpy_model_matches_plain():
    """k8_prologue (the kernel's lookups lane by lane) against the plain
    version at the edge lanes, within 1e-14 of each lane's scale (numpy's
    and torch's pow and exp, and the plain version's dense-row sums, may
    round apart by an ulp)."""
    m, eta = _tables(8)
    mt = state.model_from_numpy(m)
    om = trg.omega_tables(mt, A_IN)
    f = lambda *shape: torch.zeros(shape, dtype=F64)
    B = len(LANES)
    src = rt.OneLoopSrc(f(B, 14, NK), f(B, 3, 8, NK), mt.g_lna, mt.g_G,
                        mt.g_dDda, mt.g_Dnorm, f(B, NK), Z_IN)
    eta_t = torch.tensor(eta)
    at, (D, dDda, _) = rt.prologue_plain(eta_t, om, src)
    beta, den, o11, (Dm, dDm, _) = k8_prologue(eta_t, om, src)
    for got, ref in ((beta, at.beta), (Dm, D), (dDm, dDda), (den, at.den),
                     (o11, at.o11)):
        assert _rel_dev(got, ref.numpy()) < 1e-14
    assert bg.OmegaConsts._fields == tuple(om.consts._fields)
