"""The packed (work-queue) scheduler of the PyTorch port against the JAX
package's, on the CPU: trg.evolve_packed, run_batch(scheduler="packed")
and the CLI's --scheduler packed / --lanes, with K3's packed final-step
rule (h >= t1 - t, redtime_tpu/trg.py:446) in its plain version.

Inputs: __graft_entry__'s cosmologies and synthetic linear data, nk=32,
the JAX package in its CPU default mode='fft'.  Lanes of the port and of
JAX take different step sequences once ulp-level differences reach the
adaptive controller, so tables are held to the controller band: 3e-5 of
column scale against JAX (tests/test_torch_slice.py), rtol 3e-5 / atol
1e-12 between the port's two schedulers (tests/test_packed.py:51).
"""

import functools
import math

import numpy as np
import pytest
import torch

import chip_smoke
from torch_port_util import col_scale_dev, jax_batch, port_inputs
from redtime_tpu import driver as jd
from redtime_tpu.config import RunSettings as JSet
from redtime_tpu.config import SolverConfig as JCfg
from redtime_tpu_torch import cli
from redtime_tpu_torch import driver as td
from redtime_tpu_torch import fastpt as tf
from redtime_tpu_torch import ode as tode
from redtime_tpu_torch import trg as tt
from redtime_tpu_torch.config import RunSettings as TSet
from redtime_tpu_torch.config import SolverConfig as TCfg
from redtime_tpu_torch.kernels import rk_finish as k3
from redtime_tpu_torch.profiling import StageTimer

NK = 32
FULL = dict(one_loop=False, z_out=(2.0, 1.0, 0.5, 0.0))
ONE_LOOP = dict(one_loop=True, z_out=(1.0, 0.0))


def _numpy(tree):
    return type(tree)(*[np.asarray(x) for x in tree])


@functools.lru_cache(maxsize=None)
def _inputs(n: int):
    """n JAX cosmologies and linear inputs, and the same for the port."""
    cosmos, lins = jax_batch(n, JCfg(nk=NK, fft_mode="fft"))
    cs, _ = port_inputs(cosmos, lins)
    return cosmos, lins, cs, _numpy(lins)


@functools.lru_cache(maxsize=None)
def _jax(n: int, settings: tuple, lanes: int):
    cosmos, lins, _, _ = _inputs(n)
    return jd.run_batch(JCfg(nk=NK, fft_mode="fft"), JSet(**dict(settings)),
                        cosmos, lins, mode="fft", scheduler="packed",
                        n_lanes=lanes)


@functools.lru_cache(maxsize=None)
def _port(n: int, settings: tuple, scheduler: str, lanes=None):
    """The port's run_batch on the CPU, and its timer's stats."""
    _, _, cs, lins = _inputs(n)
    timer = StageTimer(enabled=False)
    res = td.run_batch(TCfg(nk=NK), TSet(**dict(settings)), cs, lins,
                       device="cpu", scheduler=scheduler, n_lanes=lanes,
                       timer=timer)
    return res, timer.stats


def _key(settings: dict) -> tuple:
    return tuple(sorted(settings.items()))


@pytest.mark.parametrize("n, settings, lanes", [
    (5, FULL, 3), (3, ONE_LOOP, 2)], ids=["full_trg", "oneloop"])
def test_packed_matches_jax_packed(n, settings, lanes):
    """Fewer lanes than models, so lanes cycle through the queue; the
    linear columns bypass the integrator (1e-10); z, eta, a and the
    headers are the same numbers."""
    rj = _jax(n, _key(settings), lanes)
    rt, stats = _port(n, _key(settings), "packed", lanes)
    got, ref = rt.table.numpy(), np.asarray(rj.table)
    assert got.shape == ref.shape
    assert bool(np.isfinite(got).all())
    assert col_scale_dev(got, ref, (0, 2)) < 3e-5
    np.testing.assert_allclose(got[..., :7], ref[..., :7], rtol=1e-10,
                               atol=0)
    for name in ("z", "eta", "a"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)))
    for name in ("H", "sigma_v2", "sigmaV2_z0"):
        np.testing.assert_allclose(getattr(rt, name).numpy(),
                                   np.asarray(getattr(rj, name)),
                                   rtol=1e-10, atol=0, err_msg=name)
    assert len(stats["attempts"]) == n and min(stats["attempts"]) > 0


def test_packed_matches_chunked():
    """The port's two schedulers on the same 5 cosmologies: within the
    controller band; the packed loop runs fewer attempts than the
    chunked lanes' total, and no fewer than its own total over 3 lanes."""
    rc, sc = _port(5, _key(FULL), "chunked")
    rp, sp = _port(5, _key(FULL), "packed", 3)
    np.testing.assert_allclose(rp.table.numpy(), rc.table.numpy(),
                               rtol=3e-5, atol=1e-12)
    np.testing.assert_array_equal(rp.z.numpy(), rc.z.numpy())
    np.testing.assert_array_equal(rp.eta.numpy(), rc.eta.numpy())
    iters = sp["iterations"]
    assert iters < sum(sc["attempts"])
    assert iters >= math.ceil(sum(sp["attempts"]) / 3)


def test_packed_single_model_matches_evolve():
    """One model on one lane: the packed loop against trg.evolve
    (tests/test_packed.py:57-67)."""
    cfg, settings = TCfg(nk=NK), TSet(**FULL)
    _, _, cs, lins = _inputs(1)
    m = td._prepare_chunk(cfg, ([x.numpy() for x in cs], list(lins), None),
                          "cpu")
    ec = tf.engine_consts(cfg, "cpu")
    ys_seq = tt.evolve(cfg, settings, m, ec)
    ys_pk, iters = tt.evolve_packed(cfg, settings, m, ec, 1,
                                    return_iters=True)
    assert ys_pk.shape == ys_seq.shape == (1, 4, tt.NU_STATE, NK)
    np.testing.assert_allclose(ys_pk.numpy(), ys_seq.numpy(), rtol=1e-6,
                               atol=1e-8)
    assert iters > 0


def test_packed_stops_at_max_iters_with_zero_rows():
    """A model the loop never finished keeps zero rows, as the JAX
    package's zero-filled output does (redtime_tpu/trg.py:545-556)."""
    cfg, settings = TCfg(nk=NK), TSet(**FULL)
    _, _, cs, lins = _inputs(3)
    m = td._prepare_chunk(cfg, ([x.numpy() for x in cs], list(lins), None),
                          "cpu")
    ec = tf.engine_consts(cfg, "cpu")
    ys, iters, attempts = tt.evolve_packed(cfg, settings, m, ec, 2,
                                           max_iters=30, return_iters=True,
                                           return_stats=True)
    assert iters == 30
    done = attempts.numpy() > 0
    assert done[:2].all() and not done[2]
    assert bool((ys[2] == 0).all())
    assert bool(torch.isfinite(ys[:2]).all()) and bool((ys[:2, -1] != 0).any())


def test_scheduler_dispatch():
    """"auto" is the chunked scheduler, bit for bit; "segmented" is not
    ported and any other name raises JAX's message."""
    ra, _ = _port(3, _key(ONE_LOOP), "auto")
    rc, _ = _port(3, _key(ONE_LOOP), "chunked")
    for a, c in zip(ra, rc):
        assert torch.equal(a, c)
    _, _, cs, lins = _inputs(3)
    with pytest.raises(ValueError, match="Not ported, on purpose"):
        td.run_batch(TCfg(nk=NK), TSet(**ONE_LOOP), cs, lins, device="cpu",
                     scheduler="segmented")
    with pytest.raises(ValueError, match="unknown scheduler 'lockstep'"):
        td.run_batch(TCfg(nk=NK), TSet(**ONE_LOOP), cs, lins, device="cpu",
                     scheduler="lockstep")


def test_cli_batch_packed(tmp_path):
    """`batch --scheduler packed --lanes 2` over 3 params files: tables
    within the controller band of --scheduler chunked's; --lanes without
    packed is accepted and changes nothing."""
    paths = chip_smoke.write_cli_inputs(str(tmp_path),
                                        chip_smoke.design_params(3),
                                        (2.0, 0.0))
    base = ["batch", "--platform", "cpu", "--nk", "16"]
    runs = {"packed": ["--scheduler", "packed", "--lanes", "2"],
            "chunked": ["--scheduler", "chunked"],
            "lanes_ignored": ["--lanes", "2"]}
    tables = {}
    for name, flags in runs.items():
        out = tmp_path / name
        assert cli.main(base + flags + ["-o", str(out)] + paths) == 0
        tables[name] = [np.loadtxt(out / f"redTime_M{i:03d}.dat")
                        for i in range(3)]
    for p, c, same in zip(*tables.values()):
        assert p.shape == c.shape and bool(np.isfinite(p).all())
        np.testing.assert_allclose(p, c, rtol=3e-5, atol=1e-12)
        np.testing.assert_array_equal(same, c)


def _parent_rk_finish_plain(y, ks, t, h, t1, n, active, b, e, prm):
    """rk_finish_plain as it was before the final-step rule became part
    of the constants: the chunked rule, five outputs."""
    eabs, erel, p_dec, p_inc = prm[:4]
    dt = t1 - t
    final = h > dt
    h_try = torch.where(final, dt, h)
    acc_b = b[0] * ks[0]
    acc_e = e[0] * ks[0]
    for j in range(1, ks.shape[0]):
        acc_b = acc_b + b[j] * ks[j]
        acc_e = acc_e + e[j] * ks[j]
    hy = h_try[:, None]
    y_new = y + hy * acc_b
    yerr = hy * acc_e
    d0 = eabs + erel * torch.abs(y_new)
    r = torch.amax(torch.abs(yerr) / d0, dim=1)
    dec = r > k3.REJECT_ABOVE
    fac_dec = torch.clamp(k3.SAFETY * r ** p_dec, min=k3.FAC_MIN)
    fac_inc = torch.clamp(k3.SAFETY * r ** p_inc, 1.0, k3.FAC_MAX)
    fac = torch.where(dec, fac_dec,
                      torch.where(r < k3.GROW_BELOW, fac_inc,
                                  torch.ones_like(r)))
    h_next = h_try * fac
    t_acc = torch.where(final, t1, t + h_try)
    t_new = torch.where(dec, t, t_acc)
    take = active & ~dec
    y_out = torch.where(take[:, None], y_new, y)
    t_out = torch.where(active, t_new, t)
    h_out = torch.where(active, h_next, h)
    n_out = n + active.to(n.dtype)
    return y_out, t_out, h_out, n_out, r


def _lane_attempt_numpy(y, ks, t, h, t1, active, tab, eabs, erel, ge,
                        power):
    """A numpy transcript of the packed lane attempt and the loop's masks
    (redtime_tpu/trg.py:440-459 and :523-528), every lane at once; ge:
    False gives the chunked rule of redtime_tpu/ode.py:164.  pow is not
    correctly rounded, and numpy's, glibc's and torch's differ in the
    last bit, so r ** p comes from `power`; every other operation is
    numpy's, rounded once as XLA rounds it."""
    dt = t1 - t
    final = h >= dt if ge else h > dt
    h_try = np.where(final, dt, h)
    acc_b, acc_e = tab.b[0] * ks[0], tab.e[0] * ks[0]
    for j in range(1, ks.shape[0]):
        acc_b = acc_b + tab.b[j] * ks[j]
        acc_e = acc_e + tab.e[j] * ks[j]
    y_new = y + h_try[:, None] * acc_b
    yerr = h_try[:, None] * acc_e
    d0 = eabs + erel * np.abs(y_new)
    r = np.max(np.abs(yerr) / d0, axis=1)
    dec = r > 1.1
    fac_dec = np.maximum(0.9 * power(r, -1.0 / tab.order), 0.2)
    fac_inc = np.clip(0.9 * power(r, -1.0 / (tab.order + 1.0)), 1.0, 5.0)
    fac = np.where(dec, fac_dec, np.where(r < 0.5, fac_inc, 1.0))
    h_next = h_try * fac
    t_out = np.where(dec, t, np.where(final, t1, t + h_try))
    y_out = np.where(dec[:, None], y, y_new)
    return (np.where(active[:, None], y_out, y), np.where(active, t_out, t),
            np.where(active, h_next, h), r, final & ~dec & active)


def _torch_pow(r, p):
    return (torch.as_tensor(r) ** torch.tensor(p, dtype=torch.float64)
            ).numpy()


# (case, tableau, D, eabs, erel): the growth ramp's and the growth
# segments' attempts (eabs 0, the growth rtol) and the eta evolution's
RULE_CASES = [("growth ramp", "DOP853", 2, 0.0, 1e-6),
              ("growth segments", "DOPRI5", 102, 0.0, 1e-6),
              ("eta", "RKF45", 41 * NK, 1e-7, 1e-2)]


@pytest.mark.parametrize("case, tname, D, eabs, erel", RULE_CASES,
                         ids=[c[0] for c in RULE_CASES])
def test_rk_finish_plain_final_rule(case, tname, D, eabs, erel):
    """K3's plain version under both final-step rules, on chip_smoke's
    seeded attempt with lane 0 stepping exactly onto t1 and lane 1 just
    short of it where t + h rounds onto t1: with h > dt, the parent's
    outputs bit for bit; under either rule the numpy transcript bit for
    bit, reached included; reached differs between the rules on lane 0
    alone and stays off on lane 1, whose t lands on t1 all the same."""
    tab = getattr(tode, tname)
    rng = np.random.default_rng(20261017)
    args = chip_smoke.final_rule_lanes(
        chip_smoke.rk_inputs(rng, tab, 16, D, eabs, "cpu"))
    y, ks, t, h, t1, n, active = args
    assert float(h[0]) == float(t1[0] - t[0])
    assert float(h[1]) < float(t1[1] - t[1])
    assert float(t[1] + h[1]) == float(t1[1])
    reached = {}
    for ge in (False, True):
        consts = k3.attempt_consts(tab, eabs, erel, "cpu",
                                   final_at_equal=ge)
        out = k3.rk_finish(*args, consts)
        assert len(out) == 6 and out[5].dtype == torch.bool
        if not ge:
            for a, b in zip(out, _parent_rk_finish_plain(
                    *args, consts.b, consts.e, consts.prm)):
                assert torch.equal(a, b)
        ref = _lane_attempt_numpy(*[x.numpy() for x in (y, ks, t, h, t1,
                                                        active)],
                                  tab, eabs, erel, ge, _torch_pow)
        for a, b in zip([out[i] for i in (0, 1, 2, 4, 5)], ref):
            np.testing.assert_array_equal(a.numpy(), b)
        assert torch.equal(out[3], n + active.to(n.dtype))
        rej = out[4] > k3.REJECT_ABOVE
        assert 0 < int(rej.sum()) < 16 and not bool(rej[:2].any())
        reached[ge] = out[5]
        assert float(out[1][1]) == float(t1[1]) and not bool(out[5][1])
    assert reached[True][0] and not reached[False][0]
    assert torch.equal(reached[True][1:], reached[False][1:])
