"""The port's device split, run_batch(devices=[...]), against the JAX
package's mesh (tests/test_sharding.py) on the CPU.

Each configuration runs once through JAX's run_batch(mesh=Mesh(4 virtual
CPU devices)) and once through the port's run_batch(devices=["cpu"] * 4),
four worker processes of one lane each, shared by the tests through
module-level caches: 1-loop at tests/test_sharding.py's tiny nk=16
config and full TRG at its nk=64 one (:123-170, PT columns zero), each
chunked and packed (2 lanes, one a shard).  Bounds: the controller band,
3e-5 of column scale (tests/test_segmented.py:50-51), the linear columns
and the header scalars within 1e-10 relative, the port's usual bounds
against JAX.  A shard against an in-process run_batch of the same lanes:
bit for bit.  Every wait on the workers has a time limit (deadline).
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke

from torch_port_util import col_scale_dev, deadline, jax_batch, port_inputs
from redtime_tpu import driver as jd
from redtime_tpu.config import RunSettings as JSet
from redtime_tpu.config import SolverConfig as JCfg
from redtime_tpu_torch import driver as td
from redtime_tpu_torch import worker
from redtime_tpu_torch.config import RunSettings as TSet
from redtime_tpu_torch.config import SolverConfig as TCfg
from redtime_tpu_torch.profiling import StageTimer

N = 4
WAIT_S = 600
CONFIGS = {
    "oneloop": (dict(nk=16, np_factor=4, growth_n_lna=10, growth_n_lnk=6,
                     quad_panels=8, quad_order=8),
                dict(z_out=(1.0, 0.0))),
    "full_trg": (dict(nk=64, growth_n_lna=12, growth_n_lnk=8, quad_panels=8,
                      quad_order=8),
                 dict(one_loop=False, z_out=(3.0, 1.0, 0.0))),
}
SCHEDULERS = {"chunked": {}, "packed": dict(scheduler="packed", n_lanes=2)}
CASES = [(m, s) for m in CONFIGS for s in SCHEDULERS]
IDS = [f"{m}-{s}" for m, s in CASES]


@functools.lru_cache(maxsize=None)
def _inputs(mode: str, n: int = N):
    """JAX's and the port's configuration, settings and inputs."""
    fields, settings = CONFIGS[mode]
    jcfg = JCfg(fft_mode="fft", **fields)
    cosmos, lins = jax_batch(n, jcfg)
    cs, tlins = port_inputs(cosmos, lins)
    return (jcfg, JSet(**settings), cosmos, lins, TCfg(**fields),
            TSet(**settings), cs, tlins)


@functools.lru_cache(maxsize=None)
def _jax(mode: str, scheduler: str):
    import jax
    from jax.sharding import Mesh

    devs = jax.devices("cpu")
    if len(devs) < N:
        pytest.skip("needs >= 4 virtual CPU devices")
    jcfg, jset, cosmos, lins = _inputs(mode)[:4]
    mesh = Mesh(np.array(devs[:N]), ("batch",))
    return jd.run_batch(jcfg, jset, cosmos, lins, mode="fft", mesh=mesh,
                        prepare_on_host=False, **SCHEDULERS[scheduler])


def _port(mode: str, lanes=None, devices=None, n: int = N, **kw):
    """The port's run_batch on the CPU over lanes `lanes` (a slice or a
    list) of _inputs(mode, n), and its timer's stats."""
    tcfg, tset, cs, lins = _inputs(mode, n)[4:]
    if lanes is not None:
        cs = type(cs)(*[x[lanes] for x in cs])
        lins = type(lins)(*[x[lanes] for x in lins])
    timer = StageTimer(enabled=False)
    with deadline(WAIT_S):
        res = td.run_batch(tcfg, tset, cs, lins, device="cpu", timer=timer,
                           devices=devices, **kw)
    return res, timer.stats


@functools.lru_cache(maxsize=None)
def _split(mode: str, scheduler: str):
    return _port(mode, devices=["cpu"] * N, **SCHEDULERS[scheduler])


@pytest.mark.parametrize("mode, scheduler", CASES, ids=IDS)
def test_split_matches_jax_mesh(mode, scheduler):
    rj = _jax(mode, scheduler)
    rt, stats = _split(mode, scheduler)
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
    if mode == "full_trg":
        # the reference's full-TRG caveat under the split, as under the
        # mesh (tests/test_sharding.py:165-166)
        assert np.all(got[..., 13:17] == 0.0)
        assert np.any(got[..., 10:13] != 0.0)
    assert len(stats["shards"]) == N
    assert all(s["device"] == "cpu" and s["start_s"] > 0
               and s["wall_s"] > 0 for s in stats["shards"])
    assert not chip_smoke.child_pids()


@pytest.mark.parametrize("mode, scheduler", CASES, ids=IDS)
def test_shard_equals_in_process_run(mode, scheduler):
    """Lane 2, a shard of its own, against an in-process run_batch of
    lane 2 alone with the same settings: the same bits, the same
    attempts (and, packed, iterations)."""
    rt, stats = _split(mode, scheduler)
    one, one_stats = _port(mode, slice(2, 3), **SCHEDULERS[scheduler])
    for a, b in zip(rt, one):
        assert torch.equal(a[2:3], b)
    assert stats["attempts"][2:3] == one_stats["attempts"]
    if scheduler == "packed":
        assert stats["iterations"][2] == one_stats["iterations"]


@pytest.mark.parametrize("mode", list(CONFIGS))
def test_split_within_band_of_unsplit(mode):
    """The split run against the port's in-process run of the whole
    batch: within the controller band (a lane's bits may depend on its
    chunk-mates), the linear columns within 1e-10."""
    rt, _ = _split(mode, "chunked")
    whole, _ = _port(mode)
    got, ref = rt.table.numpy(), whole.table.numpy()
    assert col_scale_dev(got, ref, (0, 2)) < 3e-5
    np.testing.assert_allclose(got[..., :7], ref[..., :7], rtol=1e-10,
                               atol=0)


def test_padding_order_and_stats():
    """n = 5 over 2 devices, packed on 2 lanes: the batch is padded with
    its first lane to 6 and cut into shards (0, 1, 2) and (3, 4, 0); the
    padding is dropped, the lanes stay in the caller's order (each shard
    equal bit for bit to an in-process run of its lanes), attempts come
    in batch order and there is one iterations entry a shard."""
    kw = SCHEDULERS["packed"]
    rt, stats = _port("oneloop", devices=["cpu", "cpu"], n=5, **kw)
    assert rt.table.shape[0] == 5
    first, s0 = _port("oneloop", slice(0, 3), n=5, **kw)
    second, s1 = _port("oneloop", [3, 4, 0], n=5, **kw)
    for a, b0, b1 in zip(rt, first, second):
        assert torch.equal(a[:3], b0)
        assert torch.equal(a[3:], b1[:2])
    assert stats["attempts"] == s0["attempts"] + s1["attempts"][:2]
    assert stats["iterations"] == [s0["iterations"], s1["iterations"]]
    assert [s["device"] for s in stats["shards"]] == ["cpu", "cpu"]


def test_split_rules_follow_jax(monkeypatch):
    """max_chunk across the devices rounded down to a multiple of nd (or
    nd), each worker solving max_chunk // nd; packed lanes min(n_lanes or
    8, shard size); an empty device list raises; segmented still raises.
    The requests are read off a stand-in for the worker."""
    seen = []

    class Recorder:
        start_s = 0.0

        def __init__(self, name):
            self.name = name

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

        def ready(self, timeout=0.0):
            return True

        def send(self, kind, **args):
            seen.append(args)
            raise worker.WorkerError("recorded")

    monkeypatch.setattr(worker, "Worker", Recorder)
    tcfg, tset, cs, lins = _inputs("oneloop", 5)[4:]
    for kw in (dict(max_chunk=5), dict(max_chunk=1), dict(scheduler="packed"),
               dict(scheduler="packed", n_lanes=2)):
        with pytest.raises(worker.WorkerError, match="recorded"):
            td.run_batch(tcfg, tset, cs, lins, devices=["cpu"] * 2, **kw)
    assert [a["max_chunk"] for a in seen] == [2, 1, 3, 3]
    assert [a.get("n_lanes") for a in seen] == [None, None, 3, 2]
    assert [len(a["inputs"][0][0]) for a in seen] == [3] * 4
    assert all(a["device"] == "cpu" for a in seen)
    with pytest.raises(ValueError, match="devices is empty"):
        td.run_batch(tcfg, tset, cs, lins, devices=[])
    with pytest.raises(ValueError, match="Not ported, on purpose"):
        td.run_batch(tcfg, tset, cs, lins, devices=["cpu"],
                     scheduler="segmented")
