"""The port's run_pipeline, host prepare, and the
grids the CLI takes, against the JAX package on the CPU.

* run_pipeline (one cosmology, nk=32) against JAX run_pipeline(mode=
  'fft'), full Time-RG and 1-loop, with and without norm_override;
* run_batch with prepare_on_host=True over 3 lanes in chunks of 2 (each
  chunk prepared on one torch thread, then solved) against
  prepare_on_host=False, full Time-RG and 1-loop;
* run_batch at nk=16 and nk=48 (np=4nk: 2np no power of two at 48)
  against JAX run_batch, full Time-RG, 2 lanes.

The adaptive controller turns ulp-level differences into different step
sequences, so tables are held to the controller band, 3e-5 of column
scale (tests/test_segmented.py:50-51); the linear columns, sigma_v^2 and
H bypass the integrator and are held to 1e-10 relative.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from torch_port_util import col_scale_dev, jax_batch, port_inputs
from __graft_entry__ import _cosmo, _example_inputs
from redtime_tpu import driver as jd
from redtime_tpu import model as jm
from redtime_tpu.config import RunSettings as JSet
from redtime_tpu.config import SolverConfig as JCfg
from redtime_tpu_torch import driver as td
from redtime_tpu_torch.config import RunSettings as TSet
from redtime_tpu_torch.config import SolverConfig as TCfg
from redtime_tpu_torch.profiling import StageTimer

NK = 32
FULL = dict(one_loop=False, z_out=(2.0, 1.0, 0.5, 0.0))
ONE_LOOP = dict(one_loop=True, z_out=(2.0, 1.0, 0.0))
MODES = {"full_trg": FULL, "one_loop": ONE_LOOP}


def _np(tree):
    return type(tree)(*[np.asarray(x) for x in tree])


def assert_matches(got, ref, batched: bool) -> None:
    """got (the port's RunResult) within the controller band of ref (a
    JAX RunResult of the same cosmologies)."""
    tg, tr = got.table.numpy(), np.asarray(ref.table)
    assert tg.shape == tr.shape
    axes = (0, 1, 2) if batched else (0, 1)
    assert col_scale_dev(tg, tr, axes) < 3e-5
    np.testing.assert_allclose(tg[..., :7], tr[..., :7], rtol=1e-10, atol=0)
    for name in ("sigma_v2", "H", "sigmaV2_z0"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-10, atol=0, err_msg=name)
    for name in ("k", "eta", "a", "z", "eta_fin"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-15, atol=0, err_msg=name)
    assert len(td.finite_report(got)) == 0


@functools.lru_cache(maxsize=1)
def _norm() -> float:
    """A P_lin normalization 5% off cosmology 0's sigma_8 one."""
    jc = JCfg(nk=NK)
    m = jax.jit(lambda c, l: jm.prepare_model(jc, c, l))(
        _cosmo(0), _example_inputs(jc))
    return 1.05 * float(m.norm)


@functools.lru_cache(maxsize=4)
def _pipelines(mode: str, with_norm: bool):
    jc = JCfg(nk=NK, fft_mode="fft")
    c, lin = _cosmo(0), _example_inputs(jc)
    nrm = _norm() if with_norm else None
    rj = jd.run_pipeline(jc, JSet(**MODES[mode]), c, lin, mode="fft",
                         norm_override=nrm)
    rt = td.run_pipeline(TCfg(nk=NK), TSet(**MODES[mode]), _np(c), _np(lin),
                         device="cpu", norm_override=nrm)
    return rj, rt


@pytest.mark.parametrize("mode", list(MODES))
def test_run_pipeline_matches_jax(mode):
    rj, rt = _pipelines(mode, False)
    ncol = td.n_columns(TCfg(nk=NK), TSet(**MODES[mode]))
    assert rt.table.shape == (len(MODES[mode]["z_out"]), NK, ncol)
    assert rt.sigmaV2_z0.shape == ()
    assert_matches(rt, rj, batched=False)


def test_run_pipeline_norm_override_matches_jax():
    rj, rt = _pipelines("full_trg", True)
    assert_matches(rt, rj, batched=False)
    # the override reaches P_lin: the linear P columns scale by it
    _, plain = _pipelines("full_trg", False)
    np.testing.assert_allclose(rt.table[..., 3].numpy(),
                               1.05 * plain.table[..., 3].numpy(),
                               rtol=1e-10)


@functools.lru_cache(maxsize=2)
def _batch3(mode: str = "full_trg"):
    cosmos, lins = jax_batch(3, JCfg(nk=NK))
    cs, _ = port_inputs(cosmos, lins)
    lins = _np(lins)
    ref = td.run_batch(TCfg(nk=NK), TSet(**MODES[mode]), cs, lins,
                       device="cpu", max_chunk=2, prepare_on_host=False)
    return cs, lins, ref


@pytest.mark.parametrize("mode", list(MODES))
def test_host_prepare_matches_device_prepare(mode):
    """prepare_on_host=True with chunks of 2 over 3 lanes (chunk 1
    padded): the lanes come back in order, within the controller band of
    the same run prepared in place."""
    cs, lins, ref = _batch3(mode)
    got = td.run_batch(TCfg(nk=NK), TSet(**MODES[mode]), cs, lins,
                       device="cpu", max_chunk=2, prepare_on_host=True)
    nz = len(MODES[mode]["z_out"])
    assert got.table.shape == ref.table.shape
    assert got.table.shape[:3] == (3, nz, NK)
    tg, tr = got.table.numpy(), ref.table.numpy()
    assert col_scale_dev(tg, tr, (0, 1, 2)) < 3e-5
    np.testing.assert_allclose(tg[..., :7], tr[..., :7], rtol=1e-10, atol=0)


@pytest.mark.parametrize("on_host", [True, False])
def test_host_prepare_runs_on_one_torch_thread(on_host, monkeypatch):
    """Host prepare runs on one torch thread and gives the count back;
    prepare in place keeps the caller's count.  With host prepare the
    prepare worker may take chunk 1 (it prepares on one thread too,
    tests/test_torch_overlap.py): every chunk the caller prepared here
    ran on one thread, chunk 0 among them."""
    cs, lins, _ = _batch3()
    threads = torch.get_num_threads()
    seen = []
    prepare = td._prepare_chunk

    def counting(*args):
        seen.append(torch.get_num_threads())
        return prepare(*args)

    monkeypatch.setattr(td, "_prepare_chunk", counting)
    timer = StageTimer(enabled=False)
    td.run_batch(TCfg(nk=NK), TSet(**FULL), cs, lins, device="cpu",
                 max_chunk=2, prepare_on_host=on_host, timer=timer)
    by = timer.stats.get("prepared_by", ["caller"] * 2)
    assert len(by) == 2 and by[0] == "caller"
    assert seen == [1 if on_host else threads] * by.count("caller")
    assert torch.get_num_threads() == threads


def test_torch_threads_come_back_when_prepare_raises(monkeypatch):
    cs, lins, _ = _batch3()
    threads = torch.get_num_threads()

    def failing(*args):
        raise RuntimeError("prepare failed")

    monkeypatch.setattr(td, "_prepare_chunk", failing)
    with pytest.raises(RuntimeError, match="prepare failed"):
        td.run_batch(TCfg(nk=NK), TSet(**FULL), cs, lins, device="cpu",
                     max_chunk=1, prepare_on_host=True)
    assert torch.get_num_threads() == threads


@pytest.mark.parametrize("with_timer", [True, False])
def test_timer_books_each_chunk(with_timer, monkeypatch):
    """A timer books "prepare" and "solve", and the device is
    synchronized after each chunk's solve only when there is one."""
    cs, lins, _ = _batch3()
    synced = []
    monkeypatch.setattr(td, "sync", lambda x: synced.append(x.shape))
    timer = StageTimer(enabled=False) if with_timer else None
    td.run_batch(TCfg(nk=NK), TSet(**FULL), cs, lins, device="cpu",
                 max_chunk=2, timer=timer)
    assert len(synced) == (2 if with_timer else 0)
    if with_timer:
        assert set(timer.times) == {"prepare", "solve"}


@pytest.mark.parametrize("nk", [16, 48])
def test_run_batch_on_grids_matches_jax(nk):
    """Grids the CLI's --nk takes beside the default: full Time-RG, 2
    lanes, np = 4 nk."""
    jc = JCfg(nk=nk, fft_mode="fft")
    cosmos, lins = jax_batch(2, jc)
    rj = jd.run_batch(jc, JSet(**FULL), cosmos, lins, mode="fft")
    cs, _ = port_inputs(cosmos, lins)
    rt = td.run_batch(TCfg(nk=nk), TSet(**FULL), cs, _np(lins),
                      device="cpu")
    assert rt.table.shape == (2, 4, nk, 17)
    assert_matches(rt, rj, batched=True)
