"""The slice end to end: the PyTorch port's run_batch against the JAX
package's run_batch on the same 3 cosmologies, nk=32, full Time-RG,
z_out = (2, 1, 0.5, 0), on the CPU (the port's K1/K2/K3 plain versions;
JAX in its CPU default mode='fft').

The adaptive controller turns ulp-level differences into different step
sequences, so the tables are held to the controller band: 3e-5 of column
scale (tests/test_segmented.py:50-51); the linear-theory columns 0-6
bypass the integrator and are held to 1e-10 relative.
"""

import functools
import inspect
import io

import numpy as np
import pytest
import torch

from torch_port_util import col_scale_dev, jax_batch, port_inputs
from redtime_tpu import driver as jd
from redtime_tpu.config import RunSettings as JSet
from redtime_tpu.config import SolverConfig as JCfg
from redtime_tpu.io import writer as jw
from redtime_tpu_torch import driver as td
from redtime_tpu_torch import fastpt as tf
from redtime_tpu_torch.config import RunSettings as TSet
from redtime_tpu_torch.config import SolverConfig as TCfg
from redtime_tpu_torch.io import writer as tw

NK = 32
SETTINGS = dict(one_loop=False, z_out=(2.0, 1.0, 0.5, 0.0))


@functools.lru_cache(maxsize=1)
def _runs():
    jc = JCfg(nk=NK, fft_mode="fft")
    cosmos, lins = jax_batch(3, jc)
    rj = jd.run_batch(jc, JSet(**SETTINGS), cosmos, lins, mode="fft")
    cs, _ = port_inputs(cosmos, lins)
    rt = td.run_batch(TCfg(nk=NK), TSet(**SETTINGS), cs,
                      jax_tree_numpy(lins), device="cpu")
    return rj, rt, (cs, jax_tree_numpy(lins))


def jax_tree_numpy(lins):
    return type(lins)(*[np.asarray(x) for x in lins])


def test_run_batch_matches_jax():
    rj, rt, _ = _runs()
    tj, tt_ = np.asarray(rj.table), rt.table.numpy()
    assert tt_.shape == tj.shape == (3, 4, NK, 17)
    assert td.n_columns(TCfg(nk=NK), TSet(**SETTINGS)) == 17
    assert col_scale_dev(tt_, tj, (0, 2)) < 3e-5
    np.testing.assert_allclose(tt_[..., :7], tj[..., :7], rtol=1e-10, atol=0)
    # full-TRG output caveat: the PT columns print zero (driver.py:163-178)
    assert np.all(tt_[..., 13:17] == 0.0) and np.all(tj[..., 13:17] == 0.0)
    assert np.any(tt_[..., 10:13] != 0.0)
    for name in ("k", "eta", "a", "z", "H", "eta_fin"):
        np.testing.assert_allclose(getattr(rt, name).numpy(),
                                   np.asarray(getattr(rj, name)),
                                   rtol=1e-15, atol=0, err_msg=name)
    for name in ("sigma_v2", "sigmaV2_z0"):
        np.testing.assert_allclose(getattr(rt, name).numpy(),
                                   np.asarray(getattr(rj, name)),
                                   rtol=1e-12, atol=0, err_msg=name)
    assert len(td.finite_report(rt)) == 0


def test_writer_bytes_equal_for_an_identical_table():
    rj, _, _ = _runs()
    one = type(rj)(*[np.asarray(x)[1] for x in rj])
    ref, got = io.StringIO(), io.StringIO()
    jw.write_result(ref, one, "params_redTime.dat")
    batch = td.RunResult(*[torch.tensor(np.asarray(x)) for x in rj])
    tw.write_result(got, td.lane(batch, 1), "params_redTime.dat")
    assert got.getvalue() == ref.getvalue()
    assert got.getvalue().count("### main: output at eta=") == 4


def test_chunked_run_matches_one_batch():
    """max_chunk=2 over 3 lanes: the second chunk is padded by repeating
    its first lane and the padding dropped.  Each lane runs its own
    controller, but the CPU's f64 GEMMs (MKL) block by the operands'
    shapes, so a lane's bits depend on the chunk it is in (the forward
    leg, the Toeplitz and growth-table contractions: M = 3B rows), and
    the controller turns those ulps into other step sequences: the
    controller band of column scale, the linear columns within 1e-10."""
    _, rt, (cs, lins) = _runs()
    rc = td.run_batch(TCfg(nk=NK), TSet(**SETTINGS), cs, lins, max_chunk=2,
                      device="cpu")
    assert rc.table.shape == rt.table.shape
    got, ref = rc.table.numpy(), rt.table.numpy()
    assert col_scale_dev(got, ref, (0, 1, 2)) < 3e-5
    np.testing.assert_allclose(got[..., :7], ref[..., :7], rtol=1e-10,
                               atol=0)
    for name in ("sigma_v2", "H", "sigmaV2_z0"):
        np.testing.assert_allclose(getattr(rc, name).numpy(),
                                   getattr(rt, name).numpy(), rtol=1e-10,
                                   atol=0, err_msg=name)


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """run_batch, run_pipeline, engine_consts and the CLI run on the card
    unless the caller asks for the CPU: on a machine with no card, a call
    without `device` (or the CLI without --platform cpu) raises before
    any work; it never runs on the CPU."""
    import chip_smoke
    from redtime_tpu_torch import cli

    for fn in (td.run_batch, td.run_pipeline, tf.engine_consts):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    _, _, (cs, lins) = _runs()
    one_c = type(cs)(*[x[0] for x in cs])
    one_lin = type(lins)(*[x[0] for x in lins])
    paths = chip_smoke.write_cli_inputs(str(tmp_path),
                                        chip_smoke.design_params(1),
                                        SETTINGS["z_out"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        td.run_batch(TCfg(nk=NK), TSet(**SETTINGS), cs, lins)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        td.run_pipeline(TCfg(nk=NK), TSet(**SETTINGS), one_c, one_lin)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tf.engine_consts(TCfg(nk=NK))
    for argv in (["run", "--params", paths[0]],
                 ["batch", "-o", str(tmp_path / "out"), paths[0]]):
        with pytest.raises(SystemExit, match="no CUDA card"):
            cli.main(argv + ["--nk", str(NK)])
    assert not (tmp_path / "out").exists()


def test_finite_report_names_a_poisoned_lane():
    _, rt, _ = _runs()
    table = rt.table.clone()
    table[1, 2, 5, 8] = float("nan")
    assert td.finite_report(rt._replace(table=table)).tolist() == [1]


@pytest.mark.parametrize("kw, cfg_kw, exc", [
    (dict(z_out=(0.0, 1.0)), {}, ValueError),
    (dict(z_out=()), {}, ValueError),
    (dict(z_out=(300.0,)), {}, ValueError),
    (dict(z_out=(1.0,), z_in=2000.0), {}, ValueError),
    (dict(one_loop=True), dict(dtype="float32"), ValueError),
    (dict(one_loop=False), dict(out_leg="ozaki"), ValueError),
])
def test_run_batch_checks_settings(kw, cfg_kw, exc):
    _, _, (cs, lins) = _runs()
    with pytest.raises(exc):
        td.run_batch(TCfg(nk=NK, **cfg_kw), TSet(**kw), cs, lins,
                     device="cpu")
