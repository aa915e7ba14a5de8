"""The port's injected-linear reconstruction (redtime_tpu_torch.inject)
against redtime_tpu.inject, and the rerun it feeds.

One design cosmology (massive nu; chip_smoke.write_cli_inputs writes its
params file and CAMB-format stack with the port's io) is solved on the
CPU in 1-loop mode at nk=32 and its PRINTLIN table written by the port's
writer.  From that table and its params file:

* reconstruct_linear / load_injected equal JAX's within 1e-13 (the same
  numpy code: LinearData fields and the normalization), massive and
  massless;
* the rerun through run_pipeline(norm_override=...) reproduces P_lin_cb
  at z=0 within 1e-9 and at every z within 5e-3, the bounds the reference
  suite holds the injected reconstruction to
  (tests/test_golden_32models.py:134-140);
* the four inputs reconstruct_linear refuses raise ValueError in both
  packages (redtime_tpu/inject.py:88-124).
"""

import dataclasses
import os

import numpy as np
import pytest

import chip_smoke
import torch_port_util  # noqa: F401  (one torch thread per worker)
from redtime_tpu import inject as jinj
from redtime_tpu.config import SolverConfig as JCfg
from redtime_tpu.io import read_params_file as j_read_params
from redtime_tpu_torch import cli
from redtime_tpu_torch import driver as td
from redtime_tpu_torch import inject as tinj
from redtime_tpu_torch.config import SolverConfig as TCfg
from redtime_tpu_torch.io import read_params_file
from redtime_tpu_torch.io.writer import write_result_to_path

NK = 32
Z_OUT = (2.0, 1.0, 0.5, 0.0)


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    """(params path, table path, the solve's table [n_z, NK, 17])."""
    d = tmp_path_factory.mktemp("inject")
    params = chip_smoke.write_cli_inputs(
        str(d), chip_smoke.design_params(2)[1:], Z_OUT, one_loop=True)[0]
    _, lin, settings, cosmo = cli._load(params, False)
    res = td.run_pipeline(TCfg(nk=NK), settings, cosmo, lin, device="cpu")
    out = str(d / "redTime_M000.dat")
    write_result_to_path(out, res, os.path.basename(params))
    return params, out, res.table.numpy()


def _same(got, want, rtol=1e-13):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=0)


def test_load_injected_matches_jax(solved):
    params, table, _ = solved
    p, lin, norm = tinj.load_injected(TCfg(nk=NK), params, table)
    pj, lin_j, norm_j = jinj.load_injected(JCfg(nk=NK), params, table)
    assert p.z_out == pj.z_out and p.z_interp_str == pj.z_interp_str
    assert lin.beta_raw.shape == (len(p.z_interp), NK)
    for name in lin._fields:
        _same(getattr(lin, name), getattr(lin_j, name))
    assert norm == pytest.approx(norm_j, rel=1e-13, abs=0)
    blocks = tinj.read_output_blocks(table, NK)
    np.testing.assert_array_equal(blocks, jinj.read_output_blocks(table, NK))
    # massless: T over the solver k range and an empty stack
    massless = dataclasses.replace(p, Omega_nu=0.0)
    lin0, norm0 = tinj.reconstruct_linear(TCfg(nk=NK), massless, blocks)
    lin0_j, norm0_j = jinj.reconstruct_linear(
        JCfg(nk=NK), dataclasses.replace(pj, Omega_nu=0.0), blocks)
    assert lin0.beta_raw.shape == (0, 0)
    for name in lin0._fields:
        _same(getattr(lin0, name), getattr(lin0_j, name))
    assert norm0 == pytest.approx(norm0_j, rel=1e-13, abs=0)


def test_injected_rerun_reproduces_the_linear_columns(solved):
    """The rerun from the injected inputs, P_lin_cb (column 3) against the
    table it was reconstructed from."""
    params, table, ref = solved
    p, lin, norm = tinj.load_injected(TCfg(nk=NK), params, table)
    settings, cosmo = td.settings_from_params(p)
    res = td.run_pipeline(TCfg(nk=NK), settings, cosmo, lin, device="cpu",
                          norm_override=norm)
    got = res.table.numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    rel = np.abs(got[..., 3] / ref[..., 3] - 1.0)
    assert rel[-1].max() < 1e-9
    assert rel.max() < 5e-3


def test_reconstruct_refuses_what_it_cannot_use(solved):
    params, table, _ = solved
    blocks = tinj.read_output_blocks(table, NK)
    cases = {
        "redshift blocks": (lambda p: p, blocks[1:]),
        "PRINTLIN": (lambda p: dataclasses.replace(p, print_lin=0), blocks),
        "z=0 block": (lambda p: dataclasses.replace(
            p, z_out=[3.0, 2.0, 1.0, 0.5]), blocks),
        "strictly decreasing": (lambda p: dataclasses.replace(
            p, z_interp_str=list(reversed(p.z_interp_str))), blocks),
    }
    p, pj = read_params_file(params), j_read_params(params)
    for match, (edit, b) in cases.items():
        with pytest.raises(ValueError, match=match):
            tinj.reconstruct_linear(TCfg(nk=NK), edit(p), b)
        with pytest.raises(ValueError, match=match):
            jinj.reconstruct_linear(JCfg(nk=NK), edit(pj), b)
    with pytest.raises(ValueError, match="PRINTLIN"):
        tinj.reconstruct_linear(TCfg(nk=NK), p, blocks[..., :9])
