"""The PyTorch port's jax-free copies of the host-side modules (params
file, CAMB transfer files, design generator) against the JAX package's.

Inputs are written to a temporary directory (7-column CAMB layout), so
the tests need no reference example files.
"""

import os

import numpy as np
import pytest

import torch_port_util  # noqa: F401  (torch threads, JAX on CPU)
from redtime_tpu import design as jdesign
from redtime_tpu import driver as jdriver
from redtime_tpu.io import camb as jcamb
from redtime_tpu.io import params as jparams
from redtime_tpu_torch import design as tdesign
from redtime_tpu_torch import driver as tdriver
from redtime_tpu_torch.io import camb as tcamb
from redtime_tpu_torch.io import params as tparams

Z_INTERP = ["200", "50", "10", "2", "1", ".5", "0"]


def _write_inputs(root, omega_nu=0.005):
    """A params file and a synthetic CAMB transfer stack under root."""
    rng = np.random.default_rng(8)
    k = np.logspace(-4, 1, 40)
    for z in ["0"] + Z_INTERP:
        cols = np.column_stack([k] + [np.abs(rng.standard_normal(40)) + 0.1
                                      for _ in range(6)])
        np.savetxt(os.path.join(root, f"tr_z{z}.dat"), cols, fmt="%.17g",
                   header="k c b g r nu tot")
    p = jparams.ParamsFile(
        n_s=0.96, sigma_8=0.8, h=0.68, Omega_m=0.3, Omega_b=0.048,
        Omega_nu=omega_nu, T_cmb=2.726, w0=-1.0, wa=0.1,
        switch_nonlinear=1, switch_1loop=0, print_lin=1, print_rsd=1,
        z_in=200.0, z_out=[2.0, 1.0, 0.0], transfer_file="tr_z0.dat",
        nu_approx=0, nu_transfer_root="tr_z", z_interp_str=Z_INTERP)
    path = os.path.join(root, "params_redTime.dat")
    jparams.write_params_file(path, p)
    return path


def test_params_file_roundtrip_matches_jax(tmp_path):
    path = _write_inputs(str(tmp_path))
    pj, pt = jparams.read_params_file(path), tparams.read_params_file(path)
    assert vars(pj) == vars(pt)
    out = os.path.join(str(tmp_path), "again.dat")
    tparams.write_params_file(out, pt)
    with open(out) as f, open(path) as g:
        assert f.read() == g.read()
    sj, cj = jdriver.settings_from_params(pj)
    st, ct = tdriver.settings_from_params(pt)
    assert vars(sj) == vars(st)
    for a, b in zip(cj, ct):
        assert float(a) == float(b)


@pytest.mark.parametrize("omega_nu", [0.005, 0.0], ids=["massive",
                                                        "massless"])
def test_linear_data_matches_jax(tmp_path, omega_nu):
    path = _write_inputs(str(tmp_path), omega_nu)
    p = jparams.read_params_file(path)
    lj = jcamb.load_from_params(p, str(tmp_path))
    lt = tcamb.load_from_params(tparams.read_params_file(path),
                                str(tmp_path))
    assert jcamb.LinearData._fields == tcamb.LinearData._fields
    for name in tcamb.LinearData._fields:
        np.testing.assert_array_equal(getattr(lt, name),
                                      np.asarray(getattr(lj, name)),
                                      err_msg=name)


def test_short_stack_is_rejected(tmp_path):
    _write_inputs(str(tmp_path))
    files = [os.path.join(str(tmp_path), f"tr_z{z}.dat") for z in "01"]
    with pytest.raises(ValueError):
        tcamb.load_linear_data(files[0], files, [0.0, 1.0])


def test_design_matches_jax():
    u = tdesign.latin_hypercube(16, seed=42)
    np.testing.assert_array_equal(u, jdesign.latin_hypercube(16, seed=42))
    np.testing.assert_array_equal(tdesign.models_from_unit_cube(u),
                                  jdesign.models_from_unit_cube(u))
