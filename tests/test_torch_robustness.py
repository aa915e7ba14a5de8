"""The port's failure paths, as tests/test_robustness.py holds the JAX
package's: a truncated params file raises with a diagnostic, a massless
params file (empty nu root) survives write -> read, settings beyond the
growth table raise like the reference's abort, and the pab extension
matrix's interior rows equal the interpolation rules (both packages
give the same message, values and rows).
"""

import numpy as np
import pytest

import torch_port_util  # noqa: F401  (one torch thread per worker)
from __graft_entry__ import _cosmo, _example_inputs
from redtime_tpu import driver as jd
from redtime_tpu.config import RunSettings as JSet
from redtime_tpu.config import SolverConfig as JCfg
from redtime_tpu.io import params as jparams
from redtime_tpu_torch import driver as td
from redtime_tpu_torch import interp
from redtime_tpu_torch.config import RunSettings, SolverConfig
from redtime_tpu_torch.grids import make_grids, pab_extension_matrix
from redtime_tpu_torch.io import params


@pytest.mark.parametrize("text", [
    "0.96 0.8 0.68 0.3 0.048 0.0 2.726 -1.0 0.0\n1 0 1 1\n",
    "0.96 0.8 0.68\n",
    "0.96 0.8 0.68 0.3 0.048 0.0 2.726 -1.0 0.0\n1 0 1 1\n200\n3 2 1\n"])
def test_params_truncation_diagnostic(tmp_path, text):
    path = tmp_path / "params_trunc.dat"
    path.write_text(text)
    with pytest.raises(ValueError, match="truncated") as got:
        params.read_params_file(str(path))
    with pytest.raises(ValueError, match="truncated") as want:
        jparams.read_params_file(str(path))
    assert str(got.value) == str(want.value)


def test_params_roundtrip_empty_nu_root(tmp_path):
    """A massless-nu config (empty nu root, no interp redshifts) survives
    write -> read, and the file reads the same in the JAX package."""
    p0 = params.ParamsFile(
        0.96, 0.8, 0.68, 0.3, 0.048, 0.0, 2.726, -1.0, 0.0,
        1, 0, 1, 1, 200.0, [1.0, 0.0], "camb_transfer_z0.dat", 0, "", [])
    path = str(tmp_path / "params_rt.dat")
    params.write_params_file(path, p0)
    p1 = params.read_params_file(path)
    assert p1.z_out == p0.z_out and p1.transfer_file == p0.transfer_file
    assert p1.z_interp_str == [] and p1.nu_transfer_root == "none"
    assert vars(jparams.read_params_file(path)) == vars(p1)


@pytest.mark.parametrize("kw", [dict(z_in=1500.0, z_out=(0.0,)),
                                dict(z_in=200.0, z_out=(1.0, -0.2))],
                         ids=["z_in_before_a_min", "z_out_past_a_max"])
def test_growth_range_validation(kw):
    """An a range outside [growth_a_min, growth_a_max] raises before any
    work (the reference aborts; a table lookup would extrapolate)."""
    cfg = SolverConfig(nk=16, growth_n_lna=40, growth_n_lnk=16)
    lin = _example_inputs(JCfg(nk=16))
    with pytest.raises(ValueError, match="growth table") as got:
        td.run_pipeline(cfg, RunSettings(one_loop=True, **kw), _cosmo(0),
                        lin, device="cpu")
    with pytest.raises(ValueError, match="growth table") as want:
        jd.run_pipeline(JCfg(nk=16, growth_n_lna=40, growth_n_lnk=16),
                        JSet(one_loop=True, **kw), _cosmo(0), lin)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cfg", [SolverConfig(), SolverConfig(nk=48),
                                 SolverConfig.v01_compat()],
                         ids=["default", "nk48", "v01_compat"])
def test_pab_matrix_interior_rows_match_interp(cfg):
    """pab_extension_matrix's interior / edge bracketing equals
    interp.weight_matrix_np (the rules live in both; only the
    right-extrapolation tail differs by design)."""
    g = make_grids(cfg)
    M, v = pab_extension_matrix(g)
    W = interp.weight_matrix_np(np.asarray(g.lnk), np.asarray(g.lnk_ext))
    inside = (g.lnk_ext >= g.lnk[0]) & (g.lnk_ext <= g.lnk[-1])
    assert inside.sum() == cfg.nk
    np.testing.assert_allclose(M[inside], W[inside], rtol=0, atol=1e-14)
    assert np.all(v[inside] == 0.0)
