"""The solver presets of the PyTorch port at their grids, against the JAX
package, on the CPU: SolverConfig.high_accuracy (the reference's
HIGH_ACCURACY build: nk=512, np=2048, eabs 1e-15, erel 1e-6) and
SolverConfig.v01_compat (nk=256, np_factor 8, a_early=1e-50 in prepare's
growth ramp, growth_h_reset), each with tests/test_configs.py's SMALL
growth and quadrature tables, one cosmology (__graft_entry__'s), 1-loop
mode, z_out = (0,): the port's run_pipeline against the JAX package's
(mode='fft') on the same inputs.

Held to the controller band, 3e-5 of column scale
(tests/test_segmented.py:50-51); the linear columns, which bypass the
integrator, and the sigma_v^2, H and sigmaV2(z=0) headers within 1e-10
relative.
"""

import numpy as np
import pytest

from __graft_entry__ import _cosmo, _example_inputs
from torch_port_util import col_scale_dev
from redtime_tpu import driver as jd
from redtime_tpu.config import RunSettings as JSet
from redtime_tpu.config import SolverConfig as JCfg
from redtime_tpu_torch import driver as td
from redtime_tpu_torch.config import RunSettings as TSet
from redtime_tpu_torch.config import SolverConfig as TCfg
from redtime_tpu_torch.state import cosmo_from_numpy

SMALL = dict(growth_n_lna=16, growth_n_lnk=8, quad_panels=16, quad_order=8)
SETTINGS = dict(one_loop=True, z_out=(0.0,))


@pytest.mark.parametrize("preset, nk, npts", [
    ("high_accuracy", 512, 2048), ("v01_compat", 256, 2048)])
def test_preset_matches_jax(preset, nk, npts):
    jc = getattr(JCfg, preset)(fft_mode="fft", **SMALL)
    tc = getattr(TCfg, preset)(**SMALL)
    assert (tc.nk, tc.npts) == (jc.nk, jc.npts) == (nk, npts)
    lin = _example_inputs(jc)
    rj = jd.run_pipeline(jc, JSet(**SETTINGS), _cosmo(), lin, mode="fft")
    one = cosmo_from_numpy(_cosmo())
    rt = td.run_pipeline(tc, TSet(**SETTINGS), type(one)(*[x[0] for x in one]),
                         type(lin)(*[np.asarray(x) for x in lin]),
                         device="cpu")
    got, ref = rt.table.numpy(), np.asarray(rj.table)
    assert got.shape == ref.shape == (1, nk, 17)
    assert bool(np.isfinite(got).all())
    assert col_scale_dev(got, ref, (0, 1)) < 3e-5
    np.testing.assert_allclose(got[..., :7], ref[..., :7], rtol=1e-10,
                               atol=0)
    for name in ("sigma_v2", "H", "sigmaV2_z0"):
        np.testing.assert_allclose(getattr(rt, name).numpy(),
                                   np.asarray(getattr(rj, name)),
                                   rtol=1e-10, atol=0, err_msg=name)
    for name in ("k", "eta", "a", "z"):
        np.testing.assert_allclose(getattr(rt, name).numpy(),
                                   np.asarray(getattr(rj, name)),
                                   rtol=1e-15, atol=0, err_msg=name)
