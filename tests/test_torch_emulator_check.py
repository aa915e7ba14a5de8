"""The port's emulator-comparison harness (redtime_tpu_torch.emulator_check)
against redtime_tpu.emulator_check on inputs made from a seed with numpy:
two redTime-format tables written by the port's writer and a synthetic
Mira-Titan emulator directory (yFull / logk / params_ce).  Every result
equals JAX's to 1e-14 relative; the reference CI criteria raise alike.
"""

import types

import numpy as np
import pytest

import torch_port_util  # noqa: F401  (one torch thread per worker)
from redtime_tpu import emulator_check as jec
from redtime_tpu_torch import emulator_check as tec
from redtime_tpu_torch.io.writer import write_result_to_path

NK, NZ = 32, 4
OM_NU, OM_M = 0.005, 0.3


def _write(path: str, table: np.ndarray) -> None:
    z = np.linspace(2.0, 0.0, NZ)
    write_result_to_path(path, types.SimpleNamespace(
        table=table, eta=np.log(201.0 / (1.0 + z)), a=1.0 / (1.0 + z), z=z,
        H=np.full(NZ, 3e-4), sigma_v2=np.full(NZ, 30.0), sigmaV2_z0=37.9,
        eta_fin=np.log(201.0)))


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Two tables on one k grid, the second's P_dd scaled by 1 + eps(k)
    with eps up to 2e-3 at k = 1 (0 at the lowest k)."""
    d = tmp_path_factory.mktemp("emu")
    rng = np.random.default_rng(31)
    k = np.logspace(-3, 0, NK)
    t = np.empty((NZ, NK, 17))
    t[:, :, 0] = k
    t[:, :, 1:] = 1.0 + rng.random((NZ, NK, 16))
    t[:, :, 6] *= 0.01                       # P_lin_nu << P_lin_cb
    t[:, :, 7] *= 1e3 / k
    other = t.copy()
    other[:, :, 7] *= 1.0 + 2e-3 * (k - k[0]) / (k[-1] - k[0])
    _write(str(d / "ours.dat"), t)
    _write(str(d / "target.dat"), other)
    return d, t


@pytest.fixture(scope="module")
def emu_dir(tmp_path_factory):
    """A synthetic CosmicEmu directory: 3 output redshifts x 351 log k
    rows of log10 Delta^2 for 4 models, logk, and params_ce [9, 4]."""
    d = tmp_path_factory.mktemp("emulator")
    rng = np.random.default_rng(17)
    logk = np.linspace(-3.0, 1.0, 351)
    yfull = (np.vstack([0.3 * i + 1.5 * logk[:, None]
                        + 0.1 * rng.random((351, 4)) for i in range(3)]))
    params = np.vstack([0.13 + 0.02 * rng.random(4),
                        0.022 + 0.001 * rng.random(4),
                        0.8 + 0.05 * rng.random(4),
                        0.6 + 0.2 * rng.random(4),
                        0.95 + 0.03 * rng.random(4), -np.ones(4),
                        np.zeros(4), 0.001 * rng.random(4), np.zeros(4)])
    np.savetxt(d / "yFull.txt", yfull)
    np.savetxt(d / "logk.txt", logk)
    np.savetxt(d / "params_ce.txt", params)
    return str(d)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-14, atol=0)


@pytest.mark.parametrize("nu", [(0.0, 1.0), (OM_NU, OM_M)],
                         ids=["massless", "massive"])
def test_corrected_power_and_comparison_match(tables, nu):
    d, t = tables
    for iz in (-1, 0):
        for a, b in zip(tec.corrected_nonlinear_power(t, *nu, iz=iz),
                        jec.corrected_nonlinear_power(t, *nu, iz=iz)):
            _close(a, b)
    for k_max in (0.1, 1.1):
        got = tec.compare_outputs(str(d / "ours.dat"), str(d / "target.dat"),
                                  NK, k_max, *nu)
        want = jec.compare_outputs(str(d / "ours.dat"),
                                   str(d / "target.dat"), NK, k_max, *nu)
        assert type(got).__name__ == "ComparisonResult"
        for a, b in zip(got, want):
            _close(a, b)


def test_criteria_raise_alike(tables):
    d, _ = tables
    ours, target = str(d / "ours.dat"), str(d / "target.dat")
    same = tec.compare_outputs(ours, ours, NK, om_nu=OM_NU, om_m=OM_M)
    assert same.max_abs == 0.0 and same.q95 == 0.0
    tec.assert_reference_criteria(same, massive=True)
    tec.assert_reference_criteria(same)
    # up to 2e-3 at k = 1: over the massless 1e-3 bar when k_max takes in
    # the whole grid, inside the massive 5e-3 max but over its 1e-3 q95
    wide = tec.compare_outputs(ours, target, NK, k_max=1.1)
    for massive, match in ((False, "massless-nu max"),
                           (True, "massive-nu q95")):
        with pytest.raises(AssertionError, match=match):
            tec.assert_reference_criteria(wide, massive=massive)
        with pytest.raises(AssertionError, match=match):
            jec.assert_reference_criteria(
                jec.compare_outputs(ours, target, NK, k_max=1.1),
                massive=massive)
    bad = tec.ComparisonResult(np.ones(2), np.ones(2), 6e-3, 1e-4)
    with pytest.raises(AssertionError, match="massive-nu max"):
        tec.assert_reference_criteria(bad, massive=True)


def test_k_grids_must_agree(tables, tmp_path):
    d, t = tables
    shifted = t.copy()
    shifted[:, :, 0] *= 1.01
    _write(str(tmp_path / "shifted.dat"), shifted)
    with pytest.raises(ValueError, match="k grids differ"):
        tec.compare_outputs(str(d / "ours.dat"), str(tmp_path / "shifted.dat"),
                            NK)


def test_cosmicemu_recipe_matches(emu_dir, tables):
    got, want = tec.load_cosmicemu(emu_dir), jec.load_cosmicemu(emu_dir)
    assert got.logP.shape == (351, 4) and got.params.shape == (9, 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    _, t = tables
    k, P = tec.corrected_nonlinear_power(t, OM_NU, OM_M)
    for h in (0.6, 0.73):
        _close(tec.dimensionless_power(k * h, P, h),
               jec.dimensionless_power(k * h, P, h))
        for i in range(4):
            for n_low in (10, 40):
                _close(tec.emulator_rel_err(k, P, h, got, i, n_low),
                       jec.emulator_rel_err(k, P, h, want, i, n_low))
