"""The port's emulator post-processing (redtime_tpu_torch.convert and the
CLI's `convert` / `convert-full`) against redtime_tpu.convert.

Inputs are made from a seed with numpy: a design written by the port's
design.generate_design, 33-block PRINTLIN output tables written by the
port's writer (the redTime format), and PM / HACC N-body spectra.  Every
file each function writes must be byte-equal to the JAX module's on the
same inputs, and every array it returns equal.
"""

import filecmp
import os
import types

import numpy as np
import pytest

import torch_port_util  # noqa: F401  (one torch thread per worker)
from redtime_tpu import convert as jconv
from redtime_tpu_torch import cli, design
from redtime_tpu_torch import convert as tconv
from redtime_tpu_torch.io.writer import write_result_to_path

NK, NZ, N_MODELS, N_PM = 16, 33, 3, 2
STEP = 300


def _table(rng) -> np.ndarray:
    """A [33, NK, 17] output table: k, D, f, P_lin_cb, B, dlnB, P_lin_nu,
    P_dd and 9 nonlinear / RSD columns."""
    k = np.logspace(-3, 0, NK)
    t = np.empty((NZ, NK, 17))
    t[:, :, 0] = k
    t[:, :, 1] = 0.5 + 0.4 * rng.random((NZ, NK))
    t[:, :, 2:] = 10.0 * (1.0 + rng.random((NZ, NK, 15)))
    t[:, :, 7] *= 10.0
    return t


def _write_table(path: str, table: np.ndarray) -> None:
    z = np.linspace(3.0, 0.0, NZ)
    res = types.SimpleNamespace(
        table=table, eta=np.log(201.0 / (1.0 + z)), a=1.0 / (1.0 + z), z=z,
        H=np.full(NZ, 3e-4), sigma_v2=np.full(NZ, 30.0), sigmaV2_z0=37.9,
        eta_fin=np.log(201.0))
    write_result_to_path(path, res, "params_redTime.dat")


def _pk_file(path: str, n: int, seed: int, ncol: int = 3) -> None:
    """An N-body P(k) file of ncol columns: '#' header, then k, P,
    ncol - 3 others, counts."""
    r = np.random.default_rng(seed)
    kk = np.linspace(2e-3, 1.4, n)
    cols = [kk, 50.0 * (1.0 + r.random(n))]
    cols += [1.0 + r.random(n) for _ in range(ncol - 3)]
    cols.append(10.0 + 100.0 * r.random(n))
    np.savetxt(path, np.column_stack(cols), header="k P counts")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A design of N_MODELS models, their tables, and PM / HACC spectra."""
    d = tmp_path_factory.mktemp("convert_inputs")
    design.generate_design(str(d / "models.dat"), N_MODELS, seed=5)
    rng = np.random.default_rng(2024)
    for mn in range(1, N_MODELS + 1):
        _write_table(str(d / f"redTime_M{mn:03d}.dat"), _table(rng))
        for pm in range(N_PM):
            _pk_file(str(d / f"m{mn}_pm{pm}.dat"), 12 + pm, 10 * mn + pm,
                     ncol=3 + pm)
        _pk_file(str(d / f"m{mn}_hacc.dat"), 20, 99 + mn, ncol=5)
    return d


def _same_tree(a: str, b: str) -> list:
    """The files under a and b (equal names), each byte-equal."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name
    return names


def test_constants_and_readers_match(inputs):
    assert tconv.STEP_TO_ZBLOCK == jconv.STEP_TO_ZBLOCK
    path = str(inputs / "models.dat")
    assert tconv.read_models_file(path) == jconv.read_models_file(path)
    tab = str(inputs / "redTime_M001.dat")
    got = tconv.read_redtime_table(tab, NK)
    np.testing.assert_array_equal(got, jconv.read_redtime_table(tab, NK))
    assert got.shape == (NZ, NK, 17)
    with pytest.raises(ValueError, match="not divisible"):
        tconv.read_redtime_table(tab, NK + 1)
    for name in ("m1_pm0.dat", "m1_pm1.dat", "m2_hacc.dat"):
        for col in (None, 2):
            np.testing.assert_array_equal(
                tconv.read_pk_file(str(inputs / name), 0.7, col),
                jconv.read_pk_file(str(inputs / name), 0.7, col))
    for nk in (351, 3000):
        np.testing.assert_array_equal(tconv.mt_emulator_kgrid(nk),
                                      jconv.mt_emulator_kgrid(nk))
    with pytest.raises(ValueError):
        tconv.mt_emulator_kgrid(200)


@pytest.mark.parametrize("step", sorted(jconv.STEP_TO_ZBLOCK))
def test_convert_pt_files_byte_equal(inputs, tmp_path, step):
    """convert_pt at every HACC step: the k_ and pk_ files of each model,
    byte for byte; convert_pt_one's arrays equal."""
    for pkg, sub in ((jconv, "jax"), (tconv, "port")):
        os.makedirs(tmp_path / sub)
        for mn in range(1, N_MODELS + 1):
            os.link(inputs / f"redTime_M{mn:03d}.dat",
                    tmp_path / sub / f"redTime_M{mn:03d}.dat")
        pkg.convert_pt(N_MODELS, step, NK, str(inputs / "models.dat"),
                       str(tmp_path / sub))
    names = _same_tree(str(tmp_path / "jax" / f"STEP{step}"),
                       str(tmp_path / "port" / f"STEP{step}"))
    assert len(names) == 2 * N_MODELS
    table = tconv.read_redtime_table(str(inputs / "redTime_M002.dat"), NK)
    for a, b in zip(tconv.convert_pt_one(table, 0.7, 0.98, step),
                    jconv.convert_pt_one(table, 0.7, 0.98, step)):
        np.testing.assert_array_equal(a, b)


def test_process_pt_full_and_interp_match(inputs):
    path = str(inputs / "redTime_M003.dat")
    for step in (163, 499):
        for a, b in zip(tconv.process_pt_full(path, 0.7, step, NK),
                        jconv.process_pt_full(path, 0.7, step, NK)):
            np.testing.assert_array_equal(a, b)
    k = np.linspace(0.01, 1.0, 20)
    y = np.sin(3.0 * k)
    kq = np.linspace(0.0, 1.2, 50)
    np.testing.assert_array_equal(tconv._natural_cubic(k, y)(kq[5:40]),
                                  jconv._natural_cubic(k, y)(kq[5:40]))
    np.testing.assert_array_equal(tconv._interp_to_grid(kq, k, y),
                                  jconv._interp_to_grid(kq, k, y))


@pytest.mark.parametrize("grid", [False, True], ids=["no_interp",
                                                     "interp_grid"])
def test_convert_pk_full_files_byte_equal(inputs, tmp_path, grid):
    """convert_pk_full over every model of the design, the ragged
    no-interp layout and the shared emulator grid, with the HACC counts in
    the literal column 2 and in the last column."""
    kw = dict(nk_pt=NK, n_pm=N_PM)
    if grid:
        kw.update(interp_grid=tconv.mt_emulator_kgrid(351, kmin=2e-3,
                                                      kmax=1.3),
                  suffix="interp", hacc_counts_col=None)
    for pkg, sub in ((jconv, "jax"), (tconv, "port")):
        pkg.convert_pk_full(str(inputs / "models.dat"), STEP,
                            str(tmp_path / sub),
                            str(inputs / "redTime_M{model:03d}.dat"),
                            str(inputs / "m{model}_pm{pm}.dat"),
                            str(inputs / "m{model}_hacc.dat"), **kw)
    names = _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert len(names) == 3 * N_MODELS


def test_cli_convert_commands_byte_equal(inputs, tmp_path):
    """The port's CLI `convert` and `convert-full` (with --models) write
    what the JAX functions write."""
    for mn in range(1, N_MODELS + 1):
        for sub in ("jax", "port"):
            os.makedirs(tmp_path / sub, exist_ok=True)
            os.link(inputs / f"redTime_M{mn:03d}.dat",
                    tmp_path / sub / f"redTime_M{mn:03d}.dat")
    models = str(inputs / "models.dat")
    assert cli.main(["convert", "--n-models", str(N_MODELS), "--step", "499",
                     "--nk", str(NK), "--models-file", models, "--red-dir",
                     str(tmp_path / "port")]) == 0
    jconv.convert_pt(N_MODELS, 499, NK, models, str(tmp_path / "jax"))
    _same_tree(str(tmp_path / "jax" / "STEP499"),
               str(tmp_path / "port" / "STEP499"))
    templates = [str(inputs / "redTime_M{model:03d}.dat"),
                 str(inputs / "m{model}_pm{pm}.dat"),
                 str(inputs / "m{model}_hacc.dat")]
    assert cli.main(["convert-full", "--design", models, "--step", "247",
                     "-o", str(tmp_path / "full_port"), "--pt-template",
                     templates[0], "--pm-template", templates[1],
                     "--hacc-template", templates[2], "--models", "1", "3",
                     "--nk", str(NK), "--n-pm", str(N_PM)]) == 0
    jconv.convert_pk_full(models, 247, str(tmp_path / "full_jax"),
                          *templates, models=[1, 3], nk_pt=NK, n_pm=N_PM)
    assert len(_same_tree(str(tmp_path / "full_jax"),
                          str(tmp_path / "full_port"))) == 6


def test_tns_ab_matches():
    rng = np.random.default_rng(7)
    block = rng.standard_normal((NK, 17))
    for mu in (0.5, np.array([0.0, 0.3, 1.0])):
        for a, b in zip(tconv.tns_ab(block, mu), jconv.tns_ab(block, mu)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tconv.tns_ab(block[:, :16], 0.5)
