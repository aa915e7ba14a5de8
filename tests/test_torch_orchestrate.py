"""The port's CAMB orchestration (redtime_tpu_torch.orchestrate, the port
of scripts/run_redtime.py), its design writer and its demo, on the CPU.

* derive, make_camb_ini, write_params and generate_design give what
  scripts/run_redtime.py and redtime_tpu.design give, byte for byte;
* with tests/mock_camb.py as the CAMB binary: the two CAMB passes per
  model and the sigma_8 rescale A_s *= (sigma8_target/sigma8)^2
  (runRedTime:161-186), the files run_model writes equal to
  run_redtime.run_model's, and the single-model solve equal to
  run_pipeline on the same params file (cf. tests/test_orchestration.py);
* examples/2_scripts' design (3 massive-nu models) through
  orchestrate.main at --nk 32 on the CPU: per-model transfer roots, six
  CAMB passes, one batch, a finite table per model, each its own;
* the demo at --nk 16 with 2 models writes its emulator files.
"""

import argparse
import filecmp
import os
import sys

import numpy as np
import pytest

import torch_port_util  # noqa: F401  (one torch thread per worker)
from redtime_tpu import design as jdesign
from redtime_tpu_torch import demo, design, orchestrate
from redtime_tpu_torch import driver as td
from redtime_tpu_torch.config import SolverConfig
from redtime_tpu_torch.io import read_params_file
from redtime_tpu_torch.io.camb import load_from_params

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
MOCK_CAMB = os.path.join(HERE, "mock_camb.py")
EXAMPLE = os.path.join(REPO, "examples", "2_scripts")
sys.path.insert(0, os.path.join(REPO, "scripts"))

import run_redtime  # noqa: E402

BASE_AMP = 2.15903458773893e-9
MOCK_BASE_SIGMA8 = 0.8
MODELS = [("TESTNU", 0.1335, 0.02258, 0.85, 0.71, 0.963, -0.9, 0.1, 0.001),
          ("TESTL", 0.1335, 0.02258, 0.8, 0.71, 0.963, -1.0, 0.0, 0.0)]


def _amps(outdir):
    with open(os.path.join(outdir, "mock_camb_amps.log")) as f:
        return [float(x) for x in f.read().split()]


def _text(path):
    with open(path) as f:
        return f.read()


def _args(outdir):
    return argparse.Namespace(output_dir=str(outdir), camb_exec=MOCK_CAMB,
                              template_dir=None, modern_camb=False)


def test_constants_and_derivations_match():
    for name in ("SCALAR_AMP", "CAMB_Z_LIST", "TCMB", "TAU"):
        assert getattr(orchestrate, name) == getattr(run_redtime, name)
    with open(orchestrate.TEMPLATE, "rb") as f, open(os.path.join(
            REPO, "scripts", "templates", "camb_modern.ini"), "rb") as g:
        assert f.read() == g.read()
    for m in MODELS:
        _, om_m, om_b, _, h, _, _, _, om_nu = m
        assert orchestrate.derive(om_m, om_b, om_nu, h) == \
            run_redtime.derive(om_m, om_b, om_nu, h)


@pytest.mark.parametrize("amp", ["2.15903458773893", "2.3456789012345"])
def test_camb_ini_byte_equal(amp):
    template = os.path.join(REPO, "scripts", "templates", "camb_modern.ini")
    for _, om_m, om_b, _, h, ns, w0, wa, om_nu in MODELS:
        args = (template, "/out/camb_X", om_b, om_m - om_b - om_nu, om_nu,
                h, w0, wa, ns, amp)
        got = orchestrate.make_camb_ini(*args)
        assert got == run_redtime.make_camb_ini(*args)
        assert orchestrate.make_camb_ini(orchestrate.TEMPLATE,
                                         *args[1:]) == got
        assert f"scalar_amp(1)      = {amp}e-9" in got


def test_write_params_and_design_byte_equal(tmp_path):
    z_out = ["2.02", "1.006", "0.434", "0"]
    for m in MODELS:
        for pkg, sub in ((orchestrate, "port"), (run_redtime, "jax")):
            os.makedirs(tmp_path / sub, exist_ok=True)
            pkg.write_params(str(tmp_path / sub / f"p_{m[0]}.dat"), *m,
                             z_out, transfer_root=f"camb_{m[0]}_transfer_z")
        assert filecmp.cmp(tmp_path / "port" / f"p_{m[0]}.dat",
                           tmp_path / "jax" / f"p_{m[0]}.dat", shallow=False)
    for n, seed in ((3, 1), (16, 42)):
        design.generate_design(str(tmp_path / "d_port.dat"), n, seed)
        jdesign.generate_design(str(tmp_path / "d_jax.dat"), n, seed)
        assert filecmp.cmp(tmp_path / "d_port.dat", tmp_path / "d_jax.dat",
                           shallow=False)
    models = np.random.default_rng(7).random((5, 8))
    for pkg, sub in ((design, "port"), (jdesign, "jax")):
        with open(tmp_path / f"w_{sub}.dat", "w") as f:
            pkg.write_models_file(f, models)
    assert filecmp.cmp(tmp_path / "w_port.dat", tmp_path / "w_jax.dat",
                       shallow=False)


def test_run_model_two_passes_match_the_script(tmp_path):
    """run_model with the mock CAMB: two passes, the second at the
    rescaled amplitude, and the params file, the ini of the second pass
    (its output root aside) and every transfer file equal to
    run_redtime.run_model's."""
    for m in MODELS:
        paths = {}
        for pkg, sub in ((orchestrate, "port"), (run_redtime, "jax")):
            paths[sub] = pkg.run_model(_args(tmp_path / m[0] / sub), m,
                                       ["1.0", "0.0"], f"camb_{m[0]}")
        port, jax_dir = (os.path.dirname(paths[s]) for s in ("port", "jax"))
        amps = _amps(port)
        assert amps == _amps(jax_dir) and len(amps) == 2
        assert amps[0] == pytest.approx(BASE_AMP, rel=1e-14)
        s8_1 = MOCK_BASE_SIGMA8 * np.sqrt(amps[0] / BASE_AMP)
        assert amps[1] == pytest.approx(BASE_AMP * (m[3] / s8_1) ** 2,
                                        rel=1e-12)
        names = sorted(os.listdir(port))
        assert names == sorted(os.listdir(jax_dir))
        assert len([n for n in names if "_transfer_z" in n]) == 33
        for name in names:
            a, b = (_text(os.path.join(d, name)) for d in (port, jax_dir))
            assert a.replace(port, "") == b.replace(jax_dir, ""), name
        split = "0" if m[-1] else "3.046"
        assert f"massless_neutrinos = {split}" in _text(
            os.path.join(port, "temp_camb.ini"))


def test_single_model_solve_equals_run_pipeline(tmp_path):
    """orchestrate.main with 9 model arguments: the reference's
    `camb_transfer_z*` root, switches 1 0 1 1, and the `run` table equal
    to run_pipeline on the same params file (the printed 12 digits)."""
    outdir = tmp_path / "out"
    (tmp_path / "z.txt").write_text("1.0 0.0\n")
    m = ("ONE", 0.1335, 0.02258, 0.84, 0.71, 0.963, -1.0, 0.0, 0.0)
    rc = orchestrate.main(["--redshift-file", str(tmp_path / "z.txt"),
                           "--output-dir", str(outdir), "--camb-exec",
                           MOCK_CAMB, "--platform", "cpu", "--nk", "32"]
                          + [str(x) for x in m])
    assert rc == 0 and len(_amps(outdir)) == 2
    assert os.path.exists(outdir / "camb_transfer_z0.dat")
    p = read_params_file(str(outdir / "params_redTime_ONE.dat"))
    assert (p.switch_nonlinear, p.switch_1loop, p.print_lin,
            p.print_rsd) == (1, 0, 1, 1)
    assert p.transfer_file == "camb_transfer_z0.dat"
    assert len(p.z_interp_str) == 33 and p.z_out == [1.0, 0.0]
    table = np.loadtxt(outdir / "redTime_ONE.dat")
    settings, cosmo = td.settings_from_params(p)
    res = td.run_pipeline(SolverConfig(nk=32), settings, cosmo,
                          load_from_params(p, str(outdir)), device="cpu")
    direct = res.table.numpy().reshape(-1, 17)
    scale = np.max(np.abs(direct), axis=0, keepdims=True) + 1e-300
    assert np.max(np.abs(table - direct) / scale) < 1e-10
    assert np.all(table[:, 13:17] == 0.0)     # full TRG prints no B terms


def test_examples_design_through_the_port(tmp_path):
    """examples/2_scripts/models.dat (3 massive-nu models) and its
    target redshifts through orchestrate.main: one CAMB transfer root per
    model, 2 CAMB passes each, one batch at --nk 32, one finite table per
    model, no two alike."""
    outdir = tmp_path / "output"
    rc = orchestrate.main([
        "--redshift-file", os.path.join(EXAMPLE, "target_redshifts.txt"),
        "--models-file", os.path.join(EXAMPLE, "models.dat"),
        "--output-dir", str(outdir), "--camb-exec", MOCK_CAMB,
        "--platform", "cpu", "--nk", "32", "--timing"])
    assert rc == 0
    names = ["X001", "X002", "X003"]
    assert len(_amps(outdir)) == 2 * len(names)
    with open(os.path.join(EXAMPLE, "target_redshifts.txt")) as f:
        n_z = len(f.read().split())
    tables = []
    for name in names:
        p = read_params_file(str(outdir / f"params_redTime_{name}.dat"))
        assert p.nu_transfer_root == f"camb_{name}_transfer_z"
        assert p.transfer_file == f"camb_{name}_transfer_z0.dat"
        assert os.path.exists(outdir / p.transfer_file)
        t = np.loadtxt(outdir / f"redTime_{name}.dat")
        assert t.shape == (n_z * 32, 17) and np.isfinite(t).all()
        tables.append(t)
    for i in range(3):
        for j in range(i + 1, 3):
            assert not np.allclose(tables[i][:, 7], tables[j][:, 7],
                                   rtol=1e-6)


def test_orchestrate_needs_a_model():
    with pytest.raises(SystemExit):
        orchestrate.main(["--redshift-file", os.path.join(
            EXAMPLE, "target_redshifts.txt"), "A", "0.1"])


def test_demo_on_the_cpu(tmp_path, capsys):
    """The demo at --nk 16 with 2 models: its design, the 33-redshift
    batch and the step-499 emulator files."""
    assert demo.main(["--workdir", str(tmp_path), "--n-models", "2",
                      "--nk", "16", "--platform", "cpu"]) == 0
    assert "demo complete" in capsys.readouterr().out
    for mn in (1, 2):
        t = np.loadtxt(tmp_path / f"redTime_M{mn:03d}.dat")
        assert t.shape == (33 * 16, 17) and np.isfinite(t).all()
        with open(tmp_path / "STEP499" / f"pk_M{mn:03d}_no_interp_test.dat"
                  ) as f:
            pk = np.array(f.read().split(), dtype=float)
        assert pk.shape == (16,) and np.all(pk > 0)
