"""The batch-design example on the PyTorch port
(examples/2_scripts/runModels_torch), the counterpart of
tests/test_examples_scripts.py's runModels test: the bundled models.dat
and target_redshifts.txt through the script with tests/mock_camb.py as
the CAMB binary, on the CPU at --nk 32 (python -m
redtime_tpu_torch.orchestrate in a child process): two CAMB passes a
model, one finite table a model, and the tables of orchestrate.main run
in this process with the same arguments.  Both run on one torch thread,
but MKL's f64 kernels are not bit-reproducible across processes (they
follow the operands' alignment), and the controller turns ulps into other
step sequences: the controller band of column scale (3e-5), the linear
columns within 1e-10 (tests/test_torch_slice.py's chunked-run bound).
"""

import os
import subprocess

import numpy as np

from torch_port_util import col_scale_dev
from redtime_tpu_torch import orchestrate

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
EXAMPLE = os.path.join(REPO, "examples", "2_scripts")
SCRIPT = os.path.join(EXAMPLE, "runModels_torch")
MOCK_CAMB = os.path.join(HERE, "mock_camb.py")
NAMES = ("X001", "X002", "X003")


def _amps(outdir) -> list:
    with open(os.path.join(outdir, "mock_camb_amps.log")) as f:
        return [float(x) for x in f.read().split()]


def test_run_models_torch_end_to_end(tmp_path):
    out = tmp_path / "script"
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    p = subprocess.run(
        ["bash", SCRIPT, MOCK_CAMB, "--platform", "cpu", "--nk", "32",
         "--output-dir", str(out)], capture_output=True, text=True,
        env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert len(_amps(out)) == 2 * len(NAMES)

    ref = tmp_path / "main"
    rc = orchestrate.main([
        "--redshift-file", os.path.join(EXAMPLE, "target_redshifts.txt"),
        "--models-file", os.path.join(EXAMPLE, "models.dat"),
        "--output-dir", str(ref), "--camb-exec", MOCK_CAMB,
        "--platform", "cpu", "--nk", "32"])
    assert rc == 0
    with open(os.path.join(EXAMPLE, "target_redshifts.txt")) as f:
        n_z = len(f.read().split())
    for name in NAMES:
        t = np.loadtxt(out / f"redTime_{name}.dat")
        assert t.shape == (n_z * 32, 17) and np.isfinite(t).all()
        r = np.loadtxt(ref / f"redTime_{name}.dat")
        assert col_scale_dev(t, r, 0) < 3e-5
        np.testing.assert_allclose(t[:, :7], r[:, :7], rtol=1e-10, atol=0)


def test_run_models_torch_without_camb_uses_the_transfer_files(tmp_path):
    """With no CAMB binary the script passes its arguments on and the
    solver reads the transfer files already in --output-dir: here none,
    so orchestrate fails, and says which file."""
    p = subprocess.run(
        ["bash", SCRIPT, "--platform", "cpu", "--nk", "32", "--output-dir",
         str(tmp_path)], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert p.returncode != 0
    assert "camb_X001_transfer_z" in p.stderr + p.stdout
