"""The port's command-line interface (redtime_tpu_torch/cli.py), its
writer's write_result_to_path and profiling.StageTimer, on the CPU.

Inputs are synthetic CAMB-format stacks and params files written with
the port's own io (chip_smoke.write_cli_inputs, as tests/test_cli.py's
mock stacks), solved at --nk 16.  The tables `batch` and `run` write are
parsed and held against the JAX package's library run_batch (mode='fft')
on the same files, read by the JAX package's own io and written by its
writer: within the controller band, 3e-5 of column scale
(tests/test_segmented.py:50-51), the linear columns and the header
scalars within 1e-10 relative.  The JAX CLI is not called in-process: it
changes global JAX config.
"""

import argparse
import dataclasses
import functools
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from torch_port_util import col_scale_dev
from redtime_tpu import driver as jd
from redtime_tpu import cli as jcli
from redtime_tpu.config import SolverConfig as JCfg
from redtime_tpu.io import read_params_file as j_read_params
from redtime_tpu.io import writer as jw
from redtime_tpu.io.camb import load_from_params as j_load
from redtime_tpu_torch import cli
from redtime_tpu_torch import driver as td
from redtime_tpu_torch.config import SolverConfig as TCfg
from redtime_tpu_torch.io import writer as tw
from redtime_tpu_torch.profiling import StageTimer, device_trace

NK = 16
Z_OUT = (2.0, 1.0, 0.0)
N = 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu(*argv):
    return list(argv) + ["--platform", "cpu", "--nk", str(NK)]


@pytest.fixture(scope="module")
def batch_run(tmp_path_factory):
    """N params files, `batch` over them and `run` on the first."""
    work = tmp_path_factory.mktemp("torch_cli")
    paths = chip_smoke.write_cli_inputs(str(work), chip_smoke.design_params(N),
                                        Z_OUT)
    out = work / "out"
    assert cli.main(_cpu("batch", "-o", str(out), *paths)) == 0
    assert cli.main(_cpu("run", "--params", paths[0], "-o",
                         str(work / "one.dat"))) == 0
    return work, paths


@functools.lru_cache(maxsize=1)
def _jax_texts(paths: tuple) -> list:
    """JAX run_batch on the same files (its own reader), each lane through
    its writer."""
    import jax

    loaded = []
    for p in paths:
        pf = j_read_params(p)
        settings, cosmo = jd.settings_from_params(pf)
        loaded.append((settings, cosmo, j_load(pf, os.path.dirname(p))))
    stack = lambda *xs: np.stack([np.asarray(x) for x in xs])
    cosmos = jax.tree_util.tree_map(stack, *[c for _, c, _ in loaded])
    lins = jax.tree_util.tree_map(stack, *[lin for _, _, lin in loaded])
    res = jd.run_batch(JCfg(nk=NK, fft_mode="fft"), loaded[0][0], cosmos,
                       lins, mode="fft")
    texts = []
    for i, p in enumerate(paths):
        one = type(res)(*[np.asarray(x)[i] for x in res])
        f = io.StringIO()
        jw.write_result(f, one, os.path.basename(p))
        texts.append(f.getvalue())
    return texts


def _parse(text: str):
    """(table rows, header numbers) of one written result."""
    heads = [[float(v) for v in re.findall(r"=\s*([-+0-9.eE]+)", line)]
             for line in text.splitlines() if line.startswith("###")]
    rows = np.loadtxt(io.StringIO(text))
    return rows, np.array(heads[1:]), np.array(heads[0])


def _assert_band(got_text: str, ref_text: str) -> None:
    t, h, h0 = _parse(got_text)
    r, hr, h0r = _parse(ref_text)
    assert t.shape == r.shape == (len(Z_OUT) * NK, 17)
    assert np.isfinite(t).all()
    assert col_scale_dev(t, r, 0) < 3e-5
    np.testing.assert_allclose(t[:, :7], r[:, :7], rtol=1e-10, atol=0)
    # eta, a, z, H, sigma_v^2 of each block; eta_fin and sigmaV2(z=0)
    np.testing.assert_allclose(h, hr, rtol=1e-10, atol=0)
    np.testing.assert_allclose(h0, h0r, rtol=1e-10, atol=0)


def test_cli_batch_and_run_match_jax(batch_run):
    work, paths = batch_run
    ref = _jax_texts(tuple(paths))
    for i in range(N):
        got = (work / "out" / f"redTime_M{i:03d}.dat").read_text()
        assert got.startswith("#cosmological_parameters: opening parameter "
                              f"file: params_redTime_M{i:03d}.dat\n")
        _assert_band(got, ref[i])
    _assert_band((work / "one.dat").read_text(), ref[0])
    # distinct cosmologies give distinct spectra
    t0 = _parse(ref[0])[0]
    t1 = _parse((work / "out" / "redTime_M001.dat").read_text())[0]
    assert not np.allclose(t0[:, 7], t1[:, 7])


def test_cli_batch_skip_existing(batch_run, capsys):
    work, paths = batch_run
    before = {p: p.stat().st_mtime_ns for p in (work / "out").iterdir()}
    assert cli.main(_cpu("batch", "-o", str(work / "out"), "--skip-existing",
                         *paths)) == 0
    assert "skipping 3" in capsys.readouterr().err
    assert {p: p.stat().st_mtime_ns for p in (work / "out").iterdir()} \
        == before


def test_cli_batch_rejects_mixed_shapes(batch_run, tmp_path):
    _, paths = batch_run
    # a massless model has an empty beta stack: other input shapes
    massless = chip_smoke.design_params(1)
    massless[0, 5] = 0.0
    (path,) = chip_smoke.write_cli_inputs(str(tmp_path), massless, Z_OUT)
    with pytest.raises(SystemExit, match="shapes differ"):
        cli.main(_cpu("batch", "-o", str(tmp_path / "out"), paths[0], path))
    assert not (tmp_path / "out").exists()


def test_cli_batch_rejects_mixed_settings(batch_run, tmp_path):
    _, paths = batch_run
    (path,) = chip_smoke.write_cli_inputs(
        str(tmp_path), chip_smoke.design_params(1), (1.0, 0.0))
    with pytest.raises(SystemExit, match="settings differ"):
        cli.main(_cpu("batch", "-o", str(tmp_path / "out"), paths[0], path))


def test_cli_batch_does_not_write_a_poisoned_lane(tmp_path, capsys):
    """A cosmology with sigma_8 = nan poisons its own lane: the others are
    written, it is not, and the command returns 1."""
    params = chip_smoke.design_params(N)
    params[1, 1] = np.nan
    paths = chip_smoke.write_cli_inputs(str(tmp_path), params, Z_OUT)
    out = tmp_path / "out"
    assert cli.main(_cpu("batch", "-o", str(out), *paths)) == 1
    assert sorted(os.listdir(out)) == ["redTime_M000.dat", "redTime_M002.dat"]
    err = capsys.readouterr().err
    assert "1 model(s) produced non-finite output" in err
    assert "params_redTime_M001.dat" in err
    assert "cosmologies/min" in err
    assert np.isfinite(np.loadtxt(out / "redTime_M000.dat")).all()


def _ns(**kw):
    base = dict(preset="default", nk=None, dtype="float64", set_kv=[])
    base.update(kw)
    return argparse.Namespace(**base)


SHARED = sorted({f.name for f in dataclasses.fields(TCfg)}
                & {f.name for f in dataclasses.fields(JCfg)})


@pytest.mark.parametrize("kw", [
    dict(preset="default"), dict(preset="high-accuracy"),
    dict(preset="v01-compat"), dict(preset="v01-compat", nk=64),
    dict(preset="high-accuracy", set_kv=["erel_P=1e-4", "np_factor=8",
                                         "growth_h_reset=true",
                                         "quad_order=20", "out_leg=dot"]),
], ids=["default", "high-accuracy", "v01-compat", "v01-nk64", "set"])
def test_cli_config_matches_jax(kw):
    """Every SolverConfig field the two packages share is what the JAX
    CLI's _config builds from the same flags."""
    got = cli._config(_ns(**kw))
    ref = jcli._config(_ns(mode="fft", **kw))
    assert SHARED == sorted(f.name for f in dataclasses.fields(TCfg))
    for name in SHARED:
        assert getattr(got, name) == getattr(ref, name), name


def test_cli_config_refuses_what_it_cannot_run():
    with pytest.raises(SystemExit, match="unknown SolverConfig field"):
        cli._config(_ns(set_kv=["fft_mode=fft"]))
    with pytest.raises(SystemExit, match="expected int"):
        cli._config(_ns(set_kv=["nk=abc"]))
    with pytest.raises(SystemExit, match="expected a boolean"):
        cli._config(_ns(set_kv=["print_a=maybe"]))
    with pytest.raises(SystemExit, match="key=value"):
        cli._config(_ns(set_kv=["nk"]))
    with pytest.raises(ValueError, match="float64 only"):
        cli._config(_ns(dtype="float32"))
    with pytest.raises(ValueError, match="native f64"):
        cli._config(_ns(set_kv=["out_leg=ozaki"]))
    with pytest.raises(SystemExit):
        cli.main(["batch", "--scheduler", "packed", "x.dat"])


def test_write_result_to_path_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    one = td.RunResult(
        k=np.logspace(-3, 0, 4), table=rng.standard_normal((2, 4, 5)) * 1e3,
        eta=np.array([1.5, 2.5]), a=np.array([0.3, 1.0]),
        z=np.array([2.3, 0.0]), H=np.array([1e-3, 3e-4]),
        sigma_v2=np.array([12.5, 33.25]), sigmaV2_z0=np.float64(40.125),
        eta_fin=np.float64(5.3))
    tw.write_result_to_path(str(tmp_path / "port.dat"),
                            td.RunResult(*[torch.as_tensor(x) for x in one]),
                            "params_x.dat")
    jw.write_result_to_path(str(tmp_path / "jax.dat"), one, "params_x.dat")
    assert (tmp_path / "port.dat").read_bytes() == \
        (tmp_path / "jax.dat").read_bytes()


def test_stage_timer_accumulates_and_reports():
    out = io.StringIO()
    timer = StageTimer(enabled=True, stream=out)
    for _ in range(2):
        with timer.stage("a", block_on=torch.zeros(2)):
            pass
    with timer.stage("b"):
        sum(range(10000))
    assert set(timer.times) == {"a", "b"} and timer.times["a"] >= 0.0
    assert out.getvalue().count("# [timing] a:") == 2
    report = timer.report().splitlines()
    assert report[-1].startswith("# [timing] total:")
    assert len(report) == 3 and all(line.endswith("%)") for line in
                                    report[:2])
    quiet = StageTimer(enabled=False, stream=out)
    with quiet.stage("c"):
        pass
    assert "c" in quiet.times and "# [timing] c" not in out.getvalue()


def test_device_trace_writes_a_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")):
        torch.ones(8).add_(1.0)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    with device_trace(None):        # no directory: no profiler
        pass


def test_cli_runs_as_a_module_without_jax():
    """python -m redtime_tpu_torch.cli --help runs, and importing the CLI
    and its commands' modules leaves JAX out."""
    code = ("import sys, redtime_tpu_torch.cli as c, "
            "redtime_tpu_torch.driver, redtime_tpu_torch.profiling; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'redtime_tpu.')) "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr
    out = subprocess.run([sys.executable, "-m", "redtime_tpu_torch.cli",
                          "batch", "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and "--skip-existing" in out.stdout
