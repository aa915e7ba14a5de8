"""The port's native IO runtime (redtime_tpu_torch/io/native.py over
redtime_tpu_torch/csrc/redtime_io.cpp) against the JAX package's
(redtime_tpu.io.native over csrc/redtime_io.cpp) and against the port's
plain numpy / f-string versions, on the CPU with g++.

* Parsing: mock-CAMB stacks (tests/mock_camb.py's tables at the 33 CAMB
  redshifts) in 7 and 13 columns, and edge files (comments, CRLF, extra
  columns, lines with no number, a file larger than the first buffer
  guess, empty and comment-only files, a short row, a missing file):
  arrays bit-equal to JAX's native parser and, where numpy reads the
  file, to np.loadtxt; parse_stack on several OpenMP threads equal to
  the serial parse_table.
* Formatting: format_rows byte-equal to JAX's and to the f-string plain
  version on random and special f64 blocks; write_result_to_path's files
  byte-equal to the JAX writer's.  One difference: a NaN with its sign
  bit set (x86's default NaN, e.g. 0/0) prints "nan" as Python does,
  where JAX's formatter prints printf's "-nan".
* load_from_params against the JAX package's: LinearData bit-equal.
* A failed build raises with the compiler's output (no fallback).

JAX's library is built from a copy of its source under a temporary
directory, so csrc/libredtime_io.so is left as it is.
"""

import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import mock_camb
import torch_port_util  # noqa: F401  (torch threads, JAX on CPU)
from redtime_tpu.io import camb as jcamb
from redtime_tpu.io import native as jnative
from redtime_tpu.io import params as jparams
from redtime_tpu.io import writer as jw
from redtime_tpu_torch import orchestrate
from redtime_tpu_torch.io import camb as tcamb
from redtime_tpu_torch.io import native
from redtime_tpu_torch.io import params as tparams
from redtime_tpu_torch.io import writer as tw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMB_Z = orchestrate.CAMB_Z_LIST.split()


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """redtime_tpu.io.native bound to a library built from a copy of
    csrc/ under a temporary directory."""
    csrc = tmp_path_factory.mktemp("jax_csrc")
    for name in ("redtime_io.cpp", "Makefile"):
        shutil.copy(os.path.join(REPO, "csrc", name), csrc / name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_CSRC", str(csrc))
        mp.setattr(jnative, "_LIB_PATH", str(csrc / "libredtime_io.so"))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_tried", False)
        assert jnative.available()
        yield jnative


def _table(z: float, ncols: int) -> np.ndarray:
    """mock_camb's 7-column table; 13 columns append six more of modern
    CAMB's layout (no-nu total, total with DE, Weyl, v_CDM, v_b,
    v_b - v_c), smooth functions of the first seven."""
    t = mock_camb.transfer_table(z, 0.12)
    if ncols == 7:
        return t
    k, tc = t[:, 0], t[:, 1]
    return np.column_stack([t, 0.98 * tc, 1.01 * tc, -0.5 * tc / k,
                            tc * k, 0.9 * tc * k, -0.1 * tc * k])


def _write_stack(root, ncols: int, zs=CAMB_Z) -> list:
    paths = []
    for z in zs:
        path = os.path.join(str(root), f"camb_transfer_z{z}.dat")
        np.savetxt(path, _table(float(z), ncols), fmt="%.10e")
        paths.append(path)
    return paths


@pytest.fixture(scope="module", params=[7, 13], ids=["7col", "13col"])
def stack(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"stack{request.param}")
    return request.param, _write_stack(root, request.param)


def _equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def test_library_builds_and_loads():
    assert native.build() == native.library_path()
    assert native.build().exists()
    assert native.io_threads() >= 1


def test_parse_stack_matches_jax_and_numpy(stack, jax_native):
    ncols, paths = stack
    got = native.parse_stack(paths, ncols)
    ref = jax_native.parse_stack(paths, ncols)
    assert len(got) == len(paths) == 33
    for p, g, r in zip(paths, got, ref):
        plain = tcamb.read_transfer_file_plain(p, ncols == 13)
        assert g.shape == (400, ncols)
        assert _equal(g, r) and _equal(g, plain), p
        assert _equal(native.parse_table(p, ncols), g)
        assert _equal(tcamb.read_transfer_file(p, ncols == 13), g)


def test_parse_stack_threads_equal_serial(stack, tmp_path):
    """parse_stack in a process with 4 OpenMP threads gives the arrays of
    parse_table file by file."""
    ncols, paths = stack
    out = tmp_path / "par.npz"
    # native.py alone (stdlib and numpy): the package would import torch
    code = ("import importlib.util, sys, numpy as np\n"
            "spec = importlib.util.spec_from_file_location('native', "
            "sys.argv[1])\n"
            "native = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(native)\n"
            "t = native.parse_stack(sys.argv[3:-1], int(sys.argv[2]))\n"
            "np.savez(sys.argv[-1], threads=native.io_threads(), *t)\n")
    subprocess.run([sys.executable, "-c", code, native.__file__, str(ncols),
                    *paths, str(out)], check=True, timeout=120,
                   env=dict(os.environ, OMP_NUM_THREADS="4"))
    with np.load(out) as z:
        assert int(z["threads"]) == 4
        par = [z[f"arr_{i}"] for i in range(len(paths))]
    for p, a in zip(paths, par):
        assert _equal(a, native.parse_table(p, ncols)), p


ROWS = ["1.5 2 3 4 5 6 7", "8e-3 -9 10 11 12 13 14.25"]
EDGE_FILES = {
    "comments": ("# k c b g r nu tot\n" + ROWS[0] + "\n# between\n"
                 + ROWS[1] + "  # trailing\n", True),
    "crlf": ("\r\n".join(ROWS) + "\r\n", True),
    "extra_columns": (ROWS[0] + " 99 98\n" + ROWS[1] + " 97\n", False),
    "text_lines": ("k c b g r nu tot\n" + ROWS[0] + "\nend of table\n"
                   + ROWS[1] + "\n", False),
    "blank_lines": ("\n\n" + ROWS[0] + "\n\n  \n" + ROWS[1], True),
    "beyond_first_guess": ("1 2 3 4 5 6 7\n" * 500, True),
    "empty": ("", False),
    "comment_only": ("# header\n# nothing else\n", False),
}


@pytest.mark.parametrize("name", sorted(EDGE_FILES))
def test_parse_edge_files(name, tmp_path, jax_native):
    text, numpy_reads = EDGE_FILES[name]
    path = tmp_path / f"{name}.dat"
    path.write_bytes(text.encode())
    got = native.parse_table(str(path), 7)
    assert _equal(got, jax_native.parse_table(str(path), 7))
    assert _equal(native.parse_stack([str(path)] * 3, 7)[2], got)
    if not got.shape[0]:
        assert got.shape == (0, 7)
        with pytest.raises(ValueError, match="no parseable"):
            tcamb.read_transfer_file(str(path))
        return
    want = {"beyond_first_guess": 500}.get(name, 2)
    assert got.shape == (want, 7)
    if name != "beyond_first_guess":
        assert _equal(got, np.array([np.array(r.split(), float)
                                     for r in ROWS]))
    if numpy_reads:
        assert _equal(got, tcamb.read_transfer_file_plain(str(path)))


def test_parse_errors(tmp_path, jax_native):
    short = tmp_path / "short.dat"
    short.write_text(ROWS[0] + "\n1 2 3\n")
    for parse in (native.parse_table, jax_native.parse_table):
        with pytest.raises(ValueError, match="fewer than 7 columns"):
            parse(str(short), 7)
    with pytest.raises(ValueError, match="fewer than 7 columns"):
        native.parse_stack([str(short)] * 2, 7)
    seven = tmp_path / "seven.dat"
    np.savetxt(seven, _table(0.0, 7))
    with pytest.raises(ValueError, match="modern=True"):
        tcamb.read_transfer_file(str(seven), modern=True)
    with pytest.raises(FileNotFoundError):
        native.parse_table(str(tmp_path / "missing.dat"), 7)
    with pytest.raises(ValueError, match="ncols"):
        native.parse_table(str(seven), 0)


def test_parse_stack_regrows_a_full_buffer(tmp_path, jax_native):
    """A file with more rows than the shared buffer is parsed again on its
    own with a grown one (the -2 return)."""
    paths = _write_stack(tmp_path, 7, CAMB_Z[:4])
    got = native.parse_stack(paths, 7, max_rows=150)
    for p, g, r in zip(paths, got, jax_native.parse_stack(paths, 7, 150)):
        assert g.shape == (400, 7) and _equal(g, r)
        assert _equal(g, tcamb.read_transfer_file_plain(p))


def _special_values(rng) -> np.ndarray:
    with np.errstate(invalid="ignore"):
        neg_nan = np.float64(0.0) / np.float64(0.0)
    vals = np.concatenate([
        rng.standard_normal(3000) * 10.0 ** rng.integers(-320, 300, 3000),
        10.0 ** rng.uniform(-310, 308, 3000) * rng.choice([-1, 1], 3000),
        rng.standard_normal(3000),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, neg_nan, 1e-5, 1e-4,
                  9.99999999999e-5, 999999999999.5, 1e12, 1e15, 1e16, 0.1,
                  1.0, -1.0, 5e-324, -5e-324, 1.7976931348623157e308,
                  2.2250738585072014e-308, 123456789012.0, 1234567890123.0,
                  0.000123456789012345, 1e100, -1e-100, 1e300, -1e-300]),
    ])
    return np.concatenate([vals, np.zeros((-len(vals)) % 17)]).reshape(-1, 17)


@pytest.mark.parametrize("case", ["random", "special", "table", "empty"])
def test_format_rows_matches_jax_and_plain(case, jax_native):
    rng = np.random.default_rng(11)
    block = {"random": lambda: rng.standard_normal((128, 17)) * 1e4,
             "special": lambda: _special_values(rng),
             "table": lambda: np.abs(rng.standard_normal((128, 32))) ** 3,
             "empty": lambda: np.zeros((0, 17))}[case]()
    got = tw._format_block(block)
    assert got == tw._format_block_plain(block)
    assert got == native.format_rows(block, tw.WIDTH, 12)
    nan = np.isnan(block) & np.signbit(block)
    ref = jax_native.format_rows(np.where(nan, np.nan, block), jw.WIDTH, 12)
    assert got == ref
    if nan.any():
        assert "-nan" in jax_native.format_rows(block, jw.WIDTH, 12)
    with pytest.raises(ValueError, match="2-D"):
        native.format_rows(block.ravel(), 20, 12)


def test_write_result_to_path_bytes_equal_jax_and_plain(tmp_path,
                                                        jax_native,
                                                        monkeypatch):
    rng = np.random.default_rng(5)
    table = rng.standard_normal((3, 128, 17)) * 10.0 ** rng.integers(
        -8, 8, (3, 128, 17))
    table[1, 5, 3], table[2, 7, 0] = np.inf, np.nan
    one = types.SimpleNamespace(
        table=table, eta=np.array([0.5, 1.5, 2.5]),
        a=np.array([0.1, 0.3, 1.0]), z=np.array([9.0, 2.3, 0.0]),
        H=np.array([1e-2, 1e-3, 3e-4]), sigma_v2=np.array([1.5, 12.5, 33.25]),
        sigmaV2_z0=np.float64(40.125), eta_fin=np.float64(5.3))
    port = types.SimpleNamespace(**{k: torch.as_tensor(v)
                                    for k, v in vars(one).items()})
    tw.write_result_to_path(str(tmp_path / "port.dat"), port, "params_x.dat")
    jw.write_result_to_path(str(tmp_path / "jax.dat"), one, "params_x.dat")
    monkeypatch.setattr(tw, "_format_block", tw._format_block_plain)
    tw.write_result_to_path(str(tmp_path / "plain.dat"), port,
                            "params_x.dat")
    data = (tmp_path / "port.dat").read_bytes()
    assert data == (tmp_path / "jax.dat").read_bytes()
    assert data == (tmp_path / "plain.dat").read_bytes()


@pytest.mark.parametrize("modern", [False, True], ids=["7col", "13col"])
@pytest.mark.parametrize("omega_nu", [0.005, 0.0], ids=["massive",
                                                        "massless"])
def test_load_from_params_matches_jax(tmp_path, modern, omega_nu,
                                      jax_native):
    _write_stack(tmp_path, 13 if modern else 7, CAMB_Z + ["0"])
    path = str(tmp_path / "params_redTime_M001.dat")
    orchestrate.write_params(path, "M001", 0.31, 0.049, 0.8, 0.68, 0.96,
                             -1.0, 0.1, omega_nu, [2.0, 0.0])
    lj = jcamb.load_from_params(jparams.read_params_file(path),
                                str(tmp_path), modern)
    lt = tcamb.load_from_params(tparams.read_params_file(path),
                                str(tmp_path), modern)
    assert len(lt.beta_a) == (33 if omega_nu else 0)
    for name in tcamb.LinearData._fields:
        assert _equal(getattr(lt, name), np.asarray(getattr(lj, name))), name


def test_stack_checks_keep_their_messages(tmp_path):
    paths = _write_stack(tmp_path, 7, CAMB_Z[:5])
    with open(paths[2], "w") as f:
        np.savetxt(f, _table(float(CAMB_Z[2]), 7)[:-1], fmt="%.10e")
    with pytest.raises(ValueError, match="399 rows, expected 400"):
        tcamb.load_linear_data(paths[0], paths, CAMB_Z[:5])
    t = _table(float(CAMB_Z[3]), 7)
    t[:, 0] *= 1.001
    np.savetxt(paths[2], _table(float(CAMB_Z[2]), 7), fmt="%.10e")
    np.savetxt(paths[3], t, fmt="%.10e")
    with pytest.raises(ValueError, match="k grid differs"):
        tcamb.load_linear_data(paths[0], paths, CAMB_Z[:5])
    open(paths[4], "w").close()
    np.savetxt(paths[3], _table(float(CAMB_Z[3]), 7), fmt="%.10e")
    with pytest.raises(ValueError, match="no parseable"):
        tcamb.load_linear_data(paths[0], paths, CAMB_Z[:5])
    with pytest.raises(ValueError, match=">= 4 redshift nodes"):
        tcamb.load_linear_data(paths[0], paths[:3], CAMB_Z[:3])


@pytest.mark.parametrize("cxx", ["/nonexistent/bin/g++", "false"])
def test_failed_build_raises(cxx, monkeypatch):
    monkeypatch.setattr(native, "CXX", cxx)
    with pytest.raises(RuntimeError, match="g\\+\\+|false") as err:
        native.build()
    assert not native.library_path().exists()
    if cxx == "false":
        assert "failed (1)" in str(err.value)
    # with no library loaded yet, the first parse raises the same way
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError):
        tcamb.read_transfer_file(os.path.join(REPO, "csrc", "Makefile"))


def test_missing_source_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "SOURCE", tmp_path / "redtime_io.cpp")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="redtime_io.cpp is missing"):
        native.build()
    with pytest.raises(RuntimeError, match="is missing"):
        tw._format_block(np.zeros((1, 1)))


def test_package_data_ships_the_sources():
    """Every file of the port's csrc/ and templates/ (the IO library's
    .cpp, the kernels' .cu / .cuh, the CAMB templates) matches a
    package-data glob, so an installed package builds what a checkout
    builds."""
    import fnmatch
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "redtime_tpu_torch"]
    pkg = os.path.dirname(os.path.dirname(native.__file__))
    files = [os.path.relpath(native.SOURCE, pkg)]
    for sub in ("csrc", "templates"):
        files += [f"{sub}/{name}"
                  for name in sorted(os.listdir(os.path.join(pkg, sub)))]
    missed = [f for f in files
              if not any(fnmatch.fnmatch(f, g) for g in globs)]
    assert not missed, f"not in package-data {globs}: {missed}"
