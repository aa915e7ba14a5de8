"""What the harness and the reference import: no top-level name, the
part before the first dot taken whole, is jax, jaxlib, flax or
redtime_tpu; the reference imports nothing of the program either."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "redtime_tpu"}

HARNESS = """
import glob, json, os, sys
sys.path.insert(0, ROOT)
from rtbench import harness, reference, compare, costs, inputs, program, trace
import rtbench.control
for kind in ("entries", "metrics"):
    for p in sorted(glob.glob(os.path.join(ROOT, "rtbench", kind, "*.py"))):
        harness.load_module(kind, os.path.basename(p)[:-3])
# what a run imports of the program
from redtime_tpu_torch import driver, fastpt, model
from redtime_tpu_torch.kernels import counts
from redtime_tpu_torch.profiling import StageTimer
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import dataclasses, json, sys
sys.path.insert(0, ROOT)
import torch
from rtbench import inputs, reference
import rtbench.rtref.config as c
solver = dataclasses.asdict(c.SolverConfig(nk=16))
st = dict(nonlinear=True, one_loop=False, print_lin=True, print_rsd=True,
          z_in=200.0, z_out=(0.0,))
params, lin = inputs.batch_inputs(1, 5, 0)
reference.solve(solver, st, params, lin, device="cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.replace(
        "ROOT", repr(ROOT))], capture_output=True, text=True, timeout=600,
        cwd=ROOT, env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_imports_no_jax():
    names = _top_names(HARNESS)
    assert "rtbench" in names and "redtime_tpu_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    names = _top_names(REFERENCE)
    assert "rtbench" in names
    assert not names & (FORBIDDEN | {"redtime_tpu_torch"}), names


def test_forbidden_names_are_whole(monkeypatch):
    """A name is compared whole before its first dot: redtime_tpu_torch
    and jaxfoo are not forbidden, jax.numpy and redtime_tpu.model are."""
    from rtbench import harness

    for name in ("redtime_tpu_torch_x", "jaxfoo", "jaxfoo.bar"):
        monkeypatch.setitem(sys.modules, name, sys)
    base = harness.forbidden_modules()
    assert "jaxfoo" not in base and "redtime_tpu_torch_x" not in base
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "redtime_tpu.model", sys)
    assert {"jax", "redtime_tpu"} <= set(harness.forbidden_modules())


def test_jax_loaded_in_the_check_leaves_no_result(monkeypatch):
    """The look in sys.modules comes after the check: a reference that
    loads jax there makes the run refuse to give a result."""
    from rtbench import harness, reference

    solve = reference.solve

    def loads_jax(*args, **kw):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return solve(*args, **kw)

    monkeypatch.setattr(reference, "solve", loads_jax)
    small = {"solver": {"nk": 32},
             "traffic": {"batch": 2, "lanes": 2, "check_lanes": 2}}
    with pytest.raises(harness.Refused, match="jax"):
        harness.run(["--workload", "trg128.solve.w512", "--seed",
                     str(2 ** 31 + 5), "--seconds", "0", "--trace", "0"],
                    time.perf_counter(), device="cpu", need_card=False,
                    overrides=small)
