"""The precision control: the plain reference with its RHS and output
block in float32 along the float64 run's accepted steps (rtbench.control)
must fail a cell's limits.

On the CPU at a small size (nk=32, the cells' tolerances where they run
in minutes), with the cells' own limits; on the card at the cells' own
sizes, on three seeds (marked cuda: it runs on the chip).
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from rtbench import compare, harness, inputs, reference

CELLS = ("trg128.solve.w512", "trg512.solve.w64")


def test_replay_follows_the_float64_run():
    """Replayed in float64, the recorded steps give the float64 run's
    states (to rounding)."""
    from rtbench.rtref import fastpt, trg
    from rtbench.rtref.config import RunSettings, SolverConfig

    cfg = SolverConfig(nk=32)
    rs = RunSettings(nonlinear=True, one_loop=False, print_lin=True,
                     print_rsd=True, z_in=200.0, z_out=(2.02, 0.0))
    params, lin = inputs.batch_inputs(2, 4242, 0)
    m = reference.prepare(dataclasses.asdict(cfg), params, lin)
    ec = fastpt.engine_consts(cfg, "cpu")
    with reference._record_steps() as steps:
        ys = trg.evolve(cfg, rs, m, ec)
    yr = reference.replay(cfg, rs, m, steps, trg.make_rhs(cfg, rs, m, ec))
    scale = ys.abs().amax(dim=-1, keepdim=True).clamp(min=1e-300)
    assert float(((yr - ys).abs() / scale).max()) < 1e-9


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_small(cell):
    manifest = harness.load_json(harness.ROOT, "BENCHMARK.json")
    limits = harness.load_json(harness.HERE, "limits", cell + ".json")
    c = harness.cell_of(manifest, cell)
    config = harness.load_json(harness.HERE, "configs",
                               c["config"] + ".json")
    solver = dict(config["solver"], nk=32, eabs_P=1e-7, erel_P=1e-2)
    settings = dict(config["settings"], z_out=(2.02, 0.0))
    params, lin = inputs.batch_inputs(2, 97, 0)
    ref = reference.solve(solver, settings, params, lin, device="cpu")
    ctl = reference.solve(solver, settings, params, lin, device="cpu",
                          dtype=torch.float32)
    got = compare.gaps(ctl, ref)
    for f, table in ref["model"].items():    # it prepares in float64
        assert (ctl["model"][f] == table).all()
    assert got["table"] > limits["table"] or \
        got["headers"] > limits["headers"], (got, limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's size")
    from rtbench import control

    assert control.main(["--workload", cell, "--seeds", "101", "202",
                         "303"]) == 0
