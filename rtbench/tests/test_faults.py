"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at a small size (harness.run with need_card=False and
small overrides), with the program broken where it produces: a step that
returns its state unchanged, half of the batch left out (the other half
given the first half's answers), and one answer altered where it is
produced.  The cells run on one chip, so no exchange between chips can be
left out.  A sound run at the same size comes out correct first.
"""

from __future__ import annotations

import time

import pytest
import torch

from rtbench import harness

SEED = 2 ** 31 + 11
SMALL = {"trg128.solve.w512": {"solver": {"nk": 32},
                               "traffic": {"batch": 4, "lanes": 4,
                                           "check_lanes": 4}},
         "trg512.solve.w64": {"solver": {"nk": 32},
                              "traffic": {"batch": 4, "lanes": 4,
                                          "check_lanes": 4}}}
CELLS = list(SMALL)


def run(cell: str) -> dict:
    return harness.run(["--workload", cell, "--seed", str(SEED),
                        "--seconds", "0", "--trace", "0"],
                       time.perf_counter(), device="cpu", need_card=False,
                       overrides=SMALL[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line = run(cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] == 4 and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged(cell, monkeypatch):
    """K3's rk_finish advances t and h but hands back the state it got."""
    from redtime_tpu_torch import ode

    finish = ode.rk_finish

    def frozen(y, ks, t, h, t1, n, active, consts):
        out = finish(y, ks, t, h, t1, n, active, consts)
        return (y,) + tuple(out[1:])

    monkeypatch.setattr(ode, "rk_finish", frozen)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out(cell, monkeypatch):
    """The call solves the first half of its cosmologies and hands their
    answers out for the second half too."""
    from redtime_tpu_torch import driver, model as mdl

    solve = driver.solve
    half = lambda x: torch.cat([x[:2], x[:2]])

    def half_solve(cfg, settings, model, ec=None):
        res = solve(cfg, settings, mdl.take_lanes(model, slice(0, 2)), ec)
        return driver.RunResult(*map(half, res))

    monkeypatch.setattr(driver, "solve", half_solve)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced(cell, monkeypatch):
    """K11's output block: one value of one cosmology's table off by a
    part in 100."""
    from redtime_tpu_torch.kernels import out_block as ob

    block = ob.out_block

    def altered(*args, **kw):
        table, sv, H = block(*args, **kw)
        table = table.clone()
        table[-1, 0, 7, 1] *= 1.0 + 1e-2
        return table, sv, H

    monkeypatch.setattr(ob, "out_block", altered)
    line = run(cell)
    assert not line["correct"], line["checks"]
