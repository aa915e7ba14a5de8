"""The port's spans and solver counters (redtime_tpu_torch.profiling) on
the CPU, and the benchmark's readers of them (rtbench/spans.py, the
lockstep_occupancy and overrun_attempt_pct metrics).

* with tracing off, span() is one shared no-op and nothing is recorded
  or counted;
* one lockstep interval's stats, and the counters of the plain path's
  solve of a small batch: the lanes' attempts are _solve's, the attempts
  launched a multiple of CHECK_EVERY and at least the slowest lane's;
* a torch.profiler turns the counters on and not the spans;
  device_trace turns the spans on: user_annotation events, nested as the
  profiling docstring lists them;
* prepare's spans and StageTimer's;
* the readers on synthetic records, and scripts/trace_spans.py's idle
  booking on synthetic events.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_port_util  # noqa: F401  (one torch thread)
from redtime_tpu_torch import driver, ode, profiling
from redtime_tpu_torch.config import RunSettings, SolverConfig
from redtime_tpu_torch.fastpt import engine_consts
from redtime_tpu_torch.profiling import StageTimer
from rtbench import harness, inputs

sys.path.insert(0, os.path.join(harness.ROOT, "scripts"))
import trace_spans  # noqa: E402

NK = 16
CFG = SolverConfig(nk=NK)
SET = RunSettings(nonlinear=True, one_loop=False, z_out=(2.0, 1.0, 0.0))
LANES = 3
PREPARE = ("driver.prepare", "model.growth", "model.beta_transfer",
           "model.sigma8", "model.sigma_v")
NESTED = [("driver.solve", "trg.evolve"), ("driver.solve", "driver.finalize"),
          ("trg.evolve", "ode.interval"), ("ode.interval", "ode.check"),
          ("ode.interval", "ode.attempt"), ("ode.attempt", "trg.rhs"),
          ("trg.rhs", "fastpt.engine"), ("trg.rhs", "rhs_tail")]


@pytest.fixture(autouse=True)
def tracing_off():
    profiling.tracing()
    profiling.reset()
    yield
    profiling.tracing()
    profiling.reset()


class Recorder:
    """Stands in for torch.profiler.record_function: logs each span
    opened as (name, the names open around it)."""

    def __init__(self):
        self.log, self.open = [], []

    def __call__(self, name):
        rec = self

        class _Rf:
            def __enter__(self):
                rec.log.append((name, tuple(rec.open)))
                rec.open.append(name)

            def __exit__(self, *exc):
                rec.open.pop()
                return False

        return _Rf()

    def names(self) -> list:
        return [name for name, _ in self.log]


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(torch.profiler, "record_function", rec)
    return rec


@pytest.fixture(scope="module")
def prepared():
    """(model, engine constants, the spans its prepare opened) of LANES
    design cosmologies at nk=16, prepared with spans on."""
    params, lin = inputs.batch_inputs(LANES, 5, 0, design_seed=1)
    rows = ([np.ascontiguousarray(params[:, i])
             for i in range(params.shape[1])], list(lin), None)
    rec = Recorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", rec)
        profiling.tracing(spans=True)
        try:
            model = driver._prepare(CFG, rows, torch.device("cpu"),
                                    on_host=False)
        finally:
            profiling.tracing()
    return model, engine_consts(CFG, "cpu"), rec.log


def _decay(rates):
    """A lockstep interval of y' = -rate y on lanes of other stiffness:
    (y, h, n)."""
    rates = torch.tensor(rates, dtype=torch.float64)
    return ode.integrate_interval(
        lambda t, y: -rates[:, None] * y, 0.0, 1.0,
        torch.ones(len(rates), 2, dtype=torch.float64), 0.01, 1e-10, 1e-8,
        return_stats=True)


def test_tracing_off_records_nothing(prepared, recorder):
    model, ec, _ = prepared
    assert profiling.span("a") is profiling.span("b")
    assert not profiling.counting()
    with profiling.span("a"):
        pass
    with StageTimer(enabled=False).stage("prepare"):
        pass
    driver._solve(CFG, SET, model, ec)
    assert recorder.log == []
    assert set(profiling.counters().values()) == {0}


def test_counters_of_one_interval(recorder):
    """An interval's stats: the lanes' attempts and the rounds of
    CHECK_EVERY launched, as many as the slowest lane needed.  ode's loop
    books no counter itself (trg.evolve does)."""
    profiling.tracing(spans=True, counters=True)
    _, _, n, rounds = _decay([1.0, 3.0, 30.0])
    assert int(n.min()) < int(n.max())
    assert rounds == -(-int(n.max()) // ode.CHECK_EVERY)
    assert recorder.names().count("ode.check") == rounds + 1
    assert recorder.names().count("ode.attempt") == rounds * ode.CHECK_EVERY
    assert set(profiling.counters().values()) == {0}


def test_counters_of_the_plain_solve(prepared):
    model, ec, _ = prepared
    profiling.tracing(counters=True)
    _, attempts = driver._solve(CFG, SET, model, ec)
    c = profiling.counters()
    launched = c["ode.attempts_launched"]
    assert c["ode.lane_attempts"] == int(attempts.sum())
    assert launched % ode.CHECK_EVERY == 0
    assert launched >= c["ode.slowest_lane_attempts"] >= int(attempts.max())
    assert c["ode.lane_slots"] == launched * LANES
    assert c["ode.checks"] == launched // ode.CHECK_EVERY + len(SET.z_out)


def test_the_profiler_turns_counters_on_not_spans(prepared, recorder):
    """A profile started elsewhere (the benchmark's traced passes) counts
    and opens no span; prepare's growth ODE is not counted."""
    model, ec, _ = prepared
    params, lin = inputs.batch_inputs(2, 6, 0, design_seed=1)
    rows = ([np.ascontiguousarray(params[:, i])
             for i in range(params.shape[1])], list(lin), None)
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.counting()
        assert profiling.span("a") is profiling.span("b")
        driver._prepare(CFG, rows, torch.device("cpu"), on_host=False)
        assert set(profiling.counters().values()) == {0}
        _, attempts = driver._solve(CFG, SET, model, ec)
    assert not profiling.counting()
    assert recorder.log == []
    c = profiling.counters()
    assert c["ode.lane_attempts"] == int(attempts.sum()) > 0


def test_counters_sum_over_calls():
    """Each booking adds to the totals; reading sums the held attempt
    counts once; reset clears them."""
    profiling.tracing(counters=True)
    for i in range(5):
        profiling.count_lockstep(8, 3, [torch.tensor([1, i + 1]),
                                        torch.tensor([2, 2])])
    c = profiling.counters()
    assert c == {"ode.attempts_launched": 40, "ode.checks": 15,
                 "ode.lane_slots": 80,
                 "ode.lane_attempts": sum(i + 6 for i in range(5)),
                 "ode.slowest_lane_attempts": sum(i + 1 + 2
                                                  for i in range(5))}
    assert profiling.counters() == c
    profiling.count_lockstep(4, 2, [torch.tensor([3, 1])])
    assert profiling.counters()["ode.lane_attempts"] == c[
        "ode.lane_attempts"] + 4
    profiling.reset()
    assert set(profiling.counters().values()) == {0}


def _inside(inner: dict, outer: list) -> bool:
    s, e = inner["ts"], inner["ts"] + inner["dur"]
    return any(o["ts"] <= s and e <= o["ts"] + o["dur"] for o in outer)


def test_spans_nest_under_the_profiler(prepared, tmp_path):
    """No switch: device_trace (the CLI's --trace-dir) turns spans on,
    and its profiler the counters."""
    model, ec, _ = prepared
    with profiling.device_trace(str(tmp_path)):
        driver._solve(CFG, SET, model, ec)
    assert profiling.span("a") is profiling.span("b")
    assert not profiling.counting()
    events = json.loads((tmp_path / "trace.json").read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    by_name: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            by_name.setdefault(e["name"], []).append(e)
    for outer, inner in NESTED:
        assert by_name.get(inner), inner
        assert all(_inside(e, by_name[outer]) for e in by_name[inner]), \
            (outer, inner)
    c = profiling.counters()
    assert len(by_name["ode.attempt"]) == c["ode.attempts_launched"] > 0
    assert len(by_name["ode.check"]) == c["ode.checks"]
    assert len(by_name["trg.rhs"]) == 6 * c["ode.attempts_launched"]


def test_prepare_opens_its_spans(prepared):
    log = prepared[2]
    names = [name for name, _ in log]
    assert names[0] == PREPARE[0]
    assert all(names.count(k) == 1 for k in PREPARE)
    assert all(PREPARE[0] in around for name, around in log[1:])


def test_stage_timer_opens_its_span(recorder):
    profiling.tracing(spans=True)
    timer = StageTimer(enabled=False)
    for _ in range(2):
        with timer.stage("solve"):
            with profiling.span("inner"):
                pass
    assert recorder.log == [("solve", ()), ("inner", ("solve",))] * 2
    assert timer.times["solve"] > 0


def metric(name: str, rec: dict):
    return harness.load_module("metrics", name).read(rec)


TRACED = dict(traced=dict(cosmologies=4))


def test_readers_of_the_counters(monkeypatch):
    for name in ("lockstep_occupancy", "overrun_attempt_pct"):
        assert metric(name, {}) is None            # no traced calls
        assert metric(name, TRACED) is None        # nothing counted
    profiling.tracing(counters=True)
    profiling.count_lockstep(16, 6, [torch.tensor([5, 8, 2]),
                                     torch.tensor([3, 6, 1])])
    assert metric("lockstep_occupancy", TRACED) == pytest.approx(
        100.0 * 25 / 48)
    assert metric("overrun_attempt_pct", TRACED) == pytest.approx(
        100.0 * 2 / 16)
    # a program without counters (the parent commit's) reads nothing
    monkeypatch.delattr(profiling, "counters")
    assert metric("lockstep_occupancy", TRACED) is None
    assert metric("overrun_attempt_pct", TRACED) is None


def _x(name: str, cat: str, ts: float, dur: float) -> dict:
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur)


def test_idle_booked_to_the_spans_open_where_it_starts():
    """Device ops at [10, 20], [40, 50], [55, 60] between markers at 0
    and 100 (us): idle 10 + 20 + 5 + 40 (to the second marker's end).
    The gap at 20 starts in ode.check (nested in ode.interval, opened at
    the same time), the one at 50 in ode.attempt, the one at 60 in
    ode.interval and the first one in no span."""
    ev = [_x("spin_kernel", "kernel", 0, 0), _x("spin_kernel", "kernel",
                                                 100, 0),
          _x("k1", "kernel", 10, 10), _x("k2", "kernel", 40, 10),
          _x("cpy", "gpu_memcpy", 55, 5),
          _x("ode.interval", "user_annotation", 15, 70),
          _x("ode.check", "user_annotation", 15, 10),
          _x("aten::item", "cpu_op", 16, 8),
          _x("ode.attempt", "user_annotation", 30, 25),
          _x("trg.rhs", "user_annotation", 31, 5)]
    got = trace_spans.reduce_spans(ev)
    assert got["window_s"] == pytest.approx(100e-6)
    assert got["idle_s"] == pytest.approx(75e-6)
    assert got["check_idle_s"] == pytest.approx(20e-6)
    assert got["idle_by_span"] == pytest.approx(
        {"ode.check": 20e-6, "ode.attempt": 5e-6, "ode.interval": 40e-6,
         "no span": 10e-6})
    assert got["spans"]["ode.check"] == [1, pytest.approx(10e-6)]
    assert "aten::item" not in got["spans"]
    assert trace_spans.reduce_spans(
        [_x("ode.check", "user_annotation", 0, 1)]) == {}


def test_the_new_metrics_are_reported_in_both_cells():
    m = harness.load_json(harness.ROOT, "BENCHMARK.json")
    for cell in ("trg128.solve.w512", "trg512.solve.w64"):
        names = [x["name"] for x in harness.metrics_of(m, cell, True)]
        assert {"lockstep_occupancy", "overrun_attempt_pct"} <= set(names)
