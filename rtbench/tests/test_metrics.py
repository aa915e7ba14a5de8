"""The metric arithmetic on synthetic records: rates over the whole
window, roofline shares from counts and device seconds, the idle union of
a trace, the breakdown, and the comparison's numbers."""

from __future__ import annotations

import math

import numpy as np
import pytest

from rtbench import compare, costs, harness, trace


def metric(name: str, rec: dict):
    return harness.load_module("metrics", name).read(rec)


SHAPE = dict(lanes=256, batch=256, nk=128, npts=512, nfam=14, nz=8,
             rt_variant="full_q", stages=6)


def test_rates_over_the_whole_window():
    rec = dict(window=dict(seconds=30.0, calls=90, cosmologies=90 * 256,
                           failed=0))
    assert metric("solve_cosmo_per_min", rec) == pytest.approx(46080.0)
    assert metric("solve_cosmo_per_min", {}) is None
    assert metric("setup_s", dict(setup_s=17.5)) == 17.5


def test_per_layer_readers_read_nothing_without_a_trace():
    for name in ("rk_roofline", "engine_roofline", "rhs_tail_roofline",
                 "device_idle_pct.solve", "lane_attempts_per_cosmo"):
        assert metric(name, dict(inputs=SHAPE)) is None
        assert metric(name, dict(inputs=SHAPE, traced=dict(
            trace={}, launches={}, cosmologies=256))) is None


def traced(kernels: dict, **kw) -> dict:
    t = dict(trace=dict(kernels=kernels, busy_s=0.5, window_s=2.0),
             launches=kw.get("launches", {}),
             cosmologies=kw.get("cosmologies", 512))
    return dict(inputs=SHAPE, traced=t)


def test_roofline_shares():
    B, D = SHAPE["lanes"], 41 * SHAPE["nk"]
    fin = costs.rk_finish_cost(B, D, 6)["bound_ms"] * 1e-3
    stg = sum(costs.rk_stage_cost(B, D, i)["bound_ms"] for i in range(1, 6))
    stg *= 1e-3
    # 100 attempts at twice their least time
    rec = traced({"rk_finish": [100, 2 * 100 * fin],
                  "rk_stage": [500, 2 * 100 * stg]})
    assert metric("rk_roofline", rec) == pytest.approx(50.0)
    k9, k10 = costs.engine_costs(256, 128, 512, 512, 14)
    least = (k9["bound_ms"] + k10["bound_ms"]
             + costs.out_leg_cost(256, 14, 1024, 129)["bound_ms"]
             + costs.pz_leg_cost(256, 128, 512)["bound_ms"]) * 1e-3
    share = {"engine_front": [600, 600 * least / 4],
             "tab_leg": [600, 600 * least / 4],
             "out_leg": [600, 600 * least / 4],
             "pz_leg": [600, 600 * least / 4]}
    assert metric("engine_roofline", traced(share)) == pytest.approx(100.0)
    rt = costs.rt_cost(256, 128, 8, "full_q")["bound_ms"] * 1e-3
    rec = traced({"rhs_tail": [600, 600 * rt * 4]})
    assert metric("rhs_tail_roofline", rec) == pytest.approx(25.0)


def test_counters_and_spans():
    rec = traced({}, launches={"rk_finish": 96}, cosmologies=512)
    # 96 attempts a chunk of 256 lanes, over 2 calls of 256
    assert metric("lane_attempts_per_cosmo", rec) == pytest.approx(48.0)
    assert metric("device_idle_pct.solve", rec) == pytest.approx(75.0)


def ev(cat, name, ts, dur, ph="X"):
    return dict(cat=cat, name=name, ts=ts, dur=dur, ph=ph)


def test_trace_union_markers_and_gaps():
    events = [
        ev("kernel", "void spin_kernel(long)", 0.0, 1.0),
        ev("kernel", "void rk_finish_kernel<6>(double*)", 10.0, 5.0),
        ev("kernel", "void rk_stage_kernel(double*)", 12.0, 6.0),   # overlap
        ev("gpu_memcpy", "Memcpy DtoH", 30.0, 2.0),
        ev("kernel", "out_leg_kernel(double const*)", 50.0, 10.0),
        ev("kernel", "void spin_kernel(long)", 99.0, 1.0),
        ev("cpu_op", "aten::copy_", 18.0, 12.0),
        ev("cuda_runtime", "cudaStreamSynchronize", 60.0, 40.0),
        ev("cpu_op", "outer", 0.0, 100.0),
        ev("kernel", "late_kernel", 200.0, 5.0),        # past the window
        ev("kernel", "no_dur", 40.0, 1.0, ph="i"),
    ]
    r = trace.reduce(events)
    assert r["window_s"] == pytest.approx(100e-6)
    # busy: [10, 18], [30, 32], [50, 60]
    assert r["busy_s"] == pytest.approx(20e-6)
    assert r["kernels"]["rk_finish"] == [1, pytest.approx(5e-6)]
    assert r["kernels"]["rk_stage"] == [1, pytest.approx(6e-6)]
    assert r["kernels"]["out_leg"] == [1, pytest.approx(10e-6)]
    ops = dict(r["breakdown"]["device_ops"])
    assert ops["out_leg_kernel"] == pytest.approx(10e-6)
    gaps = dict(r["breakdown"]["idle_gaps"])
    # gaps [0,10] and [32,50]: "outer"; [18,30]: aten::copy_; [60,100]:
    # cudaStreamSynchronize
    assert gaps["outer"] == pytest.approx(28e-6)
    assert gaps["aten::copy_"] == pytest.approx(12e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(40e-6)
    assert math.isclose(sum(gaps.values()) + r["busy_s"], r["window_s"])


def test_trace_without_device_events():
    assert trace.reduce([ev("cpu_op", "x", 0.0, 1.0)]) == {}


@pytest.mark.parametrize("name,want", [
    ("void rhs_tail_kernel<3, true>(double*, int)", "rhs_tail_kernel"),
    ("engine_front_kernel", "engine_front_kernel"),
    ("Memcpy HtoD (Pinned -> Device)", "Memcpy HtoD")])
def test_short_names(name, want):
    assert trace.short_name(name) == want


def test_compare_gaps():
    rng = np.random.default_rng(0)
    ref = dict(table=rng.uniform(1, 2, (2, 3, 8, 4)),
               sigma_v2=rng.uniform(1, 2, (2, 3)), H=np.ones((2, 3)),
               sigmaV2_z0=np.ones(2))
    ref["table"][..., 3] = 0.0          # a column printed as 0
    got = {k: v.copy() for k, v in ref.items()}
    assert compare.gaps(got, ref) == dict(table=0.0, headers=0.0)
    got["table"][1, 2, 5, 1] += 1e-6 * np.abs(ref["table"][1, 2, :, 1]).max()
    got["H"] = got["H"] * (1 + 1e-9)
    g = compare.gaps(got, ref)
    assert g["table"] == pytest.approx(1e-6)
    assert g["headers"] == pytest.approx(1e-9)
    got["table"][0, 0, 0, 3] = 1e-30     # must read 0
    assert compare.gaps(got, ref)["table"] == math.inf
    got["table"][0, 0, 0, 3] = 0.0
    got["table"][0, 1, 2, 0] = np.nan
    assert compare.gaps(got, ref)["table"] == math.inf
    ok, checks = compare.judge(dict(table=1e-7, headers=2e-9),
                               dict(table=1e-6, headers=1e-9))
    assert not ok and checks == dict(table=[1e-7, 1e-6],
                                     headers=[2e-9, 1e-9])
    assert compare.judge(dict(table=1e-7), {})[0] is False


def test_gaps_without_host_events_name_the_next_operation():
    events = [ev("kernel", "void spin_kernel(long)", 0.0, 1.0),
              ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 10.0, 2.0),
              ev("kernel", "void (anonymous namespace)::rhs_tail_kernel<2>"
                           "(double*)", 20.0, 5.0),
              ev("kernel", "void spin_kernel(long)", 30.0, 1.0)]
    r = trace.reduce(events)
    assert r["kernels"] == {"rhs_tail": [1, pytest.approx(5e-6)]}
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert gaps["host: none traced, before Memcpy HtoD"] == \
        pytest.approx(10e-6)
    assert gaps["host: none traced, before rhs_tail_kernel"] == \
        pytest.approx(8e-6)
    assert gaps["host: none traced, at the window's end"] == \
        pytest.approx(6e-6)
