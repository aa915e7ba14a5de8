"""The benchmark's frozen copies held to their sources in the repository
at the commit that added them: the input makers (rtbench.inputs), the
cost functions and peaks (rtbench.costs) and the plain path
(rtbench.rtref, through rtbench.reference), on the CPU."""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from redtime_tpu_torch import design  # noqa: E402

from rtbench import costs, inputs  # noqa: E402


@pytest.mark.parametrize("n,seed", [(1, 0), (16, 42), (256, 2 ** 40 + 7)])
def test_design_copy(n, seed):
    np.testing.assert_array_equal(inputs.latin_hypercube(n, seed=seed),
                                  design.latin_hypercube(n, seed=seed))
    u = design.latin_hypercube(n, seed=seed)
    np.testing.assert_array_equal(inputs.models_from_unit_cube(u),
                                  design.models_from_unit_cube(u))
    np.testing.assert_array_equal(inputs.design_params(n, seed),
                                  chip_smoke.design_params(n, seed))


def test_example_linear_copy():
    for got, want in zip(inputs.example_linear(),
                         chip_smoke.example_linear()):
        np.testing.assert_array_equal(got, want)


def test_box_in_configs():
    """The configurations state the box that inputs maps to."""
    import json

    for name in ("miratitan_trg_nk128", "miratitan_trg_nk512"):
        with open(os.path.join(ROOT, "rtbench", "configs",
                               name + ".json")) as f:
            box = json.load(f)["design_box"]
        np.testing.assert_array_equal(box["lower"], inputs.RANGES_LOWER)
        np.testing.assert_array_equal(box["upper"], inputs.RANGES_UPPER)


def test_stream_seeds():
    """Any whole number is a seed; different keys, different streams."""
    s = {inputs.stream(seed, k) for seed in (0, -1, 1, 2 ** 31 + 5)
         for k in (0, 1)}
    assert len(s) == 8
    assert inputs.stream(7, 3) == inputs.stream(7, 3)
    assert all(0 <= x < 2 ** 63 for x in s)


def test_peaks_copy():
    assert costs.HBM_BYTES_S == chip_smoke.HBM_BYTES_S
    assert costs.PEAK_FP64_TC == chip_smoke.PEAK_FP64_TC
    assert costs.PEAK_FP64 == chip_smoke.PEAK_FP64
    for args in ((1e9, 1e12, costs.PEAK_FP64), (1e3, 1e12, 1e15)):
        assert costs.least_time(*args) == chip_smoke.least_time(*args)


@pytest.mark.parametrize("B,D,s", [(16, 41 * 128, 6), (64, 41 * 512, 6),
                                   (3, 2, 13)])
def test_rk_costs_copy(B, D, s):
    y = torch.zeros(B, D, dtype=torch.float64)
    ks = torch.zeros(s, B, D, dtype=torch.float64)
    assert costs.rk_finish_cost(B, D, s) == chip_smoke.rk_finish_cost(y, ks)
    for i in range(1, s):
        # chip_smoke.check_rk_stage's row
        want = chip_smoke.least_time(8.0 * ((i + 2) * B * D + B + i),
                                     (2.0 * i + 1.0) * B * D,
                                     chip_smoke.PEAK_FP64)
        assert costs.rk_stage_cost(B, D, i) == want


@pytest.mark.parametrize("n", [2, 3, 64, 96, 256, 1024, 2048, 37 * 4])
def test_fft_copy(n):
    from redtime_tpu_torch import fourier

    assert costs.fft_plan(n) == fourier.fft_plan(n)
    assert costs.fft_flops(n) == chip_smoke.fft_flops(n)


@pytest.mark.parametrize("B,nk,nfam", [(16, 128, 14), (256, 128, 14),
                                       (64, 512, 14), (8, 48, 7)])
def test_engine_costs_copy(B, nk, nfam):
    npts = 4 * nk
    got = costs.engine_costs(B, nk, npts, npts, nfam)
    want = chip_smoke.engine_costs(B, nk, npts, npts, nfam)
    for g, w in zip(got, want):
        assert g == {k: v for k, v in w.items() if not k.startswith("gemm")}
    # chip_smoke.leg_rows' K1 and K2 rows
    K, O = 2 * npts, nk + 1
    k1 = chip_smoke.least_time(
        8.0 * (B * 2 * nfam * 3 * K + nfam * K * O + B * nfam * 9 * O),
        2.0 * nfam * 9 * B * K * O, chip_smoke.PEAK_FP64_TC)
    assert costs.out_leg_cost(B, nfam, K, O) == k1
    k2 = chip_smoke.least_time(
        8.0 * (7 * nk * npts + 3 * B * npts + nk + B * 7 * 3 * 3 * nk),
        2.0 * 7 * nk * 3 * B * npts, chip_smoke.PEAK_FP64_TC)
    assert costs.pz_leg_cost(B, nk, npts) == k2


@pytest.mark.parametrize("variant", ["linear", "full", "full_q", "oneloop",
                                     "oneloop_q"])
@pytest.mark.parametrize("B,nk,nz", [(16, 128, 8), (256, 128, 8),
                                     (64, 512, 0)])
def test_rt_cost_copy(variant, B, nk, nz):
    from redtime_tpu_torch import background as bg
    from redtime_tpu_torch.kernels import rhs_tail as rt

    z = lambda *s: torch.zeros(*s, dtype=torch.float64)
    nn = 101 if variant.startswith("oneloop") else 0
    om = rt.OmegaIn(z(B, nz), z(B, nz, nk), z(B), z(B),
                    bg.OmegaConsts(*[z(B)] * 13), 0.005)
    evolve_q = variant.endswith("_q")
    if variant == "linear":
        src = None
    elif variant.startswith("full"):
        src = rt.FullSrc(z(B, 14, 3, 3, nk + 1), z(B, 7, 3, 3, nk))
    else:
        src = rt.OneLoopSrc(z(B, 14, nk), z(B, 3, 8, nk), z(B, nn),
                            z(B, nn, nk), z(B, nn, nk), z(B, nk), z(B, nk),
                            200.0)
    args = (z(B, 41, nk), z(B), z(nk), om, src, evolve_q)
    want = chip_smoke.rt_cost(args)
    assert costs.rt_cost(B, nk, nz, variant, nn) == want


def test_reference_is_the_plain_path():
    """The frozen plain path gives the port's CPU bits (the same batch on
    both sides), prepare included."""
    from redtime_tpu_torch import driver
    from redtime_tpu_torch import model as mdl
    from redtime_tpu_torch.config import RunSettings, SolverConfig

    from rtbench import program, reference

    solver = dataclasses.asdict(SolverConfig(nk=32))
    st = dict(nonlinear=True, one_loop=False, print_lin=True,
              print_rsd=True, z_in=200.0, z_out=(2.02, 0.66, 0.0))
    params, lin = inputs.batch_inputs(2, 31337, 0)
    ref = reference.solve(solver, st, params, lin, device="cpu")
    cfg, rs = SolverConfig(**solver), RunSettings(**st)
    res = driver.run_batch(cfg, rs, program.cosmo(params),
                           program.linear(lin), device="cpu")
    got = program.outputs(res, [0, 1])
    for name in ("table", "sigma_v2", "H", "sigmaV2_z0"):
        np.testing.assert_array_equal(got[name], ref[name])
    m = mdl.prepare_model(cfg, program.cosmo(params), program.linear(lin))
    for f in reference.MODEL_FIELDS:
        np.testing.assert_array_equal(getattr(m, f).numpy(),
                                      ref["model"][f])


def test_fixed_design_in_the_seed_s_order():
    """With a design seed every run seed solves the same points, in its
    own order."""
    a, _ = inputs.batch_inputs(64, 1, 0, design_seed=1508)
    b, _ = inputs.batch_inputs(64, 2 ** 31 + 3, 0, design_seed=1508)
    assert not np.array_equal(a, b)
    key = lambda p: p[np.lexsort(p.T[::-1])]
    np.testing.assert_array_equal(key(a), key(b))
    np.testing.assert_array_equal(key(a), key(inputs.design_params(64, 1508)))
