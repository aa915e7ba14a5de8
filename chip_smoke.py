"""Smoke run of the PyTorch port (redtime_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, nvcc and
triton.  It

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from redtime_tpu_torch/csrc with nvcc
     (sm_90a) and compiles the Triton kernel;
  3. checks each hand kernel against its plain PyTorch version on the card
     at the main path's shapes (nk=128, np=512, 16 lanes, inputs from a
     seeded numpy generator; K3 at each tableau and state size the main
     path runs it with), with the tolerances stated below, and times
     both;
  4. runs the main path: driver.run_batch over 16 cosmologies of the
     bench's Mira-Titan Latin-hypercube design, full Time-RG at
     SolverConfig() defaults, on the card, once untimed as set-up and
     once timed, with every launch counter reset just before the timed
     run and read just after; checks that every table is
     finite, that every kernel was launched, and that lanes 0-1 match the
     JAX golden (tests/data/torch_port_golden_nk128.npz, written by
     scripts/gen_torch_port_golden.py) within 3e-5 of column scale, the
     linear columns and the sigma_v^2 and H headers within 1e-10
     relative;
  5. prints the kernels' JSON line, the card line and, last, the result.

Any failed phase raises, and the script exits non-zero without a result.
It imports nothing of JAX.  Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "data", "torch_port_golden_nk128.npz")
DETAIL = os.path.join(HERE, "chiprun_out", "chip_smoke.json")
Z_OUT = (2.02, 1.61, 1.01, 0.66, 0.43, 0.24, 0.10, 0.0)
N_DESIGN, SEED, B_CHECK = 16, 42, 16
EPS = float(np.finfo(np.float64).eps)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def example_linear():
    """The synthetic linear inputs of __graft_entry__._example_inputs (a
    smooth CDM-like transfer and a delta_nu/delta_c ratio stack)."""
    k = np.logspace(-5, 1.3, 600)
    keq = 0.015
    T = 1.0 / (1.0 + (k / keq) ** 2 * np.log(1.0 + k / keq))
    zs = np.array([200.0, 50.0, 10.0, 5.0, 2.0, 1.0, 0.5, 0.0])
    a = 1.0 / (1.0 + zs)
    ratio = 1.0 / (1.0 + (k[None, :] / 0.1) ** 2) * (0.3 + 0.7 * a[:, None])
    return np.log(k), T, T, a, k, ratio


def design_params(n: int = N_DESIGN, seed: int = SEED) -> np.ndarray:
    """[n, 9] cosmologies of the bench's design, mapped as bench.py does
    (physical densities omega divided by h^2, T_cmb = 2.726)."""
    from redtime_tpu_torch import design
    rows = design.models_from_unit_cube(design.latin_hypercube(n, seed=seed))
    om_m, om_b, s8, h, ns, w0, wa, om_nu = rows.T
    return np.stack([ns, s8, h, om_m / h ** 2, om_b / h ** 2,
                     om_nu / h ** 2, np.full(n, 2.726), w0, wa], axis=1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rk_cases(cfg) -> list:
    """(case, tableau, D, eabs, erel) of every kind of K3 launch on the
    main path: prepare's growth ramp (one [2] state per lane) and its
    node-stopped DOPRI5 segments (a [2] state per k node), both at eabs 0
    and the growth rtol, then the eta evolution (RKF45 on the full-TRG
    state, D = 41 nk)."""
    from redtime_tpu_torch import model
    n_k = len(model.growth_nodes(cfg)[1])
    return [("growth ramp", cfg.growth_ramp_tableau.upper(), 2, 0.0,
             cfg.growth_rtol),
            ("growth segments", "DOPRI5", 2 * n_k, 0.0, cfg.growth_rtol),
            ("eta", "RKF45", 41 * cfg.nk, cfg.eabs_P, cfg.erel_P)]


def check_rk_finish(rng, cfg, dev) -> list:
    """K3 against its plain version on one attempt of each rk_cases entry:
    |dy| <= 8 eps sum_j |h b_j k_j| + eps |y_out| (stage sums plus the
    final rounding of y + h sum), r, t and h within 1e-13 relative,
    identical accept/reject masks and attempt counts.  Each case must
    reject some lanes and accept others."""
    import torch

    from redtime_tpu_torch import ode
    from redtime_tpu_torch.kernels import rk_finish as k3

    t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    B = B_CHECK
    out_cases = []
    for case, tname, D, eabs, erel in rk_cases(cfg):
        tab = getattr(ode, tname)
        # eabs 0 divides by erel |y_new|: keep the state away from 0, as
        # the growth state (D a_early / a, dD/da a_early) is
        y = t(rng.standard_normal((B, D)) if eabs > 0
              else rng.uniform(0.5, 2.0, (B, D)))
        ks = t(rng.standard_normal((len(tab.c), B, D)))
        tt = t(rng.uniform(0.0, 1.0, B))
        t1 = tt + t(rng.uniform(0.05, 0.5, B))
        # h spans rejection (large), acceptance and the final clip to t1
        h = t(10.0 ** rng.uniform(-9.0, 0.0, B))
        n = torch.arange(B, dtype=torch.int64, device=dev)
        active = torch.as_tensor(rng.uniform(size=B) < 0.8, device=dev)
        b, e = t(tab.b), t(tab.e)
        prm = k3.controller_params(eabs, erel, tab.order, dev)
        args = (y, ks, tt, h, t1, n, active, b, e, prm)
        out = k3.rk_finish(*args)
        ref = k3.rk_finish_plain(*args)
        what = f"rk_finish {case}"
        h_try = torch.where(h > t1 - tt, t1 - tt, h)
        bound = (8 * EPS * (h_try[None, :, None] * b[:, None, None] * ks)
                 .abs().sum(0) + EPS * ref[0].abs())
        err_y = (out[0] - ref[0]).abs()
        check(bool((err_y <= bound).all()),
              f"{what}: y |delta|/bound {float((err_y / bound).max()):.3g}")
        for i, name in ((4, "r"), (1, "t"), (2, "h")):
            rel = ((out[i] - ref[i]).abs() / ref[i].abs()).max()
            check(float(rel) <= 1e-13, f"{what}: {name} relative {rel:.3g}")
        rej = ref[4] > k3.REJECT_ABOVE
        check(bool(torch.equal(out[4] > k3.REJECT_ABOVE, rej)),
              f"{what}: accept/reject masks differ")
        check(0 < int(rej.sum()) < B,
              f"{what}: inputs must both accept and reject lanes")
        check(bool(torch.equal(out[3], ref[3])), f"{what}: attempt counts")
        out_cases.append(dict(case=case, tableau=tname, D=D, eabs=eabs,
                              erel=erel, max_abs_err=float(err_y.max()),
                              rejected=int(rej.sum()), args=args))
    return out_cases


def check_kernels(rng, detail: dict) -> list:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from redtime_tpu_torch import fastpt
    from redtime_tpu_torch.config import SolverConfig
    from redtime_tpu_torch.kernels import out_leg as k1
    from redtime_tpu_torch.kernels import pz_leg as k2
    from redtime_tpu_torch.kernels import rk_finish as k3

    dev = torch.device("cuda")
    cfg = SolverConfig()
    ec = fastpt.engine_consts(cfg, dev)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    B, nk, npts = B_CHECK, cfg.nk, cfg.npts
    K = 2 * npts
    rows = []

    # K1: |delta| <= 2K eps (|prod| @ |G|) elementwise (the forward-error
    # bound of a K-term f64 dot product, with margin 2)
    tab = t(rng.standard_normal((B, 2, fastpt.NFAM, 3, K)))
    J = k1.out_leg(tab, ec.G)
    J_ref = k1.out_leg_plain(tab, ec.G)
    prod = tab[:, 0, :, :, None, :] * tab[:, 1, :, None, :, :] / K
    bound = 2 * K * EPS * torch.matmul(
        prod.abs().reshape(B, fastpt.NFAM, 9, K), ec.G.abs()).reshape(
            J.shape)
    err = (J - J_ref).abs()
    check(bool(torch.isfinite(J).all()), "out_leg: non-finite output")
    check(bool((err <= bound).all()),
          f"out_leg: max |delta|/bound {float((err / bound).max()):.3g}")
    rows.append(dict(
        name="out_leg", route="cuda",
        source="redtime_tpu_torch/csrc/out_leg.cu",
        replaces="scripts/probe_pallas.py:145",
        max_abs_err=float(err.max()),
        ms=time_ms(lambda: k1.out_leg(tab, ec.G)),
        plain_ms=time_ms(lambda: k1.out_leg_plain(tab, ec.G))))

    # K2 on engine-shaped spectra: |delta| <= 2np eps (|T_sl| @ |P_e|)
    # |kfac P_e| (the dot product's forward-error bound; a max-relative
    # bound is wrong here, the contraction cancels ~1e8 per element)
    g_lnk = np.log(np.logspace(np.log10(cfg.kmin), np.log10(cfg.kmax), nk))
    lnP = (8.0 - 1.5 * (g_lnk + 2.0) ** 2 / 4.0)[None, None, :] \
        + 0.05 * rng.standard_normal((B, 3, nk))
    P_e = fastpt.extend_power(cfg, t(lnP), t(np.full(B, 0.96)), ec)
    PZ = k2.pz_leg(ec.toeplitz_sl, P_e, ec.pz_kfac_sl, cfg.nshift)
    PZ_ref = k2.pz_leg_plain(ec.toeplitz_sl, P_e, ec.pz_kfac_sl,
                                  cfg.nshift)
    sl = slice(cfg.nshift, cfg.nshift + nk)
    dot_abs = torch.einsum("nim,bam->bnai", ec.toeplitz_sl.abs(), P_e.abs())
    bound = (2 * npts * EPS * dot_abs[:, :, :, None, :]
             * (ec.pz_kfac_sl * P_e[:, None, None, :, sl]).abs())
    err = (PZ - PZ_ref).abs()
    check(bool(torch.isfinite(PZ).all()), "pz_leg: non-finite output")
    check(bool((err <= bound).all()),
          "pz_leg: max |delta|/bound "
          f"{float((err / bound.clamp(min=1e-300)).max()):.3g}")
    rows.append(dict(
        name="pz_leg", route="cuda",
        source="redtime_tpu_torch/csrc/pz_leg.cu",
        replaces="redtime_tpu/fastpt.py:1310",
        max_abs_err=float(err.max()),
        ms=time_ms(lambda: k2.pz_leg(ec.toeplitz_sl, P_e,
                                          ec.pz_kfac_sl, cfg.nshift)),
        plain_ms=time_ms(lambda: k2.pz_leg_plain(
            ec.toeplitz_sl, P_e, ec.pz_kfac_sl, cfg.nshift))))

    # K3 at each tableau the main path runs it with (rk_cases)
    k3_cases = check_rk_finish(np.random.default_rng(5678), cfg, dev)
    for c in k3_cases:
        c["ms"] = time_ms(lambda: k3.rk_finish(*c["args"]))
        c["plain_ms"] = time_ms(lambda: k3.rk_finish_plain(*c["args"]))
        print(f"rk_finish {c['case']} ({c['tableau']}, D={c['D']}): "
              f"{c['ms']:.4f} ms (plain {c['plain_ms']:.4f} ms), max "
              f"|delta| {c['max_abs_err']:.3g}, {c['rejected']}/{B} "
              "lanes rejected")
    eta = k3_cases[-1]
    rows.append(dict(
        name="rk_finish", route="triton",
        source="redtime_tpu_torch/kernels/rk_finish.py",
        replaces="redtime_tpu/ode.py:161",
        max_abs_err=max(c["max_abs_err"] for c in k3_cases),
        ms=eta["ms"], plain_ms=eta["plain_ms"]))
    for c in k3_cases:
        del c["args"]
    detail["rk_finish_cases"] = k3_cases
    return rows


def run_main_path(detail: dict, card: str) -> dict:
    """16 design cosmologies through run_batch on the card, once untimed
    (set-up: Triton's compiles of each tableau's K3, cuBLAS and allocator
    first use) and once timed; returns the launch counts of the timed
    run."""
    import torch

    from redtime_tpu_torch import driver, fastpt
    from redtime_tpu_torch.kernels import counts
    from redtime_tpu_torch.config import CosmoParams, RunSettings, \
        SolverConfig
    from redtime_tpu_torch.io.camb import LinearData

    cfg = SolverConfig()
    settings = RunSettings(one_loop=False, z_out=Z_OUT)
    params = design_params()
    lin = example_linear()
    gold = np.load(GOLDEN)
    check(np.array_equal(gold["params"], params[:2])
          and np.array_equal(gold["z_out"], np.asarray(Z_OUT)),
          "design lanes 0-1 or z_out differ from the golden's inputs")
    for name, x in zip(LinearData._fields, lin):
        check(np.array_equal(gold[name], x),
              f"linear input {name} differs from the golden's")
    cs = CosmoParams(*[torch.as_tensor(params[:, i]) for i in range(9)])
    lins = LinearData(*[np.stack([x] * N_DESIGN) for x in lin])
    t0 = time.perf_counter()
    fastpt.engine_consts(cfg, "cuda")
    driver.run_batch(cfg, settings, cs, lins, device="cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    print(f"set-up: engine constants and one untimed run_batch of the same "
          f"chunk {setup:.3f} s")

    counts.reset()
    t0 = time.perf_counter()
    res = driver.run_batch(cfg, settings, cs, lins, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts.snapshot()

    bad = driver.finite_report(res)
    check(len(bad) == 0, f"non-finite lanes {list(bad)}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    table = res.table[:2].cpu().numpy()
    ref = gold["table"]
    check(table.shape == ref.shape, f"table shape {table.shape}")
    scale = np.max(np.abs(ref), axis=(0, 2), keepdims=True) + 1e-300
    dev_col = float(np.max(np.abs(table - ref) / scale))
    dev_lin = float(np.max(np.abs(table[..., :7] - ref[..., :7])
                           / (np.abs(ref[..., :7]) + 1e-300)))
    check(dev_col <= 3e-5, f"lanes 0-1 vs golden {dev_col:.3g} of column "
                           "scale (bound 3e-5)")
    check(dev_lin <= 1e-10, f"linear columns vs golden {dev_lin:.3g} "
                            "relative (bound 1e-10)")
    check(bool(np.all(res.table[..., 13:17].cpu().numpy() == 0.0)),
          "full-TRG PT columns must be zero")
    for name in ("sigma_v2", "H", "sigmaV2_z0"):
        got = getattr(res, name)[:2].cpu().numpy()
        rel = float(np.max(np.abs(got - gold[name]) / np.abs(gold[name])))
        check(rel <= 1e-10, f"{name} vs golden {rel:.3g} relative "
                            "(bound 1e-10)")
    per_min = N_DESIGN / wall * 60.0
    detail.update(e2e=dict(setup_s=setup, wall_s=wall, cosmologies=N_DESIGN,
                           cosmologies_per_min=per_min,
                           golden_dev_col_scale=dev_col,
                           golden_dev_linear_rel=dev_lin,
                           launches=launches))
    print(f"main path on {card}: {N_DESIGN} cosmologies, full TRG nk=128, "
          f"{wall:.3f} s = {per_min:.2f} cosmologies/min; lanes 0-1 vs "
          f"JAX golden {dev_col:.3g} of column scale, linear "
          f"{dev_lin:.3g}; launches {launches}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from redtime_tpu_torch.kernels import build, rk_finish as k3

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    detail: dict = {"card": card}

    t0 = time.perf_counter()
    lib = build.build()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    k3._kernel()
    print(f"build: nvcc {build_s:.3f} s ({lib.name}); triton import "
          f"{time.perf_counter() - t0:.3f} s")
    detail["build"] = dict(build.BUILD_LOG, wall_s=build_s)

    rows = check_kernels(np.random.default_rng(1234), detail)
    for r in rows:
        print(f"kernel {r['name']}: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f} ms), max |delta| {r['max_abs_err']:.3g}")
    launches = run_main_path(detail, card)
    for r in rows:
        r["launches"] = launches[r["name"]]
    detail["kernels"] = rows
    os.makedirs(os.path.dirname(DETAIL), exist_ok=True)
    with open(DETAIL, "w") as f:
        json.dump(detail, f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
