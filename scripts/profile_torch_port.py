"""Where the time goes in the PyTorch port's main path on one CUDA card.

    python3 scripts/profile_torch_port.py [--oneloop] [--out PATH]

from the root of a checkout.  Runs a chip_smoke.py cell: by default the
full-TRG one (16 design cosmologies, SolverConfig() defaults, the bench's
eight output redshifts), with --oneloop the 1-loop one (32 design
cosmologies, SolverConfig(print_bias=True), the bench's secondary
redshifts), and measures:

  * phases: prepare_model, evolve (in 1-loop mode the z1l cache build
    included) and _finalize, host clock with torch.cuda.synchronize()
    around each, two repeats after one untimed warm-up, with each phase's
    kernel launch counts and attempts per lane;
  * one RHS evaluation at the cell's lanes and its pieces (extend_power,
    the windowed engine, assemble, omega_matrix): host clock over 20
    calls and CUDA events over 20 calls;
  * torch.profiler over one RHS evaluation and over one controller
    attempt: the device kernels of each, and so the kernels an attempt
    launches outside its RHS evaluations;
  * torch.profiler over prepare_model and over the first output interval
    of the evolution: the count of device kernels, the device's busy time
    and its idle share of the profiled wall, and the top device kernels.

With --placements it measures instead the walls of driver.run_batch over
the bench's design (latin_hypercube(B, seed=42)) at B = 16, 64 and 128
(--batches), full TRG and 1-loop, for the two prepare placements:
  card: prepare_on_host=False, each chunk prepared on the card;
  host: prepare_on_host=True (the default), each chunk prepared on the
      host CPU, then copied to the card;
in rounds (card, host), (host, card), after one untimed chunk per mode,
each with its StageTimer stages (prepare, solve); before them,
prepare_model of one chunk on the host CPU at one torch thread (as
run_batch prepares there) and at torch's default.

Prints each result and writes them all as JSON to PATH (default
chiprun_out/profile_torch_port[_oneloop|_placements].json).  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from redtime_tpu_torch import (assembly, driver, fastpt, model,  # noqa: E402
                               state, trg)
from redtime_tpu_torch.config import (CosmoParams, RunSettings,  # noqa: E402
                                      SolverConfig)
from redtime_tpu_torch.grids import make_grids  # noqa: E402
from redtime_tpu_torch.io.camb import LinearData  # noqa: E402
from redtime_tpu_torch.kernels import build, counts  # noqa: E402
from redtime_tpu_torch.kernels.rk_finish import attempt_consts  # noqa: E402
from redtime_tpu_torch.ode import attempt, integrate_interval  # noqa: E402


def sync() -> None:
    torch.cuda.synchronize()


def host_ms(fn, n: int = 20) -> float:
    """Mean host-clock time of fn() in ms over n calls, synchronized."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync()
    return (time.perf_counter() - t0) / n * 1e3


def phases(cfg, settings, cs, lins, ec, out: dict) -> tuple:
    model.prepare_model(cfg, cs, lins)       # warm-up: cuBLAS, allocator
    sync()
    for rep in range(2):
        counts.reset()
        t0 = time.perf_counter()
        m = model.prepare_model(cfg, cs, lins)
        sync()
        t1 = time.perf_counter()
        c_prep = counts.snapshot()
        counts.reset()
        ys, att = trg.evolve(cfg, settings, m, ec, return_stats=True)
        sync()
        t2 = time.perf_counter()
        c_ev = counts.snapshot()
        driver._finalize(cfg, settings, m, ys, ec)
        sync()
        t3 = time.perf_counter()
        out[f"phases_{rep}"] = dict(
            prepare_s=t1 - t0, evolve_s=t2 - t1, finalize_s=t3 - t2,
            prepare_launches=c_prep, evolve_launches=c_ev,
            attempts=att.tolist())
        print(out[f"phases_{rep}"])
    return m, ys


def _rhs(cfg, settings, m, ec):
    cache = (trg.build_oneloop_cache(cfg, settings, m, ec)
             if settings.one_loop else None)
    return trg.make_rhs(cfg, settings, m, ec, cache)


def rhs_pieces(cfg, settings, m, ys, cs, ec, out: dict) -> None:
    dev = ys.device
    B = ys.shape[0]
    rhs = _rhs(cfg, settings, m, ec)
    y = ys[:, 3].reshape(B, -1).contiguous()
    eta = torch.full((B,), 3.0, dtype=torch.float64, device=dev)
    k = torch.as_tensor(np.asarray(make_grids(cfg).k), device=dev)
    lnP = y.reshape(B, trg.NU_STATE, -1)[:, :3].contiguous()
    P = fastpt.extend_power(cfg, lnP, cs.n_s, ec)
    Jw, Jlo, PZw = fastpt.compute_J_PZ_windowed(cfg, P, True, ec)
    pieces = {
        "rhs": lambda: rhs(eta, y),
        "extend_power": lambda: fastpt.extend_power(cfg, lnP, cs.n_s, ec),
        "engine_windowed": lambda: fastpt.compute_J_PZ_windowed(
            cfg, P, True, ec),
        "assemble": lambda: assembly.assemble(Jw[:, :7], PZw, Jw[:, 7:],
                                              Jlo, k, True),
        "omega": lambda: trg.omega_matrix(cfg, m, 0.005 * torch.exp(eta)),
    }
    out["rhs_ms"] = {name: dict(host_ms=host_ms(fn),
                                event_ms=chip_smoke.time_ms(fn))
                     for name, fn in pieces.items()}
    print(out["rhs_ms"])


def device_profile(fn) -> dict:
    """torch.profiler over fn(): wall, the device's busy time and idle
    share, the count of device kernels and the 15 largest."""
    from torch.profiler import ProfilerActivity, profile

    # device activity only: prepare alone launches ~700,000 kernels, and
    # a record of every host operator beside them takes minutes to sum
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    cuda = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in cuda) / 1e6
    return dict(
        wall_s=wall, device_busy_s=busy, device_idle_share=1.0 - busy / wall,
        device_kernel_count=sum(e.count for e in cuda),
        top_kernels=[dict(name=e.key[:120], count=e.count,
                          device_ms=e.self_device_time_total / 1e3)
                     for e in sorted(cuda, key=lambda e:
                                     -e.self_device_time_total)[:15]])


def _show(name: str, prof: dict) -> None:
    print(name, {k: v for k, v in prof.items() if k != "top_kernels"})
    for k in prof["top_kernels"][:8]:
        print(f"    {k['device_ms']:10.3f} ms {k['count']:8d}  {k['name']}")


def profile_attempt(cfg, settings, m, ys, ec, out: dict) -> None:
    """Device kernels of one RHS evaluation and of one controller attempt
    of the evolution; the difference to s evaluations is what the attempt
    launches outside its RHS (stage inputs, stage times, the tail)."""
    dev = ys.device
    B = ys.shape[0]
    rhs = _rhs(cfg, settings, m, ec)
    y = ys[:, 3].reshape(B, -1).contiguous()
    tab = trg.eta_tableau(cfg)
    consts = attempt_consts(tab, cfg.eabs_P, cfg.erel_P, dev)
    f64 = dict(dtype=torch.float64, device=dev)
    t, h, t1 = (torch.full((B,), v, **f64) for v in (3.0, 1e-2, 3.5))
    n = torch.zeros(B, dtype=torch.int64, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    one = lambda: attempt(rhs, t, h, y, t1, n, active, consts)
    one()
    per_rhs = device_profile(lambda: rhs(t, y))["device_kernel_count"]
    per_attempt = device_profile(one)["device_kernel_count"]
    out["kernels"] = dict(
        per_rhs=per_rhs, per_attempt=per_attempt, stages=consts.s,
        per_attempt_outside_rhs=per_attempt - consts.s * per_rhs)
    print("device kernels", out["kernels"])


def profile_phases(cfg, settings, m, cs, lins, ec, out: dict) -> None:
    out["profile_prepare"] = device_profile(
        lambda: model.prepare_model(cfg, cs, lins))
    _show("prepare", out["profile_prepare"])
    rhs = _rhs(cfg, settings, m, ec)
    y0 = trg.initial_state(cfg, settings, m)
    t1 = float(settings.etasteps()[0])
    h0 = 1e-2 * float(np.log(1.0 / settings.a_in))
    attempts = []
    prof = device_profile(lambda: attempts.append(integrate_interval(
        rhs, 0.0, t1, y0, h0, cfg.eabs_P, cfg.erel_P, trg.eta_tableau(cfg),
        return_stats=True)[2].tolist()))
    out["profile_first_interval"] = dict(prof, attempts=attempts[0])
    _show("first interval", out["profile_first_interval"])


PLACEMENTS = {"card": False, "host": True}   # prepare_on_host


def host_prepare_threads(out: dict) -> None:
    """prepare_model of one chunk on the host CPU at one torch thread and
    at torch's default count, in turns (1, default, default, 1), both
    modes' chunk sizes."""
    default = torch.get_num_threads()
    cfg = SolverConfig()
    rows = out["host_prepare_threads"] = []
    for B in (chip_smoke.N_DESIGN, chip_smoke.N_DESIGN_1L):
        cs, lins = chip_smoke.design_inputs(B)
        chunk = ([x.numpy() for x in cs], list(lins), None)
        driver._prepare_chunk(cfg, chunk, "cpu")          # warm-up
        for n in (1, default, default, 1):
            with driver._torch_threads(n):
                t0 = time.perf_counter()
                driver._prepare_chunk(cfg, chunk, "cpu")
                rows.append(dict(lanes=B, threads=n,
                                 seconds=time.perf_counter() - t0))
            print(json.dumps(rows[-1]))


def placements(batches, out: dict) -> None:
    """run_batch walls of each placement at each batch, both modes."""
    from redtime_tpu_torch.profiling import StageTimer

    modes = {"full_trg": (SolverConfig(), RunSettings(
                 one_loop=False, z_out=chip_smoke.Z_OUT)),
             "oneloop": (SolverConfig(print_bias=True), RunSettings(
                 one_loop=True, z_out=chip_smoke.Z_OUT_1L))}
    runs = out["placements"] = []
    for mode, (cfg, settings) in modes.items():
        cs, lins = chip_smoke.design_inputs(16)
        t0 = time.perf_counter()
        driver.run_batch(cfg, settings, cs, lins, device="cuda")
        sync()
        print(f"{mode} set-up (one untimed chunk of 16): "
              f"{time.perf_counter() - t0:.3f} s")
        for B in batches:
            cs, lins = chip_smoke.design_inputs(B)
            for rnd, order in enumerate((list(PLACEMENTS),
                                         list(PLACEMENTS)[::-1])):
                for name in order:
                    timer = StageTimer(enabled=False)
                    t0 = time.perf_counter()
                    res = driver.run_batch(cfg, settings, cs, lins,
                                           device="cuda", timer=timer,
                                           prepare_on_host=PLACEMENTS[name])
                    sync()
                    wall = time.perf_counter() - t0
                    bad = driver.finite_report(res)
                    chip_smoke.check(len(bad) == 0, f"{mode} B={B} {name}: "
                                     f"non-finite lanes {list(bad)}")
                    row = dict(mode=mode, batch=B, placement=name,
                               round=rnd, wall_s=wall,
                               cosmologies_per_min=B / wall * 60.0,
                               stages_s=dict(timer.times))
                    runs.append(row)
                    print(json.dumps(row))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--oneloop", action="store_true",
                    help="the 1-loop cell instead of the full-TRG one")
    ap.add_argument("--placements", action="store_true",
                    help="time the prepare placements instead")
    ap.add_argument("--batches", default="16,64,128",
                    help="batch sizes of --placements")
    ap.add_argument("--out")
    args = ap.parse_args()
    out_path = args.out or os.path.join(
        ROOT, "chiprun_out", "profile_torch_port"
        + ("_placements" if args.placements else "_oneloop" if args.oneloop
           else "") + ".json")
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 2
    out = {"card": chip_smoke.card_line()}
    print(out["card"])
    build.build()
    if args.placements:
        host_prepare_threads(out)
        placements([int(b) for b in args.batches.split(",")], out)
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
        return 0
    dev = torch.device("cuda")
    if args.oneloop:
        B = chip_smoke.N_DESIGN_1L
        cfg = SolverConfig(print_bias=True)
        settings = RunSettings(one_loop=True, z_out=chip_smoke.Z_OUT_1L)
    else:
        B = chip_smoke.N_DESIGN
        cfg = SolverConfig()
        settings = RunSettings(one_loop=False, z_out=chip_smoke.Z_OUT)
    params = chip_smoke.design_params(B)
    lin = chip_smoke.example_linear()
    cs = CosmoParams(*[torch.as_tensor(params[:B, i], device=dev)
                       for i in range(9)])
    lins = state.linear_from_numpy(
        LinearData(*[np.stack([x] * B) for x in lin]), dev)
    ec = fastpt.engine_consts(cfg, dev)

    m, ys = phases(cfg, settings, cs, lins, ec, out)
    rhs_pieces(cfg, settings, m, ys, cs, ec, out)
    profile_attempt(cfg, settings, m, ys, ec, out)
    profile_phases(cfg, settings, m, cs, lins, ec, out)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
