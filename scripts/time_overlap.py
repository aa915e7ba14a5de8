"""Walls of run_batch's chunked scheduler over the bench's batch of 64 in
two or more checkouts of the repo on one CUDA card, in turns: the
host-prepare overlap of one checkout against another's inline prepare;
and one RHS evaluation's device kernels, device busy ms and host ms.

    python3 scripts/time_overlap.py [--rounds N] [--out PATH]
        [--cells NAME,...] ROOT [ROOT ...]

For each round, each ROOT in turn (the order reversed every other round,
so two roots run A, B, B, A): a fresh python imports that checkout's
redtime_tpu_torch, builds its kernels, runs one untimed chunk of each
mode (set-up: a 16-lane full-TRG chunk, a 32-lane 1-loop one), then times
run_batch at the default placement (prepare on the host): one chunk of
this checkout's chip_smoke bench batch (full TRG 16 lanes, 1-loop 32)
and the whole batch of 64 (full TRG in 4 chunks of 16, 1-loop with
print_bias in 2 chunks of 32), each with a StageTimer (prepare, solve
and, where the checkout has it, the overlap's stats); the rhs_ cells
take one RHS evaluation (trg.make_rhs) of a full-TRG chunk of 16 and a
1-loop chunk of 32 design cosmologies, on chip_smoke.rt_state's states,
and count its device kernels and device busy ms (torch.profiler,
chip_smoke.device_kernels: a window of 10 calls) and its host ms (20
calls, synchronized).  --cells times only the named
ones of CELLS (and warms up only their modes).  Prints one JSON
line per (round, root) and writes them all, with the card's name and
power limit, to PATH (default chiprun_out/time_overlap.json).  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("full_trg_16", "full_trg_64", "oneloop_32", "oneloop_64",
         "rhs_full_16", "rhs_oneloop_32")
RHS_CELLS = CELLS[4:]


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "time_overlap_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_one(root: str, cells=CELLS) -> dict:
    """The walls of `cells` in the checkout at root (this process)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from redtime_tpu_torch import driver, fastpt, trg
    from redtime_tpu_torch.config import RunSettings, SolverConfig
    from redtime_tpu_torch.kernels import build
    from redtime_tpu_torch.profiling import StageTimer

    smoke = _smoke()
    build.build()
    full = (SolverConfig(), RunSettings(one_loop=False, z_out=smoke.Z_OUT))
    oneloop = (SolverConfig(print_bias=True),
               RunSettings(one_loop=True, z_out=smoke.Z_OUT_1L))
    rhs_runs = [(name, *run) for name, run in zip(RHS_CELLS, (
        (full, smoke.N_DESIGN), (oneloop, smoke.N_DESIGN_1L)))
        if name in cells]
    runs = [(name, *run) for name, run in zip(CELLS, (
        (full, smoke.N_DESIGN, smoke.N_DESIGN),
        (full, smoke.N_DESIGN, smoke.BATCH_BENCH),
        (oneloop, smoke.N_DESIGN_1L, smoke.N_DESIGN_1L),
        (oneloop, smoke.N_DESIGN_1L, smoke.BATCH_BENCH))) if name in cells]
    for mode, n in ((full, smoke.N_DESIGN), (oneloop, smoke.N_DESIGN_1L)):
        if any(run[1] is mode for run in runs + rhs_runs):
            driver.run_batch(*mode, *smoke.design_inputs(n), device="cuda")
    torch.cuda.synchronize()
    out = dict(root=root)
    for name, (cfg, settings), n_golden, batch in runs:
        cs, lins = smoke.design_inputs(
            batch, smoke.bench_params(n_golden)[:batch])
        timer = StageTimer(enabled=False)
        t0 = time.perf_counter()
        driver.run_batch(cfg, settings, cs, lins, device="cuda",
                         timer=timer)
        torch.cuda.synchronize()
        out[name] = dict(wall_s=time.perf_counter() - t0,
                         stages_s=dict(timer.times),
                         stats={k: v for k, v in timer.stats.items()
                                if k != "attempts"})
    dev = torch.device("cuda")
    for name, (cfg, settings), B in rhs_runs:
        cs, lins = smoke.design_inputs(B)
        m = driver._prepare(cfg, ([x.numpy() for x in cs], list(lins), None),
                            dev, True)
        ec = fastpt.engine_consts(cfg, dev)
        cache = (trg.build_oneloop_cache(cfg, settings, m, ec)
                 if settings.one_loop else None)
        eta, y = smoke.rt_state(np.random.default_rng(7), cfg, settings, m,
                                B)
        rhs = trg.make_rhs(cfg, settings, m, ec, cache)
        kernels, busy, _ = smoke.device_kernels(lambda: rhs(eta, y))
        out[name] = dict(rhs_device_kernels=kernels,
                         rhs_device_busy_ms=busy,
                         rhs_host_ms=smoke.rhs_host_ms(rhs, eta, y))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--out")
    ap.add_argument("--cells", default=",".join(CELLS))
    args = ap.parse_args()
    cells = args.cells.split(",")
    if not set(cells) <= set(CELLS):
        ap.error(f"--cells: names of {', '.join(CELLS)}")
    if args.one:
        print(json.dumps(time_one(args.one, cells)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_overlap: no CUDA device", file=sys.stderr)
        return 2
    out = dict(card=_smoke().card_line(), runs=[])
    print(out["card"])
    for rnd in range(args.rounds):
        for root in args.roots if rnd % 2 == 0 else args.roots[::-1]:
            p = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--one", root, "--cells", args.cells],
                               capture_output=True,
                               text=True, timeout=900)
            if p.returncode:
                print(p.stderr[-4000:], file=sys.stderr)
                return 1
            row = dict(json.loads(p.stdout.strip().splitlines()[-1]),
                       round=rnd)
            out["runs"].append(row)
            print(json.dumps(row))
    path = args.out or os.path.join(ROOT, "chiprun_out", "time_overlap.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
