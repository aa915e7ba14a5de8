"""Walls of run_batch's chunked scheduler over the bench's batch of 64 in
two or more checkouts of the repo on one CUDA card, in turns: the
host-prepare overlap of one checkout against another's inline prepare.

    python3 scripts/time_overlap.py [--rounds N] [--out PATH] ROOT [ROOT ...]

For each round, each ROOT in turn (the order reversed every other round,
so two roots run A, B, B, A): a fresh python imports that checkout's
redtime_tpu_torch, builds its kernels, runs one untimed 16-lane full-TRG
chunk (set-up), then times run_batch at the default placement (prepare on
the host) over this checkout's chip_smoke bench batch: full TRG in 4
chunks of 16 and 1-loop (print_bias) in 2 chunks of 32, each with a
StageTimer (prepare, solve and, where the checkout has it, the overlap's
stats).  Prints one JSON line per (round, root) and writes them all, with
the card's name and power limit, to PATH (default
chiprun_out/time_overlap.json).  Imports nothing of JAX.
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


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "time_overlap_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_one(root: str) -> dict:
    """The walls of the two batches in the checkout at root (this
    process)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from redtime_tpu_torch import driver
    from redtime_tpu_torch.config import RunSettings, SolverConfig
    from redtime_tpu_torch.kernels import build
    from redtime_tpu_torch.profiling import StageTimer

    smoke = _smoke()
    build.build()
    full = (SolverConfig(), RunSettings(one_loop=False, z_out=smoke.Z_OUT))
    oneloop = (SolverConfig(print_bias=True),
               RunSettings(one_loop=True, z_out=smoke.Z_OUT_1L))
    driver.run_batch(*full, *smoke.design_inputs(smoke.N_DESIGN),
                     device="cuda")
    torch.cuda.synchronize()
    out = dict(root=root)
    for name, (cfg, settings), n_golden in (
            ("full_trg_64", full, smoke.N_DESIGN),
            ("oneloop_64", oneloop, smoke.N_DESIGN_1L)):
        cs, lins = smoke.design_inputs(smoke.BATCH_BENCH,
                                       smoke.bench_params(n_golden))
        timer = StageTimer(enabled=False)
        t0 = time.perf_counter()
        driver.run_batch(cfg, settings, cs, lins, device="cuda",
                         timer=timer)
        torch.cuda.synchronize()
        out[name] = dict(wall_s=time.perf_counter() - t0,
                         stages_s=dict(timer.times),
                         stats={k: v for k, v in timer.stats.items()
                                if k != "attempts"})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_one(args.one)))
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
                                "--one", root], capture_output=True,
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
