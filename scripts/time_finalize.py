"""The output block (driver._finalize) of two or more checkouts of the repo
on one CUDA card, in turns: host wall, hand-kernel launches and device
kernels of one finalize call.

    python3 scripts/time_finalize.py [--rounds N] [--reps N] [--out PATH]
        ROOT [ROOT ...]

For each round, each ROOT in turn (the order reversed every other round,
so two roots run A, B, B, A): a fresh python imports that checkout's
redtime_tpu_torch, builds its kernels and, for each cell, prepares one
chunk of this checkout's chip_smoke design cosmologies on the host (as
run_batch does), evolves it once (trg.evolve) and then times
driver._finalize on the evolved states: one untimed call, then `--reps`
calls on the host clock, each synchronized (median and range); the
launch counters over one call (kernels.counts); and the device kernels
of one call under torch.profiler (CUDA activity: kernels and copies, in
a window between two torch.cuda._sleep marker kernels, which are not
counted; the fullest of 3 windows), with the device's busy ms.  Cells:

  full_trg_16       full Time-RG, SolverConfig(), 16 lanes, the bench's
                    8 output redshifts (chip_smoke.Z_OUT);
  oneloop_32        1-loop, SolverConfig(), 32 lanes, 7 redshifts
                    (chip_smoke.Z_OUT_1L);
  oneloop_32_bias   the same with print_bias (the bench's secondary).

Prints one JSON line per (round, root) and writes them all, with the
card's name and power limit, to PATH (default
chiprun_out/time_finalize.json).  Imports nothing of JAX.
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
CELLS = ("full_trg_16", "oneloop_32", "oneloop_32_bias")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "time_finalize_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_kernels(fn, tries: int = 3) -> tuple:
    """(device activities, busy ms, {name: count}) of one fn() call under
    torch.profiler, between two marker kernels; the fullest of `tries`
    windows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    best = (-1, 0.0, {})
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        cuda = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "spin_kernel" not in e.key]
        n = sum(e.count for e in cuda)
        if n > best[0]:
            best = (n, sum(e.self_device_time_total for e in cuda) / 1e3,
                    {e.key[:80]: e.count for e in cuda})
    return best


def time_one(root: str, reps: int) -> dict:
    """The finalize cells in the checkout at root (this process)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from redtime_tpu_torch import driver, trg
    from redtime_tpu_torch.config import RunSettings, SolverConfig
    from redtime_tpu_torch.fastpt import engine_consts
    from redtime_tpu_torch.kernels import build, counts

    smoke = _smoke()
    build.build()
    dev = torch.device("cuda")
    cells = {
        "full_trg_16": (SolverConfig(), RunSettings(
            one_loop=False, z_out=smoke.Z_OUT), smoke.N_DESIGN),
        "oneloop_32": (SolverConfig(), RunSettings(
            one_loop=True, z_out=smoke.Z_OUT_1L), smoke.N_DESIGN_1L),
        "oneloop_32_bias": (SolverConfig(print_bias=True), RunSettings(
            one_loop=True, z_out=smoke.Z_OUT_1L), smoke.N_DESIGN_1L)}
    out = dict(root=root)
    for name, (cfg, settings, B) in cells.items():
        cs, lins = smoke.design_inputs(B)
        m = driver._prepare(cfg, ([x.numpy() for x in cs], list(lins), None),
                            dev, True)
        ec = engine_consts(cfg, dev)
        ys = trg.evolve(cfg, settings, m, ec)

        def fin():
            return driver._finalize(cfg, settings, m, ys, ec)

        res = fin()
        torch.cuda.synchronize()
        ncol = res.table.shape[-1]
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fin()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        counts.reset()
        fin()
        torch.cuda.synchronize()
        launches = {k: v for k, v in counts.snapshot().items() if v}
        n_dev, busy, names = device_kernels(fin)
        out[name] = dict(lanes=B, n_z=len(settings.z_out), ncol=ncol,
                         finalize_s=float(np.median(walls)),
                         finalize_s_range=[min(walls), max(walls)],
                         hand_launches=launches, device_kernels=n_dev,
                         device_busy_ms=busy, device_kernel_names=names)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_one(args.one, args.reps)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_finalize: no CUDA device", file=sys.stderr)
        return 2
    if not args.roots:
        ap.error("name at least one checkout")
    out = dict(card=_smoke().card_line(), runs=[])
    print(out["card"])
    path = args.out or os.path.join(ROOT, "chiprun_out",
                                    "time_finalize.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    for rnd in range(args.rounds):
        for root in args.roots if rnd % 2 == 0 else args.roots[::-1]:
            p = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--one", root, "--reps", str(args.reps)],
                               capture_output=True, text=True, timeout=900)
            if p.returncode:
                print(p.stderr[-4000:], file=sys.stderr)
                return 1
            row = dict(json.loads(p.stdout.strip().splitlines()[-1]),
                       round=rnd)
            out["runs"].append(row)
            brief = {c: {k: row[c][k] for k in (
                "finalize_s", "finalize_s_range", "hand_launches",
                "device_kernels", "device_busy_ms")} for c in CELLS}
            print(json.dumps(dict(root=root, round=rnd, **brief)))
            with open(path, "w") as f:
                json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
