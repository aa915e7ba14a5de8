"""The precision control of a cell's check: the plain reference computed
in float32, in the program's place, against the reference in float64 (the
configurations' precision), on the cell's sampled cosmologies:

    python3 rtbench/control.py --workload <cell> --seeds 1 2 3 [--device cuda]

For each seed it makes the cell's inputs as a run does (rtbench.inputs),
takes the lanes a run checks (program.sample_lanes), runs the reference in
float64 and in float32 (prepare in float64, the evolution and the output
block in float32: the step a later change would be tempted to take), and
prints the compared numbers beside the cell's limits.  Exits 0 when the
control fails at least one limit on every seed, 1 otherwise.  A float32
run that raises or reads NaN fails, with no number.  Imports nothing of
the program.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))


def cell_inputs(manifest: dict, workload: str, seed: int) -> tuple:
    """(solver, settings, traffic, params, lin) of the lanes a run of the
    cell at seed checks (in the design entry, of its first call)."""
    import numpy as np

    from rtbench import harness, inputs, program

    cell = harness.cell_of(manifest, workload)
    config = harness.load_json(harness.HERE, "configs",
                               cell["config"] + ".json")
    traffic = harness.load_json(harness.HERE, "traffic",
                                cell["traffic"] + ".json")
    ctx = types.SimpleNamespace(seed=seed, traffic=traffic)
    idx = program.sample_lanes(ctx)
    params, lin = inputs.batch_inputs(int(traffic["batch"]), seed, 0,
                                      design_seed=traffic.get("design_seed"))
    return (config["solver"], config["settings"], traffic, params[idx],
            tuple(np.asarray(x)[idx] for x in lin))


def readings(manifest: dict, workload: str, seed: int, device: str) -> dict:
    """The compared numbers of the float32 control against float64 at one
    seed (inf where the control raised or gave no finite number)."""
    import torch

    from rtbench import compare, reference

    solver, settings, traffic, params, lin = cell_inputs(manifest, workload,
                                                         seed)
    ref = reference.solve(solver, settings, params, lin, device=device)
    try:
        ctl = reference.solve(solver, settings, params, lin, device=device,
                              dtype=torch.float32)
    except (RuntimeError, ValueError, FloatingPointError) as e:
        print(f"control raised: {e}", file=sys.stderr)
        return {"table": float("inf"), "headers": float("inf")}
    return compare.gaps(ctl, ref)


def main(argv: list) -> int:
    from rtbench import harness

    p = argparse.ArgumentParser(prog="rtbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    manifest = harness.load_json(harness.ROOT, "BENCHMARK.json")
    limits = harness.load_json(harness.HERE, "limits",
                               a.workload + ".json")
    failed_all = True
    for seed in a.seeds:
        got = readings(manifest, a.workload, seed, a.device)
        fails = {k: v > limits[k] for k, v in got.items()}
        failed_all &= any(fails.values())
        print(json.dumps(dict(workload=a.workload, seed=seed, control=got,
                              limits={k: limits[k] for k in got},
                              fails=fails)), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
