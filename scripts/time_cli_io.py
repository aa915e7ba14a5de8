"""The CLI's table IO of two or more checkouts of the repo on one CUDA
card's host, in turns: the `batch --timing` stages load-inputs,
solve-batch and write-outputs over chip_smoke.py's production inputs.

    python3 scripts/time_cli_io.py [--rounds N] [--out PATH] ROOT [ROOT ...]

Makes the inputs once with this checkout's port, as chip_smoke.py's
production phase does: redtime_tpu_torch.design writes N_PROD = 16
Mira-Titan cosmologies (seed SEED), and redtime_tpu_torch.orchestrate
runs each through two passes of tests/mock_camb.py (33 transfer files a
model, 400 rows x 7 columns each) with the 33 CAMB redshifts as outputs,
ending in one CLI `batch` (which builds this checkout's libraries).
Then each ROOT runs `python -m redtime_tpu_torch.cli batch --timing`
over the 16 params files once untimed (its own kernel and IO builds),
then `--rounds` rounds, each ROOT in turn, the order reversed every
other round (two roots: A B B A).  A reading is one fresh process; its
stages are the CLI's --timing lines.  Checks whether every ROOT wrote
the same bytes.  Prints one JSON line a reading, then the medians and
ranges a root with the card's name and power limit, and writes them all
to PATH (default chiprun_out/time_cli_io.json).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("load-inputs", "solve-batch", "write-outputs")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "time_cli_io_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(cmd: list, cwd: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=cwd)
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"{' '.join(cmd[:4])} in {cwd} failed "
                           f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    return proc


def make_inputs(work: str, smoke) -> list:
    """The production phase's params files and CAMB stacks under work."""
    code = (
        "import sys\n"
        "from redtime_tpu_torch import design, orchestrate\n"
        "work, n, seed = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])\n"
        "design.generate_design(work + '/models.dat', n, seed=seed)\n"
        "open(work + '/z.txt', 'w').write(orchestrate.CAMB_Z_LIST + '\\n')\n"
        "sys.exit(orchestrate.main(['--redshift-file', work + '/z.txt',"
        " '--models-file', work + '/models.dat', '--output-dir',"
        " work + '/inputs', '--camb-exec', sys.argv[4]]))\n")
    _run([sys.executable, "-c", code, work, str(smoke.N_PROD),
          str(smoke.SEED), smoke.MOCK_CAMB], ROOT)
    params = sorted(glob.glob(os.path.join(work, "inputs",
                                           "params_redTime_M*.dat")))
    if len(params) != smoke.N_PROD:
        raise RuntimeError(f"{len(params)} params files in {work}")
    return params


def reading(root: str, params: list, out: str) -> dict:
    """One `batch --timing` of root's CLI in a fresh process."""
    proc = _run([sys.executable, "-m", "redtime_tpu_torch.cli", "batch",
                 "--timing", "--output-dir", out, *params], root)
    stages = {k: float(v) for k, v in re.findall(
        r"# \[timing\] (\S+): ([0-9.]+)s \(", proc.stderr)}
    missing = [s for s in STAGES if s not in stages]
    if missing:
        raise RuntimeError(f"{root}: no --timing line for {missing}:\n"
                           f"{proc.stderr[-4000:]}")
    return {s: stages[s] for s in STAGES}


def tables(out: str) -> dict:
    paths = sorted(glob.glob(os.path.join(out, "redTime_M*.dat")))
    data = {}
    for p in paths:
        with open(p, "rb") as f:
            data[os.path.basename(p)] = f.read()
    return data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "time_cli_io.json"))
    args = ap.parse_args(argv)
    smoke = _smoke()
    card = smoke.card_line()
    roots = [os.path.abspath(r) for r in args.roots]
    rows = []
    with tempfile.TemporaryDirectory() as work:
        params = make_inputs(work, smoke)
        outs = [os.path.join(work, f"out{i}") for i in range(len(roots))]
        for root, out in zip(roots, outs):
            reading(root, params, out)
        for rnd in range(args.rounds):
            order = list(range(len(roots)))
            if rnd % 2:
                order.reverse()
            for i in order:
                row = dict(round=rnd, root=roots[i],
                           **reading(roots[i], params, outs[i]))
                rows.append(row)
                print(json.dumps(row), flush=True)
        written = [tables(out) for out in outs]
    same = all(w == written[0] for w in written[1:])
    summary = {}
    for root in roots:
        mine = [r for r in rows if r["root"] == root]
        summary[root] = {s: dict(median=statistics.median(xs), low=min(xs),
                                 high=max(xs))
                         for s in STAGES
                         for xs in [[r[s] for r in mine]]}
        print(f"{root}: " + "; ".join(
            f"{s} {v['median']:.3f} s ({v['low']:.3f}-{v['high']:.3f})"
            for s, v in summary[root].items())
            + f" over {len(mine)} readings")
    print(f"tables of every root byte-equal: {same} "
          f"({len(written[0])} files); card: {card}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, rounds=args.rounds, readings=rows,
                       summary=summary, same_bytes=same), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
