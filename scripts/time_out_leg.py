"""Device times of K1 out_leg in each of its schedules, at the shapes the
port runs it at, on one CUDA card.

    python3 scripts/time_out_leg.py [--sweep] [--rounds N] [--out PATH]

For each shape (B, nfam, 2np, O) of SHAPES (with --sweep, of SWEEP: the
lanes on both sides of the wide schedules' threshold on each grid), on
inputs from a seeded numpy generator (G padded as engine_consts pads it):
every schedule the kernel
is built with (out_leg.SCHEDULES) is checked against out_leg_plain within
the dot product's forward-error bound and for the same bits over two
calls, then timed, the schedules in turns, `--rounds` times
(chip_smoke.graph_ms: 20 calls in a CUDA graph, replayed 5 times).  Each
line gives the schedule `out_leg.schedule` picks, the device ms of every
schedule (medians) and their share of the launch's least time
(rtbench.costs.out_leg_cost).  Prints one JSON line per shape and writes
them, with the card's name and power limit and the kernels' `-Xptxas -v`
lines, to PATH (default chiprun_out/time_out_leg.json).  Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (B, nfam, 2np, O): the solve cells (512 lanes at nk=128, 64 at nk=512),
# the main path's 16-lane chunk, the presets' 2 lanes, a ragged shape
SHAPES = ((16, 14, 1024, 129), (512, 14, 1024, 129), (64, 14, 4096, 513),
          (33, 14, 4096, 513), (48, 14, 4096, 513), (192, 14, 1024, 129),
          (256, 14, 1024, 129), (256, 7, 1024, 129), (100, 14, 2048, 257),
          (2, 14, 4096, 513))
# the default, v0.1 and HIGH_ACCURACY grids (2np, O), full TRG's 14 and
# 1-loop's 7 families, over the lanes of the paths' chunks and finalize
SWEEP = tuple((B, nfam, K, O) for K, O in ((1024, 129), (4096, 257),
                                            (4096, 513))
              for nfam in (14, 7) for B in (8, 16, 24, 32, 48, 64, 96, 128))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "time_out_leg_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_lines(log: str) -> list:
    """The `-Xptxas -v` registers and spills of every out_leg_kernel
    instantiation in the build log."""
    out = []
    for block in log.split("ptxas info    : Compiling entry function")[1:]:
        head = block.split("\n", 1)[0]
        if "out_leg_kernel" in head:
            lines = [ln.replace("ptxas info    :", "").strip()
                     for ln in block.splitlines()[1:4]
                     if "registers" in ln or "spill" in ln]
            out.append(head.strip() + ": " + "; ".join(lines))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()
    import numpy as np
    import torch

    from redtime_tpu_torch.kernels import build
    from redtime_tpu_torch.kernels import out_leg as k1
    from rtbench.costs import out_leg_cost

    if not torch.cuda.is_available():
        print("time_out_leg: no CUDA device", file=sys.stderr)
        return 2
    smoke = _smoke()
    build.lib()
    out = dict(card=smoke.card_line(), ptxas=ptxas_lines(
        build.BUILD_LOG.get("output", "")), shapes=[])
    print(out["card"])
    print("\n".join(out["ptxas"]))
    n_sm = build.sm_count(0)
    rng = np.random.default_rng(2024)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64, device="cuda")
    eps = float(np.finfo(np.float64).eps)
    for B, nfam, K, O in SWEEP if args.sweep else SHAPES:
        tab = t(rng.standard_normal((B, 2, nfam, 3, K)))
        G = k1.padded(t(rng.standard_normal((nfam, K, O))))
        J_ref = k1.out_leg_plain(tab, G)
        prod = tab[:, 0, :, :, None, :] * tab[:, 1, :, None, :, :] / K
        bound = 2 * K * eps * torch.matmul(
            prod.abs().reshape(B, nfam, 9, K), G.abs()).reshape(J_ref.shape)
        del prod
        worst = {}
        for sched in k1.SCHEDULES:
            J = k1._launch(tab, G, sched)
            ratio = float(((J - J_ref).abs() / bound).max())
            if not ratio <= 1.0 or not torch.equal(J, k1._launch(tab, G,
                                                                 sched)):
                print(f"out_leg {sched} at {(B, nfam, K, O)}: |delta|/bound "
                      f"{ratio:.3g} or two calls differ", file=sys.stderr)
                return 1
            worst[k1.NAMES[sched]] = ratio
        del J_ref, bound
        runs = {k1.NAMES[s]: [] for s in k1.SCHEDULES}
        for _ in range(args.rounds):
            for sched in k1.SCHEDULES:
                runs[k1.NAMES[sched]].append(smoke.graph_ms(
                    lambda: k1._launch(tab, G, sched)))
        cost = out_leg_cost(B, nfam, K, O)
        med = {s: float(np.median(v)) for s, v in runs.items()}
        row = dict(shape=[B, nfam, K, O],
                   picked=k1.NAMES[k1.schedule(B, nfam, O, n_sm)],
                   bound_ms=cost["bound_ms"], bound_by=cost["bound_by"],
                   device_ms=med,
                   share={s: cost["bound_ms"] / v for s, v in med.items()},
                   err_over_bound=worst, readings=runs)
        out["shapes"].append(row)
        print(json.dumps({k: row[k] for k in ("shape", "picked", "bound_ms",
                                              "device_ms", "share")}))
        del tab, G
        torch.cuda.empty_cache()
    path = args.out or os.path.join(
        ROOT, "chiprun_out",
        "time_out_leg_sweep.json" if args.sweep else "time_out_leg.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
