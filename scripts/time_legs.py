"""Device times of K1 out_leg and K2 pz_leg at the main path's shapes, in
two or more checkouts of the repo on one CUDA card, in turns.

    python3 scripts/time_legs.py [--rounds N] [--out PATH] ROOT [ROOT ...]

For each round, each ROOT in turn: a fresh python imports that checkout's
redtime_tpu_torch, builds its kernels and times K1 and K2 at nk=128,
np=512, 16 lanes (SolverConfig() defaults, the shapes chip_smoke.py times
them at) on inputs from the same seeded numpy generator, with this
checkout's chip_smoke.graph_ms (20 calls in a CUDA graph, replayed 5
times), five readings each, alternating, and gives the sha256 of each
one's output, so that the checkouts' bits can be compared.  Prints one JSON line per
(round, root) and writes them all, with the card's name and power limit,
to PATH (default chiprun_out/time_legs.json).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READINGS = 5


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "time_legs_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_one(root: str) -> dict:
    """K1 and K2 device ms in the checkout at root (this process)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from redtime_tpu_torch import fastpt
    from redtime_tpu_torch.config import SolverConfig
    from redtime_tpu_torch.kernels import build
    from redtime_tpu_torch.kernels import out_leg as k1
    from redtime_tpu_torch.kernels import pz_leg as k2

    smoke = _smoke()
    build.build()
    dev = torch.device("cuda")
    cfg = SolverConfig()
    ec = fastpt.engine_consts(cfg, dev)
    rng = np.random.default_rng(1234)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    B, nk = smoke.B_CHECK, cfg.nk
    tab = t(rng.standard_normal((B, 2, fastpt.NFAM, 3, 2 * cfg.npts)))
    g_lnk = np.log(np.logspace(np.log10(cfg.kmin), np.log10(cfg.kmax), nk))
    lnP = (8.0 - 1.5 * (g_lnk + 2.0) ** 2 / 4.0)[None, None, :] \
        + 0.05 * rng.standard_normal((B, 3, nk))
    P_e = fastpt.extend_power(cfg, t(lnP), t(np.full(B, 0.96)), ec)
    fns = dict(out_leg=lambda: k1.out_leg(tab, ec.G),
               pz_leg=lambda: k2.pz_leg(ec.toeplitz_sl, P_e, ec.pz_kfac_sl,
                                        cfg.nshift))
    sha = {name: hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()
           for name, fn in fns.items()}
    out = {name: [] for name in fns}
    for _ in range(READINGS):
        for name, fn in fns.items():
            out[name].append(smoke.graph_ms(fn))
    return dict(root=root, device_ms=out, sha256=sha,
                median_ms={k: float(np.median(v)) for k, v in out.items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_one(args.one)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_legs: no CUDA device", file=sys.stderr)
        return 2
    out = dict(card=_smoke().card_line(), runs=[])
    print(out["card"])
    for rnd in range(args.rounds):
        for root in args.roots:
            p = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--one", root], capture_output=True,
                               text=True, timeout=600)
            if p.returncode:
                print(p.stderr[-4000:], file=sys.stderr)
                return 1
            row = dict(json.loads(p.stdout.strip().splitlines()[-1]),
                       round=rnd)
            out["runs"].append(row)
            print(json.dumps(row))
    path = args.out or os.path.join(ROOT, "chiprun_out", "time_legs.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
