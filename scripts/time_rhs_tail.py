"""Device times of K8 rhs_tail at every (nk, lanes, mode) the paths run it
at, in one or more checkouts of the repo on one CUDA card, in turns; and
with one part of the kernel taken out at a time.

    python3 scripts/time_rhs_tail.py [--rounds N] [--drops] [ROOT ...]

from the root of a checkout, on a machine with a CUDA card.  This
checkout makes the inputs once: design models prepared on the host,
states from a seeded generator and trg.rhs_prologue (as chip_smoke.py's
K8 phase makes them), at chip_smoke.RT_TIMED (full TRG at nk = 128 and
16, 64, 8 lanes and at nk = 48, 2 lanes; 1-loop at nk = 128, 32 lanes and
at the presets' nk = 512 and 256, 2 lanes), and saves them.  Then for each
round, each ROOT in turn (in reverse order on odd rounds: A B B A), a
fresh python imports that checkout's redtime_tpu_torch, builds its
kernels and times its rhs_tail on the saved inputs with this checkout's
chip_smoke.graph_ms (20 calls in a CUDA graph, replayed 5 times), five
readings a case.  ROOT defaults to this checkout.

With --drops, this checkout's kernel is also built seven more times with
one part taken out (csrc/rhs_tail.cu RT_DROP: 1 the row loads, 2 the dI
/ dQ outputs, 4 dlnP, 8 the scalars; 16 every task running item 0, one
item's code on the whole card; 32 every task storing one row of zeros
and nothing else; 64 the lookups' prologue: no bracketing, pow, exp or
log, the table rows of fixed nodes) and timed on the same inputs in the
same turns; what a part costs is the whole kernel's time less the
variant's.  A ROOT whose K8 predates the lookups (its OmegaIn holds beta)
is fed the lookups' values, computed here by the plain version.  Prints the card, each reading's medians as JSON lines and a table with
the bound and the launch floor; writes everything to
chiprun_out/time_rhs_tail.json.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READINGS = 5
# builds beside the package's, each with one part taken out: name -> RT_DROP
DROPS = {"without the row loads": 1, "without dI/dQ": 2, "without dlnP": 4,
         "without the scalars": 8, "item 0 everywhere": 16,
         "zeros alone": 32, "without the lookups' prologue": 64}


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "time_rhs_tail_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs(path: str) -> list:
    """Save the inputs of every RT_TIMED case to `path` (torch.save of
    plain tensors); returns each case's bound (chip_smoke.rt_cost)."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from redtime_tpu_torch import driver, fastpt, trg
    from redtime_tpu_torch import model as mdl
    from redtime_tpu_torch.config import RunSettings
    from redtime_tpu_torch.kernels import rhs_tail as rt

    smoke = _smoke()
    dev = torch.device("cuda")
    rng = np.random.default_rng(3579)
    cs, lins = smoke.design_inputs(2)
    chunk = ([x.numpy() for x in cs], list(lins), None)
    cases, bounds = [], []
    for nk in sorted({nk for nk, _, _ in smoke.RT_TIMED}):
        cfg = smoke.rt_config(nk)
        m2 = driver._prepare(cfg, chunk, dev, True)
        ec = fastpt.engine_consts(cfg, dev)
        for nk_, B, mode in smoke.RT_TIMED:
            if nk_ != nk:
                continue
            m = mdl.take_lanes(m2, torch.arange(B, device=dev) % 2)
            settings = RunSettings(z_out=smoke.Z_OUT_1L,
                                   **smoke.RT_MODES[mode])
            cache = (trg.build_oneloop_cache(cfg, settings, m, ec)
                     if settings.one_loop else None)
            eta, y = smoke.rt_state(rng, cfg, settings, m, B)
            args = trg.rhs_prologue(cfg, settings, m, ec, cache)(eta, y)
            y, eta, k, om, src, evolve_q = args
            # the lookups as a checkout whose K8 takes them ready made
            # (before its prologue moved into the kernel) is fed them
            at, growth = rt.prologue_plain(eta, om, src)
            cases.append(dict(
                key=f"{mode} nk={nk} B={B}", y=y, eta=eta, k=k,
                om=list(om[:4]) + [list(om.consts), om.a_in],
                src=None if src is None else list(src),
                looked_up=dict(om=list(at), growth=growth),
                full=mode == "full", evolve_q=evolve_q))
            bounds.append(dict(key=cases[-1]["key"], **smoke.rt_cost(args)))
    torch.save(cases, path)
    return bounds


def time_one(root: str, inputs: str, builds: list) -> dict:
    """Device ms of the rhs_tail of the checkout at root (this process)
    on every saved case, and of this checkout's `builds` (names of DROPS)
    too."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from redtime_tpu_torch.kernels import build
    from redtime_tpu_torch.kernels import rhs_tail as rt

    smoke = _smoke()
    build.build()
    log = build.BUILD_LOG.get("output", "")
    libs = {}
    if builds:
        import ctypes
        from concurrent.futures import ThreadPoolExecutor

        def one(name):
            return build.build(defines=(f"RT_DROP={DROPS[name]}",),
                               only=("rhs_tail.cu",))

        with ThreadPoolExecutor(4) as pool:
            paths = dict(zip(builds, pool.map(one, builds)))
        libs = {name: build.bind_rhs_tail(ctypes.CDLL(str(p)))
                for name, p in paths.items()}
    out = {}
    for case in torch.load(inputs, weights_only=False):
        args = _args(rt, case)
        fns = {"whole": lambda: rt.rhs_tail(*args)}
        for name, lib in libs.items():
            dy = torch.empty_like(case["y"])
            fns[name] = (
                lambda lib=lib, dy=dy: rt.launch(lib, dy, *args))
        runs = {k: [] for k in fns}
        for _ in range(READINGS):
            for k, fn in fns.items():
                runs[k].append(smoke.graph_ms(fn))
        out[case["key"]] = dict(
            runs=runs, median_ms={k: float(np.median(v))
                                  for k, v in runs.items()})
    return dict(root=root, cases=out,
                ptxas={v: smoke.ptxas_of(log, f"rhs_tail_kernelILi{i}E")
                       for i, v in enumerate(getattr(rt, "VARIANTS", ()))})


def _args(rt, case: dict) -> tuple:
    """rhs_tail's arguments of a saved case in the interface of the
    checkout's K8 (rt): the model's tables, or, where its OmegaIn still
    holds beta (K8 before the lookups moved into it), the lookups' values
    saved beside them."""
    src = case["src"]
    if "beta" not in rt.OmegaIn._fields:
        from redtime_tpu_torch import background as bg
        om = rt.OmegaIn(*case["om"][:4], bg.OmegaConsts(*case["om"][4]),
                        case["om"][5])
        if src is not None:
            src = (rt.FullSrc if case["full"] else rt.OneLoopSrc)(*src)
    else:
        om = rt.OmegaIn(*case["looked_up"]["om"])
        if src is not None and case["full"]:
            src = rt.FullSrc(*src)
        elif src is not None:
            D, dDda, z = case["looked_up"]["growth"]
            src = rt.OneLoopSrc(src[0], src[1], D, dDda, src[6], z)
    return (case["y"], case["eta"], case["k"], om, src, case["evolve_q"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--drops", action="store_true")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    ap.add_argument("--builds", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_one(args.one, args.inputs,
                                  json.loads(args.builds or "[]"))))
        return 0
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_rhs_tail: no CUDA device", file=sys.stderr)
        return 2
    roots = [os.path.abspath(r) for r in args.roots] or [HERE]
    smoke = _smoke()
    outdir = os.path.join(HERE, "chiprun_out")
    os.makedirs(outdir, exist_ok=True)
    inputs = os.path.join(outdir, "time_rhs_tail_inputs.pt")
    bounds = make_inputs(inputs)
    out = dict(card=smoke.card_line(), roots=roots, bounds=bounds, runs=[])
    print(out["card"])
    for rnd in range(args.rounds):
        for root in roots[::-1] if rnd % 2 else roots:
            cmd = [sys.executable, os.path.abspath(__file__), "--one", root,
                   "--inputs", inputs]
            if args.drops and root == HERE:
                cmd += ["--builds", json.dumps(list(DROPS))]
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=1200)
            if p.returncode:
                print(p.stderr[-4000:], file=sys.stderr)
                return 1
            row = dict(json.loads(p.stdout.strip().splitlines()[-1]),
                       round=rnd)
            out["runs"].append(row)
            print(json.dumps(dict(root=root, round=rnd, median_ms={
                k: c["median_ms"] for k, c in row["cases"].items()})))
    sys.path.insert(0, HERE)
    from redtime_tpu_torch.kernels import build
    stream = torch.cuda.current_stream
    out["launch_floor_ms"] = smoke.graph_ms(lambda: build.check(
        build.lib().rt_launch_floor(stream().cuda_stream), "launch_floor"))
    os.remove(inputs)
    print(f"K8 device ms, medians over rounds of each reading's median; "
          f"launch floor {out['launch_floor_ms']:.5f} ms; {out['card']}")
    for b in bounds:
        cells = []
        for root in roots:
            meds = [r["cases"][b["key"]]["median_ms"] for r in out["runs"]
                    if r["root"] == root]
            for part in meds[0]:
                cells.append(f"{os.path.basename(root)} {part} "
                             f"{np.median([m[part] for m in meds]):.5f}")
        print(f"  {b['key']}: bound {b['bound_ms']:.5f} by {b['bound_by']}; "
              + "; ".join(cells))
    with open(os.path.join(outdir, "time_rhs_tail.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
