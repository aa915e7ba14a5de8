"""Device times of K11 out_block at chip_smoke.OB_TIMED (full TRG, 16 lanes x
8 redshifts; 1-loop with print_bias, 32 x 7) in one or more checkouts of
the repo on one CUDA card, in turns; and with one part of the kernel taken
out at a time.

    python3 scripts/time_out_block.py [--rounds N] [--drops]
        [--plans JSON] [--cases NAME,...] [ROOT ...]

from the root of a checkout, on a machine with a CUDA card.  --cases
names other chip_smoke.OB_CASES to time.  This
checkout makes the inputs once, as chip_smoke.py's check_out_block makes
them (design models prepared on the host, states from a seeded
generator, the engine over the B S lanes where the layout needs it), and
saves them.  Then for each round, each ROOT in turn (in reverse order on
odd rounds: A B B A), a fresh python imports that checkout's
redtime_tpu_torch, builds its kernels and times its out_block on the
saved inputs with this checkout's chip_smoke.graph_ms (20 calls in a CUDA
graph, replayed 5 times), five readings a case, and hashes the outputs
(table, sigma_v2, H): the roots' bits are compared.  ROOT defaults to
this checkout.

With --drops, every ROOT's kernel is also built once more for each part
that its source can take out, and timed in the same turns; what a part
costs is the whole kernel's time less the variant's:
  no table stores     OB_DROP=1: the table is computed into the staging
                      tile but not written;
  lookups fixed       LOOKUP_FIXED=1 (csrc/lookups.cuh): no nodes read,
                      no bracketing, fixed weights;
  no traced programs  OB_DROP=4: the A, P_T / P_MR and P_B programs'
                      outputs are k.
A kernel whose source has no OB_DROP times the lookups' variant only.
--plans '[{"case": "full_trg", "cluster": 4, "chunks": 1, ...}, ...]'
times this checkout's kernel under other launch plans too (each dict
overrides out_block.launch_plan's keys, for the case it names or for
every case), with their bits checked against the default plan's.
Prints the card, each reading's medians as JSON lines and a table with the
bounds (chip_smoke.ob_cost) and the launch floor; writes everything to
chiprun_out/time_out_block.json.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READINGS = 5
# each --drops variant's define, and the macro its source must have
DROPS = {"no table stores": ("OB_DROP=1", "OB_DROP"),
         "lookups fixed": ("LOOKUP_FIXED=1", "LOOKUP_FIXED"),
         "no traced programs": ("OB_DROP=4", "OB_DROP")}


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "time_out_block_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs(path: str, names) -> list:
    """Save the inputs of the OB_CASES `names` to `path` (torch.save of
    plain tensors and tuples); returns each case's bound
    (chip_smoke.ob_cost)."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from redtime_tpu_torch import fastpt
    from redtime_tpu_torch import model as mdl
    from redtime_tpu_torch.config import RunSettings

    smoke = _smoke()
    dev = torch.device("cuda")
    rng = np.random.default_rng(8642)
    models = smoke.ob_models()
    cases, bounds = [], []
    for name, kw, skw, B, zname in smoke.OB_CASES:
        if name not in names:
            continue
        cfg = smoke.ob_config(kw)
        m = mdl.take_lanes(models[(cfg.nk, cfg.kmin)],
                           torch.arange(B, device=dev) % 2)
        settings = RunSettings(z_out=smoke.ob_z(zname), **skw)
        ec = fastpt.engine_consts(cfg, dev)
        ys = smoke.ob_states(rng, cfg, settings, m, len(settings.z_out))
        if name == "full_trg":
            ys[-1, 0] = float("nan")     # a poisoned lane, as chip_smoke's
        args = smoke.ob_args(cfg, settings, m, ys, ec)
        lay, ys, k, m, zs, a_in, src, sv = args
        cases.append(dict(
            key=f"{name} B={B} n_z={len(zs)}", lay=tuple(lay), ys=ys, k=k,
            cosmo=m.cosmo._asdict(),
            model={f: getattr(m, f) for f in m._fields if f != "cosmo"},
            zs=zs, a_in=a_in, src=None if src is None else tuple(src),
            sv=sv))
        bounds.append(dict(key=cases[-1]["key"], **smoke.ob_cost(args)))
    torch.save(cases, path)
    return bounds


def _args(ob, mdl, config, case: dict) -> tuple:
    """out_block's arguments of a saved case in the checkout's types."""
    m = mdl.Model(config.CosmoParams(**case["cosmo"]), **case["model"])
    return (ob.Layout(*case["lay"]), case["ys"], case["k"], m, case["zs"],
            case["a_in"], case["src"], case["sv"])


def _variant(build, name: str):
    """The library of the checkout's kernel with `name` (of DROPS) taken
    out, built beside the package's; None where its sources lack the
    variant's macro."""
    import ctypes

    define, macro = DROPS[name]
    src = (build.CSRC / "out_block.cu").read_text() \
        + (build.CSRC / "lookups.cuh").read_text()
    if macro not in src:
        return None
    path = build.build((define,), ("out_block.cu",))
    return build.bind_out_block(ctypes.CDLL(str(path)))


def _digest(outs) -> str:
    h = hashlib.sha256()
    for x in outs:
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_one(root: str, inputs: str, drops: bool, plans: list) -> dict:
    """Device ms of the out_block of the checkout at root (this process)
    on every saved case, and of its DROPS variants and `plans`."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from redtime_tpu_torch import config
    from redtime_tpu_torch import model as mdl
    from redtime_tpu_torch.kernels import build
    from redtime_tpu_torch.kernels import out_block as ob

    smoke = _smoke()
    build.build()
    log = build.BUILD_LOG.get("output", "")
    if "out_block_kernel" not in log:
        # built by another process: compile the kernel's source alone
        # (a define that changes nothing) for its ptxas line
        build.build(("OB_PTXAS_LOG=1",), ("out_block.cu",))
        log = build.BUILD_LOG.get("output", "")
    libs = {name: _variant(build, name) for name in DROPS} if drops \
        else {}
    libs = {name: lib for name, lib in libs.items() if lib is not None}
    out = {}
    for case in torch.load(inputs, weights_only=False):
        args = _args(ob, mdl, config, case)
        lay, ys = args[0], args[1]
        B, S, _, nk = ys.shape
        outs = ob.out_block(*args)
        torch.cuda.synchronize()
        fns = {"whole": lambda: ob.out_block(*args)}
        digests = {"whole": _digest(outs)}

        def launcher(lib, plan=None):
            bufs = [torch.empty_like(x) for x in outs]

            def fn():
                ob.launch(lib, *args, *bufs, 0, S,
                          **({} if plan is None else dict(plan=plan)))
            return fn, bufs

        for name, lib in libs.items():
            fns[name] = launcher(lib)[0]
        base = case["key"].split()[0]
        for i, over in enumerate(plans):
            if over.get("case", base) != base:
                continue
            plan = dict(ob.launch_plan(nk, B, S, ob.n_columns(lay)),
                        **{k: v for k, v in over.items() if k != "case"})
            tag = "plan " + json.dumps({k: v for k, v in over.items()
                                        if k != "case"})
            fn, bufs = launcher(build.lib(), plan)
            fn()
            torch.cuda.synchronize()
            fns[tag] = fn
            digests[tag] = _digest(bufs)
        runs = {k: [] for k in fns}
        for _ in range(READINGS):
            for k, fn in fns.items():
                runs[k].append(smoke.graph_ms(fn))
        out[case["key"]] = dict(
            runs=runs, digests=digests,
            median_ms={k: float(np.median(v)) for k, v in runs.items()})
    return dict(root=root, cases=out,
                ptxas=smoke.ptxas_of(log, "out_block_kernel"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--drops", action="store_true")
    ap.add_argument("--plans", default="[]")
    ap.add_argument("--cases", default="")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        here = args.one == HERE
        plans = json.loads(args.plans) if here else []
        print(json.dumps(time_one(args.one, args.inputs, args.drops, plans)))
        return 0
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_out_block: no CUDA device", file=sys.stderr)
        return 2
    roots = [os.path.abspath(r) for r in args.roots] or [HERE]
    smoke = _smoke()
    outdir = os.path.join(HERE, "chiprun_out")
    os.makedirs(outdir, exist_ok=True)
    # the inputs (~70 MB) go under build/, beside the builds, not with
    # the results
    inputs = os.path.join(HERE, "build", "time_out_block_inputs.pt")
    os.makedirs(os.path.dirname(inputs), exist_ok=True)
    bounds = make_inputs(inputs, args.cases.split(",") if args.cases
                         else smoke.OB_TIMED)
    out = dict(card=smoke.card_line(), roots=roots, bounds=bounds, runs=[])
    print(out["card"])
    for rnd in range(args.rounds):
        for root in roots[::-1] if rnd % 2 else roots:
            cmd = [sys.executable, os.path.abspath(__file__), "--one", root,
                   "--inputs", inputs, "--plans", args.plans]
            cmd += ["--drops"] * args.drops
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=1500)
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
    print(f"K11 device ms, medians over rounds of each reading's median; "
          f"launch floor {out['launch_floor_ms']:.5f} ms; {out['card']}")
    first = out["runs"][0]["cases"]
    same = {}
    for b in bounds:
        key = b["key"]
        cells = []
        for root in roots:
            rows = [r for r in out["runs"] if r["root"] == root]
            meds = [r["cases"][key]["median_ms"] for r in rows]
            for part in meds[0]:
                cells.append(f"{os.path.basename(root)} {part} "
                             f"{np.median([m[part] for m in meds]):.5f}")
            digs = rows[0]["cases"][key]["digests"]
            same[f"{key} {root}"] = all(
                d == first[key]["digests"]["whole"] for d in digs.values())
        print(f"  {key}: bound {b['bound_ms']:.5f} by {b['bound_by']}; "
              + "; ".join(cells))
    for r in out["runs"][:len(roots)]:
        print(f"  ptxas {os.path.basename(r['root'])}: {r['ptxas']}")
    out["bits_equal_to_first_root"] = same
    print("outputs bit-equal to the first root's (and every plan to its "
          f"default): {same}")
    with open(os.path.join(outdir, "time_out_block.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
