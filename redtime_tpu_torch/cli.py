"""Command-line interface of the PyTorch port (the port of
redtime_tpu/cli.py).

`run`          — the redTime-binary equivalent: consume a
                 params_redTime.dat (plus its CAMB transfer files) and
                 write the output table (reference `src/redTime.cc` main()).
`batch`        — evolve many params files in one batched computation on
                 the card, chunked or (`--scheduler packed --lanes N`)
                 through the work queue: the replacement for the serial
                 `runRedTimeBatch` shell loop (reference
                 scripts/runRedTimeBatch:91-99).
`convert`      — emulator post-processing (convertPt): per-HACC-step k / P
                 files from the output tables (convert.convert_pt).
`convert-full` — merge PT + PM + HACC spectra (convertPkFull,
                 convert.convert_pk_full).

    redtime-tpu-torch batch params_*.dat -o out/          # on the card
    redtime-tpu-torch batch params_*.dat -o out/ --scheduler packed --lanes 16
    python -m redtime_tpu_torch.cli run --params p.dat --platform cpu
    redtime-tpu-torch convert --n-models 16 --step 499 \
        --models-file models.dat --red-dir out/

`run` and `batch` run on the card unless `--platform cpu` asks for the
CPU; with no card they exit non-zero.  `convert` and `convert-full` are
numpy on the host.  The JAX CLI's `--mode` and `--show-legs` (FFT and
Ozaki backends) and the segmented scheduler with its `--seg-breaks` have
no counterpart here; `--shard` waits for the multi-GPU batch split
(ROADMAP.md, queue 1 item 5).  scripts/run_redtime.py's two-pass CAMB
orchestration is `python -m redtime_tpu_torch.orchestrate`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np


def _device(args) -> str:
    """The run's device: the card unless --platform cpu; exits with the
    reason when there is no card."""
    from redtime_tpu_torch.fastpt import device_of

    dev = "cpu" if args.platform == "cpu" else "cuda"
    try:
        device_of(dev)
    except RuntimeError as err:
        raise SystemExit(f"redtime-tpu-torch: {err}") from None
    return dev


def _load(params_path: str, modern: bool):
    from redtime_tpu_torch.driver import settings_from_params
    from redtime_tpu_torch.io import read_params_file
    from redtime_tpu_torch.io.camb import load_from_params

    p = read_params_file(params_path)
    base = os.path.dirname(os.path.abspath(params_path))
    lin = load_from_params(p, base, modern)
    settings, cosmo = settings_from_params(p)
    return p, lin, settings, cosmo


def _coerce(field, text: str):
    """Parse a --set VALUE string into the type of the SolverConfig
    field's default (every field has a scalar default)."""
    proto = field.default
    if isinstance(proto, bool):
        low = text.lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        raise SystemExit(f"--set {field.name}: expected a boolean, "
                         f"got {text!r}")
    for typ in (int, float) if isinstance(proto, int) else (float,):
        if isinstance(proto, typ):
            try:
                return typ(text)
            except ValueError:
                raise SystemExit(f"--set {field.name}: expected "
                                 f"{typ.__name__}, got {text!r}")
    return text


def _config(args):
    """SolverConfig from the CLI tier flags: the preset, --nk, then each
    --set key=value over the port's SolverConfig fields."""
    from redtime_tpu_torch.config import SolverConfig

    make = {"default": SolverConfig,
            "high-accuracy": SolverConfig.high_accuracy,
            "v01-compat": SolverConfig.v01_compat}[args.preset]
    cfg = make(dtype=args.dtype)
    if args.nk is not None:
        cfg = dataclasses.replace(cfg, nk=args.nk)
    fields = {f.name: f for f in dataclasses.fields(SolverConfig)}
    for kv in getattr(args, "set_kv", None) or []:
        key, sep, val = kv.partition("=")
        if not sep:
            raise SystemExit(f"--set expects key=value, got {kv!r}")
        if key not in fields:
            raise SystemExit(
                f"--set: unknown SolverConfig field {key!r}; valid: "
                + ", ".join(sorted(fields)))
        cfg = dataclasses.replace(cfg, **{key: _coerce(fields[key], val)})
    return cfg


def cmd_run(args) -> int:
    from redtime_tpu_torch.driver import finite_report, run_pipeline
    from redtime_tpu_torch.io.writer import write_result
    from redtime_tpu_torch.profiling import sync

    dev = _device(args)
    cfg = _config(args)
    p, lin, settings, cosmo = _load(args.params, args.modern)

    t0 = time.time()
    res = run_pipeline(cfg, settings, cosmo, lin, device=dev)
    sync(res.table)
    dt = time.time() - t0

    if len(finite_report(res)):
        print(f"# {args.params}: solver produced non-finite output "
              "(diverged/poisoned state) — refusing to write",
              file=sys.stderr)
        return 1

    out = open(args.output, "w") if args.output else sys.stdout
    write_result(out, res, os.path.basename(args.params))
    if args.output:
        out.close()
        print(f"# wrote {args.output} in {dt:.1f}s", file=sys.stderr)
    return 0


def cmd_batch(args) -> int:
    import torch

    from redtime_tpu_torch.config import CosmoParams
    from redtime_tpu_torch.driver import (RunResult, finite_report, lane,
                                          run_batch)
    from redtime_tpu_torch.io.camb import LinearData
    from redtime_tpu_torch.io.writer import write_result_to_path
    from redtime_tpu_torch.profiling import StageTimer, device_trace, sync

    dev = _device(args)
    cfg = _config(args)
    timer = StageTimer(enabled=args.timing)

    def outname(path):
        name = os.path.splitext(os.path.basename(path))[0]
        # strip only the PREFIX: replace() would mangle interior matches
        # and collide distinct inputs onto one output path
        if name.startswith("params_"):
            name = name[len("params_"):]
        return os.path.join(args.output_dir, name + ".dat")

    params_files = list(args.params_files)
    if args.skip_existing:
        exists = {p: os.path.exists(outname(p)) for p in params_files}
        skipped = [p for p in params_files if exists[p]]
        params_files = [p for p in params_files if not exists[p]]
        if skipped:
            print(f"# skipping {len(skipped)} already-produced outputs",
                  file=sys.stderr)
        if not params_files:
            return 0

    with timer.stage("load-inputs"):
        loaded = [_load(path, args.modern) for path in params_files]
    settings = loaded[0][2]
    for path, (_, _, s, _) in zip(params_files, loaded):
        if s != settings:
            raise SystemExit(
                f"{path}: run settings differ from {params_files[0]}; "
                "a batch must share switches/redshifts (the reference's "
                "batch loop shares them too)")
    # a batch needs identical input shapes; mixed designs (massless +
    # massive nu, or different transfer row counts) would otherwise die
    # in the stack with no file named
    ref_shapes = [np.shape(x) for x in loaded[0][1]]
    for path, (_, lin, _, _) in zip(params_files[1:], loaded[1:]):
        if [np.shape(x) for x in lin] != ref_shapes:
            raise SystemExit(
                f"{path}: linear-input shapes differ from "
                f"{params_files[0]} (e.g. massless vs massive-neutrino "
                "models, or transfer files of different lengths); run "
                "such designs as separate batches")
    # stack on the host: run_batch cuts its chunks there
    cosmos = CosmoParams(*[np.stack([np.asarray(c[i]) for *_, c in loaded])
                           for i in range(len(CosmoParams._fields))])
    lins = LinearData(*[np.stack([lin[i] for _, lin, _, _ in loaded])
                        for i in range(len(LinearData._fields))])

    t0 = time.time()
    with device_trace(args.trace_dir):
        with timer.stage("solve-batch"):
            # per-chunk stages (and a sync after each chunk) only when
            # they are reported
            res = run_batch(cfg, settings, cosmos, lins, device=dev,
                            max_chunk=args.chunk,
                            timer=timer if args.timing else None,
                            scheduler=args.scheduler, n_lanes=args.lanes)
            sync(res.table)
    dt = time.time() - t0

    # per-model failure detection: a diverged/NaN cosmology poisons only
    # its own lane (the reference batch loop dies on first failure,
    # runRedTimeBatch:2; here the rest of the design survives)
    bad_idx = set(int(i) for i in finite_report(res))
    bad = [params_files[i] for i in sorted(bad_idx)]

    os.makedirs(args.output_dir, exist_ok=True)
    with timer.stage("write-outputs"):
        # one copy of the whole batch to the host
        res = RunResult(*[x.cpu() for x in res])
        for i, path in enumerate(params_files):
            if i in bad_idx:
                continue
            write_result_to_path(outname(path), lane(res, i),
                                 os.path.basename(path))
    n = len(params_files)
    print(f"# {n} cosmologies in {dt:.1f}s "
          f"({n / dt * 60:.1f} cosmologies/min) on "
          f"{torch.cuda.get_device_name() if dev == 'cuda' else 'cpu'}",
          file=sys.stderr)
    if args.timing:
        print(timer.report(), file=sys.stderr)
    if bad:
        print(f"# WARNING: {len(bad)} model(s) produced non-finite "
              f"output and were not written: {bad}", file=sys.stderr)
        return 1
    return 0


def cmd_convert(args) -> int:
    from redtime_tpu_torch.convert import convert_pt

    convert_pt(args.n_models, args.step, args.nk, args.models_file,
               args.red_dir)
    return 0


def cmd_convert_full(args) -> int:
    from redtime_tpu_torch.convert import convert_pk_full

    convert_pk_full(args.design, args.step, args.output_dir,
                    args.pt_template, args.pm_template, args.hacc_template,
                    models=args.models, nk_pt=args.nk, n_pm=args.n_pm)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="redtime-tpu-torch",
        description="Time-RG nonlinear power spectrum solver (PyTorch, "
                    "CUDA)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--platform", default=None, choices=[None, "cpu"],
                        help="run on the CPU (default: the CUDA card)")
    common.add_argument("--modern", action="store_true",
                        help="13-column (pip CAMB) transfer files")
    common.add_argument("--dtype", default="float64",
                        choices=["float64", "float32"],
                        help="solver stepping dtype (the port runs float64 "
                        "only: float32 raises)")
    common.add_argument("--preset", default="default",
                        choices=["default", "high-accuracy", "v01-compat"],
                        help="solver configuration tier: the reference's "
                        "default build, the HIGH_ACCURACY ifdef "
                        "(nk=512, tol 1e-15/1e-6), or the v0.1 README "
                        "settings")
    common.add_argument("--nk", type=int, default=None,
                        help="override the solver k-grid size "
                        "(reference compile-time nk, redTime.cc:90-94)")
    common.add_argument("--set", action="append", dest="set_kv",
                        metavar="KEY=VALUE", default=[],
                        help="override any SolverConfig field by name "
                        "(repeatable), e.g. --set eabs_P=1e-9 "
                        "--set np_factor=8")

    r = sub.add_parser("run", parents=[common],
                       help="solve one params_redTime.dat")
    r.add_argument("--params", required=True)
    r.add_argument("--output", "-o", default=None,
                   help="output file (default stdout)")
    r.set_defaults(fn=cmd_run)

    b = sub.add_parser("batch", parents=[common],
                       help="solve many params files in one batched run")
    b.add_argument("params_files", nargs="+")
    b.add_argument("--output-dir", "-o", default=".")
    b.add_argument("--skip-existing", action="store_true",
                   help="skip models whose output file already exists")
    b.add_argument("--timing", action="store_true",
                   help="print per-stage wall-clock")
    b.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace here")
    b.add_argument("--scheduler", default="auto",
                   choices=["auto", "chunked", "packed"],
                   help="batch scheduler: 'chunked' (the default) prepares "
                   "the chunks on the host and solves them on the card; "
                   "'packed' prepares every model at once and lets --lanes "
                   "lanes pull models off a work queue as they finish")
    b.add_argument("--chunk", type=int, default=None,
                   help="chunk size (default: 16 full-TRG / 32 one-loop "
                   "on the card, the whole batch on the CPU)")
    b.add_argument("--lanes", type=int, default=None,
                   help="packed-scheduler lane count (default 8)")
    b.set_defaults(fn=cmd_batch)

    cv = sub.add_parser("convert",
                        help="emulator post-processing (convertPt)")
    cv.add_argument("--n-models", type=int, required=True)
    cv.add_argument("--step", type=int, required=True,
                    help="HACC analysis step (163..499)")
    cv.add_argument("--nk", type=int, default=128)
    cv.add_argument("--models-file", required=True)
    cv.add_argument("--red-dir", required=True)
    cv.set_defaults(fn=cmd_convert)

    cf = sub.add_parser(
        "convert-full",
        help="merge PT + PM + HACC spectra (convertPkFull equivalent; "
             "path templates take {model}/{step}/{pm})")
    cf.add_argument("--design", required=True, help="design/models file")
    cf.add_argument("--step", type=int, required=True)
    cf.add_argument("--output-dir", "-o", required=True)
    cf.add_argument("--pt-template", required=True,
                    help="e.g. runs/redTime_M{model:03d}.dat")
    cf.add_argument("--pm-template", required=True,
                    help="e.g. runs/M{model:03d}/PM{pm:03d}/m.pk.{step}")
    cf.add_argument("--hacc-template", required=True)
    cf.add_argument("--models", type=int, nargs="*", default=None)
    cf.add_argument("--nk", type=int, default=128)
    cf.add_argument("--n-pm", type=int, default=16)
    cf.set_defaults(fn=cmd_convert_full)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
