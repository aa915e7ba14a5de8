"""One run of one benchmark cell: set-up, the measured window (or, with
--trace 1, the traced calls), the check of the outputs against the plain
reference, and the result line.

Everything a cell needs is found by name: the cell in BENCHMARK.json
names its configuration (rtbench/configs/<config>.json: the SolverConfig
fields, the RunSettings, source, reduced, assumed) and its traffic
(rtbench/traffic/<traffic>.json: the entry and its sizes); the entry is
rtbench/entries/<entry>.py; each metric is rtbench/metrics/<name>.py
(`read(rec)`, None where it finds nothing to read); the limits of the
check are rtbench/limits/<cell>.json.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "redtime_tpu")


class Refused(RuntimeError):
    """A run that cannot give a result (no card, a forbidden import)."""


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """rtbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"rtbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_of(manifest: dict, workload: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(manifest: dict, workload: str, trace: bool) -> list:
    """The metrics a run of the cell reports: its end-to-end ones, or with
    trace its per-layer ones (those without a workloads list, and those
    whose list names the cell)."""
    entries = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in entries
            if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    """Top-level names in sys.modules, before the first dot and whole,
    that are JAX or the JAX package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line(device_index: int = 0) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(device_index),
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def context(manifest: dict, workload: str, seed: int, device: str,
            overrides: dict | None = None) -> types.SimpleNamespace:
    """What an entry is built from: the cell, its configuration and
    traffic files, the program's SolverConfig and RunSettings."""
    from redtime_tpu_torch.config import RunSettings, SolverConfig

    cell = cell_of(manifest, workload)
    config = load_json(HERE, "configs", cell["config"] + ".json")
    traffic = load_json(HERE, "traffic", cell["traffic"] + ".json")
    over = overrides or {}
    solver = dict(config["solver"], **over.get("solver", {}))
    settings = dict(config["settings"], **over.get("settings", {}))
    traffic = dict(traffic, **over.get("traffic", {}))
    settings["z_out"] = tuple(settings["z_out"])
    return types.SimpleNamespace(
        cell=cell, config=config, traffic=traffic, solver=solver,
        settings_d=settings, cfg=SolverConfig(**solver),
        settings=RunSettings(**settings), seed=seed, device=device)


def window(entry, seconds: float) -> dict:
    """Whole calls until `seconds` have passed: calls, cosmologies,
    failed lanes and the seconds they took.  Python's cyclic garbage
    collector waits until the window has closed."""
    calls = done = failed = 0
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        while True:
            n, bad = entry.call()
            calls += 1
            done += n
            failed += bad
            dt = time.perf_counter() - t0
            if dt >= seconds:
                return dict(seconds=dt, calls=calls, cosmologies=done,
                            failed=failed)
    finally:
        gc.enable()


def traced_calls(entry, n_calls: int) -> dict:
    """n_calls calls under the profiler, device activity alone: the
    trace's reduction and the launch counters over them; then n_calls more
    with the host's activity traced too, whose gaps name what the host was
    doing (the host's tracing slows it, so the first pass gives every
    number)."""
    from redtime_tpu_torch.kernels import counts

    from rtbench import trace

    def calls(host_too: bool) -> tuple:
        done = failed = 0
        with trace.traced(host_too) as tr:
            for _ in range(n_calls):
                n, bad = entry.call()
                done += n
                failed += bad
        return done, failed, tr["events"]

    before = counts.snapshot()
    t0 = time.perf_counter()
    done, failed, events = calls(False)
    dt = time.perf_counter() - t0
    after = counts.snapshot()
    out = dict(seconds=dt, calls=n_calls, cosmologies=done, failed=failed,
               attempted=done, launches={k: after[k] - before[k]
                                         for k in after},
               trace=trace.reduce(events))
    done, failed, events = calls(True)
    out["attempted"] += done
    out["failed"] += failed
    gaps = trace.reduce(events).get("breakdown", {}).get("idle_gaps")
    if gaps:
        out["trace"].setdefault("breakdown", {})["idle_gaps"] = gaps
    return out


def check(ctx, entry, limits: dict, device: str) -> tuple:
    """The sampled cosmologies' outputs against the plain reference:
    (correct, {name: [value, limit]})."""
    import numpy as np

    from rtbench import compare, inputs, reference

    rng = np.random.default_rng(inputs.stream(ctx.seed, 2 ** 31 - 1))
    params, lin, got = entry.sample(rng)
    entry.close()
    ref = reference.solve(ctx.solver, ctx.settings_d, params, lin,
                          device=device)
    return compare.judge(compare.gaps(got, ref), limits)


def run(argv: list, t_start: float, device: str = "cuda",
        need_card: bool = True, overrides: dict | None = None) -> dict:
    """One run; returns the result line's dict (with its "checks" last)."""
    p = argparse.ArgumentParser(prog="rtbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    manifest = load_json(ROOT, "BENCHMARK.json")
    cell = cell_of(manifest, a.workload)
    if need_card:
        if not torch.cuda.is_available():
            raise Refused("no CUDA card: torch.cuda.is_available() is "
                          "false; the benchmark never runs on the CPU")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"the cell needs {cell['chips']} cards, "
                          f"{torch.cuda.device_count()} visible")
    ctx = context(manifest, a.workload, a.seed, device, overrides)
    limits = load_json(HERE, "limits", a.workload + ".json")
    entry = load_module("entries", ctx.traffic["entry"]).Entry(ctx)
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    rec = dict(workload=a.workload, config=ctx.solver,
               settings=ctx.settings_d, traffic=ctx.traffic,
               inputs=entry.shape(), setup_s=setup_s)
    if a.trace:
        rec["traced"] = traced_calls(entry, int(ctx.traffic["trace_calls"]))
        part = rec["traced"]
    else:
        rec["window"] = window(entry, a.seconds)
        part = rec["window"]
        part["attempted"] = part["cosmologies"]
    peak = (torch.cuda.max_memory_allocated(0) if device != "cpu" else 0)
    t_check = time.perf_counter()
    correct, checks = check(ctx, entry, limits, device)
    # after the check, so that what the reference loads is caught too
    found = forbidden_modules()
    if found:
        raise Refused(f"sys.modules holds {found} after the window and "
                      "the check")
    print(f"rtbench: {a.workload} seed {a.seed}: set-up {setup_s:.3f} s, "
          f"{part['calls']} calls in {part['seconds']:.3f} s, check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct = correct and part["failed"] == 0
    metrics = {}
    for m in metrics_of(manifest, a.workload, bool(a.trace)):
        value = load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = dict(platform="gpu" if device != "cpu" else "cpu",
               kind=(torch.cuda.get_device_name(0) if device != "cpu"
                     else "cpu"),
               count=int(cell["chips"]), memory_peak_bytes=int(peak))
    line = dict(correct=bool(correct), attempted=int(part["attempted"]),
                failed=int(part["failed"]), metrics=metrics, device=dev)
    if a.trace:
        tr = part["trace"]
        dev.update(busy_s=tr.get("busy_s", 0.0),
                   window_s=tr.get("window_s", part["seconds"]))
        if tr.get("breakdown"):
            line["breakdown"] = tr["breakdown"]
    if device != "cpu":
        dev["card"] = card_line()
    line["checks"] = checks
    return line


def main(argv: list, t_start: float) -> int:
    try:
        line = run(argv, t_start)
    except Refused as e:
        print(f"rtbench: {e}", file=sys.stderr)
        return 2
    for name, (value, limit) in line["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
