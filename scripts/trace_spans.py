"""The port's spans and solver counters in the benchmark's cells, on one
CUDA card: what the readings of the program's own records give, and
what tracing costs.

    python3 scripts/trace_spans.py [--cells A,B] [--seed N] [--window S]
        [--calls N] [--out PATH]

For each cell of BENCHMARK.json (default: all), as rtbench/harness.py
builds it (its configuration, traffic and entry; inputs from --seed):

  set-up     the entry's prepare and warm-up call, with prepare's host
             seconds (driver._prepare) and those of its stages
             (build_growth_tables, the two qag quadratures, the copy;
             "other" the rest of prepare_model) taken by timing wrappers;
  off        tracing off: whole calls for --window seconds
             (harness.window), the calls a second;
  device     --calls calls under torch.profiler, device activity alone
             (trace.traced(False), as the harness's first traced pass),
             twelve passes in turns: as the program runs there (the
             counters on, the spans off), with the spans switched on
             too, and with the counters kept off: the solver counters
             against K3 rk_finish's launches (kernels.counts) over the
             same calls, the occupancy and
             overrun, the idle share and the window's seconds a call;
  host       --calls calls with the host traced too (the harness's
             second pass), the spans switched on: `reduce_spans` (each
             span's count and seconds, the idle seconds that start inside
             `ode.check` over the window, the idle by the span open where
             it starts) and trace.reduce's idle gaps (by the host event
             open at each gap's middle, as the result line's breakdown has
             them), and the gaps that start in a check, the interval's
             last check apart from the others;
  span cost  a span's host microseconds with tracing off and with spans
             on (no profiler), and the span sites a call opens.

Writes one JSON object, with the card's name and power limit, to PATH
(default chiprun_out/trace_spans.json) and prints a summary.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def span_cost_us(reps: int = 200_000) -> dict:
    """A span's host microseconds, off and on (no profiler), less the
    bare loop's."""
    from redtime_tpu_torch import profiling

    def loop(n: int, body: bool) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            if body:
                with profiling.span("cost"):
                    pass
        return (time.perf_counter() - t0) / n * 1e6

    bare = loop(reps, False)
    off = loop(reps, True) - bare
    profiling.tracing(spans=True)
    try:
        on = loop(reps // 10, True) - bare
    finally:
        profiling.tracing()
    return dict(off_us=off, on_us=on)


CHECK = "ode.check"
SPAN_CAT = "user_annotation"
# prepare's stages, timed by wrappers: (module, function, name)
PREPARE = (("driver", "_prepare", "driver.prepare"),
           ("driver", "_on_device", "driver.prepare.copy"),
           ("model", "build_growth_tables", "model.growth"),
           ("model", "sigma8_normalization_qag", "model.sigma8"),
           ("model", "sigma_v2_z0_qag", "model.sigma_v"))


def timed_prepare(build):
    """build() with prepare's stages (PREPARE) timed: (build's result,
    name -> [calls, host seconds], "other" prepare's seconds outside the
    named stages)."""
    from redtime_tpu_torch import driver, model

    mods = dict(driver=driver, model=model)
    table: dict = {}
    saved = []

    def wrap(fn, name):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                entry = table.setdefault(name, [0, 0.0])
                entry[0] += 1
                entry[1] += time.perf_counter() - t0
        return timed

    for mod, attr, name in PREPARE:
        fn = getattr(mods[mod], attr)
        saved.append((mods[mod], attr, fn))
        setattr(mods[mod], attr, wrap(fn, name))
    try:
        out = build()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    whole = table.get("driver.prepare", [0, 0.0])[1]
    table["other"] = [1, whole - sum(v[1] for k, v in table.items()
                                     if k != "driver.prepare")]
    return out, table


def _window(dev: list, markers: list) -> tuple:
    if len(markers) >= 2:
        markers.sort()
        return markers[0][0], markers[-1][1]
    return min(s for s, _ in dev), max(e for _, e in dev)


def _by_start(gaps: list, spans: list) -> dict:
    """Each gap's seconds by the innermost span open at its start (spans
    sorted by start, the outer first, nested as one thread opens them)."""
    out: dict = {}
    stack: list = []
    j = 0
    for g0, g1 in gaps:
        while j < len(spans) and spans[j][0] <= g0:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < g0:
            stack.pop()
        label = stack[-1][2] if stack else "no span"
        out[label] = out.get(label, 0.0) + (g1 - g0) * 1e-6
    return out


def reduce_spans(events: list) -> dict:
    """spans (name -> [count, seconds]), window_s, idle_s, check_idle_s
    (the idle that starts while the host waits in `ode.check`: the queue
    drained while the host waited, until the next device operation) and
    idle_by_span (name -> seconds, by the innermost span open where each
    gap starts) of one host-traced pass; {} without device events."""
    from rtbench import trace

    dev, markers, spans = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        cat = e.get("cat", "")
        if cat in trace.DEVICE_CATS:
            (markers if trace.MARKER in e.get("name", "") else dev).append(
                (s, s + d))
        elif cat == SPAN_CAT:
            spans.append((s, s + d, e.get("name", "")))
    if not dev:
        return {}
    w0, w1 = _window(dev, markers)
    busy = trace._union([[max(s, w0), min(e, w1)] for s, e in dev
                         if e > w0 and s < w1])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2]) if g1 > g0]
    spans.sort(key=lambda x: (x[0], -x[1]))      # outer first
    table: dict = {}
    for s, e, name in spans:
        n, secs = table.get(name, (0, 0.0))
        table[name] = (n + 1, secs + (e - s) * 1e-6)
    by_span = _by_start(gaps, spans)
    return dict(spans={k: list(v) for k, v in table.items()},
                window_s=(w1 - w0) * 1e-6,
                idle_s=sum(g1 - g0 for g0, g1 in gaps) * 1e-6,
                check_idle_s=by_span.get(CHECK, 0.0),
                idle_by_span=dict(sorted(by_span.items(),
                                         key=lambda kv: -kv[1])))


def device_pass(entry, n_calls: int, mode: str) -> dict:
    """n_calls calls under the profiler, device activity alone, as the
    harness's first traced pass: as the program runs there (mode
    "program": the counters follow the profiler, the spans are off),
    with the spans switched on too ("spans"), or with the counters kept
    off ("bare"), for the cost of each there."""
    from redtime_tpu_torch import profiling
    from redtime_tpu_torch.kernels import counts

    from rtbench import trace

    profiling.reset()
    profiling.tracing(spans=mode == "spans")
    follow = profiling._profiler_on
    if mode == "bare":
        profiling._profiler_on = lambda: False
    before = counts.snapshot()
    try:
        with trace.traced(False) as tr:
            for _ in range(n_calls):
                entry.call()
        c = profiling.counters()
    finally:
        profiling._profiler_on = follow
        profiling.tracing()
    launches = {k: v - before[k] for k, v in counts.snapshot().items()}
    red = trace.reduce(tr["events"])
    launched = c["ode.attempts_launched"]
    return dict(
        mode=mode, calls=n_calls, counters=c,
        rk_finish_launches=launches["rk_finish"],
        launched_equals_rk_finish=launched == launches["rk_finish"],
        lockstep_occupancy=100.0 * c["ode.lane_attempts"]
        / max(c["ode.lane_slots"], 1),
        overrun_attempt_pct=100.0 * (launched
                                     - c["ode.slowest_lane_attempts"])
        / max(launched, 1),
        busy_s=red["busy_s"], window_s=red["window_s"],
        window_per_call_s=red["window_s"] / n_calls,
        idle_pct=100.0 * (1.0 - red["busy_s"] / red["window_s"]))


def check_gaps(events: list) -> dict:
    """The idle gap that starts inside each `ode.check` (after the last
    device operation that ends in it), split into the checks that end an
    interval (no attempt follows in their ode.interval) and the others:
    [checks, the gaps' seconds] each."""
    from rtbench import trace

    dev, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if (e.get("cat") in trace.DEVICE_CATS
                and trace.MARKER not in e.get("name", "")):
            dev.append([s, s + d])
        elif e.get("cat") == "user_annotation":
            spans.append((s, s + d, e.get("name", "")))
    busy = trace._union(dev)
    starts = [s for s, _ in busy]
    ends = [e for _, e in busy]
    attempts = sorted(s for s, _, name in spans if name == "ode.attempt")
    intervals = [(s, e) for s, e, name in spans if name == "ode.interval"]
    out = {"in_interval": [0, 0.0], "interval_end": [0, 0.0]}
    for s, e, name in spans:
        if name != "ode.check":
            continue
        k = bisect.bisect_right(ends, e) - 1
        gap = 0.0
        if k >= 0 and ends[k] >= s and k + 1 < len(starts):
            gap = (starts[k + 1] - ends[k]) * 1e-6
        iv_end = max((i1 for i0, i1 in intervals if i0 <= s <= i1),
                     default=e)
        j = bisect.bisect_right(attempts, e)
        key = ("interval_end" if j == len(attempts) or attempts[j] > iv_end
               else "in_interval")
        out[key][0] += 1
        out[key][1] += gap
    return out


def cell(manifest: dict, name: str, seed: int, window_s: float,
         n_calls: int) -> dict:
    import torch

    from redtime_tpu_torch import profiling

    from rtbench import harness, trace

    t_start = time.perf_counter()
    ctx = harness.context(manifest, name, seed, "cuda")
    entry, prep = timed_prepare(
        lambda: harness.load_module("entries", ctx.traffic["entry"]).Entry(
            ctx))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    out = dict(cell=name, seed=seed, setup_s=setup_s, prepare_stages=prep)

    w = harness.window(entry, window_s)
    out["off"] = dict(w, calls_per_s=w["calls"] / w["seconds"])

    passes = []
    for mode in ("program", "spans", "bare") * 4:
        passes.append(device_pass(entry, n_calls, mode))
    out["device"] = next(p for p in passes if p["mode"] == "program")
    out["device_passes"] = [
        {k: p[k] for k in ("mode", "idle_pct", "window_per_call_s")}
        for p in passes]

    profiling.tracing(spans=True)
    try:
        t0 = time.perf_counter()
        with trace.traced(True) as tr:
            for _ in range(n_calls):
                entry.call()
        dt = time.perf_counter() - t0
    finally:
        profiling.tracing()
    red = reduce_spans(tr["events"])
    full = trace.reduce(tr["events"])
    gaps = full.get("breakdown", {}).get("idle_gaps", [])
    out["host"] = dict(
        calls=n_calls, seconds=dt, calls_per_s=n_calls / dt,
        window_s=red["window_s"], idle_s=red["idle_s"],
        check_idle_s=red["check_idle_s"],
        device_idle_pct_check=100.0 * red["check_idle_s"] / red["window_s"],
        idle_by_span=red["idle_by_span"], spans=red["spans"],
        idle_gaps_by_middle=gaps,
        check_gaps=check_gaps(tr["events"]),
        python_between_ops_share=dict(gaps).get(
            "host: Python between ops", 0.0) / red["idle_s"],
        sites_per_call=sum(v[0] for v in red["spans"].values()) / n_calls)
    entry.close()
    return out


def main(argv=None) -> int:
    import torch

    from rtbench import harness

    p = argparse.ArgumentParser(prog="scripts/trace_spans.py")
    p.add_argument("--cells", default="")
    p.add_argument("--seed", type=int, default=3_000_000_019)
    p.add_argument("--window", type=float, default=12.0)
    p.add_argument("--calls", type=int, default=0,
                   help="calls a traced pass (default: the traffic's "
                        "trace_calls)")
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                 "trace_spans.json"))
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_spans: no CUDA card", file=sys.stderr)
        return 2
    manifest = harness.load_json(ROOT, "BENCHMARK.json")
    names = ([c for c in a.cells.split(",") if c] or
             [w["name"] for w in manifest["workloads"]])
    res = dict(card=harness.card_line(), span_cost=span_cost_us(),
               cells=[])
    for name in names:
        ctx = harness.context(manifest, name, a.seed, "cuda")
        n = a.calls or int(ctx.traffic["trace_calls"])
        r = cell(manifest, name, a.seed, a.window, n)
        res["cells"].append(r)
        d, h = r["device"], r["host"]
        print(f"{name}: setup {r['setup_s']:.2f} s, prepare "
              f"{r['prepare_stages'].get('driver.prepare', [0, 0])[1]:.2f} s;"
              f" s a call: off {1 / r['off']['calls_per_s']:.4f}, device "
              f"pass {d['window_per_call_s']:.4f}, host pass "
              f"{h['window_s'] / h['calls']:.4f};"
              f" occupancy {d['lockstep_occupancy']:.2f}%, overrun "
              f"{d['overrun_attempt_pct']:.2f}%, launched = rk_finish "
              f"{d['launched_equals_rk_finish']}; idle check "
              f"{h['device_idle_pct_check']:.3f}% of the window",
              flush=True)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res["span_cost"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
