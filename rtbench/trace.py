"""The device trace of a traced run: torch.profiler over the traced calls,
between two marker kernels, exported as a Chrome trace and reduced to
what the per-layer readers take.

The window runs from the first marker's start to the second's end (the
first is launched as the window opens, the second once the last call has
synchronised).  Busy time is the union of the intervals of every other
device operation in it (kernels, copies, fills); each hand kernel's
launches and seconds are booked by its launch counter's name.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile

import torch

MARKER = "spin_kernel"      # torch.cuda._sleep's kernel
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
             "cuda_driver")
# CUDA function name -> the port's launch counter (kernels.counts)
KERNELS = {"rk_stage_kernel": "rk_stage", "rk_finish_kernel": "rk_finish",
           "rk_finish_passes_kernel": "rk_finish",
           "engine_front_kernel": "engine_front",
           "tab_leg_kernel": "tab_leg", "out_leg_kernel": "out_leg",
           "pz_leg_kernel": "pz_leg", "rhs_tail_kernel": "rhs_tail",
           "out_block_kernel": "out_block"}


def short_name(name: str) -> str:
    """A device operation's name without return type, template arguments
    and parameters ("void f<1>(double*)" -> "f")."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in ("(", "<"):
        name = name.split(stop, 1)[0]
    return name.strip()[:64] or "unnamed"


@contextlib.contextmanager
def traced(host: bool):
    """Profile the block (CUDA activity, and the host's with host=True)
    between two marker kernels; yields a dict that holds, after the
    block, the trace's events ("events": the Chrome trace's list)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                      else [])
    out: dict = {}
    with profile(activities=acts) as prof:
        torch.cuda._sleep(1000)
        yield out
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    out["events"] = data["traceEvents"] if isinstance(data, dict) else data


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_at(host: list, starts: list, t: float, look: int = 4000) -> str:
    """The innermost host event (sorted by start) that spans time t: the
    latest-starting one that has not ended by t."""
    if not host:
        return "host: none traced"
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "host: Python between ops"


def reduce(events: list, top: int = 10) -> dict:
    """busy_s, window_s, each hand kernel's launches and device seconds
    ("kernels": counter name -> [launches, seconds]), and the breakdown:
    the device operations that took most time and the idle gaps' time by
    what the host was doing at each gap's middle (the innermost host
    event there; "host: none traced" without host events)."""
    dev, host, markers = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            name = e.get("name", "")
            if MARKER in name:
                markers.append((s, s + d))
            else:
                dev.append((s, s + d, name))
        elif cat in HOST_CATS:
            host.append((s, s + d, e.get("name", "")))
    if not dev:
        return {}
    if len(markers) >= 2:
        markers.sort()
        w0, w1 = markers[0][0], markers[-1][1]
    else:
        w0, w1 = min(x[0] for x in dev), max(x[1] for x in dev)
    dev = [x for x in dev if x[1] > w0 and x[0] < w1]
    busy = _union([[max(s, w0), min(e, w1)] for s, e, _ in dev])
    busy_us = sum(e - s for s, e in busy)
    kernels: dict = {}
    by_op: dict = {}
    for s, e, name in dev:
        fn = short_name(name)
        by_op[fn] = by_op.get(fn, 0.0) + (e - s) * 1e-6
        counter = KERNELS.get(fn)
        if counter:
            n, secs = kernels.get(counter, (0, 0.0))
            kernels[counter] = (n + 1, secs + (e - s) * 1e-6)
    gaps: dict = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    host.sort()
    starts = [h[0] for h in host]
    dev.sort()
    dev_starts = [x[0] for x in dev]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            label = _host_at(host, starts, 0.5 * (g0 + g1))
            if not host:
                i = bisect.bisect_left(dev_starts, g1)
                label += (f", before {short_name(dev[i][2])}"
                          if i < len(dev) else ", at the window's end")
            gaps[label] = gaps.get(label, 0.0) + (g1 - g0) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                 key=lambda kv: -kv[1])[:top]]
    return dict(busy_s=busy_us * 1e-6, window_s=(w1 - w0) * 1e-6,
                kernels={k: list(v) for k, v in kernels.items()},
                breakdown=dict(device_ops=rank(by_op), idle_gaps=rank(gaps)))
