"""Structured stage timing, spans and solver counters, and the profiler
hook (the port of redtime_tpu/profiling.py, plus the spans).

`StageTimer` accumulates host wall-clock per named stage, used as a
context manager; `block_on` synchronises a CUDA tensor's device before the
stage's clock stops, so the device work queued in the stage is booked to
it.  `device_trace` wraps `torch.profiler.profile` and writes a Chrome
trace (viewable in Perfetto or chrome://tracing) to a directory.

Tracing is off by default.  Spans are on where `tracing(spans=True)`
switched them on and while `device_trace` records (the CLI's
`--trace-dir`); a torch.profiler started elsewhere does not switch them
on, since a profile of device activity alone records no span and would
pay for them.  The counters are on where `tracing(counters=True)`
switched them on and while any torch.profiler records (the benchmark's
traced calls).  With tracing off, `span(name)` returns one shared no-op
context and the solver counts nothing, adding no device work.  With
spans on, a span is `torch.profiler.record_function(name)`: a
`user_annotation` in the trace, on the clock of the device's events.
The spans, nested in this order:

  driver.solve          driver._solve: one lockstep chunk to its tables
    trg.evolve          trg.evolve: the eta evolution to every output
      ode.interval      one integrate_interval call (an output interval;
                        prepare's growth segments run it too)
        ode.check       the host's wait on whether any lane still runs
        ode.attempt     one controller attempt: its stages and K3's finish
          trg.rhs       one RHS evaluation
            fastpt.engine   K9, K10, K1, K2 (full Time-RG)
            rhs_tail        K8
    driver.finalize     the output block: the engine call and K11
  driver.prepare        driver._prepare: prepare_model and the copy
    model.growth        the growth ODE tables
    model.beta_transfer beta_P and the transfer on the solver grid
    model.sigma8        the sigma_8 normalisation (quad_impl "qag")
    model.sigma_v       the sigma_v^2(z=0) quadrature (quad_impl "qag")
    driver.prepare.copy the pinned copy of a host-prepared Model

and each `StageTimer` stage under its own name ("prepare", "solve", the
CLI's stages).  The counters (`counters()`), over trg.evolve's lockstep
intervals (the packed queue, trg.evolve_packed, and prepare's growth
ODE are not counted):

  ode.attempts_launched      attempts launched on every lane (on the card,
                             K3 rk_finish launches)
  ode.checks                 the host's waits on the lanes
  ode.lane_slots             attempts launched x lanes
  ode.lane_attempts          the sum over lanes and intervals of each
                             lane's own attempts
  ode.slowest_lane_attempts  the sum over intervals of the slowest lane's

The last two are read from each interval's attempt counts, held as
the device tensors they are (no device work while counting: a first
reduction on the card inside a profiled window would load its kernel
there) and summed on the host when `counters()` is called, after the
caller synchronised.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, Optional

import torch

COUNTERS = ("ode.attempts_launched", "ode.checks", "ode.lane_slots",
            "ode.lane_attempts", "ode.slowest_lane_attempts")

_spans_on = False
_counters_on = False
_profiler_on = torch._C._autograd._profiler_enabled
_counts: Dict[str, int] = dict.fromkeys(COUNTERS, 0)
# each counted interval's attempt counts n [B], summed in counters()
_held: list = []


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A context that, with spans on, records the block under `name`
    (module docstring); otherwise the shared no-op."""
    if _spans_on:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def counting() -> bool:
    """Whether the solver's counters count."""
    return _counters_on or _profiler_on()


def tracing(spans: bool = False, counters: bool = False) -> None:
    """Switch spans and counters on or off."""
    global _spans_on, _counters_on
    _spans_on, _counters_on = bool(spans), bool(counters)


def reset() -> None:
    """Clear the counters."""
    _counts.update(dict.fromkeys(COUNTERS, 0))
    _held.clear()


def count_lockstep(launched: int, checks: int, ns: list) -> None:
    """Book lockstep intervals: `launched` attempts on every lane,
    `checks` waits, and each interval's lanes' own attempts n [B] in ns
    (held, summed in `counters()`)."""
    _counts["ode.attempts_launched"] += launched
    _counts["ode.checks"] += checks
    _counts["ode.lane_slots"] += launched * ns[0].shape[0]
    _held.extend(ns)


def counters() -> dict:
    """The counters (module docstring); the caller has synchronised the
    devices the counted intervals ran on."""
    for n in _held:
        n = n.cpu()
        _counts["ode.lane_attempts"] += int(n.sum())
        _counts["ode.slowest_lane_attempts"] += int(n.max())
    _held.clear()
    return dict(_counts)


def sync(x) -> None:
    """Wait for the device of tensor x when it is a CUDA tensor; a no-op
    for anything else."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class StageTimer:
    """Accumulates wall-clock per named stage; prints each stage as it
    ends when enabled.  Each stage is a span of its name.  `stats` holds
    what a run books beside its stages (driver.run_batch: each
    cosmology's controller attempts, "attempts", and the packed
    scheduler's loop iterations, "iterations")."""

    def __init__(self, enabled: bool = True, stream=None):
        self.enabled = enabled
        self.stream = stream if stream is not None else sys.stderr
        self.times: Dict[str, float] = {}
        self.stats: Dict[str, object] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        with span(name):
            try:
                yield
            finally:
                sync(block_on)
                dt = time.perf_counter() - t0
                self.times[name] = self.times.get(name, 0.0) + dt
                if self.enabled:
                    print(f"# [timing] {name}: {dt:.3f}s", file=self.stream)

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"# [timing] {k}: {v:.3f}s ({v / total * 100:.0f}%)"
                 for k, v in sorted(self.times.items(),
                                    key=lambda kv: -kv[1])]
        lines.append(f"# [timing] total: {total:.3f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """torch.profiler over the block when log_dir is given (CPU and, with
    a card, CUDA activity), written to log_dir/trace.json; a no-op
    otherwise.  The spans are on while it records."""
    global _spans_on
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was, _spans_on = _spans_on, True
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        _spans_on = was
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
