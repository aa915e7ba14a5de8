"""Structured stage timing and the profiler hook (the port of
redtime_tpu/profiling.py).

`StageTimer` accumulates host wall-clock per named stage, used as a
context manager; `block_on` synchronises a CUDA tensor's device before the
stage's clock stops, so the device work queued in the stage is booked to
it.  `device_trace` wraps `torch.profiler.profile` and writes a Chrome
trace (viewable in Perfetto or chrome://tracing) to a directory.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, Optional

import torch


def sync(x) -> None:
    """Wait for the device of tensor x when it is a CUDA tensor; a no-op
    for anything else."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class StageTimer:
    """Accumulates wall-clock per named stage; prints each stage as it
    ends when enabled.  `stats` holds what a run books beside its stages
    (driver.run_batch: each cosmology's controller attempts, "attempts",
    and the packed scheduler's loop iterations, "iterations")."""

    def __init__(self, enabled: bool = True, stream=None):
        self.enabled = enabled
        self.stream = stream if stream is not None else sys.stderr
        self.times: Dict[str, float] = {}
        self.stats: Dict[str, object] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
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
    otherwise."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
