"""Entry `solve`: set-up prepares `batch` design cosmologies (the points of
the design drawn from the traffic's `design_seed`, in an order drawn from
the run's seed) through the driver's own prepare, placed as run_batch
places it by default (on the card: prepared on the host, then copied
over); each call is one redtime_tpu_torch.driver.solve over all of them,
one lockstep chunk of `lanes` = `batch` lanes.  Set-up ends with one
call, which runs every shape of the window."""

from __future__ import annotations

import numpy as np
import torch

from rtbench import inputs, program


class Entry:
    def __init__(self, ctx):
        from redtime_tpu_torch import driver, fastpt

        t = ctx.traffic
        self.ctx, self.batch = ctx, int(t["batch"])
        if int(t["lanes"]) != self.batch:
            raise ValueError("entry solve: lanes must equal batch (one "
                             "lockstep chunk)")
        self.params, self.lin = inputs.batch_inputs(
            self.batch, ctx.seed, 0, design_seed=t.get("design_seed"))
        dev = fastpt.device_of(ctx.device)
        # the rows as run_batch hands them to _prepare: (cs, lins, norm)
        rows = ([np.ascontiguousarray(self.params[:, i])
                 for i in range(self.params.shape[1])], list(self.lin), None)
        self.model = driver._prepare(ctx.cfg, rows, dev,
                                     on_host=dev.type != "cpu")
        self.ec = fastpt.engine_consts(ctx.cfg, ctx.device)
        self.last = None
        self.idx = program.sample_lanes(ctx)
        self.call()

    def call(self) -> tuple:
        from redtime_tpu_torch import driver

        self.last = driver.solve(self.ctx.cfg, self.ctx.settings, self.model,
                                 self.ec)
        if self.ctx.device != "cpu":
            torch.cuda.synchronize()
        return self.batch, program.lanes_failed(self.last)

    def shape(self) -> dict:
        return program.shape(self.ctx, self.lin)

    def sample(self, rng) -> tuple:
        """(params, lin, the program's outputs) of the sampled lanes in the
        last call (every call solves the same inputs)."""
        idx = self.idx
        got = program.outputs(self.last, idx)
        return (self.params[idx], tuple(x[idx] for x in self.lin), got)

    def close(self) -> None:
        """Free the program's state on the card before the reference."""
        self.model = self.ec = self.last = None
        if self.ctx.device != "cpu":
            torch.cuda.empty_cache()
