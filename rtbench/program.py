"""What the entries share: the program's inputs from the benchmark's and
the outputs read back for the check."""

from __future__ import annotations

import numpy as np
import torch


def cosmo(params: np.ndarray):
    """The program's CosmoParams of the rows params [n, 9] (CPU)."""
    from redtime_tpu_torch.config import CosmoParams

    return CosmoParams(*[torch.as_tensor(np.array(params[:, i]))
                         for i in range(params.shape[1])])


def linear(lin: tuple):
    from redtime_tpu_torch.io.camb import LinearData

    return LinearData(*[torch.as_tensor(np.array(x, dtype=np.float64))
                        for x in lin])


def sample_lanes(ctx) -> list:
    """The lanes of a call whose outputs the check compares:
    `check_lanes` of the batch, drawn from the seed."""
    from rtbench import inputs

    rng = np.random.default_rng(inputs.stream(ctx.seed, 2 ** 31 - 2))
    n = int(ctx.traffic["batch"])
    return sorted(rng.choice(n, size=min(int(ctx.traffic["check_lanes"]), n),
                             replace=False).tolist())


def outputs(res, idx) -> dict:
    """The rows idx of a RunResult as numpy f64 arrays, under the names
    compare.gaps takes."""
    host = lambda x: x[idx].detach().double().cpu().numpy()
    return dict(table=host(res.table), sigma_v2=host(res.sigma_v2),
                H=host(res.H), sigmaV2_z0=host(res.sigmaV2_z0))


def lanes_failed(res) -> int:
    """Cosmologies with a NaN or inf anywhere in their output."""
    from redtime_tpu_torch import driver

    return len(driver.finite_report(res))


def shape(ctx, lin: tuple) -> dict:
    """The sizes the per-layer readers compute costs from."""
    s = ctx.solver
    rsd = bool(ctx.settings_d["print_rsd"] or s.get("print_q", False))
    one_loop = bool(ctx.settings_d["nonlinear"]
                    and ctx.settings_d["one_loop"])
    mode = ("linear" if not ctx.settings_d["nonlinear"]
            else "oneloop" if one_loop else "full")
    return dict(nk=int(s["nk"]), npts=int(s["nk"] * s["np_factor"]),
                nfam=14 if rsd else 7, nz=int(lin[3].shape[-1]),
                rt_variant=mode if mode == "linear" else
                mode + ("_q" if rsd else ""),
                stages={"rkf45": 6, "dopri5": 7, "dop853": 12}[
                    s["eta_tableau"]],
                lanes=int(ctx.traffic["lanes"]),
                batch=int(ctx.traffic["batch"]))
