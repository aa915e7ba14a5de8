"""The plain reference of a cell's output: prepare, evolve and the output
tables of a few cosmologies, by the frozen plain path in rtbench.rtref.

It takes the raw inputs that the benchmark handed the program (design
rows and linear arrays) and nothing the program made.  Prepare runs on
the host CPU on one torch thread, as the port's host prepare does; the
evolution and the output block run on `device` in plain PyTorch.

With a dtype below float64 (a control), every RHS evaluation (the engine
and the tail) and the output block run in that dtype, on the prepared
tables cast to it, along the accepted steps of the float64 run (replay):
prepare, the state and its updates stay in float64.  A step controller
fed float32 RHS values stalls on the nk=512 grid (its error estimate's
rounding, ~1e-7 of the RHS a step, stays above eabs = 1e-15 on the rows
that start at 0), so the control takes the float64 run's steps instead.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

MODEL_FIELDS = ("g_lna", "g_G", "g_dDda", "g_Dnorm", "beta_a",
                "beta_solver", "T_solver", "norm", "sigmaV2_z0")


@contextlib.contextmanager
def _threads(n: int):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _finalize(cfg, settings, model, ys, ec):
    """driver._finalize of the port at its commit, on the plain path:
    (table [B, n_z, nk, ncol], sigma_v2 [B, n_z], H [B, n_z])."""
    from rtbench.rtref import fastpt
    from rtbench.rtref.grids import make_grids
    from rtbench.rtref.kernels import out_block as ob

    B, S = ys.shape[:2]
    nk = ys.shape[3]
    F = ys.dtype
    lay = ob.layout_of(cfg, settings)
    k = torch.as_tensor(make_grids(cfg).k, dtype=F, device=ys.device)
    src = None
    if lay.mc:
        src = fastpt.compute_J_PZ(
            cfg, ys[:, :, 0:3].reshape(B * S, 3, nk), model.cosmo.n_s,
            settings.print_rsd, ec, n_rep=S)
    return ob.out_block(
        lay, ys, k, model, tuple(float(x) for x in settings.z_out),
        settings.a_in, src, ob.sv_weights(make_grids(cfg).k, cfg.kmin))


def prepare(solver: dict, params: np.ndarray, lin: tuple):
    """The reference's prepared Model of the rows `params` [n, 9] with the
    linear arrays `lin` (each with a leading dimension n), on the CPU."""
    from rtbench.rtref import model as mdl
    from rtbench.rtref.config import CosmoParams, SolverConfig
    from rtbench.rtref.io.camb import LinearData

    f64 = torch.float64
    cfg = SolverConfig(**solver)
    cs = CosmoParams(*[torch.as_tensor(np.array(params[:, i]), dtype=f64)
                       for i in range(params.shape[1])])
    li = LinearData(*[torch.as_tensor(np.array(x, dtype=np.float64))
                      for x in lin])
    with _threads(1):
        return mdl.prepare_model(cfg, cs, li)


# the modules that keep float64 in a control: the integrator and its
# controller, and the state's time-stepping (trg's evolve loops)
KEEP_F64 = ("ode", "kernels.rk_finish", "trg")


def _cast(x, dtype):
    """Tensors, and the tensors in (named) tuples, as dtype where they
    are floating."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, tuple):
        items = [_cast(v, dtype) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


@contextlib.contextmanager
def _lower(cfg, device, dtype):
    """Inside the block trg's RHS evaluates in dtype (its engine constants
    and the Model's tables cast to dtype) and returns float64."""
    from rtbench.rtref import fastpt, precision, trg
    from rtbench.rtref.kernels import rhs_tail as rt

    precision.use(dtype, keep=KEEP_F64)
    ec = fastpt.engine_consts(cfg, device)
    make_rhs = trg.make_rhs

    def lowered(cfg_, settings, model, ec_, cache=None):
        prologue = trg.rhs_prologue(cfg_, settings, _cast(model, dtype), ec,
                                    _cast(cache, dtype))

        def rhs(eta, yflat):
            args = _cast(prologue(eta.to(dtype), yflat.to(dtype)), dtype)
            dy = rt.rhs_tail(*args)
            if dy.dtype != dtype:
                raise RuntimeError(f"the control's RHS came out in "
                                   f"{dy.dtype}, not {dtype}")
            return dy.reshape(yflat.shape[0], -1).to(torch.float64)

        return rhs

    trg.make_rhs = lowered
    try:
        yield ec
    finally:
        trg.make_rhs = make_rhs
        precision.use(torch.float64)


@contextlib.contextmanager
def _record_steps():
    """Inside the block every K3 attempt's (t, t after) is recorded, on
    the host: yields the list of pairs."""
    from rtbench.rtref import ode

    steps = []
    finish = ode.rk_finish

    def recording(y, ks, t, h, t1, n, active, consts):
        out = finish(y, ks, t, h, t1, n, active, consts)
        steps.append((t.cpu().numpy().copy(), out[1].cpu().numpy().copy()))
        return out

    ode.rk_finish = recording
    try:
        yield steps
    finally:
        ode.rk_finish = finish


def replay(cfg, settings, model, steps: list, rhs):
    """The states at the output redshifts [B, n_z, 41, nk] of the RK pair's
    solution along the recorded accepted steps (t, t after, per lane), in
    lockstep (a lane with fewer steps takes steps of 0), each stage by
    rhs(eta [B], y [B, 41 nk]) -> float64."""
    from rtbench.rtref import trg

    tab = trg.eta_tableau(cfg)
    B = model.batch
    dev = model.norm.device
    f64 = torch.float64
    lanes = [[(t0[b], t1[b]) for t0, t1 in steps if t1[b] != t0[b]]
             for b in range(B)]
    n = max(len(x) for x in lanes)
    T0, T1 = np.zeros((B, n)), np.zeros((B, n))
    for b, x in enumerate(lanes):
        if x:
            T0[b, :len(x)], T1[b, :len(x)] = np.array(x).T
            T0[b, len(x):] = T1[b, len(x):] = x[-1][1]
    etas = settings.etasteps()
    a = torch.as_tensor(np.asarray(tab.a), dtype=f64, device=dev)
    bw = torch.as_tensor(np.asarray(tab.b), dtype=f64, device=dev)
    c = torch.as_tensor(np.asarray(tab.c), dtype=f64, device=dev)
    y = trg.initial_state(cfg, settings, model)
    nk = cfg.nk
    outs = torch.full((B, len(etas)) + tuple(y.shape[1:]), float("nan"),
                      dtype=f64, device=dev)
    for j in range(n):
        t = torch.as_tensor(T0[:, j], dtype=f64, device=dev)
        h = torch.as_tensor(T1[:, j] - T0[:, j], dtype=f64, device=dev)
        ks = []
        for i in range(len(c)):
            yi = y
            for m in range(i):
                yi = yi + (h * a[i, m])[:, None] * ks[m]
            ks.append(rhs(t + c[i] * h, yi))
        y = y + h[:, None] * sum(bw[i] * ks[i] for i in range(len(c)))
        for z, eta in enumerate(etas):
            hit = torch.as_tensor(T1[:, j] == eta, device=dev)
            if bool(hit.any()):
                outs[:, z] = torch.where(hit[:, None], y, outs[:, z])
    return outs.reshape(B, len(etas), trg.NU_STATE, nk)


def model_tables(m) -> dict:
    """The prepared Model's tables as numpy f64, by field name."""
    return {f: getattr(m, f).detach().double().cpu().numpy()
            for f in MODEL_FIELDS}


def solve(solver: dict, settings: dict, params: np.ndarray, lin: tuple,
          device="cuda", dtype=torch.float64) -> dict:
    """The reference's outputs for the rows `params`, evolved in lockstep
    (trg.evolve): the output table, sigma_v2, H, sigmaV2_z0 and the
    prepared Model's tables, as numpy f64 arrays."""
    from rtbench.rtref import fastpt, precision, trg
    from rtbench.rtref import model as mdl
    from rtbench.rtref.config import CosmoParams, RunSettings, SolverConfig

    cfg = SolverConfig(**solver)
    rs = RunSettings(**settings)
    precision.use(torch.float64)
    m = prepare(solver, params, lin)
    out = {"model": model_tables(m)}
    to = lambda x: x.to(device=device)
    m = mdl.Model(CosmoParams(*map(to, m.cosmo)), *map(to, m[1:]))

    ec = fastpt.engine_consts(cfg, device)
    with _record_steps() as steps:
        ys = trg.evolve(cfg, rs, m, ec)
    if dtype == torch.float64:
        table, sv2, H = _finalize(cfg, rs, m, ys, ec)
    else:
        with _lower(cfg, device, dtype) as ec:
            ys = replay(cfg, rs, m, steps, trg.make_rhs(cfg, rs, m, ec))
            table, sv2, H = _finalize(cfg, rs, _cast(m, dtype),
                                      ys.to(dtype), ec)
        if table.dtype != dtype:
            raise RuntimeError(f"the control's table came out in "
                               f"{table.dtype}, not {dtype}")
    host = lambda x: x.detach().double().cpu().numpy()
    out.update(table=host(table), sigma_v2=host(sv2), H=host(H),
               sigmaV2_z0=out["model"]["sigmaV2_z0"])
    return out
