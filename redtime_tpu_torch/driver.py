"""End-to-end solver driver: prepare -> evolve -> output tables.

`run_batch` is the entry point, with the JAX package's two schedulers
(redtime_tpu/driver.py:603-710):
  * chunked (the default): a batch of cosmologies is cut into chunks (the
    last one padded by repeating its first lane), each chunk is prepared
    and then solved on `device` as one batch with one adaptive controller
    per lane, and the chunks are concatenated, with the vmap written out
    as the leading batch dimension;
  * packed: every cosmology is prepared at once, and n_lanes lanes pull
    cosmologies off a work queue as they finish (trg.evolve_packed,
    redtime_tpu/driver.py:542-600 without the mesh).
`run_pipeline` runs one cosmology (redtime_tpu/driver.py:453-492).

Prepare placement, as in the JAX package: on the card, each chunk is
prepared on the host CPU (`prepare_on_host`, the default there) and the
prepared `Model` is copied to the card; the solve runs on the card.
Prepare is some 700,000 small kernels a chunk, bound by launches on the
card and by per-op overhead on the host.  With more than one chunk, a
prepare worker process (`worker.py`) prepares chunk i+1 while the caller
launches chunk i's solve (redtime_tpu/driver.py:520-531).

`run_batch(devices=[...])` is the counterpart of the JAX package's
`mesh`: the batch is padded to a multiple of the device count and cut
into one contiguous shard per device, each run by a worker process with
its own queue or chunks (redtime_tpu/driver.py:542-600, 603-710).
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from redtime_tpu_torch import fastpt
from redtime_tpu_torch import model as mdl
from redtime_tpu_torch import trg
from redtime_tpu_torch.config import CosmoParams, RunSettings, SolverConfig
from redtime_tpu_torch.fastpt import device_of, engine_consts
from redtime_tpu_torch.grids import make_grids
from redtime_tpu_torch.io.camb import LinearData
from redtime_tpu_torch.io.params import ParamsFile
from redtime_tpu_torch.kernels import counts
from redtime_tpu_torch.kernels import out_block as ob
from redtime_tpu_torch.profiling import StageTimer, sync
from redtime_tpu_torch.state import (cosmo_from_numpy, linear_from_numpy,
                                     model_from_numpy)

F64 = torch.float64

prepare_model = mdl.prepare_model

# Chunk sizes on a GPU, full TRG and 1-loop/linear: the JAX package's
# accelerator defaults for these modes (redtime_tpu/driver.py:532-539);
# neither is tuned for the H100 yet.
DEFAULT_GPU_CHUNK_FULL = 16
DEFAULT_GPU_CHUNK = 32
# Lanes of the packed scheduler: the JAX package's default
# (redtime_tpu/driver.py:569); not tuned for the H100.
DEFAULT_LANES = 8


class RunResult(NamedTuple):
    """Tensors of a batched solver run (leading dimension B)."""

    k: torch.Tensor          # [B, nk]
    table: torch.Tensor      # [B, n_eta, nk, ncol] — printed column layout
    eta: torch.Tensor        # [B, n_eta] header scalars
    a: torch.Tensor
    z: torch.Tensor
    H: torch.Tensor          # H in h/Mpc units (reference prints H_H0*H0h)
    sigma_v2: torch.Tensor   # [B, n_eta]
    sigmaV2_z0: torch.Tensor  # [B]
    eta_fin: torch.Tensor    # [B]


def lane(res: RunResult, i: int) -> RunResult:
    """One cosmology's result out of a batch (for io.writer)."""
    return RunResult(*[x[i] for x in res])


def n_columns(cfg: SolverConfig, settings: RunSettings) -> int:
    n = 1
    if settings.print_lin:
        n += 6
    n += 3
    if cfg.print_a:
        n += 14
    if cfg.print_i:
        n += 14
    if settings.print_rsd and cfg.print_bias:
        n += 22
    if settings.print_rsd and not cfg.print_bias:
        n += 7
    if cfg.print_q:
        n += 24
    return n


def _check_settings(settings: RunSettings,
                    cfg: SolverConfig | None = None) -> None:
    z = np.asarray(settings.z_out, dtype=float)
    if z.size == 0:
        raise ValueError("z_out is empty")
    if np.any(np.diff(z) > 0):
        raise ValueError(
            f"z_out must be ordered from greatest to least (reference "
            f"params convention); got {list(settings.z_out)}")
    if z[0] > settings.z_in:
        raise ValueError(
            f"first output z={z[0]} precedes z_in={settings.z_in}")
    if cfg is not None:
        # growth-table range: the reference ABORTS on a outside
        # [growth_a_min, growth_a_max] (AU_cosmological_parameters.h:
        # 644-649); the table lookup would silently edge-extrapolate
        a_lo = 1.0 / (1.0 + settings.z_in)
        a_hi = 1.0 / (1.0 + float(z[-1]))
        if a_lo < cfg.growth_a_min or a_hi > cfg.growth_a_max:
            raise ValueError(
                f"a range [{a_lo:.3e}, {a_hi:.3e}] (z_in={settings.z_in}, "
                f"z_out min={z[-1]}) exceeds the growth table "
                f"[{cfg.growth_a_min}, {cfg.growth_a_max}] — the "
                f"reference aborts here; widen growth_a_min/max or "
                f"adjust z_in/z_out")


def build_output_block(cfg: SolverConfig, settings: RunSettings,
                       model: mdl.Model, y: torch.Tensor, z: float,
                       ec) -> torch.Tensor:
    """One output block [B, nk, ncol] at redshift z from the states
    y [B, 41, nk] (reference main output loop, redTime.cc:1646-1741), by
    the plain version of K11 (kernels.out_block.block_plain).

    1-loop mode recomputes the full mode coupling at the output time from
    the evolved spectra (reference :1646-1653).  Full-TRG mode leaves the
    PRINTA block and the PT/PMR columns at zero (the reference gates the
    recomputation on SWITCH_1LOOP, a documented output caveat reproduced
    here) unless cfg.fill_pt_full_trg opts into the recomputation."""
    lay = ob.layout_of(cfg, settings)
    k = _headers(cfg, settings, y.device)[0]
    mc = None
    if lay.mc:
        A_u, _, PT, PMR = trg.compute_mode_coupling_full(
            cfg, y[:, 0:3], model.cosmo.n_s, settings.print_rsd, k, ec)
        mc = A_u, PT, PMR
    return ob.block_plain(lay, y, k, model, float(z), settings.a_in, mc)


@functools.lru_cache(maxsize=32)
def _headers(cfg: SolverConfig, settings: RunSettings, device):
    """The header constants of a run's result on `device`, made once: k
    [nk], eta, a, z [n_z] and eta_fin (a CUDA graph cannot copy them from
    the host, and each copy is a transfer on the card)."""
    z = np.asarray(settings.z_out, dtype=np.float64)
    t = lambda x: torch.as_tensor(x, dtype=F64, device=device)
    return (t(make_grids(cfg).k), t(settings.etasteps()), t(1.0 / (1.0 + z)),
            t(z), t(np.log(1.0 / settings.a_in)))


def solve(cfg: SolverConfig, settings: RunSettings, model: mdl.Model,
          ec=None) -> RunResult:
    """Full evolution + output assembly for a prepared batch."""
    _check_settings(settings, cfg)
    if ec is None:
        ec = engine_consts(cfg, model.norm.device)
    return _solve(cfg, settings, model, ec)[0]


def _solve(cfg: SolverConfig, settings: RunSettings, model: mdl.Model,
           ec) -> tuple:
    """evolve + _finalize: (RunResult, each lane's controller attempts
    [B])."""
    ys, attempts = trg.evolve(cfg, settings, model, ec, return_stats=True)
    return _finalize(cfg, settings, model, ys, ec), attempts


def _finalize(cfg: SolverConfig, settings: RunSettings, model: mdl.Model,
              ys: torch.Tensor, ec) -> RunResult:
    """Output assembly from the evolved states [B, n_eta, 41, nk]: where
    the layout prints the mode coupling, one engine evaluation over the B
    n_eta lanes (K9, K10, K1, K2), then K11 out_block, which writes every
    redshift's block, sigma_v^2 and H (redtime_tpu/driver.py:240-268)."""
    B, S = ys.shape[:2]
    nk = ys.shape[3]
    lay = ob.layout_of(cfg, settings)
    k, eta, a, z, eta_fin = _headers(cfg, settings, ys.device)
    src = None
    if lay.mc:
        src = fastpt.compute_J_PZ(
            cfg, ys[:, :, 0:3].reshape(B * S, 3, nk), model.cosmo.n_s,
            settings.print_rsd, ec, n_rep=S)
    table, svs, Hs = ob.out_block(
        lay, ys, k, model, tuple(float(x) for x in settings.z_out),
        settings.a_in, src, ob.sv_weights(make_grids(cfg).k, cfg.kmin))
    return RunResult(
        k=k.expand(B, -1), table=table, eta=eta.expand(B, -1),
        a=a.expand(B, -1), z=z.expand(B, -1), H=Hs, sigma_v2=svs,
        sigmaV2_z0=model.sigmaV2_z0, eta_fin=eta_fin.expand(B))


def finite_report(res: RunResult) -> np.ndarray:
    """Indices of batch lanes with non-finite output (per-model fault
    isolation).  Checks the header scalars too.  One cosmology's result
    (run_pipeline's, no batch dimension) counts as lane 0."""
    nb = res.table.shape[0] if res.table.dim() == 4 else 1
    ok = None
    for x in (res.table, res.sigma_v2, res.H, res.sigmaV2_z0):
        lane_ok = torch.isfinite(x.reshape(nb, -1)).all(dim=1)
        ok = lane_ok if ok is None else ok & lane_ok
    return np.nonzero(~ok.cpu().numpy())[0]


def _batch_size(cs: CosmoParams) -> int:
    return int(np.asarray(cs.n_s.cpu() if hasattr(cs.n_s, "cpu")
                          else cs.n_s).shape[0])


def _host(x) -> np.ndarray:
    return np.array(x.cpu() if hasattr(x, "cpu") else x, dtype=np.float64)


def _take(x: np.ndarray, i0: int, size: int) -> np.ndarray:
    """Rows [i0, i0+size) of x, padded to `size` by repeating row i0."""
    part = x[i0:i0 + size]
    pad = size - part.shape[0]
    if pad:
        part = np.concatenate([part, np.repeat(part[:1], pad, axis=0)])
    return part


def _prepare_chunk(cfg: SolverConfig, chunk, device) -> mdl.Model:
    """prepare_model of one chunk (cs, lins, norm: numpy rows) on
    `device`."""
    cs, lin, nrm = chunk
    ccs = CosmoParams(*[torch.as_tensor(x, device=device) for x in cs])
    clin = linear_from_numpy(LinearData(*lin), device)
    return mdl.prepare_model(cfg, ccs, clin, norm_override=nrm)


def _prepare(cfg: SolverConfig, part, device, on_host: bool) -> mdl.Model:
    """_prepare_chunk of part on `device`, or, on_host, on the host CPU
    on one torch thread (prepare is some 700,000 small ops, which torch's
    thread pool slows down there) and then copied to `device`."""
    if on_host:
        with _torch_threads(1):
            return _on_device(_prepare_chunk(cfg, part, "cpu"), device)
    return _prepare_chunk(cfg, part, device)


def _on_device(m: mdl.Model, device: torch.device) -> mdl.Model:
    """A Model prepared on the host, on `device`: pinned host memory and
    copies that do not block the host."""
    if device.type != "cuda":
        return m
    to = lambda x: x.pin_memory().to(device, non_blocking=True)
    return mdl.Model(CosmoParams(*map(to, m.cosmo)), *map(to, m[1:]))


@contextlib.contextmanager
def _torch_threads(n: int):
    """torch's CPU thread count set to n inside the block."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def run_batch(cfg: SolverConfig, settings: RunSettings, cs: CosmoParams,
              lins: LinearData, device="cuda", max_chunk: int | None = None,
              norm_override=None, prepare_on_host: bool | None = None,
              timer: StageTimer | None = None, scheduler: str = "auto",
              n_lanes: int | None = None, devices=None) -> RunResult:
    """Batched pipeline on `device`: the card unless the caller asks for
    the CPU (device="cpu"); with no card a call without `device` raises.

    cs: CosmoParams with [B] fields; lins: LinearData with a leading batch
    dimension (numpy or tensors); norm_override: optional [B] P_lin
    normalization constants.

    scheduler: "chunked" (or "auto", which means chunked, as in the JAX
    package) or "packed" (the work queue, n_lanes lanes, default 8);
    "segmented" is not ported.  Chunked: max_chunk is the largest batch
    prepared and solved at once (default: the whole batch on the CPU; on
    a GPU 16 lanes in full-TRG mode, 32 otherwise); chunks are padded to
    equal size by repeating their first lane and the padding is dropped
    from the result.  Packed: the whole batch is prepared at once and
    max_chunk is the width of the output assembly's pieces.

    prepare_on_host: prepare on the host CPU, on one torch thread, and
    copy the Model to `device` (default: on the card, yes; on the CPU the
    placement is the same either way).  Chunked with host prepare and
    more than one chunk, a prepare worker process prepares chunk i+1
    while the caller launches chunk i's solve; the caller prepares chunks
    itself until the worker has started.  Prepare on the card
    (prepare_on_host=False) runs inline before each solve: the JAX
    package overlaps it only through asynchronous dispatch, and a child
    process cannot hand CUDA tensors over cheaply.

    devices: None runs in this process on `device`.  A sequence of
    devices (the JAX package's `mesh`; a device may appear more than once,
    as two workers on one card) runs one worker process per entry, and
    `device` is not used: the batch is padded to a multiple of nd =
    len(devices) by repeating its first lane and cut into nd contiguous
    shards; packed, each shard runs its own queue on min(n_lanes or 8,
    shard size) lanes; chunked, max_chunk counts lanes across all devices
    (rounded down to a multiple of nd), so each worker solves max_chunk //
    nd at a time.  The result, without the padding, is on devices[0]; the
    workers' kernel launches are added to `kernels.counts`.

    timer: a profiling.StageTimer that books "prepare" (the time the solve
    waited for a prepared chunk) and "solve" (with a timer, the device is
    synchronized after each solve) and, in its stats, each cosmology's
    controller attempts ("attempts"), the packed scheduler's loop
    iterations ("iterations") and, when a prepare worker ran, which
    process prepared each chunk ("prepared_by"), the worker's own prepare
    seconds ("prepare_worker_s"), the part of them the solve did not wait
    for ("prepare_hidden_s") and its start ("worker_start_s").  With
    devices, it books "start" (until every worker is ready) and "solve",
    "attempts" in batch order, "iterations" per shard (packed) and each
    shard's device, start, wall, stages and stats ("shards")."""
    _check_settings(settings, cfg)
    if scheduler == "segmented":
        raise ValueError("scheduler='segmented' is not ported: it works "
                         "around the TPU's dispatch-time limit (ROADMAP.md, "
                         "'Not ported, on purpose')")
    if scheduler not in ("auto", "chunked", "packed"):
        raise ValueError(f"unknown scheduler {scheduler!r}; choose "
                         "'auto', 'chunked', 'packed', or 'segmented'")
    timed = timer is not None
    timer = timer if timed else StageTimer(enabled=False)
    inputs = ([_host(x) for x in cs], [_host(x) for x in lins],
              None if norm_override is None else _host(norm_override))
    if devices is not None:
        return _run_batch_split(cfg, settings, inputs, list(devices),
                                max_chunk, prepare_on_host, timer, timed,
                                scheduler, n_lanes)
    device = device_of(device)
    n = _batch_size(cs)
    if max_chunk is None:
        max_chunk = _default_chunk(settings, device, n)
    if prepare_on_host is None:
        prepare_on_host = device.type != "cpu"
    ec = engine_consts(cfg, device)
    size = min(max_chunk, n)
    if scheduler == "packed":
        return _run_batch_packed(
            cfg, settings, inputs, device, ec, prepare_on_host, timer, timed,
            DEFAULT_LANES if n_lanes is None else n_lanes, size)
    return _run_batch_chunked(cfg, settings, inputs, device, ec, size,
                              prepare_on_host, timer, timed)


def _default_chunk(settings: RunSettings, device: torch.device,
                   n: int) -> int:
    """max_chunk's default: the whole batch on the CPU, on a GPU the JAX
    package's accelerator chunk for the mode."""
    if device.type == "cpu":
        return n
    if settings.nonlinear and not settings.one_loop:
        return DEFAULT_GPU_CHUNK_FULL
    return DEFAULT_GPU_CHUNK


def _run_batch_chunked(cfg: SolverConfig, settings: RunSettings, inputs,
                       device: torch.device, ec, size: int,
                       prepare_on_host: bool, timer: StageTimer,
                       timed: bool) -> RunResult:
    """The chunked scheduler over inputs (cs, lins, norm: numpy rows) in
    chunks of `size`: each chunk prepared, then solved.  With host prepare
    and more than one chunk, a prepare worker prepares chunk i+1 while
    chunk i's solve is launched (redtime_tpu/driver.py:520-531): whenever
    the worker is ready and holds no chunk, it is handed the next one,
    before the caller prepares a chunk itself and before each solve.  The
    caller prepares every chunk not handed over.  The worker's Model has
    the same bits as the caller's: the same code on one torch thread on
    the same host."""
    # imported here: `python -m redtime_tpu_torch.worker` runs the module
    # as __main__ after the package (and this module) is imported
    from redtime_tpu_torch import worker

    cs_np, lin_np, nrm_np = inputs
    n = cs_np[0].shape[0]
    chunks = [([_take(x, i0, size) for x in cs_np],
               [_take(x, i0, size) for x in lin_np],
               None if nrm_np is None else _take(nrm_np, i0, size))
              for i0 in range(0, n, size)]
    overlap = prepare_on_host and len(chunks) > 1
    outs, attempts, by = [], [], []
    waited = worker_s = 0.0
    with contextlib.ExitStack() as stack:
        helper = (stack.enter_context(worker.Worker("prepare worker"))
                  if overlap else None)
        held = None            # the chunk the worker is preparing

        def hand_over(i: int):
            if (overlap and held is None and i < len(chunks)
                    and helper.ready()):
                helper.send("prepare", cfg=cfg, chunk=chunks[i])
                return i
            return held

        for i, chunk in enumerate(chunks):
            with timer.stage("prepare"):
                if held != i:
                    held = hand_over(i + 1)
                    m = _prepare(cfg, chunk, device, prepare_on_host)
                    by.append("caller")
                else:
                    t0 = time.perf_counter()
                    m_np, secs = helper.receive()
                    m = _on_device(model_from_numpy(m_np), device)
                    waited += time.perf_counter() - t0
                    worker_s += secs
                    held = None
                    by.append("worker")
            counts.mark("prepare")
            held = hand_over(i + 1)
            with timer.stage("solve"):
                res, att = _solve(cfg, settings, m, ec)
                outs.append(res)
                attempts.append(att)
                if timed:
                    sync(outs[-1].table)
            counts.mark("solve")
    if timed:
        timer.stats["attempts"] = torch.cat(attempts)[:n].tolist()
        if overlap:
            timer.stats.update(
                prepared_by=by, prepare_worker_s=worker_s,
                prepare_hidden_s=max(0.0, worker_s - waited),
                worker_start_s=helper.start_s)
    return RunResult(*[torch.cat(xs, dim=0)[:n] for xs in zip(*outs)])


def _run_batch_split(cfg: SolverConfig, settings: RunSettings, inputs,
                     devices: list, max_chunk: int | None,
                     prepare_on_host: bool | None, timer: StageTimer,
                     timed: bool, scheduler: str,
                     n_lanes: int | None) -> RunResult:
    """run_batch over `devices`, one worker process a shard (the JAX
    package's mesh: redtime_tpu/driver.py:542-600 packed, 603-710
    chunked); see run_batch.  On the card the kernels are built here
    first, so the workers do not run nvcc at once."""
    from redtime_tpu_torch import worker

    if not devices:
        raise ValueError("devices is empty")
    devs = [device_of(d) for d in devices]
    nd = len(devs)
    cs_np, lin_np, nrm_np = inputs
    n = cs_np[0].shape[0]
    pad = (-n) % nd
    size = (n + pad) // nd
    grow = lambda x: np.concatenate([x, np.repeat(x[:1], pad, axis=0)])
    cs_np, lin_np = [grow(x) for x in cs_np], [grow(x) for x in lin_np]
    nrm_np = None if nrm_np is None else grow(nrm_np)
    if max_chunk is None:
        max_chunk = _default_chunk(settings, devs[0], n + pad)
    max_chunk = max_chunk - max_chunk % nd or nd
    kw = dict(max_chunk=max_chunk // nd, prepare_on_host=prepare_on_host,
              scheduler=scheduler)
    if scheduler == "packed":
        kw["n_lanes"] = min(n_lanes or DEFAULT_LANES, size)
    if any(d.type == "cuda" for d in devs):
        from redtime_tpu_torch.kernels import build

        build.build()
    part = lambda x, j: None if x is None else x[j * size:(j + 1) * size]
    with contextlib.ExitStack() as stack:
        with timer.stage("start"):
            workers = [stack.enter_context(
                worker.Worker(f"shard {j} of {nd} on {d}"))
                for j, d in enumerate(devs)]
            for w in workers:
                w.ready(None)
        with timer.stage("solve"):
            for j, (w, d) in enumerate(zip(workers, devs)):
                w.send("run", cfg=cfg, settings=settings,
                       inputs=([part(x, j) for x in cs_np],
                               [part(x, j) for x in lin_np],
                               part(nrm_np, j)),
                       device=str(d), threads=torch.get_num_threads(), **kw)
            answers = worker.gather(workers)
        for w in workers:          # let them all exit at once
            w.stop()
    for a in answers:
        counts.add(a["launches"], a["phases"])
    if timed:
        stats = [a["stats"] for a in answers]
        timer.stats["attempts"] = [x for s in stats
                                   for x in s["attempts"]][:n]
        if scheduler == "packed":
            timer.stats["iterations"] = [s["iterations"] for s in stats]
        timer.stats["shards"] = [
            dict(device=str(d), start_s=w.start_s, wall_s=a["wall_s"],
                 times=a["times"],
                 stats={k: v for k, v in a["stats"].items()
                        if k not in ("attempts", "iterations")})
            for d, w, a in zip(devs, workers, answers)]
    return RunResult(*[torch.as_tensor(np.concatenate(xs)[:n],
                                       device=devs[0])
                       for xs in zip(*[a["result"] for a in answers])])


def _run_batch_packed(cfg: SolverConfig, settings: RunSettings, inputs,
                      device: torch.device, ec, prepare_on_host: bool,
                      timer: StageTimer, timed: bool, n_lanes: int,
                      width: int) -> RunResult:
    """The packed scheduler (redtime_tpu/driver.py:542-600, without the
    mesh): every cosmology of inputs (cs, lins, norm: numpy rows)
    prepared at once and copied over once, one trg.evolve_packed on
    n_lanes lanes, then the output assembly in pieces of `width`
    cosmologies; timed: the caller's timer, synchronized after the
    solve, gets the stats."""
    with timer.stage("prepare"):
        models = _prepare(cfg, inputs, device, prepare_on_host)
    counts.mark("prepare")
    with timer.stage("solve"):
        ys, iters, attempts = trg.evolve_packed(
            cfg, settings, models, ec, n_lanes, return_iters=True,
            return_stats=True)
        n = models.batch
        parts = [_finalize(cfg, settings,
                           mdl.take_lanes(models, slice(i0, i0 + width)),
                           ys[i0:i0 + width], ec)
                 for i0 in range(0, n, width)]
        res = RunResult(*[torch.cat(xs, dim=0) for xs in zip(*parts)])
        if timed:
            sync(res.table)
    counts.mark("solve")
    if timed:
        timer.stats.update(iterations=iters, attempts=attempts.tolist())
    return res


def run_pipeline(cfg: SolverConfig, settings: RunSettings, c, lin,
                 device="cuda", prepare_on_host: bool | None = None,
                 norm_override=None) -> RunResult:
    """prepare_model + solve for one cosmology (the port of
    redtime_tpu/driver.py:453-492): c, CosmoParams of scalars; lin, one
    cosmology's LinearData (numpy or tensors); norm_override, an optional
    P_lin normalization constant.  On the card, prepare runs on the host
    CPU unless prepare_on_host is False, as in run_batch.  Returns one
    cosmology's RunResult (no batch dimension), as driver.lane gives it;
    the JAX function's `mode` and `use_jit` have no counterpart (the port
    runs the GEMM form, eagerly)."""
    nrm = None if norm_override is None else np.reshape(
        _host(norm_override), 1)
    res = run_batch(cfg, settings, cosmo_from_numpy(c), linear_from_numpy(
        lin), device=device, max_chunk=1, norm_override=nrm,
        prepare_on_host=prepare_on_host)
    return lane(res, 0)


def settings_from_params(p: ParamsFile) -> tuple[RunSettings, CosmoParams]:
    settings = RunSettings(
        nonlinear=bool(p.switch_nonlinear), one_loop=bool(p.switch_1loop),
        print_lin=bool(p.print_lin), print_rsd=bool(p.print_rsd),
        z_in=p.z_in, z_out=tuple(p.z_out))
    cosmo = CosmoParams.make(p.n_s, p.sigma_8, p.h, p.Omega_m, p.Omega_b,
                             p.Omega_nu, p.T_cmb, p.w0, p.wa)
    return settings, cosmo
