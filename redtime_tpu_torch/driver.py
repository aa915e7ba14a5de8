"""End-to-end solver driver: prepare -> evolve -> output tables.

`run_batch` is the entry point: a batch of cosmologies is cut into chunks
(the last one padded by repeating its first lane), each chunk is prepared
and then solved on `device` as one batch with one adaptive controller per
lane, and the chunks are concatenated — the JAX package's chunked
scheduler (redtime_tpu/driver.py:603-710) with the vmap written out as
the leading batch dimension.  `run_pipeline` runs one cosmology
(redtime_tpu/driver.py:453-492).

Prepare placement, as in the JAX package: on the card, each chunk is
prepared on the host CPU (`prepare_on_host`, the default there) and the
prepared `Model` is copied to the card; the solve runs on the card.
Prepare is some 700,000 small kernels a chunk, bound by launches on the
card and by per-op overhead on the host.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from redtime_tpu_torch import background as bg
from redtime_tpu_torch import interp
from redtime_tpu_torch import model as mdl
from redtime_tpu_torch import trg
from redtime_tpu_torch.config import H0H, CosmoParams, RunSettings, SolverConfig
from redtime_tpu_torch.fastpt import device_of, engine_consts
from redtime_tpu_torch.grids import make_grids
from redtime_tpu_torch.io.camb import LinearData
from redtime_tpu_torch.io.params import ParamsFile
from redtime_tpu_torch.kernels import counts
from redtime_tpu_torch.profiling import StageTimer, sync
from redtime_tpu_torch.state import cosmo_from_numpy, linear_from_numpy

F64 = torch.float64

prepare_model = mdl.prepare_model

# Chunk sizes on a GPU, full TRG and 1-loop/linear: the JAX package's
# accelerator defaults for these modes (redtime_tpu/driver.py:532-539);
# neither is tuned for the H100 yet.
DEFAULT_GPU_CHUNK_FULL = 16
DEFAULT_GPU_CHUNK = 32


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
    y [B, 41, nk] (reference main output loop, redTime.cc:1646-1741).

    1-loop mode recomputes the full mode coupling at the output time from
    the evolved spectra (reference :1646-1653).  Full-TRG mode leaves the
    PRINTA block and the PT/PMR columns at zero (the reference gates the
    recomputation on SWITCH_1LOOP, a documented output caveat reproduced
    here) unless cfg.fill_pt_full_trg opts into the recomputation."""
    g = make_grids(cfg)
    B = y.shape[0]
    dev = y.device
    k = torch.as_tensor(g.k, dtype=F64, device=dev)
    a = 1.0 / (1.0 + z)
    r = a / settings.a_in
    r2, r3, r4 = r * r, r ** 3, r ** 4
    cols = [k.expand(B, -1)]

    if settings.print_lin:
        D, dDda = mdl.growth_D_f(model, z)
        f = a * dDda / D
        _, Pcb, Pnu = mdl.plin_all(cfg, model, z)
        beta = mdl.beta_P_solver(model, a)
        b1 = mdl.beta_P_solver(model, 1.0)
        aL, aR = a * 0.999, min(1.0, a * 1.001)
        dlnB_num = (mdl.beta_P_solver(model, aR)
                    - mdl.beta_P_solver(model, aL)) / (aR - aL)
        dlnB = torch.where(model.f_nu[:, None] < 1e-10,
                           torch.zeros_like(dlnB_num),
                           (a / beta) * dlnB_num)
        cols += [D, f, Pcb, beta / (b1 + 1e-100), dlnB, Pnu]

    P = torch.exp(y[:, 0:3])
    cols += [P[:, 0] * r2, P[:, 1] * r2, P[:, 2] * r2]

    need_mc = settings.nonlinear and (
        settings.one_loop or cfg.fill_pt_full_trg) and (
        settings.print_rsd or cfg.print_a or cfg.print_bias)
    if need_mc:
        A_u, _, PTjm, PMR = trg.compute_mode_coupling_full(
            cfg, y[:, 0:3], model.cosmo.n_s, settings.print_rsd, k, ec)
        PT = trg._collapse_pt(PTjm)
    else:
        A_u = y.new_zeros((B, trg.NUI, g.nk))
        PTjm = y.new_zeros((B, 9, g.nk))
        PMR = y.new_zeros((B, 8, g.nk))
        PT = y.new_zeros((B, 4, g.nk))

    if cfg.print_a:
        cols += list(A_u.unbind(1))
    if cfg.print_i:
        cols += list(y[:, trg.NUP:trg.NUP + trg.NUI].unbind(1))

    if settings.print_rsd:
        pb = trg.pbis_j(cfg, y) * r3                     # [B, 5, nk]
        if cfg.print_bias:
            cols += list(pb.unbind(1))
            cols += [PTjm[:, n] * r4 for n in range(9)]
            cols += [PMR[:, n] * r4 for n in range(8)]
        else:
            cols += [pb[:, 0] + pb[:, 1], pb[:, 2] + pb[:, 3], pb[:, 4]]
            cols += [PT[:, n] * r4 for n in range(4)]

    if cfg.print_q:
        cols += [y[:, trg.NUP + trg.NUI + j] * r3 for j in range(trg.NUQ)]
    return torch.stack(cols, dim=2)


def solve(cfg: SolverConfig, settings: RunSettings, model: mdl.Model,
          ec=None) -> RunResult:
    """Full evolution + output assembly for a prepared batch."""
    _check_settings(settings, cfg)
    if ec is None:
        ec = engine_consts(cfg, model.norm.device)
    ys = trg.evolve(cfg, settings, model, ec)
    return _finalize(cfg, settings, model, ys, ec)


def _finalize(cfg: SolverConfig, settings: RunSettings, model: mdl.Model,
              ys: torch.Tensor, ec) -> RunResult:
    """Output assembly from the evolved states [B, n_eta, 41, nk]."""
    g = make_grids(cfg)
    B = model.batch
    dev = ys.device
    z_arr = np.asarray(settings.z_out, dtype=np.float64)
    a_arr = 1.0 / (1.0 + z_arr)
    table = torch.stack(
        [build_output_block(cfg, settings, model, ys[:, i], float(z), ec)
         for i, z in enumerate(z_arr)], dim=1)
    # the reference evaluates sigma_v^2 at the HARDCODED k = 1e-3
    # (AU_cosmological_parameters.h:963-970); on the default grid that is
    # exactly the first solver column
    wsv = (None if cfg.kmin == 1e-3 else torch.as_tensor(
        interp.weight_matrix_np(
            np.log(np.asarray(g.k)),
            np.asarray([np.log(np.clip(1e-3, g.k[0], g.k[-1]))]))[0],
        dtype=F64, device=dev))
    svs = torch.stack([mdl.sigma_v2(model, float(z), wsv) for z in z_arr],
                      dim=1)
    t = lambda x: torch.as_tensor(x, dtype=F64, device=dev)
    a_t = t(a_arr).expand(B, -1)
    Hs = bg.H_H0(model.cosmo, a_t) * H0H
    return RunResult(
        k=t(g.k).expand(B, -1), table=table,
        eta=t(settings.etasteps()).expand(B, -1), a=a_t,
        z=t(z_arr).expand(B, -1), H=Hs, sigma_v2=svs,
        sigmaV2_z0=model.sigmaV2_z0,
        eta_fin=t(np.log(1.0 / settings.a_in)).expand(B))


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
              timer: StageTimer | None = None) -> RunResult:
    """Batched pipeline on `device` (the chunked scheduler): the card
    unless the caller asks for the CPU (device="cpu"); with no card a
    call without `device` raises.

    cs: CosmoParams with [B] fields; lins: LinearData with a leading batch
    dimension (numpy or tensors); norm_override: optional [B] P_lin
    normalization constants.  max_chunk: the largest batch prepared and
    solved at once (default: the whole batch on the CPU; on a GPU 16
    lanes in full-TRG mode, 32 otherwise); chunks are padded to equal
    size by repeating their first lane and the padding is dropped from
    the result.

    prepare_on_host: prepare each chunk on the host CPU, on one torch
    thread, and copy it to `device` (default: on the card, yes; on the
    CPU the placement is the same either way).
    timer: a profiling.StageTimer that books "prepare" and "solve" (with
    a timer, the device is synchronized after each chunk's solve)."""
    _check_settings(settings, cfg)
    device = device_of(device)
    n = _batch_size(cs)
    if max_chunk is None:
        max_chunk = n if device.type == "cpu" else (
            DEFAULT_GPU_CHUNK_FULL if settings.nonlinear
            and not settings.one_loop else DEFAULT_GPU_CHUNK)
    if prepare_on_host is None:
        prepare_on_host = device.type != "cpu"
    timed = timer is not None
    timer = timer if timed else StageTimer(enabled=False)
    cs_np = [_host(x) for x in cs]
    lin_np = [_host(x) for x in lins]
    nrm_np = None if norm_override is None else _host(norm_override)
    ec = engine_consts(cfg, device)
    outs = []
    size = min(max_chunk, n)
    for i0 in range(0, n, size):
        with timer.stage("prepare"):
            chunk = ([_take(x, i0, size) for x in cs_np],
                     [_take(x, i0, size) for x in lin_np],
                     None if nrm_np is None else _take(nrm_np, i0, size))
            if prepare_on_host:
                # prepare is some 700,000 small ops, which torch's thread
                # pool slows down on the host
                with _torch_threads(1):
                    m = _on_device(_prepare_chunk(cfg, chunk, "cpu"), device)
            else:
                m = _prepare_chunk(cfg, chunk, device)
        counts.mark("prepare")
        with timer.stage("solve"):
            outs.append(solve(cfg, settings, m, ec))
            if timed:
                sync(outs[-1].table)
        counts.mark("solve")
    return RunResult(*[torch.cat(xs, dim=0)[:n] for xs in zip(*outs)])


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
