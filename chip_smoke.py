"""Smoke run of the PyTorch port (redtime_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card and nvcc.  It

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from redtime_tpu_torch/csrc with nvcc
     (sm_90a) and checks that K1's and K2's SASS holds FP64 tensor-core
     instructions (DMMA), K5's int8 mma.sync (IMMA) and K7's int8 wgmma
     (IGMMA), by cuobjdump;
  3. checks each hand kernel against its plain PyTorch version on the card
     at the main path's shapes (nk=128, np=512, 16 lanes, inputs from a
     seeded numpy generator; K3's rk_finish and rk_stage at each tableau
     and state size the main path runs them with, bit for bit, and on
     odd and ragged state sizes, a NaN lane, all lanes frozen and twice
     on the same inputs), with the tolerances stated below, and times
     it, its plain version and (where one exists) one PyTorch library
     call for the same function in turns: eager, and on the device alone
     (CUDA-graph replay); each row also carries the least time the card
     could take (bound_ms, by bytes or operations); then K1 and K2 at
     every shape the port uses and on grids with ragged K-steps
     (check_leg_shapes), and two calls of each must give the same bits;
     K3 also on lanes too large for a cluster's registers (in passes),
     and under both final-step rules (h > dt, the chunked scheduler's,
     and h >= dt, the packed one's) at the main path's three cases and
     at the presets' eta states (D = 41 nk at nk = 512, 256), all six
     outputs bit for bit, reached included; then K1, K2 and K3 at the
     shapes of
     the presets' phase (nk, np = 512, 2048 and 256, 2048; 2 lanes),
     checked and timed with their bounds (preset_rows);
  4. checks the probe kernels K4 affine, K5 int8_dot and K6 dd_mul
     against their plain versions on the card, bit for bit, at the
     probes' shapes, at one larger shape each and on ragged sizes, and
     times both, and an empty kernel beside them (the launch floor under
     the probes' small shapes); K7 oz_fused the same way at P4's shape,
     with its W pack (oz_pack_w, a row of its own) and with the L2
     flushed before each call too (cold_ms: its share of the bound is
     taken cold), on the tiling's edges (OZ_CASES) and on rows at the
     edges of the row exponent, with its registers, spills and shared
     memory; then
     runs redtime_tpu_torch.probes (probe1-probe4 and probe4_out_leg) on
     the card, with the launch counters reset just before and read just
     after, checks that K4-K7 and K7's pack (and K1, at probe4's shape)
     were launched,
     and times probe4's two paths in a loop as the JAX probe does;
  5. runs the main path: driver.run_batch over 16 cosmologies of the
     bench's Mira-Titan Latin-hypercube design, full Time-RG at
     SolverConfig() defaults, on the card, once untimed as set-up and
     once timed at the default placement (each chunk prepared on the
     host CPU, then solved on the card), then once more with
     prepare_on_host=False (prepared on the card), each with every
     launch counter reset just before it and read just after (split into
     run_batch's prepare and solve phases); checks that every table is
     finite, that the solve launched K1-K3 (rk_stage and rk_finish), that
     host prepare launched no kernel on the card and card prepare K3, and
     that lanes 0-1 match the JAX golden
     (tests/data/torch_port_golden_nk128.npz, written by
     scripts/gen_torch_port_golden.py) within 3e-5 of column scale, the
     linear columns and the sigma_v^2, H and sigmaV2(z=0) headers within
     1e-10 relative;
  6. runs 1-loop mode the same way (the bench's secondary workload):
     32 design cosmologies (one GPU chunk), SolverConfig(print_bias=True),
     the redshifts (5, 4, 3, 2, 1, 0.5, 0); the same checks against
     tests/data/torch_port_golden_oneloop_nk128.npz (gen_torch_port_golden
     --case oneloop), and the PT and PMR columns must be populated;
  7. runs full TRG over the bench's batch of 64 (4 chunks) and 1-loop
     over 64 (2 chunks of 32), each chunk prepared on the host: chunk 0
     by the caller, later ones by the prepare worker process
     (redtime_tpu_torch/worker.py) while the previous chunk is solved;
     lanes 0-1 against the goldens, with the wall, the time the solve
     waited for prepare and the prepare seconds hidden behind the solve;
  8. runs the packed scheduler (run_batch(scheduler="packed")): full TRG
     over the same 64 on 16 lanes and 1-loop over step 6's 32 on 8
     lanes, each against its golden and within the controller band (3e-5
     of column scale) of the chunked table on the same inputs, with its
     wall, prepare / solve split, iterations and attempts per cosmology;
     then the device split (run_batch(devices=...): every card, or the
     one card named twice, one worker process a shard of 32) over the
     full-TRG 64, chunked and packed (32 lanes a shard), against the
     golden and the in-process chunked table, with each shard's wall,
     each worker's start and the launches the workers sent back;
  9. runs the CLI (`batch` over 4 params files written with the port's
     io, `run` over one) at nk=128, against run_batch on the same inputs,
     `batch --scheduler packed --lanes 2` against
     run_batch(scheduler="packed", n_lanes=2), and `batch --shard`
     against the CLI's `batch` (byte-equal with one shard); then a
     device list naming a card the machine lacks, which must raise in
     this process with the worker's message and leave no worker;
 10. runs the presets at their full settings, SolverConfig.high_accuracy()
     and v01_compat(), 2 design lanes, 1-loop, z_out (1, 0), against
     their JAX goldens (tests/data/torch_port_golden_{high_accuracy,
     v01_compat}.npz, gen_torch_port_golden --case), with the same
     bounds; and full TRG at nk=48 (a grid whose K-steps end ragged in
     K1 and K2), against the port's own CPU run, and once more in chunks
     of one lane (whether a lane's bits depend on its chunk on the card:
     printed, not checked);
 11. runs the emulator-production chain (run_production): a 16-model
     Mira-Titan design through orchestrate.main with tests/mock_camb.py
     (two CAMB passes a model), its 33 CAMB redshifts as outputs, one CLI
     `batch --timing` on the card (full TRG, SolverConfig() defaults),
     the CLI's `convert` at the 8 HACC steps and `convert-full` at step
     499, emulator_check of each table against itself, and the injected
     rerun of lanes 0-1 (inject.load_injected, run_batch(norm_override)),
     against the JAX golden tests/data/torch_port_golden_production.npz
     (gen_torch_port_golden --case production); prints each stage's
     wall, cosmologies/min and attempts per cosmology;
 12. runs the off-by-default numerics (run_numerics: growth_dense and
     quad_impl='gl', 1-loop, 2 lanes, prepare on the card) against
     tests/data/torch_port_golden_numerics.npz (--case numerics);
 13. prints the kernels' JSON line, the card line and, last, the result.

Every path from step 4 on runs with the launch counters set to 0 just
before it and read just after, and must have launched K1-K3 (the probes:
K4-K7 and K1); a worker process's launches come back with its answer.

Any failed phase raises, and the script exits non-zero without a result.
It imports nothing of JAX.  Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "data", "torch_port_golden_nk128.npz")
GOLDEN_1L = os.path.join(HERE, "tests", "data",
                         "torch_port_golden_oneloop_nk128.npz")
# the presets' JAX goldens (scripts/gen_torch_port_golden.py --case):
# name -> (nk, path); 1-loop at Z_OUT_PRESETS
GOLDEN_PRESETS = {
    name: (nk, os.path.join(HERE, "tests", "data",
                            f"torch_port_golden_{name}.npz"))
    for name, nk in (("high_accuracy", 512), ("v01_compat", 256))}
Z_OUT_PRESETS = (1.0, 0.0)
DETAIL = os.path.join(HERE, "chiprun_out", "chip_smoke.json")
Z_OUT = (2.02, 1.61, 1.01, 0.66, 0.43, 0.24, 0.10, 0.0)
Z_OUT_1L = (5.0, 4.0, 3.0, 2.0, 1.0, 0.5, 0.0)
N_DESIGN, N_DESIGN_1L, SEED, B_CHECK = 16, 32, 42, 16
BATCH_BENCH = 64                      # the bench's batch (bench.py:65)
EPS = float(np.finfo(np.float64).eps)
# H100 SXM peaks (NVIDIA's data sheet, dense): HBM bytes/s; FP64 on the
# tensor cores, FP64 and FP32 outside them, int8 on the tensor cores
HBM_BYTES_S = 3.35e12
PEAK_FP64_TC, PEAK_FP64, PEAK_FP32, PEAK_INT8_TC = 67e12, 34e12, 67e12, \
    1979e12
MAIN_KERNELS = ("out_leg", "pz_leg", "rk_stage", "rk_finish")
# the production chain (run_production): a Latin-hypercube design of
# N_PROD Mira-Titan cosmologies (design.generate_design, seed SEED),
# tests/mock_camb.py as the CAMB binary, the 33 CAMB redshifts as the
# output list, convert at every HACC step and convert-full at
# PROD_STEP_FULL with N_PM PM realizations and one HACC spectrum a model
# (write_nbody_spectra, seed NBODY_SEED); its JAX golden is
# scripts/gen_torch_port_golden.py --case production
GOLDEN_PROD = os.path.join(HERE, "tests", "data",
                           "torch_port_golden_production.npz")
MOCK_CAMB = os.path.join(HERE, "tests", "mock_camb.py")
N_PROD, PROD_STEP_FULL, N_PM, NBODY_SEED = 16, 499, 16, 7
# the numerics run (run_numerics): 1-loop, growth_dense and quad_impl='gl'
# with prepare on the card; scripts/gen_torch_port_golden.py --case
# numerics
GOLDEN_NUMERICS = os.path.join(HERE, "tests", "data",
                               "torch_port_golden_numerics.npz")
NUMERICS = dict(growth_dense=True, quad_impl="gl")
PROBE_KERNELS = ("affine", "int8_dot", "dd_mul", "oz_pack_w", "oz_fused")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def example_linear():
    """The synthetic linear inputs of __graft_entry__._example_inputs (a
    smooth CDM-like transfer and a delta_nu/delta_c ratio stack)."""
    k = np.logspace(-5, 1.3, 600)
    keq = 0.015
    T = 1.0 / (1.0 + (k / keq) ** 2 * np.log(1.0 + k / keq))
    zs = np.array([200.0, 50.0, 10.0, 5.0, 2.0, 1.0, 0.5, 0.0])
    a = 1.0 / (1.0 + zs)
    ratio = 1.0 / (1.0 + (k[None, :] / 0.1) ** 2) * (0.3 + 0.7 * a[:, None])
    return np.log(k), T, T, a, k, ratio


def design_params(n: int = N_DESIGN, seed: int = SEED) -> np.ndarray:
    """[n, 9] cosmologies of the bench's design, mapped as bench.py does
    (physical densities omega divided by h^2, T_cmb = 2.726)."""
    from redtime_tpu_torch import design
    rows = design.models_from_unit_cube(design.latin_hypercube(n, seed=seed))
    om_m, om_b, s8, h, ns, w0, wa, om_nu = rows.T
    return np.stack([ns, s8, h, om_m / h ** 2, om_b / h ** 2,
                     om_nu / h ** 2, np.full(n, 2.726), w0, wa], axis=1)


# the redshifts of write_cli_inputs' transfer stacks (z = 0 is also the
# transfer file): >= 4 nodes for the cubic a-stencil, from z_in down
CLI_STACK_Z = ("200", "50", "10", "5", "2", "1", "0.5", "0")


def write_cli_inputs(workdir: str, params: np.ndarray, z_out,
                     one_loop: bool = False) -> list:
    """Write one params_redTime_M<i>.dat per row of params (design_params'
    columns) with a synthetic CAMB transfer stack beside it (7 columns:
    k, delta_c, delta_b, ..., delta_nu at column 5; example_linear's
    transfer, a neutrino suppression growing with a), with the port's own
    io; z_in 200, switches nonlinear, 1-loop as asked, print_lin and
    print_rsd on.  Returns the params paths."""
    from redtime_tpu_torch.io.params import ParamsFile, write_params_file

    k = np.logspace(-5, 1.3, 400)
    keq = 0.015
    T = 1.0 / (1.0 + (k / keq) ** 2 * np.log(1.0 + k / keq))
    paths = []
    for i, row in enumerate(params):
        name = f"M{i:03d}"
        os.makedirs(os.path.join(workdir, name), exist_ok=True)
        for z in CLI_STACK_Z:
            a = 1.0 / (1.0 + float(z))
            supp = 1.0 / (1.0 + (k / 0.1) ** 2) * (0.3 + 0.7 * a)
            np.savetxt(os.path.join(workdir, name, f"camb_transfer_z{z}.dat"),
                       np.column_stack([k, T, T, T, T, T * supp, T]),
                       fmt="%.17e")
        root = f"{name}/camb_transfer_z"
        path = os.path.join(workdir, f"params_redTime_{name}.dat")
        write_params_file(path, ParamsFile(
            *[float(x) for x in row], 1, int(one_loop), 1, 1, 200.0,
            [float(z) for z in z_out], root + "0.dat", 0, root,
            list(CLI_STACK_Z)))
        paths.append(path)
    return paths


def write_nbody_spectra(workdir: str, n_models: int,
                        step: int = PROD_STEP_FULL, n_pm: int = N_PM,
                        seed: int = NBODY_SEED) -> tuple:
    """Synthetic N-body spectra for convert-full, made with numpy from
    `seed`: per model 1..n_models, n_pm PM realizations of 64 rows and
    one HACC spectrum of 96 rows, each '#'-headed (k [h/Mpc], P, counts),
    a smooth P(k) with 2% scatter and mode counts growing as k^2.
    Returns the (PM, HACC) path templates convert_pk_full takes."""
    rng = np.random.default_rng(seed)
    pm_t = os.path.join(workdir, "M{model:03d}_PM{pm:03d}.pk.{step}")
    hacc_t = os.path.join(workdir, "M{model:03d}_HACC.pk.{step}")

    def spectrum(path, n):
        k = np.linspace(2e-3, 1.4, n)
        P = 2e4 * (k / 0.02) / (1.0 + (k / 0.02) ** 2.6) * (
            1.0 + 0.02 * rng.standard_normal(n))
        counts = 10.0 + 1e4 * k * k * (1.0 + rng.random(n))
        np.savetxt(path, np.column_stack([k, P, counts]),
                   header="k P counts")

    for mn in range(1, n_models + 1):
        for pm in range(n_pm):
            spectrum(pm_t.format(model=mn, pm=pm, step=step), 64)
        spectrum(hacc_t.format(model=mn, step=step), 96)
    return pm_t, hacc_t


def read_headers(path: str) -> tuple:
    """(H [n_z], sigma_v^2 [n_z], sigmaV2(z=0)) from the '###' header
    lines of a redTime-format table."""
    H, sv2, sv2_z0 = [], [], None
    with open(path) as f:
        for line in f:
            if line.startswith("###main:"):
                sv2_z0 = float(line.split("sigmaV2(z=0) =")[1])
            elif line.startswith("### main: output at"):
                fields = dict(kv.strip().split("=") for kv in
                              line.split("output at", 1)[1].split(","))
                H.append(float(fields["H"]))
                sv2.append(float(fields["sigma_v^2"]))
    return np.asarray(H), np.asarray(sv2), sv2_z0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Eager time of fn() in ms: CUDA events over `iters` back-to-back
    calls, so the wrapper's host path (checks, allocation, launch) is in
    it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of fn() in ms, without the host path: `calls` calls
    captured in one CUDA graph, replayed `replays` times between CUDA
    events.  The warm-up runs before the capture, on a side stream, so
    builds, compiles and cuBLAS's workspace happen outside it; the
    wrappers launch on the current stream, which is the capture stream."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def cold_ms(fn, calls: int = 21, flush_mb: int = 256) -> tuple:
    """Device time of fn() in ms with the L2 cache cold: one call captured
    in a CUDA graph, replayed between CUDA events right after a write of
    flush_mb MB (it evicts the card's 50 MB L2, and lasts long enough that
    the host has queued the replay before the device reaches it).  Returns
    the median over `calls` replays and every reading."""
    import torch
    flush = torch.empty(flush_mb * 2 ** 18, dtype=torch.float32,
                        device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(calls):
        flush.fill_(1.0)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), times


def measure(kernel, plain, library=None, rounds: int = 3) -> tuple:
    """The kernel, its plain version and the library call timed in turns
    (kernel, plain, library; `rounds` times), each eager (time_ms) and
    on the device (graph_ms).  Returns the medians as row fields and the
    readings of every round.  The inputs stay where the caller made them,
    so constants (G, T_sl) are warm in L2 as on the main path."""
    fns = dict(kernel=kernel, plain=plain)
    if library is not None:
        fns["library"] = library
    runs = {f"{k}_{how}": [] for k in fns for how in ("ms", "device_ms")}
    for _ in range(rounds):
        for k, fn in fns.items():
            runs[f"{k}_ms"].append(time_ms(fn))
            runs[f"{k}_device_ms"].append(graph_ms(fn))
    med = {k: float(np.median(v)) for k, v in runs.items()}
    return dict(ms=med["kernel_ms"], device_ms=med["kernel_device_ms"],
                plain_ms=med["plain_ms"],
                plain_device_ms=med["plain_device_ms"],
                library_ms=med.get("library_device_ms"),
                library_eager_ms=med.get("library_ms")), runs


def least_time(nbytes: float, ops: float, peak: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over `peak` (one of PEAK_*)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / peak
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=nbytes, bound_ops=ops)


def rk_cases(cfg) -> list:
    """(case, tableau, D, eabs, erel) of every kind of K3 launch on the
    main path: prepare's growth ramp (one [2] state per lane) and its
    node-stopped DOPRI5 segments (a [2] state per k node), both at eabs 0
    and the growth rtol, then the eta evolution (RKF45 on the full-TRG
    state, D = 41 nk)."""
    from redtime_tpu_torch import model
    n_k = len(model.growth_nodes(cfg)[1])
    return [("growth ramp", cfg.growth_ramp_tableau.upper(), 2, 0.0,
             cfg.growth_rtol),
            ("growth segments", "DOPRI5", 2 * n_k, 0.0, cfg.growth_rtol),
            ("eta", "RKF45", 41 * cfg.nk, cfg.eabs_P, cfg.erel_P)]


# K3 on lanes that eight blocks cannot keep in registers (the kernel
# loops over its slices): the eta state at nk = 1024 (D = 41984, 16-byte
# accesses) and an odd D above 16384 (nk = 401, 8-byte accesses)
RK_PASSES = [("eta nk=1024, in passes", "RKF45", 41 * 1024, 1e-7, 1e-2),
             ("odd D in passes", "DOP853", 41 * 401, 1e-7, 1e-2)]
PASSES_CASES = {case for case, *_ in RK_PASSES}


def rk_inputs(rng, tab, B: int, D: int, eabs: float, dev) -> list:
    """One attempt's (y, ks, t, h, t1, n, active) from the generator."""
    import torch

    t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    # eabs 0 divides by erel |y_new|: keep the state away from 0, as the
    # growth state (D a_early / a, dD/da a_early) is
    y = t(rng.standard_normal((B, D)) if eabs > 0
          else rng.uniform(0.5, 2.0, (B, D)))
    ks = t(rng.standard_normal((len(tab.c), B, D)))
    tt = t(rng.uniform(0.0, 1.0, B))
    t1 = tt + t(rng.uniform(0.05, 0.5, B))
    # h spans rejection (large), acceptance and the final clip to t1
    h = t(10.0 ** rng.uniform(-9.0, 0.0, B))
    n = torch.arange(B, dtype=torch.int64, device=dev)
    active = torch.as_tensor(rng.uniform(size=B) < 0.8, device=dev)
    return [y, ks, tt, h, t1, n, active]


def final_rule_lanes(args) -> list:
    """rk_inputs' attempt with two lanes the final-step rule tells apart,
    both active and with steps small enough to be accepted: lane 0 steps
    exactly onto t1 (h == t1 - t: final under h >= dt, not under h > dt);
    lane 1 steps just short of t1 where t + h rounds onto t1 (h < t1 - t:
    final under neither rule, and t_out lands on t1 all the same)."""
    y, ks, t, h, t1, n, active = [x.clone() for x in args]
    t[0], t[1] = 0.25, 3.0
    t1[0] = t[0] + 2.0 ** -40
    t1[1] = t[1] + 4 * float(np.spacing(3.0))
    h[0] = t1[0] - t[0]
    h[1] = float(np.nextafter(float(t1[1] - t[1]), 0.0))
    active[:2] = True
    return [y, ks, t, h, t1, n, active]


# rk_finish's outputs, in order
K3_OUTPUTS = ("y", "t", "h", "n", "r", "reached")


def rk_finish_cost(y, ks) -> dict:
    """least_time of one rk_finish: y, ks, t, h, t1, n, active, b, e and
    prm in; y, t, h, n, r and reached out; 2 s + 4 flops an element."""
    s, (B, D) = ks.shape[0], y.shape
    return least_time(8.0 * (2 * B * D + s * B * D + 8 * B + 2 * s + 9)
                      + 2 * B, 2.0 * B * D * (2 * s + 4), PEAK_FP64)


def same_bits(a, b) -> bool:
    """torch.equal, with NaNs in the same places counted as equal."""
    return a.shape == b.shape and bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


def check_rk_finish(rng, cfg, dev) -> list:
    """K3's rk_finish against its plain version on one attempt of each
    rk_cases entry, of an odd D (8-byte accesses, eight a thread) and of
    a D whose blocks end ragged: y, t, h, n, r and the accept/reject
    masks bit for bit, reached included (the kernel rounds every
    operation alone, as the plain version does, and CUDA's pow, which r
    and h go through, is the routine torch.pow runs).  Each case must
    reject some lanes and accept others; then the same inputs a second time (the same bits), with a
    NaN in one lane's stages (r is NaN there, as torch.amax gives it, the
    other lanes untouched) and with every lane frozen (the state comes
    back as it went in)."""
    import torch

    from redtime_tpu_torch import ode
    from redtime_tpu_torch.kernels import rk_finish as k3

    B = B_CHECK
    cases = rk_cases(cfg) + [
        ("odd D", "DOP853", 41 * cfg.nk - 1, cfg.eabs_P, cfg.erel_P),
        ("ragged D", "DOPRI5", 3000, cfg.eabs_P, cfg.erel_P)] + RK_PASSES
    out_cases = []
    for case, tname, D, eabs, erel in cases:
        tab = getattr(ode, tname)
        consts = k3.attempt_consts(tab, eabs, erel, dev)
        args = rk_inputs(rng, tab, B, D, eabs, dev)
        plain = lambda a: k3.rk_finish_plain(*a, consts.b, consts.e,
                                             consts.prm)
        out, ref = k3.rk_finish(*args, consts), plain(args)
        what = f"rk_finish {case}"
        for x, want, name in zip(out, ref, K3_OUTPUTS):
            check(bool(torch.equal(x, want)),
                  f"{what}: {name} not bit-equal to plain")
        rej = ref[4] > k3.REJECT_ABOVE
        check(bool(torch.equal(out[4] > k3.REJECT_ABOVE, rej)),
              f"{what}: accept/reject masks differ")
        check(0 < int(rej.sum()) < B,
              f"{what}: inputs must both accept and reject lanes")
        for x, again in zip(out, k3.rk_finish(*args, consts)):
            check(bool(torch.equal(x, again)),
                  f"{what}: two calls on the same inputs differ")
        poisoned = list(args)
        poisoned[1] = args[1].clone()
        poisoned[1][len(tab.c) // 2, 1, D // 2] = float("nan")
        got, want = k3.rk_finish(*poisoned, consts), plain(poisoned)
        check(bool(got[4][1].isnan()) and bool(want[4][1].isnan()),
              f"{what}: a NaN stage must give a NaN r")
        frozen = args[:6] + [torch.zeros_like(args[6])]
        still = k3.rk_finish(*frozen, consts)
        for x, a, b in zip(got + still, want + plain(frozen),
                           K3_OUTPUTS * 2):
            check(same_bits(x, a), f"{what}: {b} differs from plain with a "
                                   "NaN lane or with every lane frozen")
        for i, j in ((0, 0), (1, 2), (2, 3), (3, 5)):
            check(bool(torch.equal(still[i], args[j])),
                  f"{what}: a frozen lane moved")
        cl, vec = k3.cluster_plan(D, True)
        check(k3.in_passes(D, cl, vec) == (case in PASSES_CASES),
              f"{what}: in passes or not, against the plan")
        out_cases.append(dict(
            case=case, tableau=tname, D=D, eabs=eabs, erel=erel,
            cluster=cl, bytes_per_access=16 if vec else 8,
            in_passes=k3.in_passes(D, cl, vec),
            max_abs_err=float((out[0] - ref[0]).abs().max()),
            rejected=int(rej.sum()), args=args, consts=consts))
    return out_cases


# the presets' eta states (SolverConfig.high_accuracy / v01_compat: RKF45
# at eabs 1e-15, erel 1e-6), where the packed scheduler also runs K3
RK_PRESETS = [("eta high_accuracy", "RKF45", 41 * 512, 1e-15, 1e-6),
              ("eta v01_compat", "RKF45", 41 * 256, 1e-15, 1e-6)]


def check_rk_final_rule(rng, cfg, dev) -> list:
    """K3's rk_finish under both final-step rules (h > dt, the chunked
    scheduler's; h >= dt, the packed one's) on final_rule_lanes' attempt
    at each rk_cases entry and at RK_PRESETS: all six outputs bit-equal
    to plain, reached included; reached set under h >= dt alone in lane
    0, and in neither rule in lane 1, whose t lands on t1 all the same.
    Each case timed under h >= dt.  Returns the cases."""
    import torch

    from redtime_tpu_torch import ode
    from redtime_tpu_torch.kernels import rk_finish as k3

    out_cases = []
    for case, tname, D, eabs, erel in rk_cases(cfg) + RK_PRESETS:
        tab = getattr(ode, tname)
        args = final_rule_lanes(rk_inputs(rng, tab, B_CHECK, D, eabs, dev))
        reached, err = {}, 0.0
        for ge in (False, True):
            consts = k3.attempt_consts(tab, eabs, erel, dev,
                                       final_at_equal=ge)
            out = k3.rk_finish(*args, consts)
            ref = k3.rk_finish_plain(*args, consts.b, consts.e, consts.prm,
                                     ge)
            what = f"rk_finish {case}, {'h >= dt' if ge else 'h > dt'}"
            for x, want, name in zip(out, ref, K3_OUTPUTS):
                check(bool(torch.equal(x, want)),
                      f"{what}: {name} not bit-equal to plain")
            check(float(out[1][1]) == float(args[4][1])
                  and not bool(out[5][1]),
                  f"{what}: lane 1 must land on t1 without reaching it")
            err = max(err, float((out[0] - ref[0]).abs().max()))
            reached[ge] = out[5]
        check(bool(reached[True][0]) and not bool(reached[False][0]),
              f"rk_finish {case}: lane 0 reaches t1 under h >= dt alone")
        row = dict(case=case, tableau=tname, D=D, eabs=eabs, erel=erel,
                   rule="h >= dt", max_abs_err=err,
                   reached=int(reached[True].sum()))
        row.update(measure(
            lambda: k3.rk_finish(*args, consts),
            lambda: k3.rk_finish_plain(*args, consts.b, consts.e, consts.prm,
                                       True))[0])
        row.update(rk_finish_cost(args[0], args[1]))
        out_cases.append(row)
        print(f"rk_finish {case} ({tname}, D={D}) under both final-step "
              f"rules: all six outputs bit-equal to plain; h >= dt "
              f"{row['ms']:.4f} ms eager, {row['device_ms']:.4f} ms device "
              f"(plain {row['plain_ms']:.4f} / {row['plain_device_ms']:.4f};"
              f" bound {row['bound_ms']:.5f})")
    return out_cases


def preset_rows(rng, detail: dict) -> dict:
    """K1, K2 and K3 at the presets' shapes as their phase runs them (2
    lanes, chunked): K1 and K2 on SolverConfig.high_accuracy()'s and
    v01_compat()'s engine constants (leg_rows), K3's rk_finish and
    rk_stage (stage 5) on their eta states (RKF45, D = 41 nk), bit-equal
    to plain; each timed, with its bound.  Returns {kernel: {preset:
    row}}."""
    import torch

    from redtime_tpu_torch import ode
    from redtime_tpu_torch.config import SolverConfig
    from redtime_tpu_torch.kernels import rk_finish as k3

    dev = torch.device("cuda")
    out: dict = {}
    keep = ("ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
            "bound_ms", "bound_by", "max_abs_err")
    for name in GOLDEN_PRESETS:
        cfg = getattr(SolverConfig, name)()
        B = 2
        for r in leg_rows(rng, cfg, B, detail, f"_{name}"):
            out.setdefault(r["name"], {})[name] = dict(
                {k: r[k] for k in keep}, B=B, nk=cfg.nk, np=cfg.npts)
        consts = k3.attempt_consts(ode.RKF45, cfg.eabs_P, cfg.erel_P, dev)
        args = rk_inputs(rng, ode.RKF45, B, 41 * cfg.nk, cfg.eabs_P, dev)
        got = k3.rk_finish(*args, consts)
        want = k3.rk_finish_plain(*args, consts.b, consts.e, consts.prm)
        for x, w, label in zip(got, want, K3_OUTPUTS):
            check(bool(torch.equal(x, w)), f"rk_finish at {name}'s eta "
                                           f"state: {label} not bit-equal")
        t, _ = measure(lambda: k3.rk_finish(*args, consts),
                       lambda: k3.rk_finish_plain(*args, consts.b, consts.e,
                                                  consts.prm))
        out.setdefault("rk_finish", {})[name] = dict(
            t, **rk_finish_cost(args[0], args[1]), max_abs_err=0.0, B=B,
            D=41 * cfg.nk)
        y, ks, h = args[0], args[1], args[3]
        i, D = 5, y.shape[1]
        check(bool(torch.equal(k3.rk_stage(y, ks, h, consts, i),
                               k3.rk_stage_plain(y, ks, h, consts.a[i], i))),
              f"rk_stage at {name}'s eta state: not bit-equal")
        t, _ = measure(lambda: k3.rk_stage(y, ks, h, consts, i),
                       lambda: k3.rk_stage_plain(y, ks, h, consts.a[i], i))
        out.setdefault("rk_stage", {})[name] = dict(
            t, **least_time(8.0 * ((i + 2) * B * D + B + i),
                            (2.0 * i + 1.0) * B * D, PEAK_FP64),
            max_abs_err=0.0, B=B, D=D)
        for kernel, by in out.items():
            r = by[name]
            print(f"{kernel} at {name}'s shape (B={B}): {r['ms']:.4f} ms "
                  f"eager, {r['device_ms']:.4f} ms device (plain "
                  f"{r['plain_ms']:.4f} / {r['plain_device_ms']:.4f}; "
                  f"library {r['library_ms']}; bound {r['bound_ms']:.5f} by "
                  f"{r['bound_by']})")
    detail["preset_shapes"] = out
    return out


def check_rk_stage(rng, cfg, dev, detail: dict) -> dict:
    """K3's rk_stage against its plain version, bit for bit, at every
    stage index of the three tableaux and every state size of rk_cases
    plus an odd one; timed at the eta case's stage 5 (RKF45's last).
    Returns its row for the kernels' line."""
    import torch

    from redtime_tpu_torch import ode
    from redtime_tpu_torch.kernels import rk_finish as k3

    B = B_CHECK
    sizes = [D for _, _, D, _, _ in rk_cases(cfg)] + [41 * cfg.nk - 1] + [
        D for _, _, D, _, _ in RK_PASSES]
    n_checked, err = 0, 0.0
    for tname in ("RKF45", "DOPRI5", "DOP853"):
        tab = getattr(ode, tname)
        consts = k3.attempt_consts(tab, 0.0, 0.0, dev)
        for D in sizes:
            y, ks, _, h = rk_inputs(rng, tab, B, D, 1.0, dev)[:4]
            for i in range(1, len(tab.c)):
                out = k3.rk_stage(y, ks, h, consts, i)
                ref = k3.rk_stage_plain(y, ks, h, consts.a[i], i)
                err = max(err, float((out - ref).abs().max()))
                check(bool(torch.equal(out, ref)),
                      f"rk_stage {tname} D={D} stage {i}: not bit-equal to "
                      "plain")
                n_checked += 1
    i, D = 5, sizes[2]
    consts = k3.attempt_consts(ode.RKF45, 0.0, 0.0, dev)
    y, ks, _, h = rk_inputs(rng, ode.RKF45, B, D, 1.0, dev)[:4]
    a_row = consts.a[i]
    timing, runs = measure(lambda: k3.rk_stage(y, ks, h, consts, i),
                           lambda: k3.rk_stage_plain(y, ks, h, a_row, i))
    detail["rk_stage_timing"] = runs
    print(f"rk_stage: bit-equal to plain at {n_checked} (tableau, D, stage) "
          f"cases; RKF45 stage {i} at D={D}: {timing['ms']:.4f} ms eager, "
          f"{timing['device_ms']:.4f} ms device")
    # y, the i rows, h and a's row in; the stage input out
    return dict(
        name="rk_stage", route="cuda",
        source="redtime_tpu_torch/csrc/rk_attempt.cu",
        replaces="redtime_tpu/ode.py:130", max_abs_err=err, **timing,
        **least_time(8.0 * ((i + 2) * B * D + B + i),
                     (2.0 * i + 1.0) * B * D, PEAK_FP64))


def leg_rows(rng, cfg, B: int, detail: dict, tag: str = "") -> list:
    """K1 and K2 on cfg's engine constants at B lanes, against their
    plain versions: within the dot product's forward-error bound, the
    same bits over two calls; timed with the library call beside them.
    Returns their rows for the kernels' line (detail keys end in tag)."""
    import torch

    from redtime_tpu_torch import fastpt
    from redtime_tpu_torch.kernels import out_leg as k1
    from redtime_tpu_torch.kernels import pz_leg as k2

    dev = torch.device("cuda")
    ec = fastpt.engine_consts(cfg, dev)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    nk, npts = cfg.nk, cfg.npts
    K = 2 * npts
    rows = []

    # K1: |delta| <= 2K eps (|prod| @ |G|) elementwise (the forward-error
    # bound of a K-term f64 dot product, with margin 2)
    tab = t(rng.standard_normal((B, 2, fastpt.NFAM, 3, K)))
    J = k1.out_leg(tab, ec.G)
    J_ref = k1.out_leg_plain(tab, ec.G)
    prod = tab[:, 0, :, :, None, :] * tab[:, 1, :, None, :, :] / K
    bound = 2 * K * EPS * torch.matmul(
        prod.abs().reshape(B, fastpt.NFAM, 9, K), ec.G.abs()).reshape(
            J.shape)
    err = (J - J_ref).abs()
    check(bool(torch.isfinite(J).all()), f"out_leg{tag}: non-finite output")
    check(bool(torch.equal(J, k1.out_leg(tab, ec.G))),
          f"out_leg{tag}: two calls on the same inputs differ")
    check(bool((err <= bound).all()),
          f"out_leg{tag}: max |delta|/bound {float((err / bound).max()):.3g}")
    nfam, O = fastpt.NFAM, ec.G.shape[-1]
    # the library yardstick: one batched DGEMM on the pair product,
    # materialized outside the timed region
    prod_mat = prod.permute(1, 0, 2, 3, 4).reshape(nfam, 9 * B, K) \
        .contiguous()
    t_k1, runs = measure(lambda: k1.out_leg(tab, ec.G),
                         lambda: k1.out_leg_plain(tab, ec.G),
                         lambda: torch.bmm(prod_mat, ec.G))
    detail[f"out_leg_timing{tag}"] = runs
    rows.append(dict(
        name="out_leg", route="cuda",
        source="redtime_tpu_torch/csrc/out_leg.cu",
        replaces="redtime_tpu/fastpt.py:1228",
        max_abs_err=float(err.max()), **t_k1,
        **least_time(8.0 * (tab.numel() + nfam * K * O + J.numel()),
                2.0 * nfam * 9 * B * K * O, PEAK_FP64_TC)))

    # K2 on engine-shaped spectra: |delta| <= 2np eps (|T_sl| @ |P_e|)
    # |kfac P_e| (the dot product's forward-error bound; a max-relative
    # bound is wrong here, the contraction cancels ~1e8 per element)
    g_lnk = np.log(np.logspace(np.log10(cfg.kmin), np.log10(cfg.kmax), nk))
    lnP = (8.0 - 1.5 * (g_lnk + 2.0) ** 2 / 4.0)[None, None, :] \
        + 0.05 * rng.standard_normal((B, 3, nk))
    P_e = fastpt.extend_power(cfg, t(lnP), t(np.full(B, 0.96)), ec)
    PZ = k2.pz_leg(ec.toeplitz_sl, P_e, ec.pz_kfac_sl, cfg.nshift)
    PZ_ref = k2.pz_leg_plain(ec.toeplitz_sl, P_e, ec.pz_kfac_sl,
                                  cfg.nshift)
    sl = slice(cfg.nshift, cfg.nshift + nk)
    dot_abs = torch.einsum("nim,bam->bnai", ec.toeplitz_sl.abs(), P_e.abs())
    bound = (2 * npts * EPS * dot_abs[:, :, :, None, :]
             * (ec.pz_kfac_sl * P_e[:, None, None, :, sl]).abs())
    err = (PZ - PZ_ref).abs()
    check(bool(torch.isfinite(PZ).all()), f"pz_leg{tag}: non-finite output")
    check(bool(torch.equal(PZ, k2.pz_leg(ec.toeplitz_sl, P_e, ec.pz_kfac_sl,
                                         cfg.nshift))),
          f"pz_leg{tag}: two calls on the same inputs differ")
    check(bool((err <= bound).all()),
          f"pz_leg{tag}: max |delta|/bound "
          f"{float((err / bound.clamp(min=1e-300)).max()):.3g}")
    T2, P2 = ec.toeplitz_sl.view(7 * nk, npts), P_e.view(3 * B, npts)
    t_k2, runs = measure(
        lambda: k2.pz_leg(ec.toeplitz_sl, P_e, ec.pz_kfac_sl, cfg.nshift),
        lambda: k2.pz_leg_plain(ec.toeplitz_sl, P_e, ec.pz_kfac_sl,
                                cfg.nshift),
        lambda: torch.matmul(T2, P2.T))
    detail[f"pz_leg_timing{tag}"] = runs
    rows.append(dict(
        name="pz_leg", route="cuda",
        source="redtime_tpu_torch/csrc/pz_leg.cu",
        replaces="redtime_tpu/fastpt.py:1310",
        max_abs_err=float(err.max()), **t_k2,
        **least_time(8.0 * (T2.numel() + P2.numel() + nk + PZ.numel()),
                2.0 * 7 * nk * 3 * B * npts, PEAK_FP64_TC)))
    return rows


def check_kernels(rng, detail: dict) -> list:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from redtime_tpu_torch.config import SolverConfig
    from redtime_tpu_torch.kernels import rk_finish as k3

    dev = torch.device("cuda")
    cfg = SolverConfig()
    B = B_CHECK
    rows = leg_rows(rng, cfg, B, detail)

    # K3 rk_finish at each tableau the main path runs it with (rk_cases)
    # and in passes (the grids of nk > 799); its row is the eta case, the
    # one the evolution runs
    k3_cases = check_rk_finish(np.random.default_rng(5678), cfg, dev)
    timed_cases = {case for case, *_ in rk_cases(cfg)} | PASSES_CASES
    calls = {}
    for c in k3_cases:
        args, consts = c.pop("args"), c.pop("consts")
        if c["case"] not in timed_cases:
            continue
        calls[c["case"]] = (*args, consts)
        c.update(measure(
            lambda: k3.rk_finish(*args, consts),
            lambda: k3.rk_finish_plain(*args, consts.b, consts.e,
                                       consts.prm))[0])
        c.update(rk_finish_cost(args[0], args[1]))
        print(f"rk_finish {c['case']} ({c['tableau']}, D={c['D']}, "
              f"{c['cluster']} blocks a lane): "
              f"{c['ms']:.4f} ms eager, {c['device_ms']:.4f} ms device "
              f"(plain {c['plain_ms']:.4f} / {c['plain_device_ms']:.4f}), "
              f"all six outputs bit-equal to plain, {c['rejected']}/{B} lanes "
              "rejected")
    eta = next(c for c in k3_cases if c["case"] == "eta")
    # the eta case with the lane split over fewer blocks than the wrapper
    # chooses (one block cannot hold a lane of 41 nk)
    eta["device_ms_by_cluster"] = {
        cl: graph_ms(lambda: k3._launch_finish(*calls["eta"], cl, True))
        for cl in (2, 4, 8)}
    print(f"rk_finish eta by blocks a lane: {eta['device_ms_by_cluster']} "
          "ms device")
    # under the packed scheduler's final-step rule too
    rule_cases = check_rk_final_rule(np.random.default_rng(9753), cfg, dev)
    eta_ge = next(c for c in rule_cases if c["case"] == "eta")
    rows.append(dict(
        name="rk_finish", route="cuda",
        source="redtime_tpu_torch/csrc/rk_attempt.cu",
        replaces="redtime_tpu/ode.py:161",
        also_replaces="redtime_tpu/trg.py:440 (the packed lane attempt)",
        final_rules="h > dt (chunked) and h >= dt (packed): both bit-equal "
                    "to plain, reached included",
        max_abs_err=max(c["max_abs_err"] for c in k3_cases + rule_cases),
        packed_rule_device_ms=eta_ge["device_ms"],
        **{k: eta[k] for k in ("ms", "device_ms", "plain_ms",
                               "plain_device_ms", "library_ms", "bound_ms",
                               "bound_by", "bound_bytes", "bound_ops")}))
    detail["rk_finish_cases"] = k3_cases
    detail["rk_finish_final_rule_cases"] = rule_cases
    rows.append(check_rk_stage(np.random.default_rng(8765), cfg, dev,
                               detail))
    return rows


# the tensor-core instruction each kernel's SASS must hold: FP64 (DMMA)
# for K1 and K2, int8 mma.sync (IMMA) for K5, int8 wgmma (IGMMA, the
# opcode of K7's wgmma m64n64k32 s8 in the SASS of its first build) for
# K7's main kernel as it runs (oz_fused_kernel<0>, mangled ...ILi0E; the
# other instantiations are rt_oz_fused_ablate's measurement variants)
TENSOR_CORE_OPS = {"out_leg_kernel": "DMMA", "pz_leg_kernel": "DMMA",
                   "int8_dot_kernel": "IMMA",
                   "oz_fused_kernelILi0E": "IGMMA"}


def check_tensor_cores(lib, detail: dict) -> None:
    """K1 and K2 run on the FP64 tensor cores, K5 and K7 on the int8 ones:
    their SASS (cuobjdump -sass of the built library) holds DMMA, IMMA
    (K5's mma.sync) and IGMMA (K7's wgmma) instructions."""
    from redtime_tpu_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        for kernel, op in TENSOR_CORE_OPS.items():
            if kernel in name:
                counts[kernel] = counts.get(kernel, 0) + part.count(op)
    for kernel, op in TENSOR_CORE_OPS.items():
        check(counts.get(kernel, 0) > 0, f"{kernel}: no {op} in its SASS")
    print(f"tensor cores: DMMA / IMMA / IGMMA instructions in the SASS "
          f"{counts}")
    detail["tensor_core_ops_in_sass"] = counts


# (nk, np) of grids whose K is no multiple of K1's or K2's K-steps, or
# whose 2np is no power of two: nk = 16, 48, 96 at np = 4nk, np_factor 8
# at nk = 128, an odd nk
RAGGED_GRIDS = ((16, 64), (48, 192), (96, 384), (128, 1024), (37, 148))


def check_leg_shapes(rng, detail: dict) -> None:
    """K1 and K2 against their plain versions at every shape the port
    uses, within the forward-error bounds of check_kernels, and bit-equal
    over two calls: K1 at B in (1, 3, 16, 33), 7 and 14 families, 2np in
    (1024, 4096) and O in (129, 257, 513), and at (2np, nk + 1) of each
    of RAGGED_GRIDS, G padded as engine_consts pads it; K2 at the same B
    on the default, v0.1 and HIGH_ACCURACY grids (nk, np) = (128, 512),
    (256, 2048), (512, 2048) and on RAGGED_GRIDS."""
    import torch

    from redtime_tpu_torch.kernels import out_leg as k1
    from redtime_tpu_torch.kernels import pz_leg as k2

    t = lambda x: torch.as_tensor(x, dtype=torch.float64, device="cuda")
    cases = []
    for B in (1, 3, 16, 33):
        for nfam in (7, 14):
            ko = [(K, O) for K in (1024, 4096) for O in (129, 257, 513)] \
                + [(2 * npts, nk + 1) for nk, npts in RAGGED_GRIDS]
            for K, O in ko:
                tab = t(rng.standard_normal((B, 2, nfam, 3, K)))
                G = k1.padded(t(rng.standard_normal((nfam, K, O))))
                J = k1.out_leg(tab, G)
                prod = tab[:, 0, :, :, None, :] \
                    * tab[:, 1, :, None, :, :] / K
                bound = 2 * K * EPS * torch.matmul(
                    prod.abs().reshape(B, nfam, 9, K), G.abs())
                ratio = float(((J - k1.out_leg_plain(tab, G)).abs()
                               .reshape(bound.shape) / bound).max())
                what = f"out_leg at B={B} nfam={nfam} K={K} O={O}"
                check(ratio <= 1.0, f"{what}: |delta|/bound {ratio:.3g}")
                check(bool(torch.equal(J, k1.out_leg(tab, G))),
                      f"{what}: two calls differ")
                cases.append(dict(kernel="out_leg", B=B, nfam=nfam, K=K,
                                  O=O, err_over_bound=ratio))
        for nk, npts in ((128, 512), (256, 2048), (512, 2048)) \
                + RAGGED_GRIDS:
            T = t(rng.standard_normal((7, nk, npts)))
            P = t(np.exp(rng.standard_normal((B, 3, npts))))
            kfac = t(rng.standard_normal(nk))
            nshift = (npts - nk) // 2
            PZ = k2.pz_leg(T, P, kfac, nshift)
            dot = torch.einsum("nim,bam->bnai", T.abs(), P.abs())
            bound = (2 * npts * EPS * dot[:, :, :, None, :]
                     * (kfac * P[:, None, None, :, nshift:nshift + nk]).abs())
            ratio = float(((PZ - k2.pz_leg_plain(T, P, kfac, nshift)).abs()
                           / bound.clamp(min=1e-300)).max())
            what = f"pz_leg at B={B} nk={nk} np={npts}"
            check(ratio <= 1.0, f"{what}: |delta|/bound {ratio:.3g}")
            check(bool(torch.equal(PZ, k2.pz_leg(T, P, kfac, nshift))),
                  f"{what}: two calls differ")
            cases.append(dict(kernel="pz_leg", B=B, nk=nk, np=npts,
                              err_over_bound=ratio))
    worst = {k: max(c["err_over_bound"] for c in cases if c["kernel"] == k)
             for k in ("out_leg", "pz_leg")}
    print(f"kernel shapes: out_leg at {sum(c['kernel'] == 'out_leg' for c in cases)}"
          f" shapes and pz_leg at {sum(c['kernel'] == 'pz_leg' for c in cases)}"
          f" within their bounds (worst |delta|/bound {worst}) and "
          "bit-equal over two calls")
    detail["leg_shape_cases"] = cases


def check_probe_kernels(rng, detail: dict) -> list:
    """K4-K6 against their plain versions on the card, bit for bit: at
    the probes' shapes (timed), at one larger shape each (timed) and on
    ragged sizes; then K7 (check_oz_fused)."""
    import torch

    from redtime_tpu_torch import dd
    from redtime_tpu_torch.kernels import build
    from redtime_tpu_torch.kernels import probes as kp

    dev = torch.device("cuda")

    def f32(n):
        return torch.as_tensor((rng.standard_normal(n) * np.exp(
            rng.uniform(-8, 8, n))).astype(np.float32), device=dev)

    def dd_args(n):
        x = rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n))
        y = rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n))
        return (*dd.from_f64(torch.as_tensor(x, device=dev)),
                *dd.from_f64(torch.as_tensor(y, device=dev)))

    def int8(shape):
        return torch.as_tensor(rng.integers(-128, 128, shape).astype(np.int8),
                               device=dev)

    def dot_args(m, k, n):
        return int8((m, k)), int8((k, n))

    def cost_affine(n):
        return 8.0 * n, 2.0 * n, PEAK_FP32

    def cost_dot(s):
        m, k, n = s
        return float(m * k + k * n + 4 * m * n), 2.0 * m * k * n, PEAK_INT8_TC

    def cost_dd(n):
        # 4 f32 in, 2 out; dd.mul is 24 f32 operations an element
        return 24.0 * n, 24.0 * n, PEAK_FP32

    def lib_affine(x):
        ones = torch.ones_like(x)
        return lambda: torch.add(ones, x, alpha=2)

    # (kernel, plain, library call or None, make args, cost, probe size,
    # large size, ragged sizes)
    specs = [
        ("affine", "scripts/probe_pallas.py:29", kp.affine, kp.affine_plain,
         lib_affine, lambda n: (f32(n),), cost_affine, 8 * 128, 2 ** 20,
         [1, 1000, 2 ** 20 + 3]),
        ("int8_dot", "scripts/probe_pallas.py:44", kp.int8_dot,
         kp.int8_dot_plain, lambda a, b: lambda: torch._int_mm(a, b),
         lambda s: dot_args(*s), cost_dot, (128, 512, 256),
         (2016, 1024, 256),
         [(1, 1, 1), (67, 130, 33), (129, 1023, 257), (67, 1000, 33)]),
        ("dd_mul", "scripts/probe_pallas.py:78", kp.dd_mul, kp.dd_mul_plain,
         None, dd_args, cost_dd, 8 * 128, 2 ** 20, [1, 1000, 2 ** 20 + 7]),
    ]
    # an empty kernel under the same protocol: what a launch costs on the
    # card, the floor under the probes' [8, 128] shapes
    stream = torch.cuda.current_stream
    floor = float(np.median([graph_ms(lambda: build.check(
        build.lib().rt_launch_floor(stream().cuda_stream), "launch_floor"))
        for _ in range(3)]))
    detail["launch_floor_ms"] = floor
    print(f"launch floor: an empty kernel takes {floor:.5f} ms on the "
          "device")
    rows, cases = [], []
    for (name, replaces, kern, plain, lib, make, cost, probe, large,
         ragged) in specs:
        timed, err = {}, 0.0
        for size in [probe, large] + ragged:
            args = make(size)
            out, ref = kern(*args), plain(*args)
            out = out if isinstance(out, tuple) else (out,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            for o, r in zip(out, ref):
                check(o.dtype == r.dtype and o.shape == r.shape,
                      f"{name} at {size}: dtype or shape")
                delta = float((o.double() - r.double()).abs().max())
                err = max(err, delta)
                check(bool(torch.equal(o, r)),
                      f"{name} at {size}: not bit-equal to plain, max "
                      f"|delta| {delta:.3g}")
            if size in (probe, large):
                t, runs = measure(lambda: kern(*args), lambda: plain(*args),
                                  lib(*args) if lib else None)
                timed[size] = dict(t, **least_time(*cost(size)))
                detail[f"{name}_timing_{size}"] = runs
            cases.append(dict(kernel=name, size=str(size)))
        big = timed[large]
        print(f"kernel {name}: bit-equal to plain at {probe}, {large} and "
              f"{ragged}; at {large}: {big['ms']:.4f} ms eager, "
              f"{big['device_ms']:.4f} ms device (plain {big['plain_ms']:.4f}"
              f" / {big['plain_device_ms']:.4f} ms)")
        rows.append(dict(
            name=name, route="cuda",
            source="redtime_tpu_torch/csrc/probes.cu", replaces=replaces,
            max_abs_err=err, **timed[probe], launch_floor_ms=floor,
            large_shape=str(large),
            **{f"large_{k}": v for k, v in big.items()}))
    detail["probe_kernel_cases"] = cases
    # K5's tile and split of K at each shape (rt_int8_dot_plan)
    plan = (ctypes.c_int * 2)()
    detail["int8_dot_plans"] = {}
    for m, k, n in [(128, 512, 256), (2016, 1024, 256)] + specs[1][-1]:
        build.lib().rt_int8_dot_plan(m, n, k, plan)
        detail["int8_dot_plans"][str((m, k, n))] = dict(tile=plan[0],
                                                      split=plan[1])
    print(f"int8_dot plans at (M, K, N): {detail['int8_dot_plans']}")
    rows += check_oz_fused(rng, detail)
    return rows


def oz_edge_rows(x: np.ndarray, rng) -> np.ndarray:
    """x with rows 0-4 at the edges of P4's row exponent exi = clip(
    floor(log2 max|xh|) + 2, -125, 125): a zero row (max 0 meets the 1e-38
    floor, exi -125, the lower clip bound); a row with max|x| 1.5 2^123
    (exi 125, the upper bound, unclipped) and one with 1.5 2^124 (126,
    clipped to 125; its first slice still fits int8); a row of normal
    values in [2^-126, 1.5 2^-126] (exi -124, the nearest a normal row
    gets to the lower bound); and a row of subnormal f32 values (max
    about 2^-128, exi clipped from -126)."""
    x = x.copy()
    K = x.shape[1]
    x[0] = 0.0
    for row, top in ((1, 1.5 * 2.0 ** 123), (2, 1.5 * 2.0 ** 124)):
        x[row] *= top / np.abs(x[row]).max()
    x[3] = np.sign(x[3]) * rng.uniform(1.0, 1.5, K) * 2.0 ** -126
    x[4] *= 2.0 ** -128 / np.abs(x[4]).max()
    return x


# K7's cases beyond P4's inputs and its edge rows, (M, K, O): the earlier
# ragged ones (M not a multiple of the 64-row tile, K % 4 != 0 on the
# plain x loads, O odd on the scalar stores), then the tiling's edges: one
# row and a ragged last tile at P4's K and O, K below one round of the
# peelers and below one K-step, O of 8 (three ranks of the tile have no
# columns) and above one tile (264, 520: a second and third group of
# columns), K over one x panel (the row maxima from global memory)
OZ_CASES = ((77, 1000, 100), (300, 999, 129), (1, 1024, 256),
            (2017, 1024, 256), (70, 4, 64), (70, 40, 264), (33, 1024, 8),
            (130, 520, 520), (70, 3000, 72))


def ptxas_of(log: str, kernel: str) -> str:
    """The `-Xptxas -v` lines (registers, spills) of the first kernel whose
    mangled name holds `kernel`, from the build log."""
    for block in log.split("ptxas info    : Compiling entry function")[1:]:
        if kernel in block.split("\n", 1)[0]:
            lines = [ln.replace("ptxas info    :", "").strip()
                     for ln in block.splitlines()[1:4]
                     if "registers" in ln or "spill" in ln]
            return "; ".join(lines)
    return "not in the build log"


def check_oz_fused(rng, detail: dict) -> list:
    """K7 against its plain versions on the card, bit for bit: the W pack
    against oz_pack_w_plain, and the whole call against oz_fused_plain in
    oh and ol, at P4's shape with probe4's inputs (timed warm, and with
    the L2 flushed before each call: cold_ms), with the rows of
    oz_edge_rows, and at OZ_CASES; the tiling the kernel computes
    (rt_oz_fused_plan) against oz_plan at every case.  Returns the rows of
    the pack kernel and of the main kernel for the kernels' line."""
    import torch

    from redtime_tpu_torch import dd, probes
    from redtime_tpu_torch.kernels import build
    from redtime_tpu_torch.kernels import probes as kp

    def split(x, ws):
        xh, xl = dd.from_f64(torch.as_tensor(x, device="cuda"))
        return xh, xl, torch.as_tensor(ws, device="cuda")

    def ragged(m, k, o):
        return split(rng.standard_normal((m, k)),
                     rng.integers(-64, 64, (4, k, o)).astype(np.int8))

    x, xh, xl, ws = probes.probe4_inputs("cuda")
    M, K = xh.shape
    O = ws.shape[2]
    cases = [("P4", (xh, xl, ws)),
             ("edge rows", split(oz_edge_rows(x.cpu().numpy(), rng),
                                 ws.cpu().numpy()))]
    cases += [(f"ragged {s}", ragged(*s)) for s in OZ_CASES]
    err = 0.0
    for case, args in cases:
        wp = kp.oz_pack_w(args[2])
        check(bool(torch.equal(wp, kp.oz_pack_w_plain(args[2]))),
              f"oz_pack_w {case}: not bit-equal to plain")
        m, k, o = args[0].shape[0], args[0].shape[1], args[2].shape[2]
        on_card = kp.oz_plan_on_card(m, k, o)
        check(all(on_card[key] == v for key, v in kp.oz_plan(m, k, o).items()),
              f"oz_fused {case}: rt_oz_fused_plan {on_card} differs from "
              f"oz_plan")
        out, ref = kp.oz_fused(*args), kp.oz_fused_plain(*args)
        for got, want, name in zip(out, ref, ("oh", "ol")):
            check(got.dtype == want.dtype and got.shape == want.shape,
                  f"oz_fused {case}: {name} dtype or shape")
            delta = float((got.double() - want.double()).abs().max())
            err = max(err, delta)
            check(bool(torch.equal(got, want)),
                  f"oz_fused {case}: {name} not bit-equal to plain, max "
                  f"|delta| {delta:.3g}")
    edge = cases[1][1]
    exi = kp._oz_row_exponent(edge[0])[:5, 0].tolist()
    check(exi == [-125, 125, 125, -124, -125],
          f"oz_fused edge rows: exponents {exi}")
    plan = kp.oz_plan_on_card(M, K, O)
    log = build.BUILD_LOG.get("output", "")
    ptxas = {name: ptxas_of(log, mangled) for name, mangled in
             (("oz_pack_w", "oz_pack_w_kernel"),
              ("oz_fused", "oz_fused_kernelILi0E"))}
    print(f"oz_fused at P4's shape: {plan['threads']} threads, "
          f"{plan['smem_bytes']} bytes of dynamic shared memory, "
          f"{plan['row_tiles'] * plan['col_groups'] * 4} CTAs; ptxas "
          f"{ptxas}")
    t, runs = measure(lambda: kp.oz_fused(xh, xl, ws),
                      lambda: kp.oz_fused_plain(xh, xl, ws))
    cold, cold_runs = cold_ms(lambda: kp.oz_fused(xh, xl, ws))
    tp, runs_p = measure(lambda: kp.oz_pack_w(ws),
                         lambda: kp.oz_pack_w_plain(ws))
    detail.update(oz_fused_timing=runs, oz_fused_cold_ms=cold_runs,
                  oz_pack_w_timing=runs_p, oz_fused_plan=plan,
                  oz_fused_ptxas=ptxas,
                  oz_fused_cases=[c for c, _ in cases])
    # xh, xl and W read once, oh and ol written once; six int8 dots
    bound = least_time(float(2 * 4 * M * K + 4 * K * O + 2 * 4 * M * O),
                       6.0 * 2.0 * M * K * O, PEAK_INT8_TC)
    # the pack: W read once, the packed W written once
    bound_p = least_time(float(4 * K * O + plan["wp_bytes"]), 0.0,
                         PEAK_INT8_TC)
    print(f"kernel oz_fused: bit-equal to plain in oh and ol (and the pack "
          f"to oz_pack_w_plain) at {[c for c, _ in cases]}; at P4's shape "
          f"{t['ms']:.4f} ms eager, {t['device_ms']:.5f} ms device warm, "
          f"{cold:.5f} ms device with the L2 cold (plain {t['plain_ms']:.4f}"
          f" / {t['plain_device_ms']:.4f} ms); bound {bound['bound_ms']:.5f}"
          f" ms, share {bound['bound_ms'] / cold:.3f} of it cold; the pack "
          f"{tp['device_ms']:.5f} ms device")
    common = dict(route="cuda", source="redtime_tpu_torch/csrc/oz_fused.cu",
                  replaces="scripts/probe_pallas.py:145")
    return [dict(name="oz_pack_w", max_abs_err=0.0, **common, **tp,
                 **bound_p),
            dict(name="oz_fused", max_abs_err=err, **common, **t,
                 cold_device_ms=cold, warm_device_ms=t["device_ms"],
                 share=bound["bound_ms"] / cold, **bound)]


def run_probes(detail: dict) -> dict:
    """redtime_tpu_torch.probes' PROBES on the card; returns the
    launch counts of that run."""
    import torch

    from redtime_tpu_torch import probes
    from redtime_tpu_torch.kernels import counts

    counts.reset()
    out = {}
    for p in probes.PROBES:
        out[p.__name__] = p("cuda")
    torch.cuda.synchronize()
    launches = counts.snapshot()
    for name in PROBE_KERNELS + ("out_leg",):
        check(launches[name] > 0, f"kernel {name} was not launched by the "
                                  "probes")
    inloop = probes.probe4_inloop()
    detail["probes"] = dict(results=out, launches=launches,
                            probe4_inloop=inloop)
    print(f"probes: {', '.join(out)} OK on the card {out}; launches "
          f"{launches}; probe4 in-loop {inloop}")
    return launches


def design_inputs(n: int, params: np.ndarray | None = None):
    """(CosmoParams, LinearData) of n design cosmologies (design_params,
    or the rows of `params`) with example_linear's inputs, as numpy-backed
    CPU tensors and arrays: run_batch cuts and places them itself."""
    import torch

    from redtime_tpu_torch.config import CosmoParams
    from redtime_tpu_torch.io.camb import LinearData

    params = design_params(n) if params is None else params
    cs = CosmoParams(*[torch.as_tensor(params[:, i]) for i in range(9)])
    lins = LinearData(*[np.stack([x] * len(params))
                        for x in example_linear()])
    return cs, lins


def golden_dev(res, gold: dict, what: str) -> tuple:
    """Lanes 0-1 of res against the JAX golden: (column-scale deviation,
    linear columns' relative deviation); raises past 3e-5 / 1e-10 or when
    sigma_v^2, H or sigmaV2_z0 leave 1e-10 relative."""
    table = res.table[:2].cpu().numpy()
    ref = gold["table"]
    check(table.shape == ref.shape, f"{what}: table shape {table.shape}")
    scale = np.max(np.abs(ref), axis=(0, 2), keepdims=True) + 1e-300
    dev_col = float(np.max(np.abs(table - ref) / scale))
    dev_lin = float(np.max(np.abs(table[..., :7] - ref[..., :7])
                           / (np.abs(ref[..., :7]) + 1e-300)))
    check(dev_col <= 3e-5, f"{what}: lanes 0-1 vs golden {dev_col:.3g} of "
                           "column scale (bound 3e-5)")
    check(dev_lin <= 1e-10, f"{what}: linear columns vs golden "
                            f"{dev_lin:.3g} relative (bound 1e-10)")
    for name in ("sigma_v2", "H", "sigmaV2_z0"):
        got = getattr(res, name)[:2].cpu().numpy()
        rel = float(np.max(np.abs(got - gold[name]) / np.abs(gold[name])))
        check(rel <= 1e-10, f"{what}: {name} vs golden {rel:.3g} relative "
                            "(bound 1e-10)")
    return dev_col, dev_lin


def load_golden(golden: str, params: np.ndarray, settings, what: str):
    gold = dict(np.load(golden))
    check(np.array_equal(gold["params"], params[:2])
          and np.array_equal(gold["z_out"], np.asarray(settings.z_out)),
          f"{what}: design lanes 0-1 or z_out differ from the golden's")
    for name, x in zip(("t_lnk", "t_Tc", "t_Tb", "beta_a", "beta_k",
                        "beta_raw"), example_linear()):
        check(np.array_equal(gold[name], x),
              f"{what}: linear input {name} differs from the golden's")
    return gold


def spread(xs) -> str:
    """min / median / max of a list of counts."""
    return f"{min(xs)} / {float(np.median(xs)):g} / {max(xs)}"


def band_dev(got, ref) -> float:
    """max |got - ref| over the column scale of ref (its max |.| over
    lanes and k), the controller band's measure (bound 3e-5)."""
    scale = np.max(np.abs(ref), axis=(0, 2), keepdims=True) + 1e-300
    return float(np.max(np.abs(got - ref) / scale))


def timed_run(what: str, cfg, settings, cs, lins, detail: dict, **kw):
    """One run_batch on the card with every launch counter set to 0 just
    before it and read just after; checks that every lane is finite, that
    the launches by phase add up and that the solve launched K1-K3; with
    host prepare (the default) that prepare launched none of them, with
    card prepare that it ran K3.  kw goes to run_batch.  Returns (result,
    launches with by_phase, wall seconds, the run's StageTimer: its
    stages' times and its stats, attempts per cosmology and, packed,
    iterations)."""
    import torch

    from redtime_tpu_torch import driver
    from redtime_tpu_torch.kernels import counts
    from redtime_tpu_torch.profiling import StageTimer

    timer = StageTimer(enabled=False)
    counts.reset()
    t0 = time.perf_counter()
    res = driver.run_batch(cfg, settings, cs, lins, device="cuda",
                           timer=timer, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts.snapshot()
    by_phase = counts.phases()
    for name, total in launches.items():
        check(sum(p[name] for p in by_phase.values()) == total,
              f"{what}: {name}'s launches by phase do not add up")
    bad = driver.finite_report(res)
    check(len(bad) == 0, f"{what}: non-finite lanes {list(bad)}")
    for name in MAIN_KERNELS:
        check(by_phase["solve"][name] > 0,
              f"{what}: kernel {name} was not launched in the solve")
    k3_prep = by_phase["prepare"]["rk_stage"] + \
        by_phase["prepare"]["rk_finish"]
    if kw.get("prepare_on_host", True):
        check(k3_prep == 0 and by_phase["prepare"]["out_leg"] == 0,
              f"{what}: host prepare launched kernels on the card "
              f"{by_phase['prepare']}")
    else:
        check(k3_prep > 0, f"{what}: card prepare launched no K3")
    return res, dict(launches, by_phase=by_phase), wall, timer


def run_path(what: str, cfg, settings, n_design: int, golden: str,
             detail: dict, card: str):
    """n_design design cosmologies through run_batch on the card at the
    default placement (prepare on the host), once untimed (set-up: cuBLAS
    and allocator first use) and once timed, held to the JAX golden of
    lanes 0-1; then the same chunk once more with prepare on the card
    (prepare_on_host=False), held to the golden too.  Returns the default
    run's result and the launch counts of each run (by phase under
    "by_phase"), keyed what and what_card_prepare."""
    import torch

    from redtime_tpu_torch import driver, fastpt

    params = design_params(n_design)
    gold = load_golden(golden, params, settings, what)
    cs, lins = design_inputs(n_design)
    t0 = time.perf_counter()
    fastpt.engine_consts(cfg, "cuda")
    driver.run_batch(cfg, settings, cs, lins, device="cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    print(f"{what} set-up: engine constants and one untimed run_batch of "
          f"the same chunk {setup:.3f} s")

    out, launches = {}, {}
    for key, kw in ((what, {}),
                    (f"{what}_card_prepare", dict(prepare_on_host=False))):
        res, launches[key], wall, timer = timed_run(key, cfg, settings, cs,
                                                    lins, detail, **kw)
        times = dict(timer.times)
        dev_col, dev_lin = golden_dev(res, gold, key)
        per_min = n_design / wall * 60.0
        detail[key] = dict(setup_s=setup, wall_s=wall, cosmologies=n_design,
                           cosmologies_per_min=per_min, stages_s=times,
                           golden_dev_col_scale=dev_col,
                           golden_dev_linear_rel=dev_lin,
                           launches=launches[key])
        print(f"{key} path on {card}: {n_design} cosmologies, nk={cfg.nk}, "
              f"prepare on the {'card' if kw else 'host'}: {wall:.3f} s = "
              f"{per_min:.2f} cosmologies/min (stages {times}); lanes 0-1 "
              f"vs JAX golden {dev_col:.3g} of column scale, linear "
              f"{dev_lin:.3g}; launches by phase {launches[key]['by_phase']}")
        out.setdefault("res", res)
    return out["res"], launches


def run_main_path(detail: dict, card: str) -> dict:
    """Full Time-RG, the bench's headline workload: its PT columns print
    zero (the reference's output caveat).  Returns the launch counts."""
    from redtime_tpu_torch.config import RunSettings, SolverConfig

    res, launches = run_path(
        "full_trg", SolverConfig(),
        RunSettings(one_loop=False, z_out=Z_OUT), N_DESIGN, GOLDEN, detail,
        card)
    check(bool(np.all(res.table[..., 13:17].cpu().numpy() == 0.0)),
          "full-TRG PT columns must be zero")
    return launches


def run_oneloop(detail: dict, card: str) -> tuple:
    """1-loop mode with the PRINTBIAS columns, the bench's secondary
    workload: k | 6 lin | 3 P | 5 P_B | 9 PT | 8 PMR.  Returns the launch
    counts and the default placement's result."""
    from redtime_tpu_torch.config import RunSettings, SolverConfig

    res, launches = run_path(
        "oneloop", SolverConfig(print_bias=True),
        RunSettings(one_loop=True, z_out=Z_OUT_1L), N_DESIGN_1L, GOLDEN_1L,
        detail, card)
    pt = res.table[..., 15:32].cpu().numpy()
    check(bool(np.all(np.any(pt != 0.0, axis=2))),
          "1-loop PT and PMR columns must be populated")
    return launches, res


def bench_params(n_golden: int) -> np.ndarray:
    """The bench's batch (bench.py:65): 64 cosmologies of the design
    latin_hypercube(64, seed=42), with the golden's two cosmologies (lanes
    0-1 of design_params(n_golden)) in lanes 0-1."""
    params = design_params(BATCH_BENCH)
    params[:2] = design_params(n_golden)[:2]
    return params


def overlap_line(timer) -> str:
    """The host-prepare overlap of a chunked run: the time the solve
    waited for prepared chunks, the prepare worker's own seconds, the part
    of them hidden behind the solve, the worker's start and which process
    prepared each chunk."""
    st = timer.stats
    start = st.get("worker_start_s")
    return (f"prepare waited {timer.times['prepare']:.3f} s; the prepare "
            f"worker prepared {st.get('prepare_worker_s', 0.0):.3f} s, "
            f"{st.get('prepare_hidden_s', 0.0):.3f} s of it hidden behind "
            f"the solve; worker start "
            f"{'not reached' if start is None else f'{start:.3f} s'}; "
            f"chunks prepared by {st.get('prepared_by')}")


def run_batch64(what: str, cfg, settings, golden: str, n_golden: int,
                detail: dict, card: str) -> tuple:
    """A chunked run over the bench's batch of 64 at the default placement
    (each chunk prepared on the host; from the second chunk on by the
    prepare worker while the previous chunk is solved): full TRG in 4
    chunks of 16, 1-loop in 2 of 32.  Every lane finite, lanes 0-1 held to
    the golden; prints the wall, the time the solve waited for prepare
    and the prepare seconds hidden behind the solve.  Returns the launch
    counts and the result."""
    params = bench_params(n_golden)
    gold = load_golden(golden, params, settings, what)
    cs, lins = design_inputs(BATCH_BENCH, params)
    res, launches, wall, timer = timed_run(what, cfg, settings, cs, lins,
                                           detail)
    times, att = dict(timer.times), timer.stats["attempts"]
    check(timer.stats["prepared_by"][0] == "caller",
          f"{what}: chunk 0 was not prepared by the caller")
    dev_col, dev_lin = golden_dev(res, gold, what)
    per_min = BATCH_BENCH / wall * 60.0
    n_chunks = len(timer.stats["prepared_by"])
    detail[what] = dict(
        wall_s=wall, cosmologies=BATCH_BENCH, chunks=n_chunks,
        cosmologies_per_min=per_min, stages_s=times,
        overlap={k: timer.stats.get(k) for k in (
            "prepared_by", "prepare_worker_s", "prepare_hidden_s",
            "worker_start_s")},
        golden_dev_col_scale=dev_col, golden_dev_linear_rel=dev_lin,
        attempts=att, launches=launches)
    print(f"{what} path on {card}: {BATCH_BENCH} cosmologies in {n_chunks} "
          f"chunks, {wall:.3f} s = {per_min:.2f} cosmologies/min; "
          f"{overlap_line(timer)}; solve {times['solve']:.3f} s; attempts "
          f"per cosmology {spread(att)}; lanes 0-1 vs JAX golden "
          f"{dev_col:.3g} of column scale, linear {dev_lin:.3g}")
    return launches, res


def run_batch64_paths(detail: dict, card: str) -> tuple:
    """Full TRG (the bench's headline) and 1-loop (print_bias, its 7
    redshifts) over the bench's batch of 64 through run_batch64.  Returns
    the launch counts of both and the full-TRG result."""
    from redtime_tpu_torch.config import RunSettings, SolverConfig

    launches, res = run_batch64(
        "batch64", SolverConfig(), RunSettings(one_loop=False, z_out=Z_OUT),
        GOLDEN, N_DESIGN, detail, card)
    launches_1l, _ = run_batch64(
        "oneloop64", SolverConfig(print_bias=True),
        RunSettings(one_loop=True, z_out=Z_OUT_1L), GOLDEN_1L, N_DESIGN_1L,
        detail, card)
    return dict(batch64=launches, oneloop64=launches_1l), res


def shard_devices() -> list:
    """The split's device list: every card when there are several, else
    the one card named twice (two worker processes, two CUDA contexts on
    one card)."""
    import torch

    count = torch.cuda.device_count()
    return ([f"cuda:{i}" for i in range(count)] if count > 1
            else ["cuda:0", "cuda:0"])


def child_pids() -> list:
    """The pids of this process's living children (Linux /proc)."""
    me, out = os.getpid(), []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:          # it exited while we looked
            continue
        state, ppid = stat.rsplit(")", 1)[1].split()[:2]
        if int(ppid) == me and state != "Z":
            out.append(int(entry))
    return out


def run_shard(chunked64, detail: dict, card: str) -> dict:
    """The device split, run_batch(devices=shard_devices()): the bench's
    batch of 64 in full TRG (run_batch64's inputs), one worker process a
    shard of 32, chunked (the JAX rule: max_chunk 16 across the devices,
    so each worker solves 16 // nd lanes at a time, with its own prepare
    worker) and packed (32 lanes a shard), each with the counters set to
    0 just before and read just after (timed_run: the launches the
    workers sent back, K1-K3 in their solve, none in their host
    prepare).  Every lane finite, lanes 0-1 held to the golden, every
    lane within the controller band (3e-5 of column scale) of the
    in-process chunked run; no worker left running.  Prints the wall,
    each shard's wall and each worker's start.  Returns the launch counts
    of both runs."""
    from redtime_tpu_torch.config import RunSettings, SolverConfig

    cfg, settings = SolverConfig(), RunSettings(one_loop=False, z_out=Z_OUT)
    params = bench_params(N_DESIGN)
    gold = load_golden(GOLDEN, params, settings, "shard")
    cs, lins = design_inputs(BATCH_BENCH, params)
    devices = shard_devices()
    ref = chunked64.table.cpu().numpy()
    out = {}
    for what, kw in (("shard", {}),
                     ("shard_packed", dict(scheduler="packed", n_lanes=32))):
        res, launches, wall, timer = timed_run(what, cfg, settings, cs, lins,
                                               detail, devices=devices, **kw)
        check(not child_pids(), f"{what}: worker processes left running")
        dev_col, dev_lin = golden_dev(res, gold, what)
        dev_band = band_dev(res.table.cpu().numpy(), ref)
        check(dev_band <= 3e-5, f"{what}: vs the in-process chunked table "
                                f"{dev_band:.3g} of column scale (bound "
                                "3e-5)")
        shards = timer.stats["shards"]
        att = timer.stats["attempts"]
        check(len(att) == BATCH_BENCH, f"{what}: {len(att)} attempts")
        per_min = BATCH_BENCH / wall * 60.0
        detail[what] = dict(
            wall_s=wall, devices=devices, cosmologies=BATCH_BENCH,
            cosmologies_per_min=per_min, stages_s=dict(timer.times),
            shards=shards, iterations=timer.stats.get("iterations"),
            attempts=att, golden_dev_col_scale=dev_col,
            golden_dev_linear_rel=dev_lin, chunked_dev_col_scale=dev_band,
            launches=launches)
        print(f"{what} path on {card}: {BATCH_BENCH} cosmologies over "
              f"{devices}, {wall:.3f} s = {per_min:.2f} cosmologies/min "
              f"(workers started in {timer.times['start']:.3f} s); shard "
              f"walls {[round(s['wall_s'], 3) for s in shards]} s, worker "
              f"starts {[round(s['start_s'], 3) for s in shards]} s, shard "
              f"stages {[s['times'] for s in shards]}, iterations "
              f"{timer.stats.get('iterations')}; lanes 0-1 vs JAX golden "
              f"{dev_col:.3g} of column scale, linear {dev_lin:.3g}; vs the "
              f"in-process chunked table {dev_band:.3g}; launches the "
              f"workers sent back {launches['by_phase']}")
        out[what] = launches
    return out


def run_worker_fault(detail: dict, card: str) -> None:
    """A device list that names a card the machine does not have
    (cuda:{count}): run_batch must raise WorkerError in this process with
    the worker's message, and leave no worker running.  Anything else
    fails the script."""
    import torch

    from redtime_tpu_torch import driver, worker
    from redtime_tpu_torch.config import RunSettings, SolverConfig

    missing = f"cuda:{torch.cuda.device_count()}"
    cs, lins = design_inputs(2)
    t0 = time.perf_counter()
    try:
        driver.run_batch(SolverConfig(), RunSettings(one_loop=False,
                                                     z_out=Z_OUT),
                         cs, lins, devices=[missing])
    except worker.WorkerError as err:
        msg = str(err)
    else:
        msg = None
    wall = time.perf_counter() - t0
    check(msg is not None, f"worker fault: run_batch on {missing} did not "
                           "raise")
    check(f"shard 0 of 1 on {missing}" in msg and "the worker raised" in msg
          and "CUDA card(s)" in msg,
          f"worker fault: not the worker's message: {msg!r}")
    left = child_pids()
    check(not left, f"worker fault: worker processes left running {left}")
    detail["worker_fault"] = dict(device=missing, wall_s=wall,
                                  message=msg.splitlines()[-1])
    print(f"worker fault on {card}: run_batch(devices=[{missing!r}]) raised "
          f"in {wall:.3f} s with the worker's message "
          f"{msg.splitlines()[-1]!r}; no worker left running")


def run_cli(detail: dict, card: str) -> dict:
    """The CLI on the card: write_cli_inputs writes 4 design cosmologies
    (full TRG, the bench's redshifts) into a temporary directory;
    redtime_tpu_torch.cli.main(["batch", ...]) and (["run", ...]) on the
    first file run there at nk=128; rc 0, every file written and finite,
    and each table within 3e-5 of column scale of run_batch's on the same
    inputs (loaded by the CLI's own reader), its linear columns within
    1e-10 relative."""
    import tempfile

    import torch

    from redtime_tpu_torch import cli, driver
    from redtime_tpu_torch.config import CosmoParams, SolverConfig
    from redtime_tpu_torch.io.camb import LinearData
    from redtime_tpu_torch.kernels import counts

    n = 4
    with tempfile.TemporaryDirectory() as work:
        paths = write_cli_inputs(work, design_params(n), Z_OUT)
        out_dir = os.path.join(work, "out")
        counts.reset()
        t0 = time.perf_counter()
        rc = cli.main(["batch", "--timing", "-o", out_dir] + paths)
        wall_batch = time.perf_counter() - t0
        rc_run = cli.main(["run", "--params", paths[0], "-o",
                           os.path.join(work, "one.dat")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts.snapshot()
        check(rc == 0 and rc_run == 0, f"cli: batch rc {rc}, run rc {rc_run}")
        for name in MAIN_KERNELS:
            check(launches[name] > 0, f"cli: kernel {name} was not launched")
        files = [os.path.join(out_dir, f"redTime_M{i:03d}.dat")
                 for i in range(n)]
        texts = [open(f, "rb").read() for f in files]
        tables = [np.loadtxt(f) for f in files]
        tables.append(np.loadtxt(os.path.join(work, "one.dat")))
        loaded = [cli._load(p, False) for p in paths]
        cs = CosmoParams(*[torch.stack([c[i] for *_, c in loaded])
                           for i in range(9)])
        lins = LinearData(*[np.stack([lin[i] for _, lin, _, _ in loaded])
                            for i in range(6)])
        ref = driver.run_batch(SolverConfig(), loaded[0][2], cs, lins,
                               device="cuda").table.cpu().numpy()
    nk = SolverConfig().nk
    devs = []
    for i, t in enumerate(tables):       # the batch's n, then run's one
        r = ref[i % n].reshape(-1, ref.shape[-1])
        check(t.shape == r.shape and bool(np.isfinite(t).all()),
              f"cli: table {i} shape {t.shape} or non-finite")
        scale = np.max(np.abs(r), axis=0) + 1e-300
        dev = float(np.max(np.abs(t - r) / scale))
        lin = float(np.max(np.abs(t[:, :7] - r[:, :7])
                           / (np.abs(r[:, :7]) + 1e-300)))
        check(dev <= 3e-5 and lin <= 1e-10,
              f"cli: table {i} vs run_batch {dev:.3g} of column scale, "
              f"linear {lin:.3g}")
        devs.append(dev)
    detail["cli"] = dict(batch_wall_s=wall_batch, wall_s=wall, files=n,
                         nk=nk, dev_col_scale=devs, launches=launches)
    print(f"cli path on {card}: batch of {n} files {wall_batch:.3f} s, then "
          f"run of one, {wall:.3f} s in all; tables vs run_batch "
          f"{max(devs):.3g} of column scale (the printed 12 digits); "
          f"launches {launches}")
    return launches, texts


def run_cli_shard(cli_texts: list, detail: dict, card: str) -> dict:
    """`batch --shard` over the CLI phase's 4 params files (the same
    write_cli_inputs), with the counters set to 0 just before and read
    just after: rc 0, the sharding line on stderr with nd the largest
    divisor of 4 at most the card count, K1-K3 launched (by the workers),
    no worker left running, and the tables byte-equal to the CLI phase's
    `batch` when nd = 1, else within 3e-5 of column scale (linear columns
    1e-10 relative)."""
    import io
    import tempfile

    import torch

    from redtime_tpu_torch import cli
    from redtime_tpu_torch.kernels import counts

    n = len(cli_texts)
    nd = len(cli.shard_devices(n, list(range(torch.cuda.device_count()))))
    err = io.StringIO()
    with tempfile.TemporaryDirectory() as work:
        paths = write_cli_inputs(work, design_params(n), Z_OUT)
        out_dir = os.path.join(work, "out")
        counts.reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["batch", "--shard", "-o", out_dir] + paths)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts.snapshot()
        texts = [open(os.path.join(out_dir, f"redTime_M{i:03d}.dat"),
                      "rb").read() for i in range(n)]
    sys.stderr.write(err.getvalue())
    check(rc == 0, f"cli shard: batch --shard rc {rc}")
    line = f"# sharding batch of {n} over {nd} devices"
    check(line in err.getvalue(), f"cli shard: no line {line!r} on stderr")
    check(not child_pids(), "cli shard: worker processes left running")
    for name in MAIN_KERNELS:
        check(launches[name] > 0, f"cli shard: kernel {name} was not "
                                  "launched")
    same = [a == b for a, b in zip(texts, cli_texts)]
    devs = []
    for i, (a, b) in enumerate(zip(texts, cli_texts)):
        t = np.loadtxt(io.BytesIO(a))
        r = np.loadtxt(io.BytesIO(b))
        dev = float(np.max(np.abs(t - r) / (np.max(np.abs(r), axis=0)
                                            + 1e-300)))
        lin = float(np.max(np.abs(t[:, :7] - r[:, :7])
                           / (np.abs(r[:, :7]) + 1e-300)))
        check(bool(np.isfinite(t).all()) and t.shape == r.shape,
              f"cli shard: table {i} shape {t.shape} or non-finite")
        check(same[i] if nd == 1 else dev <= 3e-5 and lin <= 1e-10,
              f"cli shard: table {i} vs batch: same bytes {same[i]}, "
              f"{dev:.3g} of column scale, linear {lin:.3g} (nd {nd})")
        devs.append(dev)
    detail["cli_shard"] = dict(wall_s=wall, files=n, nd=nd,
                               byte_equal=same, dev_col_scale=devs,
                               launches=launches)
    print(f"cli_shard path on {card}: batch --shard of {n} files over {nd} "
          f"device(s), {wall:.3f} s; tables byte-equal to batch's {same}, "
          f"{max(devs):.3g} of column scale; launches {launches}")
    return launches


def run_ragged_grid(detail: dict, card: str) -> dict:
    """Full TRG at nk=48 (np=192, 2np=384: no power of two, ragged
    K-steps in K1 and K2), 2 design lanes, the bench's redshifts: on the
    card against the port's own CPU run of the same lanes, within 3e-5
    of column scale, the linear columns within 1e-10 relative; then the
    same lanes on the card in chunks of one, and whether each lane has
    the same bits as in the chunk of two (printed, not checked: the
    host's prepare and the card's library GEMMs may block by shape)."""
    import torch

    from redtime_tpu_torch import driver
    from redtime_tpu_torch.config import RunSettings, SolverConfig

    cfg = SolverConfig(nk=48)
    settings = RunSettings(one_loop=False, z_out=Z_OUT)
    cs, lins = design_inputs(2)
    res, launches, wall, _ = timed_run("grid_nk48", cfg, settings, cs, lins,
                                       detail)
    t0 = time.perf_counter()
    ref = driver.run_batch(cfg, settings, cs, lins, device="cpu")
    cpu_s = time.perf_counter() - t0
    got, want = res.table.cpu().numpy(), ref.table.numpy()
    scale = np.max(np.abs(want), axis=(0, 2), keepdims=True) + 1e-300
    dev = float(np.max(np.abs(got - want) / scale))
    lin = float(np.max(np.abs(got[..., :7] - want[..., :7])
                       / (np.abs(want[..., :7]) + 1e-300)))
    check(dev <= 3e-5 and lin <= 1e-10,
          f"grid_nk48: card vs CPU {dev:.3g} of column scale, linear "
          f"{lin:.3g}")
    apart = driver.run_batch(cfg, settings, cs, lins, device="cuda",
                             max_chunk=1).table
    same = bool(torch.equal(apart, res.table))
    n_diff = int((apart != res.table).sum())
    detail["grid_nk48"] = dict(wall_s=wall, cpu_wall_s=cpu_s,
                               dev_col_scale=dev, dev_linear_rel=lin,
                               chunk_of_one_same_bits=same,
                               chunk_of_one_elements_differ=n_diff,
                               launches=launches)
    print(f"grid_nk48 path on {card}: 2 lanes, nk=48, {wall:.3f} s (CPU "
          f"{cpu_s:.3f} s); card vs CPU {dev:.3g} of column scale, linear "
          f"{lin:.3g}; launches by phase {launches['by_phase']}; in chunks "
          f"of one: same bits {same} ({n_diff} of {res.table.numel()} "
          "elements differ)")
    return launches


def run_packed(what: str, cfg, settings, params: np.ndarray, lanes: int,
               golden: str, chunked, detail: dict, card: str) -> dict:
    """The packed scheduler through run_batch(scheduler="packed",
    n_lanes=lanes) over the design cosmologies `params` at the default
    placement (all prepared on the host at once, then one work-queue
    solve), with the counters set to 0 just before and read just after
    (timed_run: every lane finite, K1-K3 launched in the solve and none
    in prepare); lanes 0-1 held to the JAX golden as the chunked paths
    are, and every lane within the controller band (3e-5 of column
    scale) of the chunked run's table on the same inputs.  Prints the
    wall, the prepare / solve split, the loop's iterations and the
    attempts per cosmology.  Returns the launch counts."""
    n = len(params)
    gold = load_golden(golden, params, settings, what)
    cs, lins = design_inputs(n, params)
    res, launches, wall, timer = timed_run(what, cfg, settings, cs, lins,
                                           detail, scheduler="packed",
                                           n_lanes=lanes)
    dev_col, dev_lin = golden_dev(res, gold, what)
    got, ref = res.table.cpu().numpy(), chunked.table.cpu().numpy()
    check(got.shape == ref.shape, f"{what}: table shape {got.shape}")
    dev_ch = band_dev(got, ref)
    check(dev_ch <= 3e-5, f"{what}: vs the chunked table {dev_ch:.3g} of "
                          "column scale (bound 3e-5)")
    times, stats = dict(timer.times), timer.stats
    att = stats["attempts"]
    per_min = n / wall * 60.0
    detail[what] = dict(
        wall_s=wall, cosmologies=n, lanes=lanes, cosmologies_per_min=per_min,
        stages_s=times, iterations=stats["iterations"], attempts=att,
        golden_dev_col_scale=dev_col, golden_dev_linear_rel=dev_lin,
        chunked_dev_col_scale=dev_ch, launches=launches)
    print(f"{what} path on {card}: {n} cosmologies on {lanes} lanes, "
          f"{wall:.3f} s = {per_min:.2f} cosmologies/min (prepare "
          f"{times['prepare']:.3f} s, solve {times['solve']:.3f} s); "
          f"{stats['iterations']} iterations, attempts per cosmology "
          f"{spread(att)} (sum {sum(att)}); lanes 0-1 vs JAX golden "
          f"{dev_col:.3g} of column scale, linear {dev_lin:.3g}; vs the "
          f"chunked table {dev_ch:.3g}; launches by phase "
          f"{launches['by_phase']}")
    return launches


def run_packed_paths(chunked64, chunked1l, detail: dict, card: str) -> dict:
    """Full TRG over the bench's batch of 64 (run_batch64's inputs) on 16
    lanes, and 1-loop over the 32 cosmologies of run_oneloop on 8 lanes,
    each through run_packed against its chunked result."""
    from redtime_tpu_torch.config import RunSettings, SolverConfig

    params = bench_params(N_DESIGN)
    return dict(
        packed64=run_packed(
            "packed64", SolverConfig(),
            RunSettings(one_loop=False, z_out=Z_OUT), params, 16, GOLDEN,
            chunked64, detail, card),
        packed_oneloop=run_packed(
            "packed_oneloop", SolverConfig(print_bias=True),
            RunSettings(one_loop=True, z_out=Z_OUT_1L),
            design_params(N_DESIGN_1L), 8, GOLDEN_1L, chunked1l, detail,
            card))


def run_cli_packed(detail: dict, card: str) -> dict:
    """`batch --scheduler packed --lanes 2` over 4 params files written
    by write_cli_inputs (full TRG, nk=128), with the counters set to 0
    just before and read just after: rc 0, K1-K3 launched, every table
    finite and within 3e-5 of column scale (its linear columns within
    1e-10 relative) of run_batch(scheduler="packed", n_lanes=2) on the
    same inputs, loaded by the CLI's own reader."""
    import tempfile

    import torch

    from redtime_tpu_torch import cli, driver
    from redtime_tpu_torch.config import CosmoParams, SolverConfig
    from redtime_tpu_torch.io.camb import LinearData
    from redtime_tpu_torch.kernels import counts

    n = 4
    with tempfile.TemporaryDirectory() as work:
        paths = write_cli_inputs(work, design_params(n), Z_OUT)
        out_dir = os.path.join(work, "out")
        counts.reset()
        t0 = time.perf_counter()
        rc = cli.main(["batch", "--scheduler", "packed", "--lanes", "2",
                       "-o", out_dir] + paths)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts.snapshot()
        check(rc == 0, f"cli packed: batch rc {rc}")
        for name in MAIN_KERNELS:
            check(launches[name] > 0,
                  f"cli packed: kernel {name} was not launched")
        tables = [np.loadtxt(os.path.join(out_dir, f"redTime_M{i:03d}.dat"))
                  for i in range(n)]
        loaded = [cli._load(p, False) for p in paths]
        cs = CosmoParams(*[torch.stack([c[i] for *_, c in loaded])
                           for i in range(9)])
        lins = LinearData(*[np.stack([lin[i] for _, lin, _, _ in loaded])
                            for i in range(6)])
        ref = driver.run_batch(SolverConfig(), loaded[0][2], cs, lins,
                               device="cuda", scheduler="packed",
                               n_lanes=2).table.cpu().numpy()
    devs = []
    for i, t in enumerate(tables):
        r = ref[i].reshape(-1, ref.shape[-1])
        check(t.shape == r.shape and bool(np.isfinite(t).all()),
              f"cli packed: table {i} shape {t.shape} or non-finite")
        dev = float(np.max(np.abs(t - r) / (np.max(np.abs(r), axis=0)
                                            + 1e-300)))
        lin = float(np.max(np.abs(t[:, :7] - r[:, :7])
                           / (np.abs(r[:, :7]) + 1e-300)))
        check(dev <= 3e-5 and lin <= 1e-10,
              f"cli packed: table {i} vs run_batch {dev:.3g} of column "
              f"scale, linear {lin:.3g}")
        devs.append(dev)
    detail["cli_packed"] = dict(wall_s=wall, files=n, lanes=2,
                                dev_col_scale=devs, launches=launches)
    print(f"cli_packed path on {card}: batch --scheduler packed --lanes 2 "
          f"of {n} files {wall:.3f} s; tables vs run_batch(scheduler="
          f"'packed') {max(devs):.3g} of column scale (the printed 12 "
          f"digits); launches {launches}")
    return launches


def run_presets(detail: dict, card: str) -> dict:
    """SolverConfig.high_accuracy() (nk=512, np=2048, eabs 1e-15, erel
    1e-6) and v01_compat() (nk=256, np_factor 8, growth_n_lnk 1000,
    a_early 1e-50, growth_h_reset) at their full settings: 2 design
    cosmologies, 1-loop, z_out (1, 0), chunked at the default placement,
    each with the counters set to 0 just before and read just after
    (timed_run); lanes 0-1 held to the presets' JAX goldens as the
    chunked paths are.  Prints the wall and the attempts per cosmology.
    Returns the launch counts by preset."""
    from redtime_tpu_torch.config import RunSettings, SolverConfig

    settings = RunSettings(one_loop=True, z_out=Z_OUT_PRESETS)
    params = design_params(N_DESIGN)[:2]
    out = {}
    for name, (nk, golden) in GOLDEN_PRESETS.items():
        cfg = getattr(SolverConfig, name)()
        check(cfg.nk == nk, f"{name}: nk {cfg.nk}")
        gold = load_golden(golden, params, settings, name)
        cs, lins = design_inputs(2, params)
        res, launches, wall, timer = timed_run(name, cfg, settings, cs, lins,
                                               detail)
        dev_col, dev_lin = golden_dev(res, gold, name)
        att = timer.stats["attempts"]
        detail[name] = dict(wall_s=wall, nk=cfg.nk, np=cfg.npts,
                            stages_s=dict(timer.times), attempts=att,
                            golden_dev_col_scale=dev_col,
                            golden_dev_linear_rel=dev_lin, launches=launches)
        print(f"{name} path on {card}: 2 cosmologies, nk={cfg.nk}, "
              f"np={cfg.npts}, 1-loop: {wall:.3f} s (stages "
              f"{dict(timer.times)}); attempts per cosmology {att}; lanes "
              f"0-1 vs JAX golden {dev_col:.3g} of column scale, linear "
              f"{dev_lin:.3g}; launches by phase {launches['by_phase']}")
        out[name] = launches
    return out


@contextlib.contextmanager
def batch_timers():
    """The StageTimer of every driver.run_batch call inside the block (the
    CLI makes its own), so a run through the CLI can report its attempts
    per cosmology."""
    from redtime_tpu_torch import driver

    inner, seen = driver.run_batch, []

    def recorded(*args, **kw):
        seen.append(kw.get("timer"))
        return inner(*args, **kw)

    driver.run_batch = recorded
    try:
        yield seen
    finally:
        driver.run_batch = inner


# the linear columns' bounds of the injected rerun: dln beta/dln a
# (column 5) differentiates the beta table that inject densifies from the
# printed 12-digit P_lin_nu / P_lin_cb, so it carries the rounding of the
# two packages' printed tables amplified (2.0e-10 on the CPU, port
# against JAX); 1e-9 is the reference suite's z=0 bound on the injected
# reconstruction (tests/test_golden_32models.py:139)
INJECT_LIN_BOUNDS = (1e-10,) * 5 + (1e-9, 1e-10)


def table_dev(got: np.ndarray, ref: np.ndarray, what: str,
              lin_bounds=(1e-10,) * 7) -> tuple:
    """(column-scale deviation over lanes and k, linear columns' relative
    deviation) of tables [lanes, blocks, nk, ncol]; raises past 3e-5 or
    past lin_bounds (one a linear column)."""
    check(got.shape == ref.shape, f"{what}: table shape {got.shape}, golden "
                                  f"{ref.shape}")
    dev_col = band_dev(got, ref)
    lin = np.max(np.abs(got[..., :7] - ref[..., :7])
                 / (np.abs(ref[..., :7]) + 1e-300), axis=(0, 1, 2))
    check(dev_col <= 3e-5, f"{what}: vs golden {dev_col:.3g} of column "
                           "scale (bound 3e-5)")
    check(bool(np.all(lin <= np.asarray(lin_bounds))),
          f"{what}: linear columns vs golden {lin} relative (bounds "
          f"{lin_bounds})")
    return dev_col, float(lin.max())


def header_dev(got: dict, gold: dict, prefix: str, what: str) -> float:
    """Largest relative deviation of the H, sigma_v^2 and sigmaV2(z=0)
    headers from the golden's `prefix`-named ones; raises past 1e-10."""
    worst = 0.0
    for name in ("H", "sigma_v2", "sigmaV2_z0"):
        ref = gold[prefix + name]
        rel = float(np.max(np.abs(np.asarray(got[name]) - ref) / np.abs(ref)))
        check(rel <= 1e-10, f"{what}: {name} vs golden {rel:.3g} relative "
                            "(bound 1e-10)")
        worst = max(worst, rel)
    return worst


def output_dev(got: np.ndarray, ref: np.ndarray, axis: int,
               what: str) -> float:
    """max |got - ref| over max |ref| along `axis` (a convert output's
    column scale); raises past 3e-5."""
    check(got.shape == ref.shape, f"{what}: shape {got.shape}, golden "
                                  f"{ref.shape}")
    scale = np.max(np.abs(ref), axis=axis, keepdims=True) + 1e-300
    dev = float(np.max(np.abs(got - ref) / scale))
    check(dev <= 3e-5, f"{what}: vs golden {dev:.3g} of column scale "
                       "(bound 3e-5)")
    return dev


def read_outputs(out_dir: str, tag: str, n: int = 2) -> np.ndarray:
    """The convert outputs {tag}_M###_no_interp_test.dat of models 1..n."""
    return np.stack([np.loadtxt(os.path.join(
        out_dir, f"{tag}_M{mn:03d}_no_interp_test.dat"))
        for mn in range(1, n + 1)])


def run_production(detail: dict, card: str) -> tuple:
    """The emulator-production chain on the card, through the entry points
    a user calls, held to the JAX golden of its first two models
    (GOLDEN_PROD):

      1. design.generate_design writes N_PROD = 16 Mira-Titan cosmologies
         (seed SEED); orchestrate.main runs each through two passes of
         tests/mock_camb.py (the sigma_8 rescale), writes their params
         files (switches 1 0 1 1, z_out the 33 CAMB redshifts) and ends in
         one CLI `batch --timing` on the card at SolverConfig() defaults
         (nk=128, np=512, RKF45, f64, scheduler auto), with the counters
         set to 0 just before and read just after: K1-K3 launched in the
         solve, none in host prepare; 16 x 33 finite blocks; lanes 0-1
         at the 8 HACC blocks within 3e-5 of column scale of the golden,
         linear columns and headers within 1e-10;
      2. the CLI's `convert` at the 8 HACC steps of STEP_TO_ZBLOCK and
         `convert-full` at PROD_STEP_FULL over write_nbody_spectra's PM
         and HACC spectra, every model; models 1-2 within 3e-5 of column
         scale of the golden's outputs; emulator_check.compare_outputs of
         each table against itself through assert_reference_criteria;
      3. inject.load_injected on the tables of lanes 0-1 and their rerun
         through run_batch(norm_override=...) on the card (timed_run's
         checks), at the 8 HACC blocks within 3e-5 of column scale of the
         golden's injected tables, headers and linear columns within
         1e-10 but dln beta/dln a within 1e-9 (INJECT_LIN_BOUNDS).

    Prints each stage's wall (orchestration: orchestrate.main's wall less
    the CLI's three --timing stages), cosmologies/min, attempts per
    cosmology and the launches by phase.  Returns (the batch's launches,
    the rerun's launches)."""
    import io
    import re
    import tempfile

    import torch

    from redtime_tpu_torch import (cli, design, driver, emulator_check,
                                   inject, orchestrate)
    from redtime_tpu_torch.config import CosmoParams, SolverConfig
    from redtime_tpu_torch.convert import (STEP_TO_ZBLOCK, read_models_file,
                                           read_redtime_table)
    from redtime_tpu_torch.io.camb import LinearData
    from redtime_tpu_torch.kernels import counts

    gold = dict(np.load(GOLDEN_PROD))
    steps = sorted(STEP_TO_ZBLOCK)
    blocks = [STEP_TO_ZBLOCK[s] for s in steps]
    check(list(gold["blocks"]) == blocks and list(gold["steps"]) == steps,
          "production: the golden's HACC blocks differ")
    cfg = SolverConfig()
    walls, out_detail = {}, {}
    with tempfile.TemporaryDirectory() as work:
        models = os.path.join(work, "models.dat")
        design.generate_design(models, N_PROD, seed=SEED)
        check(np.array_equal(np.loadtxt(models, usecols=range(1, 9))[:2],
                             gold["design"]),
              "production: design lanes 0-1 differ from the golden's")
        zfile = os.path.join(work, "z.txt")
        with open(zfile, "w") as f:
            f.write(orchestrate.CAMB_Z_LIST + "\n")
        check(np.array_equal(np.asarray(orchestrate.CAMB_Z_LIST.split(),
                                        dtype=np.float64), gold["z_out"]),
              "production: z_out differs from the golden's")
        out = os.path.join(work, "out")
        err = io.StringIO()
        counts.reset()
        t0 = time.perf_counter()
        with batch_timers() as timers, contextlib.redirect_stderr(err):
            rc = orchestrate.main(["--redshift-file", zfile, "--models-file",
                                   models, "--output-dir", out, "--camb-exec",
                                   MOCK_CAMB, "--timing"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log = err.getvalue()
        sys.stderr.write(log)
        check(rc == 0, f"production: orchestrate rc {rc}")
        launches = dict(counts.snapshot(), by_phase=counts.phases())
        for name in MAIN_KERNELS:
            check(launches["by_phase"]["solve"][name] > 0,
                  f"production: kernel {name} was not launched in the solve")
            check(launches["by_phase"]["prepare"][name] == 0,
                  f"production: host prepare launched {name} on the card")
        stages = {k: float(v) for k, v in re.findall(
            r"# \[timing\] (\S+): ([0-9.]+)s \(", log)}
        cli_stages = ("load-inputs", "solve-batch", "write-outputs")
        check(all(s in stages for s in cli_stages),
              f"production: --timing stages {stages}")
        walls.update({s: stages[s] for s in cli_stages})
        walls["orchestration"] = wall - sum(stages[s] for s in cli_stages)
        per_min = float(re.search(r"\(([0-9.]+) cosmologies/min\)",
                                  log).group(1))
        check(len(timers) == 1 and timers[0] is not None,
              "production: the CLI ran run_batch without its timer")
        att = timers[0].stats["attempts"]

        paths = [os.path.join(out, f"redTime_M{i:03d}.dat")
                 for i in range(1, N_PROD + 1)]
        tables = np.stack([read_redtime_table(p, cfg.nk) for p in paths])
        check(tables.shape == (N_PROD, 33, cfg.nk, 17)
              and bool(np.isfinite(tables).all()),
              f"production: tables {tables.shape} or non-finite")
        dev_col, dev_lin = table_dev(tables[:2, blocks], gold["table"],
                                     "production")
        heads = [read_headers(p) for p in paths[:2]]
        dev_head = header_dev(dict(
            H=np.stack([h[0][blocks] for h in heads]),
            sigma_v2=np.stack([h[1][blocks] for h in heads]),
            sigmaV2_z0=np.array([h[2] for h in heads])), gold, "",
            "production")

        t0 = time.perf_counter()
        for step in steps:
            check(cli.main(["convert", "--n-models", str(N_PROD), "--step",
                            str(step), "--nk", str(cfg.nk), "--models-file",
                            models, "--red-dir", out]) == 0,
                  f"production: convert --step {step} failed")
        walls["convert"] = time.perf_counter() - t0
        conv = [(read_outputs(os.path.join(out, f"STEP{s}"), "k"),
                 read_outputs(os.path.join(out, f"STEP{s}"), "pk"))
                for s in steps]
        dev_conv = max(
            output_dev(np.stack([c[0] for c in conv]), gold["convert_k"], 2,
                       "production convert k"),
            output_dev(np.stack([c[1] for c in conv]), gold["convert_pk"],
                       2, "production convert pk"))
        nbody = os.path.join(work, "nbody")
        os.makedirs(nbody)
        pm_t, hacc_t = write_nbody_spectra(nbody, N_PROD)
        full = os.path.join(work, "full")
        t0 = time.perf_counter()
        check(cli.main(["convert-full", "--design", models, "--step",
                        str(PROD_STEP_FULL), "-o", full, "--pt-template",
                        os.path.join(out, "redTime_M{model:03d}.dat"),
                        "--pm-template", pm_t, "--hacc-template", hacc_t,
                        "--nk", str(cfg.nk), "--n-pm", str(N_PM)]) == 0,
              "production: convert-full failed")
        walls["convert_full"] = time.perf_counter() - t0
        check(len(os.listdir(full)) == 3 * N_PROD,
              f"production: convert-full wrote {len(os.listdir(full))} files")
        dev_full = max(output_dev(read_outputs(full, tag), gold["full_" + tag],
                                  1, f"production convert-full {tag}")
                       for tag in ("k", "pk", "err"))
        design_rows = read_models_file(models)
        for path, m in zip(paths, design_rows):
            res = emulator_check.compare_outputs(path, path, cfg.nk,
                                                 om_nu=m["om_nu"],
                                                 om_m=m["om_m"])
            emulator_check.assert_reference_criteria(res,
                                                     massive=m["om_nu"] > 0)
            check(res.max_abs == 0.0, f"production: {path} against itself "
                                      f"{res.max_abs}")

        loaded = [inject.load_injected(
            cfg, os.path.join(out, f"params_redTime_M{i:03d}.dat"), p)
            for i, p in zip((1, 2), paths)]
    norms = np.array([n for *_, n in loaded])
    rel = float(np.max(np.abs(norms / gold["inject_norm"] - 1.0)))
    check(rel <= 1e-10, f"production inject: norm vs golden {rel:.3g}")
    settings = driver.settings_from_params(loaded[0][0])[0]
    cosmos = [driver.settings_from_params(p)[1] for p, _, _ in loaded]
    cs = CosmoParams(*[torch.stack([c[i] for c in cosmos]) for i in range(9)])
    lins = LinearData(*[np.stack([lin[i] for _, lin, _ in loaded])
                        for i in range(6)])
    res, inj_launches, inj_wall, inj_timer = timed_run(
        "inject_rerun", cfg, settings, cs, lins, detail, norm_override=norms)
    walls["inject_rerun"] = inj_wall
    inj_col, inj_lin = table_dev(res.table[:, blocks].cpu().numpy(),
                                 gold["inject_table"], "inject rerun",
                                 INJECT_LIN_BOUNDS)
    inj_head = header_dev(dict(
        H=res.H[:, blocks].cpu().numpy(),
        sigma_v2=res.sigma_v2[:, blocks].cpu().numpy(),
        sigmaV2_z0=res.sigmaV2_z0.cpu().numpy()), gold, "inject_",
        "inject rerun")
    out_detail.update(
        cosmologies=N_PROD, redshifts=33, walls_s=walls, wall_s=wall,
        cosmologies_per_min=per_min, attempts=att,
        golden_dev_col_scale=dev_col, golden_dev_linear_rel=dev_lin,
        golden_dev_headers_rel=dev_head, convert_dev=dev_conv,
        convert_full_dev=dev_full, inject_norm_rel=rel,
        inject_dev_col_scale=inj_col, inject_dev_linear_rel=inj_lin,
        inject_dev_headers_rel=inj_head,
        inject_attempts=inj_timer.stats["attempts"], launches=launches,
        inject_launches=inj_launches)
    detail["production"] = out_detail
    print(f"production path on {card}: {N_PROD} cosmologies x 33 "
          f"redshifts, full TRG, nk={cfg.nk}: orchestrate.main {wall:.3f} s "
          f"(orchestration {walls['orchestration']:.3f} s, 2 mock CAMB "
          f"passes a model; CLI load-inputs {walls['load-inputs']:.3f} s, "
          f"solve-batch {walls['solve-batch']:.3f} s, write-outputs "
          f"{walls['write-outputs']:.3f} s; {per_min:.2f} cosmologies/min); "
          f"attempts per cosmology {spread(att)}; lanes 0-1 vs JAX golden "
          f"{dev_col:.3g} of column scale, linear {dev_lin:.3g}, headers "
          f"{dev_head:.3g}; launches by phase {launches['by_phase']}")
    print(f"production convert on {card}: 8 HACC steps x {N_PROD} models "
          f"{walls['convert']:.3f} s, vs golden {dev_conv:.3g}; convert-full "
          f"step {PROD_STEP_FULL} ({N_PM} PM + HACC, {N_PROD} models) "
          f"{walls['convert_full']:.3f} s, vs golden {dev_full:.3g}; every "
          "table passes emulator_check against itself")
    print(f"production inject rerun on {card}: 2 lanes x 33 redshifts "
          f"{inj_wall:.3f} s (stages {dict(inj_timer.times)}; attempts "
          f"{inj_timer.stats['attempts']}); norm vs golden {rel:.3g}; vs "
          f"JAX golden {inj_col:.3g} of column scale, linear {inj_lin:.3g}, "
          f"headers {inj_head:.3g}; launches by phase "
          f"{inj_launches['by_phase']}")
    return launches, inj_launches


def run_numerics(detail: dict, card: str) -> dict:
    """The off-by-default numerics: SolverConfig(growth_dense=True,
    quad_impl='gl'), 1-loop at the 1-loop redshifts, 2 design lanes, with
    prepare on the card (prepare_on_host=False: the dense growth
    integration's attempts run K3, its dense fill plain torch), with the
    counters set to 0 just before and read just after (timed_run: K3 in
    prepare, K1-K3 in the solve); lanes 0-1 held to the JAX golden
    (GOLDEN_NUMERICS) within 3e-5 of column scale, linear columns and
    headers within 1e-10 (on the CPU the port is 2.6e-12 / 8.8e-13 from
    it).  Returns the launch counts."""
    from redtime_tpu_torch.config import RunSettings, SolverConfig

    cfg = SolverConfig(**NUMERICS)
    settings = RunSettings(one_loop=True, z_out=Z_OUT_1L)
    params = design_params(N_DESIGN)
    gold = load_golden(GOLDEN_NUMERICS, params, settings, "numerics")
    cs, lins = design_inputs(2, params[:2])
    res, launches, wall, timer = timed_run("numerics", cfg, settings, cs,
                                           lins, detail,
                                           prepare_on_host=False)
    dev_col, dev_lin = golden_dev(res, gold, "numerics")
    detail["numerics"] = dict(wall_s=wall, stages_s=dict(timer.times),
                              attempts=timer.stats["attempts"],
                              golden_dev_col_scale=dev_col,
                              golden_dev_linear_rel=dev_lin,
                              launches=launches)
    print(f"numerics path on {card}: 2 cosmologies, 1-loop, growth_dense, "
          f"quad_impl='gl', prepare on the card: {wall:.3f} s (stages "
          f"{dict(timer.times)}); attempts {timer.stats['attempts']}; lanes "
          f"0-1 vs JAX golden {dev_col:.3g} of column scale, linear "
          f"{dev_lin:.3g}; launches by phase {launches['by_phase']}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from redtime_tpu_torch.kernels import build

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    detail: dict = {"card": card}

    t_start = time.perf_counter()
    lib = build.build()
    build_s = time.perf_counter() - t_start
    print(f"build: nvcc {build_s:.3f} s ({lib.name})")
    detail["build"] = dict(build.BUILD_LOG, wall_s=build_s)
    phase_s = detail["phase_s"] = {}

    def timed(name: str, fn, *args):
        """fn(*args), its wall booked to phase_s[name]."""
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    timed("tensor_cores", check_tensor_cores, lib, detail)
    rows = timed("kernels", check_kernels, np.random.default_rng(1234),
                 detail)
    timed("leg_shapes", check_leg_shapes, np.random.default_rng(2468),
          detail)
    presets = timed("preset_rows", preset_rows, np.random.default_rng(1357),
                    detail)
    for r in rows:
        if r["name"] in presets:
            r["preset_shapes"] = presets[r["name"]]
    rows += timed("probe_kernels", check_probe_kernels,
                  np.random.default_rng(4321), detail)
    for r in rows:
        lib_ms = r["library_ms"]
        print(f"kernel {r['name']}: {r['ms']:.4f} ms eager, "
              f"{r['device_ms']:.4f} ms device (plain {r['plain_ms']:.4f} / "
              f"{r['plain_device_ms']:.4f} ms; library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}; bound "
              f"{r['bound_ms']:.5f} ms by {r['bound_by']}), max |delta| "
              f"{r['max_abs_err']:.3g}")
    # each path runs with the counters set to 0 just before it; a
    # kernel's launches are the sum over the paths that ran it
    phases = dict(probes=timed("probes", run_probes, detail))
    phases.update(timed("main_path", run_main_path, detail, card))
    launches_1l, res_1l = timed("oneloop", run_oneloop, detail, card)
    phases.update(launches_1l)
    launches_64, res_64 = timed("batch64", run_batch64_paths, detail, card)
    phases.update(launches_64)
    phases.update(timed("packed", run_packed_paths, res_64, res_1l, detail,
                        card))
    phases.update(timed("shard", run_shard, res_64, detail, card))
    phases["cli"], cli_texts = timed("cli", run_cli, detail, card)
    phases.update(
        cli_packed=timed("cli_packed", run_cli_packed, detail, card),
        cli_shard=timed("cli_shard", run_cli_shard, cli_texts, detail, card))
    timed("worker_fault", run_worker_fault, detail, card)
    phases.update(timed("presets", run_presets, detail, card))
    phases.update(grid_nk48=timed("grid_nk48", run_ragged_grid, detail,
                                  card))
    phases["production"], phases["inject_rerun"] = timed(
        "production", run_production, detail, card)
    phases.update(numerics=timed("numerics", run_numerics, detail, card))
    print(f"phase walls (s): { {k: round(v, 1) for k, v in phase_s.items()} }"
          f"; {time.perf_counter() - t_start:.1f} s since the build began")
    for r in rows:
        r["launches_by_path"] = {k: p[r["name"]] for k, p in phases.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        r["launches_by_phase"] = {
            k: {ph: n[r["name"]] for ph, n in p["by_phase"].items()}
            for k, p in phases.items() if "by_phase" in p}
    detail["kernels"] = rows
    os.makedirs(os.path.dirname(DETAIL), exist_ok=True)
    with open(DETAIL, "w") as f:
        json.dump(detail, f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
