"""Smoke run of the PyTorch port (redtime_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, nvcc and g++.

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from redtime_tpu_torch/csrc with nvcc
     (sm_90a), and the host IO library (csrc/redtime_io.cpp) with g++,
     and checks that K1's and K2's SASS holds FP64
     tensor-core instructions (DMMA), K5's int8 mma.sync (IMMA) and K7's
     int8 wgmma (IGMMA), by cuobjdump;
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
     checked and timed with their bounds (preset_rows); K1 at the
     benchmark's solve cells' shapes (512 lanes at nk=128, 64 at nk=512),
     checked and timed with its bound, its share of it and the schedule
     its launch took, from out_leg.SCHEDULE_LAUNCHES (k1_cell_rows; the
     main path's 16-lane row carries its schedule too); K8 rhs_tail on
     the inputs trg.rhs_prologue builds from design models and generated
     states, at every (nk, lanes) the main paths give it (RT_SHAPES) in
     full TRG with and without RSD, 1-loop and linear, with a NaN lane
     and a frozen lane: within 1e-11 of each (lane, row)'s scale of its
     plain version, NaN and inf in the same places, two calls the same
     bits; its registers and spills (ptxas); its device time at every (nk, lanes, mode) the
     paths run it at (RT_TIMED) with its bound and the launch floor, and
     at full TRG 16 lanes and 1-loop 32 also eager and against its plain
     version, with the device kernels of one RHS evaluation
     (torch.profiler; at most 250 full TRG, 150 1-loop) and its host ms;
     K9 engine_front and K10 tab_leg on what the paths feed the engine
     from those states (ENGINE_CASES: the RHS's clipped ln P rows in full
     TRG with and without RSD at nk=128 and 16, 32, 64, 8 lanes and at
     nk=48, 2 lanes; the presets' 1-loop cache and finalize rows), within
     their stated forward-error bounds of their plain versions, NaN lanes
     NaN alone, two calls the same bits, each timed on the device with its
     bound (the FFTs' and, for the history, the GEMM form's), and at full
     TRG 16 lanes eager and against plain, (K10) the library's matmul and
     both against cuFFT (torch.fft: yardsticks the port never calls);
     K11 out_block on each path's output block (OB_CASES: full TRG 16 x
     8 redshifts, 1-loop 32 x 7 with and without print_bias, every
     switch on (84 columns), fill_pt_full_trg, linear, the presets, nk =
     48, production's 16 x 33 in both modes, kmin != 1e-3) and on
     edge-case lanes (ob_edges: f_nu = 0, NaN and zero states, a past 1,
     a growth node on ln a, 4 and no beta nodes), fed what
     driver._finalize feeds it (the engine over the B n_z lanes where the
     layout needs it): within 1e-11 of column scale of its plain version,
     NaN and inf in the same places, two calls the same bits, the
     bit-equal share printed beside the previous design's; its ptxas line
     and stack bytes; eager, device and plain ms and its bound
     each; and each path case's finalize launches K11 alone, or K9, K10,
     K1, K2 then K11, and no other kernel;
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
     finite, that the solve launched K1-K3 (rk_stage and rk_finish), K8
     and K11, that
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
 12. the host IO runtime (run_io; built with g++ beside the kernels,
     build_io, its OpenMP runtime started once and checked to write
     nothing to stderr): every production stack parsed by
     native.parse_stack, bit-equal to np.loadtxt, and step 5's full-TRG
     table formatted by native.format_rows, byte-equal to the f-strings,
     both timed against their plain versions in turns, torch's thread
     count unchanged;
 13. runs the off-by-default numerics (run_numerics: growth_dense and
     quad_impl='gl', 1-loop, 2 lanes, prepare on the card) against
     tests/data/torch_port_golden_numerics.npz (--case numerics);
 14. holds the card's engine (K9 -> K10 -> K1 + K2 on a BBKS spectrum)
     to the port's continuum oracle (quadrature.j_quadrature,
     pz_quadrature, jreg_ir_counterterm) on the card, at
     tests/test_quadrature.py's bounds (run_oracle);
 15. prints the kernels' JSON line, the card line and, last, the result.

Every path from step 4 on runs with the launch counters set to 0 just
before it and read just after, and must have launched K1-K3 and K8-K11
(the probes: K4-K7 and K1), with as many launches of K9 and K10 as of K1
and K2 (every engine evaluation K9 -> K10 -> K1 + K2); a worker process's
launches come back with its answer.

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
MAIN_KERNELS = ("engine_front", "tab_leg", "out_leg", "pz_leg", "rk_stage",
                "rk_finish", "rhs_tail", "out_block")
# the engine's kernels: one launch each an engine evaluation, on every path
ENGINE_KERNELS = ("engine_front", "tab_leg", "out_leg", "pz_leg")
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
# the oracle phase (run_oracle): tests/test_quadrature.py's points, orders
# and bounds (fraction of the family's peak, PZ for n < 0 and n >= 0; the
# Jreg identity relative)
ORACLE_IDX, ORACLE_JREG_IDX = (24, 48, 72, 96), (48, 64, 80, 96)
ORACLE_J_BOUND, ORACLE_PZ_BOUNDS, ORACLE_JREG_BOUND = 5e-3, (3e-3, 4e-2), \
    5e-3


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
        schedule=k1_schedule(lambda: k1.out_leg(tab, ec.G)),
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


# K8 rhs_tail at the main paths' (nk, lanes): full-TRG chunks (16), 1-loop
# chunks (32), packed lanes (64), the split's shards (8, 32), the ragged
# grid (48, 2) and the presets (512, 256; 2 lanes); its modes as
# RunSettings; the bound against K8's plain version (of each (lane, row)'s
# max |plain| over k) and the device kernels of one RHS evaluation: the
# hand kernels alone (full TRG K9, K10, K1, K2 and K8; 1-loop and linear
# K8)
RT_SHAPES = ((128, 16), (128, 32), (128, 64), (128, 8), (48, 2), (512, 2),
             (256, 2))
RT_MODES = {"full": dict(one_loop=False),
            "full_no_rsd": dict(one_loop=False, print_rsd=False),
            "oneloop": dict(one_loop=True),
            "linear": dict(one_loop=False, nonlinear=False)}
RT_BOUND = 1e-11
RHS_KERNELS = {"full": 5, "oneloop": 1, "linear": 1}
RHS_KERNEL_NAMES = {"full": ("engine_front", "tab_leg", "out_leg", "pz_leg",
                             "rhs_tail"),
                    "oneloop": ("rhs_tail",), "linear": ("rhs_tail",)}
# the (nk, lanes) at which K8 also runs on edge-case lanes (rt_edges)
RT_EDGE_SHAPE = (128, 8)
# the (nk, lanes, mode) at which the paths run K8, timed on the device
RT_TIMED = ((128, 16, "full"), (128, 64, "full"), (128, 8, "full"),
            (48, 2, "full"), (128, 32, "oneloop"), (512, 2, "oneloop"),
            (256, 2, "oneloop"))


def rt_config(nk: int):
    """The SolverConfig the main path runs at nk."""
    from redtime_tpu_torch.config import SolverConfig
    return {512: SolverConfig.high_accuracy, 256: SolverConfig.v01_compat,
            128: SolverConfig}.get(nk, lambda: SolverConfig(nk=nk))()


def rt_state(rng, cfg, settings, m, B: int):
    """(eta [B], y [B, 41 nk]) on the card: the initial lnP rows grown by
    e^eta and I/Q rows of the spectrum's scale from the generator; lane 1
    (when B > 2) frozen at its initial state, the last lane NaN (as the
    chunked scheduler poisons an unfinished lane)."""
    import torch

    from redtime_tpu_torch import trg

    nk = cfg.nk
    eta = rng.uniform(0.5, 4.0, B)
    y = trg.initial_state(cfg, settings, m).reshape(B, 41, nk).cpu().numpy()
    y0 = y.copy()
    y[:, :3] += 2.0 * eta[:, None, None]
    y[:, 3:] = 1e-3 * np.exp(y[:, :1]) * rng.standard_normal((B, 38, nk))
    if B > 2:
        y[1], eta[1] = y0[1], 0.0
    y[-1] = np.nan
    t = lambda x: torch.as_tensor(x, dtype=torch.float64, device="cuda")
    return t(eta), t(y.reshape(B, -1))


def rt_dev(got, ref) -> float:
    """max |got - ref| over each (lane, row)'s max |ref| over k, on the
    elements where ref is finite."""
    import torch

    fin = torch.isfinite(ref)
    scale = torch.where(fin, ref.abs(), 0.0).amax(-1, keepdim=True)
    d = torch.where(fin, (got - ref).abs(), 0.0) / (scale + 1e-300)
    return float(d.max())


def rt_cost(args) -> dict:
    """least_time of one rhs_tail: read once, each row of y, Jw, PZw, A_u
    and R that the variant's work items read (rhs_tail.item_rows: the A/R
    program reads 102 of full TRG's 189 feature rows; no column of Jw past
    nk), k, the 4 rows of the beta table that each lane's a brackets
    (with a table) and its nodes, in 1-loop mode the 4 rows each of G and
    dD/da, Dnorm, D_z1l and the ln a nodes, and the 15 lane scalars (f_nu,
    Omega_m, the 13 constants) and eta; dy written once.  Operations: the
    distinct ones a k point, the lookups' 4-node sums (8 a table) and
    o10, D, dD/da, fz, pre; a lane's bracketing (one compare a node, the
    4 weights' 24) and Omega scalars (~40, pow and exp counted as 20
    each)."""
    from redtime_tpu_torch.kernels import rhs_tail as rt

    y, eta, k, om, src, evolve_q = args
    B, _, nk = y.shape
    var = rt.variant(rt.mode_of(src), evolve_q)
    rows = set().union(*(rt.item_rows(var, it) for it in rt.items(var)))
    oneloop = isinstance(src, rt.OneLoopSrc)
    nz = om.beta_a.shape[1]
    nn = src.g_lna.shape[1] if oneloop else 0
    per_point = len(rows) + rt.NU_STATE + 4 * (nz > 0) + 10 * oneloop
    per_lane = 1 + 2 + len(om.consts) + nz + nn
    nbytes = 8.0 * (B * nk * per_point + B * per_lane + nk)
    nout = 0 if src is None else 14 + (24 if evolve_q else 0)
    omega = sum(len(t) for t in rt.kernel_table()[0][:nout])
    if isinstance(src, rt.FullSrc):
        ops, vals = rt._ar()
        ops_pt = sum(ops[i][0] not in ("f", "k")
                     for i in set().union(*vals[:nout]))
    else:
        ops_pt = 12 + 3 * nout
    ops_pt += 2 * omega + 40                       # Omega terms, dlnP
    ops_pt += 8 * (nz > 0) + 4 + oneloop * (2 * 8 + 3)   # the lookups
    ops_lane = 140 + nz + 24 + oneloop * (nn + 24 + 60)
    return least_time(nbytes, float(ops_pt) * B * nk + ops_lane * B,
                      PEAK_FP64)


def device_kernels(fn, calls: int = 10, tries: int = 3) -> tuple:
    """(device kernels, device busy ms) a call of fn() under
    torch.profiler (CUDA activity, as profile_torch_port.device_profile
    counts them), after one untimed call, and the names of the kernels:
    `calls` calls in a window between two marker kernels
    (torch.cuda._sleep's spin_kernel: a window loses the record of its
    first or last kernel now and then, the markers take that loss and
    are not counted), the window with the most kernels of `tries`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = (-1, 0.0, ())
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        cuda = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "spin_kernel" not in e.key]
        n = sum(e.count for e in cuda)
        if n > best[0]:
            best = (n, sum(e.self_device_time_total for e in cuda) / 1e3,
                    tuple(sorted({e.key for e in cuda})))
    return best[0] / calls, best[1] / calls, best[2]


def attempt_device_kernels(cfg, rhs, eta, y) -> int:
    """The device kernels of one controller attempt (ode.attempt: the
    stages' RHS evaluations, K3 and the attempt's own operations) from
    eta at step 1e-2 on every lane."""
    import torch

    from redtime_tpu_torch import ode, trg
    from redtime_tpu_torch.kernels import rk_finish as k3

    B, dev = y.shape[0], y.device
    consts = k3.attempt_consts(trg.eta_tableau(cfg), cfg.eabs_P,
                               cfg.erel_P, dev)
    t = eta.clone()
    t1 = t + 0.5
    h = torch.full_like(t, 1e-2)
    n = torch.zeros(B, dtype=torch.int64, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    return device_kernels(lambda: ode.attempt(rhs, t, h, y, t1, n, active,
                                              consts), calls=2)[0]


def rt_edges(args, prologue, eta, y) -> dict:
    """K8's arguments at edge cases, from the 8-lane arguments `args` that
    prologue(eta, y) made (rhs_prologue's): lane 0 as it is, lane 1 with
    f_nu = 0, lane 2 at a = 1.3 (clamped to the table's a = 1), lane 3 at
    half the table's first a, lane 4 with a beta node (and, 1-loop, a ln a
    node) moved onto its a (ln a), lanes 5 and 6 with a_nu just above and
    on their a, lane 7 with eta and y NaN; then the same with a table of
    4 beta nodes and with none (nz = 0).  a and ln a are computed as the
    plain version computes them, on the card.  Returns name -> args."""
    import torch

    from redtime_tpu_torch.kernels import rhs_tail as rt

    _, _, _, om, src, evolve_q = args
    eta, y = eta.clone(), y.clone()
    a_in = om.a_in
    beta_a = om.beta_a.clone()
    eta[2] = float(np.log(1.3 / a_in))
    eta[3] = float(np.log(0.5 * float(beta_a[3, 0]) / a_in))
    eta[4] = float(np.log(0.5 * float(beta_a[4, 2] + beta_a[4, 4]) / a_in))
    eta[7] = float("nan")
    y[7] = float("nan")
    a = a_in * torch.exp(eta)
    beta_a[4, 3] = a[4]
    f_nu = om.f_nu.clone()
    f_nu[1] = 0.0
    a_nu = om.consts.a_nu.clone()
    a_nu[5] = torch.nextafter(a[5], a[5] + 1.0)
    a_nu[6] = a[6]
    om8 = om._replace(beta_a=beta_a, f_nu=f_nu,
                      consts=om.consts._replace(a_nu=a_nu))
    if isinstance(src, rt.OneLoopSrc):
        z = torch.exp(-eta) * (1.0 + src.z_in) - 1.0
        lna = torch.log(torch.reciprocal(1.0 + z))
        g_lna = src.g_lna.clone()
        g_lna[4, int((g_lna[4] - lna[4]).abs().argmin())] = lna[4]
        src = src._replace(g_lna=g_lna)
    y_, eta_, k, _, src_, _ = prologue(eta, y)
    if isinstance(src, rt.OneLoopSrc) or src is None:
        src_ = src
    pick = torch.tensor([0, 3, 5, 7], device=beta_a.device)
    om4 = om8._replace(beta_a=beta_a[:, pick].contiguous(),
                       beta_solver=om.beta_solver[:, pick].contiguous())
    om0 = om8._replace(beta_a=beta_a[:, :0].contiguous(),
                       beta_solver=om.beta_solver[:, :0].contiguous())
    return {f"edges nz={o.beta_a.shape[1]}": (y_, eta_, k, o, src_,
                                              evolve_q)
            for o in (om8, om4, om0)}


def rt_compare(got, ref, what: str) -> tuple:
    """K8's dy against its plain version's: NaN and inf in the same
    places, within RT_BOUND of row scale; (deviation, bit-equal share of
    the finite elements, max |delta|)."""
    import torch

    check(bool(torch.equal(got.isnan(), ref.isnan())
               and torch.equal(got.isinf(), ref.isinf())),
          f"{what}: NaN or inf where the plain version has none")
    err = rt_dev(got, ref)
    check(err <= RT_BOUND, f"{what}: {err:.3g} of row scale from plain "
                           f"(bound {RT_BOUND:g})")
    fin = torch.isfinite(ref)
    return (err, float((got == ref)[fin].double().mean()),
            float(torch.where(fin, (got - ref).abs(), 0.0).max()))


def check_rhs_tail(rng, detail: dict, engine_inputs: list) -> dict:
    """K8 rhs_tail against its plain version on the card, on the inputs
    trg.rhs_prologue builds from design models and generated states, at
    every (nk, lanes) of RT_SHAPES in every mode of RT_MODES: within
    RT_BOUND of each (lane, row)'s scale, NaN and inf in the same places
    (a NaN lane, a frozen lane), two calls the same bits.  Times it at RT_TIMED on the device (20 calls in
    a CUDA graph, 3 readings) with its bound and the launch floor beside,
    and at full TRG 16 lanes and 1-loop 32 also eager and against its
    plain version; prints its registers and spills (ptxas); counts the
    device kernels of one full-TRG and one 1-loop RHS evaluation and
    times the evaluation on the host clock.  Appends to engine_inputs
    what the engine is fed at ENGINE_CASES (engine_inputs).  Returns the
    kernels' line row."""
    import torch

    from redtime_tpu_torch import driver, fastpt, trg
    from redtime_tpu_torch import model as mdl
    from redtime_tpu_torch.config import RunSettings
    from redtime_tpu_torch.kernels import build
    from redtime_tpu_torch.kernels import rhs_tail as rt

    dev = torch.device("cuda")
    log = build.BUILD_LOG.get("output", "")
    ptxas = {v: ptxas_of(log, f"rhs_tail_kernelILi{i}E")
             for i, v in enumerate(rt.VARIANTS)}
    print(f"rhs_tail ptxas: {ptxas}")
    stream = torch.cuda.current_stream
    floor = graph_ms(lambda: build.check(
        build.lib().rt_launch_floor(stream().cuda_stream), "launch_floor"))
    cs, lins = design_inputs(2)
    chunk = ([x.numpy() for x in cs], list(lins), None)
    cases, timed, by_shape, max_err = [], {}, [], 0.0
    for nk, B in RT_SHAPES:
        cfg = rt_config(nk)
        m2 = driver._prepare(cfg, chunk, dev, True)
        m = mdl.take_lanes(m2, torch.arange(B, device=dev) % 2)
        ec = fastpt.engine_consts(cfg, dev)
        for mode, kw in RT_MODES.items():
            settings = RunSettings(z_out=Z_OUT_1L, **kw)
            cache = (trg.build_oneloop_cache(cfg, settings, m, ec)
                     if settings.one_loop else None)
            eta, y = rt_state(rng, cfg, settings, m, B)
            if (nk, B, mode) in ENGINE_CASES:
                engine_inputs += engine_inputs_of(cfg, settings, m, ec, y,
                                                  mode)
            prologue = trg.rhs_prologue(cfg, settings, m, ec, cache)
            args = prologue(eta, y)
            var = rt.variant(rt.mode_of(args[4]), args[5])
            plan = rt.launch_plan(var, nk, B)
            edges = (rt_edges(args, prologue, eta, y)
                     if (nk, B) == RT_EDGE_SHAPE and mode != "full_no_rsd"
                     else {})
            for tag, a in [("", args)] + list(edges.items()):
                got = rt.rhs_tail(*a)
                ref = rt.rhs_tail_plain(*a)
                what = f"rhs_tail {mode} nk={nk} B={B}{' ' + tag * bool(tag)}"
                check(same_bits(got, rt.rhs_tail(*a)),
                      f"{what}: two calls on the same inputs differ")
                check(bool(got[-1, :3].isnan().all()),
                      f"{what}: the NaN lane's dlnP is not NaN")
                err, share, delta = rt_compare(got, ref, what)
                max_err = max(max_err, delta)
                cases.append(dict(mode=mode, nk=nk, B=B, edges=tag,
                                  dev_row_scale=err, bit_equal_share=share,
                                  **plan))
                print(f"{what}: {err:.3g} of row scale from plain, "
                      f"{share:.4f} of the finite elements bit-equal")
            if (nk, B, mode) in RT_TIMED:
                runs = [graph_ms(lambda: rt.rhs_tail(*args))
                        for _ in range(3)]
                row = dict(nk=nk, B=B, mode=mode, device_ms=float(
                    np.median(runs)), device_runs=runs, **plan,
                    **rt_cost(args))
                by_shape.append(row)
                print(f"rhs_tail timed {mode} nk={nk} B={B}: "
                      f"{row['device_ms']:.5f} ms device ({plan['tasks']} "
                      f"tasks, {plan['blocks']} blocks of "
                      f"{plan['threads']} threads); bound "
                      f"{row['bound_ms']:.5f} ms by {row['bound_by']}, "
                      f"launch floor {floor:.5f} ms")
            if (nk, B, mode) in ((128, 16, "full"), (128, 32, "oneloop"),
                                 (128, 32, "linear")):
                what = f"rhs_tail {mode} nk={nk} B={B}"
                rhs = trg.make_rhs(cfg, settings, m, ec, cache)
                n_kernels, busy, names = device_kernels(lambda: rhs(eta, y))
                hand = [n for n in names
                        if any(k in n for k in RHS_KERNEL_NAMES[mode])]
                check(n_kernels == RHS_KERNELS[mode] and hand == list(names)
                      and len(names) == RHS_KERNELS[mode],
                      f"{what}: one RHS evaluation ran {n_kernels} device "
                      f"kernels {names} (the hand kernels are "
                      f"{RHS_KERNELS[mode]}: {RHS_KERNEL_NAMES[mode]})")
                n_attempt = attempt_device_kernels(cfg, rhs, eta, y)
                host = rhs_host_ms(rhs, eta, y)
                print(f"{what}: one RHS evaluation {n_kernels} device "
                      f"kernels, {busy:.4f} ms busy, {host:.3f} ms host; "
                      f"one attempt {n_attempt} device kernels")
                row = dict(B=B, nk=nk, rhs_device_kernels=n_kernels,
                           rhs_device_busy_ms=busy, rhs_host_ms=host,
                           attempt_device_kernels=n_attempt)
                if mode == "linear":
                    detail["rhs_linear"] = row
                    continue
                t, runs = measure(lambda: rt.rhs_tail(*args),
                                  lambda: rt.rhs_tail_plain(*args))
                timed[mode] = dict(t, **rt_cost(args), **row)
                detail[f"rhs_tail_timing_{mode}"] = runs
                print(f"rhs_tail {mode} (B={B}): {t['ms']:.4f} ms eager, "
                      f"{t['device_ms']:.5f} ms device (plain "
                      f"{t['plain_ms']:.4f} / {t['plain_device_ms']:.4f}); "
                      f"bound {timed[mode]['bound_ms']:.5f} ms by "
                      f"{timed[mode]['bound_by']}")
    detail.update(rhs_tail_cases=cases, rhs_tail_by_shape=by_shape,
                  rhs_tail_ptxas=ptxas)
    full = timed["full"]
    return dict(
        name="rhs_tail", route="cuda",
        source="redtime_tpu_torch/csrc/rhs_tail.cu",
        replaces="redtime_tpu/trg.py:178",
        also_replaces="redtime_tpu/trg.py:84 (omega_matrix), :136 "
                      "(oneloop_rescale), redtime_tpu/assembly.py:172 (A/R), "
                      "redtime_tpu/model.py:126 (beta_P lookup), :509 "
                      "(growth_D_f), redtime_tpu/background.py:71 (H2_H02, "
                      "dlnH_dlna)",
        max_abs_err=max_err,
        max_dev_row_scale=max(c["dev_row_scale"] for c in cases),
        launch_floor_ms=floor, oneloop=timed["oneloop"], by_shape=by_shape,
        ptxas=ptxas,
        **{k: full[k] for k in ("ms", "device_ms", "plain_ms",
                                "plain_device_ms", "library_ms", "bound_ms",
                                "bound_by", "bound_bytes", "bound_ops",
                                "rhs_device_kernels", "rhs_device_busy_ms",
                                "rhs_host_ms", "attempt_device_kernels")})


# the (nk, lanes, mode) of check_rhs_tail at which K9 and K10 are checked
# on what the paths feed the engine (engine_inputs_of): full TRG with and
# without RSD at the chunks (16), the 1-loop chunk's width (32), packed
# lanes (64) and the split's shards (8), nk=48; the presets' 1-loop cache
# and finalize.  ENGINE_TIMED: the main path's case, timed eager and
# against plain and library; the others on the device only.
ENGINE_CASES = {(128, B, mode) for B in (16, 32, 64, 8)
                for mode in ("full", "full_no_rsd")} | {
    (48, 2, "full"), (48, 2, "full_no_rsd"), (512, 2, "oneloop"),
    (256, 2, "oneloop")}
ENGINE_TIMED = "full nk=128 B=16"


def engine_inputs_of(cfg, settings, m, ec, y, mode: str) -> list:
    """What the paths feed the engine (fastpt.compute_J_PZ) from the state
    y [B, 41 nk] of rt_state (a NaN lane, a frozen lane: lane 0 when B =
    2): in full TRG the RHS's ln P rows (a strided view, clipped), in
    1-loop mode the z1l cache's ln P_lin_cb rows (an expanded row) and
    finalize's rows of y (unclipped).  Each a dict: label, cfg, ec, the
    wrappers' arguments (front: the plain version's; band: what K9's
    kernel reads instead of pab_M and dft_fwd_half; clip) and nfam."""
    import torch

    from redtime_tpu_torch import fastpt, trg
    from redtime_tpu_torch import model as mdl

    B, nk = y.shape[0], cfg.nk
    y = y.reshape(B, trg.NU_STATE, nk)
    if B == 2:
        y = y.clone()
        y[0] = trg.initial_state(cfg, settings, m)[0].reshape(-1, nk)
    n_s = m.cosmo.n_s
    rsd = settings.print_rsd or cfg.print_q
    nfam = fastpt.NFAM if rsd else fastpt.NFAM_J
    label = f"{mode} nk={nk} B={B}"
    consts = (ec.pab_M, ec.pab_v, ec.wp, ec.kbias, ec.dft_fwd_half)
    band = (ec.pab_j0, ec.pab_w, ec.wc_half, ec.twiddle)
    if mode != "oneloop":
        return [dict(label=label, cfg=cfg, ec=ec, nfam=nfam, clip=True,
                     front=(y[:, :3], n_s) + consts, band=band)]
    _, Pcb, _ = mdl.plin_all(cfg, m, cfg.z1l)
    cache = torch.log(Pcb)[:, None, :].expand(-1, 3, -1)
    nfam_out = fastpt.NFAM if settings.print_rsd else fastpt.NFAM_J
    return [dict(label=f"{label} cache", cfg=cfg, ec=ec, nfam=nfam,
                 clip=False, front=(cache, n_s) + consts, band=band),
            dict(label=f"{label} finalize", cfg=cfg, ec=ec, nfam=nfam_out,
                 clip=False, front=(y[:, :3], n_s) + consts, band=band)]


def fft_flops(n: int) -> float:
    """Floating-point operations of a complex FFT of length n along
    fourier.fft_plan(n): 5 n log2 p a radix-p stage (p = 2, 4, 8: the
    butterflies and twiddle products), 8 n R the direct odd R-point
    stage."""
    from redtime_tpu_torch import fourier

    return float(sum(5.0 * n * (p.bit_length() - 1) if p & (p - 1) == 0
                     else 8.0 * n * p for p in fourier.fft_plan(n)))


def engine_costs(B: int, nk: int, npts: int, nc: int, nfam: int) -> tuple:
    """least_time of K9 and of K10 as they now run, FFTs on the FP64 pipes
    (each input read once, each output written once, the twiddle table
    [2np, 2] whole), and the GEMM form's least time of each (the products
    with the dense pab_M, dft_fwd_half and dft_bwd_half on the FP64 tensor
    cores: the earlier kernels' bound, kept for the history).  K9: the
    band's 4 FMAs, the real split (10 flops an output) and a complex FFT
    of length np / 2 a row; K10: forming X and Z (16 flops a frequency)
    and a complex FFT of length np a row."""
    N, half, rows = 2 * npts, nc // 2, 3 * B
    k9 = least_time(8.0 * (3 * B * nk + B + 3 * npts + half + 2 * N
                           + 3 * B * npts + 3 * B * nc) + 36.0 * npts,
                    rows * (8.0 * npts + 10.0 * half + fft_flops(half)),
                    PEAK_FP64)
    M = 6 * nfam * B
    k10 = least_time(8.0 * (3 * B * nc + 4 * nfam * half + 2 * N + M * N),
                     M * (16.0 * half + fft_flops(npts)), PEAK_FP64)
    gemm9 = least_time(8.0 * (3 * B * nk + B + npts * nk + 3 * npts
                              + npts * nc + 3 * B * npts + 3 * B * nc),
                       2.0 * 3 * B * npts * (nk + nc), PEAK_FP64_TC)
    gemm10 = least_time(8.0 * (3 * B * nc + 4 * nfam * half + nc * N
                               + M * N), 2.0 * M * nc * N, PEAK_FP64_TC)
    for row, gemm in ((k9, gemm9), (k10, gemm10)):
        row.update(gemm_bound_ms=gemm["bound_ms"],
                   gemm_bound_by=gemm["bound_by"])
    return k9, k10


def bound_ratio(got, ref, bound, what: str) -> float:
    """max |got - ref| / bound over the finite elements of ref; raises
    when NaN or inf fall elsewhere than in ref."""
    import torch

    check(bool(torch.equal(got.isnan(), ref.isnan())
               and torch.equal(got.isinf(), ref.isinf())),
          f"{what}: NaN or inf where the plain version has none")
    fin = torch.isfinite(ref)
    return float(((got - ref).abs()[fin] / bound[fin].clamp(min=1e-300))
                 .max())


def check_engine_legs(cases: list, detail: dict) -> list:
    """K9 engine_front and K10 tab_leg against their plain versions on the
    card, on what the paths feed the engine (engine_inputs_of, at
    ENGINE_CASES): within their stated forward-error bounds
    (engine_front.error_bound, tab_leg.error_bound), NaN lanes NaN and no
    other lane, two calls the same bits.  K10 takes the plain version's ci.
    Times both on the device at every case and, at ENGINE_TIMED, eager and
    against plain, (K10) the library's matmul on the plain version's sab,
    and cuFFT as a yardstick (torch.fft.rfft of P_ext kbias for K9,
    torch.fft.irfft of the zero-padded complex sab for K10); returns their
    rows for the kernels' line."""
    import torch

    from redtime_tpu_torch.kernels import engine_front as k9
    from redtime_tpu_torch.kernels import tab_leg as k10

    rows, by_case = {}, {"engine_front": [], "tab_leg": []}
    worst = {"engine_front": 0.0, "tab_leg": 0.0}
    max_err = dict(worst)
    for c in cases:
        front, clip, nfam, ec = c["front"], c["clip"], c["nfam"], c["ec"]
        what = c["label"]
        band = c["band"]
        P, ci = k9.engine_front(*front, *band, clip=clip)
        P_ref, ci_ref, dP, dci = k9.error_bound(*front, clip=clip)
        g = (ec.ga_re, ec.ga_im, ec.gb_re, ec.gb_im, ec.dft_bwd_half)
        tab = k10.tab_leg(ci_ref, *g, ec.twiddle, nfam)
        tab_ref, dtab = k10.error_bound(ci_ref, *g, nfam)
        ratios = {}
        for name, pairs in (("engine_front", ((P, P_ref, dP),
                                              (ci, ci_ref, dci))),
                            ("tab_leg", ((tab, tab_ref, dtab),))):
            r = max(bound_ratio(*p, f"{name} {what}") for p in pairs)
            check(r <= 1.0, f"{name} {what}: |delta|/bound {r:.3g}")
            ratios[name] = r
            worst[name] = max(worst[name], r)
            max_err[name] = max(max_err[name], max(
                float(torch.where(torch.isfinite(p[1]), (p[0] - p[1]).abs(),
                                  0.0).max()) for p in pairs))
        for x, ref in ((P, P_ref), (ci, ci_ref), (tab, tab_ref)):
            lanes = ref.flatten(1).isnan().any(1)
            check(bool(torch.equal(x.flatten(1).isnan().all(1), lanes)),
                  f"{what}: NaN lanes {lanes.tolist()} not NaN alone")
        P2, ci2 = k9.engine_front(*front, *band, clip=clip)
        check(same_bits(P, P2) and same_bits(ci, ci2),
              f"engine_front {what}: two calls differ")
        check(same_bits(tab, k10.tab_leg(ci_ref, *g, ec.twiddle, nfam)),
              f"tab_leg {what}: two calls differ")
        B, _, nk = front[0].shape
        npts, nc = ec.dft_fwd_half.shape
        costs = dict(zip(("engine_front", "tab_leg"),
                         engine_costs(B, nk, npts, nc, nfam)))
        calls = dict(engine_front=lambda: k9.engine_front(*front, *band,
                                                          clip=clip),
                     tab_leg=lambda: k10.tab_leg(ci_ref, *g, ec.twiddle,
                                                 nfam))
        line = []
        for name, fn in calls.items():
            row = dict(case=what, B=B, nk=nk, np=npts, nfam=nfam, clip=clip,
                       nan_lanes=int(ci_ref.flatten(1).isnan().any(1).sum()),
                       err_over_bound=ratios[name], device_ms=graph_ms(fn),
                       **costs[name])
            by_case[name].append(row)
            line.append(f"{name} {row['device_ms']:.5f} ms device, "
                        f"|delta|/bound {ratios[name]:.3g} (bound "
                        f"{row['bound_ms']:.5f} by {row['bound_by']})")
        print(f"engine legs {what} (nfam {nfam}, clip {clip}): "
              + "; ".join(line))
        if what != ENGINE_TIMED:
            continue
        sab = k10.sab_plain(ci_ref, *g[:4], nfam)
        half = nc // 2
        spec = torch.complex(sab[..., :half], sab[..., half:])
        Q = P_ref * front[5]
        t9, runs9 = measure(calls["engine_front"],
                            lambda: k9.engine_front_plain(*front, clip=clip))
        t10, runs10 = measure(calls["tab_leg"],
                              lambda: k10.tab_leg_plain(ci_ref, *g, nfam),
                              lambda: torch.matmul(sab, g[4]))
        fft9 = [graph_ms(lambda: torch.fft.rfft(Q)) for _ in range(3)]
        fft10 = [graph_ms(lambda: torch.fft.irfft(spec, n=2 * npts))
                 for _ in range(3)]
        detail.update(engine_front_timing=runs9, tab_leg_timing=runs10,
                      engine_front_cufft_rfft=fft9,
                      tab_leg_cufft_irfft=fft10)
        rows["engine_front"] = dict(
            t9, **costs["engine_front"], cufft_ms=float(np.median(fft9)),
            cufft_note="torch.fft.rfft(P_ext kbias): the forward leg "
                       "alone, a yardstick (no single call computes K9)")
        rows["tab_leg"] = dict(
            t10, **costs["tab_leg"], cufft_ms=float(np.median(fft10)),
            library_note="torch.matmul(sab, dft_bwd_half) on the plain "
                         "version's sab: leaves out the window products; "
                         "cufft_ms: torch.fft.irfft of the zero-padded "
                         "complex sab at n = 2np, a yardstick")
    check(set(rows) == {"engine_front", "tab_leg"},
          f"no engine case {ENGINE_TIMED!r} was checked")
    print(f"engine legs: K9 and K10 within their bounds at {len(cases)} "
          f"inputs (worst |delta|/bound {worst}), two calls the same bits")
    out = []
    for name, src, rep in (
            ("engine_front", "redtime_tpu_torch/csrc/engine_front.cu",
             "redtime_tpu/fastpt.py:908"),
            ("tab_leg", "redtime_tpu_torch/csrc/tab_leg.cu",
             "redtime_tpu/fastpt.py:1227")):
        out.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            max_abs_err=max_err[name], max_err_over_bound=worst[name],
            by_case=by_case[name], **rows[name]))
    out[0]["also_replaces"] = ("redtime_tpu/fastpt.py:1193 (the forward "
                               "leg), redtime_tpu/trg.py:185 (the clip)")
    out[1]["also_replaces"] = "redtime_tpu/fastpt.py:1194-1203 (sab)"
    return out


# K11 out_block's cases (check_out_block): the output block of each path,
# (name, SolverConfig kwargs or preset, RunSettings kwargs, lanes, z_out
# by name); "edges" runs EDGE lanes on the every-switch layout.  The
# bound against out_block_plain (of each (lane, column)'s max |plain| over
# z and k; sigma_v^2's and H's over z) and the device kernels of one
# finalize: K11 alone, or the engine's four over B n_z lanes first
OB_ALL = dict(print_a=True, print_i=True, print_q=True, print_bias=True)
OB_CASES = (
    ("full_trg", {}, dict(one_loop=False), 16, "Z_OUT"),
    ("oneloop", {}, dict(one_loop=True), 32, "Z_OUT_1L"),
    ("oneloop_bias", dict(print_bias=True), dict(one_loop=True), 32,
     "Z_OUT_1L"),
    ("every_switch", OB_ALL, dict(one_loop=True), 8, "Z_OUT_1L"),
    ("fill_pt_full_trg", dict(OB_ALL, fill_pt_full_trg=True),
     dict(one_loop=False), 16, "Z_OUT"),
    ("linear", OB_ALL, dict(nonlinear=False), 16, "Z_OUT"),
    ("high_accuracy", "high_accuracy", dict(one_loop=True), 2,
     "Z_OUT_PRESETS"),
    ("v01_compat", "v01_compat", dict(one_loop=True), 2, "Z_OUT_PRESETS"),
    ("nk48", dict(nk=48), dict(one_loop=False), 2, "Z_OUT"),
    ("production", {}, dict(one_loop=False), 16, "CAMB"),
    ("production_1loop", dict(print_bias=True), dict(one_loop=True), 16,
     "CAMB"),
    ("kmin", dict(OB_ALL, kmin=5e-4), dict(one_loop=True), 8, "Z_OUT_1L"),
)
OB_TIMED = ("full_trg", "oneloop_bias")
OB_BOUND = 1e-11
# each case's bit-equal share under the previous design of K11 (a
# thread a k point running every column; its last run on the H100):
# printed beside this one's
OB_PREV_SHARE = dict(
    full_trg=0.955484576427256, oneloop=1.0, oneloop_bias=1.0,
    every_switch=1.0, edges=1.0, fill_pt_full_trg=0.9910091593825553,
    linear=0.9910091593825553, high_accuracy=1.0, v01_compat=1.0, nk48=1.0,
    production=0.9517836769902885, production_1loop=0.9743740479465223,
    kmin=0.9999734318127474, **{"edges nz=4": 1.0, "edges nz=0": 1.0})
# the edge cases' redshifts: a past 1 (z < 0, beta clamped at a = 1),
# a = 1 (min(1, a 1.001) = 1), a node's a
OB_EDGE_Z = (3.0, 1.0, 0.0, -0.002)


def ob_models() -> dict:
    """The 2-lane models of each config of OB_CASES (host prepare), by
    (nk, kmin)."""
    import torch

    from redtime_tpu_torch import driver

    cs, lins = design_inputs(2)
    chunk = ([x.numpy() for x in cs], list(lins), None)
    out = {}
    for _, kw, _, _, _ in OB_CASES:
        cfg = ob_config(kw)
        key = (cfg.nk, cfg.kmin)
        if key not in out:
            out[key] = driver._prepare(cfg, chunk, torch.device("cuda"),
                                       True)
    return out


def ob_config(kw):
    from redtime_tpu_torch.config import SolverConfig
    return (getattr(SolverConfig, kw)() if isinstance(kw, str)
            else SolverConfig(**kw))


def ob_z(name: str) -> tuple:
    from redtime_tpu_torch import orchestrate
    if name == "CAMB":
        return tuple(float(z) for z in orchestrate.CAMB_Z_LIST.split())
    return globals()[name]


def ob_states(rng, cfg, settings, m, S: int):
    """ys [B, S, 41, nk] on the model's device: each lane's initial ln P rows grown
    by 2 eta at S etas from 1.5 to 4.6, I and Q rows of the spectrum's
    scale from the generator."""
    import torch

    from redtime_tpu_torch import trg

    B, nk = m.batch, cfg.nk
    y0 = trg.initial_state(cfg, settings, m).reshape(B, 41, nk).cpu().numpy()
    ys = np.repeat(y0[:, None], S, axis=1)
    ys[:, :, :3] += 2.0 * np.linspace(1.5, 4.6, S)[None, :, None, None]
    ys[:, :, 3:] = 1e-3 * np.exp(ys[:, :, :1]) * rng.standard_normal(
        (B, S, 38, nk))
    return torch.as_tensor(ys, device=m.norm.device)


def ob_args(cfg, settings, m, ys, ec):
    """out_block's arguments as driver._finalize makes them (the engine
    over the B S lanes where the layout needs it)."""
    from redtime_tpu_torch import driver, fastpt
    from redtime_tpu_torch.grids import make_grids
    from redtime_tpu_torch.kernels import out_block as ob

    B, S, _, nk = ys.shape
    lay = ob.layout_of(cfg, settings)
    src = (fastpt.compute_J_PZ(cfg, ys[:, :, 0:3].reshape(B * S, 3, nk),
                               m.cosmo.n_s, settings.print_rsd, ec, n_rep=S)
           if lay.mc else None)
    return (lay, ys, driver._headers(cfg, settings, ys.device)[0], m,
            tuple(float(z) for z in settings.z_out), settings.a_in, src,
            ob.sv_weights(make_grids(cfg).k, cfg.kmin))


def ob_compare(got, ref, what: str) -> tuple:
    """K11's (table, sigma_v2, H) against the plain version's: NaN and inf
    in the same places, within OB_BOUND of each (lane, column)'s scale
    over z and k (sigma_v^2's and H's over z); (deviation, bit-equal
    share of the finite elements, max |delta|)."""
    import torch

    err, same, n, delta = 0.0, 0, 0, 0.0
    for g, r in zip(got, ref):
        check(bool(torch.equal(g.isnan(), r.isnan())
                   and torch.equal(g.isinf(), r.isinf())),
              f"{what}: NaN or inf where the plain version has none")
        fin = torch.isfinite(r)
        dims = (1, 2) if r.dim() == 4 else (1,)
        scale = torch.where(fin, r.abs(), 0.0).amax(dims, keepdim=True)
        d = torch.where(fin, (g - r).abs(), 0.0)
        err = max(err, float((d / (scale + 1e-300)).max()))
        delta = max(delta, float(d.max()))
        same += int((g == r)[fin].sum())
        n += int(fin.sum())
    check(err <= OB_BOUND, f"{what}: {err:.3g} of column scale from plain "
                           f"(bound {OB_BOUND:g})")
    return err, same / max(n, 1), delta


def ob_cost(args) -> dict:
    """least_time of one out_block: read once, the state rows its layout
    prints or reads (ln P; I; P_B's Q rows; Q), the engine's rows its
    programs read (and J_lo), the 4-node rows of the growth and beta
    tables that this run's brackets touch (each lane's distinct ones),
    Dnorm, T_solver and k, the nodes and the lane scalars; the table,
    sigma_v^2 and H written once.  Operations: the traced programs' and
    ~80 a point for the lookups' sums and the linear block, ~150 a (lane,
    redshift) for the brackets and H (pow, exp counted as 20)."""
    import torch

    from redtime_tpu_torch import assembly, interp
    from redtime_tpu_torch.kernels import out_block as ob

    lay, ys, k, m, zs, a_in, src, sv = args
    B, S, _, nk = ys.shape
    progs = ob.programs()
    leaves = lambda name: {a for op, a, _ in progs[name][0].ops
                           if op == "f"}
    rows_y = set(range(3)) | (set(range(3, 17)) if lay.i else set()) | (
        leaves("pbis_rows") if lay.rsd != "off" else set()) | (
        set(range(17, 41)) if lay.q else set())
    eng = set()
    if lay.mc:
        eng |= leaves("a_rows") if lay.a else set()
        eng |= leaves("pt_pmr_rows") if lay.rsd != "off" else set()
    ops_pt = 3 * 20 + ob.n_columns(lay)
    for name, on in (("a_rows", lay.mc and lay.a),
                     ("pt_pmr_rows", lay.mc and lay.rsd != "off"),
                     ("pbis_rows", lay.rsd != "off")):
        if on:
            ops_pt += sum(op not in ("f", "k")
                          for op, _, _ in progs[name][0].ops)
    ops_pt += 80 if lay.lin else 12
    per_zk = len(rows_y) + len(eng - {assembly.PT_JLO}) + ob.n_columns(lay)
    # the growth and beta rows this run's brackets touch, per lane
    a = torch.as_tensor(1.0 / (1.0 + np.asarray(zs)))
    gl = m.g_lna.cpu()
    i0 = interp.axis_weights(gl, torch.log(a).expand(B, -1))[0]
    g_rows = sum(len({int(i) + j for i in row for j in range(4)})
                 for row in i0)
    b_rows = 0
    nz = m.beta_a.shape[1]
    if lay.lin and nz:
        aL, aR = a * 0.999, torch.clamp(a * 1.001, max=1.0)
        x = torch.clamp(torch.cat([a, aL, aR, torch.ones(1)]), max=1.0)
        ib = interp.axis_weights(m.beta_a.cpu(), x.expand(B, -1))[0]
        b_rows = sum(len({int(i) + j for i in row for j in range(4)})
                     for row in ib)
    per_lane_k = 2 * g_rows / B + 1 + (b_rows / B + 1 if lay.lin else 0)
    nbytes = 8.0 * (B * S * nk * per_zk + B * nk * per_lane_k + nk
                    + B * (m.g_lna.shape[1] + nz + 9)
                    + B * S * (1 + 2) + (B * S if lay.mc else 0))
    ops = float(ops_pt) * B * S * nk + 150.0 * B * S
    return least_time(nbytes, ops, PEAK_FP64)


def ptxas_stack(ptxas: str) -> int | None:
    """The stack frame bytes of a ptxas line (ptxas_of), None if absent."""
    import re
    m = re.search(r"(\d+) bytes stack frame", ptxas)
    return int(m.group(1)) if m else None


def ob_edges(rng, m8, cfg, ec) -> dict:
    """K11's arguments at edge cases on 8 lanes of the every-switch
    1-loop layout at OB_EDGE_Z (a at z = 1 and z = 0 on a node of the
    design's beta table): lane 0 as it is, lane 1 with f_nu = 0
    (Omega_nu = 0), lane 2's state NaN at one redshift (the chunked
    scheduler's poisoned lane), lane 3's zero (a packed model never
    finished), lane 5 with a growth node moved onto its ln a at z = 1;
    then the same with a table of 4 beta nodes and with none (nz = 0).
    Returns name -> (args, settings)."""
    import torch

    from redtime_tpu_torch.config import RunSettings

    settings = RunSettings(one_loop=True, z_out=OB_EDGE_Z)
    c = m8.cosmo
    m = m8._replace(cosmo=c._replace(Omega_nu=c.Omega_nu.clone()),
                    g_lna=m8.g_lna.clone())
    m.cosmo.Omega_nu[1] = 0.0
    lx = torch.log(torch.reciprocal(torch.tensor(1.0 + OB_EDGE_Z[1])))
    g = m.g_lna[5]
    g[int((g.cpu() - lx).abs().argmin())] = float(lx)
    ys = ob_states(rng, cfg, settings, m, len(OB_EDGE_Z))
    ys[2, 1] = float("nan")
    ys[3, 2] = 0.0
    pick = torch.tensor([0, 3, 5, 7], device=ys.device)
    out = {}
    for tag, mm in (
            ("edges", m),
            ("edges nz=4", m._replace(
                beta_a=m.beta_a[:, pick].contiguous(),
                beta_solver=m.beta_solver[:, pick].contiguous())),
            ("edges nz=0", m._replace(
                beta_a=m.beta_a[:, :0].contiguous(),
                beta_solver=m.beta_solver[:, :0].contiguous()))):
        out[tag] = (ob_args(cfg, settings, mm, ys, ec), settings)
    return out


def check_out_block(rng, detail: dict) -> dict:
    """K11 out_block against its plain version on the card at each path's
    output block (OB_CASES: the lanes and redshifts of the paths' chunks,
    every layout family, the presets, nk = 48, production's 16 x 33 in
    both modes, kmin != 1e-3) and at edge cases (ob_edges): within
    OB_BOUND of column scale, NaN and inf in the same places, two calls
    the same bits, the bit-equal share printed beside the previous
    design's (OB_PREV_SHARE); one launch a call; the kernel's ptxas line
    and stack bytes.  Each case: eager ms (CUDA events over 20 calls),
    device ms (20 calls in a CUDA graph x 5 replays), the plain version's
    eager ms (3 calls: it copies scalars to the card, so no graph), the
    bound (ob_cost); each
    path case's finalize (driver._finalize on the same states) runs 1
    device kernel, or 5 where the layout takes the engine (K9, K10, K1,
    K2 over the B n_z lanes first), and no other: the launch counters over
    one call give those and nothing else, and a profiler window (the
    fullest of 5, of one call between markers: a window drops a record
    now and then) sees no other kernel.  Returns the kernels' line row
    (full TRG 16 x 8, the headline's block)."""
    import torch

    from redtime_tpu_torch import driver, fastpt
    from redtime_tpu_torch import model as mdl
    from redtime_tpu_torch.config import RunSettings
    from redtime_tpu_torch.kernels import build, counts
    from redtime_tpu_torch.kernels import out_block as ob

    dev = torch.device("cuda")
    log = build.BUILD_LOG.get("output", "")
    ptxas = ptxas_of(log, "out_block_kernel")
    print(f"out_block ptxas: {ptxas}")
    models = ob_models()
    cases, rows, max_err = [], {}, 0.0
    todo = []
    for name, kw, skw, B, zname in OB_CASES:
        cfg = ob_config(kw)
        m2 = models[(cfg.nk, cfg.kmin)]
        m = mdl.take_lanes(m2, torch.arange(B, device=dev) % 2)
        settings = RunSettings(z_out=ob_z(zname), **skw)
        ec = fastpt.engine_consts(cfg, dev)
        ys = ob_states(rng, cfg, settings, m, len(settings.z_out))
        if name == "full_trg":
            ys[-1, 0] = float("nan")     # a poisoned lane at one redshift
        todo.append((name, cfg, settings, ob_args(cfg, settings, m, ys, ec),
                     ec, True))
        if name == "every_switch":
            todo += [(tag, cfg, s, a, ec, False) for tag, (a, s) in
                     ob_edges(rng, m, cfg, ec).items()]
    for name, cfg, settings, args, ec, path in todo:
        lay, ys = args[0], args[1]
        B, S, _, nk = ys.shape
        what = f"out_block {name} (B={B}, {S} z, nk={nk}, " \
               f"{ob.n_columns(lay)} columns)"
        before = counts.snapshot()["out_block"]
        got = ob.out_block(*args)
        check(counts.snapshot()["out_block"] == before + 1,
              f"{what}: not one launch")
        check(all(same_bits(g, h) for g, h in zip(got, ob.out_block(*args))),
              f"{what}: two calls on the same inputs differ")
        ref = ob.out_block_plain(*args)
        err, share, delta = ob_compare(got, ref, what)
        max_err = max(max_err, delta)
        row = dict(case=name, B=B, n_z=S, nk=nk, ncol=ob.n_columns(lay),
                   mc=lay.mc, dev_col_scale=err, bit_equal_share=share,
                   ms=time_ms(lambda: ob.out_block(*args)),
                   device_ms=graph_ms(lambda: ob.out_block(*args)),
                   plain_ms=time_ms(lambda: ob.out_block_plain(*args),
                                    iters=3, warmup=1),
                   **ob.launch_plan(nk, B, S, ob.n_columns(lay)),
                   **ob_cost(args))
        if path:
            m = args[3]
            fin = lambda: driver._finalize(cfg, settings, m, ys, ec)
            want = ["out_block"] + (list(ENGINE_KERNELS) if lay.mc else [])
            before = counts.snapshot()
            fin()
            launched = {k: v - before[k] for k, v in counts.snapshot().items()
                        if v != before[k]}
            n_dev, busy, names = device_kernels(fin, calls=1, tries=5)
            hand = [n for n in names if any(k in n for k in want)]
            check(launched == dict.fromkeys(want, 1) and hand == list(names)
                  and n_dev <= len(want),
                  f"{what}: one finalize launched {launched} and ran "
                  f"{n_dev} device kernels {names} (the hand kernels are "
                  f"{len(want)}: {want})")
            row.update(finalize_launches=len(want),
                       finalize_device_kernels=n_dev, finalize_busy_ms=busy)
        rows[name] = row
        cases.append(row)
        print(f"{what}: {err:.3g} of column scale from plain, {share:.6f} "
              f"of the finite elements bit-equal (the previous design "
              f"{OB_PREV_SHARE.get(name, float('nan')):.6f}); "
              f"{row['ms']:.4f} ms "
              f"eager, {row['device_ms']:.5f} ms device (plain "
              f"{row['plain_ms']:.3f} ms); bound {row['bound_ms']:.5f} ms "
              f"by {row['bound_by']}"
              + (f"; finalize {row['finalize_launches']} launches, "
                 f"{row['finalize_device_kernels']:g} device kernels seen "
                 f"by the profiler (its fullest of 5 windows)" if path
                 else ""))
    detail.update(out_block_cases=cases, out_block_ptxas=ptxas)
    main = rows["full_trg"]
    return dict(
        name="out_block", route="cuda",
        source="redtime_tpu_torch/csrc/out_block.cu",
        replaces="redtime_tpu/driver.py:133",
        also_replaces="redtime_tpu/driver.py:240 (_finalize), "
                      "redtime_tpu/trg.py:563 (pbis_j), :161 (_collapse_pt),"
                      " redtime_tpu/assembly.py:465 (PT), :507 (PMR), "
                      "redtime_tpu/model.py:135 (beta_P_solver), :509 "
                      "(growth_D_f), :521 (plin_all), :581 (sigma_v2), "
                      "redtime_tpu/background.py:78 (H_H0)",
        max_abs_err=max_err,
        max_dev_col_scale=max(c["dev_col_scale"] for c in cases),
        min_bit_equal_share=min(c["bit_equal_share"] for c in cases),
        plain_device_ms=None, library_ms=None, oneloop=rows["oneloop_bias"],
        ptxas=ptxas, ptxas_stack_bytes=ptxas_stack(ptxas),
        **{k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                "bound_by", "bound_bytes", "bound_ops",
                                "finalize_launches",
                                "finalize_device_kernels")})


def rhs_host_ms(rhs, eta, y, n: int = 20) -> float:
    """Host-clock ms of one rhs(eta, y), the device synchronized, over n
    calls after one untimed call."""
    import torch

    rhs(eta, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        rhs(eta, y)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


# the tensor-core instruction each kernel's SASS must hold: FP64 (DMMA)
# for K1 and K2, int8 mma.sync (IMMA) for K5, int8 wgmma (IGMMA, the
# opcode of K7's wgmma m64n64k32 s8 in the SASS of its first build) for
# K7's main kernel as it runs (oz_fused_kernel<0>, mangled ...ILi0E; the
# other instantiations are rt_oz_fused_ablate's measurement variants)
TENSOR_CORE_OPS = {"out_leg_kernel": "DMMA", "pz_leg_kernel": "DMMA",
                   "int8_dot_kernel": "IMMA",
                   "oz_fused_kernelILi0E": "IGMMA"}


def check_tensor_cores(lib, detail: dict) -> None:
    """K1 and K2 run on the FP64 tensor cores, K5 and K7 on the int8
    ones:
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


def k1_schedule(fn) -> str:
    """The name of the schedule that K1's launch in fn() took, read from
    out_leg.SCHEDULE_LAUNCHES; checks that fn() launched K1 once."""
    from redtime_tpu_torch.kernels import out_leg as k1

    before = dict(k1.SCHEDULE_LAUNCHES)
    fn()
    took = [s for s, n in k1.SCHEDULE_LAUNCHES.items()
            if n != before.get(s, 0)]
    check(len(took) == 1 and k1.SCHEDULE_LAUNCHES[took[0]]
          == before.get(took[0], 0) + 1, f"out_leg: launches {took}")
    return k1.NAMES[took[0]]


# K1 at the benchmark's solve cells' shapes: cell -> (SolverConfig
# preset, or None for the defaults; lanes)
K1_CELLS = {"trg128.solve.w512": (None, 512),
            "trg512.solve.w64": ("high_accuracy", 64)}


def k1_cell_rows(rng, detail: dict) -> dict:
    """K1 at the solve cells' shapes (512 lanes on SolverConfig()'s grid,
    64 on high_accuracy()'s: nk=512, np=2048), on their engine constants:
    within the dot product's forward-error bound of its plain version,
    the same bits over two calls, timed (eager, device, plain) with its
    bound, its share of it and the schedule its launch took.  Returns
    {cell: row}."""
    import torch

    from redtime_tpu_torch import fastpt
    from redtime_tpu_torch.config import SolverConfig
    from redtime_tpu_torch.kernels import out_leg as k1

    out = {}
    for cell, (preset, B) in K1_CELLS.items():
        cfg = getattr(SolverConfig, preset)() if preset else SolverConfig()
        ec = fastpt.engine_consts(cfg, torch.device("cuda"))
        K, nfam, O = 2 * cfg.npts, fastpt.NFAM, cfg.nk + 1
        tab = torch.as_tensor(rng.standard_normal((B, 2, nfam, 3, K)),
                              device="cuda")
        J, J_ref = k1.out_leg(tab, ec.G), k1.out_leg_plain(tab, ec.G)
        prod = tab[:, 0, :, :, None, :] * tab[:, 1, :, None, :, :] / K
        bound = 2 * K * EPS * torch.matmul(
            prod.abs().reshape(B, nfam, 9, K), ec.G.abs()).reshape(J.shape)
        del prod
        ratio = float(((J - J_ref).abs() / bound).max())
        check(ratio <= 1.0, f"out_leg at {cell}: |delta|/bound {ratio:.3g}")
        check(bool(torch.equal(J, k1.out_leg(tab, ec.G))),
              f"out_leg at {cell}: two calls differ")
        del J, J_ref, bound
        t, runs = measure(lambda: k1.out_leg(tab, ec.G),
                          lambda: k1.out_leg_plain(tab, ec.G))
        cost = least_time(8.0 * (tab.numel() + nfam * K * O
                                 + B * nfam * 9 * O),
                          2.0 * nfam * 9 * B * K * O, PEAK_FP64_TC)
        out[cell] = dict(t, **cost, B=B, nfam=nfam, K=K, O=O,
                         share=cost["bound_ms"] / t["device_ms"],
                         schedule=k1_schedule(lambda: k1.out_leg(tab,
                                                                 ec.G)),
                         err_over_bound=ratio, readings=runs)
        r = out[cell]
        print(f"out_leg at {cell}'s shape (B={B}, K={K}, O={O}): "
              f"{r['ms']:.4f} ms eager, {r['device_ms']:.4f} ms device "
              f"(plain {r['plain_ms']:.4f} / {r['plain_device_ms']:.4f}); "
              f"bound {r['bound_ms']:.5f} by {r['bound_by']}, "
              f"{100 * r['share']:.1f}% of it; schedule {r['schedule']}")
        del tab
        torch.cuda.empty_cache()
    detail["out_leg_cells"] = out
    return out


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
    the launches by phase add up and that the solve launched K1-K3, K8 and
    K11; with host prepare (the default) that prepare launched none of
    them, with
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


def run_main_path(detail: dict, card: str) -> tuple:
    """Full Time-RG, the bench's headline workload: its PT columns print
    zero (the reference's output caveat).  Returns the launch counts and
    the default placement's result."""
    from redtime_tpu_torch.config import RunSettings, SolverConfig

    res, launches = run_path(
        "full_trg", SolverConfig(),
        RunSettings(one_loop=False, z_out=Z_OUT), N_DESIGN, GOLDEN, detail,
        card)
    check(bool(np.all(res.table[..., 13:17].cpu().numpy() == 0.0)),
          "full-TRG PT columns must be zero")
    return launches, res


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


def run_production(work: str, detail: dict, card: str) -> tuple:
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
    cosmology and the launches by phase.  Its files stay in `work` (the
    io phase reads them).  Returns (the batch's launches, the rerun's
    launches)."""
    import io
    import re

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


def quiet(fn, *args):
    """fn(*args), checked to write nothing to file descriptor 2, where a C
    runtime warns (e.g. of two OpenMP runtimes in one process); returns
    its result."""
    import tempfile

    sys.stderr.flush()
    saved = os.dup(2)
    with tempfile.TemporaryFile("w+") as f:
        os.dup2(f.fileno(), 2)
        try:
            out = fn(*args)
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
        f.seek(0)
        said = f.read()
    check(said == "", f"{fn.__name__} wrote to stderr: {said!r}")
    return out


def build_io() -> dict:
    """Builds the host IO library (g++) and starts its OpenMP runtime
    once (native.io_threads), checked to warn nothing and to leave
    torch's thread count as it was.  Returns its build seconds and
    threads."""
    import torch

    from redtime_tpu_torch.io import native

    t0 = time.perf_counter()
    path = native.build()
    build_s = time.perf_counter() - t0
    before = torch.get_num_threads()
    threads = quiet(native.io_threads)
    check(torch.get_num_threads() == before,
          f"io: torch threads {before} -> {torch.get_num_threads()}")
    print(f"build: g++ {build_s:.3f} s ({path.name}); parse_stack's OpenMP "
          f"threads {threads}, torch's {before}")
    return dict(wall_s=build_s, library=path.name, omp_threads=threads,
                torch_threads=before)


def run_io(work: str, res, detail: dict, card: str) -> None:
    """The host IO runtime on the card's host, against its plain versions:

      1. every production model's CAMB inputs (its params file's
         transfer file and 33 beta_P files, written by run_production in
         `work`) parsed as camb.load_linear_data parses them under the
         CLI's load-inputs: the transfer file by camb.read_transfer_file
         (native.parse_table, one thread), then the stack by one
         native.parse_stack (OpenMP); bit-equal to
         camb.read_transfer_file_plain (np.loadtxt) file by file; each
         model timed both ways, in turns (native, plain, plain, native);
      2. the full-TRG main path's table (res: 16 lanes x 8 redshifts x
         nk x 17) formatted block by block by writer._format_block
         (native.format_rows), byte-equal to _format_block_plain
         (f-strings); the whole table timed both ways, in turns;
      3. torch's thread count the same before and after, and nothing
         written to stderr.

    Prints ms a file and us a value for both routes."""
    import glob

    import torch

    from redtime_tpu_torch.io import camb, native, read_params_file, writer

    threads = torch.get_num_threads()
    params = sorted(glob.glob(os.path.join(work, "out",
                                           "params_redTime_M*.dat")))
    check(len(params) == N_PROD, f"io: {len(params)} params files")
    stacks = []
    for path in params:
        p = read_params_file(path)
        base = os.path.dirname(path)
        stacks.append([os.path.join(base, p.transfer_file)]
                      + p.nu_transfer_files(base))

    def native_inputs(files):
        return [camb.read_transfer_file(files[0])] \
            + native.parse_stack(files[1:], 7)

    def plain_inputs(files):
        return [camb.read_transfer_file_plain(f) for f in files]

    for files in stacks:
        quiet(native_inputs, files)
    parse_s = {"native": [], "plain": []}
    for files in stacks:
        for route in ("native", "plain", "plain", "native"):
            t0 = time.perf_counter()
            if route == "native":
                nat = native_inputs(files)
            else:
                plain = plain_inputs(files)
            parse_s[route].append(time.perf_counter() - t0)
        check(all(a.shape == b.shape and a.tobytes() == b.tobytes()
                  for a, b in zip(nat, plain)),
              f"io: native parse of {files[0]} differs from np.loadtxt")
    files_per_model = len(stacks[0])
    check(all(len(f) == files_per_model for f in stacks),
          "io: the models' stacks differ in length")
    n_files = sum(len(f) for f in stacks)

    table = res.table.cpu().numpy()
    blocks = table.reshape(-1, *table.shape[2:])
    fmt_s = {"native": [], "plain": []}
    for route in ("native", "plain", "plain", "native"):
        fn = writer._format_block if route == "native" \
            else writer._format_block_plain
        t0 = time.perf_counter()
        text = [fn(b) for b in blocks]
        fmt_s[route].append((time.perf_counter() - t0) / table.size)
        if route == "native":
            nat_text = text
        else:
            plain_text = text
    check(nat_text == plain_text,
          "io: native formatting differs from the f-strings")
    check(torch.get_num_threads() == threads,
          f"io: torch threads {threads} -> {torch.get_num_threads()}")
    med = {f"{k}_ms_per_model": float(np.median(v)) * 1e3
           for k, v in parse_s.items()}
    med.update({f"{k}_ms_per_file": med[f"{k}_ms_per_model"]
                / files_per_model for k in parse_s})
    med.update({f"{k}_us_per_value": float(np.median(v)) * 1e6
                for k, v in fmt_s.items()})
    detail["io"] = dict(med, files=n_files, values=int(table.size),
                        omp_threads=native.io_threads(),
                        torch_threads=threads,
                        files_per_model=files_per_model,
                        parse_s_per_model=parse_s, format_s_per_value=fmt_s)
    print(f"io on {card}'s host: {N_PROD} production models' inputs "
          f"({n_files} files, 7 columns) parsed as the CLI parses them "
          f"(the transfer file on one thread, the {files_per_model - 1} "
          f"stack files on {native.io_threads()} OpenMP threads), "
          f"bit-equal to np.loadtxt: {med['native_ms_per_model']:.4f} ms a "
          f"model, {med['native_ms_per_file']:.4f} ms a file (plain "
          f"{med['plain_ms_per_model']:.4f}, "
          f"{med['plain_ms_per_file']:.4f}); full-TRG table "
          f"{tuple(table.shape)} formatted byte-equal to the f-strings: "
          f"{med['native_us_per_value']:.4f} us a value (plain "
          f"{med['plain_us_per_value']:.4f}); medians of "
          f"{len(parse_s['native'])} / 2 readings a side (a model / the "
          f"table), in turns; torch threads {threads} before and after")


def oracle_devs(cfg, P_ext, Jw, PZw, device) -> dict:
    """The engine's windowed outputs (P_ext [npts], Jw [NFAM, nk], PZw [7,
    nk] of one spectrum row) against the port's continuum oracle on
    `device`, at tests/test_quadrature.py's points, orders and bounds:
    name -> deviation over its bound (<= 1 passes)."""
    from redtime_tpu_torch import fastpt, quadrature
    from redtime_tpu_torch.grids import make_grids

    g = make_grids(cfg)
    idx = list(ORACLE_IDX)
    k = g.k[idx]
    Pk = P_ext[g.nshift:g.nshift + g.nk][idx]
    out = {}
    for fam, alpha, beta, ell in quadrature.UNREG_FAMILIES:
        jq = quadrature.j_quadrature(cfg, P_ext, k, alpha, beta, ell, 600,
                                     96, device=device)
        peak = Jw[fam].abs().max()
        out[f"J{fam}"] = float((jq - Jw[fam][idx]).abs().max() / peak
                               / ORACLE_J_BOUND)
    for fi, n in enumerate(fastpt.Z_N):
        pq = quadrature.pz_quadrature(cfg, P_ext, k, n, device=device) * Pk
        bound = ORACLE_PZ_BOUNDS[n >= 0]
        out[f"PZ{n}"] = float((pq - PZw[fi][idx]).abs().max()
                              / PZw[fi].abs().max() / bound)
    jidx = list(ORACLE_JREG_IDX)
    naive = quadrature.j_quadrature(cfg, P_ext, g.k[jidx], 2, -2, 0, 800,
                                    1024, device=device)
    model = quadrature.jreg_ir_counterterm(cfg, P_ext, g.k[jidx],
                                           device=device)
    out["Jreg"] = float(((naive - Jw[1][jidx]) / model - 1.0).abs().max()
                        / ORACLE_JREG_BOUND)
    return out


def run_oracle(detail: dict, card: str) -> None:
    """The card's engine held to the port's continuum oracle on the card:
    fastpt.compute_J_PZ (K9 -> K10 -> K1 + K2, with the launch counters
    set to 0 just before and each checked after) on the BBKS spectrum at
    SolverConfig() defaults, windowed, against quadrature.j_quadrature,
    pz_quadrature and jreg_ir_counterterm on the card (oracle_devs):
    the six unregularised J families within 5e-3 of peak, PZ within
    3e-3 / 4e-2, the Jreg identity within 5e-3."""
    import torch

    from redtime_tpu_torch import fastpt
    from redtime_tpu_torch.config import SolverConfig
    from redtime_tpu_torch.grids import make_grids
    from redtime_tpu_torch.kernels import counts
    from redtime_tpu_torch.quadrature import bbks_lnP

    cfg = SolverConfig()
    g = make_grids(cfg)
    ec = fastpt.engine_consts(cfg, "cuda")
    lnP3 = torch.as_tensor(
        np.broadcast_to(bbks_lnP(g.k), (1, 3, g.nk)).copy(), device="cuda")
    n_s = torch.tensor([0.96], dtype=torch.float64, device="cuda")
    counts.reset()
    P_ext = fastpt.extend_power(cfg, lnP3, n_s, ec)
    Jw, _, PZw = fastpt.window(
        cfg, *fastpt.compute_J_PZ(cfg, lnP3, n_s, True, ec), True)
    launches = counts.snapshot()
    for name in ENGINE_KERNELS:
        check(launches[name] > 0, f"oracle: {name} was not launched")
    t0 = time.perf_counter()
    devs = oracle_devs(cfg, P_ext[0, 0], Jw[0, :, 0, 0], PZw[0, :, 0, 0],
                       "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    worst = max(devs, key=devs.get)
    check(all(np.isfinite(v) and v <= 1.0 for v in devs.values()),
          f"oracle: the engine is outside the oracle's bounds {devs}")
    detail["oracle"] = dict(dev_over_bound=devs, wall_s=wall,
                            launches={k: launches[k] for k in ENGINE_KERNELS})
    print(f"oracle on {card}: the card's engine (K9 -> K10 -> K1 + K2) "
          f"against the continuum quadrature on the card, 6 J families, 7 "
          f"PZ kernels and the Jreg identity, deviation over bound at most "
          f"{devs[worst]:.3f} ({worst}); "
          f"{ {k: round(v, 3) for k, v in devs.items()} }; oracle "
          f"{wall:.3f} s")


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
    import tempfile

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
    detail["build_io"] = build_io()
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
    engine_inputs: list = []
    rows.append(timed("rhs_tail", check_rhs_tail,
                      np.random.default_rng(3579), detail, engine_inputs))
    rows += timed("engine_legs", check_engine_legs, engine_inputs, detail)
    del engine_inputs
    rows.append(timed("out_block", check_out_block,
                      np.random.default_rng(8642), detail))
    timed("leg_shapes", check_leg_shapes, np.random.default_rng(2468),
          detail)
    presets = timed("preset_rows", preset_rows, np.random.default_rng(1357),
                    detail)
    cells = timed("k1_cells", k1_cell_rows, np.random.default_rng(9753),
                  detail)
    for r in rows:
        if r["name"] in presets:
            r["preset_shapes"] = presets[r["name"]]
        if r["name"] == "out_leg" and "cell_shapes" not in r:
            r["cell_shapes"] = {c: {k: v for k, v in row.items()
                                    if k != "readings"}
                                for c, row in cells.items()}
    rows += timed("probe_kernels", check_probe_kernels,
                  np.random.default_rng(4321), detail)
    for r in rows:
        lib_ms, plain_dev = r["library_ms"], r["plain_device_ms"]
        plain_dev = "-" if plain_dev is None else f"{plain_dev:.4f}"
        print(f"kernel {r['name']}: {r['ms']:.4f} ms eager, "
              f"{r['device_ms']:.4f} ms device (plain {r['plain_ms']:.4f} / "
              f"{plain_dev} ms; library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}; bound "
              f"{r['bound_ms']:.5f} ms by {r['bound_by']}), max |delta| "
              f"{r['max_abs_err']:.3g}")
    # each path runs with the counters set to 0 just before it; a
    # kernel's launches are the sum over the paths that ran it
    phases = dict(probes=timed("probes", run_probes, detail))
    launches_main, res_main = timed("main_path", run_main_path, detail, card)
    phases.update(launches_main)
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
    with tempfile.TemporaryDirectory() as work:
        phases["production"], phases["inject_rerun"] = timed(
            "production", run_production, work, detail, card)
        timed("io", run_io, work, res_main, detail, card)
    del res_main
    phases.update(numerics=timed("numerics", run_numerics, detail, card))
    timed("oracle", run_oracle, detail, card)
    # every engine evaluation of every path ran K9 -> K10 -> K1 + K2
    for path, p in phases.items():
        if path != "probes":
            n = {k: p[k] for k in ENGINE_KERNELS}
            check(len(set(n.values())) == 1,
                  f"{path}: engine launches differ {n}")
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
