"""Smoke run of the PyTorch port (redtime_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card and nvcc.  It

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from redtime_tpu_torch/csrc with nvcc
     (sm_90a) and checks that K1's and K2's SASS holds FP64 tensor-core
     instructions (DMMA) and K5's and K7's int8 ones (IMMA), by cuobjdump;
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
     every shape the port uses (check_leg_shapes), and two calls of each
     must give the same bits;
  4. checks the probe kernels K4 affine, K5 int8_dot and K6 dd_mul
     against their plain versions on the card, bit for bit, at the
     probes' shapes, at one larger shape each and on ragged sizes, and
     times both, and an empty kernel beside them (the launch floor under
     the probes' small shapes); K7 oz_fused the same way at P4's shape,
     on ragged shapes and on rows at the edges of the row exponent; then
     runs redtime_tpu_torch.probes (probe1-probe4 and probe4_out_leg) on
     the card, with the launch counters reset just before and read just
     after, checks that K4-K7 (and K1, at probe4's shape) were launched,
     and times probe4's two paths in a loop as the JAX probe does;
  5. runs the main path: driver.run_batch over 16 cosmologies of the
     bench's Mira-Titan Latin-hypercube design, full Time-RG at
     SolverConfig() defaults, on the card, once untimed as set-up and
     once timed, with every launch counter reset just before the timed
     run and read just after (K3's split into prepare and solve);
     checks that every table is finite, that K1-K3 (rk_stage and
     rk_finish) were launched, and that lanes 0-1 match the JAX golden
     (tests/data/torch_port_golden_nk128.npz, written by
     scripts/gen_torch_port_golden.py) within 3e-5 of column scale, the
     linear columns and the sigma_v^2 and H headers within 1e-10
     relative;
  6. runs 1-loop mode the same way (the bench's secondary workload):
     32 design cosmologies (one GPU chunk), SolverConfig(print_bias=True),
     the redshifts (5, 4, 3, 2, 1, 0.5, 0); the same checks against
     tests/data/torch_port_golden_oneloop_nk128.npz (gen_torch_port_golden
     --oneloop), and the PT and PMR columns must be populated;
  7. prints the kernels' JSON line, the card line and, last, the result.

Any failed phase raises, and the script exits non-zero without a result.
It imports nothing of JAX.  Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

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
DETAIL = os.path.join(HERE, "chiprun_out", "chip_smoke.json")
Z_OUT = (2.02, 1.61, 1.01, 0.66, 0.43, 0.24, 0.10, 0.0)
Z_OUT_1L = (5.0, 4.0, 3.0, 2.0, 1.0, 0.5, 0.0)
N_DESIGN, N_DESIGN_1L, SEED, B_CHECK = 16, 32, 42, 16
EPS = float(np.finfo(np.float64).eps)
# H100 SXM peaks (NVIDIA's data sheet, dense): HBM bytes/s; FP64 on the
# tensor cores, FP64 and FP32 outside them, int8 on the tensor cores
HBM_BYTES_S = 3.35e12
PEAK_FP64_TC, PEAK_FP64, PEAK_FP32, PEAK_INT8_TC = 67e12, 34e12, 67e12, \
    1979e12
MAIN_KERNELS = ("out_leg", "pz_leg", "rk_stage", "rk_finish")
PROBE_KERNELS = ("affine", "int8_dot", "dd_mul", "oz_fused")


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


def same_bits(a, b) -> bool:
    """torch.equal, with NaNs in the same places counted as equal."""
    return a.shape == b.shape and bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


def check_rk_finish(rng, cfg, dev) -> list:
    """K3's rk_finish against its plain version on one attempt of each
    rk_cases entry, of an odd D (8-byte accesses, eight a thread) and of
    a D whose blocks end ragged: y, t, h, n, r and the accept/reject
    masks bit for bit (the kernel rounds every operation alone, as the
    plain version does, and CUDA's pow, which r and h go through, is the
    routine torch.pow runs).  Each case must reject some lanes and accept
    others; then the same inputs a second time (the same bits), with a
    NaN in one lane's stages (r is NaN there, as torch.amax gives it, the
    other lanes untouched) and with every lane frozen (the state comes
    back as it went in)."""
    import torch

    from redtime_tpu_torch import ode
    from redtime_tpu_torch.kernels import rk_finish as k3

    B = B_CHECK
    cases = rk_cases(cfg) + [
        ("odd D", "DOP853", 41 * cfg.nk - 1, cfg.eabs_P, cfg.erel_P),
        ("ragged D", "DOPRI5", 3000, cfg.eabs_P, cfg.erel_P)]
    out_cases = []
    for case, tname, D, eabs, erel in cases:
        tab = getattr(ode, tname)
        consts = k3.attempt_consts(tab, eabs, erel, dev)
        args = rk_inputs(rng, tab, B, D, eabs, dev)
        plain = lambda a: k3.rk_finish_plain(*a, consts.b, consts.e,
                                             consts.prm)
        out, ref = k3.rk_finish(*args, consts), plain(args)
        what = f"rk_finish {case}"
        for x, want, name in zip(out, ref, "ythnr"):
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
                           "ythnr" * 2):
            check(same_bits(x, a), f"{what}: {b} differs from plain with a "
                                   "NaN lane or with every lane frozen")
        for i, j in ((0, 0), (1, 2), (2, 3), (3, 5)):
            check(bool(torch.equal(still[i], args[j])),
                  f"{what}: a frozen lane moved")
        cl, vec = k3.cluster_plan(D, True)
        out_cases.append(dict(
            case=case, tableau=tname, D=D, eabs=eabs, erel=erel,
            cluster=cl, bytes_per_access=16 if vec else 8,
            max_abs_err=float((out[0] - ref[0]).abs().max()),
            rejected=int(rej.sum()), args=args, consts=consts))
    return out_cases


def check_rk_stage(rng, cfg, dev, detail: dict) -> dict:
    """K3's rk_stage against its plain version, bit for bit, at every
    stage index of the three tableaux and every state size of rk_cases
    plus an odd one; timed at the eta case's stage 5 (RKF45's last).
    Returns its row for the kernels' line."""
    import torch

    from redtime_tpu_torch import ode
    from redtime_tpu_torch.kernels import rk_finish as k3

    B = B_CHECK
    sizes = [D for _, _, D, _, _ in rk_cases(cfg)] + [41 * cfg.nk - 1]
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


def check_kernels(rng, detail: dict) -> list:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from redtime_tpu_torch import fastpt
    from redtime_tpu_torch.config import SolverConfig
    from redtime_tpu_torch.kernels import out_leg as k1
    from redtime_tpu_torch.kernels import pz_leg as k2
    from redtime_tpu_torch.kernels import rk_finish as k3

    dev = torch.device("cuda")
    cfg = SolverConfig()
    ec = fastpt.engine_consts(cfg, dev)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    B, nk, npts = B_CHECK, cfg.nk, cfg.npts
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
    check(bool(torch.isfinite(J).all()), "out_leg: non-finite output")
    check(bool(torch.equal(J, k1.out_leg(tab, ec.G))),
          "out_leg: two calls on the same inputs differ")
    check(bool((err <= bound).all()),
          f"out_leg: max |delta|/bound {float((err / bound).max()):.3g}")
    nfam, O = fastpt.NFAM, ec.G.shape[-1]
    # the library yardstick: one batched DGEMM on the pair product,
    # materialized outside the timed region
    prod_mat = prod.permute(1, 0, 2, 3, 4).reshape(nfam, 9 * B, K) \
        .contiguous()
    t_k1, runs = measure(lambda: k1.out_leg(tab, ec.G),
                         lambda: k1.out_leg_plain(tab, ec.G),
                         lambda: torch.bmm(prod_mat, ec.G))
    detail["out_leg_timing"] = runs
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
    check(bool(torch.isfinite(PZ).all()), "pz_leg: non-finite output")
    check(bool(torch.equal(PZ, k2.pz_leg(ec.toeplitz_sl, P_e, ec.pz_kfac_sl,
                                         cfg.nshift))),
          "pz_leg: two calls on the same inputs differ")
    check(bool((err <= bound).all()),
          "pz_leg: max |delta|/bound "
          f"{float((err / bound.clamp(min=1e-300)).max()):.3g}")
    T2, P2 = ec.toeplitz_sl.view(7 * nk, npts), P_e.view(3 * B, npts)
    t_k2, runs = measure(
        lambda: k2.pz_leg(ec.toeplitz_sl, P_e, ec.pz_kfac_sl, cfg.nshift),
        lambda: k2.pz_leg_plain(ec.toeplitz_sl, P_e, ec.pz_kfac_sl,
                                cfg.nshift),
        lambda: torch.matmul(T2, P2.T))
    detail["pz_leg_timing"] = runs
    rows.append(dict(
        name="pz_leg", route="cuda",
        source="redtime_tpu_torch/csrc/pz_leg.cu",
        replaces="redtime_tpu/fastpt.py:1310",
        max_abs_err=float(err.max()), **t_k2,
        **least_time(8.0 * (T2.numel() + P2.numel() + nk + PZ.numel()),
                2.0 * 7 * nk * 3 * B * npts, PEAK_FP64_TC)))

    # K3 rk_finish at each tableau the main path runs it with (rk_cases);
    # its row is the eta case, the one the evolution runs
    k3_cases = check_rk_finish(np.random.default_rng(5678), cfg, dev)
    main_cases = {case for case, *_ in rk_cases(cfg)}
    calls = {}
    for c in k3_cases:
        args, consts = c.pop("args"), c.pop("consts")
        if c["case"] not in main_cases:
            continue
        calls[c["case"]] = (*args, consts)
        c.update(measure(
            lambda: k3.rk_finish(*args, consts),
            lambda: k3.rk_finish_plain(*args, consts.b, consts.e,
                                       consts.prm))[0])
        y, ks = args[0], args[1]
        s, (Bc, D) = ks.shape[0], y.shape
        # y, ks, t, h, t1, n, active, b, e, prm in; y, t, h, n, r out
        c.update(least_time(8.0 * (2 * Bc * D + s * Bc * D + 8 * Bc + 2 * s + 9)
                       + Bc, 2.0 * Bc * D * (2 * s + 4), PEAK_FP64))
        print(f"rk_finish {c['case']} ({c['tableau']}, D={c['D']}, "
              f"{c['cluster']} blocks a lane): "
              f"{c['ms']:.4f} ms eager, {c['device_ms']:.4f} ms device "
              f"(plain {c['plain_ms']:.4f} / {c['plain_device_ms']:.4f}), "
              f"y, t, h, n and r bit-equal to plain, {c['rejected']}/{B} lanes "
              "rejected")
    eta = next(c for c in k3_cases if c["case"] == "eta")
    # the eta case with the lane split over fewer blocks than the wrapper
    # chooses (one block cannot hold a lane of 41 nk)
    eta["device_ms_by_cluster"] = {
        cl: graph_ms(lambda: k3._launch_finish(*calls["eta"], cl, True))
        for cl in (2, 4, 8)}
    print(f"rk_finish eta by blocks a lane: {eta['device_ms_by_cluster']} "
          "ms device")
    rows.append(dict(
        name="rk_finish", route="cuda",
        source="redtime_tpu_torch/csrc/rk_attempt.cu",
        replaces="redtime_tpu/ode.py:161",
        max_abs_err=max(c["max_abs_err"] for c in k3_cases),
        **{k: eta[k] for k in ("ms", "device_ms", "plain_ms",
                               "plain_device_ms", "library_ms", "bound_ms",
                               "bound_by", "bound_bytes", "bound_ops")}))
    detail["rk_finish_cases"] = k3_cases
    rows.append(check_rk_stage(np.random.default_rng(8765), cfg, dev,
                               detail))
    return rows


# the tensor-core instruction each kernel's SASS must hold: FP64 (DMMA)
# for K1 and K2, int8 (IMMA) for K5 and K7
TENSOR_CORE_OPS = {"out_leg_kernel": "DMMA", "pz_leg_kernel": "DMMA",
                   "int8_dot_kernel": "IMMA", "oz_fused_kernel": "IMMA"}


def check_tensor_cores(lib, detail: dict) -> None:
    """K1 and K2 run on the FP64 tensor cores, K5 and K7 on the int8 ones:
    their SASS (cuobjdump -sass of the built library) holds DMMA and IMMA
    instructions."""
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
    print(f"tensor cores: DMMA / IMMA instructions in the SASS {counts}")
    detail["tensor_core_ops_in_sass"] = counts


def check_leg_shapes(rng, detail: dict) -> None:
    """K1 and K2 against their plain versions at every shape the port
    uses, within the forward-error bounds of check_kernels, and bit-equal
    over two calls: K1 at B in (1, 3, 16, 33), 7 and 14 families, 2np in
    (1024, 4096) and O in (129, 257, 513), G padded as engine_consts pads
    it; K2 at the same B on the default, v0.1 and HIGH_ACCURACY grids
    (nk, np) = (128, 512), (256, 2048), (512, 2048)."""
    import torch

    from redtime_tpu_torch.kernels import out_leg as k1
    from redtime_tpu_torch.kernels import pz_leg as k2

    t = lambda x: torch.as_tensor(x, dtype=torch.float64, device="cuda")
    cases = []
    for B in (1, 3, 16, 33):
        for nfam in (7, 14):
            for K in (1024, 4096):
                for O in (129, 257, 513):
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
        for nk, npts in ((128, 512), (256, 2048), (512, 2048)):
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
    rows.append(check_oz_fused(rng, detail))
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


def check_oz_fused(rng, detail: dict) -> dict:
    """K7 against oz_fused_plain on the card, bit for bit in oh and ol: at
    P4's shape with probe4's inputs (timed), with the rows of oz_edge_rows,
    and at ragged shapes (M not a multiple of the 32-row tile, K not of
    32, O not of 8; K % 4 != 0 and O % 16 != 0 take the loaders' scalar
    paths).  Returns its row for the kernels' line."""
    import torch

    from redtime_tpu_torch import dd, probes
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
                                 ws.cpu().numpy())),
             ("ragged (77, 1000, 100)", ragged(77, 1000, 100)),
             ("ragged (300, 999, 129)", ragged(300, 999, 129))]
    err = 0.0
    for case, args in cases:
        out, ref = kp.oz_fused(*args), kp.oz_fused_plain(*args)
        for o, r, name in zip(out, ref, ("oh", "ol")):
            check(o.dtype == r.dtype and o.shape == r.shape,
                  f"oz_fused {case}: {name} dtype or shape")
            delta = float((o.double() - r.double()).abs().max())
            err = max(err, delta)
            check(bool(torch.equal(o, r)),
                  f"oz_fused {case}: {name} not bit-equal to plain, max "
                  f"|delta| {delta:.3g}")
    edge = cases[1][1]
    exi = kp._oz_row_exponent(edge[0])[:5, 0].tolist()
    check(exi == [-125, 125, 125, -124, -125],
          f"oz_fused edge rows: exponents {exi}")
    t, runs = measure(lambda: kp.oz_fused(xh, xl, ws),
                      lambda: kp.oz_fused_plain(xh, xl, ws))
    detail["oz_fused_timing"] = runs
    detail["oz_fused_cases"] = [c for c, _ in cases]
    print(f"kernel oz_fused: bit-equal to plain in oh and ol at "
          f"{[c for c, _ in cases]}; at P4's shape {t['ms']:.4f} ms eager, "
          f"{t['device_ms']:.4f} ms device (plain {t['plain_ms']:.4f} / "
          f"{t['plain_device_ms']:.4f} ms)")
    # xh, xl and W read once, oh and ol written once; six int8 dots
    return dict(
        name="oz_fused", route="cuda",
        source="redtime_tpu_torch/csrc/oz_fused.cu",
        replaces="scripts/probe_pallas.py:145", max_abs_err=err, **t,
        **least_time(float(2 * 4 * M * K + 4 * K * O + 2 * 4 * M * O),
                     6.0 * 2.0 * M * K * O, PEAK_INT8_TC))


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


def run_path(what: str, cfg, settings, n_design: int, golden: str,
             detail: dict, card: str):
    """n_design design cosmologies through run_batch on the card, once
    untimed (set-up: cuBLAS and allocator first use) and once timed;
    checks the timed run against the JAX golden of lanes 0-1 and returns
    its launch counts, with their split into run_batch's phases
    (prepare, solve) under "by_phase"."""
    import torch

    from redtime_tpu_torch import driver, fastpt
    from redtime_tpu_torch.kernels import counts
    from redtime_tpu_torch.config import CosmoParams
    from redtime_tpu_torch.io.camb import LinearData

    params = design_params(n_design)
    lin = example_linear()
    gold = np.load(golden)
    check(np.array_equal(gold["params"], params[:2])
          and np.array_equal(gold["z_out"], np.asarray(settings.z_out)),
          f"{what}: design lanes 0-1 or z_out differ from the golden's")
    for name, x in zip(LinearData._fields, lin):
        check(np.array_equal(gold[name], x),
              f"{what}: linear input {name} differs from the golden's")
    cs = CosmoParams(*[torch.as_tensor(params[:, i]) for i in range(9)])
    lins = LinearData(*[np.stack([x] * n_design) for x in lin])
    t0 = time.perf_counter()
    fastpt.engine_consts(cfg, "cuda")
    driver.run_batch(cfg, settings, cs, lins, device="cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    print(f"{what} set-up: engine constants and one untimed run_batch of "
          f"the same chunk {setup:.3f} s")

    counts.reset()
    t0 = time.perf_counter()
    res = driver.run_batch(cfg, settings, cs, lins, device="cuda")
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
        check(launches[name] > 0,
              f"{what}: kernel {name} was not launched")
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
    per_min = n_design / wall * 60.0
    detail[what] = dict(setup_s=setup, wall_s=wall, cosmologies=n_design,
                        cosmologies_per_min=per_min,
                        golden_dev_col_scale=dev_col,
                        golden_dev_linear_rel=dev_lin, launches=launches,
                        launches_by_phase=by_phase)
    print(f"{what} path on {card}: {n_design} cosmologies, nk={cfg.nk}, "
          f"{wall:.3f} s = {per_min:.2f} cosmologies/min; lanes 0-1 vs "
          f"JAX golden {dev_col:.3g} of column scale, linear "
          f"{dev_lin:.3g}; launches {launches}; by phase {by_phase}")
    return res, dict(launches, by_phase=by_phase)


def run_main_path(detail: dict, card: str) -> dict:
    """Full Time-RG, the bench's headline workload: its PT columns print
    zero (the reference's output caveat)."""
    from redtime_tpu_torch.config import RunSettings, SolverConfig

    res, launches = run_path(
        "full_trg", SolverConfig(),
        RunSettings(one_loop=False, z_out=Z_OUT), N_DESIGN, GOLDEN, detail,
        card)
    check(bool(np.all(res.table[..., 13:17].cpu().numpy() == 0.0)),
          "full-TRG PT columns must be zero")
    return launches


def run_oneloop(detail: dict, card: str) -> dict:
    """1-loop mode with the PRINTBIAS columns, the bench's secondary
    workload: k | 6 lin | 3 P | 5 P_B | 9 PT | 8 PMR."""
    from redtime_tpu_torch.config import RunSettings, SolverConfig

    res, launches = run_path(
        "oneloop", SolverConfig(print_bias=True),
        RunSettings(one_loop=True, z_out=Z_OUT_1L), N_DESIGN_1L, GOLDEN_1L,
        detail, card)
    pt = res.table[..., 15:32].cpu().numpy()
    check(bool(np.all(np.any(pt != 0.0, axis=2))),
          "1-loop PT and PMR columns must be populated")
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

    t0 = time.perf_counter()
    lib = build.build()
    build_s = time.perf_counter() - t0
    print(f"build: nvcc {build_s:.3f} s ({lib.name})")
    detail["build"] = dict(build.BUILD_LOG, wall_s=build_s)
    check_tensor_cores(lib, detail)

    rows = check_kernels(np.random.default_rng(1234), detail)
    check_leg_shapes(np.random.default_rng(2468), detail)
    rows += check_probe_kernels(np.random.default_rng(4321), detail)
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
    phases = dict(probes=run_probes(detail),
                  full_trg=run_main_path(detail, card),
                  oneloop=run_oneloop(detail, card))
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
