"""K11 out_block: the output block, every output redshift's columns,
sigma_v^2 and H in one launch (csrc/out_block.cu).

For the B lanes and the S output redshifts of one driver._finalize, from
the evolved states ys [B, S, 41, nk] it writes the table [B, S, nk, ncol]
in its printed column order (reference redTime.cc:1646-1741), sigma_v^2
[B, S] and H [B, S] (in h/Mpc):
  k | D, f, P_cb, beta/beta(a=1), dln beta/dln a, P_nu (print_lin) |
  P_00, P_01, P_11 x r^2 | A_u (print_a) | I (print_i) |
  P_B x r^3, then P_T, P_MR x r^4 (print_rsd: the 5 + 9 + 8 rows with
  print_bias, else 3 + 4 sums) | Q x r^3 (print_q),
r = a / a_in.  The lookups (growth D and dD/da, beta_P at a, 1, a 0.999
and min(1, a 1.001), the linear power, H^2/H0^2) come from the model's
tables; A_u, P_T and P_MR, where they are printed and the mode computes
them (Layout.mc), from the engine's transforms of ys's ln P rows, one
fastpt.compute_J_PZ call over the B S lanes (K9, K10, K1, K2), which the
caller makes; elsewhere they print 0.

Replaces the JAX package's output block, one XLA graph on the TPU with no
Pallas kernel: redtime_tpu/driver.py:133-198 (build_output_block),
:240-268 (_finalize: the block vmapped over z, sigma_v2, H),
redtime_tpu/trg.py:563 (pbis_j), :161 (_collapse_pt), the A rows, P_T
and P_MR of redtime_tpu/assembly.py:172-524, and the lookups
redtime_tpu/model.py:135 (beta_P_solver), :509 (growth_D_f), :521
(plin_all), :581 (sigma_v2), redtime_tpu/background.py:78 (H_H0).

The kernel's code is generated here (out_source, written beside the
sources by kernels/build.py): the A rows, P_T / P_MR and P_B traced from
assembly.ar_rows, assembly.pt_pmr_rows and trg.pbis_rows, each traced
operation one IEEE operation in traced order, and one case a column
layout (LAYOUTS) that names the layout's column groups and their first
columns.  The launch (launch_plan): a block a (lane, redshift) and a
range of its k points, the ranges of one pair a cluster where the pairs
are too few to fill the card, the columns staged in shared memory.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple

import numpy as np
import torch

from rtbench.rtref import assembly
from rtbench.rtref import background as bg
from rtbench.rtref import model as mdl
from rtbench.rtref import trg
from rtbench.rtref.config import C_NU_HOT, C_RHO_GAM, H0H
from rtbench.rtref.kernels import build, counts
from rtbench.rtref.kernels import rhs_tail as rt

F64 = torch.float64
NUP, NUI, NUQ = rt.NUP, rt.NUI, rt.NUQ
NU_STATE = rt.NU_STATE
MAX_Z = 64                 # output redshifts a launch (csrc/out_block.cu)
KT = 32                    # k points a chunk: a warp's threads
SMS = 132                  # the H100's SMs: blocks enough to fill them
WARPS = (8, 12)            # warps a block: two blocks an SM, or one
S_WARPS = 3                # of them the scalar warps (cluster rank 0)
MAX_CLUSTER = 8            # blocks a cluster (the portable most)
TILE_BYTES = 64 * 1024     # a pass's staging tile, at most


class Layout(NamedTuple):
    """A column layout: print_lin, print_a, print_i, print_rsd (rsd:
    "off", "sum" without print_bias, "bias" with it), print_q, and mc:
    whether A_u, P_T and P_MR come from the engine (else they print 0)."""

    lin: bool
    a: bool
    i: bool
    rsd: str
    q: bool
    mc: bool


RSD = ("off", "sum", "bias")
LAYOUTS = tuple(Layout(lin, a, i, rsd, q, mc)
                for lin, a, i, rsd, q, mc in itertools.product(
                    (False, True), (False, True), (False, True), RSD,
                    (False, True), (False, True))
                if not mc or a or rsd != "off")


def layout_of(cfg, settings) -> Layout:
    """The layout of a run: the reference recomputes the mode coupling at
    the output times in 1-loop mode (or full TRG with fill_pt_full_trg),
    when an RSD, A or bias column asks for it (redtime_tpu/driver.py:
    167-178); it reaches a column only through PRINTA or the RSD block."""
    need_mc = settings.nonlinear and (
        settings.one_loop or cfg.fill_pt_full_trg) and (
        settings.print_rsd or cfg.print_a or cfg.print_bias)
    rsd = ("off" if not settings.print_rsd
           else "bias" if cfg.print_bias else "sum")
    return Layout(bool(settings.print_lin), bool(cfg.print_a),
                  bool(cfg.print_i), rsd, bool(cfg.print_q),
                  bool(need_mc and (cfg.print_a or settings.print_rsd)))


def groups(lay: Layout) -> list:
    """The layout's column groups in order: (group, first column, count);
    a group the mode does not compute is ("zero", ...)."""
    out, col = [], 0

    def add(name, n, computed=True):
        nonlocal col
        out.append((name if computed else "zero", col, n))
        col += n

    add("k", 1)
    if lay.lin:
        add("lin", 6)
    add("p", 3)
    if lay.a:
        add("a", 14, lay.mc)
    if lay.i:
        add("i", 14)
    if lay.rsd == "bias":
        add("pb_bias", 5)
        add("pt_bias", 17, lay.mc)
    elif lay.rsd == "sum":
        add("pb_sum", 3)
        add("pt_sum", 4, lay.mc)
    if lay.q:
        add("q", 24)
    return out


def n_columns(lay: Layout) -> int:
    name, col, n = groups(lay)[-1]
    return col + n


# --- the plain PyTorch version

def block_plain(lay: Layout, y: torch.Tensor, k: torch.Tensor,
                model: mdl.Model, z: float, a_in: float, mc=None):
    """One output block [B, nk, ncol] at redshift z from the states y [B,
    41, nk] (the reference's main output loop, redTime.cc:1646-1741; the
    JAX package's build_output_block): mc = (A_u, P_T, P_MR) of the
    states when lay.mc, else None."""
    B = y.shape[0]
    a = 1.0 / (1.0 + z)
    r = a / a_in
    r2, r3, r4 = r * r, r ** 3, r ** 4
    cols = [k.expand(B, -1)]

    if lay.lin:
        D, dDda = mdl.growth_D_f(model, z)
        f = a * dDda / D
        _, Pcb, Pnu = mdl.plin_at(model, z, k)
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

    nk = k.shape[0]
    if mc is not None:
        A_u, PTjm, PMR = mc
        PT = trg._collapse_pt(PTjm)
    else:
        A_u = y.new_zeros((B, NUI, nk))
        PTjm = y.new_zeros((B, 9, nk))
        PMR = y.new_zeros((B, 8, nk))
        PT = y.new_zeros((B, 4, nk))

    if lay.a:
        cols += list(A_u.unbind(1))
    if lay.i:
        cols += list(y[:, NUP:NUP + NUI].unbind(1))

    if lay.rsd != "off":
        Q = y[:, NUP + NUI:].reshape(B, 3, 2, 2, 2, nk)
        pb = torch.stack(trg.pbis_rows(
            lambda l, a_, b, c: Q[:, l, a_, b, c], k), dim=1) * r3
        if lay.rsd == "bias":
            cols += list(pb.unbind(1))
            cols += [PTjm[:, n] * r4 for n in range(9)]
            cols += [PMR[:, n] * r4 for n in range(8)]
        else:
            cols += [pb[:, 0] + pb[:, 1], pb[:, 2] + pb[:, 3], pb[:, 4]]
            cols += [PT[:, n] * r4 for n in range(4)]

    if lay.q:
        cols += [y[:, NUP + NUI + j] * r3 for j in range(NUQ)]
    return torch.stack(cols, dim=2)


def sv_row(sv, nk: int, device) -> torch.Tensor | None:
    """sigma_v^2's interpolation row [nk] over the solver grid from sv =
    (i0, w[4]) (None: k = 1e-3 is the grid's first point)."""
    if sv is None:
        return None
    i0, w = sv
    row = np.zeros(nk)
    row[i0:i0 + 4] = w
    return torch.as_tensor(row, dtype=F64, device=device)


def out_block_plain(lay: Layout, ys, k, model: mdl.Model, zs, a_in: float,
                    src=None, sv=None):
    """The plain PyTorch version: (table [B, S, nk, ncol], sigma_v2 [B, S],
    H [B, S]) from the states ys [B, S, 41, nk] at the redshifts zs, with
    the engine's outputs src over the B S lanes (lane b S + s: ys[b, s])
    when lay.mc; sv: sigma_v^2's interpolation at k = 1e-3 (i0, w[4]), or
    None on a grid whose first point is k = 1e-3.  The JAX package's
    _finalize: build_output_block at each z, then sigma_v2 and H."""
    B, S = ys.shape[:2]
    mc = [None] * S
    if lay.mc:
        A_u, _, PT, PMR = trg.mode_coupling(*src, k, lay.rsd != "off")
        parts = [x.reshape((B, S) + x.shape[1:]) for x in (A_u, PT, PMR)]
        mc = [tuple(x[:, s] for x in parts) for s in range(S)]
    table = torch.stack([block_plain(lay, ys[:, s], k, model, float(z),
                                     a_in, mc[s])
                         for s, z in enumerate(zs)], dim=1)
    wsv = sv_row(sv, k.shape[0], ys.device)
    svs = torch.stack([mdl.sigma_v2(model, float(z), wsv) for z in zs],
                      dim=1)
    a = torch.as_tensor(1.0 / (1.0 + np.asarray(zs, dtype=np.float64)),
                        dtype=F64, device=ys.device).expand(B, -1)
    return table, svs, bg.H_H0(model.cosmo, a) * H0H


# --- the kernel's generated code (csrc/out_block.cu)

@functools.lru_cache(maxsize=1)
def programs() -> dict:
    """The traced programs the kernel runs, name -> (ARProgram, C of a
    feature): "a_rows" assembly.ar_program's A_unique rows, "pt_pmr_rows"
    assembly.pt_pmr_program (P_T, then P_MR), "pbis_rows" trg.pbis_rows
    (features: state rows)."""
    ar = assembly.ar_program()
    rec = assembly.Recorder()
    pb = trg.pbis_rows(lambda l, a, b, c: rec.leaf(
        NUP + NUI + 8 * l + 4 * a + 2 * b + c), rec.node("k"))
    pbis = assembly.ARProgram(tuple(rec.ops), tuple(v.i for v in pb))

    def eng(f):
        return (f"LD_JW({f})" if f < 126 else
                f"LD_PZ({f - 126})" if f < assembly.PT_JLO else "JLO_")

    return {"a_rows": (assembly.ARProgram(ar.ops, ar.outs[:NUI]), eng),
            "pt_pmr_rows": (assembly.pt_pmr_program(), eng),
            "pbis_rows": (pbis, lambda row: f"LD_Y({row})")}


def _program_c(name: str) -> list:
    """A traced program as a device function name(c, o): each value its
    outputs depend on one line (a feature one load), in traced order,
    then o[j] = output j."""
    prog, leaf = programs()[name]
    vals = sorted(set().union(*(rt._deps(prog.ops, o) for o in prog.outs)))
    lines = [f"__device__ __forceinline__ void {name}(const Ctx& c, "
             f"double* o) {{"]
    lines += [f"  const double v{i} = {rt._value_c(prog.ops[i], leaf)};"
              for i in vals]
    lines += [f"  o[{j}] = v{v};" for j, v in enumerate(prog.outs)]
    return lines + ["}", ""]


def _describe(lay: Layout) -> str:
    on = [n for n in ("lin", "a", "i", "q", "mc") if getattr(lay, n)]
    return " ".join(on + [f"rsd={lay.rsd}"])


def _group_c(name: str, col: int, n: int) -> str:
    if name == "zero":
        return f"g_zero(c, {col}, {n});"
    return f"g_{name}(c, {col});"


def out_source() -> str:
    """The kernel's generated header (out_block_gen.cuh): the traced
    programs (a_rows, pt_pmr_rows, pbis_rows), the layouts' column counts
    (LAYOUT_NCOL) and columns(layout, c), a switch with one case a layout
    of LAYOUTS that names its column groups in c (a Plan), each with its
    first column."""
    lines = ["// Generated by rtbench.rtref/kernels/out_block.py "
             "out_source from", "// assembly.ar_rows, assembly.pt_pmr_rows, "
             "trg.pbis_rows and the layouts; do", "// not edit.",
             f"constexpr int N_LAYOUTS = {len(LAYOUTS)};",
             "constexpr int LAYOUT_NCOL[N_LAYOUTS] = {"
             + ", ".join(str(n_columns(lay)) for lay in LAYOUTS) + "};", ""]
    for name in ("a_rows", "pt_pmr_rows", "pbis_rows"):
        lines += _program_c(name)
    lines += ["__device__ __forceinline__ void columns(int layout, "
              "Plan& c) {", "  switch (layout) {"]
    for n, lay in enumerate(LAYOUTS):
        lines.append(f"    case {n}: {{  // {_describe(lay)}: "
                     f"{n_columns(lay)} columns")
        lines += ["      " + _group_c(*g) for g in groups(lay)]
        lines += ["      break;", "    }"]
    lines += ["  }", "}", ""]
    return "\n".join(lines)


# --- the wrapper

def sv_weights(k_grid: np.ndarray, kmin: float):
    """sigma_v^2's interpolation at k = 1e-3 on the solver grid, (i0,
    w[4]) of interp.axis_weights_np in ln k (the reference evaluates it at
    the hard-coded k = 1e-3, AU_cosmological_parameters.h:963-970), or
    None when kmin is 1e-3: then it is the grid's first point."""
    from rtbench.rtref import interp
    if kmin == 1e-3:
        return None
    i0, w = interp.axis_weights_np(
        np.log(np.asarray(k_grid)),
        float(np.log(np.clip(1e-3, k_grid[0], k_grid[-1]))))
    return int(i0), tuple(float(x) for x in w)


def _check(lay: Layout, ys, k, model: mdl.Model, zs, src, sv) -> None:
    if lay not in LAYOUTS:
        raise ValueError(f"out_block: unknown layout {lay}")
    if ys.dim() != 4 or ys.shape[2] != NU_STATE:
        raise ValueError(f"out_block: ys must be [B, S, {NU_STATE}, nk], "
                         f"got {tuple(ys.shape)}")
    B, S, _, nk = ys.shape
    if len(zs) != S:
        raise ValueError(f"out_block: {len(zs)} redshifts for {S} states")
    if model.batch != B:
        raise ValueError(f"out_block: the model has {model.batch} lanes, "
                         f"ys {B}")
    if k.shape != (nk,):
        raise ValueError(f"out_block: k must be [{nk}], got "
                         f"{tuple(k.shape)}")
    if lay.mc:
        if src is None:
            raise ValueError("out_block: the layout needs the engine's "
                             "outputs over the B S lanes")
        Jw, PZw = src
        nfam = 14 if lay.rsd != "off" else 7
        if (Jw.dim() != 5 or Jw.shape[0] != B * S or Jw.shape[1] != nfam
                or Jw.shape[2:4] != (3, 3) or Jw.shape[4] != nk + 1):
            raise ValueError(f"out_block: Jw must be [{B * S}, {nfam}, 3, "
                             f"3, {nk + 1}], got {tuple(Jw.shape)}")
        if PZw.shape != (B * S, 7, 3, 3, nk):
            raise ValueError(f"out_block: PZw must be [{B * S}, 7, 3, 3, "
                             f"{nk}], got {tuple(PZw.shape)}")
    if sv is not None and not 0 <= sv[0] <= nk - 4:
        raise ValueError(f"out_block: sigma_v^2's row starts at {sv[0]}, "
                         f"outside [0, {nk - 4}]")
    for name, x in _tensors(ys, k, model, src if lay.mc else None):
        if x.dtype != F64:
            raise TypeError(f"out_block: {name} must be float64, got "
                            f"{x.dtype}")
        if x.device != ys.device:
            raise ValueError("out_block: inputs on different devices")


def _tensors(ys, k, model: mdl.Model, src) -> list:
    """(name, tensor) of every input, in rt_out_block's pointer order."""
    c = model.cosmo
    out = [("ys", ys), ("k", k), ("n_s", c.n_s), ("h", c.h),
           ("Omega_m", c.Omega_m), ("Omega_nu", c.Omega_nu),
           ("T_cmb", c.T_cmb), ("w0", c.w0), ("wa", c.wa),
           ("norm", model.norm), ("sigmaV2_z0", model.sigmaV2_z0),
           ("T_solver", model.T_solver), ("beta_a", model.beta_a),
           ("beta_solver", model.beta_solver), ("g_lna", model.g_lna),
           ("g_G", model.g_G), ("g_dDda", model.g_dDda),
           ("g_Dnorm", model.g_Dnorm)]
    if src is not None:
        out += [("Jw", src[0]), ("PZw", src[1])]
    return out


def out_block(lay: Layout, ys, k, model: mdl.Model, zs, a_in: float,
              src=None, sv=None):
    """(table [B, S, nk, ncol], sigma_v2 [B, S], H [B, S]): the hand
    kernel for CUDA tensors, the plain version for CPU tensors.  ys [B, S,
    41, nk]; zs the S redshifts; src the engine's outputs over the B S
    lanes when lay.mc (else None); sv as in out_block_plain."""
    _check(lay, ys, k, model, zs, src, sv)
    if True:  # the reference: the plain version on every device
        return out_block_plain(lay, ys, k, model, zs, a_in, src, sv)
    if ys.device.type != "cuda":
        raise RuntimeError(f"out_block: no kernel for device {ys.device}")
    B, S, _, nk = ys.shape
    ins = _tensors(ys, k, model, src if lay.mc else None)
    bad = [name for name, x in ins if not x.is_contiguous()]
    if bad:
        raise ValueError(f"out_block: the kernel takes contiguous tensors, "
                         f"not {bad}")
    if model.g_lna.shape[1] < 4:
        raise ValueError("out_block: the growth table needs at least 4 "
                         "nodes")
    if 0 < model.beta_a.shape[1] < 4:
        raise ValueError("out_block: the beta_P table needs 0 or at least 4 "
                         "nodes")
    ncol = n_columns(lay)
    table = torch.empty((B, S, nk, ncol), dtype=F64, device=ys.device)
    svs = torch.empty((B, S), dtype=F64, device=ys.device)
    H = torch.empty((B, S), dtype=F64, device=ys.device)
    if B == 0 or S == 0 or nk == 0:
        return table, svs, H
    lib = build.lib()
    for s0, s1 in z_launches(S):
        launch(lib, lay, ys, k, model, zs, a_in, src, sv, table, svs, H,
               s0, s1)
        counts.LAUNCHES["out_block"] += 1
    return table, svs, H


def z_launches(S: int) -> list:
    """The launches over S redshifts: (s0, s1), at most MAX_Z each."""
    return [(s0, min(S, s0 + MAX_Z)) for s0 in range(0, S, MAX_Z)]


def launch_plan(nk: int, B: int, S: int, ncol: int) -> dict:
    """The launch over B lanes and S redshifts of ncol columns at nk
    points.  Each (lane, redshift) pair is one block where the pairs are
    at least half the SMS or a pair has at most 2 chunks of KT points: a
    block's time is its chain of lookups, which a cluster does not
    shorten and its hand-over between blocks lengthens (on the H100: full
    TRG 16 x 8 0.00785 ms against 0.00838 in clusters of 2; nk = 48, 2 x
    8, 0.00616 against 0.00806).  Else a pair is a cluster of `cluster`
    blocks, the fewest (at most MAX_CLUSTER, at most a chunk a block) that
    make SMS blocks (the presets' 2 x 2 at nk = 512 0.00745 ms in clusters
    of 8 against 0.0127 in one block; 8 x 7 with every switch 0.01059 in
    clusters of 4 against 0.01113).  A block takes `chunks` consecutive
    chunks (the last block fewer; the cluster count is rounded so that
    none is left empty) in passes of `pass_chunks` (a staging tile of at
    most TILE_BYTES, rows of an odd pitch; a lin warp a chunk beside the
    S_WARPS scalar warps), with 8 warps where the blocks are more than
    the SMS (two an SM at 128 registers, all resident), else 12 (one an
    SM, more warps for the units: full TRG 16 x 8 0.00733 ms against
    0.00774 with 8)."""
    nkt, pairs = -(-nk // KT), B * S
    for c in range(1, min(MAX_CLUSTER, nkt) + 1):
        chunks = -(-nkt // c)
        cluster = -(-nkt // chunks)
        if pairs * cluster >= SMS or 2 * pairs >= SMS or nkt <= 2:
            break
    pitch = ncol | 1
    blocks = pairs * cluster
    warps = WARPS[blocks <= SMS]
    pass_chunks = max(1, min(chunks, WARPS[0] - S_WARPS,
                             TILE_BYTES // (KT * pitch * 8)))
    return dict(blocks=blocks, threads=32 * warps, cluster=cluster,
                chunks=chunks, pass_chunks=pass_chunks,
                smem_bytes=pass_chunks * KT * pitch * 8)


N_POINTERS = 18 + 2 + 3     # _tensors (engine included), table, sigma_v2, H


def launch(lib, lay: Layout, ys, k, model: mdl.Model, zs, a_in: float, src,
           sv, table, svs, H, s0: int, s1: int, plan=None) -> None:
    """One launch of `lib`'s rt_out_block for the redshifts s0 .. s1 - 1
    (at most MAX_Z) on the current stream, under launch_plan's plan (or
    `plan`: scripts/time_out_block.py times others).  Counts nothing.
    The per-z values (a = 1 / (1 + z), r^2, r^3, r^4 of r = a / a_in,
    Python floats as the plain version computes them) and the pointers go
    by value: nothing is copied to the card."""
    B, S, _, nk = ys.shape
    ins = _tensors(ys, k, model, src if lay.mc else None)
    ptrs = [x.data_ptr() for _, x in ins]
    ptrs += [None] * (20 - len(ptrs)) + [table.data_ptr(), svs.data_ptr(),
                                         H.data_ptr()]
    n = s1 - s0
    av = [1.0 / (1.0 + float(z)) for z in zs[s0:s1]]
    r = [x / a_in for x in av]
    dz = lambda xs: (ctypes.c_double * MAX_Z)(*xs)
    sv_i0, sv_w = (-1, (0.0,) * 4) if sv is None else sv
    plan = plan or launch_plan(nk, B, n, n_columns(lay))
    nfam = src[0].shape[1] if lay.mc else 0
    with torch.cuda.device(ys.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.rt_out_block(
            (ctypes.c_void_p * N_POINTERS)(*ptrs), N_POINTERS, dz(av),
            dz([x * x for x in r]), dz([x ** 3 for x in r]),
            dz([x ** 4 for x in r]),
            (ctypes.c_double * 4)(*sv_w), float(a_in), H0H, C_RHO_GAM,
            C_NU_HOT, B, S, s0, n, nk, model.beta_a.shape[1],
            model.g_lna.shape[1], nfam, sv_i0, LAYOUTS.index(lay),
            n_columns(lay), plan["cluster"], plan["chunks"],
            plan["pass_chunks"], plan["threads"], stream)
    build.check(status, "out_block")
