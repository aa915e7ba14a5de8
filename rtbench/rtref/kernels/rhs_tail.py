"""K8 rhs_tail: the Time-RG right-hand side after the mode-coupling engine,
its lookups included (csrc/rhs_tail.cu).

Per lane b and k point, from the state y [B, 41, nk] at eta [B]:
  dlnP (rows 0-2)   d ln P_ab / d eta from Omega(a, k), the I coupling and
                    the three clamps (reference :1449-1491);
  dI   (rows 3-16)  2 e^eta A_u - CI . (Of x I14)     (reference :1500-1513);
  dQ   (rows 17-40) 2 e^eta R - CQ . (Of x Q24) when Q evolves, else 0
                    (reference :1516-1539).
Omega(a, k) comes from the model's tables (OmegaIn): a = a_in e^eta,
beta_P(a, k) and the background scalars.  A_u and R come, in full
Time-RG, from the engine's transforms through the A/R half of the assembly
(assembly.assemble_ar), and in 1-loop mode from the z1l cache rescaled by
growth factors (trg.oneloop_rescale) that the growth table gives at eta's
z (OneLoopSrc).  In linear mode only dlnP is nonzero.

Replaces the JAX package's jitted RHS, which XLA fused on the TPU (no
Pallas kernel): redtime_tpu/trg.py:178-254 (make_rhs's rhs), :84-98
(omega_matrix), :136-159 (oneloop_rescale), the A/R part of
redtime_tpu/assembly.py:172-524 and the lookups inlined in them
(redtime_tpu/model.py:126-148, :509-518; redtime_tpu/background.py:71-88).
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
from rtbench.rtref.kernels import build, counts

F64 = torch.float64

# state rows (trg's layout): ln P_00, ln P_01, ln P_11; the 14 unique I;
# the 24 Q
NUP, NUI, NUQ = 3, 14, 24
NU_STATE = NUP + NUI + NUQ

# Finite-range guards (redtime_tpu/trg.py:34-51): an adaptive TRIAL step
# can overshoot lnP far beyond any physical value.  The caps sit ~7
# e-folds outside any physical trajectory, so accepted steps are
# untouched; they bind only inside rejected trials — and so decide which
# trials are rejected, which is why the port keeps them: the step
# sequence follows the JAX package's.
LNP_MIN, LNP_MAX = -80.0, 20.0
DLNP_GUARD = 1e4

# fz exponents of the 1-loop rescale (reference :1322-1336), as indices
# into fpow = (fz, fz^2, fz^3, fz^4).  The JAX package picks these rows
# with one-hot matmuls (redtime_tpu/trg.py:59-70); a one-hot product of
# finite f64 values is exact, so indexing gives the same bits.
BEF_IDX = [(j % 8) // 4 + ((j % 8) % 4) // 2 + (j % 8) % 2
           for j in range(64)]
ABC_IDX = [(j // 4) + (j % 4) // 2 + (j % 2) for j in range(8)]
_BEF_JU = [BEF_IDX[s] for s in assembly.JU]

MAX_LANES = 65535          # lanes a launch: the grid's y extent


class OmegaIn(NamedTuple):
    """What Omega(a, k) is built from: the model's beta_P table and the
    cosmology's lane constants, made once per trg.make_rhs.  At each
    evaluation the RHS takes a = a_in e^eta, beta_P(a, k) (model.beta_P_at)
    and a^3 H^2/H0^2, 3 + dlnH/dlna (bg.omega_scalars) from them."""

    beta_a: torch.Tensor        # [B, nz] the table's scale factors (nz 0:
                                # no neutrino table, beta_P = 0)
    beta_solver: torch.Tensor   # [B, nz, nk] beta/f_nu on the solver grid
    f_nu: torch.Tensor          # [B]
    Omega_m: torch.Tensor       # [B]
    consts: bg.OmegaConsts      # 13 x [B] (bg.omega_consts)
    a_in: float


class OmegaAt(NamedTuple):
    """Omega(a, k) at per-lane a: its rows are (1, -1) and (o10(k), o11),
    o10 = -1.5 Omega_m (f_cb + beta) / den."""

    beta: torch.Tensor      # [B, nk] beta_P(a, k)
    Omega_m: torch.Tensor   # [B]
    f_cb: torch.Tensor      # [B]
    den: torch.Tensor       # [B] a^3 H^2/H0^2
    o11: torch.Tensor       # [B] 3 + dlnH/dlna


class FullSrc(NamedTuple):
    """Full Time-RG: the engine's transforms as K1 and K2 write them."""

    Jw: torch.Tensor    # [B, nfam, 3, 3, O], O >= nk: J (families 0-6),
                        # Jn0 (7-13, only with RSD: nfam 14)
    PZw: torch.Tensor   # [B, 7, 3, 3, nk]


class OneLoopSrc(NamedTuple):
    """1-loop mode: the z1l cache's rows and the model's growth tables,
    made once per trg.make_rhs; the RHS looks the growth up at eta's z =
    e^-eta (1 + z_in) - 1 (model.growth_at)."""

    A_u: torch.Tensor      # [B, 14, nk] the cache's A64[:, JU]
    R: torch.Tensor        # [B, 3, 8, nk]
    g_lna: torch.Tensor    # [B, nn] the growth table's ln a nodes
    g_G: torch.Tensor      # [B, nn, nk]
    g_dDda: torch.Tensor   # [B, nn, nk]
    g_Dnorm: torch.Tensor  # [B, nk]
    D_z1l: torch.Tensor    # [B, nk]
    z_in: float


def omega_at(om: OmegaIn, a: torch.Tensor) -> OmegaAt:
    """Omega's inputs at per-lane a [B] (trg.omega_inputs' operations)."""
    beta = mdl.beta_P_at(om.beta_a, om.beta_solver, om.f_nu, a)
    return OmegaAt(beta, om.Omega_m, om.consts.f_cb,
                   *bg.omega_scalars(a, om.consts))


def prologue_plain(eta: torch.Tensor, om: OmegaIn, src):
    """The RHS's lookups at eta [B], as the eager prologue computed them
    before K8 took them over: (OmegaAt, and in 1-loop mode (D, dD/da, z)
    [B, nk], [B, nk], [B] at eta's z, else None)."""
    at = omega_at(om, om.a_in * torch.exp(eta))
    if not isinstance(src, OneLoopSrc):
        return at, None
    z = torch.exp(-eta) * (1.0 + src.z_in) - 1.0        # [B]
    D, dDda = mdl.growth_at(src.g_lna, src.g_G, src.g_dDda, src.g_Dnorm, z)
    return at, (D, dDda, z)


def omega_from(om: OmegaAt) -> torch.Tensor:
    """Omega(a, k) [B, 2, 2, nk] (reference :1383-1411)."""
    B, nk = om.beta.shape
    ones = torch.ones((B, nk), dtype=F64, device=om.beta.device)
    o10 = (-1.5 * om.Omega_m[:, None] * (om.f_cb[:, None] + om.beta)
           / om.den[:, None])
    o11 = om.o11[:, None] * ones
    return torch.stack([torch.stack([ones, -ones], dim=1),
                        torch.stack([o10, o11], dim=1)], dim=1)


@functools.lru_cache(maxsize=8)
def _mats(device: torch.device):
    """CI [14, 56], CQ [24, 96] (assembly.OMEGA_BILINEAR) and TR14 [4, 14]
    on `device`, then the fz power indices of the JU rows of A and of R
    (made once: a CUDA graph cannot copy them from the host)."""
    CI, CQ = (torch.as_tensor(m, dtype=F64, device=device)
              for m in assembly.OMEGA_BILINEAR)
    TR14 = torch.as_tensor(assembly.OMEGA_MATS[2], dtype=F64, device=device)
    return (CI, CQ, TR14, torch.tensor(_BEF_JU, device=device),
            torch.tensor(ABC_IDX, device=device))


def _rescale(src: OneLoopSrc, growth, eta: torch.Tensor):
    """trg.oneloop_rescale's A_u and R at the growth (D, dD/da, z) of
    prologue_plain: the same operations in the same order, on the JU rows
    of A."""
    D, dDda, z = growth
    fz = dDda / (D * (1.0 + z)[:, None])
    dr = D / src.D_z1l
    dr2 = dr * dr
    pre = (dr2 * dr2 * torch.exp(-4.0 * eta)[:, None])[:, None]  # [B,1,nk]
    f2 = fz * fz
    fpow = torch.stack([fz, f2, f2 * fz, f2 * f2], dim=1)  # [B, 4, nk]
    bef_ju, abc = _mats(eta.device)[3:]
    A_u = pre * fpow[:, bef_ju] * src.A_u
    R = pre[:, None] * fpow[:, abc][:, None] * src.R
    return A_u, R


def rhs_tail_plain(y, eta, k, om: OmegaIn, src, evolve_q: bool):
    """The plain PyTorch version: the eager RHS of make_rhs after the
    engine, from the lookups (prologue_plain: a, beta_P, the Omega
    scalars; the 1-loop growth) through omega_matrix, assemble's A/R and
    oneloop_rescale, in their order.  src: FullSrc, OneLoopSrc, or None
    (linear mode).  Returns dy [B, 41, nk]."""
    B, _, nk = y.shape
    at, growth = prologue_plain(eta, om, src)
    O = omega_from(at)                                   # [B, 2, 2, nk]
    e_eta = torch.exp(eta)[:, None]

    lnP = torch.clamp(y[:, 0:3], LNP_MIN, LNP_MAX)
    P = torch.exp(lnP)                                   # P00, P01, P11

    nonlinear = src is not None
    if nonlinear:
        CI, CQ, TR14 = _mats(y.device)[:3]
        I14 = y[:, NUP:NUP + NUI]
        if isinstance(src, OneLoopSrc):
            A_u, R = _rescale(src, growth, eta)
        else:
            Jf = src.Jw[..., :nk]
            A_u, R = assembly.assemble_ar(Jf[:, :7], src.PZw, Jf[:, 7:], k,
                                          evolve_q)
        Of = O.reshape(B, 4, nk)                         # O[i, g] at 2i+g

    # --- d ln P (reference :1449-1491)
    dP0 = -2.0 * (O[:, 0, 0] * P[:, 0] + O[:, 0, 1] * P[:, 1])
    dP1 = -(O[:, 0, 0] * P[:, 1] + O[:, 0, 1] * P[:, 2]) - \
        (O[:, 1, 0] * P[:, 0] + O[:, 1, 1] * P[:, 1])
    dP2 = -2.0 * (O[:, 1, 0] * P[:, 1] + O[:, 1, 1] * P[:, 2])
    if nonlinear:
        # I-coupling: sum_{c,d} I_{acd,bcd} + I_{bcd,acd}
        Isum = (TR14 @ I14).reshape(B, 2, 2, nk)
        coef = e_eta * 4.0 * np.pi / k
        dP0 = dP0 + coef * (Isum[:, 0, 0] + Isum[:, 0, 0])
        dP1 = dP1 + coef * (Isum[:, 1, 0] + Isum[:, 0, 1])
        dP2 = dP2 + coef * (Isum[:, 1, 1] + Isum[:, 1, 1])
    dlnP = torch.stack([dP0 / P[:, 0], dP1 / P[:, 1], dP2 / P[:, 2]], dim=1)
    dlnP = torch.clamp(dlnP, -DLNP_GUARD, DLNP_GUARD)
    # late-time P_11 -> 0 instability clamp (reference :1487-1491)
    dlnP = torch.cat([dlnP[:, :2], torch.clamp(dlnP[:, 2:], -10.0, 10.0)],
                     dim=1)

    if not nonlinear:
        return torch.cat([dlnP, dlnP.new_zeros((B, NUI + NUQ, nk))], dim=1)

    # --- dI (reference :1500-1513): one bilinear product against the
    # (Of x I14) outer product
    OI = (Of[:, :, None, :] * I14[:, None, :, :]).reshape(B, 4 * NUI, nk)
    dI = 2.0 * e_eta[:, :, None] * A_u - CI @ OI

    # --- dQ (reference :1516-1539)
    if evolve_q:
        Q24 = y[:, NUP + NUI:]
        OQ = (Of[:, :, None, :] * Q24[:, None, :, :]).reshape(B, 4 * NUQ, nk)
        dQ = 2.0 * e_eta[:, :, None] * R.reshape(B, NUQ, nk) - CQ @ OQ
    else:
        dQ = dlnP.new_zeros((B, NUQ, nk))
    return torch.cat([dlnP, dI, dQ], dim=1)


# --- the kernel's work items (csrc/rhs_tail.cu)
#
# The kernel's unit of work is a task: one work item (a few output rows of
# dI / dQ, or dlnP, or the zero rows) at KT k points of one lane, on one
# warp.  Tasks are numbered item-major and a block takes consecutive ones,
# so that the warps an SM holds at once run the code of one or two items.
# Each item is straight-line code generated here (ar_source), one
# instantiation of the kernel a variant (the mode, and whether Q evolves).

KT = 32                 # k points a task: a warp's threads
VARIANTS = ("linear", "full", "full_q", "oneloop", "oneloop_q")
# an item's outputs, packed while their operations stay within this cost
ITEM_COST = {"linear": 0, "full": 260, "full_q": 260, "oneloop": 120,
             "oneloop_q": 120}
BLOCK_WARPS = (8, 4, 2, 1)   # warps a block: the most that leaves
FILL_BLOCKS = 2 * 132        # this many blocks (two an SM), else one
SOURCES = ("y", "jw", "pz", "au", "r")   # where a row an item loads lives


def variant(mode: str, evolve_q: bool) -> str:
    """The kernel variant of a mode ('linear', 'full', 'oneloop')."""
    return mode if mode == "linear" else mode + ("_q" if evolve_q else "")


@functools.lru_cache(maxsize=1)
def kernel_table():
    """The Omega and trace terms as the kernel applies them: (terms,
    trace, fidx).  terms[o] (o 0-13 dI, 14-37 dQ): (g, state row, weight)
    in CI's / CQ's column order (assembly.OMEGA_BILINEAR), the term
    weight * (Of[g] * y[row]) with Of = (1, -1, o10, o11); trace[r]
    (Isum's four rows): (state row, weight) of TR14; fidx[o]: output o's
    1-loop fz power (0-3: fz, fz^2, fz^3, fz^4)."""
    CI, CQ = assembly.OMEGA_BILINEAR
    TR14 = assembly.OMEGA_MATS[2]
    terms = []
    for o in range(NUI + NUQ):
        C, nI, row0, r = ((CI, NUI, NUP, o) if o < NUI
                          else (CQ, NUQ, NUP + NUI, o - NUI))
        gs = [divmod(int(m), nI) + (float(C[r, m]),)
              for m in np.flatnonzero(C[r])]
        terms.append(tuple((g, row0 + s, w) for g, s, w in gs))
    trace = tuple(tuple((NUP + int(s), float(TR14[r, s]))
                        for s in np.flatnonzero(TR14[r])) for r in range(4))
    fidx = tuple(_BEF_JU + [ABC_IDX[j % 8] for j in range(NUQ)])
    return tuple(terms), trace, fidx


@functools.lru_cache(maxsize=1)
def _ar():
    """assembly.ar_program's operations and, for each of its 38 outputs,
    the values it is computed from in traced order."""
    prog = assembly.ar_program()
    ops = prog.ops
    if any(ops[i][0] == "f" and 63 <= ops[i][1] < 126
           for o in prog.outs[:NUI] for i in _deps(ops, o)):
        raise AssertionError("A_unique reads Jn0: the kernel loads Jn0 "
                             "only with RSD")
    return ops, tuple(tuple(sorted(_deps(ops, o))) for o in prog.outs)


def _deps(ops, i: int) -> set:
    """The values that value i is computed from, i included."""
    seen, todo = set(), [i]
    while todo:
        j = todo.pop()
        if j in seen:
            continue
        seen.add(j)
        op, a, b = ops[j]
        if op not in ("f", "k"):
            todo.append(a)
        if op in ("add", "sub", "mul", "div"):
            todo.append(b)
    return seen


def _feature_row(f: int) -> tuple:
    """The row of assembly feature f: J and Jn0 are Jw's rows as K1 wrote
    them, PZ PZw's."""
    return ("jw", f) if f < 126 else ("pz", f - 126)


class Item(NamedTuple):
    """One work item: its outputs (0-13 dI, 14-37 dQ), dlnP, zero rows."""

    outs: tuple = ()
    dlnp: bool = False
    zeros: tuple = ()


def _out_values(var: str, outs) -> list:
    """The A/R program's values the outputs are computed from, in traced
    order (full TRG; none in 1-loop mode)."""
    if not var.startswith("full"):
        return []
    vals = _ar()[1]
    return sorted(set().union(*(vals[o] for o in outs)))


@functools.lru_cache(maxsize=None)
def item_rows(var: str, item: Item) -> frozenset:
    """The rows (source, row) that a work item of variant var loads: its
    outputs' Omega terms' state rows and A/R features (full TRG) or cache
    rows (1-loop); for dlnP lnP and the trace's I rows."""
    terms, trace, _ = kernel_table()
    rows = {("y", row) for o in item.outs for _, row, _ in terms[o]}
    if var.startswith("full"):
        ops = _ar()[0]
        rows |= {_feature_row(ops[i][1]) for i in _out_values(var, item.outs)
                 if ops[i][0] == "f"}
    else:
        rows |= {("au", o) if o < NUI else ("r", o - NUI)
                 for o in item.outs}
    if item.dlnp:
        rows |= {("y", r) for r in range(NUP)}
        if var != "linear":
            rows |= {("y", row) for tr in trace for row, _ in tr}
    return frozenset(rows)


@functools.lru_cache(maxsize=None)
def item_cost(var: str, item: Item) -> int:
    """Operations of a work item as the packing weighs them: its A/R
    values computed once, two an Omega term, three an output, 150 for
    dlnP (three exp, four divisions), one a zero row."""
    terms = kernel_table()[0]
    ops = _ar()[0]
    return (sum(ops[i][0] not in ("f", "k")
                for i in _out_values(var, item.outs))
            + sum(2 * len(terms[o]) + 3 for o in item.outs)
            + 150 * item.dlnp + len(item.zeros))


@functools.lru_cache(maxsize=None)
def items(var: str) -> tuple:
    """Variant var's work items.  The variant's outputs start one an item
    and are merged, the pair that shares the most rows first, while the
    merged item's cost stays within ITEM_COST[var] (the A/R programs share
    little but features: 1,397 distinct values of 1,949, of which 552 are
    feature reads); then dlnP, an item of its own, and the zero rows (dQ
    without Q; dI and dQ in linear mode).  Heaviest first."""
    nout = 0 if var == "linear" else NUI + (NUQ if var.endswith("_q")
                                            else 0)
    packed = [(o,) for o in range(nout)]
    cap = ITEM_COST[var]
    while True:
        best, most = None, 0
        for i, j in itertools.combinations(range(len(packed)), 2):
            merged = Item(packed[i] + packed[j])
            if item_cost(var, merged) > cap:
                continue
            shared = (len(item_rows(var, Item(packed[i])))
                      + len(item_rows(var, Item(packed[j])))
                      - len(item_rows(var, merged)))
            if shared > most:
                best, most = (i, j), shared
        if best is None:
            break
        i, j = best
        packed[i] = tuple(sorted(packed[i] + packed[j]))
        del packed[j]
    out = [Item(outs) for outs in packed] + [Item(dlnp=True)]
    if nout < NUI + NUQ:
        out.append(Item(zeros=tuple(range(NUP + nout, NU_STATE))))
    return tuple(sorted(out, key=lambda it: -item_cost(var, it)))


@functools.lru_cache(maxsize=256)
def launch_plan(var: str, nk: int, B: int) -> dict:
    """The launch of variant var at nk points and B lanes: tasks (items x
    lanes x k tiles), warps a block (BLOCK_WARPS: the most that leaves
    FILL_BLOCKS blocks), blocks; no shared memory.  The wrapper passes
    blocks and threads to rt_rhs_tail."""
    tasks = len(items(var)) * B * -(-nk // KT)
    warps = next((w for w in BLOCK_WARPS if -(-tasks // w) >= FILL_BLOCKS),
                 BLOCK_WARPS[-1])
    return dict(blocks=-(-tasks // warps), threads=32 * warps, tasks=tasks,
                smem_bytes=0)


def _c_double(c: float) -> str:
    return repr(float(c))


OF_C = ("1.0", "-1.0", "O10_", "O11_")     # Of[g] in the generated code
LOAD_C = {"y": "LD_Y", "jw": "LD_JW", "pz": "LD_PZ", "au": "LD_AU",
          "r": "LD_R"}


def _row_name(row: tuple) -> str:
    return f"{row[0]}{row[1]}"


def _value_c(op: tuple, leaf=None) -> str:
    """One traced operation of assembly.ar_program as C: one IEEE
    operation (__d*_rn: no contraction), a division by a constant as a
    product with 1/c (DIVC_); a feature read as leaf(feature) (default:
    the name of its loaded row)."""
    op, a, b = op
    if op == "f":
        return leaf(a) if leaf else _row_name(_feature_row(a))
    if op == "k":
        return "K_"
    if op in ("add", "sub", "mul", "div"):
        return f"__d{op}_rn(v{a}, v{b})"
    if op == "muls":
        return f"__dmul_rn(v{a}, {_c_double(b)})"
    if op == "divs":
        return f"DIVC_(v{a}, {_c_double(b)})"
    if op == "recip":
        return f"__drcp_rn(v{a})"
    if op == "neg":
        return f"-v{a}"
    raise ValueError(f"ar_source: unknown operation {op}")


def _scalars_c(var: str, item: Item) -> list:
    """The scalars an item reads, computed in the warp (the helpers of
    csrc/rhs_tail.cu: the plain version's operations in its order)."""
    terms, _, fidx = kernel_table()
    gs = {g for o in item.outs for g, _, _ in terms[o]}
    lines = []
    if item.dlnp and var != "linear" or var.startswith("full") and item.outs:
        lines.append("const double K_ = K_AT();")
    if item.dlnp and var != "linear":
        lines.append("const double E_ = LANE_E();")
    if item.outs:
        lines.append("const double E2_ = __dmul_rn(2.0, LANE_E());")
    if item.dlnp or 2 in gs:
        lines.append("const double O10_ = O10_AT();")
    if item.dlnp or 3 in gs:
        lines.append("const double O11_ = LANE_O11();")
    if var.startswith("oneloop") and item.outs:
        powers = {fidx[o] + 1 for o in item.outs}
        lines += ["const double PRE_ = PRE_AT();",
                  "const double FZ_ = FZ_AT();"]
        if max(powers) > 1:
            lines.append("const double F2_ = __dmul_rn(FZ_, FZ_);")
        power = {1: "FZ_", 2: "F2_", 3: "__dmul_rn(F2_, FZ_)",
                 4: "__dmul_rn(F2_, F2_)"}
        lines += [f"const double PF{n}_ = __dmul_rn(PRE_, {power[n]});"
                  for n in sorted(powers)]
    return lines


def _item_c(var: str, item: Item) -> list:
    """The lines of one work item: its scalars, the rows it reads (one
    load a row), its A/R values (full TRG) and then, an output at a time,
    its source term, its Omega terms and its row of dy; dlnP; zero rows."""
    terms, trace, fidx = kernel_table()
    lines = _scalars_c(var, item)
    lines += [f"const double {_row_name(r)} = {LOAD_C[r[0]]}({r[1]});"
              for r in sorted(item_rows(var, item),
                              key=lambda r: (SOURCES.index(r[0]), r[1]))]
    ops, vals = _ar()
    lines += [f"const double v{i} = {_value_c(ops[i])};"
              for i in _out_values(var, item.outs)]
    for o in item.outs:
        row = NUP + o
        if var.startswith("full"):
            src = f"v{vals[o][-1]}"
        else:
            cache = ("au", o) if o < NUI else ("r", o - NUI)
            lines.append(f"const double a{row} = __dmul_rn(PF{fidx[o] + 1}_,"
                         f" {_row_name(cache)});")
            src = f"a{row}"
        lines.append(f"double t{row} = 0.0;")
        lines += [f"t{row} += {_c_double(w)} * __dmul_rn({OF_C[g]}, "
                  f"y{yr});" for g, yr, w in terms[o]]
        lines.append(f"OUT_({row}, __dsub_rn(__dmul_rn(E2_, {src}), "
                     f"t{row}));")
    if item.dlnp:
        ys = ", ".join(f"y{r}" for r in range(NUP))
        if var == "linear":
            lines.append(f"DLNP_LINEAR_({ys});")
        else:
            for r, tr in enumerate(trace):
                lines.append(f"double i{r} = 0.0;")
                lines += [f"i{r} += {_c_double(w)} * y{row};"
                          for row, w in tr]
            lines.append(f"DLNP_({ys}, i0, i1, i2, i3);")
    lines += [f"ZERO_({row});" for row in item.zeros]
    return lines


def _describe(item: Item) -> str:
    """An item's rows of dy, in words."""
    names = [f"{'dI' if o < NUI else 'dQ'} row {NUP + o}" for o in item.outs]
    if item.dlnp:
        names.append("dlnP")
    if item.zeros:
        names.append(f"zero rows {item.zeros[0]}-{item.zeros[-1]}")
    return ", ".join(names)


def ar_source() -> str:
    """The kernel's generated header (rhs_tail_ar.cuh, written beside the
    sources by kernels/build.py): the largest block (MAX_BLOCK_THREADS,
    of BLOCK_WARPS) and, for each variant of VARIANTS, a Sched<V> with its
    item count and item(it, c), a switch over the variant's work items.
    An item computes the scalars it reads, loads each row it reads once
    (LD_*), runs the A/R values of its outputs (full TRG: each traced
    operation of assembly.ar_program one line, one IEEE operation, in
    traced order) or their cache rows times pre fz^n (1-loop), then for
    each output its Omega terms and 2 e^eta A - t; dlnP its trace sums and
    dlnp(); the zero rows their stores."""
    lines = ["// Generated by rtbench.rtref/kernels/rhs_tail.py "
             "ar_source from", "// assembly.ar_rows and the work items; do "
             "not edit.",
             "enum Variant { "
             + ", ".join(f"V_{v.upper()} = {i}"
                         for i, v in enumerate(VARIANTS)) + " };",
             f"constexpr int MAX_BLOCK_THREADS = {32 * max(BLOCK_WARPS)};",
             ""]
    for var in VARIANTS:
        its = items(var)
        mode = 0 if var == "linear" else 1 if var.startswith("full") else 2
        lines += [f"template <> struct Sched<V_{var.upper()}> {{",
                  f"  static constexpr int MODE = {mode}, "
                  f"ITEMS = {len(its)};",
                  "  static __device__ __forceinline__ void item("
                  "const int it, const Ctx& c) {", "    switch (it) {"]
        for n, it in enumerate(its):
            lines.append(f"      case {n}: {{  // {_describe(it)}")
            lines += ["        " + ln for ln in _item_c(var, it)]
            lines += ["        break;", "      }"]
        lines += ["    }", "  }", "};", ""]
    return "\n".join(lines)


def _src_tensors(src) -> list:
    if src is None:
        return []
    return list(src[:-1]) if isinstance(src, OneLoopSrc) else list(src)


def _om_tensors(om: OmegaIn) -> list:
    return [om.beta_a, om.beta_solver, om.f_nu, om.Omega_m, *om.consts]


def _check(y, eta, k, om: OmegaIn, src, evolve_q: bool) -> None:
    if y.dim() != 3 or y.shape[1] != NU_STATE:
        raise ValueError(f"rhs_tail: y must be [B, {NU_STATE}, nk], got "
                         f"{tuple(y.shape)}")
    B, _, nk = y.shape
    if not isinstance(om, OmegaIn) or not isinstance(om.consts,
                                                     bg.OmegaConsts):
        raise TypeError("rhs_tail: om must be OmegaIn with bg.OmegaConsts")
    nz = om.beta_a.shape[-1]
    if 0 < nz < 4:
        raise ValueError(f"rhs_tail: the beta_P table needs 0 or at least "
                         f"4 nodes, got {nz}")
    shapes = [("eta", eta, (B,)), ("k", k, (nk,)),
              ("beta_a", om.beta_a, (B, nz)),
              ("beta_solver", om.beta_solver, (B, nz, nk)),
              ("f_nu", om.f_nu, (B,)), ("Omega_m", om.Omega_m, (B,))]
    shapes += [(name, x, (B,)) for name, x in om.consts._asdict().items()]
    scalars = [("a_in", om.a_in)]
    if isinstance(src, FullSrc):
        Jw = src.Jw
        nfam = Jw.shape[1] if Jw.dim() == 5 else -1
        if (Jw.dim() != 5 or Jw.shape[0] != B or nfam not in (7, 14)
                or Jw.shape[2:4] != (3, 3) or Jw.shape[4] < nk):
            raise ValueError(f"rhs_tail: Jw must be [{B}, 7 or 14, 3, 3, "
                             f">= {nk}], got {tuple(Jw.shape)}")
        if evolve_q and nfam != 14:
            raise ValueError("rhs_tail: evolving Q needs the 14 families "
                             "of J with RSD")
        shapes.append(("PZw", src.PZw, (B, 7, 3, 3, nk)))
    elif isinstance(src, OneLoopSrc):
        nn = src.g_lna.shape[-1]
        if nn < 4:
            raise ValueError(f"rhs_tail: the growth table needs at least 4 "
                             f"nodes, got {nn}")
        shapes += [("A_u", src.A_u, (B, NUI, nk)),
                   ("R", src.R, (B, 3, 8, nk)), ("g_lna", src.g_lna, (B, nn)),
                   ("g_G", src.g_G, (B, nn, nk)),
                   ("g_dDda", src.g_dDda, (B, nn, nk)),
                   ("g_Dnorm", src.g_Dnorm, (B, nk)),
                   ("D_z1l", src.D_z1l, (B, nk))]
        scalars.append(("z_in", src.z_in))
    elif src is not None:
        raise TypeError(f"rhs_tail: src must be FullSrc, OneLoopSrc or None, "
                        f"got {type(src).__name__}")
    for name, x, shape in shapes:
        if tuple(x.shape) != shape:
            raise ValueError(f"rhs_tail: {name} must be {list(shape)}, got "
                             f"{list(x.shape)}")
    for name, v in scalars:
        if isinstance(v, torch.Tensor) or not isinstance(v, (int, float)):
            raise TypeError(f"rhs_tail: {name} must be a Python float, got "
                            f"{type(v).__name__}")
    for name, x in [("y", y)] + [(n, x) for n, x, _ in shapes] + (
            [("Jw", src.Jw)] if isinstance(src, FullSrc) else []):
        if x.dtype != F64:
            raise TypeError(f"rhs_tail: {name} must be float64, got "
                            f"{x.dtype}")
        if x.device != y.device:
            raise ValueError("rhs_tail: inputs on different devices")


def rhs_tail(y, eta, k, om: OmegaIn, src, evolve_q: bool) -> torch.Tensor:
    """dy [B, 41, nk]: the hand kernel for CUDA tensors, the plain version
    for CPU tensors.  om: the Omega tables (OmegaIn); src: FullSrc (full
    Time-RG), OneLoopSrc (1-loop) or None (linear)."""
    _check(y, eta, k, om, src, evolve_q)
    if True:  # the reference: the plain version on every device
        return rhs_tail_plain(y, eta, k, om, src, evolve_q)
    if y.device.type != "cuda":
        raise RuntimeError(f"rhs_tail: no kernel for device {y.device}")
    B, _, nk = y.shape
    if B > MAX_LANES:
        raise ValueError(f"rhs_tail: at most {MAX_LANES} lanes a launch, "
                         f"got {B}")
    if launch_plan(variant(mode_of(src), evolve_q), nk, B)["tasks"] \
            >= 2 ** 31:
        raise ValueError(f"rhs_tail: {B} lanes of {nk} points are more "
                         "tasks than a launch numbers")
    ins = [y, eta, k, *_om_tensors(om), *_src_tensors(src)]
    if not all(x.is_contiguous() for x in ins):
        raise ValueError("rhs_tail: the kernel takes contiguous tensors")
    out = torch.empty_like(y)
    if B == 0 or nk == 0:
        return out
    launch(build.lib(), out, y, eta, k, om, src, evolve_q)
    counts.LAUNCHES["rhs_tail"] += 1
    return out


def mode_of(src) -> str:
    return ("linear" if src is None else
            "full" if isinstance(src, FullSrc) else "oneloop")


# rt_rhs_tail's pointer table: y, eta, k, the Omega tables (OmegaIn's
# tensors, consts in bg.OmegaConsts' order), SRC_SLOTS source tensors
# (FullSrc's or OneLoopSrc's, null-padded), dy
SRC_SLOTS = 7
N_POINTERS = 3 + 4 + len(bg.OmegaConsts._fields) + SRC_SLOTS + 1


def launch(lib, out, y, eta, k, om: OmegaIn, src, evolve_q: bool) -> None:
    """One launch of `lib`'s rt_rhs_tail into `out` on the current stream
    (the wrapper's, after its checks; scripts/time_rhs_tail.py also calls
    it on builds with a part of the kernel taken out).  Counts nothing.
    The pointers go in a host array the C side reads at the call: nothing
    is copied to the card."""
    B, _, nk = y.shape
    var = variant(mode_of(src), evolve_q)
    plan = launch_plan(var, nk, B)
    srcs = [x.data_ptr() for x in _src_tensors(src)]
    ptrs = ([y.data_ptr(), eta.data_ptr(), k.data_ptr()]
            + [x.data_ptr() for x in _om_tensors(om)]
            + srcs + [None] * (SRC_SLOTS - len(srcs)) + [out.data_ptr()])
    table = (ctypes.c_void_p * N_POINTERS)(*ptrs)
    nfam, pitch = (src.Jw.shape[1], src.Jw.shape[4]) \
        if isinstance(src, FullSrc) else (0, 0)
    nn = src.g_lna.shape[1] if isinstance(src, OneLoopSrc) else 0
    zc = 1.0 + src.z_in if isinstance(src, OneLoopSrc) else 0.0
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.rt_rhs_tail(
            table, N_POINTERS, float(om.a_in), zc, B, nk,
            om.beta_a.shape[1], nn, VARIANTS.index(var), nfam, pitch,
            plan["blocks"], plan["threads"], stream)
    build.check(status, "rhs_tail")
