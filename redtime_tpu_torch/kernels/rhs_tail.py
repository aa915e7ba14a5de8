"""K8 rhs_tail: the Time-RG right-hand side after the mode-coupling engine
(csrc/rhs_tail.cu).

Per lane b and k point, from the state y [B, 41, nk] at eta [B]:
  dlnP (rows 0-2)   d ln P_ab / d eta from Omega(a, k), the I coupling and
                    the three clamps (reference :1449-1491);
  dI   (rows 3-16)  2 e^eta A_u - CI . (Of x I14)     (reference :1500-1513);
  dQ   (rows 17-40) 2 e^eta R - CQ . (Of x Q24) when Q evolves, else 0
                    (reference :1516-1539).
A_u and R come, in full Time-RG, from the engine's transforms through the
A/R half of the assembly (assembly.assemble_ar; the kernel applies it as
the coefficient table assembly.ar_table), and in 1-loop mode from the
z1l cache rescaled by growth factors (trg.oneloop_rescale).  In linear
mode only dlnP is nonzero.

Replaces the JAX package's jitted RHS, which XLA fused on the TPU (no
Pallas kernel): redtime_tpu/trg.py:178-254 (make_rhs's rhs), :84-98
(omega_matrix), :136-159 (oneloop_rescale) and the A/R part of
redtime_tpu/assembly.py:172-524.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from redtime_tpu_torch import assembly
from redtime_tpu_torch.kernels import build, counts

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

MODES = {"linear": 0, "full": 1, "oneloop": 2}
MAX_LANES = 65535          # lanes a launch: the grid's y extent


class OmegaIn(NamedTuple):
    """What Omega(a, k) is built from (trg.omega_inputs): its rows are
    (1, -1) and (o10(k), o11), o10 = -1.5 Omega_m (f_cb + beta) / den."""

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
    """1-loop mode: the z1l cache's rows and the growth at eta's z."""

    A_u: torch.Tensor    # [B, 14, nk] the cache's A64[:, JU]
    R: torch.Tensor      # [B, 3, 8, nk]
    D: torch.Tensor      # [B, nk] model.growth_D_f at z
    dDda: torch.Tensor   # [B, nk]
    D_z1l: torch.Tensor  # [B, nk]
    z: torch.Tensor      # [B]


def omega_from(om: OmegaIn) -> torch.Tensor:
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


def _rescale(src: OneLoopSrc, eta: torch.Tensor):
    """trg.oneloop_rescale's A_u and R: the same operations in the same
    order, on the JU rows of A."""
    fz = src.dDda / (src.D * (1.0 + src.z)[:, None])
    dr = src.D / src.D_z1l
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
    engine, with omega_matrix, assemble's A/R and oneloop_rescale, in
    their order.  src: FullSrc, OneLoopSrc, or None (linear mode).
    Returns dy [B, 41, nk]."""
    B, _, nk = y.shape
    O = omega_from(om)                                   # [B, 2, 2, nk]
    e_eta = torch.exp(eta)[:, None]

    lnP = torch.clamp(y[:, 0:3], LNP_MIN, LNP_MAX)
    P = torch.exp(lnP)                                   # P00, P01, P11

    nonlinear = src is not None
    if nonlinear:
        CI, CQ, TR14 = _mats(y.device)[:3]
        I14 = y[:, NUP:NUP + NUI]
        if isinstance(src, OneLoopSrc):
            A_u, R = _rescale(src, eta)
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


def kernel_table():
    """The kernel's Omega and trace terms as (int32 words, f64 weights),
    numpy.

    Words: [0] offset of the trace ranges, [1] of the terms; from 8, three
    words an output o (0-13 dI, 14-37 dQ): its Omega terms [w0, w1) and
    its fz power index (1-loop, into (fz, fz^2, fz^3, fz^4)); the trace
    ranges of Isum's four rows, five words; then a word a term.  Term t
    has weight[t]: an Omega term is (g << 8) | state row, weight Of[g]
    y[row] (CI / CQ of assembly.OMEGA_BILINEAR), a trace term a state row
    (TR14's)."""
    CI, CQ = assembly.OMEGA_BILINEAR
    TR14 = assembly.OMEGA_MATS[2]
    fidx = _BEF_JU + [ABC_IDX[j % 8] for j in range(NUQ)]
    words, weights, out_hdr = [], [], []
    for o in range(NUI + NUQ):
        C, nI, row0, r = ((CI, NUI, NUP, o) if o < NUI
                          else (CQ, NUQ, NUP + NUI, o - NUI))
        w0 = len(words)
        for m in np.flatnonzero(C[r]):
            g, s = divmod(int(m), nI)
            words.append((g << 8) | (row0 + s))
            weights.append(float(C[r, m]))
        out_hdr += [w0, len(words), fidx[o]]
    tr = []
    for r in range(4):
        tr.append(len(words))
        for s in np.flatnonzero(TR14[r]):
            words.append(NUP + int(s))
            weights.append(float(TR14[r, s]))
    tr.append(len(words))
    off_tr = 8 + len(out_hdr)
    head = [off_tr, off_tr + len(tr), 0, 0, 0, 0, 0, 0]
    return (np.asarray(head + out_hdr + tr + words, dtype=np.int32),
            np.asarray(weights, dtype=np.float64))


def _c_double(c: float) -> str:
    return repr(float(c))


def ar_source() -> str:
    """The kernel's A/R code, generated from assembly.ar_program (the
    header rhs_tail_ar.cuh that kernels/build.py writes beside the
    sources): ar_out(o, f, nj, k) is output o (0-13 A_unique, 14-37 R) at
    one k point, f the point's staged features (J and Jn0 at
    f[row * KT], PZ row r at f[(nj + r) * KT]).  Each traced operation is
    one IEEE operation (__d*_rn, no contraction), in the traced order.  A
    division by a constant is x * (1/c), as torch's CUDA kernels divide
    by a scalar (its CPU kernels divide: x / c)."""
    prog = assembly.ar_program()
    ops = prog.ops
    if any(ops[i][0] == "f" and 63 <= ops[i][1] < 126
           for o in prog.outs[:NUI] for i in _deps(ops, o)):
        raise AssertionError("A_unique reads Jn0: the kernel stages Jn0 "
                             "only with RSD")

    def expr(i: int) -> str:
        op, a, b = ops[i]
        if op == "f":
            return (f"f[{a} * KT]" if a < 126
                    else f"f[(nj + {a - 126}) * KT]")
        if op == "k":
            return "k"
        if op in ("add", "sub", "mul", "div"):
            return f"__d{op}_rn(v{a}, v{b})"
        if op == "muls":
            return f"__dmul_rn(v{a}, {_c_double(b)})"
        if op == "divs":
            return f"__dmul_rn(v{a}, {_c_double(1.0 / b)})"
        if op == "recip":
            return f"__drcp_rn(v{a})"
        if op == "neg":
            return f"-v{a}"
        raise ValueError(f"ar_source: unknown operation {op}")

    lines = ["// Generated by redtime_tpu_torch/kernels/rhs_tail.py ar_source "
             "from", "// assembly.ar_rows; do not edit.",
             "__device__ __forceinline__ double ar_out(",
             "    int o, const double* __restrict__ f, int nj, double k) {",
             "  switch (o) {"]
    for o, out in enumerate(prog.outs):
        lines.append(f"    case {o}: {{")
        for i in sorted(_deps(ops, out)):
            lines.append(f"      const double v{i} = {expr(i)};")
        lines += [f"      return v{out};", "    }"]
    lines += ["  }", "  return 0.0;", "}", ""]
    return "\n".join(lines)


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


@functools.lru_cache(maxsize=8)
def _device_table(device: torch.device):
    ints, weights = kernel_table()
    return (torch.as_tensor(ints, device=device),
            torch.as_tensor(weights, device=device))


def _src_tensors(src) -> list:
    return [] if src is None else list(src)


def _check(y, eta, k, om: OmegaIn, src, evolve_q: bool) -> None:
    if y.dim() != 3 or y.shape[1] != NU_STATE:
        raise ValueError(f"rhs_tail: y must be [B, {NU_STATE}, nk], got "
                         f"{tuple(y.shape)}")
    B, _, nk = y.shape
    shapes = [("eta", eta, (B,)), ("k", k, (nk,)),
              ("beta", om.beta, (B, nk))]
    shapes += [(name, x, (B,)) for name, x in
               zip(OmegaIn._fields[1:], om[1:])]
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
        shapes += [("A_u", src.A_u, (B, NUI, nk)),
                   ("R", src.R, (B, 3, 8, nk)), ("D", src.D, (B, nk)),
                   ("dDda", src.dDda, (B, nk)),
                   ("D_z1l", src.D_z1l, (B, nk)), ("z", src.z, (B,))]
    elif src is not None:
        raise TypeError(f"rhs_tail: src must be FullSrc, OneLoopSrc or None, "
                        f"got {type(src).__name__}")
    for name, x, shape in shapes:
        if tuple(x.shape) != shape:
            raise ValueError(f"rhs_tail: {name} must be {list(shape)}, got "
                             f"{list(x.shape)}")
    for name, x in [("y", y)] + [(n, x) for n, x, _ in shapes] + (
            [("Jw", src.Jw)] if isinstance(src, FullSrc) else []):
        if x.dtype != F64:
            raise TypeError(f"rhs_tail: {name} must be float64, got "
                            f"{x.dtype}")
        if x.device != y.device:
            raise ValueError("rhs_tail: inputs on different devices")


def rhs_tail(y, eta, k, om: OmegaIn, src, evolve_q: bool) -> torch.Tensor:
    """dy [B, 41, nk]: the hand kernel for CUDA tensors, the plain version
    for CPU tensors.  src: FullSrc (full Time-RG), OneLoopSrc (1-loop) or
    None (linear)."""
    _check(y, eta, k, om, src, evolve_q)
    if y.device.type == "cpu":
        return rhs_tail_plain(y, eta, k, om, src, evolve_q)
    if y.device.type != "cuda":
        raise RuntimeError(f"rhs_tail: no kernel for device {y.device}")
    B, _, nk = y.shape
    if B > MAX_LANES:
        raise ValueError(f"rhs_tail: at most {MAX_LANES} lanes a launch, "
                         f"got {B}")
    ins = [y, eta, k, *om, *_src_tensors(src)]
    if not all(x.is_contiguous() for x in ins):
        raise ValueError("rhs_tail: the kernel takes contiguous tensors")
    out = torch.empty_like(y)
    if B == 0 or nk == 0:
        return out
    mode = ("linear" if src is None else
            "full" if isinstance(src, FullSrc) else "oneloop")
    ptrs = [x.data_ptr() for x in _src_tensors(src)]
    ptrs += [None] * (6 - len(ptrs))
    nfam, pitch = (src.Jw.shape[1], src.Jw.shape[4]) if mode == "full" \
        else (0, 0)
    ints, weights = _device_table(y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = build.lib().rt_rhs_tail(
            y.data_ptr(), eta.data_ptr(), k.data_ptr(),
            *[x.data_ptr() for x in om], *ptrs, ints.data_ptr(),
            weights.data_ptr(), ints.numel(), weights.numel(),
            out.data_ptr(), B, nk, MODES[mode],
            int(evolve_q), nfam, pitch, stream)
    build.check(status, "rhs_tail")
    counts.LAUNCHES["rhs_tail"] += 1
    return out
