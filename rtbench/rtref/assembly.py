"""Assembly of A_{acd,bef}, R^ell_{abc}, P_{T,jm} and P_{MR,n} from the
FAST-PT transforms.

Transcribes the rational-coefficient linear combinations of the reference's
per-k assembly loop (`src/redTime.cc:813-1279`) into vectorized [nk]
expressions — the JAX package's direct form (redtime_tpu/assembly.py:
172-524), term for term, with leading batch dimensions.  Index convention:
J[n, a, b] == reference J[9 n + 3 a + b]; same for PZ and Jn0.  All inputs
are already windowed onto the solver grid.

Layouts produced:
  * A_unique [14, nk]  — the unique components in JU order
    (JU = {8,9,10,11,12,13,14,15,56,57,59,60,61,63}, reference :157)
  * A64 / I64 scatter  — 64-slot expansion with the A_{acd,bef} = A_{adc,bfe}
    symmetry copies (reference :236-259, :968-978)
  * R [3, 8, nk]       — (ell-1, 4a+2b+c)
  * PT [9, nk], PMR [8, nk]

The static tables (SCATTER64, UNIQ_SEL, OMEGA_MATS, OMEGA_BILINEAR, M_N,
JU) are built by the same numpy code as the JAX package's, so they are
bit-identical.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

# unique slots and mirror copies (reference redTime.cc:151-157, 246-255)
JU = (8, 9, 10, 11, 12, 13, 14, 15, 56, 57, 59, 60, 61, 63)
MIRRORS = ((16, 8), (18, 9), (17, 10), (19, 11), (20, 12), (22, 13),
           (21, 14), (23, 15), (58, 57), (62, 61))

# index component tables of the 14 unique slots (reference :151-156)
AU = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1)
CU = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1)
DU = (1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1)
BU = (0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 1, 1, 1)
EU = (0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 0, 0, 1)
FU = (0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 0, 1, 1)

# P_{T,jm}: m exponent per component (reference :160)
M_N = (2, 1, 0, 2, 1, 0, 1, 0, 0)


def _scatter64() -> np.ndarray:
    S = np.zeros((64, 14))
    for j, slot in enumerate(JU):
        S[slot, j] = 1.0
    for dst, src in MIRRORS:
        S[dst] = S[src]
    return S


SCATTER64 = _scatter64()


def expand64(unique: torch.Tensor) -> torch.Tensor:
    """[..., 14, nk] unique components -> [..., 64, nk] full array with
    symmetry copies (the reference's I64 / A-symmetry block)."""
    S = torch.as_tensor(SCATTER64, dtype=unique.dtype, device=unique.device)
    return S @ unique


def nAI(a, c, d, b, e, f) -> int:
    """Slot index of A/I_{acd,bef} (reference :168-170)."""
    return 32 * a + 16 * c + 8 * d + 4 * b + 2 * e + f


def _uniq_sel() -> np.ndarray:
    """One-hot [14, 64] selector of the JU unique rows."""
    S = np.zeros((14, 64))
    for j, s in enumerate(JU):
        S[j, s] = 1.0
    return S


UNIQ_SEL = _uniq_sel()


def _omega_contraction_mats():
    """Static one-hot matrices expressing the RHS Omega contractions as
    flat [rows, nk] matmuls (reference :1449-1539).

    For each contracted position p and summand g,
        t_p[r] = O[i_p(r), g] * I[sigma_p(r, g)],
    with the row maps folded into one-hot matrices.  Everything is
    restricted to the 14 unique I rows (JU) and composed with the
    symmetry scatter, so the RHS never materializes the 64-slot array.

    Returns (PI [84, 14], QI [84, 4], TR14 [4, 14], PQ [144, 24],
    QQ [144, 4]); the leading axis stacks the 6 (position, g) summands.
    """
    def comp(r):
        return ((r >> 5) & 1, (r >> 4) & 1, (r >> 3) & 1,
                (r >> 2) & 1, (r >> 1) & 1, r & 1)

    jusel = UNIQ_SEL

    pi_blocks, qi_blocks = [], []
    for pos in (3, 4, 5):           # b, e, f of A/I_{acd,bef}
        for g in (0, 1):
            P = np.zeros((64, 64))
            Qo = np.zeros((64, 4))
            for r in range(64):
                idx = list(comp(r))
                i_orig = idx[pos]
                idx[pos] = g
                P[r, nAI(*idx)] = 1.0
                Qo[r, 2 * i_orig + g] = 1.0
            pi_blocks.append(jusel @ P @ SCATTER64)     # [14, 14]
            qi_blocks.append(jusel @ Qo)                # [14, 4]
    PI = np.concatenate(pi_blocks)                      # [84, 14]
    QI = np.concatenate(qi_blocks)                      # [84, 4]

    # I-coupling trace for dP: Isum[p,q] = sum_{c,d} I_{pcd,qcd}
    TR = np.zeros((4, 64))
    for p in range(2):
        for q in range(2):
            for c in range(2):
                for d in range(2):
                    TR[2 * p + q, nAI(p, c, d, q, c, d)] += 1.0
    TR14 = TR @ SCATTER64                               # [4, 14]

    # Q^ell_{abc} contractions over a, b, c; block-diagonal over ell
    pq_blocks, qq_blocks = [], []
    for pos in range(3):
        for g in (0, 1):
            P = np.zeros((8, 8))
            Qo = np.zeros((8, 4))
            for r in range(8):
                idx = [(r >> 2) & 1, (r >> 1) & 1, r & 1]
                i_orig = idx[pos]
                idx[pos] = g
                P[r, 4 * idx[0] + 2 * idx[1] + idx[2]] = 1.0
                Qo[r, 2 * i_orig + g] = 1.0
            pq_blocks.append(np.kron(np.eye(3), P))     # [24, 24]
            qq_blocks.append(np.kron(np.ones((3, 1)), Qo))  # [24, 4]
    PQ = np.concatenate(pq_blocks)                      # [144, 24]
    QQ = np.concatenate(qq_blocks)                      # [144, 4]
    return PI, QI, TR14, PQ, QQ


OMEGA_MATS = _omega_contraction_mats()


def _omega_bilinear_mats():
    """The Omega contractions collapsed to ONE bilinear form per state
    block: t[j] = sum_b (QI@Of)[b,j] (PI@I)[b,j] is bilinear in (Of, I),
    so it equals CI[j] . (Of x I) with CI[j, g*nI+s] =
    sum_b QI_b[j,g] PI_b[j,s] precomputed.  One [nJ, 4*nI] @ [4*nI, nk]
    dot replaces four dots + product + 6-block reduce (the element
    traffic through the emulated-f64 dot path is ~3x lower, and the op
    count in the hot loop drops from ~8 kernels to 3).

    Returns (CI [14, 56], CQ [24, 96])."""
    PI, QI, TR14, PQ, QQ = OMEGA_MATS

    def collapse(Qm, Pm, nJ):
        nB = Qm.shape[0] // nJ
        C = np.zeros((nJ, Qm.shape[1] * Pm.shape[1]))
        for b in range(nB):
            Qb = Qm[b * nJ:(b + 1) * nJ]
            Pb = Pm[b * nJ:(b + 1) * nJ]
            C += np.einsum("jg,js->jgs", Qb, Pb).reshape(nJ, -1)
        return C

    return collapse(QI, PI, 14), collapse(QQ, PQ, 24)


OMEGA_BILINEAR = _omega_bilinear_mats()


def _readers(Jf, PZf, Jn0f):
    """Element readers of the windowed transforms: J(n, idx) is
    Jf[..., n, idx // 3, idx % 3, :], likewise PZ and Jn0."""
    def J(n, idx):
        return Jf[..., n, idx // 3, idx % 3, :]

    def PZ(n, idx):
        return PZf[..., n, idx // 3, idx % 3, :]

    def Jn0(n, idx):
        return Jn0f[..., n, idx // 3, idx % 3, :]

    return J, PZ, Jn0


def assemble_ar(Jf, PZf, Jn0f, k, with_rsd: bool):
    """The A/R half of `assemble`, the part the RHS reads: returns
    (A_unique [..., 14, nk], R [..., 3, 8, nk]); R is zero unless
    with_rsd.  Same arguments as `assemble` (no J_lo: only P_MR reads
    it)."""
    A, R = ar_rows(*_readers(Jf, PZf, Jn0f), k, with_rsd)
    A_unique = torch.stack(A, dim=-2)           # [..., 14, nk]
    if with_rsd:
        Rarr = torch.stack([torch.stack(Rl, dim=-2) for Rl in R],
                           dim=-3)                      # [..., 3, 8, nk]
    else:
        Rarr = Jf.new_zeros(Jf.shape[:-4] + (3, 8) + k.shape)
    return A_unique, Rarr


def ar_rows(J, PZ, Jn0, k, with_rsd: bool):
    """A_unique's 14 rows and, with_rsd, R's rows [ell-1][4a+2b+c] (else
    None), as lists, from the element readers J(n, idx), PZ(n, idx),
    Jn0(n, idx) and k.  Arithmetic operators only, so that ar_program can
    trace it."""
    k2 = k * k
    pre_A = k / (4.0 * np.pi)
    pre_R = 1.0 / (2.0 * np.pi * k)

    # ---------------- A_{acd,bef}, 14 unique slots (reference :820-966)
    A = []

    # slot 8: A_{001,000}
    Jt = (J(4, 1) / 6 + J(2, 1) / 2 + J(0, 1) / 4 + J(1, 1) / 12 +
          J(3, 3) / 6 + J(2, 3) / 4 + J(2, 1) / 4 + J(0, 3) / 3)
    PZt = (-PZ(0, 1) / 12.0 +
           (PZ(4, 3) - PZ(2, 3) + PZ(0, 3) + PZ(1, 3) / 2 - PZ(3, 1) +
            PZ(1, 1) + PZ(0, 1) * 3 - PZ(2, 1) / 2) / 16)
    A.append(pre_A * (Jt + PZt))

    # slot 9: A_{001,001}
    Jt = (J(4, 2) / 6 + J(2, 2) / 2 + J(0, 2) / 4 + J(1, 2) / 12 +
          J(3, 4) / 6 + J(2, 4) / 4 + J(2, 4) / 4 + J(0, 4) / 3)
    A.append(pre_A * Jt)

    # slot 10: A_{001,010}
    Jt = (J(4, 4) / 6 + J(2, 4) / 2 + J(0, 4) / 4 + J(1, 4) / 12 +
          J(3, 6) / 6 + J(2, 6) / 4 + J(2, 2) / 4 + J(0, 6) / 3)
    PZt = (-PZ(0, 4) / 12.0 +
           (PZ(4, 6) - PZ(2, 6) + PZ(0, 6) + PZ(1, 6) / 2 - PZ(3, 4) +
            PZ(1, 4) + PZ(0, 4) * 3 - PZ(2, 4) / 2) / 16)
    A.append(pre_A * (Jt + PZt))

    # slot 11: A_{001,011}
    Jt = (J(4, 5) / 6 + J(2, 5) / 2 + J(0, 5) / 4 + J(1, 5) / 12 +
          J(3, 7) / 6 + J(2, 7) / 4 + J(2, 5) / 4 + J(0, 7) / 3)
    A.append(pre_A * Jt)

    # slot 12: A_{001,100}
    Jt = (J(5, 4) / 5 + J(3, 4) / 2 + J(4, 4) / 6 + 0.55 * J(2, 4) +
          J(2, 4) / 4 + J(0, 4) / 4 + J(1, 4) / 12)
    PZt = (-PZ(0, 2) / 12.0 +
           (PZ(4, 4) - PZ(2, 4) + PZ(0, 4) + PZ(1, 4) / 2 - PZ(3, 2) +
            PZ(1, 2) + PZ(0, 2) * 3 - PZ(2, 2) / 2) / 16)
    A.append(pre_A * (Jt + PZt))

    # slot 13: A_{001,101}
    Jt = (J(5, 5) / 5 + J(3, 5) / 2 + J(4, 5) / 6 + 0.55 * J(2, 5) +
          J(2, 7) / 4 + J(0, 5) / 4 + J(1, 5) / 12)
    A.append(pre_A * Jt)

    # slot 14: A_{001,110}
    Jt = (J(5, 7) / 5 + J(3, 7) / 2 + J(4, 7) / 6 + 0.55 * J(2, 7) +
          J(2, 5) / 4 + J(0, 7) / 4 + J(1, 7) / 12)
    PZt = (-PZ(0, 5) / 12.0 +
           (PZ(4, 7) - PZ(2, 7) + PZ(0, 7) + PZ(1, 7) / 2 - PZ(3, 5) +
            PZ(1, 5) + PZ(0, 5) * 3 - PZ(2, 5) / 2) / 16)
    A.append(pre_A * (Jt + PZt))

    # slot 15: A_{001,111}
    Jt = (J(5, 8) / 5 + J(3, 8) / 2 + J(4, 8) / 6 + 0.55 * J(2, 8) +
          J(2, 8) / 4 + J(0, 8) / 4 + J(1, 8) / 12)
    A.append(pre_A * Jt)

    # slot 56: A_{111,000}
    Jt = (J(5, 1) / 5 + J(3, 1) / 2 + J(4, 1) / 6 + 0.55 * J(2, 1) +
          J(2, 3) / 4 + J(0, 1) / 4 + J(1, 1) / 12) * 2.0
    PZt = (-PZ(4, 1) * 2 + PZ(2, 1) * 2 - PZ(0, 1) * 2 - PZ(1, 1) +
           PZ(6, 3) * 2 - PZ(4, 3) * 4 + PZ(2, 3)) / 16.0
    A.append(pre_A * (Jt + PZt))

    # slot 57: A_{111,001}
    Jt = (J(5, 2) / 5 + J(3, 2) / 2 + J(4, 2) / 6 + 0.55 * J(2, 2) +
          J(2, 6) / 4 + J(0, 2) / 4 + J(1, 2) / 12 +
          J(5, 4) / 5 + J(3, 4) / 2 + J(4, 4) / 6 + 0.55 * J(2, 4) +
          J(2, 4) / 4 + J(0, 4) / 4 + J(1, 4) / 12)
    PZt = (-PZ(4, 4) + PZ(2, 4) - PZ(0, 4) - PZ(1, 4) / 2 +
           PZ(6, 6) - PZ(4, 6) * 2 + PZ(2, 6) / 2) / 16.0
    A.append(pre_A * (Jt + PZt))

    # slot 59: A_{111,011}
    Jt = (J(5, 5) / 5 + J(3, 5) / 2 + J(4, 5) / 6 + 0.55 * J(2, 5) +
          J(2, 7) / 4 + J(0, 5) / 4 + J(1, 5) / 12) * 2.0
    A.append(pre_A * Jt)

    # slot 60: A_{111,100}
    Jt = (J(6, 4) * 8 / 35 + 0.4 * J(5, 4) + 0.4 * J(5, 4) +
          J(3, 4) * 19 / 21 + J(4, 4) / 6 + J(4, 4) / 6 +
          0.6 * J(2, 4) + 0.6 * J(2, 4) + J(0, 4) * 11 / 30 +
          J(1, 4) / 12 + J(1, 4) / 12)
    PZt = (-PZ(4, 2) * 2 + PZ(2, 2) * 2 - PZ(0, 2) * 2 - PZ(1, 2) +
           PZ(6, 4) * 2 - PZ(4, 4) * 4 + PZ(2, 4)) / 16.0
    A.append(pre_A * (Jt + PZt))

    # slot 61: A_{111,101}
    Jt = (J(6, 5) * 8 / 35 + 0.4 * J(5, 5) + 0.4 * J(5, 7) +
          J(3, 5) * 19 / 21 + J(4, 5) / 6 + J(4, 7) / 6 +
          0.6 * J(2, 5) + 0.6 * J(2, 7) + J(0, 5) * 11 / 30 +
          J(1, 5) / 12 + J(1, 7) / 12)
    PZt = (-PZ(4, 5) + PZ(2, 5) - PZ(0, 5) - PZ(1, 5) / 2 +
           PZ(6, 7) - PZ(4, 7) * 2 + PZ(2, 7) / 2) / 16.0
    A.append(pre_A * (Jt + PZt))

    # slot 63: A_{111,111}
    Jt = (J(6, 8) * 8 / 35 + 0.4 * J(5, 8) + 0.4 * J(5, 8) +
          J(3, 8) * 19 / 21 + J(4, 8) / 6 + J(4, 8) / 6 +
          0.6 * J(2, 8) + 0.6 * J(2, 8) + J(0, 8) * 11 / 30 +
          J(1, 8) / 12 + J(1, 8) / 12)
    A.append(pre_A * Jt)

    # ---------------- R^ell_{abc} (reference :980-1161)
    R = None
    if with_rsd:
        R = [[None] * 8 for _ in range(3)]
        for a in range(2):
            for b in range(2):
                for c in range(2):
                    j = 4 * a + 2 * b + c

                    # ell = 1
                    if a == 0:
                        Jt = (0.4 * J(5, 3 * b + c + 1) -
                              1.4 * J(2, 3 * b + c + 1) -
                              J(2, 3 * c + b + 3) -
                              2.0 * J(0, 3 * b + c + 1) +
                              0.4 * J(5, 3 * c + b + 1) +
                              (2.0 / 3.0) * J(3, 3 * b + c + 3) -
                              (2.0 / 3.0) * J(4, 3 * c + b + 1) -
                              2.4 * J(2, 3 * c + b + 1) -
                              (5.0 / 3.0) * J(0, 3 * b + c + 3) -
                              (1.0 / 3.0) * J(1, 3 * c + b + 1))
                    else:
                        Jt = ((16.0 / 35.0) * J(6, 3 * b + c + 4) -
                              0.4 * J(5, 3 * c + b + 4) +
                              0.4 * J(5, 3 * b + c + 4) -
                              (46.0 / 21.0) * J(3, 3 * b + c + 4) -
                              (2.0 / 3.0) * J(4, 3 * b + c + 4) -
                              2.6 * J(2, 3 * c + b + 4) -
                              1.4 * J(2, 3 * b + c + 4) -
                              (19.0 / 15.0) * J(0, 3 * b + c + 4) -
                              (1.0 / 3.0) * J(1, 3 * c + b + 4))
                    r1 = pre_R * Jt

                    if b == 0:
                        PZt = (-(13.0 / 12.0) * PZ(0, 3 * c + a + 1) +
                               (5.0 / 16.0) * PZ(2, 3 * c + a + 1) -
                               (7.0 / 16.0) * PZ(1, 3 * c + a + 1) -
                               0.125 * PZ(4, 3 * c + a + 1) +
                               0.375 * PZ(3, 3 * c + a + 1) -
                               0.375 * PZ(0, 3 * c + a + 3) +
                               (7.0 / 16.0) * PZ(2, 3 * c + a + 3) -
                               (3.0 / 16.0) * PZ(1, 3 * c + a + 3) -
                               0.625 * PZ(4, 3 * c + a + 3) +
                               0.125 * PZ(6, 3 * c + a + 3))
                    else:
                        PZt = -(1.0 / 3.0) * PZ(0, 3 * c + a + 4)
                    r1 = r1 + pre_R * PZt

                    if c == 0:
                        PZt = (0.125 * PZ(6, 3 * b + a + 3) -
                               0.375 * PZ(4, 3 * b + a + 3) +
                               (3.0 / 16.0) * PZ(2, 3 * b + a + 3) -
                               (1.0 / 16.0) * PZ(1, 3 * b + a + 3) -
                               0.125 * PZ(0, 3 * b + a + 3) -
                               0.125 * PZ(4, 3 * b + a + 1) +
                               (3.0 / 16.0) * PZ(2, 3 * b + a + 1) -
                               (3.0 / 16.0) * PZ(1, 3 * b + a + 1) +
                               0.125 * PZ(3, 3 * b + a + 1))
                    else:
                        PZt = (1.0 / 3.0) * PZ(0, 3 * b + a + 4)
                    R[0][j] = r1 + pre_R * PZt

                    # ell = 2
                    if a == 0:
                        Jt = (0.6 * J(5, 3 * b + c + 1) +
                              J(3, 3 * b + c + 1) -
                              0.6 * J(2, 3 * b + c + 1) -
                              J(0, 3 * b + c + 1) +
                              0.6 * J(5, 3 * c + b + 1) +
                              J(3, 3 * b + c + 3) -
                              0.6 * J(2, 3 * c + b + 1) -
                              J(0, 3 * b + c + 3))
                    else:
                        Jt = (24.0 / 35.0 * J(6, 3 * b + c + 4) -
                              1.0 * J(5, 3 * c + b + 4) +
                              2.2 * J(5, 3 * b + c + 4) -
                              (2.0 / 7.0) * J(3, 3 * b + c + 4) -
                              0.6 * J(2, 3 * b + c + 4) -
                              0.6 * J(2, 3 * c + b + 4) -
                              0.4 * J(0, 3 * b + c + 4))
                    r2 = pre_R * Jt

                    if b == 0:
                        PZt = (-(1.0 / 2.0) * PZ(0, 3 * c + a + 1) +
                               (9.0 / 32.0) * PZ(2, 3 * c + a + 1) -
                               (9.0 / 32.0) * PZ(1, 3 * c + a + 1) -
                               (3.0 / 16.0) * PZ(4, 3 * c + a + 1) +
                               (3.0 / 16.0) * PZ(3, 3 * c + a + 1) -
                               (3.0 / 16.0) * PZ(0, 3 * c + a + 3) -
                               (3.0 / 32.0) * PZ(1, 3 * c + a + 3) +
                               (9.0 / 32.0) * PZ(2, 3 * c + a + 3) -
                               (9.0 / 16.0) * PZ(4, 3 * c + a + 3) +
                               (3.0 / 16.0) * PZ(6, 3 * c + a + 3))
                        r2 = r2 + pre_R * PZt
                    if c == 0:
                        PZt = ((3.0 / 16.0) * PZ(6, 3 * b + a + 3) -
                               (9.0 / 16.0) * PZ(4, 3 * b + a + 3) +
                               (9.0 / 32.0) * PZ(2, 3 * b + a + 3) -
                               (3.0 / 32.0) * PZ(1, 3 * b + a + 3) -
                               (3.0 / 16.0) * PZ(0, 3 * b + a + 3) +
                               (3.0 / 16.0) * PZ(3, 3 * b + a + 1) -
                               (3.0 / 16.0) * PZ(4, 3 * b + a + 1) -
                               (9.0 / 32.0) * PZ(1, 3 * b + a + 1) +
                               (9.0 / 32.0) * PZ(2, 3 * b + a + 1) -
                               (1.0 / 2.0) * PZ(0, 3 * b + a + 1))
                        r2 = r2 + pre_R * PZt
                    R[1][j] = r2

                    # ell = 3
                    if a == 0:
                        Jt = (((4.0 / 7.0) * Jn0(2, 3 * c + b + 3) -
                               (40.0 / 21.0) * Jn0(1, 3 * c + b + 3) +
                               (4.0 / 3.0) * Jn0(0, 3 * c + b + 3) -
                               (4.0 / 7.0) * Jn0(2, 3 * b + c + 3) +
                               (40.0 / 21.0) * Jn0(1, 3 * b + c + 3) -
                               (4.0 / 3.0) * Jn0(0, 3 * b + c + 3)) / k2 -
                              J(5, 3 * b + c + 1) +
                              J(2, 3 * b + c + 1) -
                              (5.0 / 3.0) * J(3, 3 * b + c + 3) +
                              (5.0 / 3.0) * J(0, 3 * b + c + 3))
                    else:
                        Jt = (-(4.0 / 7.0) * J(6, 3 * b + c + 4) -
                              J(5, 3 * b + c + 4) +
                              (5.0 / 21.0) * J(3, 3 * b + c + 4) +
                              J(2, 3 * b + c + 4) +
                              (1.0 / 3.0) * J(0, 3 * b + c + 4))
                    r3 = pre_R * Jt

                    if b == 0:
                        PZt = ((35.0 / 32.0) * PZ(0, 3 * c + a + 1) +
                               (5.0 / 32.0) * PZ(5, 3 * c + a + 1) -
                               (5.0 / 8.0) * PZ(3, 3 * c + a + 1) +
                               (5.0 / 32.0) * PZ(4, 3 * c + a + 1) -
                               (5.0 / 16.0) * PZ(2, 3 * c + a + 1) +
                               (15.0 / 32.0) * PZ(1, 3 * c + a + 1) +
                               (55.0 / 96.0) * PZ(0, 3 * c + a + 3) -
                               (5.0 / 32.0) * PZ(6, 3 * c + a + 3) +
                               (5.0 / 8.0) * PZ(4, 3 * c + a + 3) -
                               (5.0 / 32.0) * PZ(3, 3 * c + a + 3) -
                               (15.0 / 32.0) * PZ(2, 3 * c + a + 3) +
                               (5.0 / 16.0) * PZ(1, 3 * c + a + 3))
                    else:
                        PZt = (1.0 / 3.0) * PZ(0, 3 * c + a + 4)
                    r3 = r3 + pre_R * PZt

                    if c == 0:
                        PZt = 1.25 * (
                            -0.125 * PZ(6, 3 * b + a + 3) +
                            0.25 * PZ(4, 3 * b + a + 3) -
                            (5.0 / 24.0) * PZ(0, 3 * b + a + 3) -
                            0.125 * PZ(1, 3 * b + a + 3) +
                            0.125 * PZ(3, 3 * b + a + 3) -
                            0.125 * PZ(5, 3 * b + a + 1) +
                            0.25 * PZ(3, 3 * b + a + 1) -
                            (5.0 / 24.0) * PZ(0, 3 * b + a + 1) -
                            0.125 * PZ(2, 3 * b + a + 1) +
                            0.125 * PZ(4, 3 * b + a + 1))
                    else:
                        PZt = -(1.0 / 3.0) * PZ(0, 3 * b + a + 4)
                    R[2][j] = r3 + pre_R * PZt
    return A, R


def assemble(Jf, PZf, Jn0f, J_lo, k, with_rsd: bool):
    """Assemble A/R/PT/PMR on the solver grid.

    Jf, PZf, Jn0f: [..., 7, 3, 3, nk] transforms windowed to the solver
    grid (leading batch dimensions allowed).
    J_lo: [...] — J[0, 0, 0] at the low-k index nloMR (reference :1252).
    k: [nk] solver grid.

    Returns (A_unique [..., 14, nk], R [..., 3, 8, nk], PT [..., 9, nk],
    PMR [..., 8, nk]).
    """
    A_unique, Rarr = assemble_ar(Jf, PZf, Jn0f, k, with_rsd)
    lead = Jf.shape[:-4]
    PT, PMR = pt_pmr_rows(*_readers(Jf, PZf, Jn0f), J_lo[..., None], k,
                          with_rsd)
    PTarr = (torch.stack(PT, dim=-2) if with_rsd
             else Jf.new_zeros(lead + (9,) + k.shape))
    PMRarr = torch.stack(PMR, dim=-2)
    return A_unique, Rarr, PTarr, PMRarr


def pt_pmr_rows(J, PZ, Jn0, J_lo, k, with_rsd: bool):
    """The P_T / P_MR half of `assemble`: P_T's 9 rows (with_rsd, else
    None) and P_MR's 8, as lists, from the element readers J(n, idx),
    PZ(n, idx), Jn0(n, idx), J_lo (J[0, 0, 0] at the low-k point,
    broadcastable against a row) and k.  Arithmetic operators only, so
    that pt_pmr_program can trace it (K11 out_block's code)."""
    k2 = k * k
    PT = None

    # ---------------- P_{T,jm} (reference :1168-1243)
    if with_rsd:
        k4 = k2 * k2
        PT = [None] * 9
        PT[0] = (1.0 / 3.0) * J(3, 4) - (1.0 / 3.0) * J(0, 4)
        PT[1] = 2.0 * ((-3.0 / 35.0) * Jn0(2, 7) +
                       (2.0 / 7.0) * Jn0(1, 7) -
                       0.2 * Jn0(0, 7)) / k2
        PT[2] = ((5.0 / 231.0) * Jn0(6, 8) - (9.0 / 77.0) * Jn0(5, 8) +
                 (5.0 / 21.0) * Jn0(4, 8) - (1.0 / 7.0) * Jn0(3, 8)) / k4
        PT[3] = ((1.0 / 3.0) * J(3, 4) + 2.0 * J(2, 4) +
                 (5.0 / 3.0) * J(0, 4))
        PT[4] = (-(6.0 / 5.0) * J(5, 5) + 2.0 * J(3, 7) +
                 (6.0 / 5.0) * J(2, 5) - 2.0 * J(0, 7) +
                 ((12.0 / 7.0) * Jn0(2, 7) - (40.0 / 7.0) * Jn0(1, 7) +
                  4.0 * Jn0(0, 7)) / k2)
        PT[5] = ((-(5.0 / 11.0) * Jn0(6, 8) + (27.0 / 11.0) * Jn0(5, 8) -
                  5.0 * Jn0(4, 8) + 3.0 * Jn0(3, 8)) / k4 +
                 (-(9.0 / 7.0) * Jn0(2, 8) + (30.0 / 7.0) * Jn0(1, 8) -
                  3.0 * Jn0(0, 8)) / k2 +
                 (27.0 / 70.0) * J(6, 8) - (9.0 / 7.0) * J(3, 8) +
                 (9.0 / 10.0) * J(0, 8))
        PT[6] = ((-2.0 * Jn0(2, 7) + (20.0 / 3.0) * Jn0(1, 7) -
                  (14.0 / 3.0) * Jn0(0, 7)) / k2 +
                 2.0 * J(5, 5) - (2.0 / 3.0) * J(3, 7) +
                 2.0 * J(2, 7) + (14.0 / 3.0) * J(0, 7))
        PT[7] = (((15.0 / 11.0) * Jn0(6, 8) - (81.0 / 11.0) * Jn0(5, 8) +
                  15.0 * Jn0(4, 8) - 9.0 * Jn0(3, 8)) / k4 +
                 (6.0 * Jn0(2, 8) - 20.0 * Jn0(1, 8) +
                  14.0 * Jn0(0, 8)) / k2 -
                 (39.0 / 35.0) * J(6, 8) - (6.0 / 5.0) * J(5, 8) +
                 (47.0 / 7.0) * J(3, 8) + (6.0 / 5.0) * J(2, 8) -
                 (28.0 / 5.0) * J(0, 8))
        PT[8] = ((-1.0 * Jn0(6, 8) + (27.0 / 5.0) * Jn0(5, 8) -
                  11.0 * Jn0(4, 8) + (33.0 / 5.0) * Jn0(3, 8)) / k4 +
                 (-(27.0 / 5.0) * Jn0(2, 8) + 18.0 * Jn0(1, 8) -
                  (63.0 / 5.0) * Jn0(0, 8)) / k2 +
                 (59.0 / 70.0) * J(6, 8) + 2.0 * J(5, 8) -
                 (36.0 / 7.0) * J(3, 8) + (63.0 / 10.0) * J(0, 8))

    # ---------------- P_{MR,n} McDonald-Roy bias integrals
    # (reference :1245-1278; low-k subtraction J_lo at nloMR)
    PMR = [None] * 8
    PMR[0] = ((4.0 / 21.0) * J(3, 0) + J(2, 0) + (17.0 / 21.0) * J(0, 0))
    PMR[1] = ((8.0 / 21.0) * J(3, 0) + J(2, 0) + (13.0 / 21.0) * J(0, 0))
    PMR[2] = ((16.0 / 245.0) * J(6, 0) + (2.0 / 5.0) * J(5, 0) +
              (254.0 / 441.0) * J(3, 0) + (4.0 / 15.0) * J(2, 0) +
              (8.0 / 315.0) * J(0, 0))
    PMR[3] = ((32.0 / 245.0) * J(6, 0) + (2.0 / 5.0) * J(5, 0) +
              (214.0 / 441.0) * J(3, 0) + (4.0 / 15.0) * J(2, 0) +
              (16.0 / 315.0) * J(0, 0))
    PMR[4] = 0.5 * J(0, 0) - 0.5 * J_lo
    PMR[5] = (J(3, 0) - J_lo) / 3.0
    PMR[6] = ((4.0 / 35.0) * J(6, 0) + (4.0 / 63.0) * J(3, 0) +
              (2.0 / 45.0) * J(0, 0) - (2.0 / 9.0) * J_lo)
    PMR[7] = 0.5 * ((-15.0 / 128.0) * PZ(6, 0) + (15.0 / 32.0) * PZ(4, 0) -
                    (15.0 / 128.0) * PZ(3, 0) - (45.0 / 128.0) * PZ(2, 0) +
                    (15.0 / 64.0) * PZ(1, 0) + (55.0 / 128.0) * PZ(0, 0))

    return PT, PMR


# ---------------------------------------------------------------------------
# The A/R half as a straight-line program (K8 rhs_tail's assembly)
#
# K8 runs `ar_rows` on the card as straight-line code generated from
# `ar_rows` itself (kernels/rhs_tail.py ar_source): ar_program traces it
# with values that record each arithmetic operation, so the kernel does
# the plain version's operations in its order, and the two cannot drift
# apart.  The order matters: A and R are small differences of terms up to
# ~1e4 times larger, so merged coefficients or another order of the sums
# move a row by ~1e-12 of its scale (a coefficient table read off
# `assemble` by probing, the JAX package's asm_consts route,
# redtime_tpu/assembly.py:526-648, gave 6.5e-12 on evolved nk=128 states).

AR_NFEAT = 3 * 63    # features: J (0-62), Jn0 (63-125), PZ (126-188)
AR_NOUT = 14 + 24    # A_unique's rows, then R's ((ell-1) 8 + 4a+2b+c)


class ARProgram(NamedTuple):
    """`ar_rows` as operations in order: ops[i] = (op, a, b) is value i,
        ("f", feat, None)          feature feat (9 n + idx in its block)
        ("k", None, None)          k
        ("add" | "sub" | "mul" | "div", i, j)   value i op value j
        ("muls" | "divs", i, c)    value i times / over the constant c
        ("recip", i, None)         1 / value i (torch's c / x is
                                   reciprocal(x) * c)
        ("neg", i, None)           -value i
    and outs, the values of A_unique's 14 rows, then R's 24."""

    ops: tuple
    outs: tuple


class _Traced:
    """A value of the traced program; its operators append operations."""

    __slots__ = ("node", "i")

    def __init__(self, node, i: int):
        self.node, self.i = node, i

    def _bin(self, op: str, other):
        if isinstance(other, _Traced):
            return self.node(op, self.i, other.i)
        if op in ("mul", "div") and isinstance(other, (int, float)):
            return self.node(op + "s", self.i, float(other))
        raise TypeError(f"ar_program: no traced form of {op} with "
                        f"{type(other).__name__}")

    def __add__(self, other):
        return self._bin("add", other)

    def __sub__(self, other):
        return self._bin("sub", other)

    def __mul__(self, other):
        return self._bin("mul", other)

    def __rmul__(self, other):
        return self._bin("mul", other)

    def __truediv__(self, other):
        return self._bin("div", other)

    def __rtruediv__(self, other):
        return self.node("recip", self.i, None)._bin("mul", other)

    def __neg__(self):
        return self.node("neg", self.i, None)


class Recorder:
    """The operations of a traced program, in order: node(op, a, b)
    appends one and returns its value; leaf(key) appends ("f", key, None)
    the first time key is read."""

    def __init__(self):
        self.ops, self._leaves = [], {}

    def node(self, op, a=None, b=None) -> _Traced:
        self.ops.append((op, a, b))
        return _Traced(self.node, len(self.ops) - 1)

    def leaf(self, key) -> _Traced:
        if key not in self._leaves:
            self._leaves[key] = self.node("f", key)
        return self._leaves[key]

    def reader(self, base: int):
        """A feature reader (n, idx) -> leaf base + 9 n + idx."""
        return lambda n, idx: self.leaf(base + 9 * n + idx)


@functools.lru_cache(maxsize=1)
def ar_program() -> ARProgram:
    """`ar_rows` (with RSD) traced once into an ARProgram."""
    rec = Recorder()
    A, R = ar_rows(rec.reader(0), rec.reader(126), rec.reader(63),
                   rec.node("k"), True)
    outs = [v.i for v in A] + [v.i for Rl in R for v in Rl]
    return ARProgram(tuple(rec.ops), tuple(outs))


# J_lo, the feature after the transforms' rows in pt_pmr_program
PT_JLO = AR_NFEAT


@functools.lru_cache(maxsize=1)
def pt_pmr_program() -> ARProgram:
    """`pt_pmr_rows` (with RSD) traced once into an ARProgram: features
    as in ar_program, J_lo the feature PT_JLO; outs P_T's 9 rows, then
    P_MR's 8."""
    rec = Recorder()
    jlo = rec.leaf(PT_JLO)
    PT, PMR = pt_pmr_rows(rec.reader(0), rec.reader(126), rec.reader(63),
                          jlo, rec.node("k"), True)
    return ARProgram(tuple(rec.ops), tuple(v.i for v in PT + PMR))

