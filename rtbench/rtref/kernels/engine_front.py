"""K9 engine_front: the engine's front, ln P -> (P_ext, ci)
(csrc/engine_front.cu).

    x[b,a,m]     = sum_j lnP[b,a,j] pab_M[m,j] + (n_s[b] - 3) pab_v[m]
    P_ext[b,a,m] = exp(clip(x, -80, 20)) wp[m]
    ci[b,a,c]    = sum_m (P_ext[b,a,m] kbias[m]) dft_fwd_half[m,c]

dft_fwd_half [np, 2 half] = [fc wc | -fs wc] is the forward real DFT of
length np on the first half = np / 2 frequencies, times the window wc.
The plain version multiplies by pab_M and dft_fwd_half; the kernel reads
neither: it extends from pab_M's band (j0, w) (grids.pab_band: at most 4
non-zeros a row) and runs the forward leg as an FFT in shared memory,
from the window wc [half] and the twiddle table tw [2np, 2]
(fourier.twiddles).

lnP [B, 3, nk] (rows ln P_00, P_01, P_11), first clipped to [LNP_MIN,
LNP_MAX] when `clip` (the RHS's clip of its state).  P_ext [B, 3, np] feeds
K2 pz_leg, ci [B, 3, 2 half] = [re | im] K10 tab_leg.  lnP may be a view
with any lane and row strides (the RHS hands it the state's first three
rows; the 1-loop cache an expanded row, row stride 0).  Replaces
redtime_tpu/fastpt.py extend_power (:908-931), the forward leg of
compute_J_PZ_windowed (:1193) and the RHS's clip (redtime_tpu/trg.py:185).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from rtbench.rtref import fourier
from rtbench.rtref.kernels import build, counts
from rtbench.rtref.kernels.rhs_tail import LNP_MAX, LNP_MIN

F64 = torch.float64

# the clip of the extended log spectrum (redtime_tpu/fastpt.py:930)
EXT_MIN, EXT_MAX = -80.0, 20.0
# the kernel's launch (csrc/engine_front.cu): one block of THREADS threads
# a row of ln P
THREADS = 256
SMEM_MAX = 232448


def forward_plain(P_ext: torch.Tensor, kbias: torch.Tensor,
                  fwd: torch.Tensor) -> torch.Tensor:
    """ci = (P_ext kbias) @ dft_fwd_half, the forward leg."""
    return (P_ext * kbias) @ fwd


def engine_front_plain(lnP, n_s, pab_M, pab_v, wp, kbias, fwd,
                       clip: bool = False):
    """The plain PyTorch version: (P_ext, ci)."""
    if clip:
        lnP = torch.clamp(lnP, LNP_MIN, LNP_MAX)
    x = lnP @ pab_M.T + (n_s[:, None, None] - 3.0) * pab_v
    P_ext = torch.exp(torch.clamp(x, EXT_MIN, EXT_MAX)) * wp
    return P_ext, forward_plain(P_ext, kbias, fwd)


def error_bound(lnP, n_s, pab_M, pab_v, wp, kbias, fwd,
                clip: bool = False):
    """(P_ext, ci, dP, dci): the plain version's outputs and elementwise
    bounds on |kernel - plain|.

    P_ext: the kernel sums the band's 4 products of each row of pab_M
    where the plain version's product sums all nk (the others are exact
    zeros); every other operation is the plain version's.  Each is within
    nk eps (|lnP| @ |pab_M|^T) of the exact sum, the bias add and the clip
    (1-Lipschitz) move x by at most 2 eps |x| more: dx = 2 (nk + 2) eps
    (|lnP| @ |pab_M|^T + |bias|).  Carried through exp and the window
    (each rounding within 2 eps), dP = 2 |P| (expm1(dx) + 8 eps).

    ci, against the exact transform T of the plain version's Q = P_ext
    kbias: the plain version's np-term dot products are within 2 (np + 1)
    eps (|Q| @ |F|), and its matrix's entries, from the unreduced angle
    theta = 2 pi m c / np, within dF = wc_c eps (3 theta + 2) (wc =
    dft_fwd_half's row 0); the kernel's FFT (twiddles from reduced angles)
    is within 16 eps l wc_c sum_m |Q_m| of T of its own Q (l =
    fft_levels(np / 2) + 3: the plan's stages and the real split), which
    is within (dP |kbias|) @ |F| of T(Q).  dci = 2 (sum of the four)."""
    eps = torch.finfo(F64).eps
    if clip:
        lnP = torch.clamp(lnP, LNP_MIN, LNP_MAX)
    P, ci = engine_front_plain(lnP, n_s, pab_M, pab_v, wp, kbias, fwd)
    nk, npts = lnP.shape[-1], pab_M.shape[0]
    bias = ((n_s[:, None, None] - 3.0) * pab_v).abs()
    dx = 2 * (nk + 2) * eps * (lnP.abs() @ pab_M.abs().T + bias)
    dP = 2 * P.abs() * (torch.expm1(dx) + 8 * eps)
    half = fwd.shape[1] // 2
    wc = fwd[0, :half].abs()
    m = torch.arange(npts, dtype=F64, device=fwd.device)
    c = torch.arange(half, dtype=F64, device=fwd.device)
    theta = 2 * np.pi * m[:, None] * c[None, :] / npts
    dF = (wc * eps * (3 * theta + 2)).repeat(1, 2)
    F, Q = fwd.abs(), (P * kbias).abs()
    levels = fourier.fft_levels(npts // 2) + 3
    dci = 2 * ((dP * kbias.abs()) @ F + 2 * (npts + 1) * eps * (Q @ F)
               + Q @ dF + 16 * eps * levels
               * Q.sum(-1, keepdim=True) * wc.repeat(2))
    return P, ci, dP, dci


def smem_bytes(nk: int, npts: int) -> int:
    """Shared memory of a block: the FFT's two buffers of np / 2 complex
    values (padded: fft_smem.cuh's padded), its two twiddle tables of np /
    2 entries and the ln P row."""
    half = npts // 2
    return 16 * (2 * (half + half // 8 + 1) + 2 * half) + 8 * nk


def _check(lnP, n_s, pab_M, pab_v, wp, kbias, fwd, j0, w, wc, tw,
           n_rep: int = 1) -> None:
    if lnP.dim() != 3 or lnP.shape[1] != 3:
        raise ValueError(f"engine_front: lnP must be [B, 3, nk], got "
                         f"{tuple(lnP.shape)}")
    B, _, nk = lnP.shape
    if pab_M.dim() != 2 or pab_M.shape[1] != nk:
        raise ValueError(f"engine_front: pab_M must be [np, {nk}], got "
                         f"{tuple(pab_M.shape)}")
    npts = pab_M.shape[0]
    if fwd.dim() != 2 or fwd.shape[0] != npts:
        raise ValueError(f"engine_front: dft_fwd_half must be [{npts}, "
                         f"2 half], got {tuple(fwd.shape)}")
    if n_rep < 1 or B % n_rep or n_s.shape != (B // n_rep,):
        raise ValueError(f"engine_front: n_s must be [B / n_rep] = "
                         f"[{B} / {n_rep}], got {tuple(n_s.shape)}")
    for name, x, shape in (("pab_v", pab_v, (npts,)), ("wp", wp, (npts,)),
                           ("kbias", kbias, (npts,)), ("j0", j0, (npts,)),
                           ("w", w, (npts, 4)),
                           ("wc", wc, (fwd.shape[1] // 2,)),
                           ("tw", tw, (2 * npts, 2))):
        if x.shape != shape:
            raise ValueError(f"engine_front: {name} must be "
                             f"{list(shape)}, got {tuple(x.shape)}")
    for name, x in (("lnP", lnP), ("n_s", n_s), ("pab_M", pab_M),
                    ("pab_v", pab_v), ("wp", wp), ("kbias", kbias),
                    ("dft_fwd_half", fwd), ("w", w), ("wc", wc), ("tw", tw),
                    ("j0", j0)):
        want = torch.int32 if name == "j0" else F64
        if x.dtype != want:
            raise TypeError(f"engine_front: {name} must be {want}, got "
                            f"{x.dtype}")
        if x.device != lnP.device:
            raise ValueError("engine_front: inputs on different devices")


def _check_kernel_shape(lnP, pab_M, pab_v, wp, kbias, fwd, j0, w, wc,
                        tw) -> None:
    """What the CUDA kernel takes beyond _check (the plain version takes
    any layout)."""
    B, _, nk = lnP.shape
    npts, nc = fwd.shape
    if lnP.stride(2) != 1 or min(lnP.stride()) < 0:
        raise ValueError(f"engine_front: the kernel needs lnP with unit "
                         f"column stride, got strides {lnP.stride()}")
    if npts % 2 or nc != npts or nk < 4:
        raise ValueError(f"engine_front: the kernel takes an even np, all "
                         f"np / 2 frequencies and nk >= 4, got np={npts}, "
                         f"2 half={nc}, nk={nk}")
    for name, x in (("pab_v", pab_v), ("wp", wp), ("kbias", kbias),
                    ("j0", j0), ("w", w), ("wc", wc), ("tw", tw)):
        if not x.is_contiguous():
            raise ValueError(f"engine_front: {name} must be contiguous")
    if w.data_ptr() % 16 or tw.data_ptr() % 16:
        raise ValueError("engine_front: w and tw must be 16-byte aligned")
    if 3 * B >= 2 ** 31:
        raise ValueError(f"engine_front: too many lanes, got {B}")
    smem = smem_bytes(nk, npts)
    if smem > SMEM_MAX:
        raise ValueError(f"engine_front: nk={nk}, np={npts} need {smem} "
                         f"bytes of shared memory a block (at most "
                         f"{SMEM_MAX})")


def engine_front(lnP, n_s, pab_M, pab_v, wp, kbias, fwd, j0, w, wc, tw,
                 clip: bool = False, n_rep: int = 1):
    """(P_ext [B, 3, np], ci [B, 3, 2 half]): the hand kernel for CUDA
    tensors (which reads pab_M's band j0 [np] (int32), w [np, 4], the
    window wc [half] and the twiddles tw [2np, 2], and of pab_M and
    dft_fwd_half only their shapes), the plain version for CPU tensors.
    n_s [B / n_rep]: lanes b n_rep .. (b + 1) n_rep - 1 take n_s[b] (the
    output block's lanes, a cosmology's n_rep redshifts in a row)."""
    _check(lnP, n_s, pab_M, pab_v, wp, kbias, fwd, j0, w, wc, tw, n_rep)
    if True:  # the reference: the plain version on every device
        if n_rep > 1:
            n_s = n_s.repeat_interleave(n_rep)
        return engine_front_plain(lnP, n_s, pab_M, pab_v, wp, kbias, fwd,
                                  clip)
    if lnP.device.type != "cuda":
        raise RuntimeError(f"engine_front: no kernel for device "
                           f"{lnP.device}")
    _check_kernel_shape(lnP, pab_M, pab_v, wp, kbias, fwd, j0, w, wc, tw)
    B, _, nk = lnP.shape
    npts = fwd.shape[0]
    plan = fourier.fft_plan(npts // 2)
    P_ext = torch.empty((B, 3, npts), dtype=F64,
                        device=lnP.device)
    ci = torch.empty((B, 3, npts), dtype=F64, device=lnP.device)
    radices = (ctypes.c_int * len(plan))(*plan)
    with torch.cuda.device(lnP.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = build.lib().rt_engine_front(
            lnP.data_ptr(), lnP.stride(0), lnP.stride(1), n_s.data_ptr(),
            n_s.stride(0), n_rep, j0.data_ptr(), w.data_ptr(),
            pab_v.data_ptr(), wp.data_ptr(), kbias.data_ptr(), wc.data_ptr(), tw.data_ptr(),
            P_ext.data_ptr(), ci.data_ptr(), B, nk, npts, int(clip),
            smem_bytes(nk, npts), radices, len(plan), stream)
    build.check(status, "engine_front")
    counts.LAUNCHES["engine_front"] += 1
    return P_ext, ci
