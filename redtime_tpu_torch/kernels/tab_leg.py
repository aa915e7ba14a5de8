"""K10 tab_leg: the convolution backward leg with its coefficient windows
(csrc/tab_leg.cu).

    sab[b,s,f,a,:] = [Re | Im](ci[b,a] * g_s[f])     s = 0: ga, s = 1: gb
    tab[b,s,f,a,n] = sum_k sab[b,s,f,a,k] dft_bwd_half[k,n]

ci [B, 3, 2 half] = [re | im] is K9 engine_front's output, g_s the gamma
coefficients ga / gb [NFAM, half] (re and im apart, the first nfam rows
used), dft_bwd_half [2 half, 2np]: the inverse real DFT of length N = 2np
on the first half = N / 4 frequencies; tab [B, 2, nfam, 3, 2np] is K1
out_leg's input.  The plain version multiplies by that matrix; the kernel
runs the transform as an FFT in shared memory, from the twiddle table tw
[2np, 2] (fourier.twiddles), and forms sab's products on the way in, so
neither sab nor the matrix is read on the card.  Replaces
redtime_tpu/fastpt.py:1194-1203 (coeff, sab) and :1227 (sab @
dft_bwd_half).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from redtime_tpu_torch import fourier
from redtime_tpu_torch.kernels import build, counts

# the kernel's launch (csrc/tab_leg.cu): at most MAX_THREADS threads and
# RB_MAX rows a block, at most S_MAX blocks a row, blocks enough for
# BLOCKS_PER_SM on every SM where the rows allow
MAX_THREADS, RB_MAX, S_MAX, BLOCKS_PER_SM = 256, 4, 8, 2
SMEM_MAX = 232448
SMS = 132  # an H100's SMs, for launch_plan without a card


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def sab_plain(ci, ga_re, ga_im, gb_re, gb_im, nfam: int) -> torch.Tensor:
    """sab [B, 2, nfam, 3, 2 half]: the windows' complex products, re and
    im on the last axis."""
    half = ga_re.shape[1]
    ca_re, ca_im = ci[:, None, :, :half], ci[:, None, :, half:]

    def coeff(gr, gi):
        sr, si = _cmul(ca_re, ca_im, gr[:nfam, None], gi[:nfam, None])
        return torch.cat([sr, si], dim=-1)              # [B, nfam, 3, 2half]

    return torch.stack([coeff(ga_re, ga_im), coeff(gb_re, gb_im)], dim=1)


def tab_leg_plain(ci, ga_re, ga_im, gb_re, gb_im, bwd,
                  nfam: int) -> torch.Tensor:
    """The plain PyTorch version: sab, then one matmul."""
    return sab_plain(ci, ga_re, ga_im, gb_re, gb_im, nfam) @ bwd


def _padded(e: int) -> int:
    """fft_smem.cuh's padded(e): the elements a padded buffer takes."""
    return e + e // 8 + 1


def smem_bytes(RB: int, S: int, npts: int) -> int:
    """Shared memory of a block: the FFT's two buffers of RB rows of np /
    S complex values (padded), the second also holding the rows' Z (np
    complex values a row) for the first stage, and the rows' offsets."""
    buf = _padded(RB * (npts // S))
    return 16 * (buf + max(buf, RB * npts)) + 8 * RB


def launch_plan(B: int, nfam: int, npts: int, sms: int = SMS) -> tuple:
    """(RB, S, threads): rows a block, blocks a row and threads a block.
    RB halves from RB_MAX while the blocks would not give every SM
    BLOCKS_PER_SM; then S doubles (to at most S_MAX, keeping np / S even
    and at least 64) until they do; both give way where the block's
    shared memory would pass the SM's.  Threads: one a radix-8 butterfly
    of the block's rows, from 64 to MAX_THREADS."""
    pairs, rows, want = 3 * B, 2 * nfam, BLOCKS_PER_SM * sms
    blocks = lambda rb, s: pairs * -(-rows // rb) * s
    RB, S = RB_MAX, 1
    while RB > 1 and blocks(RB, S) < want:
        RB //= 2
    while (blocks(RB, S) < want and S < S_MAX and npts % (2 * S) == 0
           and npts // (2 * S) >= 64):
        S *= 2
    while smem_bytes(RB, S, npts) > SMEM_MAX:
        if RB > 1:
            RB //= 2
        elif S < S_MAX and npts % (2 * S) == 0:
            S *= 2
        else:
            raise ValueError(f"tab_leg: np={npts} needs "
                             f"{smem_bytes(RB, S, npts)} bytes of shared "
                             f"memory a block (at most {SMEM_MAX})")
    threads = min(MAX_THREADS, max(64, 32 * -(-RB * (npts // S) // 256)))
    return RB, S, threads


def error_bound(ci, ga_re, ga_im, gb_re, gb_im, bwd, nfam: int):
    """(tab, dtab): the plain version's output and the elementwise bound
    on |kernel - plain|.  The kernel forms X = ci g with the plain
    version's roundings (its bits are sab's) and transforms it by an FFT
    whose twiddles come from reduced angles; the plain version multiplies
    sab by dft_bwd_half, whose entries c_k cos / sin(2 pi k n / N) come
    from the unreduced angle and are off by up to dD = c_k eps (3 theta +
    2), theta = 2 pi k n / N.  So, against the exact transform T of sab:
    |plain - T| <= 2K eps (|sab| @ |D|) + |sab| @ dD (K = 2 half: the
    dot products), and |kernel - T| <= 16 eps l sum_k c_k |X_k| (the FFT:
    each of l levels rounds within 8 eps of the magnitudes, which sum to
    at most 2 sum_k c_k |X_k| at every level; l = fft_levels(np) + S_MAX +
    4: the plan's stages, the S-fold split, the pre-twiddle).  Margin 2."""
    eps = torch.finfo(torch.float64).eps
    sab = sab_plain(ci, ga_re, ga_im, gb_re, gb_im, nfam)
    half, N = ga_re.shape[1], bwd.shape[1]
    k = torch.arange(half, dtype=torch.float64, device=ci.device)
    n = torch.arange(N, dtype=torch.float64, device=ci.device)
    c = torch.full_like(k, 2.0)
    c[0] = 1.0
    theta = 2 * np.pi * k[:, None] * n[None, :] / N
    dD = (c[:, None] * eps * (3 * theta + 2)).repeat(2, 1)
    mag = torch.hypot(sab[..., :half], sab[..., half:]) @ c
    levels = fourier.fft_levels(N // 2) + S_MAX + 4
    tab = sab @ bwd
    dtab = 2 * (2 * bwd.shape[0] * eps * (sab.abs() @ bwd.abs())
                + sab.abs() @ dD + 16 * eps * levels * mag[..., None])
    return tab, dtab


def _check(ci, ga_re, ga_im, gb_re, gb_im, bwd, tw, nfam) -> None:
    if ga_re.dim() != 2:
        raise ValueError(f"tab_leg: ga_re must be [NFAM, half], got "
                         f"{tuple(ga_re.shape)}")
    nf, half = ga_re.shape
    if not 1 <= nfam <= nf:
        raise ValueError(f"tab_leg: nfam={nfam} outside 1..{nf}")
    for name, x in (("ga_im", ga_im), ("gb_re", gb_re), ("gb_im", gb_im)):
        if x.shape != (nf, half):
            raise ValueError(f"tab_leg: {name} must be [{nf}, {half}], got "
                             f"{tuple(x.shape)}")
    if ci.dim() != 3 or ci.shape[1:] != (3, 2 * half):
        raise ValueError(f"tab_leg: ci must be [B, 3, {2 * half}], got "
                         f"{tuple(ci.shape)}")
    if bwd.dim() != 2 or bwd.shape[0] != 2 * half:
        raise ValueError(f"tab_leg: dft_bwd_half must be [{2 * half}, 2np], "
                         f"got {tuple(bwd.shape)}")
    if tw.shape != (bwd.shape[1], 2):
        raise ValueError(f"tab_leg: tw must be [{bwd.shape[1]}, 2], got "
                         f"{tuple(tw.shape)}")
    for name, x in (("ci", ci), ("ga_re", ga_re), ("ga_im", ga_im),
                    ("gb_re", gb_re), ("gb_im", gb_im),
                    ("dft_bwd_half", bwd), ("tw", tw)):
        if x.dtype != torch.float64:
            raise TypeError(f"tab_leg: {name} must be float64, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"tab_leg: {name} must be contiguous")
        if x.device != ci.device:
            raise ValueError("tab_leg: inputs on different devices")


def _check_kernel_shape(ci, bwd, tw) -> None:
    """What the CUDA kernel takes beyond _check: the inverse transform of
    length 2np = 4 half (the FFT's C2R form), a 16-byte aligned table."""
    half, N = ci.shape[2] // 2, bwd.shape[1]
    if N != 4 * half:
        raise ValueError(f"tab_leg: the kernel takes 2np = 4 half, got "
                         f"2np={N}, half={half}")
    if tw.data_ptr() % 16:
        raise ValueError("tab_leg: tw must be 16-byte aligned")


def tab_leg(ci, ga_re, ga_im, gb_re, gb_im, bwd, tw,
            nfam: int) -> torch.Tensor:
    """tab [B, 2, nfam, 3, 2np]: the hand kernel for CUDA tensors (which
    reads tw, and of dft_bwd_half only its shape), the plain version for
    CPU tensors."""
    _check(ci, ga_re, ga_im, gb_re, gb_im, bwd, tw, nfam)
    if ci.device.type == "cpu":
        return tab_leg_plain(ci, ga_re, ga_im, gb_re, gb_im, bwd, nfam)
    if ci.device.type != "cuda":
        raise RuntimeError(f"tab_leg: no kernel for device {ci.device}")
    _check_kernel_shape(ci, bwd, tw)
    B, half, N = ci.shape[0], ga_re.shape[1], bwd.shape[1]
    RB, S, threads = launch_plan(B, nfam, 2 * half,
                                 build.sm_count(ci.device.index or 0))
    plan = fourier.fft_plan(2 * half // S)
    if 3 * B * -(-2 * nfam // RB) * S >= 2 ** 31 or ci.numel() >= 2 ** 31:
        raise ValueError(f"tab_leg: B={B}, nfam={nfam} too large for the "
                         "kernel's grid and 32-bit offsets")
    tab = torch.empty((B, 2, nfam, 3, N), dtype=torch.float64,
                      device=ci.device)
    radices = (ctypes.c_int * len(plan))(*plan)
    with torch.cuda.device(ci.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = build.lib().rt_tab_leg(
            ci.data_ptr(), ga_re.data_ptr(), ga_im.data_ptr(),
            gb_re.data_ptr(), gb_im.data_ptr(), tw.data_ptr(),
            tab.data_ptr(), B, nfam, half, RB, S, threads,
            smem_bytes(RB, S, 2 * half), radices, len(plan), stream)
    build.check(status, "tab_leg")
    counts.LAUNCHES["tab_leg"] += 1
    return tab
