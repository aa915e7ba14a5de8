"""K10 tab_leg: the convolution backward leg with its coefficient windows
(csrc/tab_leg.cu).

    sab[b,s,f,a,:] = [Re | Im](ci[b,a] * g_s[f])     s = 0: ga, s = 1: gb
    tab[b,s,f,a,n] = sum_k sab[b,s,f,a,k] dft_bwd_half[k,n]

ci [B, 3, 2 half] = [re | im] is K9 engine_front's output, g_s the gamma
coefficients ga / gb [NFAM, half] (re and im apart, the first nfam rows
used), dft_bwd_half [2 half, 2np]; tab [B, 2, nfam, 3, 2np] is K1
out_leg's input.  The kernel forms sab's tiles while it stages them, so
sab never reaches device memory.  Replaces redtime_tpu/fastpt.py:1194-1203
(coeff, sab) and :1227 (sab @ dft_bwd_half).
"""

from __future__ import annotations

import torch

from redtime_tpu_torch.kernels import build, counts

# the kernel's tiling (csrc/tab_leg.cu): BM x BN output tiles of WM x WN
# warp tiles, BKH frequencies (2 BKH columns of sab: re, then im) a K-step
BM, BN, BKH, WM, WN = 64, 64, 16, 16, 32
THREADS = 32 * (BM // WM) * (BN // WN)
# a step's staged operand rows: ci's re and im rows of each a for the at
# most LANES_MAX lanes a tile touches, then g's re and im rows of each
# side and family (NFAM_MAX families at most)
NFAM_MAX = 14
LANES_MAX = BM // 6 + 2
CI_ROWS = 6 * LANES_MAX
RAW_ROWS = CI_ROWS + 4 * NFAM_MAX


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


def error_bound(ci, ga_re, ga_im, gb_re, gb_im, bwd, nfam: int):
    """(tab, dtab): the plain version's output and the elementwise bound
    on |kernel - plain|, 2K eps (|sab| @ |dft_bwd_half|) with K = 2 half:
    the kernel forms sab with the plain version's roundings, so only the
    order of the K-term dot products differs."""
    eps = torch.finfo(torch.float64).eps
    sab = sab_plain(ci, ga_re, ga_im, gb_re, gb_im, nfam)
    return sab @ bwd, 2 * bwd.shape[0] * eps * (sab.abs() @ bwd.abs())


def _check(ci, ga_re, ga_im, gb_re, gb_im, bwd, nfam) -> None:
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
    for name, x in (("ci", ci), ("ga_re", ga_re), ("ga_im", ga_im),
                    ("gb_re", gb_re), ("gb_im", gb_im),
                    ("dft_bwd_half", bwd)):
        if x.dtype != torch.float64:
            raise TypeError(f"tab_leg: {name} must be float64, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"tab_leg: {name} must be contiguous")
        if x.device != ci.device:
            raise ValueError("tab_leg: inputs on different devices")


def tab_leg(ci, ga_re, ga_im, gb_re, gb_im, bwd, nfam: int) -> torch.Tensor:
    """tab [B, 2, nfam, 3, 2np]: the hand kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check(ci, ga_re, ga_im, gb_re, gb_im, bwd, nfam)
    if ci.device.type == "cpu":
        return tab_leg_plain(ci, ga_re, ga_im, gb_re, gb_im, bwd, nfam)
    if ci.device.type != "cuda":
        raise RuntimeError(f"tab_leg: no kernel for device {ci.device}")
    B, half, N = ci.shape[0], ga_re.shape[1], bwd.shape[1]
    if nfam > NFAM_MAX:
        raise ValueError(f"tab_leg: the kernel takes at most {NFAM_MAX} "
                         f"families, got {nfam}")
    if N % 2:  # the kernel reads and writes rows in 16-byte pairs
        raise ValueError(f"tab_leg: the kernel takes an even 2np, got {N}")
    if bwd.data_ptr() % 16:
        raise ValueError("tab_leg: dft_bwd_half must be 16-byte aligned")
    if -(-6 * nfam * B // BM) > 65535 or ci.numel() >= 2 ** 31:
        raise ValueError(f"tab_leg: B={B}, nfam={nfam} too large for the "
                         "kernel's grid and 32-bit offsets")
    tab = torch.empty((B, 2, nfam, 3, N), dtype=torch.float64,
                      device=ci.device)
    with torch.cuda.device(ci.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = build.lib().rt_tab_leg(
            ci.data_ptr(), ga_re.data_ptr(), ga_im.data_ptr(),
            gb_re.data_ptr(), gb_im.data_ptr(), bwd.data_ptr(),
            tab.data_ptr(), B, nfam, half, N, stream)
    build.check(status, "tab_leg")
    counts.LAUNCHES["tab_leg"] += 1
    return tab
