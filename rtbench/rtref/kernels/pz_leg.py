"""K2 pz_leg: the Z-kernel Toeplitz contraction with its outer-factor
epilogue (csrc/pz_leg.cu).

    conv[b, n, a, i]  = sum_m T_sl[n, i, m] P_e[b, a, m]
    PZ[b, n, a, c, i] = pz_kfac_sl[i] conv[b, n, a, i] P_e[b, c, nshift+i]

Replaces redtime_tpu/fastpt.py _pz_windowed (:1310-1334), which ran the
contraction as Ozaki int8 dots on the TPU.
"""

from __future__ import annotations

import torch

from rtbench.rtref.kernels import build, counts

F64 = torch.float64


def pz_leg_plain(T_sl: torch.Tensor, P_e: torch.Tensor,
                 kfac: torch.Tensor, nshift: int) -> torch.Tensor:
    """The plain PyTorch version (the JAX package's einsum form)."""
    nk = T_sl.shape[1]
    conv = torch.einsum("nim,bam->bnai", T_sl, P_e)
    return (kfac * conv[:, :, :, None, :]
            * P_e[:, None, None, :, nshift:nshift + nk])


def _check(T_sl, P_e, kfac, nshift) -> None:
    if T_sl.dim() != 3 or T_sl.shape[0] != 7:
        raise ValueError(f"pz_leg: T_sl must be [7, nk, np], got "
                         f"{tuple(T_sl.shape)}")
    _, nk, npts = T_sl.shape
    if P_e.dim() != 3 or P_e.shape[1:] != (3, npts):
        raise ValueError(f"pz_leg: P_e must be [B, 3, {npts}], got "
                         f"{tuple(P_e.shape)}")
    if kfac.shape != (nk,):
        raise ValueError(f"pz_leg: pz_kfac_sl must be [{nk}], got "
                         f"{tuple(kfac.shape)}")
    if not 0 <= nshift <= npts - nk:
        raise ValueError(f"pz_leg: nshift={nshift} outside the grid")
    for name, x in (("T_sl", T_sl), ("P_e", P_e), ("pz_kfac_sl", kfac)):
        if x.dtype != F64:
            raise TypeError(f"pz_leg: {name} must be float64, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"pz_leg: {name} must be contiguous")
        if x.device != P_e.device:
            raise ValueError("pz_leg: inputs on different devices")


def pz_leg(T_sl: torch.Tensor, P_e: torch.Tensor, kfac: torch.Tensor,
           nshift: int) -> torch.Tensor:
    """PZ_w [B, 7, 3, 3, nk]: the hand kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check(T_sl, P_e, kfac, nshift)
    if True:  # the reference: the plain version on every device
        return pz_leg_plain(T_sl, P_e, kfac, nshift)
    if P_e.device.type != "cuda":
        raise RuntimeError(f"pz_leg: no kernel for device {P_e.device}")
    _, nk, npts = T_sl.shape
    B = P_e.shape[0]
    if npts % 2:  # the kernel reads the rows in 16-byte copies
        raise ValueError(f"pz_leg: the kernel takes an even np, got {npts}")
    if any(x.data_ptr() % 16 for x in (T_sl, P_e)):
        raise ValueError("pz_leg: T_sl and P_e must be 16-byte aligned")
    out = torch.empty((B, 7, 3, 3, nk), dtype=F64,
                      device=P_e.device)
    with torch.cuda.device(P_e.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = build.lib().rt_pz_leg(T_sl.data_ptr(), P_e.data_ptr(),
                                       kfac.data_ptr(), out.data_ptr(),
                                       B, nk, npts, nshift, stream)
    build.check(status, "pz_leg")
    counts.LAUNCHES["pz_leg"] += 1
    return out
