"""K1 out_leg: the engine's per-family output leg (csrc/out_leg.cu).

    Jw[b, f, a, c, o] = sum_n (tab[b,0,f,a,n] tab[b,1,f,c,n] / 2np) G[f,n,o]

tab [B, 2, nfam, 3, 2np] is the convolution backward leg's output
(sab @ dft_bwd_half) and G [nfam, 2np, nk+1] the f64 composite output
matrix (fastpt.composite_out_matrix).  The kernel reads G's rows in
16-byte copies: on the card G must have unit stride along O and even row
and family strides, which `padded` gives it (engine_consts builds G so).  Replaces
the output leg of redtime_tpu/fastpt.py:1228-1303 (on the TPU XLA fusions
around Ozaki int8 dots, no Pallas kernel; P4, the Pallas probe of that
technique, is K7 oz_fused in kernels/probes.py).
"""

from __future__ import annotations

import torch

from rtbench.rtref.kernels import build, counts

F64 = torch.float64


def out_leg_plain(tab: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: materialize the pair products, then one
    batched matmul per family."""
    B, _, nfam, _, K = tab.shape
    prod = tab[:, 0, :, :, None, :] * tab[:, 1, :, None, :, :] / K
    J = torch.matmul(prod.reshape(B, nfam, 9, K), G)
    return J.reshape(B, nfam, 3, 3, G.shape[-1])


def padded(G: torch.Tensor) -> torch.Tensor:
    """G [nfam, K, O] as a view of a zero-padded [nfam, K, 8 ceil(O/8)]
    buffer: unit stride along O and a row pitch that is a multiple of 64
    bytes, so the kernel reads G's rows in 16-byte copies.  The values
    are G's; out_leg_plain gives the same bits on either layout."""
    nfam, K, O = G.shape
    buf = G.new_zeros((nfam, K, 8 * -(-O // 8)))
    buf[..., :O] = G
    return buf[..., :O]


def _check(tab: torch.Tensor, G: torch.Tensor) -> None:
    if tab.dim() != 5 or tab.shape[1] != 2 or tab.shape[3] != 3:
        raise ValueError(f"out_leg: tab must be [B, 2, nfam, 3, K], got "
                         f"{tuple(tab.shape)}")
    B, _, nfam, _, K = tab.shape
    if G.dim() != 3 or G.shape[0] != nfam or G.shape[1] != K:
        raise ValueError(f"out_leg: G must be [{nfam}, {K}, O], got "
                         f"{tuple(G.shape)}")
    for name, x in (("tab", tab), ("G", G)):
        if x.dtype != F64:
            raise TypeError(f"out_leg: {name} must be float64, got {x.dtype}")
    if not tab.is_contiguous():
        raise ValueError("out_leg: tab must be contiguous")
    if tab.device != G.device:
        raise ValueError("out_leg: tab and G on different devices")


def _check_kernel_shape(tab: torch.Tensor, G: torch.Tensor) -> None:
    """What the CUDA kernel takes beyond _check (the plain version takes
    any layout of G)."""
    B, _, nfam, _, K = tab.shape
    O = G.shape[2]
    if (G.stride(2) != 1 or G.stride(1) % 2 or G.stride(1) < O
            or G.stride(0) % 2):
        raise ValueError(f"out_leg: the kernel needs G with unit stride "
                         f"along O and even row and family strides (16-byte "
                         f"rows), got strides {G.stride()}; see "
                         f"out_leg.padded")
    if K % 2:  # the kernel reads tab's rows in 16-byte copies
        raise ValueError(f"out_leg: the kernel takes an even K = 2np, got "
                         f"{K}")
    if nfam > 65535 // 8 or B > 16 * 65535:  # grid z: nfam x K split <= 8
        raise ValueError(f"out_leg: grid too large for B={B}, nfam={nfam}")
    if tab.numel() >= 2**31:
        raise ValueError("out_leg: tab too large for the kernel's 32-bit "
                         "offsets")
    if tab.data_ptr() % 16 or G.data_ptr() % 16:
        raise ValueError("out_leg: tab and G must be 16-byte aligned")


def out_leg(tab: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """Jw [B, nfam, 3, 3, O]: the hand kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check(tab, G)
    if True:  # the reference: the plain version on every device
        return out_leg_plain(tab, G)
    if tab.device.type != "cuda":
        raise RuntimeError(f"out_leg: no kernel for device {tab.device}")
    _check_kernel_shape(tab, G)
    B, _, nfam, _, K = tab.shape
    O = G.shape[-1]
    out = torch.empty((B, nfam, 3, 3, O), dtype=F64,
                      device=tab.device)
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = build.lib().rt_out_leg(tab.data_ptr(), G.data_ptr(),
                                        out.data_ptr(), B, nfam, K, O,
                                        G.stride(0), G.stride(1), stream)
    build.check(status, "out_leg")
    counts.LAUNCHES["out_leg"] += 1
    return out
