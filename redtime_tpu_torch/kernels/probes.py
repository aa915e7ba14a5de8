"""K4 affine, K5 int8_dot, K6 dd_mul: the Pallas feasibility probes P1-P3
of scripts/probe_pallas.py as Hopper kernels (csrc/probes.cu).

  * affine(x)          — P1 (probe_pallas.py:29-38): 2x + 1 on f32;
  * int8_dot(a, b)     — P2 (:44-57): int8 [M,K] @ int8 [K,N] -> int32,
                         exact;
  * dd_mul(ah, al, bh, bl) — P3 (:78-99): the double-double product
                         dd.mul of f32 (hi, lo) pairs.

Each kernel equals its plain version bit for bit.
"""

from __future__ import annotations

import torch

from redtime_tpu_torch import dd
from redtime_tpu_torch.kernels import build, counts

# |a_mk b_kn| <= 2^14 for int8, so an int32 sum over K is exact while
# K * 2^14 < 2^31
_INT8_DOT_MAX_K = 2 ** 31 // 2 ** 14 - 1


def affine_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0 + 1.0


def int8_dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact in any order of summation: every partial sum is an integer
    of magnitude <= K 2^14 < 2^53."""
    return (a.double() @ b.double()).to(torch.int32)


dd_mul_plain = dd.mul


def _check_f32(name: str, *xs: torch.Tensor) -> None:
    for x in xs:
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: needs float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if x.shape != xs[0].shape or x.device != xs[0].device:
            raise ValueError(f"{name}: inputs differ in shape or device")


def _device(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (take the plain version); raises on any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    return True


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def affine(x: torch.Tensor) -> torch.Tensor:
    """2x + 1 of a contiguous f32 tensor of any shape."""
    _check_f32("affine", x)
    if not _device("affine", x):
        return affine_plain(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = build.lib().rt_affine(x.data_ptr(), out.data_ptr(),
                                       x.numel(), _stream(x))
    build.check(status, "affine")
    counts.LAUNCHES["affine"] += 1
    return out


def int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] for int8 a, b -> int32 [M, N], exact."""
    for name, x in (("a", a), ("b", b)):
        if x.dtype != torch.int8:
            raise TypeError(f"int8_dot: {name} must be int8, got {x.dtype}")
        if x.dim() != 2:
            raise ValueError(f"int8_dot: {name} must be 2-D, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"int8_dot: {name} must be contiguous")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_dot: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not chain")
    if a.device != b.device:
        raise ValueError("int8_dot: a and b on different devices")
    (M, K), N = a.shape, b.shape[1]
    if M == 0 or N == 0:
        raise ValueError(f"int8_dot: empty output [{M}, {N}]")
    if K > _INT8_DOT_MAX_K:
        raise ValueError(f"int8_dot: K={K} can overflow the int32 sum "
                         f"(K * 2^14 must stay below 2^31)")
    if not _device("int8_dot", a):
        return int8_dot_plain(a, b)
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        status = build.lib().rt_int8_dot(a.data_ptr(), b.data_ptr(),
                                         out.data_ptr(), M, N, K, _stream(a))
    build.check(status, "int8_dot")
    counts.LAUNCHES["int8_dot"] += 1
    return out


def dd_mul(ah: torch.Tensor, al: torch.Tensor, bh: torch.Tensor,
           bl: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(ah, al) * (bh, bl) -> (hi, lo): dd.mul elementwise over four
    contiguous f32 tensors of one shape."""
    _check_f32("dd_mul", ah, al, bh, bl)
    if not _device("dd_mul", ah):
        return dd_mul_plain(ah, al, bh, bl)
    oh, ol = torch.empty_like(ah), torch.empty_like(ah)
    with torch.cuda.device(ah.device):
        status = build.lib().rt_dd_mul(
            ah.data_ptr(), al.data_ptr(), bh.data_ptr(), bl.data_ptr(),
            oh.data_ptr(), ol.data_ptr(), ah.numel(), _stream(ah))
    build.check(status, "dd_mul")
    counts.LAUNCHES["dd_mul"] += 1
    return oh, ol
