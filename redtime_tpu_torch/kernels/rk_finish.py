"""K3: one embedded-RK controller attempt's own arithmetic, in two hand
kernels (csrc/rk_attempt.cu, CUDA C++).

`rk_stage` forms one stage input, y_i = y + h_try sum_{j<i} a_ij k_j, in
one launch.  `rk_finish` is the attempt's tail: given the state y [B, D],
the stage stack ks [s, B, D] (each stage already evaluated at the clipped
step) and per-lane t, h, t1, n and an `active` mask, one attempt finishes
as in redtime_tpu/ode.py:161-181 under a vmapped while_loop:

    dt = t1 - t;  final = h > dt;  h_try = final ? dt : h
    y_new = y + h_try * sum_j b_j k_j     (stages summed in index order)
    yerr  = h_try * sum_j e_j k_j
    r     = max_i |yerr_i| / (eabs + erel |y_new_i|)      per lane
    GSL's standard controller: r > 1.1 rejects with
    h *= max(0.9 r^(-1/ord), 0.2); r < 0.5 grows h by
    clip(0.9 r^(-1/(ord+1)), 1, 5); the accepted step lands on t1 when final.

Lanes that are not active stay frozen (y, t, h and the attempt count n
unchanged).  Returns (y_out, t_out, h_out, n_out, r).

On the TPU both were part of XLA's while_loop fusion.  On the card the
finish is a fused elementwise pass plus one max-reduction per lane over
D = 41 nk elements (~5k at nk=128), bound by reading s + 1 rows of D f64
per lane: one thread-block cluster per lane reads each row once, keeps
its slice in registers, finds r through the cluster's shared memory and
writes the chosen state from registers (a slice too large for the
registers, D > 32768, runs in passes: `in_passes`).  Every product and sum rounds
once, as in the plain versions (and the JAX controller), so the error
norm r — which divides by eabs + erel|y_new| and so amplifies the
rounding of a cancelling y + h sum b k — and with it every accept/reject
decision match the plain version.

What cannot change between the attempts of one integration (the tableau,
the controller's scalars, their device) is validated once, when
`attempt_consts` builds the frozen AttemptConsts the wrappers take; a call
checks only the tensors that it is handed anew.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from redtime_tpu_torch.kernels import build, counts

# GSL's standard-controller constants: safety factor, reject-above and
# grow-below thresholds, smallest and largest step factors
SAFETY, REJECT_ABOVE, GROW_BELOW, FAC_MIN, FAC_MAX = 0.9, 1.1, 0.5, 0.2, 5.0
KERNEL_STAGES = (6, 7, 12)       # the kernels' stage counts: RKF45, DOPRI5,
                                 # DOP853 (the plain versions take any)
CLUSTER_SIZES = (1, 2, 4, 8)     # blocks that split one lane's D elements
# accesses (of 16 or 8 bytes) a block takes before the lane is split
# further (256 threads, two each), and the most it keeps in registers
# (eight each: MAX_UPT * THREADS of csrc/rk_attempt.cu, whose launcher
# runs a larger slice in passes)
_UNITS_PER_BLOCK, _MAX_UNITS_PER_BLOCK = 512, 2048
_F64 = torch.float64


def _controller_values(eabs: float, erel: float, order: int) -> list:
    return [eabs, erel, -1.0 / order, -1.0 / (order + 1.0),
            SAFETY, REJECT_ABOVE, GROW_BELOW, FAC_MIN, FAC_MAX]


def controller_params(eabs: float, erel: float, order: int,
                      device) -> torch.Tensor:
    """The controller's scalars as one f64 tensor [9]: eabs, erel, the
    step-factor exponents -1/ord and -1/(ord+1), and the constants above."""
    return torch.tensor(_controller_values(eabs, erel, order), dtype=_F64,
                        device=device)


@dataclass(frozen=True)
class AttemptConsts:
    """A tableau and the controller's scalars on one device, validated by
    `attempt_consts`, the only place that makes one: f64, contiguous,
    a [s, s], b, e [s], c [s, 1], prm [9] (controller_params); and b, e,
    prm once more in host memory (`host`, 2 s + 9 f64, at address
    `host_ptr`), which rk_finish's launcher copies into the kernel's
    parameters."""

    a: torch.Tensor
    b: torch.Tensor
    e: torch.Tensor
    c: torch.Tensor
    prm: torch.Tensor
    s: int
    device: torch.device
    host: np.ndarray
    host_ptr: int


def attempt_consts(tab, eabs: float, erel: float, device) -> AttemptConsts:
    """The constants of every attempt of one integration, uploaded in one
    copy.  tab: a tableau with fields a [s, s], b, e, c [s] and order."""
    a, b, e, c = (np.asarray(x, dtype=np.float64)
                  for x in (tab.a, tab.b, tab.e, tab.c))
    s = b.shape[0]
    if s < 1:
        raise ValueError("attempt_consts: a tableau has at least one stage")
    if a.shape != (s, s) or e.shape != (s,) or c.shape != (s,):
        raise ValueError(f"attempt_consts: need a [{s}, {s}] and e, c [{s}], "
                         f"got {a.shape}, {e.shape}, {c.shape}")
    if np.triu(a).any():
        raise ValueError("attempt_consts: a must be strictly lower "
                         "triangular (an explicit method)")
    host = np.concatenate([b, e, _controller_values(eabs, erel, tab.order)])
    flat = torch.as_tensor(np.concatenate([a.ravel(), c, host]),
                           device=device)
    a_t, c_t, b_t, e_t, prm = torch.split(flat, [s * s, s, s, s, 9])
    return AttemptConsts(a_t.view(s, s), b_t, e_t, c_t.view(s, 1), prm, s,
                         flat.device, host, host.ctypes.data)


def rk_stage_plain(y, ks, h, a_row, i: int):
    """The plain PyTorch version of rk_stage: rows summed in index order,
    every product and sum rounded alone."""
    acc = a_row[0] * ks[0]
    for j in range(1, i):
        acc = acc + a_row[j] * ks[j]
    return y + h[:, None] * acc


def rk_finish_plain(y, ks, t, h, t1, n, active, b, e, prm):
    """The plain PyTorch version, operation for operation the JAX
    controller (redtime_tpu/ode.py:161-181).  prm: controller_params."""
    eabs, erel, p_dec, p_inc = prm[:4]
    dt = t1 - t
    final = h > dt
    h_try = torch.where(final, dt, h)
    acc_b = b[0] * ks[0]
    acc_e = e[0] * ks[0]
    for j in range(1, ks.shape[0]):
        acc_b = acc_b + b[j] * ks[j]
        acc_e = acc_e + e[j] * ks[j]
    hy = h_try[:, None]
    y_new = y + hy * acc_b
    yerr = hy * acc_e
    d0 = eabs + erel * torch.abs(y_new)
    r = torch.amax(torch.abs(yerr) / d0, dim=1)
    dec = r > REJECT_ABOVE
    fac_dec = torch.clamp(SAFETY * r ** p_dec, min=FAC_MIN)
    fac_inc = torch.clamp(SAFETY * r ** p_inc, 1.0, FAC_MAX)
    fac = torch.where(dec, fac_dec,
                      torch.where(r < GROW_BELOW, fac_inc,
                                  torch.ones_like(r)))
    h_next = h_try * fac
    t_acc = torch.where(final, t1, t + h_try)
    t_new = torch.where(dec, t, t_acc)
    take = active & ~dec
    y_out = torch.where(take[:, None], y_new, y)
    t_out = torch.where(active, t_new, t)
    h_out = torch.where(active, h_next, h)
    n_out = n + active.to(n.dtype)
    return y_out, t_out, h_out, n_out, r


def _explain(name: str, consts, specs) -> None:
    """Raise for the first tensor of specs (label, tensor, shape, dtype)
    that the kernels do not take."""
    if not isinstance(consts, AttemptConsts):
        raise TypeError(f"{name}: consts must come from attempt_consts, got "
                        f"{type(consts).__name__}")
    y = specs[0][1]
    if y.dim() != 2 or y.numel() == 0:
        raise ValueError(f"{name}: y must be [B, D] with B, D >= 1, got "
                         f"{list(y.shape)}")
    for label, x, shape, dtype in specs:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: {label} must be {list(shape)}, got "
                             f"{list(x.shape)}")
        if x.dtype != dtype:
            raise TypeError(f"{name}: {label} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if x.device != consts.device:
            raise ValueError(f"{name}: {label} is on {x.device}, the "
                             f"constants on {consts.device}")
    raise ValueError(f"{name}: inputs the kernel does not take")


def _state_ok(y, ks, consts) -> bool:
    """y [B, D] and ks [s, B, D]: f64, contiguous, on the constants'
    device."""
    return (type(consts) is AttemptConsts and y.dim() == 2 and y.numel() > 0
            and ks.shape == (consts.s, *y.shape)
            and y.dtype == ks.dtype == _F64
            and y.device == ks.device == consts.device
            and y.is_contiguous() and ks.is_contiguous())


def _lanes_ok(y, dtype, *xs) -> bool:
    """Every x is a contiguous [B] tensor of dtype on y's device."""
    shape = y.shape[:1]
    return all(x.shape == shape and x.dtype == dtype
               and x.device == y.device and x.is_contiguous() for x in xs)


def cluster_plan(D: int, aligned: bool) -> tuple:
    """(cl, vec) for a lane of D f64: vec, 16-byte accesses, where D is
    even and the rows are 16-byte aligned, else 8-byte ones; cl, the
    smallest of CLUSTER_SIZES that leaves a block at most _UNITS_PER_BLOCK
    accesses (8 at D = 5248, 1 for the growth states), or 8 when none
    does (see in_passes)."""
    vec = aligned and D % 2 == 0
    units = D // 2 if vec else D
    cl = next((c for c in CLUSTER_SIZES if units <= c * _UNITS_PER_BLOCK),
              CLUSTER_SIZES[-1])
    return cl, vec


def in_passes(D: int, cl: int, vec: bool) -> bool:
    """Whether a block's slice of a lane of D f64 (cl blocks a lane,
    16-byte accesses when vec) exceeds what it keeps in registers, so the
    kernel loops over it in passes: D > 32768 (16384 when D is odd) at
    cl = 8, nk > 799 on the eta state."""
    units = D // 2 if vec else D
    return -(-units // cl) > _MAX_UNITS_PER_BLOCK


def _check_kernel_shape(name: str, y, consts) -> None:
    """What the CUDA kernels take beyond the plain versions."""
    if consts.s not in KERNEL_STAGES:
        raise ValueError(f"{name}: the kernel takes {KERNEL_STAGES} stages, "
                         f"got {consts.s}")
    if y.shape[0] > 65535:
        raise ValueError(f"{name}: at most 65535 lanes, got {y.shape[0]}")


def _aligned(*xs) -> bool:
    return not any(x.data_ptr() % 16 for x in xs)


def _raw_stream(device: torch.device) -> int:
    """The current stream's handle, without building a Stream object."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _launch_finish(y, ks, t, h, t1, n, active, consts, cl: int, vec: bool):
    """Launch rt_rk_finish with cl blocks a lane; t_out, h_out, r and
    n_out are rows of one buffer."""
    B, D = y.shape
    y_out = torch.empty_like(y)
    t_out, h_out, r, n_bits = torch.empty((4, B), dtype=_F64,
                                          device=y.device).unbind(0)
    n_out = n_bits.view(torch.int64)
    status = build.lib().rt_rk_finish(
        y.data_ptr(), ks.data_ptr(), t.data_ptr(), h.data_ptr(),
        t1.data_ptr(), n.data_ptr(), active.data_ptr(), consts.host_ptr,
        y_out.data_ptr(), t_out.data_ptr(), h_out.data_ptr(),
        n_out.data_ptr(), r.data_ptr(), B, D, consts.s, cl, int(vec),
        y.device.index, _raw_stream(y.device))
    build.check(status, "rk_finish")
    counts.LAUNCHES["rk_finish"] += 1
    return y_out, t_out, h_out, n_out, r


def rk_finish(y, ks, t, h, t1, n, active, consts: AttemptConsts):
    """One controller attempt's tail: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  consts: attempt_consts."""
    if not (_state_ok(y, ks, consts) and _lanes_ok(y, _F64, t, h, t1)
            and _lanes_ok(y, torch.int64, n)
            and _lanes_ok(y, torch.bool, active)):
        B, D = (y.shape if y.dim() == 2 else (-1, -1))
        s = getattr(consts, "s", -1)
        _explain("rk_finish", consts, [
            ("y", y, (B, D), _F64), ("ks", ks, (s, B, D), _F64),
            ("t", t, (B,), _F64), ("h", h, (B,), _F64),
            ("t1", t1, (B,), _F64), ("n", n, (B,), torch.int64),
            ("active", active, (B,), torch.bool)])
    if y.device.type == "cpu":
        return rk_finish_plain(y, ks, t, h, t1, n, active, consts.b,
                               consts.e, consts.prm)
    if y.device.type != "cuda":
        raise RuntimeError(f"rk_finish: no kernel for device {y.device}")
    _check_kernel_shape("rk_finish", y, consts)
    cl, vec = cluster_plan(y.shape[1], _aligned(y, ks))
    return _launch_finish(y, ks, t, h, t1, n, active, consts, cl, vec)


def rk_stage(y, ks, h, consts: AttemptConsts, i: int):
    """The input of stage i (1 <= i < s), y + h sum_{j<i} a_ij ks[j]
    [B, D], from the rows 0 .. i-1 of ks [s, B, D]: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if not (_state_ok(y, ks, consts) and _lanes_ok(y, _F64, h)
            and 1 <= i < consts.s):
        B, D = (y.shape if y.dim() == 2 else (-1, -1))
        s = getattr(consts, "s", -1)
        if isinstance(consts, AttemptConsts) and not 1 <= i < s:
            raise ValueError(f"rk_stage: stage index must be in [1, {s}), "
                             f"got {i}")
        _explain("rk_stage", consts, [
            ("y", y, (B, D), _F64), ("ks", ks, (s, B, D), _F64),
            ("h", h, (B,), _F64)])
    if y.device.type == "cpu":
        return rk_stage_plain(y, ks, h, consts.a[i], i)
    if y.device.type != "cuda":
        raise RuntimeError(f"rk_stage: no kernel for device {y.device}")
    _check_kernel_shape("rk_stage", y, consts)
    B, D = y.shape
    out = torch.empty_like(y)
    vec = D % 2 == 0 and _aligned(y, ks)
    status = build.lib().rt_rk_stage(
        y.data_ptr(), ks.data_ptr(), h.data_ptr(),
        consts.a.data_ptr() + 8 * i * consts.s,     # row i of a
        out.data_ptr(), B, D, i, int(vec), y.device.index,
        _raw_stream(y.device))
    build.check(status, "rk_stage")
    counts.LAUNCHES["rk_stage"] += 1
    return out
