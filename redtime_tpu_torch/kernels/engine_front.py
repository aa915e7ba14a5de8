"""K9 engine_front: the engine's front, ln P -> (P_ext, ci)
(csrc/engine_front.cu).

    x[b,a,m]     = sum_j lnP[b,a,j] pab_M[m,j] + (n_s[b] - 3) pab_v[m]
    P_ext[b,a,m] = exp(clip(x, -80, 20)) wp[m]
    ci[b,a,c]    = sum_m (P_ext[b,a,m] kbias[m]) dft_fwd_half[m,c]

lnP [B, 3, nk] (rows ln P_00, P_01, P_11), first clipped to [LNP_MIN,
LNP_MAX] when `clip` (the RHS's clip of its state).  P_ext [B, 3, np] feeds
K2 pz_leg, ci [B, 3, 2 half] = [re | im] K10 tab_leg.  lnP may be a view
with any lane and row strides (the RHS hands it the state's first three
rows; the 1-loop cache an expanded row, row stride 0).  Replaces
redtime_tpu/fastpt.py extend_power (:908-931), the forward leg of
compute_J_PZ_windowed (:1193) and the RHS's clip (redtime_tpu/trg.py:185).
"""

from __future__ import annotations

import functools

import torch

from redtime_tpu_torch.kernels import build, counts
from redtime_tpu_torch.kernels.rhs_tail import LNP_MAX, LNP_MIN

# the clip of the extended log spectrum (redtime_tpu/fastpt.py:930)
EXT_MIN, EXT_MAX = -80.0, 20.0
# the kernel's layout (csrc/engine_front.cu): a cluster of CLUSTER blocks
# for `lanes` lanes (1 or 2: `lanes`), block r of a cluster extending the
# r-th slice of the extended grid; COLS columns of ci a block, PARTS
# threads a column
CLUSTER, COLS, PARTS = 8, 64, 8
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
    bounds on |kernel - plain| (the kernel sums its dot products in another
    order; every other operation is the plain version's).  The two lnP
    products are each within nk eps (|lnP| @ |pab_M|^T) of the exact one,
    the bias add and the clip (1-Lipschitz) move x by at most 2 eps |x|
    more: dx = 2 (nk + 2) eps (|lnP| @ |pab_M|^T + |bias|).  Carried
    through exp and the window (each rounding within 2 eps), dP = 2 |P|
    (expm1(dx) + 8 eps).  ci: the np-term dot products in either order
    plus the carried dP, dci = 2 ((dP |kbias|) @ |fwd| + 2 (np + 1) eps
    (|P kbias| @ |fwd|)).  Both with margin 2."""
    eps = torch.finfo(torch.float64).eps
    if clip:
        lnP = torch.clamp(lnP, LNP_MIN, LNP_MAX)
    P, ci = engine_front_plain(lnP, n_s, pab_M, pab_v, wp, kbias, fwd)
    nk, npts = lnP.shape[-1], pab_M.shape[0]
    bias = ((n_s[:, None, None] - 3.0) * pab_v).abs()
    dx = 2 * (nk + 2) * eps * (lnP.abs() @ pab_M.abs().T + bias)
    dP = 2 * P.abs() * (torch.expm1(dx) + 8 * eps)
    F = fwd.abs()
    dci = 2 * ((dP * kbias.abs()) @ F
               + 2 * (npts + 1) * eps * ((P * kbias).abs() @ F))
    return P, ci, dP, dci


def smem_bytes(lanes: int, nk: int, npts: int) -> int:
    """Shared memory of a block of `lanes` lanes: their ln P rows, their
    whole P_ext kbias rows and the column parts' sums."""
    return 8 * 3 * lanes * (nk + npts + PARTS * COLS)


def grid(nk: int, npts: int, nc: int) -> tuple:
    """(column tiles rounded up to whole clusters, the rows of the
    extended grid each rank extends), as rt_engine_front lays them out."""
    tiles = -(-nc // COLS)
    return -(-tiles // CLUSTER) * CLUSTER, -(-npts // CLUSTER)


def lanes(B: int, nk: int, npts: int, nc: int, clusters) -> int:
    """Lanes a cluster: 2 where two lanes' rows fit a block's shared
    memory and one lane a cluster would take more waves of clusters
    (clusters(lanes): how many the device runs at once; 0 when it cannot
    say), else 1."""
    if smem_bytes(2, nk, npts) > SMEM_MAX:
        return 1
    fit = [clusters(n) for n in (1, 2)]
    if min(fit) < 1:
        return 1
    per_group = grid(nk, npts, nc)[0] // CLUSTER
    waves = [-(-(-(-B // n) * per_group) // f) for n, f in zip((1, 2), fit)]
    return 2 if waves[1] < waves[0] else 1


@functools.lru_cache(maxsize=None)
def _lanes_on(device: int, B: int, nk: int, npts: int, nc: int) -> int:
    """lanes() with the clusters that fit at once on CUDA device `device`
    (asked of the CUDA runtime once a shape)."""
    with torch.cuda.device(device):
        fit = [build.lib().rt_engine_front_clusters(n, nk, npts)
               for n in (1, 2)]
    return lanes(B, nk, npts, nc, lambda n: fit[n - 1])


def _check(lnP, n_s, pab_M, pab_v, wp, kbias, fwd) -> None:
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
    if n_s.shape != (B,):
        raise ValueError(f"engine_front: n_s must be [{B}], got "
                         f"{tuple(n_s.shape)}")
    for name, x in (("pab_v", pab_v), ("wp", wp), ("kbias", kbias)):
        if x.shape != (npts,):
            raise ValueError(f"engine_front: {name} must be [{npts}], got "
                             f"{tuple(x.shape)}")
    for name, x in (("lnP", lnP), ("n_s", n_s), ("pab_M", pab_M),
                    ("pab_v", pab_v), ("wp", wp), ("kbias", kbias),
                    ("dft_fwd_half", fwd)):
        if x.dtype != torch.float64:
            raise TypeError(f"engine_front: {name} must be float64, got "
                            f"{x.dtype}")
        if x.device != lnP.device:
            raise ValueError("engine_front: inputs on different devices")


def _check_kernel_shape(lnP, pab_M, pab_v, wp, kbias, fwd) -> None:
    """What the CUDA kernel takes beyond _check (the plain version takes
    any layout)."""
    B, _, nk = lnP.shape
    npts, nc = fwd.shape
    if lnP.stride(2) != 1 or min(lnP.stride()) < 0:
        raise ValueError(f"engine_front: the kernel needs lnP with unit "
                         f"column stride, got strides {lnP.stride()}")
    for name, x in (("pab_M", pab_M), ("pab_v", pab_v), ("wp", wp),
                    ("kbias", kbias), ("dft_fwd_half", fwd)):
        if not x.is_contiguous():
            raise ValueError(f"engine_front: {name} must be contiguous")
    if B > 65535:
        raise ValueError(f"engine_front: at most 65535 lanes, got {B}")
    smem = smem_bytes(1, nk, npts)
    if smem > SMEM_MAX:
        raise ValueError(f"engine_front: nk={nk}, np={npts} need {smem} "
                         f"bytes of shared memory a block (at most "
                         f"{SMEM_MAX})")


def engine_front(lnP, n_s, pab_M, pab_v, wp, kbias, fwd,
                 clip: bool = False):
    """(P_ext [B, 3, np], ci [B, 3, 2 half]): the hand kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check(lnP, n_s, pab_M, pab_v, wp, kbias, fwd)
    if lnP.device.type == "cpu":
        return engine_front_plain(lnP, n_s, pab_M, pab_v, wp, kbias, fwd,
                                  clip)
    if lnP.device.type != "cuda":
        raise RuntimeError(f"engine_front: no kernel for device "
                           f"{lnP.device}")
    _check_kernel_shape(lnP, pab_M, pab_v, wp, kbias, fwd)
    B, _, nk = lnP.shape
    npts, nc = fwd.shape
    P_ext = torch.empty((B, 3, npts), dtype=torch.float64,
                        device=lnP.device)
    ci = torch.empty((B, 3, nc), dtype=torch.float64, device=lnP.device)
    with torch.cuda.device(lnP.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = build.lib().rt_engine_front(
            lnP.data_ptr(), lnP.stride(0), lnP.stride(1), n_s.data_ptr(),
            n_s.stride(0), pab_M.data_ptr(), pab_v.data_ptr(), wp.data_ptr(),
            kbias.data_ptr(), fwd.data_ptr(), P_ext.data_ptr(),
            ci.data_ptr(), B, nk, npts, nc, int(clip),
            _lanes_on(lnP.device.index, B, nk, npts, nc), stream)
    build.check(status, "engine_front")
    counts.LAUNCHES["engine_front"] += 1
    return P_ext, ci
