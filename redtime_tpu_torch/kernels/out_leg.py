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

Each launch runs one of the kernel's schedules, which `schedule` picks
from the launch's shape and the card's SM count; `SCHEDULE_LAUNCHES`
counts the launches of each.
"""

from __future__ import annotations

import torch

from redtime_tpu_torch.kernels import build, counts


def out_leg_plain(tab: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: materialize the pair products, then one
    batched matmul per family."""
    B, _, nfam, _, K = tab.shape
    prod = tab[:, 0, :, :, None, :] * tab[:, 1, :, None, :, :] / K
    J = torch.matmul(prod.reshape(B, nfam, 9, K), G)
    return J.reshape(B, nfam, 3, 3, G.shape[-1])


# Schedules, by the id that csrc/out_leg.cu's rt_out_leg maps to its
# instantiation of out_leg_kernel.  NARROW is the design for few output
# tiles: 16 lanes x 72 columns, K split 4 ways in a cluster, one block an
# SM.  A wide schedule tiles rows (b, a, c) x columns, runs all of K in
# each block and two blocks an SM: WIDE_72 in tiles of 128 x 72, WIDE_48
# in tiles of 192 x 48.
NARROW, WIDE_72, WIDE_48 = 0, 1, 2
SCHEDULES = (NARROW, WIDE_72, WIDE_48)
NAMES = ("narrow", "wide 128x72", "wide 192x48")
ROWS = (144, 128, 192)      # a block tile's rows (b, a, c)
COLUMNS = (72, 72, 48)      # and columns
# the rule's costs, in narrow blocks' time at the same K: a wide block
# alone on its SM, and two wide blocks that share one (fitted to every
# schedule's device times at 2np = 1024 and 4096 on an H100: PERF.md)
WIDE_ALONE = {WIDE_72: 4.0, WIDE_48: 3.5}
WIDE_PAIR = 5.2

SCHEDULE_LAUNCHES: dict = {}   # schedule id -> launches on the card


def _tiles(n: int, size: int) -> int:
    return -(-n // size)


def schedule(B: int, nfam: int, O: int, n_sm: int) -> int:
    """The schedule of a launch at [B, 2, nfam, 3, K] x [nfam, K, O] on a
    card of n_sm SMs: the one whose busiest SM is done first, the lower id
    on a tie.  A narrow block (4 a tile) runs alone on its SM, so L of
    them on the busiest SM cost L; L wide blocks run two at a time, each
    pair WIDE_PAIR and one left over WIDE_ALONE[s].  Every cost grows with
    K alike, so K does not enter."""
    def cost(s: int) -> float:
        blocks = _tiles(9 * B, ROWS[s]) * _tiles(O, COLUMNS[s]) * nfam
        if s == NARROW:
            return _tiles(4 * blocks, n_sm)
        L = _tiles(blocks, n_sm)
        return L // 2 * WIDE_PAIR + L % 2 * WIDE_ALONE[s]
    return min(SCHEDULES, key=lambda s: (cost(s), s))


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
        if x.dtype != torch.float64:
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
    # grid z: nfam x K split; grid y: tiles of 16 lanes or of 128 rows
    if nfam > 65535 // 4 or 9 * B > 128 * 65535:
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
    if tab.device.type == "cpu":
        return out_leg_plain(tab, G)
    if tab.device.type != "cuda":
        raise RuntimeError(f"out_leg: no kernel for device {tab.device}")
    _check_kernel_shape(tab, G)
    B, _, nfam, _, _ = tab.shape
    sched = schedule(B, nfam, G.shape[-1],
                     build.sm_count(tab.device.index or 0))
    return _launch(tab, G, sched)


def _launch(tab: torch.Tensor, G: torch.Tensor, sched: int) -> torch.Tensor:
    """One launch of the kernel in schedule sched (one of SCHEDULES), on
    tensors that _check and _check_kernel_shape passed."""
    B, _, nfam, _, K = tab.shape
    O = G.shape[-1]
    out = torch.empty((B, nfam, 3, 3, O), dtype=torch.float64,
                      device=tab.device)
    with torch.cuda.device(tab.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = build.lib().rt_out_leg(tab.data_ptr(), G.data_ptr(),
                                        out.data_ptr(), B, nfam, K, O,
                                        G.stride(0), G.stride(1), sched,
                                        stream)
    build.check(status, "out_leg")
    counts.LAUNCHES["out_leg"] += 1
    SCHEDULE_LAUNCHES[sched] = SCHEDULE_LAUNCHES.get(sched, 0) + 1
    return out
