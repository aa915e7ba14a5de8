"""K4 affine, K5 int8_dot, K6 dd_mul, K7 oz_fused: the Pallas feasibility
probes P1-P4 of scripts/probe_pallas.py as Hopper kernels (csrc/probes.cu,
csrc/oz_fused.cu).

  * affine(x)          — P1 (probe_pallas.py:29-38): 2x + 1 on f32;
  * int8_dot(a, b)     — P2 (:44-57): int8 [M,K] @ int8 [K,N] -> int32,
                         exact, on the int8 tensor cores;
  * dd_mul(ah, al, bh, bl) — P3 (:78-99): the double-double product
                         dd.mul of f32 (hi, lo) pairs;
  * oz_fused(xh, xl, ws) — P4 (:145-181): the fused Ozaki product of an
                         f32 pair [M,K] with four int8 [K,O]: six 7-bit
                         slices, six int8 dots, a double-double f32 sum;
                         on the card each call first packs W into the
                         operand tiles of its main loop (oz_pack_w).

Each kernel equals its plain version bit for bit (K7 for finite inputs).
oz_xla_path is P4's reference path (:120-142), in f64.
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

# P4's Ozaki split: SA slices of Q bits each (probe_pallas.py:130-131)
OZ_Q, OZ_SLICES = 7, 6
# |t| <= 2^6 and |w| <= 2^7, so an int32 sum over K is exact while
# K * 2^13 < 2^31
_OZ_MAX_K = 2 ** 31 // 2 ** 13 - 1


def _oz_row_exponent(xh: torch.Tensor) -> torch.Tensor:
    """exi [M, 1] int32: floor(log2 max|xh|) + 2 of each row, clipped to
    [-125, 125]; 2^-exi balances the row below 1/2."""
    mx = xh.abs().amax(dim=1, keepdim=True)
    ex = torch.floor(torch.log2(torch.clamp(mx, min=1e-38))) + 2.0
    return torch.clamp(ex, -125.0, 125.0).to(torch.int32)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^(e - 127) as f32, from its biased exponent e (int32)."""
    return (e << 23).view(torch.float32)


def _oz_slices(xh: torch.Tensor, xl: torch.Tensor, inv: torch.Tensor):
    """The six int8 slices of the balanced rows (xh, xl) * inv, in f32 as
    P4 peels them: slice i is round(r 2^(7(i+1))), half to even, and xl
    joins the residual after slice 2."""
    r = xh * inv
    for i in range(OZ_SLICES):
        sc = float(2.0 ** (OZ_Q * (i + 1)))
        t = torch.round(r * sc)
        r = r - t / sc
        if i == 2:
            r = r + xl * inv
        yield i, t.to(torch.int8)


def oz_fused_plain(xh: torch.Tensor, xl: torch.Tensor,
                   ws: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """P4's body (probe_pallas.py:145-181) in PyTorch f32 operations, in
    its order: (oh, ol) f32 [M, O] with oh + ol ~ (xh + xl) @ W, the dots
    through int8_dot_plain (exact).  ws is [4, K, O] int8; slice i meets
    ws[i % 4]."""
    exi = _oz_row_exponent(xh)
    toth = torch.zeros((xh.shape[0], ws.shape[2]), dtype=torch.float32,
                       device=xh.device)
    totl = torch.zeros_like(toth)
    for i, t in _oz_slices(xh, xl, _pow2(127 - exi)):
        o = int8_dot_plain(t, ws[i % 4])
        # int32 -> (hi, lo) f32, exact: hi rounds, the residual fits f32
        ch = o.to(torch.float32)
        cl = (o - ch.to(torch.int32)).to(torch.float32)
        s = float(2.0 ** (-OZ_Q * (i + 2)))
        ch, cl = ch * s, cl * s
        # (toth, totl) += (ch, cl): Knuth's two-sum on the hi words
        sh = toth + ch
        v = sh - toth
        e = (toth - (sh - v)) + (ch - v) + totl + cl
        toth = sh + e
        totl = e - (toth - sh)
    unscale = _pow2(exi + 127)
    return toth * unscale, totl * unscale


# K7's tiling (csrc/oz_fused.cu): K-steps of 32; a group of OZ_RANKS CTAs
# owns a tile of OZ_ROWS rows and OZ_RANKS * OZ_COLS columns; rank r peels
# rows 16r..16r+15 of the tile and multiplies all of them by its OZ_COLS
# columns; x is held in panels of up to OZ_PANEL columns; a tile's ring
# holds the slices of OZ_SLOTS K-steps (6 x OZ_ROWS x 32 bytes each), and
# its sync words are the ranks' two progress counters and the exponents
OZ_BK, OZ_RANKS, OZ_ROWS, OZ_COLS, OZ_PANEL, OZ_SLOTS = 32, 4, 64, 64, 1024, 16
OZ_SYNC = 2 * OZ_RANKS + OZ_ROWS


def oz_plan(M: int, K: int, O: int) -> dict:
    """K7's tiling at (M, K, O), as rt_oz_fused_plan computes it: K-steps
    KT, column groups, row tiles, O padded to whole column groups, the x
    panel's columns and the number of panels (one panel: x stays in shared
    memory and the row maxima come from it), and the sizes of the packed W
    and of the slice ring (bytes) and of the sync buffer (int32)."""
    kt = -(-K // OZ_BK)
    groups = -(-O // (OZ_RANKS * OZ_COLS))
    tiles = -(-M // OZ_ROWS)
    panel = OZ_BK if kt == 0 else min(kt * OZ_BK, OZ_PANEL)
    return dict(KT=kt, col_groups=groups, row_tiles=tiles,
                OP=groups * OZ_RANKS * OZ_COLS, panel=panel,
                npanel=1 if kt == 0 else -(-kt * OZ_BK // panel),
                wp_bytes=4 * kt * groups * OZ_RANKS * OZ_COLS * OZ_BK,
                ring_bytes=tiles * groups * OZ_SLOTS * OZ_SLICES * OZ_ROWS
                * OZ_BK,
                sync_words=tiles * groups * OZ_SYNC)


OZ_PLAN_KEYS = ("KT", "col_groups", "row_tiles", "OP", "panel", "npanel",
                "wp_bytes", "ring_bytes", "sync_words")


def oz_plan_on_card(M: int, K: int, O: int) -> dict:
    """rt_oz_fused_plan of the built library: oz_plan's keys as the kernel
    computes them, and the main kernel's threads and shared memory."""
    import ctypes

    out = (ctypes.c_longlong * 11)()
    build.lib().rt_oz_fused_plan(M, K, O, out)
    return dict(zip(OZ_PLAN_KEYS + ("threads", "smem_bytes"), out))


def oz_tile_byte(row, k):
    """The byte of (row, k) in one K-step's operand tile of K7's main loop
    (csrc/sm90.cuh tile_byte): K-major core matrices of 8 rows x 16 bytes,
    the two halves of a row's 32 K 128 bytes apart, groups of 8 rows 256
    bytes apart."""
    return (row // 8) * 256 + (k // 16) * 128 + (row % 8) * 16 + k % 16


def oz_pack_w_plain(ws: torch.Tensor) -> torch.Tensor:
    """ws [4, K, O] (any dtype) in the layout K7's main loop reads, as
    oz_pack_w_kernel writes it: [OP / 64, KT, 4, 8, 2, 8, 16], zero-padded
    to K-steps of 32 and to OP columns; element (b, kt, v, g, h, c, j) is
    ws[v, 32 kt + 16 h + j, 64 b + 8 g + c], so the four W tiles of 64
    columns a CTA takes in a K-step are one run of 8 KB, each the tile of
    oz_tile_byte (rows = columns)."""
    _, K, O = ws.shape
    plan = oz_plan(1, K, O)
    kt, op = plan["KT"], plan["OP"]
    w = torch.zeros((4, kt * OZ_BK, op), dtype=ws.dtype, device=ws.device)
    w[:, :K, :O] = ws
    return (w.reshape(4, kt, 2, 16, op // OZ_COLS, 8, 8)
            .permute(4, 1, 0, 5, 2, 6, 3).contiguous())


def oz_xla_path(x: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """P4's reference path (probe_pallas.py:120-142): x f64 [M, K] split
    into f32 (hi, lo), the same six slices and dots, each int32 sum scaled
    and added in f64; returns f64 [M, O]."""
    xh = x.to(torch.float32)
    xl = (x - xh.to(torch.float64)).to(torch.float32)
    exi = _oz_row_exponent(xh)
    inv = _pow2(127 - exi)
    tot = None
    for i, t in _oz_slices(xh, xl, inv):
        c = int8_dot_plain(t, ws[i % 4]).to(torch.float64) \
            * (2.0 ** (-OZ_Q * (i + 2)))
        tot = c if tot is None else tot + c
    return tot * (1.0 / inv.to(torch.float64))


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


def oz_fused(xh: torch.Tensor, xl: torch.Tensor,
             ws: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """P4's fused product: (xh, xl) f32 [M, K] and ws int8 [4, K, O] ->
    (oh, ol) f32 [M, O], bit-equal to oz_fused_plain for finite xh."""
    _check_f32("oz_fused", xh, xl)
    if xh.dim() != 2:
        raise ValueError(f"oz_fused: xh, xl must be 2-D, got "
                         f"{tuple(xh.shape)}")
    if ws.dtype != torch.int8:
        raise TypeError(f"oz_fused: ws must be int8, got {ws.dtype}")
    if ws.dim() != 3 or ws.shape[0] != 4 or not ws.is_contiguous():
        raise ValueError(f"oz_fused: ws must be a contiguous [4, K, O], got "
                         f"{tuple(ws.shape)}")
    (M, K), O = xh.shape, ws.shape[2]
    if ws.shape[1] != K:
        raise ValueError(f"oz_fused: shapes {tuple(xh.shape)} and "
                         f"{tuple(ws.shape)} do not chain")
    if ws.device != xh.device:
        raise ValueError("oz_fused: x and ws on different devices")
    if M == 0 or O == 0:
        raise ValueError(f"oz_fused: empty output [{M}, {O}]")
    if K > _OZ_MAX_K:
        raise ValueError(f"oz_fused: K={K} can overflow the int32 sums "
                         f"(K * 2^13 must stay below 2^31)")
    if not _device("oz_fused", xh):
        return oz_fused_plain(xh, xl, ws)
    # W is packed on every call (it is an input like x); the pack kernel
    # also zeroes the main kernel's sync words
    plan = oz_plan(M, K, O)
    sync = torch.empty(plan["sync_words"], dtype=torch.int32,
                       device=xh.device)
    wp = oz_pack_w(ws, sync)
    ring = torch.empty(plan["ring_bytes"], dtype=torch.uint8,
                       device=xh.device)
    oh = torch.empty((M, O), dtype=torch.float32, device=xh.device)
    ol = torch.empty_like(oh)
    with torch.cuda.device(xh.device):
        status = build.lib().rt_oz_fused(
            xh.data_ptr(), xl.data_ptr(), wp.data_ptr(), ring.data_ptr(),
            sync.data_ptr(), oh.data_ptr(), ol.data_ptr(), M, K, O,
            _stream(xh))
    build.check(status, "oz_fused")
    counts.LAUNCHES["oz_fused"] += 1
    return oh, ol


def oz_pack_w(ws: torch.Tensor,
              zero: torch.Tensor | None = None) -> torch.Tensor:
    """ws int8 [4, K, O] -> the packed W of K7's main loop (the layout of
    oz_pack_w_plain, int8); on the card by oz_pack_w_kernel, which also
    sets the int32 tensor `zero` (oz_fused's sync words) to 0."""
    if ws.dtype != torch.int8:
        raise TypeError(f"oz_pack_w: ws must be int8, got {ws.dtype}")
    if ws.dim() != 3 or ws.shape[0] != 4 or not ws.is_contiguous():
        raise ValueError(f"oz_pack_w: ws must be a contiguous [4, K, O], "
                         f"got {tuple(ws.shape)}")
    if not _device("oz_pack_w", ws):
        return oz_pack_w_plain(ws)
    _, K, O = ws.shape
    plan = oz_plan(1, K, O)
    wp = torch.empty((plan["OP"] // OZ_COLS, plan["KT"], 4, 8, 2, 8, 16),
                     dtype=torch.int8, device=ws.device)
    with torch.cuda.device(ws.device):
        status = build.lib().rt_oz_pack_w(
            ws.data_ptr(), wp.data_ptr(), K, O,
            0 if zero is None else zero.data_ptr(),
            0 if zero is None else zero.numel(), _stream(ws))
    build.check(status, "oz_pack_w")
    counts.LAUNCHES["oz_pack_w"] += 1
    return wp


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
