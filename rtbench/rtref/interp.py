"""Table interpolation with the reference's exact rules.

Reproduces the semantics of the reference's `tabulated_function`
(`src/AU_tabfun.h:250-328`) and the `AU_interp.h` primitives:

  * bracketing: n = first index with nodes[n+1] >= x, capped to [0, size-2];
  * interior (0 < n < size-2): 4-point Lagrange cubic on nodes [n-1 .. n+2];
  * edges (n == 0 or n == size-2): linear on nodes [n, n+1], which linearly
    extrapolates beyond either end.

Two flavors:
  * torch functions for evaluation points known only at run time; nodes
    are either one shared 1-D axis or a batch of axes [B, nn] with one
    query per lane;
  * numpy weight-matrix builders for static evaluation points (fixed
    k-grids), which turn interpolation into a static matmul.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def _consts(device: torch.device, dtype: torch.dtype):
    """Small constants on device, made once: arange(4); the rows
    (eye(4)[o], eye(4)[o + 1]) of each offset o = 0, 1, 2 [3, 2, 4]; and
    [4, 3] whose row j lists the nodes l != j in increasing order (the
    factors of _lagrange4's weight j)."""
    eye = torch.eye(4, dtype=dtype, device=device)
    return (torch.arange(4, device=device),
            torch.stack([eye[:3], eye[1:]], dim=1),
            torch.tensor([[l for l in range(4) if l != j] for j in range(4)],
                         device=device))


def _lagrange4(xs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Weights [..., 4] of 4-point Lagrange interpolation at x [...] on
    nodes xs [..., 4] (same operation order as the JAX package: weight j
    is ((1 (x - xs_l) / (xs_j - xs_l)) ...) over l != j in increasing
    order), the four weights at once."""
    xl = xs[..., _consts(x.device, xs.dtype)[2]]          # [..., 4, 3]
    num = torch.ones_like(xs)
    for s in range(3):
        num = num * (x[..., None] - xl[..., s]) / (xs - xl[..., s])
    return num


def _take(nodes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """nodes[idx] for a shared axis [nn], or per lane for nodes [B, nn]
    with idx [B, ...]."""
    if nodes.dim() == 1:
        return nodes[idx]
    flat = idx.reshape(idx.shape[0], -1)
    return torch.gather(nodes, 1, flat).reshape(idx.shape)


def axis_weights(nodes: torch.Tensor, x: torch.Tensor):
    """Bracketing + branch weights for one axis at query points x.

    nodes: [nn] shared, or [B, nn] with x [B, ...].  Returns (i0, w) with
    i0 [...] int64 and w [..., 4] such that
    f(x) = sum_j w[..., j] * f_nodes[i0 + j].  Requires nn >= 4."""
    nn = nodes.shape[-1]
    if nodes.dim() == 1:
        pos = torch.searchsorted(nodes, x, side="left")
    else:
        flat = x.reshape(x.shape[0], -1).contiguous()
        pos = torch.searchsorted(nodes, flat, side="left").reshape(x.shape)
    n = torch.clamp(pos - 1, 0, nn - 2)
    cubic = (n > 0) & (n < nn - 2)
    i0 = torch.clamp(n - 1, 0, nn - 4)
    ar, eye_pairs, _ = _consts(x.device, nodes.dtype)
    xs = _take(nodes, i0[..., None] + ar)
    wc = _lagrange4(xs, x)
    xn, xn1 = _take(nodes, n), _take(nodes, n + 1)
    t = (x - xn) / (xn1 - xn)
    eye = eye_pairs[n - i0]        # eye(4)[off], eye(4)[off + 1], off = n - i0
    wl = (1.0 - t)[..., None] * eye[..., 0, :] + t[..., None] * eye[..., 1, :]
    return i0, torch.where(cubic[..., None], wc, wl)


def axis_weights_full(nodes: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """axis_weights spread over the full node axis: w_full [..., nn] with
    w_full[i0:i0+4] = w and zeros elsewhere, so a lookup is
    `w_full @ values`."""
    nn = nodes.shape[-1]
    i0, w = axis_weights(nodes, x)
    full = torch.zeros(x.shape + (nn,), dtype=w.dtype, device=x.device)
    idx = i0[..., None] + _consts(x.device, w.dtype)[0]
    return full.scatter_(-1, idx, w)


def interp1(nodes: torch.Tensor, values: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    """tabulated_function::f(x), elementwise over x.  nodes/values: [nn]
    shared, or [B, nn] per lane with x [B, ...]."""
    i0, w = axis_weights(nodes, x)
    f4 = _take(values, i0[..., None] + torch.arange(4, device=x.device))
    return (w * f4).sum(-1)


def interp1_vec(nodes: torch.Tensor, values: torch.Tensor,
                xs: torch.Tensor) -> torch.Tensor:
    """interp1 over a 1-D tensor of query points (the JAX package's vmapped
    form; interp1 here is elementwise already)."""
    return interp1(nodes, values, xs)


def interp2(x_nodes: torch.Tensor, y_nodes: torch.Tensor,
            table: torch.Tensor, x: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    """tabulated_function::f(x, y), elementwise over x and y of one shape.

    `table` has shape [len(x_nodes), len(y_nodes)] (C layout of the
    reference's fTable, AU_tabfun.h:435); each point reads its 4 x 4
    stencil and contracts it as wx @ block @ wy."""
    ix, wx = axis_weights(x_nodes, x)
    iy, wy = axis_weights(y_nodes, y)
    ar = torch.arange(4, device=x.device)
    block = table[(ix[..., None] + ar)[..., :, None],
                  (iy[..., None] + ar)[..., None, :]]       # [..., 4, 4]
    return ((wx[..., :, None] * block).sum(-2) * wy).sum(-1)


def axis_weights_np(nodes: np.ndarray, x: float):
    """numpy twin of axis_weights for a static point: (i0, w[4])."""
    nodes = np.asarray(nodes)
    nn = nodes.shape[0]
    n = int(np.clip(np.searchsorted(nodes, x, side="left") - 1, 0, nn - 2))
    i0 = int(np.clip(n - 1, 0, nn - 4))
    w = np.zeros(4)
    if 0 < n < nn - 2:
        xs = nodes[i0:i0 + 4]
        for j in range(4):
            num = 1.0
            for l in range(4):
                if l != j:
                    num *= (x - xs[l]) / (xs[j] - xs[l])
            w[j] = num
    else:
        t = (x - nodes[n]) / (nodes[n + 1] - nodes[n])
        w[n - i0] = 1.0 - t
        w[n - i0 + 1] = t
    return i0, w


def weight_matrix_np(nodes: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Dense weight matrix W [len(xs), len(nodes)]: f(xs) = W @ f_nodes."""
    nodes = np.asarray(nodes)
    W = np.zeros((len(xs), len(nodes)))
    for r, x in enumerate(np.asarray(xs)):
        i0, w = axis_weights_np(nodes, x)
        W[r, i0:i0 + 4] = w
    return W
