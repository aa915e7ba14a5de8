"""K3 rk_finish: the tail of one embedded-RK controller attempt (Triton).

Given the state y [B, D], the stage stack ks [s, B, D] (each stage already
evaluated at the clipped step) and per-lane t, h, t1, n and an `active`
mask, one attempt finishes as in redtime_tpu/ode.py:161-181 under a
vmapped while_loop:

    dt = t1 - t;  final = h > dt;  h_try = final ? dt : h
    y_new = y + h_try * sum_j b_j k_j     (stages summed in index order)
    yerr  = h_try * sum_j e_j k_j
    r     = max_i |yerr_i| / (eabs + erel |y_new_i|)      per lane
    GSL's standard controller: r > 1.1 rejects with
    h *= max(0.9 r^(-1/ord), 0.2); r < 0.5 grows h by
    clip(0.9 r^(-1/(ord+1)), 1, 5); the accepted step lands on t1 when final.

Lanes that are not active stay frozen (y, t, h and the attempt count n
unchanged).  Returns (y_out, t_out, h_out, n_out, r).

On the TPU this tail was part of XLA's while_loop fusion.  On the card it
is a fused elementwise pass plus one max-reduction per lane over D = 41 nk
elements (~5k at nk=128): memory-bound on reading s + 1 rows of D f64 per
lane.  One program per lane reads each stage row once to find r, decides
the lane's step, and re-reads the rows to write the chosen state, so no
y_new or yerr array is ever written to device memory.  FMA contraction is
off: every product and sum rounds once, as in the plain version (and the
JAX controller), so the error norm r — which divides by eabs + erel|y_new|
and so amplifies the rounding of a cancelling y + h sum b k — and with it
every accept/reject decision match the plain version.
"""

from __future__ import annotations

import torch

from redtime_tpu_torch.kernels import counts

_KERNEL = None
BLOCK = 1024


# GSL's standard-controller constants: safety factor, reject-above and
# grow-below thresholds, smallest and largest step factors
SAFETY, REJECT_ABOVE, GROW_BELOW, FAC_MIN, FAC_MAX = 0.9, 1.1, 0.5, 0.2, 5.0


def controller_params(eabs: float, erel: float, order: int,
                      device) -> torch.Tensor:
    """The controller's scalars as one f64 tensor [9]: eabs, erel, the
    step-factor exponents -1/ord and -1/(ord+1), and the constants above.
    The Triton kernel reads them from memory because Triton rounds Python
    float literals to f32 (0.9 would become 0.8999999762)."""
    return torch.tensor([eabs, erel, -1.0 / order, -1.0 / (order + 1.0),
                         SAFETY, REJECT_ABOVE, GROW_BELOW, FAC_MIN, FAC_MAX],
                        dtype=torch.float64, device=device)


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


def _kernel():
    """Compile-on-first-use Triton kernel (triton is imported here, not at
    module import, so the module loads where triton is absent)."""
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl
    import triton.language.extra.libdevice as tld

    @triton.jit
    def rk_finish_kernel(y_ptr, ks_ptr, t_ptr, h_ptr, t1_ptr, n_ptr,
                         act_ptr, b_ptr, e_ptr, prm_ptr,
                         y_out_ptr, t_out_ptr, h_out_ptr, n_out_ptr,
                         r_out_ptr, D, stage_stride,
                         S: tl.constexpr, BLOCK: tl.constexpr):
        lane = tl.program_id(0)
        row = lane.to(tl.int64) * D
        t = tl.load(t_ptr + lane)
        h = tl.load(h_ptr + lane)
        t1 = tl.load(t1_ptr + lane)
        n = tl.load(n_ptr + lane)
        act = tl.load(act_ptr + lane) != 0
        eabs = tl.load(prm_ptr + 0)
        erel = tl.load(prm_ptr + 1)
        p_dec = tl.load(prm_ptr + 2)
        p_inc = tl.load(prm_ptr + 3)
        safety = tl.load(prm_ptr + 4)
        reject_above = tl.load(prm_ptr + 5)
        grow_below = tl.load(prm_ptr + 6)
        fac_min = tl.load(prm_ptr + 7)
        fac_max = tl.load(prm_ptr + 8)
        dt = t1 - t
        final = h > dt
        h_try = tl.where(final, dt, h)

        # pass 1: the lane's error norm (NaN-propagating like jnp.max)
        qmax = tl.zeros([BLOCK], dtype=tl.float64)
        qnan = tl.zeros([BLOCK], dtype=tl.int32)
        for start in range(0, D, BLOCK):
            offs = start + tl.arange(0, BLOCK)
            mask = offs < D
            y = tl.load(y_ptr + row + offs, mask=mask, other=0.0)
            acc_b = tl.zeros([BLOCK], dtype=tl.float64)
            acc_e = tl.zeros([BLOCK], dtype=tl.float64)
            for j in tl.static_range(S):
                k = tl.load(ks_ptr + j * stage_stride + row + offs,
                            mask=mask, other=0.0)
                if j == 0:
                    acc_b = tl.load(b_ptr + j) * k
                    acc_e = tl.load(e_ptr + j) * k
                else:
                    acc_b = acc_b + tl.load(b_ptr + j) * k
                    acc_e = acc_e + tl.load(e_ptr + j) * k
            y_new = y + h_try * acc_b
            yerr = h_try * acc_e
            q = tl.abs(yerr) / (eabs + erel * tl.abs(y_new))
            q = tl.where(mask, q, 0.0)
            qnan = tl.maximum(qnan, (q != q).to(tl.int32))
            qmax = tl.maximum(qmax, tl.where(q != q, 0.0, q))
        r = tl.max(qmax, axis=0)
        r = tl.where(tl.max(qnan, axis=0) > 0, float("nan"), r)

        dec = r > reject_above
        fac_dec = tl.maximum(safety * tld.pow(r, p_dec), fac_min)
        fac_inc = tl.minimum(tl.maximum(safety * tld.pow(r, p_inc), 1.0),
                             fac_max)
        fac = tl.where(dec, fac_dec, tl.where(r < grow_below, fac_inc, 1.0))
        h_next = h_try * fac
        t_acc = tl.where(final, t1, t + h_try)
        t_new = tl.where(dec, t, t_acc)
        tl.store(t_out_ptr + lane, tl.where(act, t_new, t))
        tl.store(h_out_ptr + lane, tl.where(act, h_next, h))
        tl.store(n_out_ptr + lane, n + act.to(tl.int64))
        tl.store(r_out_ptr + lane, r)
        take = act & (dec == 0)

        # pass 2: write the chosen state (same arithmetic as pass 1)
        for start in range(0, D, BLOCK):
            offs = start + tl.arange(0, BLOCK)
            mask = offs < D
            y = tl.load(y_ptr + row + offs, mask=mask, other=0.0)
            acc_b = tl.zeros([BLOCK], dtype=tl.float64)
            for j in tl.static_range(S):
                k = tl.load(ks_ptr + j * stage_stride + row + offs,
                            mask=mask, other=0.0)
                if j == 0:
                    acc_b = tl.load(b_ptr + j) * k
                else:
                    acc_b = acc_b + tl.load(b_ptr + j) * k
            y_new = y + h_try * acc_b
            tl.store(y_out_ptr + row + offs, tl.where(take, y_new, y),
                     mask=mask)

    _KERNEL = rk_finish_kernel
    return _KERNEL


def _check(y, ks, t, h, t1, n, active, b, e, prm) -> None:
    if y.dim() != 2 or ks.dim() != 3 or ks.shape[1:] != y.shape:
        raise ValueError(f"rk_finish: need y [B, D] and ks [s, B, D], got "
                         f"{tuple(y.shape)} and {tuple(ks.shape)}")
    B, s = y.shape[0], ks.shape[0]
    for name, x in (("t", t), ("h", h), ("t1", t1), ("n", n),
                    ("active", active)):
        if x.shape != (B,):
            raise ValueError(f"rk_finish: {name} must be [{B}], got "
                             f"{tuple(x.shape)}")
    for name, x, want in (("b", b, (s,)), ("e", e, (s,)), ("prm", prm, (9,))):
        if x.shape != want:
            raise ValueError(f"rk_finish: {name} must be {list(want)}")
    for name, x in (("y", y), ("ks", ks), ("t", t), ("h", h), ("t1", t1),
                    ("b", b), ("e", e), ("prm", prm)):
        if x.dtype != torch.float64:
            raise TypeError(f"rk_finish: {name} must be float64, got "
                            f"{x.dtype}")
    if n.dtype != torch.int64 or active.dtype != torch.bool:
        raise TypeError("rk_finish: n must be int64 and active bool")
    for name, x in (("y", y), ("ks", ks), ("t", t), ("h", h), ("t1", t1),
                    ("n", n), ("active", active), ("b", b), ("e", e),
                    ("prm", prm)):
        if not x.is_contiguous():
            raise ValueError(f"rk_finish: {name} must be contiguous")
        if x.device != y.device:
            raise ValueError("rk_finish: inputs on different devices")


def rk_finish(y, ks, t, h, t1, n, active, b, e, prm):
    """One controller attempt's tail: the Triton kernel for CUDA tensors,
    the plain version for CPU tensors.  b, e: the tableau's weights [s];
    prm: controller_params."""
    _check(y, ks, t, h, t1, n, active, b, e, prm)
    if y.device.type == "cpu":
        return rk_finish_plain(y, ks, t, h, t1, n, active, b, e, prm)
    if y.device.type != "cuda":
        raise RuntimeError(f"rk_finish: no kernel for device {y.device}")
    B, D = y.shape
    kern = _kernel()
    y_out = torch.empty_like(y)
    t_out, h_out, r = (torch.empty_like(t) for _ in range(3))
    n_out = torch.empty_like(n)
    with torch.cuda.device(y.device):
        kern[(B,)](y, ks, t, h, t1, n, active.view(torch.uint8), b, e, prm,
                   y_out, t_out, h_out, n_out, r, D, B * D,
                   S=ks.shape[0], BLOCK=BLOCK, num_warps=4,
                   enable_fp_fusion=False)
    counts.LAUNCHES["rk_finish"] += 1
    return y_out, t_out, h_out, n_out, r
