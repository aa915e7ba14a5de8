"""The Pallas feasibility probes of scripts/probe_pallas.py, on the card.

    python -m redtime_tpu_torch.probes

runs, on `cuda`, with the JAX probes' inputs (the same shapes, dtypes and
numpy seeds) and criteria:

  1. K4 affine:   o = 2x + 1 on an [8, 128] f32 tile, allclose to 2x+1;
  2. K5 int8_dot: int8 [128, 512] @ [512, 256] -> int32, equal to the
                  int32 product;
  3. K6 dd_mul:   the double-double product of [8, 128] (hi, lo) pairs,
                  hi + lo within 1e-13 relative of x*y;
  4. K7 oz_fused: probe4's fused Ozaki product, (xh, xl) f32 [2016, 1024]
                  (x standard normal from seed 2, split as pallas_path's
                  caller splits it) with four int8 [1024, 256] W from
                  integers(-64, 64), within 1e-13 of max|ref| of
                  oz_xla_path, the f64 counterpart of probe4's xla_path;
                  on the card main() also prints the in-loop time of both
                  (30 calls, 3 rounds), as the JAX probe does;

and, after them, probe4_out_leg: K1 out_leg (the main path's output leg,
redtime_tpu/fastpt.py:1228, which has no Pallas kernel) at probe4's shape,
M = 2016 rows (16 lanes x 14 families x 9 pairs), K = 1024, O = 256,
within the f64 dot product's forward-error bound of its plain version.

It prints one line per probe.  A failed probe raises and the process
exits non-zero; nothing is caught.  On CPU tensors (`device="cpu"`) the
probes run the kernels' plain versions.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from redtime_tpu_torch import dd
from redtime_tpu_torch.kernels import out_leg as k1
from redtime_tpu_torch.kernels import probes as kp

EPS = float(np.finfo(np.float64).eps)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"probe failed: {what}")


def probe1(device="cuda") -> dict:
    x = torch.arange(8 * 128, dtype=torch.float32,
                     device=device).reshape(8, 128)
    out = kp.affine(x).cpu().numpy()
    _require(np.allclose(out, x.cpu().numpy() * 2 + 1),
             "probe1: affine differs from 2x+1")
    return dict(shape=list(x.shape))


def probe2(device="cuda") -> dict:
    rng = np.random.default_rng(0)
    a = rng.integers(-64, 64, (128, 512)).astype(np.int8)
    b = rng.integers(-64, 64, (512, 256)).astype(np.int8)
    out = kp.int8_dot(torch.as_tensor(a, device=device),
                      torch.as_tensor(b, device=device)).cpu().numpy()
    ref = a.astype(np.int32) @ b.astype(np.int32)
    _require(out.dtype == np.int32 and np.array_equal(out, ref),
             "probe2: int8 dot mismatch")
    return dict(shape=[128, 512, 256])


def probe3(device="cuda") -> dict:
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 128)) * np.exp(rng.uniform(-8, 8, (8, 128)))
    y = rng.standard_normal((8, 128)) * np.exp(rng.uniform(-8, 8, (8, 128)))
    xh, xl = dd.from_f64(torch.as_tensor(x, device=device))
    yh, yl = dd.from_f64(torch.as_tensor(y, device=device))
    oh, ol = kp.dd_mul(xh, xl, yh, yl)
    got = dd.to_f64(oh, ol).cpu().numpy()
    rel = float(np.abs(got / (x * y) - 1.0).max())
    _require(rel < 1e-13, f"probe3: dd product max rel err {rel:.2e}")
    return dict(max_rel_err=rel)


def probe4_inputs(device="cuda") -> tuple:
    """probe4's x f64 [2016, 1024], its f32 split (xh, xl) and ws int8
    [4, 1024, 256], from the JAX probe's generator and order."""
    M, K, O = 2016, 1024, 256
    rng = np.random.default_rng(2)
    x = rng.standard_normal((M, K))
    ws = np.stack([rng.integers(-64, 64, (K, O)).astype(np.int8)
                   for _ in range(4)])
    xh = x.astype(np.float32)
    xl = (x - xh).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)
    return t(x), t(xh), t(xl), t(ws)


def probe4(device="cuda") -> dict:
    """K7 oz_fused against oz_xla_path, P4's own check."""
    x, xh, xl, ws = probe4_inputs(device)
    oh, ol = kp.oz_fused(xh, xl, ws)
    ref = kp.oz_xla_path(x, ws)
    got = oh.double() + ol.double()
    rel = float((got - ref).abs().max() / ref.abs().max())
    _require(bool(torch.isfinite(got).all()), "probe4: non-finite output")
    _require(rel < 1e-13, f"probe4: fused vs XLA path {rel:.2e} of max")
    return dict(M=x.shape[0], K=x.shape[1], O=ws.shape[2],
                agreement=rel)


def probe4_out_leg(device="cuda") -> dict:
    """K1 at probe4's shape against its plain version."""
    B, nfam, K, O = 16, 14, 1024, 256
    rng = np.random.default_rng(2)
    tab = torch.as_tensor(rng.standard_normal((B, 2, nfam, 3, K)),
                          device=device)
    G = torch.as_tensor(rng.standard_normal((nfam, K, O)), device=device)
    J = k1.out_leg(tab, G)
    J_ref = k1.out_leg_plain(tab, G)
    prod = tab[:, 0, :, :, None, :] * tab[:, 1, :, None, :, :] / K
    bound = 2 * K * EPS * torch.matmul(
        prod.abs().reshape(B, nfam, 9, K), G.abs()).reshape(J.shape)
    err = (J - J_ref).abs()
    _require(bool(torch.isfinite(J).all()),
             "probe4_out_leg: non-finite output")
    _require(bool((err <= bound).all()),
             "probe4_out_leg: max |delta|/bound "
             f"{float((err / bound).max()):.3g}")
    return dict(M=B * nfam * 9, K=K, O=O, max_abs_err=float(err.max()))


def inloop_ms(fn, n: int = 30, reps: int = 3) -> float:
    """ms a call of fn() over `reps` rounds of `n` calls, between CUDA
    events after one warm-up call (probe_pallas.py's inloop)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps * n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * n)


def probe4_inloop() -> dict:
    """The in-loop time of probe4's two paths on the card, each from x f64
    (the fused path splits it into (xh, xl) first, as the JAX probe's
    loop does)."""
    x, _, _, ws = probe4_inputs("cuda")
    t_xla = inloop_ms(lambda: kp.oz_xla_path(x, ws))
    t_fused = inloop_ms(lambda: kp.oz_fused(*dd.from_f64(x), ws))
    return dict(xla_ms=t_xla, fused_ms=t_fused, speedup=t_xla / t_fused)


PROBES = (probe1, probe2, probe3, probe4, probe4_out_leg)


def main() -> int:
    if not torch.cuda.is_available():
        print("probes: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}")
    for p in PROBES:
        out = p("cuda")
        torch.cuda.synchronize()
        print(f"{p.__name__}: OK {out}")
    t = probe4_inloop()
    print(f"probe4 in-loop: XLA path {t['xla_ms']:.4f} ms  fused (K7) "
          f"{t['fused_ms']:.4f} ms  speedup {t['speedup']:.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
