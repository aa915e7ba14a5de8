"""The Pallas feasibility probes of scripts/probe_pallas.py, on the card.

    python -m redtime_tpu_torch.probes

runs, on `cuda`, with the JAX probes' inputs (the same shapes, dtypes and
numpy seeds) and criteria:

  1. K4 affine:   o = 2x + 1 on an [8, 128] f32 tile, allclose to 2x+1;
  2. K5 int8_dot: int8 [128, 512] @ [512, 256] -> int32, equal to the
                  int32 product;
  3. K6 dd_mul:   the double-double product of [8, 128] (hi, lo) pairs,
                  hi + lo within 1e-13 relative of x*y;
  4. K1 out_leg (the port of probe4's fused output leg) at probe4's shape,
     M = 2016 rows (16 lanes x 14 families x 9 pairs), K = 1024, O = 256,
     within the f64 dot product's forward-error bound of its plain
     version.

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


def probe4(device="cuda") -> dict:
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
    _require(bool(torch.isfinite(J).all()), "probe4: non-finite output")
    _require(bool((err <= bound).all()),
             f"probe4: max |delta|/bound {float((err / bound).max()):.3g}")
    return dict(M=B * nfam * 9, K=K, O=O, max_abs_err=float(err.max()))


PROBES = (probe1, probe2, probe3, probe4)


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
    return 0


if __name__ == "__main__":
    sys.exit(main())
