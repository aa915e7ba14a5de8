"""Launch counters of the hand-written kernels.

Each wrapper adds one to its counter where it launches its kernel on the
card, and nowhere else (the plain PyTorch path on CPU tensors does not
count), so a run can show that the main path went through the kernels.
"""

from __future__ import annotations

LAUNCHES = {"out_leg": 0, "pz_leg": 0, "rk_finish": 0, "affine": 0,
            "int8_dot": 0, "dd_mul": 0}


def reset() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def snapshot() -> dict:
    return dict(LAUNCHES)
