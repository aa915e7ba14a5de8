"""Design-file generation: Latin-hypercube -> models file.

A jax-free copy of redtime_tpu/design.py (the mapping of
`misc/convert_katrin_hypercube.py`): 8 parameters with w_a encoded
through the Mira-Titan parameterization -(w0+wa)^(1/4) in [0.3, 1.29]
(reference :4-7, 26-29), sampled by a self-contained LHS, and written in
the reference's models-file format.
"""

from __future__ import annotations

from typing import IO, Optional

import numpy as np

RANGES_LOWER = np.array([0.12, 0.0215, 0.7, 0.55, 0.85, -1.3, 0.3, 0.0])
RANGES_UPPER = np.array([0.155, 0.0235, 0.9, 0.85, 1.05, -0.7, 1.29, 0.01])


def latin_hypercube(n: int, dim: int = 8,
                    seed: Optional[int] = None) -> np.ndarray:
    """Simple maximin-free LHS in [0,1]^dim (one stratum per sample/axis)."""
    rng = np.random.default_rng(seed)
    u = (np.argsort(rng.random((dim, n)), axis=1).T
         + rng.random((n, dim))) / n
    return u


def models_from_unit_cube(lhc: np.ndarray) -> np.ndarray:
    """Map unit-cube samples -> (om_m, om_b, s8, h, ns, w0, wa, om_nu),
    decoding wa from the -(w0+wa)^(1/4) coordinate (reference :26-29)."""
    vals = lhc * (RANGES_UPPER - RANGES_LOWER) + RANGES_LOWER
    out = vals.copy()
    out[:, 6] = -(vals[:, 6] ** 4) - vals[:, 5]    # wa
    return out


def write_models_file(f: IO[str], models: np.ndarray) -> None:
    """Emit the reference models-file format (header + M### rows)."""
    f.write("# Cosmological models (1 per line)\n#\n# Columns\n")
    f.write("#model  omega_m omega_b s8       h       ns      w0"
            "       wa       omega_nu\n#\n")
    for i, row in enumerate(models):
        f.write("M{:03d}".format(i + 1))
        for v in row:
            f.write("  " + str(v))
        f.write("\n")


def generate_design(path: str, n: int, seed: Optional[int] = 0) -> None:
    """Write an n-model Latin-hypercube design to `path`."""
    models = models_from_unit_cube(latin_hypercube(n, 8, seed))
    with open(path, "w") as f:
        write_models_file(f, models)
