"""LinearData, as redtime_tpu_torch.io.camb defines it."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class LinearData(NamedTuple):
    """Raw linear-theory inputs (numpy arrays or f64 tensors)."""

    t_lnk: np.ndarray      # [nT]  ln k of the z=0 transfer file
    t_Tc: np.ndarray       # [nT]  delta_c column
    t_Tb: np.ndarray       # [nT]  delta_b column
    beta_a: np.ndarray     # [nz]  scale factors of the transfer stack
    beta_k: np.ndarray     # [nkb] k nodes of the stack
    beta_raw: np.ndarray   # [nz, nkb]  delta_nu/delta_c
