"""State carried across from the JAX package (given as numpy arrays).

`model_from_numpy` turns a prepared JAX `Model` (redtime_tpu/model.py:
31-58; one cosmology or a vmapped batch) into the port's batched `Model`,
and `linear_from_numpy` does the same for `LinearData`, so both packages
compute the same thing from the same state in the tests.  Both accept any
object with the right fields whose leaves numpy can read; nothing here
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from redtime_tpu_torch.config import CosmoParams
from redtime_tpu_torch.io.camb import LinearData
from redtime_tpu_torch.model import Model

F64 = torch.float64


def _tensor(x, device) -> torch.Tensor:
    arr = np.array(x.cpu() if hasattr(x, "cpu") else x, dtype=np.float64)
    return torch.as_tensor(arr, dtype=F64, device=device)


def linear_from_numpy(lin, device="cpu") -> LinearData:
    """LinearData with f64 tensors on `device` and a leading batch
    dimension (one added when the input holds a single cosmology)."""
    single = np.ndim(lin.t_lnk) == 1
    out = [_tensor(x, device) for x in lin]
    if single:
        out = [x[None] for x in out]
    return LinearData(*out)


def cosmo_from_numpy(c, device="cpu") -> CosmoParams:
    """CosmoParams with [B] f64 tensors (B = 1 for a single cosmology)."""
    return CosmoParams(*[_tensor(x, device).reshape(-1) for x in c])


def model_from_numpy(fields, device="cpu") -> Model:
    """The port's batched Model from a JAX Model (single or batched)."""
    single = np.ndim(fields.norm) == 0
    take = (lambda x: _tensor(x, device)[None]) if single else \
        (lambda x: _tensor(x, device))
    return Model(
        cosmo=cosmo_from_numpy(fields.cosmo, device),
        g_lna=take(fields.g_lna), g_G=take(fields.g_G),
        g_dDda=take(fields.g_dDda), g_Dnorm=take(fields.g_Dnorm),
        beta_a=take(fields.beta_a), beta_solver=take(fields.beta_solver),
        T_solver=take(fields.T_solver), norm=take(fields.norm),
        sigmaV2_z0=take(fields.sigmaV2_z0))
