"""The reference's float dtype: float64, or a lower one for a control."""

from __future__ import annotations

import functools
import sys

import torch


def use(dtype: torch.dtype, keep: tuple = ()) -> None:
    """Set every reference module's F64 (and rk_finish's _F64) to dtype,
    those named in `keep` (e.g. "ode") to float64, and empty the
    modules' caches, so later calls build in their dtype."""
    for name, mod in list(sys.modules.items()):
        if not name.startswith("rtbench.rtref.") or mod is None:
            continue
        here = (torch.float64 if name[len("rtbench.rtref."):] in keep
                else dtype)
        for attr in ("F64", "_F64"):
            if hasattr(mod, attr):
                setattr(mod, attr, here)
        for obj in list(vars(mod).values()):
            if isinstance(obj, functools._lru_cache_wrapper):
                obj.cache_clear()
