"""redtime_tpu_torch — the Time-RG cosmology solver in PyTorch and CUDA.

A port of `redtime_tpu` (the JAX package beside it, which stays the
reference) to PyTorch on an NVIDIA H100: Time-RG evolution of the
nonlinear P_dd/P_dt/P_tt power spectra for CDM+baryons with CPL dark
energy and massive neutrinos, with the TNS A(k,mu) columns.  It runs
full Time-RG (`RunSettings(one_loop=False)`), 1-loop mode (the default)
and the linear mode through `driver.run_batch`, with every PRINT* output
column.  `dd` and `probes` port the double-double helpers and the Pallas
feasibility probes (`python -m redtime_tpu_torch.probes` on a card).

Design: plain functions on f64 tensors with an explicit `device`; a batch
of cosmologies is a leading tensor dimension (the JAX package's vmap
written out), and every adaptive integrator runs one controller per lane.
The engine's output and PZ legs, the RK controller tail and the three
probe kernels are hand-written Hopper kernels (`kernels/`, sources in
`csrc/`); on CPU tensors their plain PyTorch versions run instead.

This package never imports JAX.
"""

from redtime_tpu_torch.config import CosmoParams, RunSettings, SolverConfig  # noqa: F401
from redtime_tpu_torch.driver import (  # noqa: F401
    prepare_model, run_batch, settings_from_params, solve,
)

__version__ = "0.1.0"
