"""Write the JAX golden that chip_smoke.py holds the PyTorch port against.

Runs the JAX package on the CPU, on the port's main path: SolverConfig()
(nk=128, np=512, RKF45 at eabs 1e-7 / erel 1e-2, f64), full Time-RG
(RunSettings(one_loop=False)) with the bench's output redshifts, over
lanes 0-1 of the bench's Mira-Titan Latin-hypercube design
(latin_hypercube(16, seed=42), mapped as in bench.py) on the synthetic
linear inputs of __graft_entry__._example_inputs.  Stores the inputs and
the tables in tests/data/torch_port_golden_nk128.npz (~0.3 MB).

    JAX_PLATFORMS=cpu python scripts/gen_torch_port_golden.py
"""

from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from __graft_entry__ import _example_inputs  # noqa: E402
from redtime_tpu import design, driver  # noqa: E402
from redtime_tpu.config import CosmoParams, RunSettings, SolverConfig  # noqa: E402

Z_OUT = (2.02, 1.61, 1.01, 0.66, 0.43, 0.24, 0.10, 0.0)
N_DESIGN, SEED, LANES = 16, 42, 2
OUT = os.path.join(ROOT, "tests", "data", "torch_port_golden_nk128.npz")


def design_params(n: int = N_DESIGN, seed: int = SEED) -> np.ndarray:
    """[n, 9] cosmologies (n_s, sigma_8, h, Omega_m, Omega_b, Omega_nu,
    T_cmb, w0, wa) of the bench's design (bench.py _design_cosmo)."""
    rows = design.models_from_unit_cube(design.latin_hypercube(n, seed=seed))
    om_m, om_b, s8, h, ns, w0, wa, om_nu = rows.T
    return np.stack([ns, s8, h, om_m / h ** 2, om_b / h ** 2,
                     om_nu / h ** 2, np.full(n, 2.726), w0, wa], axis=1)


def main() -> None:
    cfg = SolverConfig(fft_mode="fft")
    settings = RunSettings(one_loop=False, z_out=Z_OUT)
    params = design_params()[:LANES]
    lin = _example_inputs(cfg)
    cosmos = CosmoParams(*[jnp.asarray(params[:, i]) for i in range(9)])
    lins = jax.tree_util.tree_map(
        lambda x: jnp.stack([jnp.asarray(x)] * LANES), lin)
    res = driver.run_batch(cfg, settings, cosmos, lins, mode="fft")
    np.savez_compressed(
        OUT, params=params, z_out=np.asarray(Z_OUT),
        t_lnk=lin.t_lnk, t_Tc=lin.t_Tc, t_Tb=lin.t_Tb, beta_a=lin.beta_a,
        beta_k=lin.beta_k, beta_raw=lin.beta_raw,
        table=np.asarray(res.table), sigma_v2=np.asarray(res.sigma_v2),
        H=np.asarray(res.H), sigmaV2_z0=np.asarray(res.sigmaV2_z0))
    print(f"wrote {OUT}: table {np.asarray(res.table).shape}")


if __name__ == "__main__":
    main()
