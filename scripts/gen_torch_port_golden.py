"""Write the JAX goldens that chip_smoke.py holds the PyTorch port against.

Runs the JAX package on the CPU over lanes 0-1 of the bench's Mira-Titan
Latin-hypercube design (mapped as in bench.py) on the synthetic linear
inputs of __graft_entry__._example_inputs, at SolverConfig() widths
(nk=128, np=512, RKF45 at eabs 1e-7 / erel 1e-2, f64), and stores the
inputs and the tables:

  * default: full Time-RG (RunSettings(one_loop=False)) with the bench's
    headline output redshifts, design latin_hypercube(16, seed=42), into
    tests/data/torch_port_golden_nk128.npz (~0.3 MB);
  * --oneloop: the bench's secondary workload, 1-loop mode
    (RunSettings(one_loop=True)) at its redshifts (5, 4, 3, 2, 1, 0.5, 0),
    with SolverConfig(print_bias=True) (the 22 P_B/PT/PMR columns),
    design latin_hypercube(32, seed=42), into
    tests/data/torch_port_golden_oneloop_nk128.npz.

    JAX_PLATFORMS=cpu python scripts/gen_torch_port_golden.py [--oneloop]
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

SEED, LANES = 42, 2
DATA = os.path.join(ROOT, "tests", "data")
# name -> (SolverConfig fields, RunSettings fields, design size, file)
CASES = {
    "full_trg": (dict(), dict(one_loop=False, z_out=(
        2.02, 1.61, 1.01, 0.66, 0.43, 0.24, 0.10, 0.0)), 16,
        "torch_port_golden_nk128.npz"),
    "oneloop": (dict(print_bias=True), dict(one_loop=True, z_out=(
        5.0, 4.0, 3.0, 2.0, 1.0, 0.5, 0.0)), 32,
        "torch_port_golden_oneloop_nk128.npz"),
}


def design_params(n: int, seed: int = SEED) -> np.ndarray:
    """[n, 9] cosmologies (n_s, sigma_8, h, Omega_m, Omega_b, Omega_nu,
    T_cmb, w0, wa) of the bench's design (bench.py _design_cosmo)."""
    rows = design.models_from_unit_cube(design.latin_hypercube(n, seed=seed))
    om_m, om_b, s8, h, ns, w0, wa, om_nu = rows.T
    return np.stack([ns, s8, h, om_m / h ** 2, om_b / h ** 2,
                     om_nu / h ** 2, np.full(n, 2.726), w0, wa], axis=1)


def main(case: str) -> None:
    cfg_kw, settings_kw, n_design, name = CASES[case]
    out = os.path.join(DATA, name)
    cfg = SolverConfig(fft_mode="fft", **cfg_kw)
    settings = RunSettings(**settings_kw)
    params = design_params(n_design)[:LANES]
    lin = _example_inputs(cfg)
    cosmos = CosmoParams(*[jnp.asarray(params[:, i]) for i in range(9)])
    lins = jax.tree_util.tree_map(
        lambda x: jnp.stack([jnp.asarray(x)] * LANES), lin)
    res = driver.run_batch(cfg, settings, cosmos, lins, mode="fft")
    np.savez_compressed(
        out, params=params, z_out=np.asarray(settings.z_out),
        t_lnk=lin.t_lnk, t_Tc=lin.t_Tc, t_Tb=lin.t_Tb, beta_a=lin.beta_a,
        beta_k=lin.beta_k, beta_raw=lin.beta_raw,
        table=np.asarray(res.table), sigma_v2=np.asarray(res.sigma_v2),
        H=np.asarray(res.H), sigmaV2_z0=np.asarray(res.sigmaV2_z0))
    print(f"wrote {out}: table {np.asarray(res.table).shape}")


if __name__ == "__main__":
    main("oneloop" if "--oneloop" in sys.argv[1:] else "full_trg")
