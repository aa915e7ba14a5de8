"""Write the JAX goldens that chip_smoke.py holds the PyTorch port against.

Runs the JAX package on the CPU over lanes 0-1 of the bench's Mira-Titan
Latin-hypercube design (mapped as in bench.py) on the synthetic linear
inputs of __graft_entry__._example_inputs, at SolverConfig() widths
(nk=128, np=512, RKF45 at eabs 1e-7 / erel 1e-2, f64), and stores the
inputs and the tables:

  * --case full (the default): full Time-RG (RunSettings(one_loop=False))
    with the bench's headline output redshifts, design
    latin_hypercube(16, seed=42), into
    tests/data/torch_port_golden_nk128.npz (~0.3 MB);
  * --case oneloop: the bench's secondary workload, 1-loop mode
    (RunSettings(one_loop=True)) at its redshifts (5, 4, 3, 2, 1, 0.5, 0),
    with SolverConfig(print_bias=True) (the 22 P_B/PT/PMR columns),
    design latin_hypercube(32, seed=42), into
    tests/data/torch_port_golden_oneloop_nk128.npz;
  * --case high_accuracy / v01_compat: the two presets at their full
    settings, SolverConfig.high_accuracy() (nk=512, np=2048, eabs 1e-15,
    erel 1e-6) and SolverConfig.v01_compat() (nk=256, np_factor 8,
    growth_n_lnk 1000, a_early 1e-50, growth_h_reset), 1-loop mode at
    z_out (1, 0), design latin_hypercube(16, seed=42), into
    tests/data/torch_port_golden_{high_accuracy,v01_compat}.npz;
  * --case numerics: the off-by-default numerics,
    SolverConfig(growth_dense=True, quad_impl='gl'), 1-loop at the
    1-loop redshifts, design latin_hypercube(16, seed=42), into
    tests/data/torch_port_golden_numerics.npz;
  * --case production: the emulator-production chain for the first 2
    models of design.generate_design(N_PROD=16, seed=42): the two-pass
    CAMB orchestration of scripts/run_redtime.py with tests/mock_camb.py,
    the 33 CAMB redshifts as outputs (full Time-RG, switches 1 0 1 1),
    the JAX CLI's batch, convert at the 8 HACC steps, convert-full at
    step 499 over chip_smoke.write_nbody_spectra's spectra, and the
    injected-linear rerun (inject.load_injected on the two tables, then
    run_batch with norm_override).  Stores the 8 HACC blocks of the
    tables and of the rerun, their headers, and the convert outputs,
    into tests/data/torch_port_golden_production.npz (~0.3 MB).

    JAX_PLATFORMS=cpu python scripts/gen_torch_port_golden.py \
        [--case full|oneloop|high_accuracy|v01_compat|numerics|production]

Prints the seconds the JAX run took.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

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
# name -> (SolverConfig maker, its fields, RunSettings fields, design
# size, file)
CASES = {
    "full": (SolverConfig, dict(), dict(one_loop=False, z_out=(
        2.02, 1.61, 1.01, 0.66, 0.43, 0.24, 0.10, 0.0)), 16,
        "torch_port_golden_nk128.npz"),
    "oneloop": (SolverConfig, dict(print_bias=True), dict(
        one_loop=True, z_out=(5.0, 4.0, 3.0, 2.0, 1.0, 0.5, 0.0)), 32,
        "torch_port_golden_oneloop_nk128.npz"),
    "high_accuracy": (SolverConfig.high_accuracy, dict(), dict(
        one_loop=True, z_out=(1.0, 0.0)), 16,
        "torch_port_golden_high_accuracy.npz"),
    "v01_compat": (SolverConfig.v01_compat, dict(), dict(
        one_loop=True, z_out=(1.0, 0.0)), 16,
        "torch_port_golden_v01_compat.npz"),
    "numerics": (SolverConfig, dict(growth_dense=True, quad_impl="gl"),
                 dict(one_loop=True, z_out=(5.0, 4.0, 3.0, 2.0, 1.0, 0.5,
                                            0.0)), 16,
                 "torch_port_golden_numerics.npz"),
}
PRODUCTION = "torch_port_golden_production.npz"


def design_params(n: int, seed: int = SEED) -> np.ndarray:
    """[n, 9] cosmologies (n_s, sigma_8, h, Omega_m, Omega_b, Omega_nu,
    T_cmb, w0, wa) of the bench's design (bench.py _design_cosmo)."""
    rows = design.models_from_unit_cube(design.latin_hypercube(n, seed=seed))
    om_m, om_b, s8, h, ns, w0, wa, om_nu = rows.T
    return np.stack([ns, s8, h, om_m / h ** 2, om_b / h ** 2,
                     om_nu / h ** 2, np.full(n, 2.726), w0, wa], axis=1)


def main(case: str) -> None:
    make, cfg_kw, settings_kw, n_design, name = CASES[case]
    out = os.path.join(DATA, name)
    cfg = make(fft_mode="fft", **cfg_kw)
    settings = RunSettings(**settings_kw)
    params = design_params(n_design)[:LANES]
    lin = _example_inputs(cfg)
    cosmos = CosmoParams(*[jnp.asarray(params[:, i]) for i in range(9)])
    lins = jax.tree_util.tree_map(
        lambda x: jnp.stack([jnp.asarray(x)] * LANES), lin)
    t0 = time.perf_counter()
    res = driver.run_batch(cfg, settings, cosmos, lins, mode="fft")
    np.asarray(res.table)
    seconds = time.perf_counter() - t0
    np.savez_compressed(
        out, params=params, z_out=np.asarray(settings.z_out),
        t_lnk=lin.t_lnk, t_Tc=lin.t_Tc, t_Tb=lin.t_Tb, beta_a=lin.beta_a,
        beta_k=lin.beta_k, beta_raw=lin.beta_raw,
        table=np.asarray(res.table), sigma_v2=np.asarray(res.sigma_v2),
        H=np.asarray(res.H), sigmaV2_z0=np.asarray(res.sigmaV2_z0))
    print(f"wrote {out}: table {np.asarray(res.table).shape}; the JAX "
          f"run took {seconds:.1f} s on the CPU")


def production(work: str) -> None:
    """The --case production chain in `work` (see the module doc)."""
    import chip_smoke
    from redtime_tpu import inject
    from redtime_tpu.convert import STEP_TO_ZBLOCK, convert_pk_full, convert_pt

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import run_redtime

    os.environ["JAX_CACHE_DIR"] = os.path.join(work, "jax_cache")
    design.generate_design(os.path.join(work, "design.dat"),
                           chip_smoke.N_PROD, seed=SEED)
    with open(os.path.join(work, "design.dat")) as f:
        lines = f.readlines()
    models = os.path.join(work, "models.dat")
    with open(models, "w") as f:        # the 5 header lines, M001, M002
        f.writelines(lines[:5 + LANES])
    zfile = os.path.join(work, "z.txt")
    with open(zfile, "w") as f:
        f.write(run_redtime.CAMB_Z_LIST + "\n")
    out = os.path.join(work, "out")
    t0 = time.perf_counter()
    rc = run_redtime.main(["--redshift-file", zfile, "--models-file", models,
                           "--output-dir", out, "--camb-exec",
                           chip_smoke.MOCK_CAMB, "--mode", "fft"])
    if rc != 0:
        raise SystemExit(f"scripts/run_redtime.py exited {rc}")
    names = [f"M{i + 1:03d}" for i in range(LANES)]
    tables = [os.path.join(out, f"redTime_{n}.dat") for n in names]
    steps = sorted(STEP_TO_ZBLOCK)
    blocks = [STEP_TO_ZBLOCK[s] for s in steps]
    cfg = SolverConfig(fft_mode="fft")
    full = np.stack([inject.read_output_blocks(t, cfg.nk) for t in tables])
    heads = [chip_smoke.read_headers(t) for t in tables]

    conv_k, conv_pk = [], []
    for step in steps:
        convert_pt(LANES, step, cfg.nk, models, out)
        step_dir = os.path.join(out, f"STEP{step}")
        conv_k.append(chip_smoke.read_outputs(step_dir, "k", LANES))
        conv_pk.append(chip_smoke.read_outputs(step_dir, "pk", LANES))
    nbody = os.path.join(work, "nbody")
    os.makedirs(nbody)
    pm_t, hacc_t = chip_smoke.write_nbody_spectra(nbody, LANES)
    full_dir = os.path.join(work, "full")
    convert_pk_full(models, chip_smoke.PROD_STEP_FULL, full_dir,
                    os.path.join(out, "redTime_M{model:03d}.dat"), pm_t,
                    hacc_t, nk_pt=cfg.nk, n_pm=chip_smoke.N_PM)
    full_k, full_pk, full_err = (chip_smoke.read_outputs(full_dir, tag, LANES)
                                 for tag in ("k", "pk", "err"))

    loaded = [inject.load_injected(
        cfg, os.path.join(out, f"params_redTime_{n}.dat"), t)
        for n, t in zip(names, tables)]
    settings, _ = driver.settings_from_params(loaded[0][0])
    cosmos = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[driver.settings_from_params(p)[1] for p, _, _ in loaded])
    lins = jax.tree_util.tree_map(lambda *xs: jnp.stack(
        [jnp.asarray(x) for x in xs]), *[lin for _, lin, _ in loaded])
    rerun = driver.run_batch(cfg, settings, cosmos, lins, mode="fft",
                             norm_override=np.array([n for *_, n in loaded]))
    seconds = time.perf_counter() - t0
    dest = os.path.join(DATA, PRODUCTION)
    np.savez_compressed(
        dest, design=np.loadtxt(models, usecols=range(1, 9)),
        z_out=np.asarray(run_redtime.CAMB_Z_LIST.split(), dtype=np.float64),
        blocks=np.asarray(blocks), steps=np.asarray(steps),
        table=full[:, blocks], H=np.stack([h[0][blocks] for h in heads]),
        sigma_v2=np.stack([h[1][blocks] for h in heads]),
        sigmaV2_z0=np.array([h[2] for h in heads]),
        convert_k=np.array(conv_k), convert_pk=np.array(conv_pk),
        full_k=full_k, full_pk=full_pk, full_err=full_err,
        inject_norm=np.array([n for *_, n in loaded]),
        inject_table=np.asarray(rerun.table)[:, blocks],
        inject_H=np.asarray(rerun.H)[:, blocks],
        inject_sigma_v2=np.asarray(rerun.sigma_v2)[:, blocks],
        inject_sigmaV2_z0=np.asarray(rerun.sigmaV2_z0))
    print(f"wrote {dest}: tables {full.shape}, HACC blocks {blocks}; the "
          f"JAX chain took {seconds:.1f} s on the CPU")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=list(CASES) + ["production"],
                    default="full")
    case = ap.parse_args().case
    if case == "production":
        with tempfile.TemporaryDirectory() as tmp:
            production(tmp)
    else:
        main(case)
