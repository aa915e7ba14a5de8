"""Production-pipeline demo, end to end, with no external dependencies (the
port of examples/production_batch/run_demo.py):

  1. generate a small Latin-hypercube design (design.generate_design);
  2. synthesize CAMB-format transfer stacks per model (an analytic
     stand-in: in production these come from CAMB through
     `python -m redtime_tpu_torch.orchestrate`);
  3. emit params_redTime files with the 33-redshift output list;
  4. solve all models in one batch (the CLI's `batch`);
  5. extract emulator (k, pk) files for one HACC step (convert.convert_pt).

The solve runs on the CUDA card unless `--platform cpu` asks for the CPU
(the JAX demo's default is the CPU); with no card it exits non-zero.

    python -m redtime_tpu_torch.demo [--workdir DIR] [--n-models 3]
                                     [--nk 128] [--platform cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def synth_transfer_stack(workdir, z_list, seed):
    """Write a CAMB-7-column-format transfer stack with a smooth CDM-like
    shape and a plausible neutrino suppression (stand-in for CAMB)."""
    rng = np.random.default_rng(seed)
    k = np.logspace(-5, 1.3, 800)
    keq = 0.014 + 0.004 * rng.random()
    T = 1.0 / (1.0 + (k / keq) ** 2 * np.log(1.0 + k / keq))
    for z in z_list:
        a = 1.0 / (1.0 + float(z))
        supp = 1.0 / (1.0 + (k / 0.12) ** 2) * (0.3 + 0.7 * a) + 1e-4
        cols = np.column_stack([k, T, T, T, T, T * supp, T])
        path = os.path.join(workdir, f"camb_transfer_z{z}.dat")
        np.savetxt(path, cols, fmt="%.8e")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="./demo_out")
    ap.add_argument("--n-models", type=int, default=3)
    ap.add_argument("--nk", type=int, default=128,
                    help="the solver k-grid size")
    ap.add_argument("--platform", default=None, choices=[None, "cpu"],
                    help="solve on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    from redtime_tpu_torch import cli, design
    from redtime_tpu_torch.convert import convert_pt, read_models_file
    from redtime_tpu_torch.orchestrate import CAMB_Z_LIST, write_params

    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)

    # 1. design file
    models_path = os.path.join(wd, "models.dat")
    design.generate_design(models_path, args.n_models, seed=1)
    models = read_models_file(models_path)
    print(f"design: {len(models)} models")

    # 2+3. transfer stacks + params files (HACC convention: 8 analysis
    # steps map into the 33-z output list)
    z_list = CAMB_Z_LIST.split()
    params_paths = []
    for i, m in enumerate(models):
        name = f"M{i + 1:03d}"
        # one stack per model: a shared directory would overwrite the
        # transfer files, feeding every model the last stack
        mdir = os.path.join(wd, name)
        os.makedirs(mdir, exist_ok=True)
        synth_transfer_stack(mdir, z_list, seed=100 + i)
        path = os.path.join(wd, f"params_redTime_{name}.dat")
        write_params(path, name, m["om_m"], m["om_b"], m["sigma_8"], m["h"],
                     m["n_s"], m["w0"], m["wa"], m["om_nu"], z_list,
                     transfer_root=f"{name}/camb_transfer_z")
        params_paths.append(path)

    # 4. one batched solve
    platform = ["--platform", "cpu"] if args.platform == "cpu" else []
    rc = cli.main(["batch", "--output-dir", wd, "--nk", str(args.nk),
                   "--timing"] + platform + params_paths)
    if rc != 0:
        return rc

    # 5. emulator extraction for HACC step 499 (z=0)
    convert_pt(len(models), 499, args.nk, models_path, wd)
    sample = os.path.join(wd, "STEP499", "pk_M001_no_interp_test.dat")
    with open(sample) as f:
        pk = np.array(f.read().split(), dtype=np.float64)
    print(f"emulator extraction: {sample} ({len(pk)} values, "
          f"max {pk.max():.3e})")
    print("demo complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
