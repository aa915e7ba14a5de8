"""Full pipeline orchestration: CAMB -> params_redTime.dat -> solver (the
port of scripts/run_redtime.py).

Python equivalent of the reference's `scripts/runRedTime` (one model) and
`scripts/runRedTimeBatch` (a design of models).  Reproduces:

  * little-omega -> Omega derivations (omega/h^2) and the massless/massive
    N_eff = 3.046 split (runRedTime:98-119);
  * CAMB ini generation from the bundled template with A_s =
    2.15903458773893e-9, then the two-pass sigma_8 rescale
    A_s *= (sigma8_target/sigma8_camb)^2 (runRedTime:137-186);
  * params_redTime.dat emission with switches "1 0 1 1", z_in=200 and the
    33 CAMB transfer redshifts (runRedTime:198-219).

CAMB stays an external binary exactly as in the reference (--camb-exec);
the serial `runRedTimeBatch` loop is replaced by ONE batched solve over
all models (the port's CLI `batch`, or `run` for a single model) after
their transfer inputs exist.  The solve runs on the CUDA card unless
`--platform cpu` asks for the CPU; `--nk` and `--timing` go on to the
CLI.  The JAX script's `--mode` (its FFT backend) has no counterpart.

    python -m redtime_tpu_torch.orchestrate --redshift-file z.txt \\
        --models-file models.dat --output-dir out/ --camb-exec ./camb
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

SCALAR_AMP = "2.15903458773893"
CAMB_Z_LIST = ("200 100 50 20 10 5 4 3 2.5 2.0180180180180183 1.8 "
               "1.6103896103896105 1.4 1.2 1.0059880239520962 0.8 0.75 0.7 "
               "0.655683690280066 0.62 0.58 0.54 0.5 0.47 "
               "0.43366619115549243 0.4 0.35 0.3 0.2422744128553771 0.2 "
               "0.15 0.10076670317634195 0")
TCMB, TAU = "2.726", "0.09"
TEMPLATE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "templates", "camb_modern.ini")


def derive(om_m, om_b, om_nu, h):
    """little-omega -> Omega derivations (runRedTime:98-119)."""
    om_c = om_m - om_b - om_nu
    d = dict(
        Omega_m=om_m / h / h, Omega_b=om_b / h / h, Omega_nu=om_nu / h / h,
        omch2=om_c,
        massless_nu=3.046 if om_nu < 1e-10 else 0.0,
    )
    d["massive_nu"] = 3.046 - d["massless_nu"]
    return d


def make_camb_ini(template_path, out_root, om_b, om_c, om_nu, h, w0, wa,
                  ns, scalar_amp):
    """The CAMB ini text: the template with its placeholders filled."""
    with open(template_path) as f:
        tpl = f.read()
    der = derive(om_b + om_c + om_nu, om_b, om_nu, h)
    subs = {
        "CAMB_TEMPLATE_OUTROOT": out_root,
        "CAMB_TEMPLATE_OMBH2": f"{om_b:.6e}",
        "CAMB_TEMPLATE_OMCH2": f"{om_c:.6e}",
        "CAMB_TEMPLATE_OMNUH2": f"{om_nu:.6e}",
        "CAMB_TEMPLATE_H0": f"{h * 100:.6e}",
        "CAMB_TEMPLATE_W0": f"{w0:.6e}",
        "CAMB_TEMPLATE_WA": f"{wa:.6e}",
        "CAMB_TEMPLATE_TCMB": TCMB,
        "CAMB_TEMPLATE_TAU": TAU,
        "CAMB_TEMPLATE_NS": f"{ns:.6e}",
        "CAMB_TEMPLATE_MASSLESS_NU": f"{der['massless_nu']:g}",
        "CAMB_TEMPLATE_MASSIVE_NU": f"{der['massive_nu']:g}",
        "CAMB_SCALAR_AMP": f"{scalar_amp}e-9",
    }
    for key, val in subs.items():
        tpl = tpl.replace(key, val)
    return tpl


def run_camb(camb_exec, ini_path):
    """Run CAMB on one ini; returns the sigma_8 it prints after '=' on its
    last stdout line (runRedTime:161-163)."""
    out = subprocess.run([camb_exec, ini_path], capture_output=True,
                         text=True, check=True).stdout
    last = out.strip().splitlines()[-1]
    return float(re.split("=", last)[-1])


def write_params(path, name, om_m, om_b, s8, h, ns, w0, wa, om_nu,
                 z_out, transfer_root="camb_transfer_z"):
    """Emit params_redTime.dat for one model (runRedTime:198-219)."""
    d = derive(om_m, om_b, om_nu, h)
    lines = [f"{ns}", f"{s8}", f"{h}",
             repr(d["Omega_m"]), repr(d["Omega_b"]), repr(d["Omega_nu"]),
             TCMB, f"{w0}", f"{wa}",
             "1 0 1 1",          # switches (runRedTime:101)
             "200",              # z_in
             str(len(z_out)), " ".join(str(z) for z in z_out),
             f"{transfer_root}0.dat", "0", transfer_root,
             "33", CAMB_Z_LIST]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _write(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)


def run_model(args, model, z_out, out_prefix: str = "camb"):
    """CAMB two-pass + params emission for one model; returns the params
    file path (the solver runs batched afterwards).

    out_prefix: per-model CAMB output root.  The reference's serial loop
    (runRedTimeBatch:91-99) can share one `camb_transfer_z*` root because
    it solves each model before the next CAMB run overwrites the files;
    here the whole design solves in one batched call after all the CAMB
    passes, so multi-model designs must write distinct roots or every
    params file would read the last model's transfer stack."""
    name, om_m, om_b, s8, h, ns, w0, wa, om_nu = model
    outdir = os.path.abspath(args.output_dir)
    os.makedirs(outdir, exist_ok=True)
    om_c = om_m - om_b - om_nu

    if args.camb_exec:
        if args.template_dir:
            template = os.path.join(
                args.template_dir, "camb_template_modern.ini"
                if args.modern_camb else "camb_template.ini")
        else:
            template = TEMPLATE
        ini = os.path.join(outdir, "temp_camb.ini")
        root = os.path.join(outdir, out_prefix)
        _write(ini, make_camb_ini(template, root, om_b, om_c, om_nu, h, w0,
                                  wa, ns, SCALAR_AMP))
        s8_camb = run_camb(args.camb_exec, ini)
        amp2 = float(SCALAR_AMP) * (s8 / s8_camb) ** 2
        _write(ini, make_camb_ini(template, root, om_b, om_c, om_nu, h, w0,
                                  wa, ns, repr(amp2)))
        run_camb(args.camb_exec, ini)

    params_path = os.path.join(outdir, f"params_redTime_{name}.dat")
    write_params(params_path, name, om_m, om_b, s8, h, ns, w0, wa, om_nu,
                 z_out, transfer_root=f"{out_prefix}_transfer_z")
    return params_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--redshift-file", required=True)
    ap.add_argument("--output-dir", default="./output")
    ap.add_argument("--models-file", help="batch design: name om_m om_b s8 "
                    "h ns w0 wa om_nu per line")
    ap.add_argument("model_args", nargs="*", help="single model: NAME om_m "
                    "om_b s8 h ns w0 wa om_nu")
    ap.add_argument("--camb-exec", default=None,
                    help="CAMB binary (transfer files must already exist "
                    "in --output-dir if omitted)")
    ap.add_argument("--template-dir", default=None,
                    help="directory with camb_template[_modern].ini; "
                    "defaults to the bundled redtime_tpu_torch/templates")
    ap.add_argument("--modern-camb", action="store_true")
    ap.add_argument("--platform", default=None, choices=[None, "cpu"],
                    help="solve on the CPU (default: the CUDA card)")
    ap.add_argument("--nk", type=int, default=None,
                    help="the solver k-grid size (default: SolverConfig's)")
    ap.add_argument("--timing", action="store_true",
                    help="print the per-stage wall-clock of the batch "
                    "solve (a design of two or more models)")
    args = ap.parse_args(argv)

    with open(args.redshift_file) as f:
        z_out = f.read().split()

    models = []
    if args.models_file:
        with open(args.models_file) as f:
            for line in f:
                if line.strip().startswith("#") or not line.strip():
                    continue
                p = line.split()
                models.append((p[0],) + tuple(float(x) for x in p[1:9]))
    elif len(args.model_args) == 9:
        p = args.model_args
        models.append((p[0],) + tuple(float(x) for x in p[1:9]))
    else:
        ap.error("give either --models-file or 9 positional model args")

    # per-model transfer roots for multi-model designs (see run_model);
    # the single-model path keeps the reference's `camb_transfer_z*`
    # naming (runRedTime:198-219)
    params_paths = [
        run_model(args, m, z_out,
                  out_prefix="camb" if len(models) == 1
                  else f"camb_{m[0]}")
        for m in models]

    # one batched solve over the whole design (replaces the serial
    # runRedTimeBatch loop)
    from redtime_tpu_torch import cli

    common = (["--platform", "cpu"] if args.platform == "cpu" else []) + (
        ["--nk", str(args.nk)] if args.nk is not None else [])
    if len(params_paths) == 1:
        return cli.main(["run", "--params", params_paths[0], "-o",
                         os.path.join(args.output_dir,
                                      f"redTime_{models[0][0]}.dat")]
                        + common)
    return cli.main(["batch", "--output-dir", args.output_dir] + common
                    + (["--timing"] if args.timing else []) + params_paths)


if __name__ == "__main__":
    sys.exit(main())
