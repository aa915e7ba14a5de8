"""Device times of K9 engine_front and K10 tab_leg on one CUDA card, and
of builds of them with one part taken out.

    python3 scripts/time_engine_legs.py [--drops] [--out PATH]

from the root of a checkout, on a machine with a CUDA card.  Times, with
chip_smoke.graph_ms (20 calls in a CUDA graph, replayed 5 times; the
least of three readings), on random states' ln P rows (clipped, as the
RHS hands them over):

  * K9 at nk=128 over LANES lanes, with the lanes a cluster the wrapper
    picks and the clusters the CUDA runtime says fit at once;
  * K10 at SHAPES (nk, lanes; 14 families), beside torch.matmul of the
    plain version's sab with dft_bwd_half (the library's time for the
    product alone);
  * with --drops, the kernels built again from their sources with one
    part replaced (DROPS: K9 without the forward leg's loads of
    dft_fwd_half, without the extension's loads of pab_M, or without
    both; K10 without the staged copies of ci and g, or without the
    tensor-core products) into libraries beside the package's, timed in
    the same way: what a part costs is the kernel's time less the
    variant's.  The variants' outputs are wrong by design and not
    checked.

Prints the card and each reading, and writes them as JSON to PATH
(default chiprun_out/time_engine_legs.json).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = (1, 2, 8, 15, 16, 17, 32, 64)
SHAPES = ((128, 16), (128, 8), (128, 64), (48, 2), (512, 2), (256, 2))
# source, then (text, its replacement) of each variant
DROPS = {
    "K9 without the forward leg's loads": ("engine_front.cu", (
        ("f[u] = F[(size_t)(m + u) * nc];", "f[u] = 1e-3 * (m + u);"),
        ("step(m, F[(size_t)m * nc]);", "step(m, 1e-3);"))),
    "K9 without the extension's loads": ("engine_front.cu", (
        ("w[u][g] = j < nk && m < m_hi ? pab_M[(size_t)m * nk + j] : 0.0;",
         "w[u][g] = 1e-3;"),)),
    "K9 without either": ("engine_front.cu", (
        ("f[u] = F[(size_t)(m + u) * nc];", "f[u] = 1e-3 * (m + u);"),
        ("step(m, F[(size_t)m * nc]);", "step(m, 1e-3);"),
        ("w[u][g] = j < nk && m < m_hi ? pab_M[(size_t)m * nk + j] : 0.0;",
         "w[u][g] = 1e-3;"))),
    "K10 without the staged ci and g": ("tab_leg.cu", (
        ("cp_async8(st + D_STAGE + row * BKH + kq, ok ? raw_src[i] + k : D,"
         "\n                  ok);",
         "st[D_STAGE + row * BKH + kq] = 1e-3;"),)),
    "K10 without the products": ("tab_leg.cu", (
        ("rt::Dmma<KK>::run(acc[im][j], a[im], bf[j]);",
         "acc[im][j][0] += a[im][0] * bf[j][0];"),)),
}


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "time_engine_legs_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_drops(build) -> dict:
    """Each DROPS variant compiled (all at once), with the other engine
    kernel's source as it is, into its own library under build.BUILD_DIR
    / "drops"; name -> loaded handle."""
    out_dir = build.BUILD_DIR / "drops"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (source, edits)) in enumerate(DROPS.items()):
        text = (build.CSRC / source).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in {source}")
            text = text.replace(old, new)
        cu, so = out_dir / f"drop{i}.cu", out_dir / f"drop{i}.so"
        cu.write_text(text)
        other = build.CSRC / ({"engine_front.cu", "tab_leg.cu"}
                              - {source}).pop()
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-shared", "-o", str(so), str(cu), str(other)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = build.bind_engine(ctypes.CDLL(str(so)))
    return libs


@contextlib.contextmanager
def using(build, handle):
    """The wrappers launch from `handle` instead of the package's library."""
    saved, build._lib = build._lib, handle
    try:
        yield
    finally:
        build._lib = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--drops", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_engine_legs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from redtime_tpu_torch import fastpt
    from redtime_tpu_torch.config import SolverConfig
    from redtime_tpu_torch.kernels import build
    from redtime_tpu_torch.kernels import engine_front as k9
    from redtime_tpu_torch.kernels import tab_leg as k10

    smoke = _smoke()
    build.lib()
    variants = {"kernel": build.lib()}
    if args.drops:
        variants.update(build_drops(build))
    out = dict(card=smoke.card_line(), k9=[], k10=[])
    print(out["card"])
    rng = np.random.default_rng(0)
    time = lambda fn: min(smoke.graph_ms(fn) for _ in range(3))

    def front(cfg, B):
        ec = fastpt.engine_consts(cfg, "cuda")
        y = torch.as_tensor(8.0 - 0.3 * rng.standard_normal(
            (B, 41, cfg.nk)), device="cuda")
        n_s = torch.full((B,), 0.96, dtype=torch.float64, device="cuda")
        return ec, (y[:, :3], n_s, ec.pab_M, ec.pab_v, ec.wp, ec.kbias,
                    ec.dft_fwd_half)

    cfg = SolverConfig()
    fit = [build.lib().rt_engine_front_clusters(n, cfg.nk, cfg.npts)
           for n in (1, 2)]
    for B in LANES:
        _, args9 = front(cfg, B)
        row = dict(B=B, lanes_a_cluster=k9.lanes(
            B, cfg.nk, cfg.npts, 2 * (cfg.npts // 2), lambda n: fit[n - 1]),
            clusters_that_fit=fit)
        for name, handle in variants.items():
            if name == "kernel" or name.startswith("K9"):
                with using(build, handle):
                    row[name] = time(lambda: k9.engine_front(*args9,
                                                             clip=True))
        out["k9"].append(row)
        print(json.dumps(row))
    for nk, B in SHAPES:
        cfg = {512: SolverConfig.high_accuracy, 256: SolverConfig.v01_compat
               }.get(nk, lambda: SolverConfig(nk=nk))()
        ec, args9 = front(cfg, B)
        _, ci = k9.engine_front_plain(*args9, clip=True)
        g = (ec.ga_re, ec.ga_im, ec.gb_re, ec.gb_im, ec.dft_bwd_half)
        sab = k10.sab_plain(ci, *g[:4], fastpt.NFAM)
        row = dict(nk=nk, B=B, library=time(lambda: torch.matmul(sab, g[4])))
        for name, handle in variants.items():
            if name == "kernel" or name.startswith("K10"):
                with using(build, handle):
                    row[name] = time(lambda: k10.tab_leg(ci, *g,
                                                         fastpt.NFAM))
        out["k10"].append(row)
        print(json.dumps(row))
    path = args.out or os.path.join(ROOT, "chiprun_out",
                                    "time_engine_legs.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
