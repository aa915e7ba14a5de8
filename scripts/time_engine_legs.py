"""Device times of K9 engine_front and K10 tab_leg on one CUDA card, and
of builds of them with one part taken out.

    python3 scripts/time_engine_legs.py [--drops] [--out PATH]

from the root of a checkout, on a machine with a CUDA card.  Times, with
chip_smoke.graph_ms (20 calls in a CUDA graph, replayed 5 times; the
least of three readings), on random states' ln P rows (clipped, as the
RHS hands them over):

  * K9 at nk=128 over LANES lanes, beside torch.fft.rfft of its plain
    version's P_ext kbias (cuFFT: the forward leg alone);
  * K10 at SHAPES (nk, lanes; 14 families), beside torch.matmul of the
    plain version's sab with dft_bwd_half and torch.fft.irfft of the
    zero-padded complex sab at n = 2np (cuFFT): the library's times for
    the transform alone;
  * with --drops, the kernels built again from their sources with one
    part replaced (DROPS: K9 without the FFT stages, without exp, or
    without the row's NaN / inf counts; K10 without the tab stores,
    without the FFT stages, or without its loads of ci and g) into
    libraries beside the package's, timed in the same way: what a part
    costs is the kernel's time less the variant's.  The variants'
    outputs are wrong by design and not checked.  One more K10 variant
    runs its transform the other way the pruning allows, as four complex
    transforms of length np / 2 (right where the launch plan has S = 1:
    the nk=128 shapes).

The torch.fft calls are yardsticks here; the port never calls them.
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
LANES = (1, 2, 8, 16, 32, 64)
SHAPES = ((128, 16), (128, 8), (128, 64), (48, 2), (512, 2), (256, 2))
# source, then (text, its replacement) of each variant
DROPS = {
    "K9 without the FFT stages": ("engine_front.cu", (
        ("rt_fft::run<false>(plan, 1, half, T1, half, buf0, buf1, first, "
         "last);",
         "for (int o = threadIdx.x; o < half; o += THREADS)\n"
         "    last(0, o, first(0, o));"),)),
    "K9 without exp": ("engine_front.cu", (
        ("__dmul_rn(exp(x), p.wp)", "__dmul_rn(x, p.wp)"),)),
    "K9 without the NaN and inf counts": ("engine_front.cu", (
        ("nans += __syncthreads_count(isnan(v));\n"
         "    infs += __syncthreads_count(isinf(v));", "__syncthreads();"),)),
    "K10 without the tab stores": ("tab_leg.cu", (
        ("out[out_row[row] + S * m + h] = v;",
         "if (v.x == 1.25e-300) out[out_row[row] + S * m + h] = v;"),)),
    "K10 without the FFT stages": ("tab_leg.cu", (
        ("rt_fft::run<true>(plan, rows, ns, tw, N, buf0, buf1, first, last);",
         "for (int t = threadIdx.x; t < rows * ns; t += blockDim.x)\n"
         "    last(t / ns, t % ns, first(t / ns, t % ns));"),)),
    # the pruned transform as four complex ones of length np / 2, one a
    # residue r of n mod 4: y[4m + r] = Re IDFT(c_k X_k w_2np^{kr})[m],
    # in turn through the same buffers (valid where S = 1)
    "K10 as four transforms of length np / 2": ("tab_leg.cu", ((
        "  double2* out = reinterpret_cast<double2*>(tab);\n",
        """  rt_fft::Plan pl = plan;  // the plan for half = np / 2
  if (pl.radix[0] == 2) {
    for (int s = 1; s < pl.nst; ++s) pl.radix[s - 1] = pl.radix[s];
    --pl.nst;
  } else {
    pl.radix[0] /= 2;
  }
  const double* cv = ci + (size_t)pair * np;
  for (int r = 0; r < 4; ++r) {
    for (int t = threadIdx.x; t < rows * half; t += blockDim.x) {
      const int row = t / half, k = t - row * half;
      const int q = q0 + row, s = q / nfam, f = q - s * nfam;
      const size_t g = (size_t)f * half + k;
      const double wr = s ? gb_re[g] : ga_re[g];
      const double wi = s ? gb_im[g] : ga_im[g];
      const double c = cv[k], m = cv[half + k];
      const double2 x =
          make_double2(__dsub_rn(__dmul_rn(c, wr), __dmul_rn(m, wi)),
                       __dadd_rn(__dmul_rn(c, wi), __dmul_rn(m, wr)));
      const double2 z = rt_fft::cmul(__ldg(tw + k * r % N), x);
      const double ck = k ? 2.0 : 1.0;
      Zs[t] = make_double2(ck * z.x, ck * z.y);
    }
    __syncthreads();
    auto first4 = [&](int row, int k) { return Zs[row * half + k]; };
    auto last4 = [&](int row, int m, double2 v) {
      tab[2 * out_row[row] + 4 * m + r] = v.x;
    };
    rt_fft::run<true>(pl, rows, half, tw, N, buf0, buf1, first4, last4);
    __syncthreads();
  }
  return;
  double2* out = reinterpret_cast<double2*>(tab);
"""),)),
    "K10 without the loads of ci and g": ("tab_leg.cu", (
        ("const double wr = s ? gb_re[g] : ga_re[g], wi = s ? gb_im[g] : "
         "ga_im[g];\n    const double c = cr[k], m = cr[half + k];",
         "const double wr = 1e-3 * k, wi = 1e-3, c = 1.0 + g, m = 0.5;"),)),
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
                    ec.dft_fwd_half), (ec.pab_j0, ec.pab_w, ec.wc_half,
                                       ec.twiddle)

    cfg = SolverConfig()
    for B in LANES:
        ec, args9, band = front(cfg, B)
        P, _ = k9.engine_front_plain(*args9, clip=True)
        Q = P * ec.kbias
        row = dict(B=B, cufft_rfft=time(lambda: torch.fft.rfft(Q)))
        for name, handle in variants.items():
            if name == "kernel" or name.startswith("K9"):
                with using(build, handle):
                    row[name] = time(lambda: k9.engine_front(
                        *args9, *band, clip=True))
        out["k9"].append(row)
        print(json.dumps(row))
    for nk, B in SHAPES:
        cfg = {512: SolverConfig.high_accuracy, 256: SolverConfig.v01_compat
               }.get(nk, lambda: SolverConfig(nk=nk))()
        ec, args9, _ = front(cfg, B)
        _, ci = k9.engine_front_plain(*args9, clip=True)
        g = (ec.ga_re, ec.ga_im, ec.gb_re, ec.gb_im, ec.dft_bwd_half)
        sab = k10.sab_plain(ci, *g[:4], fastpt.NFAM)
        half = cfg.npts // 2
        z = torch.complex(sab[..., :half], sab[..., half:])
        n2 = 2 * cfg.npts
        row = dict(nk=nk, B=B, library=time(lambda: torch.matmul(sab, g[4])),
                   cufft_irfft=time(lambda: torch.fft.irfft(z, n=n2)))
        for name, handle in variants.items():
            if name == "kernel" or name.startswith("K10"):
                with using(build, handle):
                    row[name] = time(lambda: k10.tab_leg(
                        ci, *g, ec.twiddle, fastpt.NFAM))
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
