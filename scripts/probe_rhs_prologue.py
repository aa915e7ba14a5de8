"""K8's lookups against the plain version's on one CUDA card, value by
value: which of a^3 H^2/H0^2, 3 + dlnH/dlna, beta_P, o10 and, in 1-loop
mode, D, dD/da, fz and pre the kernel computes to torch's bits.

    python3 scripts/probe_rhs_prologue.py

from the root of a checkout, on a machine with a CUDA card.  Builds
csrc/rhs_tail.cu alone with RT_DROP=128 (item 0's tasks write the
lookups' values in dy's rows 0-7), feeds it chip_smoke.py's K8 inputs
(design models prepared on the host, chip_smoke.rt_state's states, and
at nk = 128, 8 lanes its edge-case lanes, chip_smoke.rt_edges) in 1-loop
and full TRG, and prints for each value the share of finite elements
equal to the plain version's (kernels/rhs_tail.prologue_plain on the card)
and the largest deviation over its lane's scale.  Then, for the beta and
growth lookups, the share of elements at which sums of the 4 nodes'
products in other orders (torch ops on the card: a left-to-right sum of
rounded products, two pairings, the pairs (0, 2) and (1, 3) each an addcmul, an addcmul
chain forwards and backwards, splits by k mod 2, 4, 8 and chunks of 4
to 32 nodes)
equal the plain version's dense-row einsum.  Writes
chiprun_out/probe_rhs_prologue.json.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import functools
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def sum_orders(nodes, x, table, dense) -> dict:
    """Per order of the 4-node sum, the share of elements equal to dense
    (the plain version's einsum): nodes [B, nn], x [B], table [B, nn, nk]
    on the card, the weights interp.axis_weights'."""
    import torch

    from redtime_tpu_torch import interp

    i0, w = interp.axis_weights(nodes, x)                  # [B], [B, 4]
    idx = (i0[:, None] + torch.arange(4, device=x.device))  # [B, 4]
    rows = torch.gather(table, 1, idx[..., None].expand(
        -1, -1, table.shape[2]))                           # [B, 4, nk]
    p = w[..., None] * rows
    chain = lambda order: functools.reduce(
        lambda acc, j: torch.addcmul(acc, w[:, j, None], rows[:, j]),
        order, torch.zeros_like(dense))
    sums = {"left to right": ((p[:, 0] + p[:, 1]) + p[:, 2]) + p[:, 3],
            "(01)(23)": (p[:, 0] + p[:, 1]) + (p[:, 2] + p[:, 3]),
            "(02)(13)": (p[:, 0] + p[:, 2]) + (p[:, 1] + p[:, 3]),
            "(02)(13), each pair an addcmul": (
                torch.addcmul(p[:, 0], w[:, 2, None], rows[:, 2])
                + torch.addcmul(p[:, 1], w[:, 3, None], rows[:, 3])),
            "addcmul 0-3": chain(range(4)),
            "addcmul 3-0": chain(range(3, -1, -1))}
    sums.update({name: _split_sum(i0, w, rows, *how)
                 for name, how in SPLITS.items()})
    fin = torch.isfinite(dense)
    return {name: float((v == dense)[fin].double().mean())
            for name, v in sums.items()}


# other splits of the dense row's sum: by k mod R (each class an fma
# chain in k order, the classes then added in class order or as a
# pairwise tree) or in chunks of C nodes (each an fma chain, the chunks'
# sums added in order)
SPLITS = {f"k mod {R}, {tree}": ("mod", R, tree) for R in (2, 4, 8)
          for tree in ("in order", "tree")}
SPLITS.update({f"chunks of {C}": ("chunk", C, "in order")
               for C in (4, 8, 16, 32)})


def _split_sum(i0, w, rows, kind: str, size: int, tree: str):
    """The 4 nodes' sum at each lane's i0 as a split reduction would take
    it (SPLITS)."""
    import torch

    out = []
    for b in range(w.shape[0]):
        groups = {}
        for j in range(4):
            k = int(i0[b]) + j
            g = k % size if kind == "mod" else k // size
            groups[g] = torch.addcmul(
                groups.get(g, torch.zeros_like(rows[b, 0])), w[b, j],
                rows[b, j])
        parts = [groups.get(g, torch.zeros_like(rows[b, 0]))
                 for g in (range(size) if kind == "mod"
                           else sorted(groups))]
        while len(parts) > 1 and tree == "tree":
            parts = [parts[i] + parts[i + 1] if i + 1 < len(parts)
                     else parts[i] for i in range(0, len(parts), 2)]
        acc = parts[0]
        for q in parts[1:]:
            acc = acc + q
        out.append(acc)
    return torch.stack(out)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_rhs_prologue: no CUDA device", file=sys.stderr)
        return 2
    from redtime_tpu_torch import driver, fastpt, interp, trg
    from redtime_tpu_torch import model as mdl
    from redtime_tpu_torch.config import RunSettings
    from redtime_tpu_torch.kernels import build
    from redtime_tpu_torch.kernels import rhs_tail as rt

    spec = importlib.util.spec_from_file_location(
        "probe_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    build.build()
    log = build.BUILD_LOG.get("output", "")
    ptxas = {v: smoke.ptxas_of(log, f"rhs_tail_kernelILi{i}E")
             for i, v in enumerate(rt.VARIANTS)}
    print(f"rhs_tail ptxas: {ptxas}")
    lib = build.bind_rhs_tail(ctypes.CDLL(str(build.build(
        defines=("RT_DROP=128",), only=("rhs_tail.cu",)))))
    dev = torch.device("cuda")
    rng = np.random.default_rng(2468)
    cs, lins = smoke.design_inputs(2)
    chunk = ([x.numpy() for x in cs], list(lins), None)
    out = dict(card=smoke.card_line(), ptxas=ptxas, cases=[])
    print(out["card"])
    for nk, B in ((128, 8), (128, 32), (512, 2)):
        cfg = smoke.rt_config(nk)
        m = mdl.take_lanes(driver._prepare(cfg, chunk, dev, True),
                           torch.arange(B, device=dev) % 2)
        ec = fastpt.engine_consts(cfg, dev)
        for mode in ("oneloop", "full"):
            settings = RunSettings(z_out=smoke.Z_OUT_1L,
                                   **smoke.RT_MODES[mode])
            cache = (trg.build_oneloop_cache(cfg, settings, m, ec)
                     if settings.one_loop else None)
            eta, y = smoke.rt_state(rng, cfg, settings, m, B)
            prologue = trg.rhs_prologue(cfg, settings, m, ec, cache)
            args = prologue(eta, y)
            runs = {"": args}
            if (nk, B) == smoke.RT_EDGE_SHAPE:
                runs.update(smoke.rt_edges(args, prologue, eta, y))
            for tag, a in runs.items():
                _, eta_, _, om, src, _ = a
                dy = torch.full_like(a[0], float("nan"))
                rt.launch(lib, dy, *a)
                torch.cuda.synchronize()
                at, growth = rt.prologue_plain(eta_, om, src)
                ones = torch.ones_like(at.beta)
                ref = {"den": at.den[:, None] * ones,
                       "o11": at.o11[:, None] * ones, "beta": at.beta,
                       "o10": rt.omega_from(at)[:, 1, 0]}
                if growth is not None:
                    D, dDda, z = growth
                    dr = D / src.D_z1l
                    dr2 = dr * dr
                    ref.update(D=D, dDda=dDda,
                               fz=dDda / (D * (1.0 + z)[:, None]),
                               pre=dr2 * dr2 * torch.exp(-4.0 * eta_)[:, None])
                row = dict(mode=mode, nk=nk, B=B, edges=tag)
                a_ = om.a_in * torch.exp(eta_)
                if om.beta_a.shape[1]:
                    raw = torch.einsum(
                        "bz,bzk->bk",
                        interp.axis_weights_full(om.beta_a,
                                                 a_.clamp(max=1.0)),
                        om.beta_solver)
                    row["beta_orders"] = sum_orders(
                        om.beta_a, a_.clamp(max=1.0), om.beta_solver, raw)
                if growth is not None:
                    lna = torch.log(torch.reciprocal(1.0 + growth[2]))
                    Gv = torch.einsum(
                        "bn,bnk->bk",
                        interp.axis_weights_full(src.g_lna, lna), src.g_G)
                    row["growth_orders"] = sum_orders(src.g_lna, lna,
                                                      src.g_G, Gv)
                for r, (name, v) in enumerate(ref.items()):
                    got = dy[:, r]
                    fin = torch.isfinite(v)
                    same_nan = bool(torch.equal(got.isnan(), v.isnan()))
                    row[name] = dict(
                        bit_equal=float((got == v)[fin].double().mean()),
                        dev=smoke.rt_dev(got[:, None], v[:, None]),
                        nan_same=same_nan)
                out["cases"].append(row)
                print(json.dumps(row))
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "probe_rhs_prologue.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
